"""Device ms a training step in the copy and cast group (``groups.py``),
cuDNN's NCHW/NHWC layout transposes among them."""

from h100bench.groups import seconds_by_group


def read(run):
    if run.kind != "train" or not run.steps or not run.events:
        return None
    return 1e3 * seconds_by_group(run.events).get("copy", 0.0) / run.steps
