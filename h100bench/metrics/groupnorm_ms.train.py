"""Device ms a training step in GroupNorm's kernels (``groups.py``)."""

from h100bench.groups import seconds_by_group


def read(run):
    if run.kind != "train" or not run.steps or not run.events:
        return None
    return 1e3 * seconds_by_group(run.events).get("groupnorm", 0.0) / run.steps
