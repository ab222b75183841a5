"""Device ms a request in GroupNorm's kernels (``groups.py``)."""

from h100bench.groups import seconds_by_group


def read(run):
    if run.kind != "serve" or not run.requests or not run.events:
        return None
    return 1e3 * seconds_by_group(run.events).get("groupnorm", 0.0) / run.requests
