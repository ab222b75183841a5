"""The convs' share of their roofline: the least time the window's conv
passes need (``work.py``: each pass's max of FLOPs over the peak and bytes
over the bandwidth, summed) over the device time of the conv group
(``groups.py``; cuDNN's layout transposes are in the copy group)."""

from h100bench.groups import seconds_by_group


def read(run):
    conv_s = seconds_by_group(run.events).get("conv", 0.0)
    if run.kind != "train" or conv_s <= 0.0:
        return None
    return 100.0 * run.work["conv_min_s"] / conv_s
