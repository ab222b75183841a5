"""The serving window's model FLOPs (``work.py``: the forward of every
request served, at its size)
over its wall, as a share of the card's dense peak in the
configuration's compute dtype."""

from h100bench.work import PEAK_FLOPS


def read(run):
    if run.kind != "serve":
        return None
    return 100.0 * run.work["flops"] / run.window_s / PEAK_FLOPS[run.dtype]
