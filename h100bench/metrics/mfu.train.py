"""The training window's model FLOPs (``work.py``: every conv pass of the
steps completed, the discriminator's, and the epoch ends' scoring
forwards) over its wall, as a share of the card's dense peak in the
configuration's compute dtype."""

from h100bench.work import PEAK_FLOPS


def read(run):
    if run.kind != "train":
        return None
    return 100.0 * run.work["flops"] / run.window_s / PEAK_FLOPS[run.dtype]
