"""Share of the training window's wall in ``loop.snapshot`` spans: every
snapshot of ``Trainer.train`` and every wait for one, the stop's at the
window's end among them (the program's own spans, host clock)."""

from h100bench import spans


def read(run):
    recs = spans.records() if run.kind == "train" else None
    if recs is None:
        return None
    return 100.0 * spans.wall_s(recs, "loop.snapshot") / run.window_s
