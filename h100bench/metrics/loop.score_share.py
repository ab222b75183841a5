"""Share of the training window's wall in ``loop.score`` spans:
``compute_score`` at each epoch end (the program's own spans, host clock)."""

from h100bench import spans


def read(run):
    recs = spans.records() if run.kind == "train" else None
    if recs is None:
        return None
    return 100.0 * spans.wall_s(recs, "loop.score") / run.window_s
