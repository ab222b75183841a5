"""Host syncs a training step: the ``sync`` spans of the step loop (in
``data.batch``, ``step.*`` or ``loop.drain``; an epoch end's are left out)
over the window's steps."""

from h100bench import spans


def read(run):
    recs = spans.records() if run.kind == "train" and run.steps else None
    if recs is None:
        return None
    by_id = {r.id: r for r in recs}
    return sum(r.name == "sync" and spans.in_step_loop(r, by_id) for r in recs) / run.steps
