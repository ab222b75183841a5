"""Device idle ms a training step held by the step loop's spans
(``data.batch``, ``step.*``, ``loop.drain`` and their ``sync``): each idle
interval's pieces go to the innermost span over them (``h100bench/spans.py``)."""

from h100bench import spans


def read(run):
    recs = spans.records() if run.kind == "train" and run.steps else None
    idle = None if recs is None else spans.idle_by_span(run.events, recs)
    if idle is None:
        return None
    by_id = {r.id: r for r in recs}
    held = sum(s for rid, s in idle.items()
               if rid is not None and spans.in_step_loop(by_id[rid], by_id))
    return 1e3 * held / run.steps
