"""Device idle ms a request held by the spans inside ``serve.request``
(upload, forward, fetch and its ``sync``): each idle interval's pieces go
to the innermost span over them (``h100bench/spans.py``)."""

from h100bench import spans


def read(run):
    recs = spans.records() if run.kind == "serve" and run.requests else None
    idle = None if recs is None else spans.idle_by_span(run.events, recs)
    if idle is None:
        return None
    by_id = {r.id: r for r in recs}
    held = sum(s for rid, s in idle.items()
               if rid is not None and spans.under(by_id[rid], "serve.request", by_id))
    return 1e3 * held / run.requests
