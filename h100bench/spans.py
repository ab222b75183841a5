"""The program's spans as the span readers take them
(``metrics/loop.score_share.py`` and the others): the records of
``srgan_tpu_torch.utils.profiling.spans()`` (id, parent, name, start_ns,
end_ns, attrs), on the clock of the profiler's device events. The
benchmark's profiler session is the window, so every record belongs to
it. A program that records no spans gives None, and its readers None.

Device idle goes to spans by time: each idle interval of
``groups.idle_gaps`` (from the first device event's start to the last one's
end) is cut at every span boundary inside it, and each piece goes to the
innermost span open over it (the one opened last), or to no span.
"""

from __future__ import annotations

from typing import Dict, Optional

from h100bench import groups

# the spans of the step loop (``Trainer.train_epoch``), with their ``sync``
STEP_LOOP = ("data.batch", "loop.drain")


def records() -> Optional[list]:
    """The closed span records, or None where the program has none."""
    from srgan_tpu_torch.utils import profiling

    read = getattr(profiling, "spans", None)
    recs = [] if read is None else [r for r in read() if r.end_ns is not None]
    return recs or None


def wall_s(recs, name: str) -> float:
    """Host seconds in spans named ``name``."""
    return sum(r.end_ns - r.start_ns for r in recs if r.name == name) * 1e-9


def in_step_loop(rec, by_id: dict) -> bool:
    """A span of the step loop: ``data.batch``, ``step.*``, ``loop.drain``,
    or a ``sync`` inside one of them."""
    if rec.name == "sync":
        parent = by_id.get(rec.parent)
        return parent is not None and in_step_loop(parent, by_id)
    return rec.name in STEP_LOOP or rec.name.startswith("step.")


def under(rec, name: str, by_id: dict) -> bool:
    """Whether a span named ``name`` holds ``rec`` (``rec`` excluded)."""
    rec = by_id.get(rec.parent)
    while rec is not None:
        if rec.name == name:
            return True
        rec = by_id.get(rec.parent)
    return False


def idle_by_span(events, recs) -> Optional[Dict[Optional[int], float]]:
    """Device idle seconds held by each span id (None: by no span), or None
    without device events."""
    if not events:
        return None
    t0 = min(e[1] for e in events)
    t1 = max(e[2] for e in events)
    marks = sorted([(r.end_ns * 1e-9, 0, r.id) for r in recs]
                   + [(r.start_ns * 1e-9, 1, r.id) for r in recs])
    start = {r.id: (r.start_ns, r.id) for r in recs}  # the later-opened of a tie is inner
    active: Dict[int, tuple] = {}  # open span id -> (start ns, id)
    out: Dict[Optional[int], float] = {}
    i = 0

    def step(mark):
        _, opens, rid = mark
        if opens:
            active[rid] = start[rid]
        else:
            active.pop(rid, None)

    def give(seconds):
        if seconds <= 0.0:
            return
        inner = max(active, key=active.get) if active else None
        out[inner] = out.get(inner, 0.0) + seconds

    for a, b in groups.idle_gaps(events, t0, t1):
        while i < len(marks) and marks[i][0] <= a:
            step(marks[i])
            i += 1
        at = a
        while i < len(marks) and marks[i][0] < b:
            give(marks[i][0] - at)
            at = marks[i][0]
            step(marks[i])
            i += 1
        give(b - at)
    return out
