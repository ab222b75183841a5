"""Tracing of the port: torch.profiler traces, and spans of the program's
own host work on the clock of the profiler's device events (the counterpart
of ``srgan_tpu/utils/profiling.py``; the reference has none beyond tqdm).

Usage:
    with trace("results/trace"):        # a torch.profiler session, trace.json into the dir
        Trainer(cfg).train()
    spans()                             # the session's span records

    with span("loop.score", epoch=3):   # a named region of the program's work
        ...
    with tags(epoch=3, step=7):         # attrs of every span opened inside
        ...
    vals = to_host(packed, "train_epoch.drain").tolist()   # a host sync, as a span

**On and off.** Tracing is on exactly while a torch.profiler session is on
in the process: ``trace()`` (``train --profile-dir``) or any caller's
``torch.profiler.profile``. There is no other switch. With no session,
``span`` and ``tags`` return a shared no-op context after one check of the
profiler's flag: they read no clock, open no ``record_function``, keep
nothing and sync nothing.

**An active span** opens ``record_function("srgan.<name>")``, so it shows in
the Chrome trace beside the kernels, and appends a :class:`Span` record:
id, parent id (the innermost span open on the thread), name, start and end
in Unix-epoch ns (``time.time_ns()``, the clock of the profiler's events;
the start is read just before the ``record_function`` opens and the end
just after it closes, so the record holds its event) and attrs. A span
carries the attrs of the span or ``tags`` block around it, its own on top:
the spans of one training step share ``(epoch, step)``, those of one
request its ``request``. A span already open when the session started is
not recorded. ``spans()`` holds the records since the last ``trace()``
began (or ``clear_spans()``); ``trace()`` writes them only into its Chrome
trace, as the args of each ``srgan.*`` event.

``to_host`` is every device-to-host read of the training loop and the
``Upscaler``: a ``sync`` span, attr ``site``, around ``Tensor.cpu()``, or
with ``pinned=True`` around a copy into page-locked memory.

``trace`` records host and CUDA activity and writes ``trace.json``
(Perfetto or ``chrome://tracing``) into ``log_dir`` when the block ends,
each kernel of the port under its name (``edge_stats_kernel``,
``loss_sums_kernel``, ``grad_kernel``, …). The profiler keeps every event in
host memory until then, so trace a short run.
"""

from __future__ import annotations

import bisect
import contextlib
import itertools
import json
import os
import threading
import time
from typing import List, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

TRACE_FILE = "trace.json"
PREFIX = "srgan."

_enabled = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()
_records: List["Span"] = []
_ids = itertools.count(1)


class _Local(threading.local):
    def __init__(self):
        self.stack: list = []  # open frames, (span id, attrs), innermost last


_local = _Local()


class Span:
    """One recorded span; ``end_ns`` is None while it is open."""

    __slots__ = ("id", "parent", "name", "start_ns", "end_ns", "attrs")

    def __init__(self, id: int, parent: Optional[int], name: str, attrs: dict):
        self.id, self.parent, self.name, self.attrs = id, parent, name, attrs
        self.start_ns: int = 0
        self.end_ns: Optional[int] = None

    def __repr__(self) -> str:
        return (f"Span({self.id}, parent={self.parent}, {self.name!r}, "
                f"{self.start_ns}-{self.end_ns}, {self.attrs})")


class _Active:
    __slots__ = ("_name", "_attrs", "_rec", "_rf")

    def __init__(self, name: str, attrs: dict):
        self._name, self._attrs = name, attrs

    def __enter__(self) -> Span:
        stack = _local.stack
        parent, inherited = stack[-1] if stack else (None, {})
        rec = Span(next(_ids), parent, self._name, {**inherited, **self._attrs})
        self._rec, self._rf = rec, record_function(PREFIX + self._name)
        rec.start_ns = time.time_ns()
        self._rf.__enter__()
        _records.append(rec)
        stack.append((rec.id, rec.attrs))
        return rec

    def __exit__(self, *exc) -> None:
        self._rf.__exit__(*exc)
        self._rec.end_ns = time.time_ns()
        _local.stack.pop()


class _Tags:
    __slots__ = ("_attrs",)

    def __init__(self, attrs: dict):
        self._attrs = attrs

    def __enter__(self) -> None:
        stack = _local.stack
        parent, inherited = stack[-1] if stack else (None, {})
        stack.append((parent, {**inherited, **self._attrs}))

    def __exit__(self, *exc) -> None:
        _local.stack.pop()


def span(name: str, **attrs):
    """A named region of the program's work, recorded while a profiler
    session is on (module docstring); a no-op after one flag check when
    none is."""
    if not _enabled():
        return _OFF
    return _Active(name, attrs)


annotate = span


def tags(**attrs):
    """Give every span opened inside the block on this thread ``attrs``."""
    if not _enabled():
        return _OFF
    return _Tags(attrs)


def to_host(t: torch.Tensor, site: str, pinned: bool = False) -> torch.Tensor:
    """``t`` on the host: a call site's device-to-host read, inside a
    ``sync`` span whose attr ``site`` names the call site.

    ``pinned=True``, for large reads from the card: a blocking copy into a
    page-locked tensor from torch's caching host allocator. ``.cpu()`` would
    copy through a staging buffer into fresh pageable memory, whose pages
    fault in on first touch (a 24.9 MB read: 2.2-20.8 ms on an H100 host,
    against 0.6 ms into page-locked memory). The block goes back to the
    allocator's cache when the caller drops the tensor and every array on
    it, so a caller that keeps one result while it asks for the next
    cycles two blocks."""
    with span("sync", site=site):
        if pinned and t.is_cuda:
            return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)
        return t.cpu()


def spans() -> List[Span]:
    """The span records (module docstring), in the order they opened."""
    return list(_records)


def clear_spans() -> None:
    _records.clear()


def _attrs_into_trace(path: str, records: List[Span]) -> None:
    """Add each span's attrs to the args of its ``srgan.*`` host event in
    the Chrome trace: the event of that name that starts nearest the
    record, within 1 ms."""
    with open(path) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0)
    by_name: dict = {}
    for r in sorted(records, key=lambda r: r.start_ns):
        by_name.setdefault(PREFIX + r.name, []).append(r)
    starts = {k: [r.start_ns for r in v] for k, v in by_name.items()}
    for ev in doc.get("traceEvents", []):
        recs = by_name.get(ev.get("name"))
        if not recs or ev.get("cat") != "user_annotation":
            continue
        t = base + ev["ts"] * 1e3
        k = bisect.bisect(starts[ev["name"]], t)
        near = min(recs[max(0, k - 1):k + 1], key=lambda r: abs(r.start_ns - t))
        if abs(near.start_ns - t) < 1e6:
            ev.setdefault("args", {}).update(near.attrs)
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace of the block (host, and CUDA where
    the card is available) into ``log_dir/trace.json``, the spans' attrs
    on their events."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    clear_spans()
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    _attrs_into_trace(path, spans())
