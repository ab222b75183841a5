"""Profiling and tracing hooks, the counterpart of
``srgan_tpu/utils/profiling.py`` (the reference has none beyond tqdm).

Usage:
    with trace("results/trace"):      # a torch.profiler trace into the dir
        ... training steps ...

    timer = StepTimer()
    with timer.step():
        state, m = train_step(...)
    timer.summary()  # {"mean_ms": ..., "p50_ms": ..., "p95_ms": ..., "steps": n}

``trace`` records host and CUDA activity (``torch.profiler``) and writes a
Chrome trace (``trace.json``, viewable in Perfetto or ``chrome://tracing``)
into ``log_dir`` when the block ends, each kernel of the port under its
name (``edge_stats_kernel``, ``loss_sums_kernel``, ``grad_kernel``, …). The
profiler keeps every event in host memory until then, so trace a short run.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import List

import torch
from torch.profiler import ProfilerActivity, profile, record_function

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace of the block (host, and CUDA where
    the card is available) into ``log_dir/trace.json``."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


@contextlib.contextmanager
def annotate(name: str):
    """Named region inside a trace."""
    with record_function(name):
        yield


class StepTimer:
    def __init__(self):
        self.durations_ms: List[float] = []

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        yield
        self.durations_ms.append((time.perf_counter() - t0) * 1e3)

    def summary(self) -> dict:
        if not self.durations_ms:
            return {"mean_ms": 0.0, "p50_ms": 0.0, "p95_ms": 0.0, "steps": 0}
        xs = sorted(self.durations_ms)
        n = len(xs)
        return {
            "mean_ms": sum(xs) / n,
            "p50_ms": xs[n // 2],
            "p95_ms": xs[min(n - 1, int(n * 0.95))],
            "steps": n,
        }
