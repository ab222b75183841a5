"""Structured metrics logging + step timing (the port's own copy of
``srgan_tpu/utils/logging.py``; standard library only).

The reference's observability is tqdm postfixes and prints (SURVEY.md §5);
here every epoch appends one JSON line (losses, PSNR/SSIM, images/sec) to
``results/{prefix}_metrics.jsonl`` so runs are machine-readable, plus the
same PNG artifacts for parity.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class MetricsLogger:
    """Per-epoch JSONL records. Lazily truncates on the first log unless
    ``append=True`` (resume): a fresh run otherwise inherits a crashed
    attempt's records and the file shows duplicate epochs."""

    def __init__(self, results_dir: str, prefix: str, append: bool = False):
        os.makedirs(results_dir, exist_ok=True)
        self.path = os.path.join(results_dir, f"{prefix}_metrics.jsonl")
        self._mode = "a" if append else "w"

    def log(self, record: dict) -> None:
        with open(self.path, self._mode) as f:
            self._mode = "a"
            f.write(json.dumps(record) + "\n")

    def read_records(self) -> list:
        """Existing records on disk (empty when the file is absent)."""
        if not os.path.exists(self.path):
            return []
        with open(self.path) as f:
            return [json.loads(line) for line in f if line.strip()]


class ProgressLine:
    """In-epoch live progress — the reference's per-batch tqdm postfix
    (``src/train.py:145,166``) without the per-batch host sync it implies:
    the loop feeds this from the LAGGED metric drain, so the displayed
    losses trail by one batch and the device pipeline never stalls.

    ``mode``: "auto" renders only when stderr is a TTY (logs and CI stay
    clean), "always" forces it, "off" disables. One ``\\r``-rewritten
    stderr line; finished with a newline-free clear so the epoch summary
    print lands on a clean line.
    """

    def __init__(self, mode: str = "auto", total: Optional[int] = None):
        import sys

        self.total = total
        self._out = sys.stderr
        self._on = mode == "always" or (
            mode == "auto" and self._out.isatty()
        )
        self._width = 0

    def update(self, epoch: int, batch: int, losses: dict,
               images_per_sec: float) -> None:
        if not self._on:
            return
        tot = f"/{self.total}" if self.total else ""
        parts = " ".join(
            f"{k}={v:.4f}" for k, v in losses.items() if v is not None
        )
        line = (
            f"epoch {epoch + 1} [{batch}{tot}] {parts} "
            f"({images_per_sec:.1f} img/s)"
        )
        pad = max(0, self._width - len(line))
        self._out.write("\r" + line + " " * pad)
        self._out.flush()
        self._width = len(line)

    def close(self) -> None:
        if self._on and self._width:
            self._out.write("\r" + " " * self._width + "\r")
            self._out.flush()
            self._width = 0


class Throughput:
    """images/sec over a window — the BASELINE headline metric. The loop
    adds a batch's images when its losses are drained (the host has read
    them, so the card has finished the batch), not when it is queued."""

    def __init__(self):
        self.images = 0
        self.start: Optional[float] = None

    def begin(self):
        self.start = time.perf_counter()
        self.images = 0

    def add(self, n: int):
        self.images += n

    def images_per_sec(self) -> float:
        if not self.start or not self.images:
            return 0.0
        return self.images / (time.perf_counter() - self.start)
