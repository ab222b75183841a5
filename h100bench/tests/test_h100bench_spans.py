"""A traced run of each cell at small sizes on the CPU (``small.py``): the
window's spans are read by the span readers. The CPU gives no device
events, so the readers of device idle stay silent; those of the host's
clock give numbers."""

from __future__ import annotations

import pytest
import torch

from h100bench import run
from h100bench.tests import small

HOST_READERS = {
    "sr4-train-pixel": ("loop.score_share", "loop.snapshot_share", "step.host_syncs"),
    "sr4pool3-train-gan": ("loop.score_share", "loop.snapshot_share", "step.host_syncs"),
    "sr4-serve-photos": ("serve.upload_ms",),
}


@pytest.mark.parametrize("cell", sorted(HOST_READERS))
def test_traced_run_reads_the_spans(cell):
    from srgan_tpu_torch.utils import profiling

    profiling.clear_spans()  # the records of an earlier session in this process
    out = run.execute(small.args(cell, seed=2**31 + 5, seconds=2.0, trace=1),
                      device=torch.device("cpu"), overrides=small.overrides(cell))
    assert out["correct"], out["checks"]
    metrics = out["metrics"]
    for name in HOST_READERS[cell]:
        assert metrics[name]["value"] >= 0.0, name
    assert "step.idle_ms" not in metrics and "serve.idle_ms" not in metrics
    if cell == "sr4-serve-photos":
        assert metrics["serve.upload_ms"]["value"] > 0.0
    else:
        # the stop's snapshot is in every window; scoring in those that end an epoch
        assert metrics["step.host_syncs"]["value"] == pytest.approx(1.0)
        assert metrics["loop.snapshot_share"]["value"] > 0.0
        ends = metrics["loop.score_share"]["value"] + metrics["loop.snapshot_share"]["value"]
        assert ends <= metrics["loop.epoch_end_share"]["value"]
