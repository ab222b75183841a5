"""SwinIR through the harness (``arch/swinir.py``, the configuration
``swinir-m-x4-s64w8-bf16`` and the cell ``swinir4-train-pixel``) on the
CPU: the arch file's shapes, work and reference against the port's
``models/swinir.py``, and the cell at a small size of the same structure
(embed 24, 2 groups of 2 layers, 2 heads of 12, window 4 with shift 2,
LR 16x16, batch 4), in fp32 so that the program and the reference agree
to rounding."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import pytest
import torch

from h100bench import arch, control, run, work
from h100bench.tests import small

ROOT = Path(__file__).resolve().parents[2]
CELL = "swinir4-train-pixel"
CPU = torch.device("cpu")
SMALL_MODEL = {"num_features": 8, "embed_dim": 24, "depths": [2, 2], "num_heads": [2, 2],
               "window_size": 4, "compute_dtype": "float32"}


def _config():
    return json.loads((ROOT / "h100bench/configs/swinir-m-x4-s64w8-bf16.json").read_text())


def _port_cfg(m):
    from srgan_tpu_torch.config import ModelConfig

    keys = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in m.items()
                          if k in keys})


def overrides() -> dict:
    fl = ["--arch", "swinir", "--batch-size", "4", "--hr-height", "64", "--hr-width", "64",
          "--upscale", "4", "--num-features", "8", "--embed-dim", "24", "--depths", "2,2",
          "--heads", "2,2", "--window", "4", "--lr-generator", "0.0002", "--validate-every", "0"]
    return {"config": {"train_flags": fl, "model": SMALL_MODEL,
                       "data": {"hr_size": [64, 64], "batch_size": 4}},
            "traffic": {"train_images": 40, "val_images": 12, "window_opens_at_batch": 2}}


def test_param_shapes_are_the_ports_and_the_papers():
    """Names and order of the port's ``named_parameters``, and 11,900,199 at
    SwinIR-M's published widths."""
    m = _config()["model"]
    mod = arch.load(m)
    shapes = mod.param_shapes(m)
    port = mod.port_model(_port_cfg(m))
    assert [(k, tuple(v.shape)) for k, v in port.named_parameters()] == \
        [(k, tuple(s)) for k, s in shapes]
    assert sum(torch.Size(s).numel() for _, s in shapes) == 11_900_199


@pytest.mark.parametrize("hw", [(16, 16), (12, 20)])
def test_reference_equals_the_port_in_fp32(hw):
    m = {**_config()["model"], **SMALL_MODEL}
    mod = arch.load(m)
    from h100bench import inputs

    w = inputs.weights(mod.param_shapes(m), 3, CPU, mod.param_scale)
    port = mod.port_model(_port_cfg(m))
    with torch.no_grad():
        for k, p in port.named_parameters():
            p.copy_(w[k])
    x = torch.rand(2, *hw, 3, generator=torch.Generator().manual_seed(0))
    want = mod.forward(w, x, m)
    got = port(x)
    assert got.shape == want.shape == (2, hw[0] * 4, hw[1] * 4, 3)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    # the checkpointed graph gives the same gradient as the port's
    p = {k: v.clone().requires_grad_() for k, v in w.items()}
    g_ref = torch.autograd.grad(mod.forward(p, x, m).square().mean(), list(p.values()))
    g_port = torch.autograd.grad(port(x).square().mean(), list(port.parameters()))
    for a, b in zip(g_port, g_ref):
        assert float((a - b).norm()) <= 1e-4 * max(float(b.norm()), 1e-12)


def test_work_counts_the_published_forward():
    """107.1 GFLOP an image's forward at LR 64x64: the Swin layers 78 %
    (83.2), the convs the rest."""
    m = _config()["model"]
    mod = arch.load(m)
    fwd = sum(it.flops(1) for it in mod.forward_ops(m, (64, 64)))
    assert fwd / 1e9 == pytest.approx(107.12, abs=0.01)
    swin = sum(it.flops(1) for it in mod.forward_ops(m, (64, 64)) if it.op != "conv")
    assert swin / fwd == pytest.approx(0.777, abs=0.001)
    w = work.Work("bfloat16")
    w.add(mod.train_ops(m, (64, 64)), 32)
    assert w.flops / 1e12 == pytest.approx(10.39, abs=0.01)
    assert set(w.min_s) == {"conv", "matmul", "window_attn"}
    # the attention's bound is its bytes: ~6.1 ms a step of 32
    assert w.min_s["window_attn"] * 1e3 == pytest.approx(6.08, abs=0.05)


def test_cell_runs_correct_on_the_cpu():
    out = run.execute(small.args(CELL, seed=2**31 + 11, seconds=0.5), device=CPU,
                      overrides=overrides())
    assert out["correct"], out["checks"]
    assert out["metrics"]["train_img_s"]["value"] > 0


def test_cell_traced_reads_its_metrics():
    """A traced run reports ``mfu.train`` and, with no kernel on the CPU,
    leaves the attention's two metrics out."""
    out = run.execute(small.args(CELL, seed=5, seconds=0.5, trace=1), device=CPU,
                      overrides=overrides())
    assert "mfu.train" in out["metrics"]
    assert "window_attn_ms.train" not in out["metrics"]
    assert "window_attn_roofline" not in out["metrics"]


def test_fp8_control_fails_the_cell():
    spec = run.load_cell(CELL)
    for key, val in overrides().items():
        run._merge(getattr(spec, key), val)
    checks = control.train_readings(spec, 2**31 + 3, "fp8", CPU)
    ok, judged = __import__("h100bench.compare", fromlist=["judge"]).judge(checks, spec.limits)
    assert not ok, judged
