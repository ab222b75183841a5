"""Smoke test of the PyTorch port (``srgan_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):

  1. build every CUDA source of the port (one ``nvcc`` per source, in
     parallel) and print the card's name and power limit;
  2. hold each kernel of the training path against its plain PyTorch
     version at the flagship loss shape (12, 512, 1024, 3) float32, TF32
     off, and time both with CUDA events (the median of 10 windows of 20
     calls), kernel and plain in turns;
  3. hold one pixel step on the card (kernels) against the same step on
     the CPU (plain versions) at a small size, same weights and batch;
  4. train the flagship configuration (F=64, 16 blocks, 4x subpixel head,
     fp32, HR 512x1024, batch 12) for one warm-up epoch and one counted
     epoch of 3 steps through ``Trainer.train_epoch`` on the device-cache
     path, then ``compute_score`` on one validation batch. The launch
     counts are zeroed just before the counted epoch and read just after:
     K1, K2 and K3 must each have launched once per step.

It prints a ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
line. It exits non-zero without a result where CUDA is unavailable or the
package is missing. The script imports nothing of JAX or ``srgan_tpu``.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12      # H100 SXM, fp32 outside the tensor cores
LOSS_SHAPE = (12, 512, 1024, 3)
# Arithmetic each kernel does per element (one op per add, mul, abs, max,
# compare; from the source): K1 two 6-tap Sobel sums (22), 2 abs, max,
# 3 for the sums; K2 the same edge map (25) + normalise and clamp (6) +
# weighted |hr-sr| and sums (5) + 9-tap DIFF (17) + abs, (1-e), mul, sum;
# K3 edge map + normalise (31), DIFF + sign + (1-e) field (20), the DIFF
# transpose (18), the edge term (5) and the sum.
OPS_PER_ELEMENT = {"edge_stats": 28, "loss_sums": 57, "loss_grad": 75}
LOSS_KERNEL_SYMBOLS = (
    "edge_stats_kernel", "edge_stats_finalize", "loss_sums_kernel",
    "loss_sums_finalize", "grad_kernel",
)
TPU_KERNELS = {
    "edge_stats": "srgan_tpu/ops/pallas/recon_loss_kernel.py:114",
    "loss_sums": "srgan_tpu/ops/pallas/recon_loss_kernel.py:144",
    "loss_grad": "srgan_tpu/ops/pallas/recon_loss_kernel.py:188",
}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def _device_events(prof):
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def time_ms(fn, windows: int = 5, reps: int = 20) -> list:
    """Milliseconds per call, one value for each of ``windows`` windows:
    CUDA events around ``reps`` back-to-back calls, after a warm-up. Every
    input is larger than half the 50 MB L2, so each call finds it cold."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return out


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs() / b.abs().clamp_min(1e-30))


def kernel_phase(rk, dev) -> dict:
    """Each kernel against its plain version on the same inputs."""
    from srgan_tpu_torch.ops.recon_loss import (
        edge_importance_map,
        reconstruction_loss_with_edges,
    )

    g = torch.Generator(device=dev).manual_seed(0)
    # Values on a 1/256 grid keep every stencil sum exact in fp32, so
    # sign(hr - sr) and sign(DIFF*sr) agree bit for bit between the kernel
    # and cuDNN; with arbitrary floats a handful of the 18.9M signs near 0
    # may flip from summation order alone.
    hr_u8 = torch.randint(0, 256, LOSS_SHAPE, generator=g, device=dev)
    noise = torch.randint(-12, 13, LOSS_SHAPE, generator=g, device=dev)
    hr = hr_u8.float() / 256.0
    sr = (hr_u8 + noise).clamp(0, 255).float() / 256.0
    n = hr.numel()
    out = {}

    # K1
    st_k = rk.edge_stats(hr)
    st_p = rk.edge_stats_plain(hr)
    torch.cuda.synchronize()
    err1 = max(rel_err(st_k[0], st_p[0]), rel_err(st_k[1], st_p[1]))
    check(err1 <= 1e-4, f"K1 mean/std rel err {err1} > 1e-4")
    out["edge_stats"] = dict(
        max_abs_err=float((st_k[:2] - st_p[:2]).abs().max()),
        fns=(lambda: rk.edge_stats(hr), lambda: rk.edge_stats_plain(hr)),
        bytes=n * 4,
    )

    # K1 + K2 against the whole plain loss
    e_k, tv_k = rk.loss_sums(hr, sr, st_k)
    e_p, tv_p = reconstruction_loss_with_edges(hr, sr, edge_importance_map(hr))
    torch.cuda.synchronize()
    err2 = max(rel_err(e_k, e_p), rel_err(tv_k, tv_p))
    check(err2 <= 1e-4, f"K1+K2 (edge, tv) rel err {err2} > 1e-4")
    st_scratch = st_k.clone()
    out["loss_sums"] = dict(
        max_abs_err=float(max((e_k - e_p).abs(), (tv_k - tv_p).abs())),
        fns=(lambda: rk.loss_sums(hr, sr, st_k),
             lambda: rk.loss_sums_plain(hr, sr, st_scratch)),
        bytes=2 * n * 4,
    )

    # K3 against autograd of the plain loss
    sr_req = sr.clone().requires_grad_(True)
    e, tv = reconstruction_loss_with_edges(hr, sr_req, edge_importance_map(hr))
    (g_ref,) = torch.autograd.grad(e + tv, sr_req)
    one = torch.ones((), device=dev)
    dsr = rk.loss_grad(hr, sr, st_k, one, one)
    torch.cuda.synchronize()
    err3 = float((dsr - g_ref).abs().max())
    tol3 = 1e-3 * float(g_ref.abs().max())
    check(err3 <= tol3, f"K3 max|d dsr| {err3} > 1e-3 max|g| = {tol3}")
    out["loss_grad"] = dict(
        max_abs_err=err3,
        fns=(lambda: rk.loss_grad(hr, sr, st_k, one, one),
             lambda: rk.loss_grad_plain(hr, sr, st_k, one, one)),
        bytes=3 * n * 4,
    )
    for name, rec in out.items():
        # kernel, plain, kernel, plain; the median over both turns' windows
        fn_k, fn_p = rec.pop("fns")
        runs = [time_ms(fn) for fn in (fn_k, fn_p, fn_k, fn_p)]
        win_k, win_p = runs[0] + runs[2], runs[1] + runs[3]
        rec["ms"] = statistics.median(win_k)
        rec["plain_ms"] = statistics.median(win_p)
        t_bytes = rec.pop("bytes") / HBM_BYTES_PER_S * 1e3
        t_ops = n * OPS_PER_ELEMENT[name] / FP32_OPS_PER_S * 1e3
        rec["bound_ms"] = max(t_bytes, t_ops)
        rec["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        print(f"kernel {name}: max|d|={rec['max_abs_err']:.3e} "
              f"ms={rec['ms']:.4f} (windows {min(win_k):.4f}..{max(win_k):.4f}) "
              f"plain ms={rec['plain_ms']:.4f} (windows "
              f"{min(win_p):.4f}..{max(win_p):.4f}) "
              f"bound_ms={rec['bound_ms']:.4f} ({rec['bound_by']})", flush=True)
    return out


def small_step_phase(dev) -> None:
    """One pixel step at a small size: kernels on the card against the
    plain versions on the CPU, from the same weights and batch."""
    from srgan_tpu_torch.config import ModelConfig
    from srgan_tpu_torch.models.srresnet import init_generator
    from srgan_tpu_torch.training.steps import generator_pixel_step
    from srgan_tpu_torch.training.train_state import TrainState

    cfg = ModelConfig(num_features=8, num_residuals=2, upscale_factor=4)
    rng = np.random.default_rng(0)
    hr = rng.random((2, 64, 128, 3), dtype=np.float32)
    lr_imgs = rng.random((2, 16, 32, 3), dtype=np.float32)
    results = []
    for d in (dev, torch.device("cpu")):
        state = TrainState(init_generator(cfg, seed=0, device=d))
        state, m = generator_pixel_step(
            state, torch.from_numpy(hr).to(d), torch.from_numpy(lr_imgs).to(d), 1e-3
        )
        results.append((m["packed"].cpu(), [p.detach().cpu() for p in state.params]))
    (pk_gpu, p_gpu), (pk_cpu, p_cpu) = results
    err = float(((pk_gpu - pk_cpu).abs() / pk_cpu.abs().clamp_min(1e-12))[:3].max())
    check(err <= 1e-4, f"small step losses rel err {err} > 1e-4")
    dp = max(float((a - b).abs().max()) for a, b in zip(p_gpu, p_cpu))
    check(dp <= 2e-3, f"small step params max|d| {dp} > 2*lr")
    print(f"small step: loss rel err {err:.3e}, params max|d| {dp:.3e}", flush=True)


def training_phase(rk, dev) -> dict:
    from srgan_tpu_torch.config import Config, DataConfig, TrainConfig
    from srgan_tpu_torch.data.dataset import ArrayDataset
    from srgan_tpu_torch.data.pipeline import TrainPipeline
    from srgan_tpu_torch.training.loop import Trainer

    cfg = Config(
        data=DataConfig(batch_size=12, device_cache="on"),
        train=TrainConfig(progress="off", score_max_batches=1),
    )
    h, w = cfg.data.hr_size

    def clips(n, seed):
        # smooth random images: bicubic upsampling of coarse noise
        g = torch.Generator(device=dev).manual_seed(seed)
        coarse = torch.rand((n, 3, h // 64, w // 64), generator=g, device=dev)
        img = torch.nn.functional.interpolate(coarse, size=(h, w), mode="bicubic")
        u8 = (img.clamp(0, 1) * 255).round().to(torch.uint8)
        return ArrayDataset(u8.permute(0, 2, 3, 1).contiguous().cpu().numpy())

    trainer = Trainer(cfg)  # the card, by default
    train_pipe = TrainPipeline(cfg.data, clips(36, 1), use_split=False,
                               seed=cfg.train.seed)
    val_pipe = TrainPipeline(cfg.data, clips(12, 2), use_split=False,
                             seed=cfg.train.seed + 1, augment=False)

    try:
        t0 = time.perf_counter()
        warm = trainer.train_epoch(train_pipe, 0)  # cuDNN set-up, dataset upload
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0

        rk.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        m = trainer.train_epoch(train_pipe, 1)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = dict(rk.launches)
        psnr, ssim = trainer.compute_score(val_pipe, 1)
        peak = torch.cuda.max_memory_allocated()
        profile_epoch(trainer, train_pipe, m["n_batches"])
    finally:
        train_pipe.close()
        val_pipe.close()

    steps = m["n_batches"]
    check(steps == 3, f"expected 3 steps, ran {steps}")
    for k in ("g_loss", "com_loss", "tv_loss"):
        check(math.isfinite(m[k]) and math.isfinite(warm[k]), f"{k} not finite")
    for name, c in counts.items():
        check(c == steps, f"{name} launched {c} times in {steps} steps")
    check(math.isfinite(psnr) and math.isfinite(ssim), "validation score not finite")
    step_ms = dt / steps * 1e3
    print(f"train: warm-up epoch {warm_s:.3f} s; counted epoch {steps} steps "
          f"{step_ms:.2f} ms/step {12 * steps / dt:.2f} img/s; "
          f"g_loss {warm['g_loss']:.5f} -> {m['g_loss']:.5f}; "
          f"psnr {psnr:.3f} ssim {ssim:.4f}; peak memory "
          f"{peak / 2**30:.2f} GiB; launches {counts}", flush=True)
    return counts


def profile_epoch(trainer, pipe, steps: int) -> None:
    """Where the time goes: one more epoch under torch.profiler. Device
    time by kernel, the loss kernels' share and the device's idle share
    (1 − busy/wall; the profiler's own host cost inflates wall)."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_epoch(pipe, 2)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict = {}
    for e in _device_events(prof):
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values())
    loss = sum(v for k, v in by_name.items()
               if any(n in k for n in LOSS_KERNEL_SYMBOLS))
    print(f"profile: {steps} steps, wall {wall_us / 1e3:.1f} ms, device busy "
          f"{busy / 1e3:.1f} ms (idle share {1 - busy / wall_us:.3f}); loss "
          f"kernels K1-K3 {loss / 1e3:.3f} ms ({loss / busy:.4f} of busy)",
          flush=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    for name, us in top[:10]:
        print(f"profile:   {us / 1e3 / steps:9.3f} ms/step  {name[:100]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    from srgan_tpu_torch.ops.cuda import recon_loss_kernel as rk
    from srgan_tpu_torch.ops.cuda.build import build
    from srgan_tpu_torch.utils.platform import disable_tf32

    t0 = time.perf_counter()
    reports = build()
    print(f"build: {len(reports)} source(s) compiled in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "entry function" in line or "registers" in line:
                print(f"ptxas {name}: {line.strip()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    dev = torch.device("cuda")
    disable_tf32()
    kernels = kernel_phase(rk, dev)
    small_step_phase(dev)
    counts = training_phase(rk, dev)

    line = []
    for name, rec in kernels.items():
        line.append({
            "name": f"recon_{name}",
            "route": "cuda",
            "source": "srgan_tpu_torch/csrc/recon_loss.cu",
            "replaces": TPU_KERNELS[name],
            "launches": counts[name],
            **rec,
            "library_ms": None,  # no single PyTorch call computes it
        })
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
