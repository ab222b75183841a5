"""Smoke test of the PyTorch port (``srgan_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):

  1. build every CUDA source of the port (one ``nvcc`` per source, in
     parallel), print the ``ptxas`` registers, shared memory and spills of
     every kernel (one summary line for each band kernel of K1, K2 and K3
     at C=3) and the card's name and power limit;
  2. hold each kernel of the training path against its plain PyTorch
     version (float64 for K2 and K3: the TV sum cancels) at the flagship
     loss shape (12, 512, 1024, 3) float32, TF32 off, on inputs whose TV
     term is live; check that the shape takes each kernel's vector path
     and that two calls of each give the same bits; time each kernel and
     its plain version with CUDA events (the median of 10 windows of 20
     calls), kernel and plain in turns, and each kernel and finalise
     launch by its device time under the profiler, with the GB/s and the
     share of the bound that gives, and the wrapper's host gap (ms by
     events minus device ms);
  3. hold one pixel step on the card (kernels) against the same step on
     the CPU (plain versions) at a small size, same weights and batch;
  4. train the flagship configuration (F=64, 16 blocks, 4x subpixel head,
     fp32, HR 512x1024, batch 12) for one warm-up epoch and one counted
     epoch of 3 steps through ``Trainer.train_epoch`` on the device-cache
     path, then ``compute_score`` on one validation batch. The launch
     counts are zeroed just before the counted epoch and read just after:
     K1, K2 and K3 must each have launched once per step, on their
     vector path;
  5. the residual tower (``residual_tower``, kernels K4 and K5) at the
     flagship tower shape x (12, 128, 256, 64), N=16, in f32 and bf16:
     K4 and K5 against the plain version and its autograd, launch counts
     (one ``tower_fwd`` per forward, one ``tower_bwd`` per backward), two
     calls bit-identical, the conv and wgrad kernels each mode launches
     (bf16: the tensor-core tiles only; f32: the SIMT tiles only) with
     each tile's device ms and TFLOP/s per launch (and ms per launch with
     and without GN1 + ReLU on its operand), times
     beside the bound, the plain version and the cuDNN chain (the port's
     ``ResidualBlock`` x16 with zero conv biases), achieved TFLOP/s of the
     kernel and the chain, and peak memory.

It prints a ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
line. It exits non-zero without a result where CUDA is unavailable or the
package is missing. The script imports nothing of JAX or ``srgan_tpu``.
"""

from __future__ import annotations

import json
import math
import re
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
BF16_OPS_PER_S = 989e12     # H100 SXM, bf16 dense tensor cores
TOWER_SHAPE = (12, 128, 256, 64)  # the LR of HR 512x1024 at 4x, F=64
TOWER_BLOCKS = 16
LOSS_SHAPE = (12, 512, 1024, 3)
# Arithmetic each kernel does per element (one op per add, mul, abs, max,
# compare; from the source): K1 two 6-tap Sobel sums (22), 2 abs, max,
# 3 for the sums; K2 the same edge map (25) + normalise and clamp (6) +
# weighted |hr-sr| and sums (5) + 9-tap DIFF (17) + abs, (1-e), mul, sum;
# K3 edge map + normalise (31), DIFF + sign + (1-e) field (20), the DIFF
# transpose (18), the edge term (5) and the sum.
OPS_PER_ELEMENT = {"edge_stats": 28, "loss_sums": 57, "loss_grad": 75}
LOSS_KERNEL_RE = re.compile(
    r"\b(edge_stats_kernel|edge_stats_finalize|loss_sums_kernel|loss_sums_finalize"
    r"|grad_kernel)\b")
# each wrapper's kernel and its finalise launch
LOSS_KERNELS = {
    "edge_stats": ("edge_stats_kernel", "edge_stats_finalize"),
    "loss_sums": ("loss_sums_kernel", "loss_sums_finalize"),
    "loss_grad": ("grad_kernel", None),
}
TPU_KERNELS = {
    "edge_stats": "srgan_tpu/ops/pallas/recon_loss_kernel.py:114",
    "loss_sums": "srgan_tpu/ops/pallas/recon_loss_kernel.py:144",
    "loss_grad": "srgan_tpu/ops/pallas/recon_loss_kernel.py:188",
    "tower_fwd": "srgan_tpu/ops/pallas/residual_tower_kernel.py:208",
    "tower_bwd": "srgan_tpu/ops/pallas/residual_tower_kernel.py:248",
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


def loss_inputs(dev):
    """hr black with one bright square an image, sr rough and independent,
    both on a 1/256 grid. Values on the grid keep every stencil sum exact in
    fp32, so sign(hr - sr) and sign(DIFF*sr) agree bit for bit between the
    kernels and the plain version; with arbitrary floats a handful of the
    18.9M signs near 0 may flip from summation order alone. The edges are
    sparse, so the TV term is live (tv mean > 0) and so is its gradient."""
    rng = np.random.default_rng(0)
    b, h, w, c = LOSS_SHAPE
    k = h // 6
    hr_u8 = np.zeros(LOSS_SHAPE, np.uint8)
    for i in range(b):
        y, x = rng.integers(0, h - k), rng.integers(0, w - k)
        hr_u8[i, y:y + k, x:x + k] = rng.integers(128, 256, c)
    g = torch.Generator(device=dev).manual_seed(0)
    sr_u8 = torch.randint(0, 256, LOSS_SHAPE, generator=g, device=dev)
    return torch.from_numpy(hr_u8).to(dev).float() / 256.0, sr_u8.float() / 256.0


def loss_device_times(fns: dict, reps: int = 20) -> dict:
    """Device ms per launch of each loss kernel and finalise, from the
    profiler, over ``reps`` calls of each wrapper: the wrappers' host cost
    (which back-to-back CUDA-event windows may include) cannot hide them."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for fn in fns.values():
            for _ in range(reps):
                fn()
        torch.cuda.synchronize()
    by_kernel: dict = {}  # symbol -> [launches, device us]
    for e in _device_events(prof):
        m = LOSS_KERNEL_RE.search(e.name)
        if m:
            rec = by_kernel.setdefault(m.group(1), [0, 0.0])
            rec[0] += 1
            rec[1] += e.time_range.elapsed_us()
    out = {}
    for name, symbols in LOSS_KERNELS.items():
        for sym in filter(None, symbols):
            n, us = by_kernel.get(sym, (0, 0.0))
            check(n == reps, f"profiler saw {n} launches of {sym}, expected {reps}")
            out[sym] = us / n / 1e3
    return out


def ptxas_resources(report: str) -> dict:
    """{mangled entry: (registers, smem bytes, spill store + load bytes)}
    from ``nvcc -Xptxas -v`` output."""
    out, name, spill = {}, None, 0
    for line in report.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            name, spill = m.group(1), 0
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spill = int(m.group(1)) + int(m.group(2))
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            smem = re.search(r"(\d+) bytes smem", line)
            out[name] = (int(m.group(1)), int(smem.group(1)) if smem else 0, spill)
    return out


def loss_ptxas(report: str) -> dict:
    """The band kernels' resources at C=3, by (wrapper, path)."""
    out = {}
    for name, res in ptxas_resources(report).items():
        m = re.search(r"\d+(edge_stats|loss_sums|grad)_kernelILi3ELb([01])E", name)
        if m:
            wrapper = "loss_grad" if m.group(1) == "grad" else m.group(1)
            path = "vec" if m.group(2) == "1" else "scalar"
            out[(wrapper, path)] = res
            print(f"ptxas {m.group(1)}_kernel<3, {path}>: {res[0]} registers, "
                  f"{res[1]} bytes smem, {res[2]} bytes spilled", flush=True)
    check(set(out) == {(w, p) for w in LOSS_KERNELS for p in ("vec", "scalar")},
          f"ptxas report lacks band kernels: {sorted(out)}")
    return out


def kernel_phase(rk, dev) -> dict:
    """Each kernel against its plain version on the same inputs; the path
    the flagship shape takes, two calls bit for bit, times."""
    from srgan_tpu_torch.ops.recon_loss import (
        edge_importance_map,
        reconstruction_loss_with_edges,
    )

    hr, sr = loss_inputs(dev)
    n = hr.numel()
    out = {}
    rk.reset_launches()

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

    # K1 + K2 against the whole plain loss, in float64: the TV sum cancels,
    # so two fp32 summation orders already differ by ~1e-4 relative
    e_k, tv_k = rk.loss_sums(hr, sr, st_k)
    hr64, sr64 = hr.double(), sr.double()
    e_p, tv_p = reconstruction_loss_with_edges(hr64, sr64, edge_importance_map(hr64))
    torch.cuda.synchronize()
    check(float(st_k[3]) > 0, f"tv mean {float(st_k[3])} <= 0: the TV term is gated")
    err2 = max(rel_err(e_k.double(), e_p), rel_err(tv_k.double(), tv_p))
    check(err2 <= 1e-4, f"K1+K2 (edge, tv) rel err {err2} > 1e-4")
    st_scratch = st_k.clone()
    out["loss_sums"] = dict(
        max_abs_err=float(max((e_k.double() - e_p).abs(), (tv_k.double() - tv_p).abs())),
        fns=(lambda: rk.loss_sums(hr, sr, st_k),
             lambda: rk.loss_sums_plain(hr, sr, st_scratch)),
        bytes=2 * n * 4,
    )

    # K3 against autograd of the plain loss, in float64
    sr_req = sr64.clone().requires_grad_(True)
    e, tv = reconstruction_loss_with_edges(hr64, sr_req, edge_importance_map(hr64))
    (g_ref,) = torch.autograd.grad(e + tv, sr_req)
    del e, tv, sr_req, hr64, sr64
    one = torch.ones((), device=dev)
    dsr = rk.loss_grad(hr, sr, st_k, one, one)
    torch.cuda.synchronize()
    paths = dict(rk.paths)
    check(paths == {f"{name}_{p}": int(p == "vec") for name in LOSS_KERNELS
                    for p in ("vec", "scalar")},
          f"flagship shape: paths {paths}, expected the vector path")
    err3 = float((dsr.double() - g_ref).abs().max())
    tol3 = 1e-3 * float(g_ref.abs().max())
    del g_ref
    check(err3 <= tol3, f"K3 max|d dsr| {err3} > 1e-3 max|g| = {tol3}")
    out["loss_grad"] = dict(
        max_abs_err=err3,
        fns=(lambda: rk.loss_grad(hr, sr, st_k, one, one),
             lambda: rk.loss_grad_plain(hr, sr, st_k, one, one)),
        bytes=3 * n * 4,
    )

    # two calls bit for bit: fixed sum orders, no float atomics
    stats = [rk.edge_stats(hr) for _ in range(2)]
    st_a, st_b = st_k.clone(), st_k.clone()
    sums = [rk.loss_sums(hr, sr, st) for st in (st_a, st_b)]
    grads = [rk.loss_grad(hr, sr, st_k, one, one) for _ in range(2)]
    torch.cuda.synchronize()
    check(torch.equal(*stats) and torch.equal(stats[0][:2], st_k[:2]),
          "K1: two calls differ")
    check(all(torch.equal(a, b) for a, b in zip(sums[0], sums[1]))
          and torch.equal(st_a, st_b), "K2: two calls differ")
    check(torch.equal(*grads), "K3: two calls differ")
    del stats, sums, grads, dsr
    print(f"kernels: flagship paths {paths}; K1, K2 and K3 bit-identical over "
          f"two calls; tv mean {float(st_k[3]):.6e}", flush=True)

    dev_ms = loss_device_times({name: rec["fns"][0] for name, rec in out.items()})
    for name, rec in out.items():
        # kernel, plain, kernel, plain; the median over both turns' windows
        fn_k, fn_p = rec.pop("fns")
        runs = [time_ms(fn) for fn in (fn_k, fn_p, fn_k, fn_p)]
        win_k, win_p = runs[0] + runs[2], runs[1] + runs[3]
        rec["ms"] = statistics.median(win_k)
        rec["plain_ms"] = statistics.median(win_p)
        n_bytes = rec.pop("bytes")
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = n * OPS_PER_ELEMENT[name] / FP32_OPS_PER_S * 1e3
        rec["bound_ms"] = max(t_bytes, t_ops)
        rec["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        kern, fin = LOSS_KERNELS[name]
        rec["kernel_device_ms"] = dev_ms[kern]
        rec["finalize_device_ms"] = dev_ms[fin] if fin else None
        rec["device_ms"] = dev_ms[kern] + (dev_ms[fin] if fin else 0.0)
        rec["gb_per_s"] = n_bytes / (rec["device_ms"] * 1e-3) / 1e9
        rec["bound_share"] = rec["bound_ms"] / rec["device_ms"]
        # the wrapper's host cost, as far as back-to-back calls show it
        rec["host_gap_ms"] = rec["ms"] - rec["device_ms"]
        rec["path"] = "vec"
        print(f"kernel {name}: max|d|={rec['max_abs_err']:.3e} "
              f"ms={rec['ms']:.4f} (windows {min(win_k):.4f}..{max(win_k):.4f}) "
              f"plain ms={rec['plain_ms']:.4f} (windows "
              f"{min(win_p):.4f}..{max(win_p):.4f}) "
              f"bound_ms={rec['bound_ms']:.4f} ({rec['bound_by']}); device ms a "
              f"launch {kern} {dev_ms[kern]:.4f}"
              + (f" + {fin} {dev_ms[fin]:.4f}" if fin else "")
              + f" = {rec['device_ms']:.4f}: {rec['gb_per_s']:.0f} GB/s, "
              f"{rec['bound_share']:.3f} of the bound "
              f"(by events {rec['bound_ms'] / rec['ms']:.3f}); host gap "
              f"{rec['host_gap_ms']:.4f} ms", flush=True)
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
        paths = dict(rk.paths)
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
    for name in LOSS_KERNELS:
        check(paths[f"{name}_vec"] == steps and paths[f"{name}_scalar"] == 0,
              f"{name}: paths {paths}, expected the vector path every step")
    check(math.isfinite(psnr) and math.isfinite(ssim), "validation score not finite")
    step_ms = dt / steps * 1e3
    print(f"train: warm-up epoch {warm_s:.3f} s; counted epoch {steps} steps "
          f"{step_ms:.2f} ms/step {12 * steps / dt:.2f} img/s; "
          f"g_loss {warm['g_loss']:.5f} -> {m['g_loss']:.5f}; "
          f"psnr {psnr:.3f} ssim {ssim:.4f}; peak memory "
          f"{peak / 2**30:.2f} GiB; launches {counts}; paths {paths}", flush=True)
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
    loss = sum(v for k, v in by_name.items() if LOSS_KERNEL_RE.search(k))
    print(f"profile: {steps} steps, wall {wall_us / 1e3:.1f} ms, device busy "
          f"{busy / 1e3:.1f} ms (idle share {1 - busy / wall_us:.3f}); loss "
          f"kernels K1-K3 {loss / 1e3:.3f} ms ({loss / busy:.4f} of busy)",
          flush=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    for name, us in top[:10]:
        print(f"profile:   {us / 1e3 / steps:9.3f} ms/step  {name[:100]}")


def _tower_params(tk, dev, g, margin: bool):
    """Conv weights at the model's lecun scale, std 1/sqrt(9F); GroupNorm
    scale and bias as in the JAX tests (1.1, 0.05; 0.9, -0.02). ``margin``:
    GN1 scale 0.1 and bias 1.0, so GN1's output stays above 0 and the ReLU
    never clips."""
    n, f = TOWER_BLOCKS, TOWER_SHAPE[-1]
    w = lambda: torch.randn((n, 3, 3, f, f), generator=g, device=dev) / math.sqrt(9 * f)
    full = lambda v: torch.full((n, f), v, device=dev)
    return tk.TowerParams(w(), full(0.1 if margin else 1.1),
                          full(1.0 if margin else 0.05), w(), full(0.9), full(-0.02))


def _tower_grads(fn, tk, x, params, dy, cd):
    """[y, dx, d params...] of fn under autograd, with dy as the cotangent."""
    xr = x.clone().requires_grad_(True)
    pr = [p.clone().requires_grad_(True) for p in params]
    y = fn(xr, tk.TowerParams(*pr), cd)
    y.backward(dy)
    return [y.detach(), xr.grad, *(p.grad for p in pr)]


def _errors(got, want):
    """(max abs err, max of max|Δ|/max|g| and of ||Δ||/||g||) over outputs."""
    abs_err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    rel = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(got, want)]
    fro = [float((a - b).norm() / b.norm()) for a, b in zip(got, want)]
    return abs_err, rel, fro


def _cudnn_chain(tk, params, cd):
    """The port's ResidualBlock x16, zero conv biases, NCHW, in ``cd``."""
    from srgan_tpu_torch.models.srresnet import ResidualBlock

    f = TOWER_SHAPE[-1]
    blocks = []
    for i in range(TOWER_BLOCKS):
        blk = ResidualBlock(f)
        with torch.no_grad():
            for conv, w in ((blk.conv1, params.w1[i]), (blk.conv2, params.w2[i])):
                conv.weight.copy_(w.permute(3, 2, 0, 1))
                conv.bias.zero_()
            for norm, s, b in ((blk.norm1, params.s1[i], params.b1[i]),
                               (blk.norm2, params.s2[i], params.b2[i])):
                norm.weight.copy_(s)
                norm.bias.copy_(b)
        blocks.append(blk)
    return torch.nn.Sequential(*blocks).to(device=params.w1.device, dtype=cd)


def tower_determinism(tk, x, params, dy, cd, tag: str) -> None:
    """Two calls of K4 and of K5 on the same inputs agree bit for bit: no
    float atomics, every reduction in a fixed order."""
    ys = [tk.tower_fwd(x, params, cd) for _ in range(2)]
    outs = [tk.tower_bwd(dy, x, params, cd) for _ in range(2)]
    torch.cuda.synchronize()
    check(torch.equal(*ys), f"K4 {tag}: two calls differ")
    (dx1, g1), (dx2, g2) = outs
    check(all(torch.equal(a, b) for a, b in zip([dx1, *g1], [dx2, *g2])),
          f"K5 {tag}: two calls differ")
    print(f"tower {tag}: K4 and K5 bit-identical over two calls", flush=True)


def tower_kernel_names(tk, x, params, dy, cd, tag: str) -> None:
    """The kernels that one K4 and one K5 call launch, by the profiler,
    with their device time: the bf16 mode's convs and weight gradients run
    only the tensor-core tiles (``*_tc_kernel``), the f32 mode's only the
    SIMT ones."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tk.tower_fwd(x, params, cd)
        tk.tower_bwd(dy, x, params, cd)
        torch.cuda.synchronize()
    by_kernel: dict = {}  # name -> [launches, device us]
    by_operand: dict = {}  # (tile, GN1 + ReLU on its operand) -> [launches, device us]
    for e in _device_events(prof):
        m = re.search(r"\w+_kernel\b", e.name)
        name = m.group(0) if m else e.name[:40]
        us = e.time_range.elapsed_us()
        recs = [by_kernel.setdefault(name, [0, 0.0])]
        # the tiles' last template argument is GN_IN: conv2 and dW2 read
        # relu(GN1(c1)), conv1, dX and dW1 a plain operand
        if re.fullmatch(r"(conv|wgrad)(_tc)?_kernel", name):
            gn = re.search(rf"{name}<[^<>]*\b(true|false)>", e.name)
            if gn:
                recs.append(by_operand.setdefault((name, gn.group(1) == "true"), [0, 0.0]))
        for rec in recs:
            rec[0] += 1
            rec[1] += us
    tiles = {k for k in by_kernel if re.fullmatch(r"(conv|wgrad)(_tc)?_kernel", k)}
    want = ({"conv_tc_kernel", "wgrad_tc_kernel"} if cd == torch.bfloat16
            else {"conv_kernel", "wgrad_kernel"})
    check(tiles == want, f"tower {tag}: conv/wgrad kernels {tiles}, expected {want}")
    b, h, w, f = x.shape
    tile_ops = 2 * b * h * w * 9 * f * f  # one conv, or one weight gradient
    print(f"tower {tag}: one K4 + one K5 call, device ms (launches) by kernel: "
          + "; ".join(f"{k} {us / 1e3:.3f} ({n})" for k, (n, us)
                      in sorted(by_kernel.items(), key=lambda kv: -kv[1][1]))
          + "; per launch of each tile: "
          + "; ".join(f"{k} {us / n / 1e3:.4f} ms {tile_ops / (us / n * 1e-6) / 1e12:.1f} "
                      f"TFLOP/s" for k, (n, us) in sorted(by_kernel.items()) if k in tiles)
          + "; by operand: "
          + "; ".join(f"{k}{' (GN1 + ReLU)' if gn else ''} {us / n / 1e3:.4f} ms ({n})"
                      for (k, gn), (n, us) in sorted(by_operand.items())),
          flush=True)


def tower_dtype_phase(tk, dev, cd) -> list:
    tag = "f32" if cd == torch.float32 else "bf16"
    tol = 1e-3 if cd == torch.float32 else 2e-2
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(TOWER_SHAPE, generator=g, device=dev)
    dy = torch.randn(TOWER_SHAPE, generator=g, device=dev)
    p_margin = _tower_params(tk, dev, g, margin=True)
    p_jax = _tower_params(tk, dev, g, margin=False)

    # the main path: forward and backward through the op, counted
    tk.reset_launches()
    got = _tower_grads(tk.residual_tower, tk, x, p_margin, dy, cd)
    torch.cuda.synchronize()
    counts = dict(tk.launches)
    check(counts == {"tower_fwd": 1, "tower_bwd": 1},
          f"tower {tag}: launches {counts}, expected one forward, one backward")
    want = _tower_grads(tk.residual_tower_plain, tk, x, p_margin, dy, cd)
    fwd_abs, fwd_rel, _ = _errors(got[:1], want[:1])
    bwd_abs, bwd_rel, bwd_fro = _errors(got[1:], want[1:])
    del got, want
    check(fwd_rel[0] <= tol, f"K4 {tag}: max|dy| {fwd_rel[0]:.3e}*max > {tol}")
    names = ["dx", *tk.TowerParams._fields]
    for name, r in zip(names, bwd_rel):
        check(r <= tol, f"K5 {tag} {name}: max|d| {r:.3e}*max > {tol}")

    # the JAX tests' GN values: the ReLU clips, and a value within rounding
    # of a kink may fall on the other side in the kernel and in the plain
    # version, where the gradient jumps. K4 is held to the bar; K5's
    # gradients only to a sanity bound on ||d||/||g||.
    y_k = tk.residual_tower(x, p_jax, cd)
    y_p = tk.residual_tower_plain(x, p_jax, cd)
    _, kink_fwd_rel, _ = _errors([y_k], [y_p])
    del y_k, y_p
    check(kink_fwd_rel[0] <= tol,
          f"K4 {tag} (ReLU clips): max|dy| {kink_fwd_rel[0]:.3e}*max > {tol}")
    got = _tower_grads(tk.residual_tower, tk, x, p_jax, dy, cd)
    want = _tower_grads(tk.residual_tower_plain, tk, x, p_jax, dy, cd)
    _, kink_rel, kink_fro = _errors(got[1:], want[1:])
    del got, want
    sanity = 1e-2 if cd == torch.float32 else 1e-1
    check(max(kink_fro) <= sanity,
          f"K5 {tag} (ReLU clips): ||d||/||g|| {max(kink_fro):.3e} > {sanity}")
    print(f"tower {tag}: margin K4 max|d|/max {fwd_rel[0]:.3e}; K5 max|d|/max "
          + " ".join(f"{n}={r:.2e}" for n, r in zip(names, bwd_rel))
          + f"; ReLU clips: K4 {kink_fwd_rel[0]:.3e}, K5 max|d|/max "
          + " ".join(f"{n}={r:.2e}" for n, r in zip(names, kink_rel))
          + " ||d||/||g|| " + " ".join(f"{n}={r:.2e}" for n, r in zip(names, kink_fro)),
          flush=True)
    tower_determinism(tk, x, p_margin, dy, cd, tag)
    tower_kernel_names(tk, x, p_margin, dy, cd, tag)

    # times: kernel, plain, cuDNN chain in turns, 5 windows of 2 calls each
    chain = _cudnn_chain(tk, p_margin, cd)
    xn = x.permute(0, 3, 1, 2).contiguous().to(cd)
    dyn = dy.permute(0, 3, 1, 2).contiguous().to(cd)
    chain_params = list(chain.parameters())

    def plain_fwd_bwd():
        xr = x.clone().requires_grad_(True)
        pr = [p.clone().requires_grad_(True) for p in p_margin]
        y = tk.residual_tower_plain(xr, tk.TowerParams(*pr), cd)
        torch.autograd.grad(y, [xr, *pr], dy)

    def chain_fwd_bwd():
        xr = xn.clone().requires_grad_(True)
        torch.autograd.grad(chain(xr), [xr, *chain_params], dyn)

    def chain_fwd():
        with torch.no_grad():
            chain(xn)

    def plain_fwd():
        with torch.no_grad():
            tk.residual_tower_plain(x, p_margin, cd)

    fns = {
        "tower_fwd": (lambda: tk.tower_fwd(x, p_margin, cd), plain_fwd, chain_fwd),
        "tower_bwd": (lambda: tk.tower_bwd(dy, x, p_margin, cd), plain_fwd_bwd,
                      chain_fwd_bwd),
    }
    b, h, w, f = TOWER_SHAPE
    conv_ops = 2 * b * h * w * 9 * f * f * 2 * TOWER_BLOCKS  # 2 convs a block
    act_bytes = b * h * w * f * 4
    param_bytes = sum(p.numel() * 4 for p in p_margin)
    peak_ops = FP32_OPS_PER_S if cd == torch.float32 else BF16_OPS_PER_S
    work = {  # (operations, bytes): each input read once, each output written once
        "tower_fwd": (conv_ops, 2 * act_bytes + param_bytes),
        "tower_bwd": (3 * conv_ops, 3 * act_bytes + 2 * param_bytes),
    }
    out = []
    for name, (fn_k, fn_p, fn_c) in fns.items():
        runs = [time_ms(fn, windows=5, reps=2) for fn in (fn_k, fn_p, fn_c) * 2]
        ms, plain_ms, chain_ms = (statistics.median(runs[i] + runs[i + 3])
                                  for i in range(3))
        t_ops = work[name][0] / peak_ops * 1e3
        t_bytes = work[name][1] / HBM_BYTES_PER_S * 1e3
        # the chain does the same convs (its zero biases add a pass each)
        tflops, chain_tflops = (work[name][0] / (t * 1e-3) / 1e12
                                for t in (ms, chain_ms))
        rec = {
            "name": f"{name}_{tag}",
            "route": "cuda",
            "source": "srgan_tpu_torch/csrc/residual_tower.cu",
            "replaces": TPU_KERNELS[name],
            "launches": counts[name],
            "max_abs_err": fwd_abs if name == "tower_fwd" else bwd_abs,
            "max_rel_err": max(fwd_rel if name == "tower_fwd" else bwd_rel),
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None,  # no single PyTorch call: see cudnn_chain_ms
            "cudnn_chain_ms": chain_ms,
            "tflops": tflops,
            "cudnn_chain_tflops": chain_tflops,
        }
        print(f"kernel {rec['name']}: ms={ms:.3f} (windows "
              f"{min(runs[0] + runs[3]):.3f}..{max(runs[0] + runs[3]):.3f}) "
              f"plain ms={plain_ms:.3f} cudnn chain ms={chain_ms:.3f} "
              f"bound_ms={rec['bound_ms']:.3f} ({rec['bound_by']}); "
              f"TFLOP/s {tflops:.1f} (chain {chain_tflops:.1f})", flush=True)
        out.append(rec)
    return out


def tower_phase(dev) -> list:
    from srgan_tpu_torch.ops.cuda import residual_tower_kernel as tk

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = []
    for cd in (torch.float32, torch.bfloat16):
        out += tower_dtype_phase(tk, dev, cd)
    print(f"tower: phase {time.perf_counter() - t0:.1f} s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    from srgan_tpu_torch.ops.cuda import recon_loss_kernel as rk
    from srgan_tpu_torch.ops.cuda.build import SOURCES, build, ptxas_report
    from srgan_tpu_torch.utils.platform import disable_tf32

    t0 = time.perf_counter()
    reports = build()
    print(f"build: {len(reports)} source(s) compiled in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name in SOURCES:  # built now or earlier: each keeps its report
        for line in ptxas_report(name).splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    resources = loss_ptxas(ptxas_report("recon_loss"))
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    dev = torch.device("cuda")
    disable_tf32()
    kernels = kernel_phase(rk, dev)
    small_step_phase(dev)
    counts = training_phase(rk, dev)
    tower = tower_phase(dev)

    line = []
    for name, rec in kernels.items():
        regs = resources.get((name, "vec"))
        line.append({
            "name": f"recon_{name}",
            "route": "cuda",
            "source": "srgan_tpu_torch/csrc/recon_loss.cu",
            "replaces": TPU_KERNELS[name],
            "launches": counts[name],
            **rec,
            "registers": regs[0] if regs else None,
            "spill_bytes": regs[2] if regs else None,
            "library_ms": None,  # no single PyTorch call computes it
            "cudnn_chain_ms": None,
            "tflops": None,
            "cudnn_chain_tflops": None,
        })
    line += tower
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
