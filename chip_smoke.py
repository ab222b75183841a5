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
     the CPU (plain versions) at a small size, same weights and batch, in
     fp32 (losses rel 1e-4) and in bf16 (rel 2e-2), params within 2·lr;
  4. train the flagship configuration (F=64, 16 blocks, 4x subpixel head,
     HR 512x1024) through ``Trainer.train_epoch`` on the device-cache
     path, each run one warm-up epoch and one counted epoch of 3 steps: fp32
     at batch 12, bf16 at batch 12 and at batch 24, with ms/step, img/s and
     peak memory. The launch counts are zeroed just before each counted
     epoch and read just after: K1, K2 and K3 must each have launched once
     per step, on their vector path. ``compute_score`` on one validation
     batch (fp32); one profiled epoch of fp32 batch 12 and of bf16 batch 24
     (device time by kernel and by group). Then the layout experiment at
     batch 12 in both dtypes: the model's weights and activations in
     ``channels_last`` against the default layout, in turns (default,
     channels_last, channels_last, default), with the run-to-run spread
     and a profiled epoch of bf16 channels_last;
  5. the train entry point at the flagship size in bf16, batch 12,
     configured by the ``train`` CLI's flags: ``Trainer.train`` for 2
     epochs with checkpoints every epoch, keep-best and validation every
     epoch on 36 + 12 in-memory clips, then ``resume`` to epoch 3 (launch
     counts zeroed before it: K1-K3 once per step, vector path); checks
     the JSONL, the snapshots, the sidecar, the comparison PNGs and that
     the resumed epoch moved the params, and the rating curve where
     matplotlib is installed (where it is not, the curve is named as not
     written);
  6. the residual tower (``residual_tower``, kernels K4 and K5) at the
     flagship tower shape x (12, 128, 256, 64), N=16, in f32 and bf16:
     K4 and K5 against the plain version and its autograd, launch counts
     (one ``tower_fwd`` per forward, one ``tower_bwd`` per backward), two
     calls bit-identical, the conv and wgrad kernels each mode launches
     (bf16: the tensor-core tiles only; f32: the SIMT tiles only) with
     each tile's device ms and TFLOP/s per launch (and ms per launch with
     and without GN1 + ReLU on its operand), times
     beside the bound, the plain version and the cuDNN chain (the port's
     ``ResidualBlock`` x16 as the model runs it in that dtype, with zero
     conv biases), achieved TFLOP/s of the
     kernel and the chain, and peak memory.

It prints a ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
line. It exits non-zero without a result where CUDA is unavailable or the
package is missing. The script imports nothing of JAX or ``srgan_tpu``.
"""

from __future__ import annotations

import importlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
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
FLAGSHIP_STEPS = 3  # counted steps an epoch of the flagship runs
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
# device kernels by what they do, for the profile's summary; first match
PROFILE_GROUPS = [(g, re.compile(rx, re.I)) for g, rx in (
    ("loss K1-K3", LOSS_KERNEL_RE.pattern),
    ("conv", r"conv|gemm|xmma|winograd|dgrad|wgrad|implicit|cudnn|sm\d\d_"),
    ("group norm", r"group_?norm|welford|moments|GammaBeta|ComputeFused"),
    ("adam, ema", r"foreach|multi_tensor"),
    ("cast, copy", r"copy|cast|convert"),
    ("elementwise", r"elementwise|vectorized|unrolled|reduce"),
)]
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
    """One pixel step at a small size, in fp32 and in bf16: kernels on the
    card against the plain versions on the CPU, from the same weights and
    batch. Bars: losses rel 1e-4 (fp32) / 2e-2 (bf16), params 2·lr."""
    from srgan_tpu_torch.config import ModelConfig
    from srgan_tpu_torch.models.srresnet import init_generator
    from srgan_tpu_torch.training.steps import generator_pixel_step
    from srgan_tpu_torch.training.train_state import TrainState

    rng = np.random.default_rng(0)
    hr = rng.random((2, 64, 128, 3), dtype=np.float32)
    lr_imgs = rng.random((2, 16, 32, 3), dtype=np.float32)
    for compute_dtype, loss_tol in (("float32", 1e-4), ("bfloat16", 2e-2)):
        cfg = ModelConfig(num_features=8, num_residuals=2, upscale_factor=4,
                          compute_dtype=compute_dtype)
        results = []
        for d in (dev, torch.device("cpu")):
            state = TrainState(init_generator(cfg, seed=0, device=d))
            state, m = generator_pixel_step(
                state, torch.from_numpy(hr).to(d), torch.from_numpy(lr_imgs).to(d), 1e-3
            )
            results.append((m["packed"].cpu(), [p.detach().cpu() for p in state.params]))
        (pk_gpu, p_gpu), (pk_cpu, p_cpu) = results
        err = float(((pk_gpu - pk_cpu).abs() / pk_cpu.abs().clamp_min(1e-12))[:3].max())
        check(err <= loss_tol, f"small step {compute_dtype}: losses rel err {err} > {loss_tol}")
        # a first Adam step moves a weight by lr·g/(|g| + eps), so a gradient
        # near 0 whose sign differs moves the two copies 2·lr apart (bf16
        # reaches it); 1e-6 more covers the rounding of the params
        dp = max(float((a - b).abs().max()) for a, b in zip(p_gpu, p_cpu))
        check(dp <= 2e-3 + 1e-6, f"small step {compute_dtype}: params max|d| {dp} > 2*lr")
        print(f"small step {compute_dtype}: loss rel err {err:.3e} (bar {loss_tol}), "
              f"params max|d| {dp:.3e} (bar 2e-3)", flush=True)


def smooth_clips(dev, n: int, seed: int, hw=LOSS_SHAPE[1:3]) -> np.ndarray:
    """n smooth random HR clips, (n, H, W, 3) uint8: bicubic upsampling of
    coarse noise, made on the card from ``seed``."""
    h, w = hw
    g = torch.Generator(device=dev).manual_seed(seed)
    coarse = torch.rand((n, 3, h // 64, w // 64), generator=g, device=dev)
    img = torch.nn.functional.interpolate(coarse, size=(h, w), mode="bicubic")
    u8 = (img.clamp(0, 1) * 255).round().to(torch.uint8)
    return u8.permute(0, 2, 3, 1).contiguous().cpu().numpy()


def channels_last(trainer) -> None:
    """The layout experiment: the model's weights and its activations in
    ``channels_last`` (GroupNorm's output is turned back to it, since the
    CUDA group_norm returns NCHW). The public NHWC contract is unchanged:
    the input's NCHW view is channels_last already."""
    model = trainer.pool.leader.state.model
    model.to(memory_format=torch.channels_last)
    for m in model.modules():
        if isinstance(m, torch.nn.GroupNorm):
            m.register_forward_hook(
                lambda mod, args, out: out.contiguous(memory_format=torch.channels_last))


class Flagship:
    """One flagship Trainer (F=64, 16 blocks, 4x subpixel head, HR
    512x1024) on clips in the device cache, with a temporary results dir."""

    def __init__(self, dev, compute_dtype: str, batch: int, clips, results_dir: str,
                 layout: str = "default"):
        from srgan_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
        from srgan_tpu_torch.data.dataset import ArrayDataset
        from srgan_tpu_torch.data.pipeline import TrainPipeline
        from srgan_tpu_torch.training.loop import Trainer

        self.tag = f"{compute_dtype} batch {batch}" + (
            " channels_last" if layout == "channels_last" else "")
        self.batch = batch
        cfg = Config(
            model=ModelConfig(compute_dtype=compute_dtype),
            data=DataConfig(batch_size=batch, device_cache="on"),
            train=TrainConfig(progress="off", score_max_batches=1,
                              results_dir=results_dir),
        )
        self.trainer = Trainer(cfg)  # the card, by default
        if layout == "channels_last":
            channels_last(self.trainer)
        self.pipe = TrainPipeline(cfg.data, ArrayDataset(clips[:FLAGSHIP_STEPS * batch]),
                                  use_split=False, seed=cfg.train.seed)
        t0 = time.perf_counter()
        self.warm = self.trainer.train_epoch(self.pipe, 0)  # cuDNN set-up, upload
        torch.cuda.synchronize()
        self.warm_s = time.perf_counter() - t0
        self.epochs = 1

    def epoch(self) -> tuple:
        """(metrics, seconds) of one counted epoch."""
        t0 = time.perf_counter()
        m = self.trainer.train_epoch(self.pipe, self.epochs)
        torch.cuda.synchronize()
        self.epochs += 1
        dt = time.perf_counter() - t0
        check(m["n_batches"] == FLAGSHIP_STEPS,
              f"{self.tag}: expected {FLAGSHIP_STEPS} steps, ran {m['n_batches']}")
        for k in ("g_loss", "com_loss", "tv_loss"):
            check(math.isfinite(m[k]) and math.isfinite(self.warm[k]),
                  f"{self.tag}: {k} not finite")
        return m, dt

    def counted(self, rk) -> dict:
        """The main path's counted epoch: launch counts zeroed just before
        and read just after; K1, K2 and K3 once per step, vector path."""
        torch.cuda.reset_peak_memory_stats()
        rk.reset_launches()
        m, dt = self.epoch()
        counts, paths = dict(rk.launches), dict(rk.paths)
        peak = torch.cuda.max_memory_allocated()
        for name in LOSS_KERNELS:
            check(counts[name] == FLAGSHIP_STEPS,
                  f"{self.tag}: {name} launched {counts[name]} times in "
                  f"{FLAGSHIP_STEPS} steps")
            check(paths[f"{name}_vec"] == FLAGSHIP_STEPS and paths[f"{name}_scalar"] == 0,
                  f"{self.tag}: {name}: paths {paths}, expected the vector path every step")
        step_ms = dt / FLAGSHIP_STEPS * 1e3
        print(f"train {self.tag}: warm-up epoch {self.warm_s:.3f} s; counted epoch "
              f"{FLAGSHIP_STEPS} steps {step_ms:.2f} ms/step "
              f"{self.batch * FLAGSHIP_STEPS / dt:.2f} img/s; g_loss "
              f"{self.warm['g_loss']:.5f} -> {m['g_loss']:.5f}; peak memory "
              f"{peak / 2**30:.2f} GiB; launches {counts}; paths {paths}", flush=True)
        return {"counts": counts, "step_ms": step_ms, "peak_gib": peak / 2**30}

    def close(self):
        self.pipe.close()


def training_phase(rk, dev) -> dict:
    """The flagship step through ``Trainer.train_epoch``: fp32 at batch 12
    (its counts feed the kernels line), bf16 at batch 12 and 24, each a
    warm-up epoch then a counted one; ``compute_score`` on fp32; a profiled
    epoch of fp32 and of bf16 batch 24; then the layout experiment at
    batch 12 in both dtypes, default and channels_last in turns, with a
    profiled epoch of bf16 channels_last."""
    clips = smooth_clips(dev, FLAGSHIP_STEPS * 24, 1)
    val_clips = smooth_clips(dev, 12, 2)
    out = {}
    with tempfile.TemporaryDirectory() as results_dir:
        from srgan_tpu_torch.data.dataset import ArrayDataset
        from srgan_tpu_torch.data.pipeline import TrainPipeline

        runs = {}
        try:
            for compute_dtype, batch in (("float32", 12), ("bfloat16", 12),
                                         ("bfloat16", 24)):
                run = Flagship(dev, compute_dtype, batch, clips, results_dir)
                runs[(compute_dtype, batch)] = run
                out[(compute_dtype, batch)] = run.counted(rk)
                if batch == 24 or compute_dtype == "float32":
                    profile_epoch(run.trainer, run.pipe, FLAGSHIP_STEPS, run.tag)
                    run.epochs += 1
                if compute_dtype == "float32":
                    val = TrainPipeline(run.trainer.cfg.data, ArrayDataset(val_clips),
                                        use_split=False, seed=1, augment=False)
                    try:
                        psnr, ssim = run.trainer.compute_score(val, 1)
                    finally:
                        val.close()
                    check(math.isfinite(psnr) and math.isfinite(ssim),
                          "validation score not finite")
                    print(f"train {run.tag}: psnr {psnr:.3f} ssim {ssim:.4f}", flush=True)
            runs.pop(("bfloat16", 24)).close()  # free its cached clips

            # layout: default, channels_last, channels_last, default for
            # each dtype
            for compute_dtype in ("float32", "bfloat16"):
                default = runs[(compute_dtype, 12)]
                cl = Flagship(dev, compute_dtype, 12, clips, results_dir,
                              layout="channels_last")
                try:
                    times = {"default": [out[(compute_dtype, 12)]["step_ms"]],
                             "channels_last": []}
                    for layout, run in (("channels_last", cl), ("channels_last", cl),
                                        ("default", default)):
                        times[layout].append(run.epoch()[1] / FLAGSHIP_STEPS * 1e3)
                    if compute_dtype == "bfloat16":  # where its time goes
                        profile_epoch(cl.trainer, cl.pipe, FLAGSHIP_STEPS, cl.tag)
                finally:
                    cl.close()
                spread = max(abs(t[0] - t[1]) for t in times.values())
                gain = (statistics.mean(times["default"])
                        - statistics.mean(times["channels_last"]))
                print(f"layout {compute_dtype} batch 12: ms/step default "
                      + " / ".join(f"{t:.2f}" for t in times["default"])
                      + ", channels_last " + " / ".join(f"{t:.2f}" for t in times["channels_last"])
                      + f"; channels_last faster by {gain:.2f} ms/step, run-to-run "
                      f"spread {spread:.2f} ms", flush=True)
        finally:
            for run in runs.values():
                run.close()
    b12, b24 = out[("bfloat16", 12)], out[("bfloat16", 24)]
    print(f"train: bf16 against fp32 at batch 12: {out[('float32', 12)]['step_ms'] / b12['step_ms']:.2f}x; "
          f"bf16 img/s batch 12 {12e3 / b12['step_ms']:.2f}, batch 24 "
          f"{24e3 / b24['step_ms']:.2f}", flush=True)
    return out[("float32", 12)]["counts"]


def profile_epoch(trainer, pipe, steps: int, tag: str) -> None:
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
    print(f"profile {tag}: {steps} steps, wall {wall_us / 1e3:.1f} ms, device busy "
          f"{busy / 1e3:.1f} ms (idle share {1 - busy / wall_us:.3f}); loss "
          f"kernels K1-K3 {loss / 1e3:.3f} ms ({loss / busy:.4f} of busy)",
          flush=True)
    groups: dict = {}
    for name, us in by_name.items():
        group = next((g for g, rx in PROFILE_GROUPS if rx.search(name)), "other")
        groups[group] = groups.get(group, 0.0) + us
    print(f"profile {tag}: ms/step by group: " + "; ".join(
        f"{g} {us / 1e3 / steps:.3f} ({us / busy:.3f})"
        for g, us in sorted(groups.items(), key=lambda kv: -kv[1])), flush=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    for name, us in top[:12]:
        print(f"profile {tag}:   {us / 1e3 / steps:9.3f} ms/step  {name[:100]}")


def entry_point_phase(rk, dev) -> None:
    """The train entry point on the card at the flagship size in bf16
    (F=64, 16 blocks, HR 512x1024, batch 12), configured by the CLI's
    flags: 2 epochs with ``--checkpoint-every 1 --keep-best
    --validate-every 1``, then ``--resume`` to epoch 3, with the launch
    counts zeroed just before the resumed run and read just after. 36
    training clips, so that the 0.7 split leaves 2 steps an epoch. The
    clips are in memory (``Trainer.train`` on an ``ArrayDataset``), so that
    the phase also runs where matplotlib is missing: there the CLI's own
    run would end in ``ModuleNotFoundError`` at the rating curve. An
    artifact the machine cannot write is named, and its writer stubbed out
    here only."""
    from srgan_tpu_torch import cli
    from srgan_tpu_torch.data.dataset import ArrayDataset
    from srgan_tpu_torch.training import checkpoint as ckpt
    from srgan_tpu_torch.training import loop

    missing = []
    for name in ("PIL", "matplotlib"):
        try:
            importlib.import_module(name)
        except ImportError:
            missing.append(name)
    if missing:
        print(f"entry point: {', '.join(missing)} missing on this machine; not "
              "written: " + ", ".join(
                  {"PIL": "the comparison PNGs", "matplotlib": "the rating curve"}[m]
                  for m in missing), flush=True)
    steps = 2
    data = (ArrayDataset(smooth_clips(dev, 36, 3)), ArrayDataset(smooth_clips(dev, 12, 4)))
    save_rating_curve = loop.save_rating_curve
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as res:
        flags = ["train", "--epochs", "2", "--batch-size", "12", "--bf16",
                 "--checkpoint-every", "1", "--keep-best", "--validate-every",
                 "0" if "PIL" in missing else "1", "--results-dir", res,
                 "--progress", "off"]
        try:
            if "matplotlib" in missing:
                loop.save_rating_curve = lambda *args, **kw: None
            t0 = time.perf_counter()
            loop.Trainer(cli.config_from_args(cli.build_parser().parse_args(flags))
                         ).train(*data)
            first_s = time.perf_counter() - t0
            epoch2 = ckpt.restore_generator_params(res, "Training")
            args = cli.build_parser().parse_args(flags + ["--epochs", "3", "--resume"])
            rk.reset_launches()
            t0 = time.perf_counter()
            loop.Trainer(cli.config_from_args(args)).train(*data, resume=True)
            torch.cuda.synchronize()
        finally:
            loop.save_rating_curve = save_rating_curve
        resume_s = time.perf_counter() - t0
        counts, paths = dict(rk.launches), dict(rk.paths)

        for name in LOSS_KERNELS:
            check(counts[name] == steps and paths[f"{name}_vec"] == steps,
                  f"entry point resume: {name} launches {counts[name]}, paths "
                  f"{paths}; expected {steps} on the vector path")
        with open(os.path.join(res, "Training_metrics.jsonl")) as f:
            records = [json.loads(line) for line in f if line.strip()]
        check([r["epoch"] for r in records] == [1, 2, 3],
              f"entry point: JSONL epochs {[r['epoch'] for r in records]}")
        check(all(math.isfinite(r[k]) for r in records for k in ("g_loss", "psnr")),
              "entry point: non-finite loss or psnr in the JSONL")
        check(all(r["n_batches"] == steps for r in records),
              f"entry point: batches an epoch {[r['n_batches'] for r in records]}")
        latest = ckpt.latest_ckpt_dir(res, "Training")
        check(os.path.basename(latest).startswith("Training_ckpt@3"),
              f"entry point: latest snapshot {latest}")
        best = ckpt.latest_ckpt_dir(res, "Training-best")
        check(best is not None, "entry point: no Training-best snapshot")
        sidecar = ckpt.load_model_config(res, "Training")
        check(sidecar is not None and sidecar.compute_dtype == "bfloat16"
              and sidecar.num_features == 64 and sidecar.num_residuals == 16,
              f"entry point: sidecar {sidecar}")
        names = sorted(os.listdir(res))
        want = ["Training_metrics.jsonl", "Training_model.json", "Training-best_model.json"]
        if "PIL" not in missing:
            want += [f"Training_epoch_{e}_0_comparison.png" for e in (1, 2, 3)]
        if "matplotlib" not in missing:
            want.append("Trainingtraining_loss_curve_0.png")
        check(set(want) <= set(names), f"entry point: artifacts {names}, want {want}")
        epoch3 = ckpt.restore_generator_params(res, "Training")
        check(epoch3.keys() == epoch2.keys()
              and any(not torch.equal(epoch3[k], epoch2[k]) for k in epoch2),
              "entry point: the resumed epoch 3 left the params as they were")
        check(all(torch.isfinite(t).all() for t in epoch3.values()),
              "entry point: non-finite params after the resume")
    print(f"entry point bf16 batch 12: 2 epochs in {first_s:.1f} s, resume to epoch 3 "
          f"in {resume_s:.1f} s (phase {time.perf_counter() - t_phase:.1f} s); psnr by "
          f"epoch {[round(r['psnr'], 3) for r in records]}; resumed launches {counts}; "
          f"latest {os.path.basename(latest)}, best {os.path.basename(best)}; "
          f"artifacts {names}", flush=True)


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
    """The port's ResidualBlock x16 as the model runs it in ``cd`` (f32
    params cast on each call, GroupNorm in f32 with its output rounded),
    zero conv biases, NCHW."""
    from srgan_tpu_torch.models.srresnet import ResidualBlock

    f = TOWER_SHAPE[-1]
    blocks = []
    for i in range(TOWER_BLOCKS):
        blk = ResidualBlock(f, compute_dtype=cd)
        with torch.no_grad():
            for conv, w in ((blk.conv1, params.w1[i]), (blk.conv2, params.w2[i])):
                conv.weight.copy_(w.permute(3, 2, 0, 1))
                conv.bias.zero_()
            for norm, s, b in ((blk.norm1, params.s1[i], params.b1[i]),
                               (blk.norm2, params.s2[i], params.b2[i])):
                norm.weight.copy_(s)
                norm.bias.copy_(b)
        blocks.append(blk)
    return torch.nn.Sequential(*blocks).to(params.w1.device)


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
    entry_point_phase(rk, dev)
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
