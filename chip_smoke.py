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
     fp32 (losses rel 1e-4) and in bf16 (rel 2e-2), and its gradients
     (Adam's first moments after the step, on the whole network's norm)
     within 1e-2 (fp32) / 0.5 (bf16);
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
  5. the GAN steps at a small size, in fp32 and bf16: one
     ``gan_train_step``, one ``discriminator_step_on_sr`` and one
     ``scanned_pool_gan_step`` (N=3, mask [1, 0, 1]) on the card against
     the same calls on the CPU from the same weights (F=8, HR 64x128, D of
     2 stages). Bars: the pixel losses rel 1e-4 (fp32) / 2e-2 (bf16), the
     adversarial ones abs 3e-5 / 2e-3, every G's and D's moments as in 3;
  6. the GAN phase at the flagship size (F=64, 16 blocks, HR 512x1024, D of
     4 stages at 64 filters), batch 12, through ``Trainer.train_epoch``,
     each run a warm-up epoch and a counted epoch of 3 steps: the pool of 3
     on the stacked scan executor in bf16 (K1-K3 three times a step), and
     one generator on the fused GAN step in fp32 (once a step). Both use
     ``p_gan_above=1.0``, so every member takes a GAN update in every
     batch of the counted epoch (the auto gate is not calibrated by
     ``train_epoch`` alone). ms/step, img/s, peak memory, each member's
     counters, d_loss, and a profiled epoch of the pool;
  7. the train entry point at the flagship size in bf16, batch 12, on PNG
     folders written from 36 + 12 smooth clips: ``python3 -m
     srgan_tpu_torch.cli train`` as a subprocess for 2 epochs with
     checkpoints every epoch, keep-best and validation every epoch; then
     ``--resume`` to epoch 3 and ``--continue-training --gan
     --num-generators 3 --epochs 1`` through ``cli.main``, the launch
     counts zeroed before each (K1-K3 once a step, then three times a step;
     vector path). The last leg crosses the phase boundary: the pool grows
     1 → 3 from a snapshot without a discriminator. Checks the JSONLs, the
     snapshots (3 generators and a discriminator in the last), the
     sidecars, the comparison PNGs, the rating curves and that the resumed
     epoch moved the params;
  8. the residual tower (``residual_tower``, kernels K4 and K5) at the
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
     kernel and the chain, and peak memory;
  9. serving and evaluation, at the flagship width from the
     entry point's own results directory (the bf16 ``Training`` snapshot
     and the ``Post-Training`` pool of 3), TF32 off: ``Upscaler`` fp32
     (random, seed 0) on the card against the CPU at LR (2, 64, 96, 3)
     (1e-4·max; uint8 within 1 LSB, and bit-equal to the host quantisation
     of ``upscale``); ``upscale_u8`` at batch 8 of LR
     128x256, bf16 and fp32 (ms/batch by CUDA events, img/s, output MP/s,
     the forward alone, peak memory, bytes fetched); the pool ensemble at
     batch 8, TTA and TTA + ensemble at batch 1, against the plain forward;
     ``upscale_tiled`` of one LR 1080x1920 image (tile 256, overlap 16,
     batch 16, uint8 tiles) with its wall, SR-call and forward seconds and
     the host blend's share, and a one-tile image equal to ``upscale``;
     ``python3 -m srgan_tpu_torch.cli upscale-dir --ensemble`` as a
     subprocess on 32 PNGs of 128x256, 3 odd sizes and a corrupt file (35
     outputs at 4x, the summary and timing lines); ``eval`` through
     ``cli.main`` on 12 pairs (default quirks) and ``--no-extra-downscale
     --bucketed`` on 6 pairs of 3 sizes, and an fp32 eval of 2 pairs on
     the card against the CPU (PSNR within 1e-3 dB); bf16 on the card
     against the CPU, random weights and the snapshot, within the CPU's
     own bf16 error e against the fp32 forward of the same weights
     (|card − fp32| ≤ 1.25 e, |card − CPU| ≤ √2 e). The launch
     counts are zeroed before the phase and read after: K1-K5 must not
     have launched.

  10. the perceptual prior (run between phases 7 and 8, on phase 7's
     folders): the card against the CPU at a small size in fp32 (the VGG19
     features at conv3_3 and conv4_3 and the encoder's taps within
     1e-4·max|y|; one perceptual pixel step and one perceptual fused GAN
     step: losses, p_loss included, rel 1e-4, moments as in 3), the
     random-VGG warning checked and printed where no pretrained VGG19 is
     cached; ``python3 -m srgan_tpu_torch.cli train-encoder`` as a
     subprocess on 48 PNG clips at the JAX CLI's defaults, 200 steps;
     ``train --perceptual 0.1 --perceptual-encoder`` as a subprocess in
     fp32 (one epoch of 2 steps); ``eval --perceptual-metric`` on 12 pairs
     of that snapshot, card against CPU (PSNR within 1e-3 dB, the distance
     within rel 1e-4); then ``Trainer.train_epoch`` at the flagship size,
     batch 12, weight 0.1: VGG19 in fp32 and bf16 and the trained encoder
     in fp32 and bf16 (a warm-up and a counted epoch of 3 steps; the VGG
     runs with a profiled epoch and the extractor's passes timed alone on
     the device), and the pool of 3 with GAN and VGG in bf16 (2 steps):
     ms/step, img/s, peak memory, K1-K3 once a step and member, the
     extractor on HR once a batch and on SR once a member.

  11. determinism (after phase 6): the deterministic mode that every entry
     point turns on (``utils.platform.make_deterministic``): phase 10's
     ``train-encoder`` subprocess run again in this process, archives and
     losses bit-identical; the flagship bf16 pool of 3 with GAN once more
     over 2 epochs of 3 steps, every network's params and Adam moments and
     the losses bit-identical to phase 6's run; the mode's cost in ms/step
     against the mode off (on, off, off, on) on that pool and, in phase 4,
     on the bf16 pixel step;
  12. multi-process, in this process: a one-rank NCCL group from torchrun's
     variables; K1-K3 at the flagship loss shape through the group (the
     fp64 totals all-gathered between each totals stage and its finalise)
     bit-identical to the no-group path and within the kernel phase's bars
     of their plain group form; the flagship bf16 pool of 3 with GAN under
     the group for 2 epochs, bit-identical to phase 6's run, K1 and K2
     counted through the group every launch. And in phase 7, ``train
     --multihost`` as a subprocess (NCCL, world 1) for the same 2 epochs as
     the run without it: params, g_loss and psnr bit-identical;
  13. input: one flagship bf16 epoch with ``--salt-prob 0.001 --pepper-prob
     0.001 --spot-size 3`` (counted: K1-K3 once a step) and the spot density
     of an epoch's LR batches against its expectation (within 40 %);
  14. tracing (after phase 7, on its folders): ``train --profile-dir``
     through ``cli.main``, one flagship bf16 epoch of 2 steps; the trace
     file names ``edge_stats_kernel``, ``loss_sums_kernel`` and
     ``grad_kernel``;
  15. serving (in phase 9): ``upscale-dir`` prints the codec that served
     (native, or PIL with the native build's first error line) and its
     img/s; ``upscale --dp`` (every visible card)
     writes the plain path's output.
  16. the vmap pool executor (after phase 12): K2 and K3 over a member axis
     at (N=3, 12, 512, 1024, 3) f32, each member bit-identical to the
     single launch on its sr and within the kernel phase's bars of the
     pooled plain version (float64), one pooled launch timed against three
     single ones; JAX's vmap-against-scan steps at their small sizes (one
     pixel step, N=3, and one fused GAN step, N=2), vmap against scan on
     the card and against the vmap step on the CPU, fp32 and bf16, with
     functorch's per-member fallback switched off (K1-K3 once a vmap step,
     once a member a scan step); the flagship pool of 3, bf16, batch 12,
     pixel and GAN, vmap beside scan (ms/step, img/s, peak memory, launches
     a step: vmap 1/1/1, scan 3/3/3; a profiled epoch of each pixel run);
     the vmap GAN run twice over 2 epochs, bit-identical; the vmap executor
     on remat models (``--pool-exec vmap --remat``), pixel and GAN at batch
     12 beside the vmap runs without remat (losses bit-identical, params
     and Adam moments bit-identical or within JAX's vmap-against-scan
     bars, peak memory below theirs, launches 1/1/1 a step; a profiled
     pixel epoch), its GAN run twice over 2 epochs, bit-identical, and a
     pixel run at batch 24;
  17. W-sharded inference (``parallel/spatial.py``): the flagship generator
     on the LR 1080x1920 frame, fp32 and bf16, without a group and under a
     one-rank NCCL group, against the model's own forward, with ms;
  18. the space-to-depth trunk (``models/s2d_trunk.py``) at
     ``scripts/s2d_trunk_probe.py``'s defaults: ``s2d_trunk`` against
     ``fine_trunk`` (outputs and gradients) in fp32 and bf16, ms/step of
     each in bf16 and the device time of one step of each by group.

  19. SwinIR's windowed attention (``csrc/window_attention.cu``) at
     SwinIR-M's training shape, shifted and plain, bf16 (the tensor-core
     kernels) and f32 (the CUDA-core kernels): against the op's plain route
     in float64 on the card, two calls bit for bit (dBias too), launches by
     design, device ms beside the byte bound, each kernel's registers and
     static shared memory, the plain route's ms, and which of torch's
     ``scaled_dot_product_attention`` backends takes the shape.
     ``python3 chip_smoke.py --phase window_attention`` runs it alone.

It prints a ``{"kernels": [...]}`` line (K2's and K3's records carry their
member-axis launch under ``"pooled"``, and the vmap runs' launches in
``launches_by_path``) and, last, the ``{"ok": true, ...}`` line. It exits non-zero without a result where CUDA is unavailable or the
package is missing. The script imports nothing of JAX or ``srgan_tpu``.
"""

from __future__ import annotations

import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from srgan_tpu_torch.ops.cuda import group_norm_kernel as gk

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
    r"|grad_kernel|partials_totals<[23]>)")
# each wrapper's kernel, then its totals stage and finalise launches
LOSS_KERNELS = {
    "edge_stats": ("edge_stats_kernel", "partials_totals<2>", "edge_stats_finalize"),
    "loss_sums": ("loss_sums_kernel", "partials_totals<3>", "loss_sums_finalize"),
    "loss_grad": ("grad_kernel",),
}
# device kernels by what they do, for the profile's summary; first match
PROFILE_GROUPS = [(g, re.compile(rx, re.I)) for g, rx in (
    ("loss K1-K3", LOSS_KERNEL_RE.pattern),
    ("conv", r"conv|gemm|xmma|winograd|dgrad|wgrad|implicit|cudnn|sm\d\d_"),
    ("group norm", r"group_?norm|welford|moments|GammaBeta|ComputeFused"),
    ("adam, ema", r"foreach|multi_tensor"),
    ("cast, copy", r"copy|cast|convert"),
    ("max pool", r"max_pool"),
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
    (which back-to-back CUDA-event windows may include) cannot hide them.
    A first, uncounted session starts the profiler's device tracing: the
    first session of a process can miss its first launch."""
    with profile(activities=[ProfilerActivity.CUDA]):
        for fn in fns.values():
            fn()
        torch.cuda.synchronize()
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
        kern, *fin = LOSS_KERNELS[name]
        rec["kernel_device_ms"] = dev_ms[kern]
        # the totals stage and the finalise together
        rec["finalize_device_ms"] = sum(dev_ms[f] for f in fin) if fin else None
        rec["device_ms"] = dev_ms[kern] + sum(dev_ms[f] for f in fin)
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
              + "".join(f" + {f} {dev_ms[f]:.4f}" for f in fin)
              + f" = {rec['device_ms']:.4f}: {rec['gb_per_s']:.0f} GB/s, "
              f"{rec['bound_share']:.3f} of the bound "
              f"(by events {rec['bound_ms'] / rec['ms']:.3f}); host gap "
              f"{rec['host_gap_ms']:.4f} ms", flush=True)
    return out


# GroupNorm's forward at the shapes the model runs it without a gradient:
# a 4K serving request's LR (batch 1) and a scoring batch (24 of 128x256)
GROUP_NORM_SHAPES = {"serve": (1, 64, 540, 960), "score": (24, 64, 128, 256)}


def group_norm_phase(dev) -> dict:
    """GroupNorm's forward kernels (``csrc/group_norm.cu``) in bf16 at each
    shape of ``GROUP_NORM_SHAPES``: against torch's route on the f32 cast
    and the float64 plain version (one bf16 ulp), two calls bit for bit,
    the vector path; then each kernel's device ms a call by the profiler,
    the wrapper's ms by events, beside the bound (bf16 read twice, written
    once), the plain version's ms, ``torch.native_group_norm`` on the f32
    cast alone (``library_ms``) and with its two casts (the route the
    kernels replace)."""
    out = {}
    for tag, shape in GROUP_NORM_SHAPES.items():
        g = torch.Generator(device=dev).manual_seed(0)
        x = (torch.randn(shape, generator=g, device=dev) * 1.5 + 0.3).bfloat16()
        w = torch.rand(shape[1], generator=g, device=dev) + 0.5
        b = torch.rand(shape[1], generator=g, device=dev) - 0.5
        xf = x.float()
        n, c = shape[:2]
        hw = shape[2] * shape[3]
        gk.reset_launches()
        kern = lambda: gk.group_norm_cuda(x, w, b, 8, 1e-6)
        ys = [kern(), kern()]
        native = gk.native_group_norm(x, w, b, 8, 1e-6, torch.bfloat16)
        y_p, mean_p, var_p = gk.group_norm_plain(x[:2], w, b, 8, 1e-6)
        torch.cuda.synchronize()
        check(gk.paths["vec"] == 2, f"group norm {tag}: paths {gk.paths}")
        check(torch.equal(*ys), f"group norm {tag}: two calls differ")
        # the plain version's result rounded once: one bf16 ulp at each value;
        # torch's route (f32 statistics): one ulp at the largest |y|
        ulp = lambda t: torch.exp2(torch.floor(torch.log2(t.double().abs().clamp_min(1e-30))) - 7)
        want = y_p.float().bfloat16()
        worst_plain = float(((ys[0][:2].double() - want.double()).abs()
                             / torch.maximum(ulp(ys[0][:2]), ulp(want))).max())
        gap_native = float((ys[0].double() - native.double()).abs().max())
        top_ulp = float(ulp(native.abs().max()))
        check(worst_plain <= 1 and gap_native <= top_ulp,
              f"group norm {tag}: {worst_plain} ulp from plain, {gap_native} from "
              f"torch's (one ulp at max|y| {top_ulp})")
        del ys, native, y_p, want

        with profile(activities=[ProfilerActivity.CUDA]):
            kern()
            torch.cuda.synchronize()
        reps = 20
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                kern()
            torch.cuda.synchronize()
        by_kernel: dict = {}
        for e in _device_events(prof):
            for k in gk.KERNELS:
                if k in e.name:
                    by_kernel[k] = by_kernel.get(k, 0.0) + e.time_range.elapsed_us() / reps / 1e3
        check(set(by_kernel) == set(gk.KERNELS), f"group norm {tag}: profiler saw {by_kernel}")
        names = sorted({e.name for e in _device_events(prof) if "group_norm" in e.name})
        route = lambda: torch.native_group_norm(x.float(), w, b, n, c, hw, 8, 1e-6)[0].bfloat16()
        library = lambda: torch.native_group_norm(xf, w, b, n, c, hw, 8, 1e-6)
        plain = lambda: gk.group_norm_plain(x, w, b, 8, 1e-6)
        fns = {"ms": kern, "route_ms": route, "library_ms": library,
               # float64 copies of a scoring batch: not timed there
               "plain_ms": plain if n == 1 else None}
        rec = {k: fn and statistics.median(time_ms(fn, windows=3, reps=10))
               for k, fn in fns.items()}
        n_bytes = 3 * x.numel() * 2
        rec.update(
            shape=list(shape),
            device_ms=sum(by_kernel.values()),
            kernel_device_ms=by_kernel,
            bound_ms=n_bytes / HBM_BYTES_PER_S * 1e3,
            ulps_from_plain=worst_plain, gap_from_route=gap_native,
            profiled_names=names,
        )
        rec["bound_share"] = rec["bound_ms"] / rec["device_ms"]
        rec["gb_per_s"] = n_bytes / (rec["device_ms"] * 1e-3) / 1e9
        out[tag] = rec
        print(f"group norm {tag} {shape}: " + json.dumps(rec), flush=True)
        del x, xf
    return out


WINDOW_ATTN_GRID = (32, 64, 64)  # SwinIR-M x4's training step: LR 64x64, batch 32
WINDOW_ATTN_HEADS, WINDOW_ATTN_DIM, WINDOW_ATTN_WINDOW = 6, 30, 8


def window_attention_phase(dev) -> dict:
    """SwinIR's windowed attention (``csrc/window_attention.cu``) at
    SwinIR-M's training shape (``WINDOW_ATTN_GRID``: tokens (32, 4096), 6
    heads of 30, window 8), shifted (4) and plain, bf16 (the tensor-core
    kernels) and f32 (the CUDA-core kernels): forward, dqkv and dbias
    against the op's plain route in float64 on the card (f32 2e-5 of
    max|y|; bf16: out one bf16 ulp at max|y|, dqkv 1e-2, dbias 2e-3 of max,
    as ``tests/test_torch_window_attn_source.py`` holds them), two calls bit
    for bit, dbias included, and ``launches`` by design; the kernels' device
    ms by the profiler (every name of the dtype's design seen, and of
    ``KERNELS`` over both) and the wrappers' by events, beside the bound (q,
    k, v, O; and dO, dq, dk, dv backward, at the input's width, over HBM's
    bandwidth), each kernel's ``ptxas`` registers, static shared memory
    and spills (the tensor-core kernels' is dynamic: ``MmaSmem`` in the
    source), the plain route's ms in bf16, and which of torch's
    ``scaled_dot_product_attention`` backends takes the shape (each
    refusal with torch's reasons) (the math
    path's ms as ``library_ms``; the port never calls it)."""
    from srgan_tpu_torch.ops import window_attention as wa
    from srgan_tpu_torch.ops.cuda import window_attention_kernel as wk
    from srgan_tpu_torch.ops.cuda.build import ptxas_report

    resources, kernel = {}, None
    for line in ptxas_report("window_attention").splitlines():
        if "entry function" in line or "registers" in line or "spill" in line:
            print(f"ptxas window_attention: {line.strip()}")
        named = re.search(r"entry function '(\S+)'", line)
        if named:
            kernel = next((k for k in wk.KERNELS if k in named.group(1)), None)
        for key, rx in (("registers", r"Used (\d+) registers"), ("smem_bytes", r"(\d+) bytes smem"),
                        ("spill_bytes", r"(\d+) bytes spill stores")):
            found = re.search(rx, line)
            if kernel and found:
                resources.setdefault(kernel, {})[key] = int(found.group(1))
    grid, heads, d, ws = WINDOW_ATTN_GRID, WINDOW_ATTN_HEADS, WINDOW_ATTN_DIM, WINDOW_ATTN_WINDOW
    b, h, w = grid
    n, c = ws * ws, heads * d
    out = {"ptxas": resources}
    seen = set()
    for dtype in (torch.bfloat16, torch.float32):
        design = wk.DESIGNS[dtype]
        names = wk.KERNELS_BY_DESIGN[design]
        fwd_name, bwd_name, dbias_name = names
        for shift in (ws // 2, 0):
            tag = f"{str(dtype).split('.')[-1]} shift {shift}"
            g = torch.Generator(device=dev).manual_seed(0)
            qkv = torch.randn((b, h * w, 3 * c), generator=g, device=dev).to(dtype)
            bias = torch.randn((heads, n, n), generator=g, device=dev) * 0.5
            dout = torch.randn((b, h * w, c), generator=g, device=dev).to(dtype)
            wk.reset_launches()
            runs = []
            for _ in range(2):
                o, lse = wk.window_attention_cuda(qkv, bias, heads, ws, shift, grid)
                runs.append((o, lse, *wk.window_attention_backward_cuda(
                    qkv, bias, o, lse, dout, heads, ws, shift, grid)))
            torch.cuda.synchronize()
            other = "simt" if design == "mma" else "mma"
            check(wk.launches == {"forward": 2, "backward": 2, f"forward_{design}": 2,
                                  f"backward_{design}": 2, f"forward_{other}": 0,
                                  f"backward_{other}": 0}, f"window attn {tag}: {wk.launches}")
            check(all(torch.equal(a, b2) for a, b2 in zip(*runs)),
                  f"window attn {tag}: two calls differ")
            o, _, dqkv, dbias = runs[0]
            del runs
            q64 = qkv.double().requires_grad_()
            b64 = bias.double().requires_grad_()
            o64 = wa.window_attention_plain(q64, b64, heads, ws, shift, grid)
            dq64, db64 = torch.autograd.grad(o64, [q64, b64], dout.double())
            o64 = o64.detach()
            err = lambda got, want: float((got.double() - want).abs().max() / want.abs().max())
            errs = {"out": err(o, o64), "dqkv": err(dqkv, dq64), "dbias": err(dbias, db64)}
            bars = ({"out": 2.0 ** -7, "dqkv": 1e-2, "dbias": 2e-3} if dtype == torch.bfloat16
                    else {"out": 2e-5, "dqkv": 2e-5, "dbias": 2e-5})
            check(all(errs[k] <= bars[k] for k in bars), f"window attn {tag}: {errs} > {bars}")
            del q64, b64, o64, dq64, db64, dqkv, dbias
            fwd = lambda: wk.window_attention_cuda(qkv, bias, heads, ws, shift, grid)
            o, lse = fwd()
            bwd = lambda: wk.window_attention_backward_cuda(qkv, bias, o, lse, dout, heads, ws,
                                                            shift, grid)
            with profile(activities=[ProfilerActivity.CUDA]):
                fwd(), bwd()
                torch.cuda.synchronize()
            reps = 5
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fwd()
                    bwd()
                torch.cuda.synchronize()
            by_kernel: dict = {}
            for e in _device_events(prof):
                k = next((k for k in wk.KERNELS if k in e.name), None)
                if k:
                    ms = e.time_range.elapsed_us() / reps / 1e3
                    by_kernel[k] = by_kernel.get(k, 0.0) + ms
            check(set(by_kernel) == set(names), f"window attn {tag}: profiler saw {by_kernel}")
            seen |= set(by_kernel)
            width = qkv.element_size()
            rec = {
                "ms": statistics.median(time_ms(fwd, windows=3, reps=5)),
                "bwd_ms": statistics.median(time_ms(bwd, windows=3, reps=5)),
                "kernel_device_ms": by_kernel,
                "bound_ms": 4 * b * h * w * c * width / HBM_BYTES_PER_S * 1e3,
                "bwd_bound_ms": 8 * b * h * w * c * width / HBM_BYTES_PER_S * 1e3,
                "errors": errs,
                "profiled_names": sorted({e.name for e in _device_events(prof)
                                          if "window_attn_" in e.name}),
            }
            rec["design"] = design
            rec["bound_share"] = rec["bound_ms"] / by_kernel[fwd_name]
            rec["bwd_bound_share"] = rec["bwd_bound_ms"] / (by_kernel[bwd_name]
                                                            + by_kernel[dbias_name])
            if dtype == torch.bfloat16:
                plain = lambda: wa.window_attention_plain(qkv, bias, heads, ws, shift, grid)
                rec["plain_ms"] = statistics.median(time_ms(plain, windows=3, reps=3))
                rec.update(sdpa_probe(qkv, bias, heads, ws, shift, grid))
            out[tag] = rec
            print(f"window attn {tag}: " + json.dumps(rec), flush=True)
            del qkv, dout, o, lse
    check(seen == set(wk.KERNELS), f"window attn: the profiler saw {sorted(seen)}")
    return out


def sdpa_probe(qkv, bias, heads, ws, shift, grid) -> dict:
    """Which backend of torch's ``scaled_dot_product_attention`` takes the
    windows (head dim 30, an additive bias and mask a head and window), and
    the ms of the one that does, on the already partitioned windows."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from srgan_tpu_torch.ops import window_attention as wa

    b, h, w = grid
    n, c = ws * ws, qkv.shape[-1] // 3
    x = qkv.view(b, h // ws, ws, w // ws, ws, 3 * c).transpose(2, 3)
    q, k, v = x.reshape(-1, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    mask = bias[None].expand(q.shape[0], -1, -1, -1).clone()
    if shift:
        m = wa.shift_mask(h, w, ws, shift).to(qkv.device)
        mask = (mask.view(b, -1, heads, n, n) + m[None, :, None]).view(-1, heads, n, n)
    mask = mask.to(qkv.dtype)
    taken = {}
    for name in ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION", "MATH"):
        with warnings.catch_warnings(record=True) as said:
            warnings.simplefilter("always")
            try:
                with sdpa_kernel(getattr(SDPBackend, name)):
                    torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=mask)
                torch.cuda.synchronize()
                taken[name] = True
            except RuntimeError as e:
                why = [str(m.message).splitlines()[0][:160] for m in said]
                taken[name] = [str(e).splitlines()[0][:80], *why]
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    return {"sdpa_backends": taken, "library_ms": statistics.median(time_ms(sdpa, windows=3,
                                                                            reps=3))}


def group_norm_counts() -> dict:
    """GroupNorm's launches and routes since ``gk.reset_launches()``."""
    return {"launches": gk.launches["group_norm"], "paths": dict(gk.paths)}


# Bars of the steps on the card against the CPU, each network's Adam first
# moment after one step, (1 - b1)·g, on its whole norm (tests/test_torch_gan.py
# says why, and why bf16's is loose), and the adversarial loss terms, abs.
GRAD_RTOL = {"float32": 1e-2, "bfloat16": 0.5}
ADV_ATOL = {"float32": 3e-5, "bfloat16": 2e-3}


def moments_rel_err(got, want) -> float:
    """The largest ‖mu_got − mu_want‖ / ‖mu_want‖ over pairs of states, one
    network each (after one step: the gradients' agreement)."""
    worst = 0.0
    for a, b in zip(got, want):
        d2 = sum(float(((x.cpu().double() - y.cpu().double()) ** 2).sum())
                 for x, y in zip(a.mu, b.mu))
        n2 = sum(float((y.cpu().double() ** 2).sum()) for y in b.mu)
        check(n2 > 0, "moments: all 0 on the CPU")
        worst = max(worst, math.sqrt(d2 / n2))
    return worst


def small_step_phase(dev) -> None:
    """One pixel step at a small size, in fp32 and in bf16: kernels on the
    card against the plain versions on the CPU, from the same weights and
    batch. Bars: losses rel 1e-4 (fp32) / 2e-2 (bf16), the gradients (Adam
    moments) ``GRAD_RTOL``."""
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
            results.append((m["packed"].cpu(), state))
        (pk_gpu, st_gpu), (pk_cpu, st_cpu) = results
        err = float(((pk_gpu - pk_cpu).abs() / pk_cpu.abs().clamp_min(1e-12))[:3].max())
        check(err <= loss_tol, f"small step {compute_dtype}: losses rel err {err} > {loss_tol}")
        g_err = moments_rel_err([st_gpu], [st_cpu])
        bar = GRAD_RTOL[compute_dtype]
        check(g_err <= bar, f"small step {compute_dtype}: moments rel err {g_err} > {bar}")
        print(f"small step {compute_dtype}: loss rel err {err:.3e} (bar {loss_tol}), "
              f"moments rel err {g_err:.3e} (bar {bar})", flush=True)


def gan_small_step_phase(dev) -> None:
    """One ``gan_train_step``, one ``discriminator_step_on_sr`` and one
    ``scanned_pool_gan_step`` (N=3, mask [1, 0, 1], D on member 2's SR) at
    a small size (F=8, 2 blocks, HR 64x128, D of 2 stages at 8 filters), in
    fp32 and bf16: the kernels on the card against the plain versions on
    the CPU, each call from fresh states made from the same seeds. Bars: the
    pixel losses rel 1e-4 (fp32) / 2e-2 (bf16); the adversarial ones
    (g_d_loss, d_loss: means of tanh of differences of two sigmoids, near 0)
    ``ADV_ATOL``; every network's gradients (Adam moments) ``GRAD_RTOL``."""
    from srgan_tpu_torch.config import DiscriminatorConfig, ModelConfig
    from srgan_tpu_torch.models.discriminator import init_discriminator
    from srgan_tpu_torch.models.srresnet import init_generator
    from srgan_tpu_torch.training.stacked_pool import scanned_pool_gan_step, stack_states
    from srgan_tpu_torch.training.steps import discriminator_step_on_sr, gan_train_step
    from srgan_tpu_torch.training.train_state import TrainState

    t0 = time.perf_counter()
    rng = np.random.default_rng(1)
    hr = rng.random((2, 64, 128, 3), dtype=np.float32)
    lr_imgs = rng.random((2, 16, 32, 3), dtype=np.float32)
    sr = rng.random((2, 64, 128, 3), dtype=np.float32)
    mask = np.asarray([1.0, 0.0, 1.0], np.float32)
    lr = 1e-3
    for cd, rel in (("float32", 1e-4), ("bfloat16", 2e-2)):
        g_cfg = ModelConfig(num_features=8, num_residuals=2, upscale_factor=4,
                            compute_dtype=cd)
        d_cfg = DiscriminatorConfig(num_filters=8, num_stages=2, compute_dtype=cd)
        out = []
        for d in (dev, torch.device("cpu")):
            t = lambda a: torch.from_numpy(a).to(d)  # noqa: E731
            g = TrainState(init_generator(g_cfg, seed=0, device=d))
            d1, d2, d3 = (TrainState(init_discriminator(d_cfg, seed=1, device=d))
                          for _ in range(3))
            g, d1, m1 = gan_train_step(g, d1, t(hr), t(lr_imgs), lr, lr)
            d2, m2 = discriminator_step_on_sr(d2, t(hr), t(sr), lr)
            pool = stack_states([TrainState(init_generator(g_cfg, seed=2 + i, device=d))
                                 for i in range(3)])
            pool, d3, m3 = scanned_pool_gan_step(pool, d3, t(hr), t(lr_imgs), mask, lr, lr,
                                                 d_target_idx=2)
            out.append(([m1["packed"].cpu(), m2["d_loss"].reshape(1).cpu(), m3["packed"].cpu()],
                        [g, d1, d2, d3, *pool]))
        (pk_gpu, st_gpu), (pk_cpu, st_cpu) = out
        # the pixel terms of each packed vector: (g, com, tv) of the fused
        # step, (g, com, tv) x 3 members of the pool; the rest adversarial
        pixel = [slice(0, 3), slice(0, 0), slice(0, 9)]
        rel_err = adv_err = 0.0
        for a, b, px in zip(pk_gpu, pk_cpu, pixel):
            is_px = torch.zeros(a.numel(), dtype=torch.bool)
            is_px[px] = True
            rel_err = max([rel_err, *((a - b).abs() / b.abs().clamp_min(1e-12))[is_px].tolist()])
            adv_err = max([adv_err, *(a - b).abs()[~is_px].tolist()])
        adv = ADV_ATOL[cd]
        check(rel_err <= rel, f"gan small step {cd}: pixel losses rel err {rel_err} > {rel}")
        check(adv_err <= adv, f"gan small step {cd}: adversarial losses abs err {adv_err} > {adv}")
        g_err = moments_rel_err(st_gpu, st_cpu)
        bar = GRAD_RTOL[cd]
        check(g_err <= bar, f"gan small step {cd}: moments rel err {g_err} > {bar}")
        print(f"gan small step {cd}: pixel losses rel err {rel_err:.3e} (bar {rel}), "
              f"adversarial abs err {adv_err:.3e} (bar {adv}), G and D moments rel err "
              f"{g_err:.3e} (bar {bar}); d_loss card {float(pk_gpu[0][5]):.6f} cpu "
              f"{float(pk_cpu[0][5]):.6f}", flush=True)
    print(f"gan small step: phase {time.perf_counter() - t0:.1f} s", flush=True)


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
    512x1024) on clips in the device cache, with a temporary results dir.
    ``n_gen`` generators; ``gan``: with the flagship discriminator (4
    stages, 64 filters) and ``p_gan_above=1.0``; ``steps`` an epoch;
    ``train``: more ``TrainConfig`` fields (the perceptual term's);
    ``data``: more ``DataConfig`` fields (salt and pepper); ``remat``: each
    residual block recomputed in the backward."""

    def __init__(self, dev, compute_dtype: str, batch: int, clips, results_dir: str,
                 layout: str = "default", n_gen: int = 1, gan: bool = False,
                 steps: int = FLAGSHIP_STEPS, train: dict | None = None, tag: str = "",
                 data: dict | None = None, member_exec: str = "scan",
                 remat: bool = False):
        from srgan_tpu_torch.config import (Config, DataConfig, DiscriminatorConfig,
                                            ModelConfig, PoolConfig, TrainConfig)
        from srgan_tpu_torch.data.dataset import ArrayDataset
        from srgan_tpu_torch.data.pipeline import TrainPipeline
        from srgan_tpu_torch.training.loop import Trainer

        self.tag = f"{compute_dtype} batch {batch}" + (
            " channels_last" if layout == "channels_last" else "") + (
            f" pool {n_gen}" if n_gen > 1 else "") + (
            f" {member_exec}" if member_exec != "scan" else "") + (
            " remat" if remat else "") + (" gan" if gan else "") + tag
        self.batch = batch
        self.steps = steps
        # K1-K3 launches a step: once a member, or once for all (vmap)
        self.vmap = member_exec == "vmap" and n_gen > 1
        self.per_step = 1 if self.vmap else n_gen
        cfg = Config(
            model=ModelConfig(compute_dtype=compute_dtype, remat=remat),
            discriminator=DiscriminatorConfig(compute_dtype=compute_dtype),
            data=DataConfig(batch_size=batch, device_cache="on", **(data or {})),
            pool=PoolConfig(num_generators=n_gen, member_exec=member_exec,
                            **({"p_gan_above": 1.0} if gan else {})),
            train=TrainConfig(progress="off", score_max_batches=1,
                              results_dir=results_dir, use_gan=gan, **(train or {})),
        )
        self.trainer = Trainer(cfg)  # the card, by default
        if layout == "channels_last":
            channels_last(self.trainer)
        self.pipe = TrainPipeline(cfg.data, ArrayDataset(clips[:steps * batch]),
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
        check(m["n_batches"] == self.steps,
              f"{self.tag}: expected {self.steps} steps, ran {m['n_batches']}")
        for k in ("g_loss", "com_loss", "tv_loss"):
            check(math.isfinite(m[k]) and math.isfinite(self.warm[k]),
                  f"{self.tag}: {k} not finite")
        return m, dt

    def snapshot(self) -> list:
        """The active pool's records (the stacked pool's where it runs)."""
        t = self.trainer
        return (t.spool if t.spool is not None else t.pool).snapshot()

    def counted(self, rk) -> dict:
        """The main path's counted epoch: launch counts zeroed just before
        and read just after; K1, K2 and K3 once per step and member, vector
        path; GroupNorm's kernels never (a training step's norms need their
        gradient: torch's, by ``group_norm_counts``)."""
        want = self.steps * self.per_step
        before = self.snapshot()
        torch.cuda.reset_peak_memory_stats()
        rk.reset_launches()
        gk.reset_launches()
        m, dt = self.epoch()
        counts, paths, pooled = dict(rk.launches), dict(rk.paths), dict(rk.pooled)
        norms = group_norm_counts()
        check(norms["launches"] == 0 and norms["paths"]["vec"] == 0,
              f"{self.tag}: GroupNorm's kernels in a training step: {norms}")
        peak = torch.cuda.max_memory_allocated()
        want_pooled = self.steps if self.vmap else 0
        check(all(v == want_pooled for v in pooled.values()),
              f"{self.tag}: member-axis launches {pooled}, expected {want_pooled} each")
        for name in LOSS_KERNELS:
            check(counts[name] == want,
                  f"{self.tag}: {name} launched {counts[name]} times in "
                  f"{self.steps} steps, expected {want}")
            check(paths[f"{name}_vec"] == want and paths[f"{name}_scalar"] == 0,
                  f"{self.tag}: {name}: paths {paths}, expected the vector path every step")
        step_ms = dt / self.steps * 1e3
        gan = ""
        if self.trainer.d_state is not None:
            after = self.snapshot()
            n_gan = [a["gan_updates"] - b["gan_updates"] for a, b in zip(after, before)]
            n_pix = [a["pixel_updates"] - b["pixel_updates"] for a, b in zip(after, before)]
            check(sum(n_gan) >= 1, f"{self.tag}: no GAN update in the counted epoch")
            check(math.isfinite(m["d_loss"]) and math.isfinite(m["g_d_loss"]),
                  f"{self.tag}: d_loss {m['d_loss']}, g_d_loss {m['g_d_loss']}")
            gan = (f"; counted epoch gan_updates {n_gan} pixel_updates {n_pix} (run "
                   f"totals {[(a['gan_updates'], a['pixel_updates']) for a in after]}); "
                   f"d_loss {m['d_loss']:.5f} g_d_loss {m['g_d_loss']:.5f}")
        print(f"train {self.tag}: warm-up epoch {self.warm_s:.3f} s; counted epoch "
              f"{self.steps} steps {step_ms:.2f} ms/step "
              f"{self.batch * self.steps / dt:.2f} img/s; g_loss "
              f"{self.warm['g_loss']:.5f} -> {m['g_loss']:.5f}; peak memory "
              f"{peak / 2**30:.2f} GiB; launches {counts}; paths {paths}; group norm "
              f"{norms}{gan}", flush=True)
        return {"counts": counts, "step_ms": step_ms, "peak_gib": peak / 2**30,
                "p_loss": m["p_loss"], "metrics": m, "group_norm": norms}

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
                if (compute_dtype, batch) == ("bfloat16", 12):
                    _mode_cost(run, run.tag)
                if compute_dtype == "float32":
                    val = TrainPipeline(run.trainer.cfg.data, ArrayDataset(val_clips),
                                        use_split=False, seed=1, augment=False)
                    gk.reset_launches()
                    try:
                        psnr, ssim = run.trainer.compute_score(val, 1)
                    finally:
                        val.close()
                    scoring = group_norm_counts()
                    check(math.isfinite(psnr) and math.isfinite(ssim),
                          "validation score not finite")
                    # a scoring forward: 32 norms, no gradient, the kernels
                    check(scoring["launches"] > 0 and scoring["launches"] % 32 == 0
                          and scoring["launches"] == scoring["paths"]["vec"]
                          and scoring["paths"]["grad"] == 0,
                          f"scoring: GroupNorm {scoring}, expected the kernels only")
                    print(f"train {run.tag}: psnr {psnr:.3f} ssim {ssim:.4f}; group norm "
                          f"{scoring}", flush=True)
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
    return out[("float32", 12)], scoring


def gan_training_phase(rk, dev) -> dict:
    """The GAN phase at the flagship size, batch 12: the pool of 3 on the
    stacked scan executor in bf16 (with a profiled epoch), then one
    generator on the fused GAN step in fp32; each a warm-up epoch and a
    counted one, launch counts zeroed just before the counted epoch. The
    pool's state after its counted epoch is kept (``"state"``)."""
    clips = smooth_clips(dev, FLAGSHIP_STEPS * 12, 1)
    out = {}
    with tempfile.TemporaryDirectory() as results_dir:
        for name, cd, n_gen in (("pool gan flagship", "bfloat16", 3),
                                ("gan single flagship", "float32", 1)):
            t0 = time.perf_counter()
            torch.cuda.empty_cache()
            run = Flagship(dev, cd, 12, clips, results_dir, n_gen=n_gen, gan=True)
            try:
                out[name] = run.counted(rk)
                if n_gen > 1:  # the determinism phase's reference run
                    out[name]["state"] = _run_state(run)
                    profile_epoch(run.trainer, run.pipe, FLAGSHIP_STEPS, run.tag)
            finally:
                run.close()
                del run
            print(f"{name}: phase {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def _by_group(by_name: dict) -> dict:
    """Device time by kernel name summed by ``PROFILE_GROUPS`` group."""
    groups: dict = {}
    for name, t in by_name.items():
        group = next((g for g, rx in PROFILE_GROUPS if rx.search(name)), "other")
        groups[group] = groups.get(group, 0.0) + t
    return groups


def profile_epoch(trainer, pipe, steps: int, tag: str) -> tuple:
    """Where the time goes: one more epoch under torch.profiler. Device
    time by kernel, the loss kernels' share and the device's idle share
    (1 − busy/wall; the profiler's own host cost inflates wall). Returns
    the device's busy ms a step and its ms a step by group."""
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
    groups = _by_group(by_name)
    print(f"profile {tag}: ms/step by group: " + "; ".join(
        f"{g} {us / 1e3 / steps:.3f} ({us / busy:.3f})"
        for g, us in sorted(groups.items(), key=lambda kv: -kv[1])), flush=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    for name, us in top[:12]:
        print(f"profile {tag}:   {us / 1e3 / steps:9.3f} ms/step  {name[:100]}")
    return busy / 1e3 / steps, {g: us / 1e3 / steps for g, us in groups.items()}


def _cli(argv):
    """``cli.main(argv)`` in this process (so its launches count here): its
    return value and its printout, also echoed."""
    import contextlib
    import io

    from srgan_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = cli.main(argv)
    print(buf.getvalue(), end="", flush=True)
    return out, buf.getvalue()


def entry_point_phase(rk, dev, root: str):
    """The train entry point on the card at the flagship size in bf16
    (F=64, 16 blocks, HR 512x1024, batch 12) on PNG folders of 36 + 12
    smooth clips (the 0.7 split leaves 2 steps an epoch): ``python3 -m
    srgan_tpu_torch.cli train`` as a subprocess, 2 epochs with
    ``--checkpoint-every 1 --keep-best --validate-every 1``; then
    ``--resume`` to epoch 3 and ``--continue-training --gan
    --num-generators 3 --epochs 1`` through ``cli.main``, with the launch
    counts zeroed just before each and read just after. Works in ``root``;
    returns the two counted legs' launch counts and the results directory,
    which the serving phase serves."""
    from srgan_tpu_torch.training import checkpoint as ckpt

    steps = 2
    t_phase = time.perf_counter()
    counted = {}
    for name, n, seed in (("train", 36, 3), ("val", 12, 4)):
        _png_folder(os.path.join(root, name), smooth_clips(dev, n, seed))
    res = os.path.join(root, "results")
    flags = ["train", "--train-dir", os.path.join(root, "train"), "--val-dir",
             os.path.join(root, "val"), "--batch-size", "12", "--bf16",
             "--checkpoint-every", "1", "--keep-best", "--validate-every", "1",
             "--results-dir", res, "--progress", "off"]
    # the run and the same run with --multihost (one rank of an NCCL group
    # joined from torchrun's variables), side by side on the card: their
    # params must be equal
    res_mh = os.path.join(root, "results_multihost")
    argv_mh = [a if a != res else res_mh for a in flags]
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "srgan_tpu_torch.cli", *argv, "--epochs", "2", *extra],
        cwd=here, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for argv, extra, env in ((flags, [], None),
                                 (argv_mh, ["--multihost"],
                                  {**os.environ, **_torchrun_env(_free_port())}))]
    try:
        (out, err), (out_mh, err_mh) = (p.communicate(timeout=600) for p in procs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    first_s = time.perf_counter() - t0
    proc = subprocess.CompletedProcess(procs[0].args, procs[0].returncode, out, err)
    print(proc.stdout, end="", flush=True)
    check(proc.returncode == 0,
          f"entry point: the CLI exited {proc.returncode}: {proc.stderr[-3000:]}")
    check("Epoch [2/2] Training" in proc.stdout, "entry point: no epoch 2 line")
    check(os.path.exists(os.path.join(res, "Trainingtraining_loss_curve_0.png")),
          "entry point: the CLI wrote no rating curve")
    epoch2 = ckpt.restore_generator_params(res, "Training")

    check(procs[1].returncode == 0,
          f"entry point --multihost: the CLI exited {procs[1].returncode}: {err_mh[-3000:]}")
    mh = ckpt.restore_generator_params(res_mh, "Training")
    check(mh.keys() == epoch2.keys() and all(torch.equal(mh[k], epoch2[k]) for k in mh),
          "entry point --multihost: params differ from the run without --multihost")
    with open(os.path.join(res, "Training_metrics.jsonl")) as f:
        plain_recs = [json.loads(line) for line in f if line.strip()]
    with open(os.path.join(res_mh, "Training_metrics.jsonl")) as f:
        mh_recs = [json.loads(line) for line in f if line.strip()]
    same_loss = [a["g_loss"] == b["g_loss"] and a["psnr"] == b["psnr"]
                 for a, b in zip(plain_recs, mh_recs)]
    check(len(mh_recs) == 2 and all(same_loss),
          f"entry point --multihost: records {mh_recs} vs {plain_recs}")
    print(f"entry point --multihost (NCCL, world 1) bf16 batch 12: CLI subprocess 2 epochs "
          f"beside the run without it, both in {first_s:.1f} s; params bit-identical to "
          f"the run without --multihost, g_loss and psnr of both epochs equal", flush=True)

    legs = (("resume", ["--epochs", "3", "--resume"], 1),
            ("gan pool", ["--epochs", "1", "--continue-training", "--gan",
                          "--num-generators", "3"], 3))
    times, printed = {}, {}
    for leg, extra, per_step in legs:
        rk.reset_launches()
        t0 = time.perf_counter()
        _, printed[leg] = _cli(flags + extra)
        torch.cuda.synchronize()
        times[leg] = time.perf_counter() - t0
        counts, paths = dict(rk.launches), dict(rk.paths)
        counted[leg] = counts
        for name in LOSS_KERNELS:
            want = steps * per_step
            check(counts[name] == want and paths[f"{name}_vec"] == want,
                  f"entry point {leg}: {name} launches {counts[name]}, paths "
                  f"{paths}; expected {want} on the vector path")

    records = {}
    for prefix, epochs in (("Training", [1, 2, 3]), ("Post-Training", [1])):
        with open(os.path.join(res, f"{prefix}_metrics.jsonl")) as f:
            records[prefix] = [json.loads(line) for line in f if line.strip()]
        recs = records[prefix]
        check([r["epoch"] for r in recs] == epochs,
              f"entry point: {prefix} JSONL epochs {[r['epoch'] for r in recs]}")
        check(all(math.isfinite(r[k]) for r in recs for k in ("g_loss", "psnr")),
              f"entry point: non-finite loss or psnr in the {prefix} JSONL")
        check(all(r["n_batches"] == steps for r in recs),
              f"entry point: {prefix} batches an epoch {[r['n_batches'] for r in recs]}")
    gan_rec = records["Post-Training"][0]
    check(len(gan_rec["pool"]) == 3 and math.isfinite(gan_rec["d_loss"]),
          f"entry point gan pool: record {gan_rec}")
    check("has 1 generator(s); pool wants 3" in printed["gan pool"],
          "entry point gan pool: no pool-growth message")
    latest = ckpt.latest_ckpt_dir(res, "Training")
    check(os.path.basename(latest).startswith("Training_ckpt@3"),
          f"entry point: latest snapshot {latest}")
    best = ckpt.latest_ckpt_dir(res, "Training-best")
    check(best is not None, "entry point: no Training-best snapshot")
    post = ckpt.latest_ckpt_dir(res, "Post-Training")
    payload = torch.load(os.path.join(post, ckpt.PAYLOAD_FILE), weights_only=True)
    check(len(payload["generators"]) == 3 and "discriminator" in payload,
          f"entry point gan pool: snapshot {os.path.basename(post)} holds "
          f"{len(payload['generators'])} generators, discriminator "
          f"{'discriminator' in payload}")
    del payload
    sidecar = ckpt.load_model_config(res, "Training")
    check(sidecar is not None and sidecar.compute_dtype == "bfloat16"
          and sidecar.num_features == 64 and sidecar.num_residuals == 16,
          f"entry point: sidecar {sidecar}")
    names = sorted(os.listdir(res))
    want = ["Training_metrics.jsonl", "Training_model.json", "Training-best_model.json",
            "Trainingtraining_loss_curve_0.png", "Post-Training_metrics.jsonl",
            "Post-Training_model.json", "Post-Trainingtraining_loss_curve_0.png",
            "Post-Training_epoch_1_0_comparison.png"]
    want += [f"Training_epoch_{e}_0_comparison.png" for e in (1, 2, 3)]
    check(set(want) <= set(names), f"entry point: artifacts {names}, want {want}")
    epoch3 = ckpt.restore_generator_params(res, "Training")
    check(epoch3.keys() == epoch2.keys()
          and any(not torch.equal(epoch3[k], epoch2[k]) for k in epoch2),
          "entry point: the resumed epoch 3 left the params as they were")
    check(all(torch.isfinite(t).all() for t in epoch3.values()),
          "entry point: non-finite params after the resume")
    print(f"entry point bf16 batch 12: CLI subprocess 2 epochs in {first_s:.1f} s (beside "
          f"the --multihost one), resume "
          f"to epoch 3 in {times['resume']:.1f} s, --continue-training --gan "
          f"--num-generators 3 in {times['gan pool']:.1f} s (phase "
          f"{time.perf_counter() - t_phase:.1f} s); psnr by epoch "
          f"{[round(r['psnr'], 3) for r in records['Training']]}, gan pool "
          f"{round(gan_rec['psnr'], 3)}, d_loss {gan_rec['d_loss']:.5f}, pool "
          f"{[(m['gan_updates'], m['pixel_updates']) for m in gan_rec['pool']]}; launches "
          f"{counted}; latest {os.path.basename(latest)}, best {os.path.basename(best)}, "
          f"gan pool {os.path.basename(post)}; artifacts {names}", flush=True)
    return counted, res, flags


P_WEIGHT = 0.1  # the flagship perceptual runs' --perceptual weight
POOL_P_STEPS = 2  # counted steps of the perceptual pool run
RANDOM_VGG = "no pretrained VGG19 weights found"  # the fallback's warning


def _feature_errs(got: dict, want: dict) -> dict:
    """max|Δ|/max|y| of each tap, got on the card, want on the CPU."""
    check(list(got) == list(want), f"taps {list(got)} != {list(want)}")
    return {k: float((got[k].cpu() - want[k]).abs().max() / want[k].abs().max())
            for k in want}


def perceptual_small_phase(dev) -> None:
    """The card against the CPU at a small size, fp32, TF32 off, from the
    same weights and inputs: the VGG19 features at the default taps
    (conv3_3, conv4_3) and the encoder's taps (features 32, 64, 128) on x
    (2, 64, 128, 3), each within 1e-4·max|y|; one perceptual pixel step and
    one perceptual fused GAN step (F=8, 2 blocks, HR 64x128, D of 2 stages
    at 8 filters, VGG at the default taps, weight 1.0): the losses, p_loss
    included, rel 1e-4, the adversarial ones ``ADV_ATOL``, every network's
    moments ``GRAD_RTOL``. Without a cached pretrained VGG19, VGG runs on
    random weights: its warning is checked and printed."""
    import warnings

    from srgan_tpu_torch.config import DiscriminatorConfig, ModelConfig
    from srgan_tpu_torch.models.discriminator import init_discriminator
    from srgan_tpu_torch.models.encoder import init_encoder
    from srgan_tpu_torch.models.srresnet import init_generator
    from srgan_tpu_torch.models.vgg import _find_cached_torch_vgg19, frozen, init_vgg_extractor
    from srgan_tpu_torch.training.steps import gan_train_step, generator_pixel_step
    from srgan_tpu_torch.training.train_state import TrainState

    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        vgg = {d: init_vgg_extractor(seed=0, device=d) for d in (dev, cpu)}
    random_w = [w for w in caught if RANDOM_VGG in str(w.message)]
    cached = _find_cached_torch_vgg19()
    if cached is None:
        check(len(random_w) == 2 and random_w[0].category is RuntimeWarning,
              f"perceptual: {len(random_w)} random-VGG warnings, expected 2")
        print(f"perceptual: no pretrained VGG19 on this machine; the extractor warned "
              f"(RuntimeWarning): {random_w[0].message}", flush=True)
    else:
        check(not random_w, "perceptual: the random-VGG warning with a cached .pth")
        print(f"perceptual: VGG19 weights from {cached}", flush=True)
    enc = {d: frozen(init_encoder(seed=0, device=d)) for d in (dev, cpu)}
    rng = np.random.default_rng(3)
    x = rng.random((2, 64, 128, 3), dtype=np.float32)
    for name, ext in (("vgg19", vgg), ("encoder", enc)):
        with torch.no_grad():
            errs = _feature_errs(ext[dev](torch.from_numpy(x).to(dev)),
                                 ext[cpu](torch.from_numpy(x)))
        check(max(errs.values()) <= 1e-4, f"perceptual {name}: card vs CPU {errs} > 1e-4")
        print(f"perceptual {name} taps, card vs CPU, x {x.shape}: max|dy|/max|y| "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()) + " (bar 1e-4)",
              flush=True)

    hr = rng.random((2, 64, 128, 3), dtype=np.float32)
    lr_imgs = rng.random((2, 16, 32, 3), dtype=np.float32)
    g_cfg = ModelConfig(num_features=8, num_residuals=2, upscale_factor=4)
    d_cfg = DiscriminatorConfig(num_filters=8, num_stages=2)
    out = []
    for d in (dev, cpu):
        t = lambda a: torch.from_numpy(a).to(d)  # noqa: E731
        g1 = TrainState(init_generator(g_cfg, seed=0, device=d))
        g1, m1 = generator_pixel_step(g1, t(hr), t(lr_imgs), 1e-3, vgg[d], 1.0)
        g2 = TrainState(init_generator(g_cfg, seed=0, device=d))
        d2 = TrainState(init_discriminator(d_cfg, seed=1, device=d))
        g2, d2, m2 = gan_train_step(g2, d2, t(hr), t(lr_imgs), 1e-3, 1e-3, vgg[d], 1.0)
        out.append(([m1["packed"].cpu(), m2["packed"].cpu()], [g1, g2, d2]))
    (pk_gpu, st_gpu), (pk_cpu, st_cpu) = out
    rel_err = adv_err = 0.0
    for a, b in zip(pk_gpu, pk_cpu):  # g, com, tv, p relative; g_d, d_loss absolute
        rel = [0, 1, 2, 4]
        adv = [i for i in range(a.numel()) if i not in rel]
        rel_err = max([rel_err, *((a - b).abs() / b.abs().clamp_min(1e-12))[rel].tolist()])
        adv_err = max([adv_err, *(a - b).abs()[adv].tolist()])
    check(all(float(p[4]) > 0 for p in pk_gpu), f"perceptual steps: p_loss {pk_gpu}")
    check(rel_err <= 1e-4, f"perceptual steps: losses rel err {rel_err} > 1e-4")
    check(adv_err <= ADV_ATOL["float32"], f"perceptual steps: adversarial abs err {adv_err}")
    g_err = moments_rel_err(st_gpu, st_cpu)
    check(g_err <= GRAD_RTOL["float32"], f"perceptual steps: moments rel err {g_err}")
    print(f"perceptual small steps fp32 (pixel, fused GAN), card vs CPU: losses rel err "
          f"{rel_err:.3e} (bar 1e-4; p_loss card {float(pk_gpu[0][4]):.6f} / "
          f"{float(pk_gpu[1][4]):.6f}), adversarial abs err {adv_err:.3e}, G and D "
          f"moments rel err {g_err:.3e} (bar {GRAD_RTOL['float32']}); phase "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def _count_extractor_calls(extractor) -> dict:
    """Counts the extractor's forwards without a graph (HR) and with one (SR)."""
    calls = {"hr": 0, "sr": 0}

    def hook(module, args):
        calls["sr" if torch.is_grad_enabled() else "hr"] += 1

    extractor.register_forward_pre_hook(hook)
    return calls


def extractor_device_ms(extractor, dev, batch: int, reps: int = 2) -> dict:
    """The extractor's passes alone at the flagship shape, under the
    profiler: device ms of the HR forward without a graph, and of the SR
    forward with the SR input gradient (what a step adds per generator),
    each with the convs' share."""
    from srgan_tpu_torch.training.steps import perceptual_term, real_features

    g = torch.Generator(device=dev).manual_seed(5)
    hr = torch.rand((batch, *LOSS_SHAPE[1:]), generator=g, device=dev)
    sr = (hr + 0.05 * torch.randn(hr.shape, generator=g, device=dev)).requires_grad_()
    f_real = real_features(extractor, hr)
    passes = {
        "hr": lambda: real_features(extractor, hr),
        "sr": lambda: torch.autograd.grad(perceptual_term(sr, f_real, extractor), sr),
    }
    conv_rx = dict(PROFILE_GROUPS)["conv"]
    out = {}
    for name, fn in passes.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = _device_events(prof)
        total = sum(e.time_range.elapsed_us() for e in events)
        conv = sum(e.time_range.elapsed_us() for e in events if conv_rx.search(e.name))
        out[name] = (total / reps / 1e3, conv / max(total, 1e-9))
    return out


def perceptual_training_phase(rk, dev, enc_path: str) -> dict:
    """The perceptual term at the flagship size through
    ``Trainer.train_epoch``, ``perceptual_weight`` 0.1, batch 12, each run a
    warm-up epoch and a counted one (launch and extractor-call counts zeroed
    just before it): VGG19 at conv3_3 and conv4_3 in fp32 and bf16 (3 steps;
    a profiled epoch each, beside the extractor's passes timed alone on the
    device), the trained encoder prior of ``enc_path`` in fp32 and bf16 (3
    steps; each with the deterministic mode's cost, mode on against off),
    and the pool of 3 with GAN and VGG in bf16 (2 steps). K1-K3 once a step
    and member; the extractor on HR once a batch, on SR once a member.
    Returns each run's launch counts."""
    import warnings

    clips = smooth_clips(dev, FLAGSHIP_STEPS * 12, 1)
    runs = (("vgg19", "float32", 1, False, {}, FLAGSHIP_STEPS),
            ("vgg19", "bfloat16", 1, False, {}, FLAGSHIP_STEPS),
            ("encoder", "float32", 1, False, {"perceptual_encoder_npz": enc_path},
             FLAGSHIP_STEPS),
            ("encoder", "bfloat16", 1, False, {"perceptual_encoder_npz": enc_path},
             FLAGSHIP_STEPS),
            ("vgg19", "bfloat16", 3, True, {}, POOL_P_STEPS))
    out = {}
    with tempfile.TemporaryDirectory() as results_dir, warnings.catch_warnings():
        # perceptual_small_phase checked and printed the random-VGG warning
        warnings.filterwarnings("ignore", message=".*" + RANDOM_VGG)
        for prior, cd, n_gen, gan, extra, steps in runs:
            t0 = time.perf_counter()
            torch.cuda.empty_cache()
            run = Flagship(dev, cd, 12, clips, results_dir, n_gen=n_gen, gan=gan,
                           steps=steps, train={"perceptual_weight": P_WEIGHT, **extra},
                           tag=f" perceptual {prior}")
            try:
                ext = run.trainer.extractor
                check(ext is not None and not any(p.requires_grad for p in ext.parameters()),
                      f"{run.tag}: no frozen extractor")
                calls = _count_extractor_calls(ext)
                calls.update(hr=0, sr=0)
                rec = run.counted(rk)
                calls = dict(calls)  # the counted epoch's; more calls follow
                check(calls == {"hr": steps, "sr": steps * n_gen},
                      f"{run.tag}: extractor calls {calls} in {steps} steps, expected "
                      f"HR once a batch and SR once a member")
                check(math.isfinite(rec["p_loss"]) and rec["p_loss"] > 0,
                      f"{run.tag}: p_loss {rec['p_loss']}")
                out[run.tag] = rec
                split = ""
                if n_gen == 1:
                    busy, groups = profile_epoch(run.trainer, run.pipe, steps, run.tag)
                    run.epochs += 1
                    alone = extractor_device_ms(ext, dev, 12)
                    ext_ms = alone["hr"][0] + alone["sr"][0]
                    ext_conv = alone["hr"][0] * alone["hr"][1] + alone["sr"][0] * alone["sr"][1]
                    conv = groups.get("conv", 0.0)
                    split = (f"; the extractor's passes alone on the device {ext_ms:.2f} "
                             f"ms/step (HR forward {alone['hr'][0]:.2f} ms, conv share "
                             f"{alone['hr'][1]:.3f}; SR forward + input gradient "
                             f"{alone['sr'][0]:.2f} ms, conv share {alone['sr'][1]:.3f}) "
                             f"of the step's device busy {busy:.2f} ms ({ext_ms / busy:.3f}); "
                             f"convs: the extractor's {ext_conv:.2f} ms, the generator's "
                             f"(the step's {conv:.2f} less the extractor's) "
                             f"{conv - ext_conv:.2f} ms; the rest of the step "
                             f"{busy - ext_ms:.2f} ms")
                print(f"perceptual {run.tag}: counted epoch {rec['step_ms']:.2f} ms/step "
                      f"{12e3 / rec['step_ms']:.2f} img/s, peak memory "
                      f"{rec['peak_gib']:.2f} GiB; extractor calls {calls}; p_loss "
                      f"{rec['p_loss']:.6f}{split}; run {time.perf_counter() - t0:.1f} s",
                      flush=True)
                if prior == "encoder":
                    # its stride-2 convs' input gradient is where cuDNN's
                    # deterministic algorithms cost the most
                    _mode_cost(run, run.tag)
            finally:
                run.close()
                del run
    return out


def perceptual_entry_phase(dev, root: str) -> str:
    """The perceptual entry points on the card, as a user runs them:
    ``python3 -m srgan_tpu_torch.cli train-encoder`` as a subprocess on a PNG
    folder of 48 clips at the JAX CLI's defaults (batch 32, crop 96, load
    160, features 32 64 128, embed 128) with ``--steps 200`` (its JSON line;
    lossN < loss0; the archive loads); ``train --perceptual 0.1
    --perceptual-encoder`` as a subprocess in fp32, one epoch of 2 steps on
    the entry-point phase's folders; ``eval --perceptual-metric`` on 12 pairs
    of that snapshot through ``cli.main``, the card against the CPU (PSNR
    within 1e-3 dB, the distance within rel 1e-4). Returns the archive."""
    from srgan_tpu_torch.models.encoder import load_encoder_npz

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    data = os.path.join(root, "encoder_data")
    _png_folder(data, smooth_clips(dev, 48, 21))
    enc_path = os.path.join(root, "encoder.npz")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "srgan_tpu_torch.cli", "train-encoder", "--data", data,
         "--out", enc_path, "--steps", "200"],
        cwd=here, capture_output=True, text=True, timeout=600,
    )
    enc_s = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"train-encoder exited {proc.returncode}: {proc.stderr[-3000:]}")
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    check(rec["steps"] == 200 and rec["images"] == 48 and rec["lossN"] < rec["loss0"],
          f"train-encoder: {rec}")
    enc = load_encoder_npz(enc_path)
    check(enc.features == (32, 64, 128) and enc.embed_dim == 128 and enc.proj is not None,
          f"train-encoder: archive holds {enc.meta()}")
    print(f"perceptual train-encoder (subprocess, 48 clips, 200 steps, batch 32, crop 96): "
          f"{json.dumps(rec)}; {enc_s:.1f} s with process start", flush=True)
    # determinism: the same training again, in this process, gives the bits
    # of the subprocess's run
    from srgan_tpu_torch.training.encoder_train import train_contrastive_encoder

    again = os.path.join(root, "encoder_again.npz")
    t0 = time.perf_counter()
    rec2 = train_contrastive_encoder(data, again, steps=200, verbose=False)
    again_s = time.perf_counter() - t0
    with np.load(enc_path) as a, np.load(again) as b:
        same = a.files == b.files and all(np.array_equal(a[f], b[f]) for f in a.files)
    keys = ("loss0", "lossN", "align", "unif")
    check(same and all(rec[k] == rec2[k] for k in keys),
          f"determinism: two train-encoder runs differ: {rec} vs {rec2}")
    print(f"determinism train-encoder twice (the subprocess, then in this process, "
          f"{again_s:.1f} s): archives bit-identical, losses {[rec[k] for k in keys]} both",
          flush=True)

    res = os.path.join(root, "results_perceptual")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "srgan_tpu_torch.cli", "train", "--train-dir",
         os.path.join(root, "train"), "--val-dir", os.path.join(root, "val"),
         "--batch-size", "12", "--epochs", "1", "--perceptual", str(P_WEIGHT),
         "--perceptual-encoder", enc_path, "--results-dir", res, "--progress", "off"],
        cwd=here, capture_output=True, text=True, timeout=600,
    )
    train_s = time.perf_counter() - t0
    print(proc.stdout, end="", flush=True)
    check(proc.returncode == 0,
          f"train --perceptual-encoder exited {proc.returncode}: {proc.stderr[-3000:]}")
    with open(os.path.join(res, "Training_metrics.jsonl")) as f:
        jrec = json.loads(f.readline())
    check(jrec["n_batches"] == 2 and jrec["p_loss"] > 0 and math.isfinite(jrec["g_loss"]),
          f"train --perceptual-encoder: record {jrec}")

    pairs = os.path.join(root, "perceptual_pairs")
    _pairs_folder(pairs, smooth_clips(dev, 12, 22))
    argv = ["eval", "-D", pairs, "--results-dir", res, "--perceptual-metric", enc_path]
    t0 = time.perf_counter()
    card, _ = _cli(argv)
    eval_s = time.perf_counter() - t0
    cpu, _ = _cli(argv + ["--device", "cpu"])
    dpsnr, drel = abs(card[0] - cpu[0]), abs(card[2] - cpu[2]) / abs(cpu[2])
    check(dpsnr <= 1e-3 and drel <= 1e-4 and card[2] > 0,
          f"eval --perceptual-metric card {card} vs CPU {cpu}")
    print(f"perceptual entry points: train --perceptual {P_WEIGHT} --perceptual-encoder fp32 "
          f"1 epoch of 2 steps in {train_s:.1f} s as a subprocess (p_loss "
          f"{jrec['p_loss']:.6f}, psnr {jrec['psnr']:.3f}); eval --perceptual-metric on 12 "
          f"pairs: card {card}, CPU {cpu} (|dpsnr| {dpsnr:.2e} dB, distance rel "
          f"{drel:.2e}), {eval_s / 12 * 1e3:.1f} ms/image on the card; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return enc_path


SERVE_LR = (128, 256)  # the LR of HR 512x1024 at 4x
SERVE_BATCH = 8
TILED_LR = (1080, 1920)
DIR_TIMES_RE = re.compile(r"upscale_directory: \d+ image\(s\) in .*")


def _png_folder(path: str, images) -> None:
    from PIL import Image

    os.makedirs(path, exist_ok=True)
    for i, img in enumerate(images):
        Image.fromarray(img).save(os.path.join(path, f"img_{i:02d}.png"))


def _pairs_folder(path: str, hrs, factor: int = 4) -> None:
    """Paired LRbicx4/original folders: each HR and its PIL bicubic ÷factor."""
    from PIL import Image

    lrs = [np.asarray(Image.fromarray(hr).resize(
        (hr.shape[1] // factor, hr.shape[0] // factor), Image.BICUBIC)) for hr in hrs]
    _png_folder(os.path.join(path, "original"), hrs)
    _png_folder(os.path.join(path, "LRbicx4"), lrs)


class _ForwardEvents:
    """CUDA events around every forward of ``model``: the device time of
    the forwards, apart from the host work between them."""

    def __init__(self, model):
        self.pairs = []
        self.handles = [
            model.register_forward_pre_hook(lambda *_: self._record(True)),
            model.register_forward_hook(lambda *_: self._record(False)),
        ]

    def _record(self, start: bool):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        if start:
            self.pairs.append([ev])
        else:
            self.pairs[-1].append(ev)

    def seconds(self) -> float:
        torch.cuda.synchronize()
        for h in self.handles:
            h.remove()
        return sum(a.elapsed_time(b) for a, b in self.pairs) / 1e3


def serve_phase(rk, tk, dev, res: str) -> dict:
    """Serving and evaluation on the card at the flagship width (F=64, 16
    blocks, 4x subpixel head), TF32 off, from the entry-point phase's
    results directory ``res``: the bf16 ``Training`` snapshot and the
    ``Post-Training`` pool of 3. The launch counts are zeroed just before
    and read just after: no loss or tower kernel may run at serve time.
    Returns those counts."""
    import dataclasses

    from srgan_tpu_torch.config import ModelConfig
    from srgan_tpu_torch.eval.evaluation import evaluate_model
    from srgan_tpu_torch.eval.inference import Upscaler
    from srgan_tpu_torch.training.checkpoint import load_model_config

    t_phase = time.perf_counter()
    rk.reset_launches()
    tk.reset_launches()
    gk.reset_launches()
    rng = np.random.default_rng(0)

    # 1. the card against the CPU in fp32, same weights and input (the bf16
    # snapshot's comparison closes the phase)
    x = rng.random((2, 64, 96, 3), dtype=np.float32)
    fp32 = Upscaler.random_init(seed=0, device=dev)
    cpu32 = Upscaler.random_init(seed=0, device="cpu")
    y_card, y_cpu = fp32.upscale(x), cpu32.upscale(x)
    err = float(np.abs(y_card - y_cpu).max() / np.abs(y_cpu).max())
    check(err <= 1e-4, f"serve fp32: card vs CPU max|dy| {err:.3e}*max > 1e-4")
    u_card = fp32.upscale_u8(x)
    lsb = int(np.abs(u_card.astype(int) - cpu32.upscale_u8(x).astype(int)).max())
    check(lsb <= 1, f"serve fp32: upscale_u8 card vs CPU {lsb} LSB > 1")
    host = np.floor(np.clip(y_card, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    check(np.array_equal(u_card, host),
          "serve fp32: upscale_u8 on the card != the host quantisation of upscale")
    print(f"serve fp32 card vs CPU, LR {x.shape}: max|dy| {err:.3e}*max, uint8 "
          f"{lsb} LSB; the card's uint8 = the host quantisation", flush=True)
    bf16 = Upscaler.from_checkpoint(res, "Training", device=dev)
    check(bf16.model.compute_dtype == torch.bfloat16, "serve: the snapshot is not bf16")

    # 2. direct serving, uint8 off the card
    h, w = SERVE_LR
    out_mp = SERVE_BATCH * 16 * h * w / 1e6
    lr8 = smooth_clips(dev, SERVE_BATCH, 11, hw=SERVE_LR)
    lr8_dev = torch.from_numpy(lr8).to(dev).float() / 255.0
    times = {}
    for tag, up in (("bf16 snapshot", bf16), ("fp32 random", fp32)):
        torch.cuda.reset_peak_memory_stats()
        out = up.upscale_u8(lr8)
        check(out.shape == (SERVE_BATCH, 4 * h, 4 * w, 3) and out.dtype == np.uint8,
              f"serve {tag}: output {out.shape} {out.dtype}")
        ms = statistics.median(time_ms(lambda: up.upscale_u8(lr8), windows=5, reps=1))
        fwd_ms = statistics.median(time_ms(lambda: up.forward(lr8_dev), windows=5, reps=1))
        times[tag] = ms
        print(f"serve direct {tag}: batch {SERVE_BATCH} LR {h}x{w}: upscale_u8 "
              f"{ms:.3f} ms/batch ({SERVE_BATCH / ms * 1e3:.2f} img/s, "
              f"{out_mp / ms * 1e3:.1f} output MP/s), forward alone on the card "
              f"{fwd_ms:.3f} ms; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; fetched "
              f"{out.nbytes} B/batch (uint8; {out.nbytes * 4} B as float32)", flush=True)

    # 3. the pool ensemble and TTA
    pool = Upscaler.from_checkpoint(res, "Post-Training", ensemble=True, device=dev)
    check(pool.ensemble and len(pool.members) == 3,
          f"serve: the Post-Training ensemble has {len(pool.members)} members")
    ens_ms = statistics.median(time_ms(lambda: pool.upscale_u8(lr8), windows=5, reps=1))
    one = lr8[:1]
    plain1 = statistics.median(time_ms(lambda: bf16.upscale_u8(one), windows=5, reps=1))
    tta = Upscaler.from_checkpoint(res, "Training", tta=True, device=dev)
    tta_ens = Upscaler.from_checkpoint(res, "Post-Training", ensemble=True, tta=True,
                                       device=dev)
    tta_ms = statistics.median(time_ms(lambda: tta.upscale_u8(one), windows=5, reps=1))
    te_ms = statistics.median(time_ms(lambda: tta_ens.upscale_u8(one), windows=5, reps=1))
    for tag, up in (("ensemble", pool), ("tta", tta), ("tta ensemble", tta_ens)):
        y = up.upscale(one)
        check(np.isfinite(y).all() and y.shape == (1, 4 * h, 4 * w, 3),
              f"serve {tag}: output {y.shape}, finite {np.isfinite(y).all()}")
    print(f"serve ensemble of 3 (bf16): batch {SERVE_BATCH} {ens_ms:.3f} ms "
          f"({ens_ms / times['bf16 snapshot']:.2f}x the plain forward); batch 1: plain "
          f"{plain1:.3f} ms, tta {tta_ms:.3f} ms ({tta_ms / plain1:.2f}x), tta + "
          f"ensemble (24 forwards) {te_ms:.3f} ms ({te_ms / plain1:.2f}x)", flush=True)

    # 4. tiled: one LR 1080x1920 image (→ 4320x7680)
    th, tw = TILED_LR
    big = smooth_clips(dev, 1, 12, hw=TILED_LR)[0]
    sr_s = [0.0]
    fetch = bf16.upscale_u8

    def timed_fetch(batch):
        t0 = time.perf_counter()
        out = fetch(batch)
        sr_s[0] += time.perf_counter() - t0
        return out

    bf16.upscale_u8 = timed_fetch
    bf16.upscale_tiled(big[:300, :300], tile=256, overlap=16, batch_size=16,
                       fetch_u8=True)  # warm-up at the tile shape
    sr_s[0] = 0.0
    events = _ForwardEvents(bf16.model)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tiled = bf16.upscale_tiled(big, tile=256, overlap=16, batch_size=16, fetch_u8=True)
    wall = time.perf_counter() - t0
    dev_s = events.seconds()
    del bf16.upscale_u8
    stride = 256 - 16
    n_tiles = math.prod(len(range(0, n - 256 + 1, stride)) + ((n - 256) % stride > 0)
                        for n in TILED_LR)
    check(tiled.shape == (4 * th, 4 * tw, 3) and np.isfinite(tiled).all(),
          f"serve tiled: output {tiled.shape}")
    print(f"serve tiled bf16: LR {th}x{tw} → {4 * th}x{4 * tw}, tile 256 overlap 16, "
          f"{n_tiles} tiles in {len(events.pairs)} batches of 16: wall "
          f"{wall:.3f} s; SR calls (upload, forwards, fetch) {sr_s[0]:.3f} s, of which "
          f"forwards on the card {dev_s:.3f} s; host blend and padding "
          f"{wall - sr_s[0]:.3f} s ({(wall - sr_s[0]) / wall:.3f} of wall); peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    del tiled
    square = rng.random((256, 256, 3), dtype=np.float32)
    one_tile = fp32.upscale_tiled(square, tile=256, overlap=16, batch_size=1)
    err = float(np.abs(one_tile - fp32.upscale(square)).max())
    check(err <= 1e-6, f"serve tiled: one tile vs upscale max|d| {err:.3e} > 1e-6")

    # 5. upscale-dir as a subprocess: 32 direct, 3 odd sizes, 1 corrupt
    with tempfile.TemporaryDirectory() as root:
        src, dst = os.path.join(root, "in"), os.path.join(root, "out")
        _png_folder(src, smooth_clips(dev, 32, 13, hw=SERVE_LR))
        from PIL import Image

        sizes = {}
        for i, hw in enumerate(((90, 140), (150, 210), (260, 300))):
            name = f"odd_{i}.png"
            Image.fromarray(smooth_clips(dev, 1, 20 + i, hw=hw)[0]).save(
                os.path.join(src, name))
            sizes[name] = hw
        with open(os.path.join(src, "corrupt.png"), "wb") as f:
            f.write(b"\x89PNG\r\n\x1a\n not an image")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "srgan_tpu_torch.cli", "upscale-dir", src, dst,
             "--results-dir", res, "--prefix", "Post-Training", "--ensemble",
             "--batch-size", "8"],
            cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
            text=True, timeout=600,
        )
        dir_s = time.perf_counter() - t0
        check(proc.returncode == 0,
              f"serve upscale-dir: exited {proc.returncode}: {proc.stderr[-3000:]}")
        check("upscaled 35 images" in proc.stdout, f"serve upscale-dir: {proc.stdout}")
        check("1 direct size bucket(s), 3 odd-size file(s)" in proc.stderr,
              f"serve upscale-dir: no summary line in {proc.stderr[-2000:]}")
        written = sorted(os.listdir(dst))
        check(len(written) == 35 and "corrupt.png" not in written,
              f"serve upscale-dir: wrote {len(written)} files")
        for name in written:
            with Image.open(os.path.join(dst, name)) as im:
                want = sizes.get(name, SERVE_LR)
                check(im.size == (4 * want[1], 4 * want[0]),
                      f"serve upscale-dir: {name} is {im.size}, input {want}")
        line = DIR_TIMES_RE.search(proc.stderr)
        print(f"serve upscale-dir --ensemble (pool of 3, bf16) --batch-size 8: 35 files "
              f"in {dir_s:.1f} s as a subprocess ({35 / dir_s:.2f} img/s, process "
              f"start and model load included); {line.group(0) if line else '?'}",
              flush=True)
        rate = re.search(r"\(([\d.]+) img/s\)", line.group(0)) if line else None
        codec = re.search(r"; codec (.*)$", line.group(0)) if line else None
        check(rate is not None and codec is not None,
              f"serve upscale-dir: no rate or codec in {proc.stderr[-2000:]}")
        print(f"serve upscale-dir codec: {codec.group(1)}: {rate.group(1)} img/s "
              f"(upscale_directory's own wall)", flush=True)

        # --dp: every visible card, one replica each; equal to the plain path
        one = os.path.join(src, "img_00.png")
        outs = {}
        for tag, extra in (("plain", []), ("dp", ["--dp"])):
            outs[tag] = os.path.join(root, f"{tag}.png")
            _cli(["upscale", one, outs[tag], "--results-dir", res, *extra])
        with Image.open(outs["plain"]) as a, Image.open(outs["dp"]) as b:
            check(np.array_equal(np.asarray(a), np.asarray(b)),
                  "serve upscale --dp differs from the plain path")
        print(f"serve upscale --dp on {torch.cuda.device_count()} card(s): output equal to "
              "the plain path", flush=True)

        # 6. eval through cli.main: the default quirks, then --bucketed on 3 sizes
        pairs = os.path.join(root, "pairs")
        _pairs_folder(pairs, smooth_clips(dev, 12, 14))
        t0 = time.perf_counter()
        out, _ = _cli(["eval", "-D", pairs, "--results-dir", res])
        eval_s = time.perf_counter() - t0
        check(len(out) == 3 and all(math.isfinite(v) for v in out[:2]),
              f"serve eval: {out}")
        mixed = os.path.join(root, "mixed")
        hrs = [smooth_clips(dev, 2, 15 + i, hw=hw)
               for i, hw in enumerate(((512, 1024), (480, 960), (400, 800)))]
        _pairs_folder(mixed, [im for pair in hrs for im in pair])
        t0 = time.perf_counter()
        out_b, _ = _cli(["eval", "-D", mixed, "--results-dir", res,
                         "--no-extra-downscale", "--bucketed"])
        bucket_s = time.perf_counter() - t0
        check(len(out_b) == 3 and all(math.isfinite(v) for v in out_b[:2]),
              f"serve eval --bucketed: {out_b}")
        two = os.path.join(root, "two")
        _pairs_folder(two, smooth_clips(dev, 2, 14))
        scores = {d: evaluate_model(two, "LRbicx4", "original", verbose=False,
                                    upscaler=Upscaler.random_init(seed=0, device=d))
                  for d in (dev, "cpu")}
        dpsnr = abs(scores[dev][0] - scores["cpu"][0])
        check(dpsnr <= 1e-3, f"serve eval: card vs CPU psnr {scores} (|d| {dpsnr} > 1e-3)")
    print(f"serve eval (bf16 snapshot): 12 pairs LR 128x256 / HR 512x1024, default "
          f"quirks: psnr {out[0]:.4f}, ssim {out[1]:.4f}, {eval_s / 12 * 1e3:.1f} ms/image "
          f"(first call included); --no-extra-downscale --bucketed on 6 pairs of 3 "
          f"sizes: psnr {out_b[0]:.4f}, ssim {out_b[1]:.4f}, "
          f"{bucket_s / 6 * 1e3:.1f} ms/image; fp32 card vs CPU on 2 pairs: psnr "
          f"{scores[dev][0]:.6f} vs {scores['cpu'][0]:.6f}", flush=True)

    # 7. bf16 on the card against the CPU. At this size a bf16 forward of
    # the flagship parts from the fp32 forward of the same weights by
    # ~0.13·max on either device, so the card is held to the CPU's
    # own bf16 error e = |CPU − fp32|: |card − fp32| ≤ 1.25 e and
    # |card − CPU| ≤ √2 e (two independent bf16 errors), in max|d|/max|y|
    # and in ||d||/||y||; random weights (seed 0) and the snapshot.
    def rel(a, b):
        d = a.astype(np.float64) - b
        return float(np.abs(d).max() / np.abs(b).max()), float(
            np.linalg.norm(d) / np.linalg.norm(b))

    snap32 = dataclasses.replace(load_model_config(res, "Training"), compute_dtype="float32")
    bf16_cfg = ModelConfig(compute_dtype="bfloat16")
    for tag, card, cpu, ref in (
            ("random", Upscaler.random_init(bf16_cfg, seed=0, device=dev),
             Upscaler.random_init(bf16_cfg, seed=0, device="cpu"), fp32),
            ("snapshot", bf16, Upscaler.from_checkpoint(res, "Training", device="cpu"),
             Upscaler.from_checkpoint(res, "Training", device=dev, model_cfg=snap32))):
        y_card, y_cpu, y_32 = card.upscale(x), cpu.upscale(x), ref.upscale(x)
        errs = {"card vs CPU": rel(y_card, y_cpu), "card vs fp32": rel(y_card, y_32),
                "CPU vs fp32": rel(y_cpu, y_32)}
        u8 = np.abs((y_card * 255 + 0.5).astype(int) - (y_cpu * 255 + 0.5).astype(int))
        print(f"serve bf16 {tag}, LR {x.shape}, (max|d|/max|y|, ||d||/||y||): "
              + "; ".join(f"{k} ({a:.3e}, {b:.3e})" for k, (a, b) in errs.items())
              + f"; uint8 card vs CPU max {u8.max()} LSB, {(u8 > 1).mean():.2e} beyond "
              "1 LSB", flush=True)
        for k, norm in enumerate(("max", "norm")):
            e = errs["CPU vs fp32"][k]
            check(errs["card vs fp32"][k] <= 1.25 * e and errs["card vs CPU"][k] <= 2**0.5 * e,
                  f"serve bf16 {tag} ({norm}): {errs}, beyond the CPU's own bf16 error")

    # 8. no loss kernel and no tower kernel at serve time
    torch.cuda.synchronize()
    counts = {**rk.launches, **tk.launches}
    check(all(v == 0 for v in counts.values()),
          f"serve: kernels launched at serve time: {counts}")
    # GroupNorm's kernels, 32 a forward (the CPU's forwards count ``cpu``;
    # ``Upscaler.forward`` timed outside ``torch.no_grad`` counts ``grad``)
    norms = group_norm_counts()
    check(norms["launches"] > 0 and norms["launches"] % 32 == 0
          and norms["launches"] == norms["paths"]["vec"] + norms["paths"]["scalar"],
          f"serve: GroupNorm {norms}, expected the kernels on the card")
    print(f"serve: phase {time.perf_counter() - t_phase:.1f} s; launches {counts}; "
          f"group norm {norms}", flush=True)
    return {**counts, "group_norm": norms}


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


# ------------------- determinism, multi-process, input, tracing --


def _set_deterministic(on: bool) -> None:
    """The deterministic mode (``utils.platform.make_deterministic``) on or
    off, for timing the mode against its absence; the program has no
    switch."""
    torch.backends.cudnn.deterministic = on
    torch.use_deterministic_algorithms(on)


def _host_states(run) -> list:
    """Each member's and then D's ``(params, mu, nu, scale)`` on the host;
    ``scale``, 1/(1 − b1^count), turns Adam's first moment into the size of
    a gradient."""
    t = run.trainer
    states = list(t.spool.state) if t.spool is not None else [m.state for m in t.pool.members]
    if t.d_state is not None:
        states.append(t.d_state)
    return [([p.detach().cpu() for p in st.params], [m.cpu() for m in st.mu],
             [v.cpu() for v in st.nu], 1.0 / (1.0 - st.b1 ** st.count)) for st in states]


def _run_state(run) -> list:
    """Every tensor the run's next step reads: each member's params and Adam
    moments, then D's, on the host."""
    return [x for p, mu, nu, _ in _host_states(run) for x in (*p, *mu, *nu)]


def _bit_equal(a: list, b: list) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _mode_cost(run, tag: str) -> dict:
    """ms/step of ``run``'s epochs with the deterministic mode on and off, in
    turns (on, off, off, on), the mode left on."""
    times = {True: [], False: []}
    try:
        for on in (True, False, False, True):
            _set_deterministic(on)
            times[on].append(run.epoch()[1] / run.steps * 1e3)
    finally:
        _set_deterministic(True)
    on, off = statistics.mean(times[True]), statistics.mean(times[False])
    print(f"determinism cost {tag}: ms/step mode on "
          + " / ".join(f"{t:.2f}" for t in times[True]) + ", off "
          + " / ".join(f"{t:.2f}" for t in times[False])
          + f"; on - off {on - off:+.2f} ms/step ({(on / off - 1) * 100:+.2f} %)", flush=True)
    return {"on_ms": times[True], "off_ms": times[False]}


def determinism_phase(rk, dev, first: dict) -> dict:
    """The deterministic mode on the card, which every entry point turns on
    (``utils.platform.make_deterministic``; ``train-encoder`` twice: phase
    10, ``perceptual_entry_phase``): the flagship bf16 pool of 3 with GAN
    (D's strided convs and overlapping max pool in the backward) over 2
    epochs of 3 steps, every network's params and Adam moments and the
    epoch losses bit-identical to ``first``, the GAN phase's run of the
    same config; the mode's cost in ms/step against the mode off on that
    pool, in turns (phase 4 times it on the bf16 pixel step). Returns the
    reference state and losses (the multi-process phase's) and the counted
    epoch's launches."""
    t_phase = time.perf_counter()
    ref = {"state": first["state"],
           "losses": {k: v for k, v in first["metrics"].items() if k.endswith("loss")}}
    clips = smooth_clips(dev, FLAGSHIP_STEPS * 12, 1)
    with tempfile.TemporaryDirectory() as results_dir:
        torch.cuda.empty_cache()
        run = Flagship(dev, "bfloat16", 12, clips, results_dir, n_gen=3, gan=True,
                       tag=" determinism")
        try:
            rk.reset_launches()
            m, _ = run.epoch()
            counts = dict(rk.launches)
            state = _run_state(run)
            losses = {k: m[k] for k in ref["losses"]}
            check(_bit_equal(state, ref["state"]) and losses == ref["losses"],
                  f"determinism: two flagship bf16 pool-of-3 GAN runs differ: "
                  f"{losses} vs {ref['losses']}")
            print(f"determinism flagship bf16 pool 3 gan, 2 epochs of {FLAGSHIP_STEPS} "
                  f"steps, again: params and Adam moments of 3 generators and D "
                  f"bit-identical to phase 6's run ({len(state)} tensors), losses "
                  f"{losses} both", flush=True)
            _mode_cost(run, run.tag)
        finally:
            run.close()
    print(f"determinism: phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {**ref, "counts": counts}


def _torchrun_env(port: int) -> dict:
    """The variables torchrun sets, for one process on this card."""
    return dict(MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE="1",
                RANK="0", LOCAL_RANK="0")


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def multihost_phase(rk, dev, reference: dict) -> dict:
    """``--multihost``'s path in this process: a one-rank NCCL group joined
    from torchrun's variables (``parallel.mesh.initialize_multihost``).
    K1-K3 at the flagship loss shape through the totals path with the group
    (an all_gather of the fp64 totals between each totals stage and its
    finalise), bit for bit against the no-group path and, like the kernel
    phase, against their plain versions (in the group's fp64 form on the
    card: statistics and losses rel 1e-4, d/d sr 1e-3·max); then the
    flagship bf16 pool of 3 with GAN under the group for 2 epochs, every
    network's params and moments bit-identical to the determinism phase's
    run without one, the counted epoch's launches (K1 and K2 through the
    group each time). The group is destroyed at the end."""
    import torch.distributed as dist

    from srgan_tpu_torch.parallel import mesh

    t_phase = time.perf_counter()
    saved_env = dict(os.environ)
    os.environ.update(_torchrun_env(_free_port()))
    got_dev = mesh.initialize_multihost()
    try:
        group = mesh.default_group()
        check(got_dev == torch.device("cuda", 0) and dist.get_backend(group) == "nccl"
              and mesh.process_shard_info(group) == (1, 0),
              f"multihost: device {got_dev}, backend {dist.get_backend(group)}")
        hr, sr = loss_inputs(dev)
        g = (torch.tensor(1.0, device=dev), torch.tensor(0.7, device=dev))

        def run(grp):
            stats = rk.edge_stats(hr, grp)
            losses = rk.loss_sums(hr, sr, stats, grp)
            return stats.clone(), *losses, rk.loss_grad(hr, sr, stats, *g)

        alone, grouped = run(None), run(group)
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in zip(alone, grouped)),
              "multihost: the world-1 group path differs from the no-group path")
        hr64, sr64 = hr.double(), sr.double()
        want = rk.edge_stats_plain(hr64, group)
        e_p, tv_p = rk.loss_sums_plain(hr64, sr64, want, group)
        d_p = rk.loss_grad_plain(hr64, sr64, want, g[0].double(), g[1].double())
        st_err = float(((grouped[0].double() - want) / want).abs().max())
        l_err = max(abs(float(grouped[1]) - float(e_p)) / abs(float(e_p)),
                    abs(float(grouped[2]) - float(tv_p)) / abs(float(tv_p)))
        d_err = float((grouped[3].double() - d_p).abs().max() / d_p.abs().max())
        check(st_err <= 1e-4 and l_err <= 1e-4 and d_err <= 1e-3,
              f"multihost: group path vs plain: stats {st_err:.2e}, losses {l_err:.2e}, "
              f"dsr {d_err:.2e}")
        print(f"multihost kernels at {tuple(hr.shape)}, one-rank NCCL group: stats, losses "
              f"and d/d sr bit-identical to the no-group path; against the plain group "
              f"form (fp64): stats rel {st_err:.2e}, losses rel {l_err:.2e}, dsr "
              f"{d_err:.2e}*max", flush=True)

        clips = smooth_clips(dev, FLAGSHIP_STEPS * 12, 1)
        with tempfile.TemporaryDirectory() as results_dir:
            torch.cuda.empty_cache()
            run_g = Flagship(dev, "bfloat16", 12, clips, results_dir, n_gen=3, gan=True,
                             tag=" multihost world 1")
            try:
                check(run_g.trainer.group is group, "multihost: the Trainer has no group")
                rk.reset_launches()
                m, dt = run_g.epoch()
                counts, sums = dict(rk.launches), dict(rk.group_sums)
                state = _run_state(run_g)
            finally:
                run_g.close()
        want_n = FLAGSHIP_STEPS * 3
        check(all(counts[k] == want_n for k in LOSS_KERNELS)
              and all(v == want_n for v in sums.values()),
              f"multihost: launches {counts}, group sums {sums}; expected {want_n}")
        losses = {k: m[k] for k in reference["losses"]}
        check(_bit_equal(state, reference["state"]) and losses == reference["losses"],
              f"multihost: world-1 run differs from the run without a group: "
              f"{losses} vs {reference['losses']}")
        print(f"multihost flagship bf16 pool 3 gan, world 1: 2 epochs bit-identical to "
              f"the run without a group (params, moments, losses); counted epoch "
              f"{dt / FLAGSHIP_STEPS * 1e3:.2f} ms/step; launches {counts}, through the "
              f"group {sums}; phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    finally:
        dist.destroy_process_group()
        os.environ.clear()
        os.environ.update(saved_env)
    return counts


def _spot_expectation(h: int, w: int, s: int, p_salt: float, p_pepper: float) -> tuple:
    """Expected fractions of LR pixels that show salt (1.0) and pepper (0.0)
    under ``add_salt_pepper_from``: each pixel is covered by k valid seed
    positions; a density u·p·scale with u ~ U(0, 1) covers it with
    probability 1 − (1 − u·a)^k, a = p·scale, whose mean over u is
    1 − (1 − (1 − a)^(k+1)) / ((k + 1)·a); pepper wins over salt."""
    scale = h * w / ((h - s + 1) * (w - s + 1))
    ys, xs = np.arange(h), np.arange(w)
    ny = np.minimum(ys, h - s) - np.maximum(ys - s + 1, 0) + 1
    nx = np.minimum(xs, w - s) - np.maximum(xs - s + 1, 0) + 1
    k = (ny[:, None] * nx[None, :]).astype(np.float64)

    def uncovered(p):
        a = p * scale
        return (1.0 - (1.0 - a) ** (k + 1)) / ((k + 1) * a)

    no_salt, no_pepper = uncovered(p_salt), uncovered(p_pepper)
    return float(((1 - no_salt) * no_pepper).mean()), float((1 - no_pepper).mean())


def input_phase(rk, dev) -> dict:
    """One flagship bf16 epoch with ``--salt-prob 0.001 --pepper-prob 0.001
    --spot-size 3`` (a warm-up epoch, then a counted one: K1-K3 once a
    step), and the spot density of a further epoch's LR batches (pixels of
    exactly 1.0 and 0.0 in every channel) against its expectation: within
    40 % (36 images, each with its own density U(0, p): the mean's relative
    spread is ~10 %)."""
    from srgan_tpu_torch.training.loop import _epoch_generator

    t_phase = time.perf_counter()
    sp = dict(salt_prob=0.001, pepper_prob=0.001, sp_spot_size=3)
    clips = smooth_clips(dev, FLAGSHIP_STEPS * 12, 1)
    with tempfile.TemporaryDirectory() as results_dir:
        run = Flagship(dev, "bfloat16", 12, clips, results_dir, data=sp,
                       tag=" salt 0.001 pepper 0.001 spot 3")
        try:
            rec = run.counted(rk)
            salt = pepper = total = 0
            gen = _epoch_generator(dev, 0, 9)
            for _, lr in run.pipe.epoch(9, gen):
                salt += int((lr == 1.0).all(-1).sum())
                pepper += int((lr == 0.0).all(-1).sum())
                total += lr.shape[0] * lr.shape[1] * lr.shape[2]
                lr_hw = lr.shape[1:3]
        finally:
            run.close()
    want = _spot_expectation(*lr_hw, 3, 0.001, 0.001)
    got = (salt / total, pepper / total)
    ratios = [g / w for g, w in zip(got, want)]
    check(all(abs(r - 1) <= 0.4 for r in ratios),
          f"input: spot density salt/pepper {got}, expected {want}")
    print(f"input spots: LR {tuple(lr_hw)}, {total} pixels: salt {got[0]:.5f} (expected "
          f"{want[0]:.5f}, x{ratios[0]:.3f}), pepper {got[1]:.5f} (expected {want[1]:.5f}, "
          f"x{ratios[1]:.3f}); phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return rec


TRACE_NAMES = ("edge_stats_kernel", "loss_sums_kernel", "grad_kernel")


def trace_phase(rk, dev, flags: list, root: str) -> dict:
    """``train --profile-dir`` through ``cli.main`` at the flagship size in
    bf16, one epoch of 2 steps on the entry-point phase's folders: the trace
    file exists and names K1, K2 and K3; their launches counted (once a
    step)."""
    from srgan_tpu_torch.utils.profiling import TRACE_FILE

    prof, res = os.path.join(root, "trace"), os.path.join(root, "results_trace")
    argv = [a if a != flags[flags.index("--results-dir") + 1] else res for a in flags]
    rk.reset_launches()
    t0 = time.perf_counter()
    _cli(argv + ["--epochs", "1", "--profile-dir", prof])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(rk.launches)
    path = os.path.join(prof, TRACE_FILE)
    check(os.path.exists(path), f"trace: no {path}")
    with open(path) as f:
        text = f.read()
    named = {n: text.count(n) for n in TRACE_NAMES}
    check(all(named.values()) and all(counts[k] == 2 for k in LOSS_KERNELS),
          f"trace: kernel names in the trace {named}, launches {counts}")
    print(f"trace: train --profile-dir, 1 epoch of 2 steps bf16, {dt:.1f} s with the "
          f"profiler; {path} {len(text) / 2**20:.1f} MiB; kernel name occurrences {named}; "
          f"launches {counts}", flush=True)
    return counts


POOL_N = 3  # members of the vmap phase's pooled kernels and flagship pool


def _member_inputs(dev):
    """The kernel phase's hr and sr, and POOL_N - 1 more members' sr on the
    same 1/256 grid: (hr, srs (N, 12, 512, 1024, 3))."""
    hr, sr = loss_inputs(dev)
    g = torch.Generator(device=dev).manual_seed(1)
    more = [torch.randint(0, 256, LOSS_SHAPE, generator=g, device=dev).float() / 256.0
            for _ in range(POOL_N - 1)]
    return hr, torch.stack([sr, *more])


def loss_device_ms(fn, reps: int = 20) -> dict:
    """Device ms a call of ``fn`` by loss kernel symbol (all its launches),
    from the profiler over ``reps`` calls, after a session that starts the
    profiler's device tracing."""
    with profile(activities=[ProfilerActivity.CUDA]):
        fn()
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in _device_events(prof):
        m = LOSS_KERNEL_RE.search(e.name)
        if m:
            out[m.group(1)] = out.get(m.group(1), 0.0) + e.time_range.elapsed_us() / reps / 1e3
    return out


def pooled_kernel_phase(rk, dev) -> dict:
    """K2 and K3 over the member axis at (N=3, 12, 512, 1024, 3) f32: each
    member bit-identical to the single-member launch on its sr; against the
    pooled plain version in float64 (losses and stats rel 1e-4, d/d sr
    1e-3·max|g| a member); one pooled launch timed against three single
    ones, in turns, by CUDA events and by device time."""
    hr, srs = _member_inputs(dev)
    n = hr.numel()
    ge = torch.tensor([1.0, 0.5, -1.5], device=dev)
    gt = torch.tensor([1.0, -2.0, 0.25], device=dev)
    stats = rk.edge_stats(hr)
    edge, tv, rows = rk.loss_sums_pooled(hr, srs, stats)
    dsr = rk.loss_grad_pooled(hr, srs, rows, ge, gt)
    singles = [stats.clone() for _ in range(POOL_N)]
    for i in range(POOL_N):
        e_i, t_i = rk.loss_sums(hr, srs[i], singles[i])
        d_i = rk.loss_grad(hr, srs[i], singles[i], ge[i], gt[i])
        torch.cuda.synchronize()
        check(torch.equal(edge[i], e_i) and torch.equal(tv[i], t_i)
              and torch.equal(rows[i], singles[i]),
              f"pooled K2: member {i} differs from the single launch")
        check(torch.equal(dsr[i], d_i), f"pooled K3: member {i} differs from the single launch")
    del d_i
    check(bool((rows[:, 3] > 0).all()), f"pooled: tv means {rows[:, 3].tolist()}: a TV term is gated")
    hr64, srs64 = hr.double(), srs.double()
    st64 = rk.edge_stats_plain(hr64)
    e_p, t_p, rows_p = rk.loss_sums_pooled_plain(hr64, srs64, st64)
    l_err = float(max(((edge.double() - e_p) / e_p).abs().max(),
                      ((tv.double() - t_p) / t_p).abs().max(),
                      ((rows.double() - rows_p) / rows_p).abs().max()))
    check(l_err <= 1e-4, f"pooled K2 against plain: rel err {l_err} > 1e-4")
    g_p = rk.loss_grad_pooled_plain(hr64, srs64, rows_p, ge.double(), gt.double())
    d_err = max(float((dsr[i].double() - g_p[i]).abs().max() / g_p[i].abs().max())
                for i in range(POOL_N))
    check(d_err <= 1e-3, f"pooled K3 against plain: max|d dsr| {d_err}·max|g| > 1e-3")
    max_abs = {"loss_sums": float(max((edge.double() - e_p).abs().max(),
                                      (tv.double() - t_p).abs().max())),
               "loss_grad": float((dsr.double() - g_p).abs().max())}
    del hr64, srs64, g_p, dsr
    print(f"pooled kernels at N={POOL_N} x {LOSS_SHAPE} f32: every member's losses, stats "
          f"and d/d sr bit-identical to the single launches; against the float64 pooled "
          f"plain version: losses and stats rel {l_err:.2e}, d/d sr {d_err:.2e}*max", flush=True)

    fns = {"loss_sums": (lambda: rk.loss_sums_pooled(hr, srs, stats),
                         lambda: [rk.loss_sums(hr, srs[i], singles[i]) for i in range(POOL_N)]),
           "loss_grad": (lambda: rk.loss_grad_pooled(hr, srs, rows, ge, gt),
                         lambda: [rk.loss_grad(hr, srs[i], rows[i], ge[i], gt[i])
                                  for i in range(POOL_N)])}
    # each input read once, each output written once; K3 writes N dsr
    n_bytes = {"loss_sums": (1 + POOL_N) * n * 4, "loss_grad": (1 + 2 * POOL_N) * n * 4}
    out = {}
    for name, (pooled, three) in fns.items():
        runs = [time_ms(fn, windows=5, reps=10) for fn in (pooled, three, three, pooled)]
        dev_p, dev_3 = loss_device_ms(pooled), loss_device_ms(three)
        t_bytes = n_bytes[name] / HBM_BYTES_PER_S * 1e3
        t_ops = POOL_N * n * OPS_PER_ELEMENT[name] / FP32_OPS_PER_S * 1e3
        rec = {"ms": statistics.median(runs[0] + runs[3]),
               "three_single_ms": statistics.median(runs[1] + runs[2]),
               "device_ms": sum(dev_p.values()), "three_single_device_ms": sum(dev_3.values()),
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "max_abs_err": max_abs[name], "device_ms_by_kernel": dev_p}
        rec["bound_share"] = rec["bound_ms"] / rec["device_ms"]
        out[name] = rec
        print(f"pooled kernel {name} N={POOL_N}: one launch {rec['ms']:.4f} ms by events "
              f"(device {rec['device_ms']:.4f}: "
              + ", ".join(f"{k} {v:.4f}" for k, v in dev_p.items())
              + f"), three single launches {rec['three_single_ms']:.4f} ms (device "
              f"{rec['three_single_device_ms']:.4f}); bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']}), {rec['bound_share']:.3f} of it", flush=True)
    return out


def _vmap_members(cd: str, n: int, dev, norm: str = "none"):
    """JAX's vmap-against-scan members (``tests/test_stacked_pool.py``: F=8,
    1 block, 2x), seeds 0..n-1."""
    from srgan_tpu_torch.config import ModelConfig
    from srgan_tpu_torch.models.srresnet import init_generator
    from srgan_tpu_torch.training.train_state import TrainState

    cfg = ModelConfig(num_features=8, num_residuals=1, upscale_factor=2, norm=norm,
                      compute_dtype=cd)
    return [TrainState(init_generator(cfg, seed=i, device=dev)) for i in range(n)]


def _margin(a, b, rtol: float, atol: float) -> float:
    """max(|a − b| − atol − rtol·|b|): ≤ 0 where ``a`` is within the bar."""
    a, b = a.detach(), b.detach().to(a.device)
    return float(((a - b).abs() - atol - rtol * b.abs()).max())


# Adam's first step moves a weight by lr·g/(|g| + 1e-8): where |g| is within
# 100 eps of 0, the two executors' rounding of g moves it by up to ±lr
EPS_REGIME = 1e-6


def _params_margin(got, want) -> tuple:
    """``_margin`` of the params after one step (rtol 2e-4, atol 1e-6) over
    the elements whose gradient (10·mu after one step) is at least
    ``EPS_REGIME``, and the count of those left out."""
    worst, left_out = -math.inf, 0
    for x, y in zip(got, want):
        for p, q, mu in zip(x.params, y.params, y.mu):
            keep = (10 * mu).abs() >= EPS_REGIME
            left_out += int((~keep).sum())
            if keep.any():
                worst = max(worst, _margin(p[keep], q[keep], 2e-4, 1e-6))
    return worst, left_out


def vmap_small_phase(rk, dev) -> None:
    """JAX's vmap-against-scan tests (``tests/test_stacked_pool.py:151-255``)
    on the card: one pixel step (N=3, HR 16x16) and one fused GAN step
    (N=2, HR 64x64, mask [1, 1], D of 2 stages at 8 filters on member 1's
    SR) of the vmap executor against the scan executor, norm="none", and
    against the vmap step on the CPU, in fp32 and bf16. Bars, fp32 against
    scan (JAX's): losses rtol 1e-5 / atol 1e-7, member 1's SR rtol 1e-5 /
    atol 1e-6, Adam moments rtol 2e-4 / atol 1e-6, params the same where the
    gradient is not within ``EPS_REGIME`` of 0 (counted); bf16 against
    scan and both dtypes against the CPU, the card-against-CPU bars of
    phases 3 and 5 (pixel losses rel 1e-4 / 2e-2, adversarial ADV_ATOL,
    moments GRAD_RTOL). K1-K3 launch once a vmap step (K2/K3 on the member
    axis) and once a member a scan step. No op may fall back to functorch's
    per-member loop."""
    from srgan_tpu_torch.config import DiscriminatorConfig
    from srgan_tpu_torch.models.discriminator import init_discriminator
    from srgan_tpu_torch.training import stacked_pool as sp
    from srgan_tpu_torch.training.train_state import TrainState

    t0 = time.perf_counter()
    fx = torch._C._functorch
    fx._set_vmap_fallback_enabled(False)
    cpu = torch.device("cpu")
    rng = np.random.default_rng(0)
    inputs = {"pixel": [rng.random((2, 16, 16, 3), dtype=np.float32),
                        rng.random((2, 8, 8, 3), dtype=np.float32)],
              "gan": [rng.random((2, 64, 64, 3), dtype=np.float32),
                      rng.random((2, 32, 32, 3), dtype=np.float32)]}
    try:
        for cd in ("float32", "bfloat16"):
            fp32 = cd == "float32"
            for kind in ("pixel", "gan"):
                n = 3 if kind == "pixel" else 2
                res = {}
                for ex, d in (("vmap", dev), ("scan", dev), ("vmap cpu", cpu)):
                    members = _vmap_members(cd, n, d)
                    hr, lr_imgs = (torch.from_numpy(a).to(d) for a in inputs[kind])
                    sr1 = members[1].model(lr_imgs).detach()
                    rk.reset_launches()
                    if kind == "pixel" and ex == "scan":
                        members, m = sp.scanned_pool_step(members, hr, lr_imgs, 1e-3)
                    elif kind == "pixel":
                        members, m = sp.stacked_pool_step(members, hr, lr_imgs, 1e-3,
                                                          return_sr=True, d_target_idx=1)
                    else:
                        d_cfg = DiscriminatorConfig(num_filters=8, num_stages=2, compute_dtype=cd)
                        d_state = TrainState(init_discriminator(d_cfg, seed=9, device=d))
                        step = (sp.stacked_pool_gan_step if ex.startswith("vmap")
                                else sp.scanned_pool_gan_step)
                        members, d_state, m = step(members, d_state, hr, lr_imgs,
                                                   np.ones(n, np.float32), 1e-3, 1e-3,
                                                   d_target_idx=1)
                        members = [*members, d_state]
                    if d.type == "cuda":
                        torch.cuda.synchronize()
                    res[ex] = (m, members, sr1, dict(rk.launches), dict(rk.pooled))
                (m_v, st_v, _, c_v, p_v), (m_s, st_s, sr_s, c_s, _) = res["vmap"], res["scan"]
                m_c, st_c = res["vmap cpu"][:2]
                check(all(c_v[k] == 1 for k in LOSS_KERNELS) and p_v == {"loss_sums": 1, "loss_grad": 1},
                      f"vmap {kind} {cd}: launches {c_v}, member-axis {p_v}; expected 1 each")
                check(all(c_s[k] == n for k in LOSS_KERNELS),
                      f"scan {kind} {cd}: launches {c_s}; expected {n} each")
                px_keys = ["com_loss", "tv_loss", "g_loss"]
                adv_keys = ["g_d_loss", "d_loss"] if kind == "gan" else []
                # against scan: JAX's bars in fp32; the card-against-CPU bars in bf16
                if fp32:
                    l_m = max(_margin(m_v[k], m_s[k], 1e-5, 1e-7) for k in px_keys + adv_keys)
                else:
                    l_m = max([_margin(m_v[k], m_s[k], 2e-2, 0.0) for k in px_keys]
                              + [_margin(m_v[k], m_s[k], 0.0, ADV_ATOL[cd]) for k in adv_keys])
                check(l_m <= 0, f"vmap {kind} {cd} against scan: a loss beyond its bar by {l_m:.2e}")
                c_m = max([_margin(m_v[k].cpu(), m_c[k], 1e-4 if fp32 else 2e-2, 0.0)
                           for k in px_keys]
                          + [_margin(m_v[k].cpu(), m_c[k], 0.0, ADV_ATOL[cd]) for k in adv_keys])
                check(c_m <= 0, f"vmap {kind} {cd} card against CPU: a loss beyond its bar by "
                                f"{c_m:.2e}")
                g_c = moments_rel_err(st_v, st_c)
                check(g_c <= GRAD_RTOL[cd], f"vmap {kind} {cd} card against CPU: moments rel "
                      f"{g_c:.2e} > {GRAD_RTOL[cd]}")
                if fp32:
                    worst = max(_margin(p, q, 2e-4, 1e-6) for x, y in zip(st_v, st_s)
                                for p, q in zip(x.mu + x.nu, y.mu + y.nu))
                    check(worst <= 0, f"vmap {kind} fp32 against scan: Adam moments "
                                      f"beyond rtol 2e-4 / atol 1e-6 by {worst:.2e}")
                    p_m, n_eps = _params_margin(st_v, st_s)
                    check(p_m <= 0, f"vmap {kind} fp32 against scan: params beyond rtol "
                                    f"2e-4 / atol 1e-6 by {p_m:.2e}")
                    detail = (f"moments margin {worst:.2e}, params margin {p_m:.2e} "
                              f"({n_eps} elements with |g| < {EPS_REGIME:g} left out)")
                    if kind == "pixel":  # member 1's pre-update SR, the D handoff
                        sr_m = _margin(m_v["sr"], sr_s, 1e-5, 1e-6)
                        check(sr_m <= 0, f"vmap pixel fp32: member 1's SR beyond rtol 1e-5 / "
                                         f"atol 1e-6 by {sr_m:.2e}")
                        detail += f", member 1's SR margin {sr_m:.2e}"
                else:
                    g_s = moments_rel_err(st_v, st_s)
                    check(g_s <= GRAD_RTOL[cd], f"vmap {kind} bf16 against scan: moments rel "
                          f"{g_s:.2e} > {GRAD_RTOL[cd]}")
                    detail = f"moments rel {g_s:.2e} (bar {GRAD_RTOL[cd]})"
                print(f"vmap small {kind} {cd} N={n}: against scan, losses margin {l_m:.2e}, "
                      f"{detail}; card against CPU, losses margin {c_m:.2e}, moments rel "
                      f"{g_c:.2e}; launches vmap {c_v} (member axis {p_v}), scan {c_s}",
                      flush=True)
    finally:
        fx._set_vmap_fallback_enabled(True)
    print(f"vmap small: phase {time.perf_counter() - t0:.1f} s", flush=True)


def _remat_margins(got: list, want: list) -> tuple:
    """Two runs' ``_host_states``: whether every tensor is bit-identical; the
    margin (``_margin`` at JAX's vmap-against-scan bars, rtol 2e-4 / atol
    1e-6) of the Adam moments; that of the params over the elements whose
    gradient (|mu|·scale) is at least ``EPS_REGIME``; the count of those
    left out."""
    pairs = list(zip(got, want))
    same = all(torch.equal(x, y) for a, b in pairs
               for x, y in zip(a[0] + a[1] + a[2], b[0] + b[1] + b[2]))
    moments = max(_margin(x, y, 2e-4, 1e-6) for a, b in pairs
                  for x, y in zip(a[1] + a[2], b[1] + b[2]))
    params, left_out = -math.inf, 0
    for (p_a, _, _, _), (p_b, mu_b, _, scale) in pairs:
        for p, q, mu in zip(p_a, p_b, mu_b):
            keep = (mu * scale).abs() >= EPS_REGIME
            left_out += int((~keep).sum())
            if keep.any():
                params = max(params, _margin(p[keep], q[keep], 2e-4, 1e-6))
    return same, moments, params, left_out


def _epoch_losses(rec) -> dict:
    """The loss values of a run's warm-up and counted epochs."""
    return {f"{e} {k}": v for e, m in (("warm", rec["warm"]), ("counted", rec["metrics"]))
            for k, v in m.items() if k.endswith("loss")}


# (name, executor, gan, remat, batch) of the flagship pool-of-3 bf16 runs
VMAP_LEGS = (("vmap pool 3", "vmap", False, False, 12), ("scan pool 3", "scan", False, False, 12),
             ("vmap pool 3 gan", "vmap", True, False, 12),
             ("vmap pool 3 gan again", "vmap", True, False, 12),
             ("vmap remat pool 3", "vmap", False, True, 12),
             ("vmap remat pool 3 gan", "vmap", True, True, 12),
             ("vmap remat pool 3 gan again", "vmap", True, True, 12),
             ("vmap remat pool 3 batch 24", "vmap", False, True, 24))


def vmap_flagship_phase(rk, dev, scan_gan: dict) -> dict:
    """The pool of 3 at the flagship size, bf16, through
    ``Trainer.train_epoch``, each run a warm-up and a counted epoch of 3
    steps: ms/step, img/s, peak memory, launches a step (vmap 1/1/1, K2/K3
    on the member axis; scan 3/3/3). At batch 12 the vmap executor (pixel,
    then GAN) beside the scan executor (pixel here; GAN from the GAN phase's
    run of the same config, ``scan_gan``), then the vmap executor on remat
    models, pixel and GAN, against the vmap runs without remat: the losses
    of both epochs bit-identical, every network's params and Adam moments
    bit-identical or within JAX's bars (``_remat_margins``), peak memory
    below theirs. The vmap GAN run, with and without remat, again from the
    same seeds: two runs of 2 epochs, every network's params and Adam
    moments and the losses bit-identical under the deterministic mode. Last
    a remat pixel run at batch 24 (no run without remat there)."""
    t0 = time.perf_counter()
    clips = {12: smooth_clips(dev, FLAGSHIP_STEPS * 12, 1),
             24: smooth_clips(dev, FLAGSHIP_STEPS * 24, 1)}
    out, hosts, losses = {}, {}, {}
    with tempfile.TemporaryDirectory() as results_dir:
        for name, ex, gan, remat, batch in VMAP_LEGS:
            torch.cuda.empty_cache()
            run = Flagship(dev, "bfloat16", batch, clips[batch], results_dir, n_gen=POOL_N,
                           gan=gan, member_exec=ex, remat=remat)
            try:
                if name.endswith("again"):
                    rec = {"metrics": run.epoch()[0]}
                else:
                    rec = out[name] = run.counted(rk)
                rec["warm"] = run.warm
                losses[name] = _epoch_losses(rec)
                if batch == 12 and ex == "vmap":
                    hosts[name] = _host_states(run)
                if not gan and batch == 12:  # where the pixel step's time goes
                    profile_epoch(run.trainer, run.pipe, FLAGSHIP_STEPS, run.tag)
            finally:
                run.close()
                del run
    for first in ("vmap pool 3 gan", "vmap remat pool 3 gan"):
        again = f"{first} again"
        check(_remat_margins(hosts[first], hosts[again])[0] and losses[first] == losses[again],
              f"vmap determinism: two flagship bf16 {first} runs differ: "
              f"{losses[first]} / {losses[again]}")
    for kind, v, s in (("pixel", out["vmap pool 3"], out["scan pool 3"]),
                       ("gan", out["vmap pool 3 gan"], scan_gan)):
        per = {ex: "/".join(str(r["counts"][k] // FLAGSHIP_STEPS) for k in LOSS_KERNELS)
               for ex, r in (("vmap", v), ("scan", s))}
        check(per == {"vmap": "1/1/1", "scan": f"{POOL_N}/{POOL_N}/{POOL_N}"},
              f"vmap flagship {kind}: K1/K2/K3 launches a step {per}")
        print(f"vmap flagship bf16 pool {POOL_N} {kind} batch 12: vmap {v['step_ms']:.2f} "
              f"ms/step ({12e3 / v['step_ms']:.2f} img/s, peak {v['peak_gib']:.2f} GiB) against "
              f"scan {s['step_ms']:.2f} ms/step ({12e3 / s['step_ms']:.2f} img/s, peak "
              f"{s['peak_gib']:.2f} GiB): vmap/scan {v['step_ms'] / s['step_ms']:.3f}; K1/K2/K3 "
              f"launches a step vmap {per['vmap']}, scan {per['scan']}", flush=True)
    for kind, plain, remat in (("pixel", "vmap pool 3", "vmap remat pool 3"),
                               ("gan", "vmap pool 3 gan", "vmap remat pool 3 gan")):
        v, r = out[plain], out[remat]
        per = "/".join(str(r["counts"][k] // FLAGSHIP_STEPS) for k in LOSS_KERNELS)
        check(per == "1/1/1", f"vmap remat flagship {kind}: K1/K2/K3 launches a step {per}")
        check(losses[remat] == losses[plain],
              f"vmap remat flagship {kind}: losses {losses[remat]} differ from the vmap "
              f"run's without remat {losses[plain]}")
        same, moments, params, left_out = _remat_margins(hosts[remat], hosts[plain])
        check(same or (moments <= 0 and params <= 0),
              f"vmap remat flagship {kind}: against the vmap run without remat, Adam moments "
              f"margin {moments:.2e}, params margin {params:.2e} (rtol 2e-4 / atol 1e-6)")
        check(r["peak_gib"] < v["peak_gib"],
              f"vmap remat flagship {kind}: peak {r['peak_gib']:.2f} GiB not below the vmap "
              f"run's {v['peak_gib']:.2f}")
        state = ("params and Adam moments bit-identical" if same else
                 f"params margin {params:.2e} ({left_out} elements with |g| < {EPS_REGIME:g} "
                 f"left out), Adam moments margin {moments:.2e}")
        print(f"vmap remat flagship bf16 pool {POOL_N} {kind} batch 12: remat "
              f"{r['step_ms']:.2f} ms/step ({12e3 / r['step_ms']:.2f} img/s, peak "
              f"{r['peak_gib']:.2f} GiB) against vmap {v['step_ms']:.2f} ms/step "
              f"({12e3 / v['step_ms']:.2f} img/s, peak {v['peak_gib']:.2f} GiB): ms/step "
              f"remat/vmap {r['step_ms'] / v['step_ms']:.3f}, peak remat/vmap "
              f"{r['peak_gib'] / v['peak_gib']:.3f}; K1/K2/K3 launches a step {per}; losses of "
              f"both epochs bit-identical; {state}", flush=True)
    b24 = out["vmap remat pool 3 batch 24"]
    per = "/".join(str(b24["counts"][k] // FLAGSHIP_STEPS) for k in LOSS_KERNELS)
    check(per == "1/1/1", f"vmap remat flagship batch 24: K1/K2/K3 launches a step {per}")
    print(f"vmap remat flagship bf16 pool {POOL_N} pixel batch 24: {b24['step_ms']:.2f} "
          f"ms/step ({24e3 / b24['step_ms']:.2f} img/s), peak {b24['peak_gib']:.2f} GiB; "
          f"K1/K2/K3 launches a step {per}", flush=True)
    print(f"vmap determinism flagship bf16 pool {POOL_N} gan, with and without remat, 2 "
          f"epochs twice: params and Adam moments of {POOL_N} generators and D and the "
          f"losses bit-identical; phase {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def spatial_phase(dev) -> dict:
    """``parallel.spatial.upscale_spatially_sharded`` on the flagship
    generator (F=64, 16 blocks, 4x, seed 0) and the serving phase's LR
    1080x1920 frame, in fp32 and bf16: without a group and under a
    one-rank NCCL group (both the plain forward, by contract), against the
    model's own forward. Bars: fp32 1e-5·max|y|, bf16 2e-2·max|y| (the CPU
    tests' bf16 serving bar). One card holds one rank: the halo exchange
    across ranks runs in the CPU tests only."""
    import torch.distributed as dist

    from srgan_tpu_torch.config import ModelConfig
    from srgan_tpu_torch.models.srresnet import init_generator
    from srgan_tpu_torch.parallel import mesh
    from srgan_tpu_torch.parallel.spatial import upscale_spatially_sharded

    t0 = time.perf_counter()
    frame = smooth_clips(dev, 1, 12, hw=TILED_LR)[0].astype(np.float32) / 255.0
    saved_env = dict(os.environ)
    os.environ.update(_torchrun_env(_free_port()))
    mesh.initialize_multihost()
    out = {}
    try:
        group = mesh.default_group()
        for cd, bar in (("float32", 1e-5), ("bfloat16", 2e-2)):
            model = init_generator(ModelConfig(compute_dtype=cd), seed=0, device=dev).eval()
            x = torch.from_numpy(frame).to(dev)[None]

            def plain():
                with torch.no_grad():
                    return model(x)[0].cpu().numpy()

            timed = {}
            for name, fn in (("plain", plain),
                             ("no group", lambda: upscale_spatially_sharded(model, frame)),
                             ("world 1", lambda: upscale_spatially_sharded(model, frame, group))):
                fn()  # warm-up
                torch.cuda.synchronize()
                t = time.perf_counter()
                y = fn()
                timed[name] = (y, (time.perf_counter() - t) * 1e3)
            want = timed["plain"][0]
            scale = float(np.abs(want).max())
            errs = {k: float(np.abs(v[0] - want).max()) for k, v in timed.items() if k != "plain"}
            check(want.shape == (4 * TILED_LR[0], 4 * TILED_LR[1], 3) and np.isfinite(want).all(),
                  f"spatial {cd}: output {want.shape}")
            check(all(e <= bar * scale for e in errs.values()),
                  f"spatial {cd}: max|Δ| {errs} > {bar}·max|y| = {bar * scale:.3e}")
            out[cd] = {k: v[1] for k, v in timed.items()}
            print(f"spatial {cd} LR {TILED_LR}: upscale_spatially_sharded without a group "
                  f"{timed['no group'][1]:.1f} ms, one-rank NCCL group {timed['world 1'][1]:.1f} "
                  f"ms, the model's forward {timed['plain'][1]:.1f} ms (host copy included); "
                  f"max|Δ| {errs} (bar {bar}·max|y| = {bar * scale:.2e})", flush=True)
            del model, x, timed
    finally:
        dist.destroy_process_group()
        os.environ.clear()
        os.environ.update(saved_env)
    print(f"spatial: phase {time.perf_counter() - t0:.1f} s", flush=True)
    return out


S2D_BATCH, S2D_LR = 24, (128, 256)  # scripts/s2d_trunk_probe.py's defaults


def device_ms_by_group(fn, tag: str) -> dict:
    """Device ms of one call of ``fn`` by ``PROFILE_GROUPS`` group, and its
    top kernels, from the profiler (after an unprofiled call)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in _device_events(prof):
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    groups = _by_group(by_name)
    busy = sum(groups.values())
    print(f"profile {tag}: device busy {busy:.2f} ms; by group: " + "; ".join(
        f"{g} {ms:.2f}" for g, ms in sorted(groups.items(), key=lambda kv: -kv[1])), flush=True)
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        print(f"profile {tag}:   {ms:9.3f} ms  {name[:100]}")
    return groups


def s2d_phase(dev) -> dict:
    """``models/s2d_trunk.py`` at ``scripts/s2d_trunk_probe.py``'s defaults
    (batch 24, LR 128x256, F=64, 16 blocks, bf16, with gradients: the
    gradient of mean(trunk(x)²) in the trunk's params): ``s2d_trunk``
    against ``fine_trunk`` on the same model, outputs and the whole trunk's
    gradient, in fp32 (‖Δ‖/‖ref‖ ≤ 1e-4 output, 1e-3 gradient: the fold is exact, the
    sums' order is not) and bf16 (2e-2 and 5e-2: two roundings of 16
    blocks); ms/step of each in turns (fine, s2d, s2d, fine, 5 steps
    each)."""
    from srgan_tpu_torch.config import ModelConfig
    from srgan_tpu_torch.models.s2d_trunk import fine_trunk, s2d_trunk
    from srgan_tpu_torch.models.srresnet import init_generator

    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.rand((S2D_BATCH, *S2D_LR, ModelConfig().num_features), generator=g, device=dev)
    out = {}
    for cd, bars in (("float32", (1e-4, 1e-3)), ("bfloat16", (2e-2, 5e-2))):
        model = init_generator(ModelConfig(compute_dtype=cd), seed=0, device=dev)
        params = [p for n, p in model.named_parameters() if n.startswith(("blocks.", "mid."))]

        def step(trunk):
            y = trunk(model, x)
            return y, torch.autograd.grad(y.float().square().sum() / x.numel(), params)

        (y_f, g_f), (y_s, g_s) = step(fine_trunk), step(s2d_trunk)
        y_err = float((y_s.float() - y_f.float()).detach().norm() / y_f.float().detach().norm())
        # on the whole trunk's gradient: the convs' biases before a GroupNorm
        # have a true gradient of 0, each alone only rounding
        g_err = math.sqrt(sum(float((a - b).double().square().sum()) for a, b in zip(g_s, g_f))
                          / sum(float(b.double().square().sum()) for b in g_f))
        check(y_err <= bars[0] and g_err <= bars[1],
              f"s2d {cd}: s2d against fine trunk: output {y_err:.2e} (bar {bars[0]}), "
              f"gradients {g_err:.2e} (bar {bars[1]})")
        del y_f, g_f, y_s, g_s
        times = {"fine": [], "s2d": []}
        if cd == "bfloat16":
            for name, trunk in (("fine", fine_trunk), ("s2d", s2d_trunk), ("s2d", s2d_trunk),
                                ("fine", fine_trunk)):
                torch.cuda.synchronize()
                t = time.perf_counter()
                for _ in range(5):
                    step(trunk)
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t) / 5 * 1e3)
            out = {k: statistics.mean(v) for k, v in times.items()}
            for name, trunk in (("fine", fine_trunk), ("s2d", s2d_trunk)):
                device_ms_by_group(lambda: step(trunk), f"s2d {cd} {name} trunk step")
        print(f"s2d {cd} batch {S2D_BATCH} LR {S2D_LR} {len(model.blocks)} blocks: s2d "
              f"against fine "
              f"output rel {y_err:.2e} (bar {bars[0]}), gradients rel {g_err:.2e} (bar "
              f"{bars[1]})" + ("" if cd == "float32" else
                               "; ms/step fine " + " / ".join(f"{t:.2f}" for t in times["fine"])
                               + ", s2d " + " / ".join(f"{t:.2f}" for t in times["s2d"])
                               + f"; s2d/fine {out['s2d'] / out['fine']:.3f}"), flush=True)
        del model, params
    print(f"s2d: phase {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    if sys.argv[1:] == ["--phase", "window_attention"]:
        from srgan_tpu_torch.utils.platform import disable_tf32, make_deterministic

        disable_tf32()
        make_deterministic()
        rec = window_attention_phase(torch.device("cuda"))
        print(json.dumps({"kernels": [{"name": "window_attention", "route": "cuda",
                                       "source": "srgan_tpu_torch/csrc/window_attention.cu",
                                       "replaces": None, **rec}]}))
        return 0
    from srgan_tpu_torch.ops.cuda import recon_loss_kernel as rk
    from srgan_tpu_torch.ops.cuda import residual_tower_kernel as tk
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
    group_norm = group_norm_phase(dev)
    small_step_phase(dev)
    gan_small_step_phase(dev)
    pixel, scoring = training_phase(rk, dev)
    counts = pixel["counts"]
    gan = gan_training_phase(rk, dev)
    det = determinism_phase(rk, dev, gan["pool gan flagship"])
    multihost = multihost_phase(rk, dev, det)
    pooled = pooled_kernel_phase(rk, dev)
    vmap_small_phase(rk, dev)
    vmap = vmap_flagship_phase(rk, dev, gan["pool gan flagship"])
    spatial_phase(dev)
    s2d_phase(dev)
    spots = input_phase(rk, dev)["counts"]
    with tempfile.TemporaryDirectory() as root:
        entry, res, flags = entry_point_phase(rk, dev, root)
        traced = trace_phase(rk, dev, flags, root)
        perceptual_small_phase(dev)
        enc_path = perceptual_entry_phase(dev, root)
        perceptual = perceptual_training_phase(rk, dev, enc_path)
        tower = tower_phase(dev)
        serve = serve_phase(rk, tk, dev, res)
    window_attn = window_attention_phase(dev)
    # K1-K3's launches on each path this script drove, each read just after
    # its run: 3 steps of the flagship (fp32; its counts are "launches"),
    # of the pool of 3 and of the one-generator GAN run, 2 steps of each
    # counted entry-point leg, 3 steps of each one-generator perceptual run
    # and 2 of the perceptual pool of 3, and the serving phase (none)
    by_path = {"pixel fp32": counts, **{k: v["counts"] for k, v in gan.items()},
               "determinism pool 3 gan": det["counts"], "multihost world 1": multihost,
               **{k: v["counts"] for k, v in vmap.items()},
               "salt and pepper": spots,
               **{f"entry point {k}": v for k, v in entry.items()}, "trace": traced,
               **{k: v["counts"] for k, v in perceptual.items()}, "serve": serve}

    line = []
    for name, rec in kernels.items():
        regs = resources.get((name, "vec"))
        line.append({
            "name": f"recon_{name}",
            "route": "cuda",
            "source": "srgan_tpu_torch/csrc/recon_loss.cu",
            "replaces": TPU_KERNELS[name],
            "launches": counts[name],
            "launches_by_path": {k: v[name] for k, v in by_path.items()},
            **rec,
            # K2/K3's member-axis launch (the vmap pool executor) at N=3
            "pooled": pooled.get(name),
            "registers": regs[0] if regs else None,
            "spill_bytes": regs[2] if regs else None,
            "library_ms": None,  # no single PyTorch call computes it
            "cudnn_chain_ms": None,
            "tflops": None,
            "cudnn_chain_tflops": None,
        })
    for rec in tower:  # K4/K5: launched by the tower phase alone
        name = rec["name"].rsplit("_", 1)[0]
        rec["launches_by_path"] = {"tower": rec["launches"], "serve": serve[name]}
    line += tower
    # GroupNorm's launches and routes on each path, read just after it: the
    # kernels in scoring and serving, torch's in every training step
    line.append({"name": "group_norm", "route": "cuda",
                 "source": "srgan_tpu_torch/csrc/group_norm.cu", "replaces": None,
                 "launches_by_path": {
                     "pixel fp32": pixel["group_norm"], "scoring": scoring,
                     **{k: v["group_norm"] for k, v in {**gan, **vmap}.items()},
                     "serve": serve["group_norm"]},
                 **group_norm})
    line.append({"name": "window_attention", "route": "cuda",
                 "source": "srgan_tpu_torch/csrc/window_attention.cu", "replaces": None,
                 **window_attn})
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
