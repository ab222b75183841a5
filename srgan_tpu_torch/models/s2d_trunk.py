"""The space-to-depth form of the residual trunk, the counterpart of
``srgan_tpu/models/s2d_trunk.py``: a probe beside the model, on no shipped
path.

The trunk (the residual blocks, the mid conv and the global skip, at LR
resolution and F channels) has an exactly equivalent form on
``pixel_unshuffle(x, 2)``, at (H/2, W/2, 4F):

  - a fine conv3x3 (padding 1, Cin → Cout) equals a coarse conv3x3
    (padding 1, 4Cin → 4Cout) whose kernel embeds the fine one: output fine
    pixel (2i+a, 2j+b) reads fine input (2i+a+u, 2j+b+v) = coarse
    (i+s, j+t), phase (p, q), with s = ⌊(a+u)/2⌋, p = (a+u) − 2s (the same
    for t, q). A quarter of the coarse kernel is non-zero, so the dense
    coarse conv does 4x the fine conv's multiply-adds;
  - GroupNorm(G) over F fine channels equals GroupNorm(G) over the 4F coarse
    ones: the unshuffle's channel order (c·4 + 2·rh + rw) keeps a fine
    group's channels and their 4 phases contiguous, over the same elements;
    scale and bias repeat 4 times;
  - ReLU, the residual adds and the global skip commute with the unshuffle,
    so the whole trunk folds: one unshuffle in, one shuffle out.

Both trunks here run on a port ``SRResNet``'s ``blocks`` and ``mid``
parameters (OIHW), NHWC in and out, with the model's compute dtype and its
GroupNorm (statistics in f32, eps 1e-6, torch's kernel). ``fine_trunk`` is
the oracle; ``s2d_trunk`` folds every conv each call, a contraction with a
constant 0/1 map, so its gradient reaches the fine parameters.

Timed by ``chip_smoke.py``'s s2d phase at ``scripts/s2d_trunk_probe.py``'s
defaults (batch 24, LR 128x256, F=64, 16 blocks, bf16, forward and
backward) on an NVIDIA H100 80GB HBM3 at its 700.00 W power limit:

  fine_trunk   90.70 / 90.70 ms/step   convs 31.39 device ms
  s2d_trunk   106.93 / 122.78 ms/step  convs 46.24 device ms

so cuDNN runs the dense fold's 4x multiply-adds at 256 channels in 1.47x
the fine convs' time, and the s2d trunk is 1.27x the fine one. A fold
written as a gather (one index per coarse entry) took 1.29 s a step on
that card in the backward of the gather alone: an accumulating scatter,
sorted under deterministic algorithms.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from srgan_tpu_torch.models.srresnet import SRResNet
from srgan_tpu_torch.ops.pixel_shuffle import pixel_shuffle, pixel_unshuffle


@functools.lru_cache(maxsize=None)
def _phase_map(device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """M[S, P, A, U] = 1 where fine output phase A (0, 1) reading fine tap U
    (offset U − 1) lands in coarse tap S (offset S − 1), input phase P:
    A + U − 1 = 2(S − 1) + P. The fold is separable, the same map for rows
    and columns. A constant, never written."""
    m = np.zeros((3, 2, 2, 3), np.float32)
    for a in range(2):
        for u in range(-1, 2):
            m[(a + u) // 2 + 1, (a + u) % 2, a, u + 1] = 1.0
    return torch.from_numpy(m).to(device, dtype)


def fold_conv3x3_to_s2d(weight: torch.Tensor, bias: torch.Tensor):
    """A fine conv3x3's OIHW ``weight`` (Cout, Cin, 3, 3) and ``bias`` →
    the exactly equivalent coarse conv3x3 (4·Cout, 4·Cin, 3, 3) on
    ``pixel_unshuffle(x, 2)`` (padding 1 on both grids: the coarse kernel
    never reads a phase outside the fine halo), and its bias. Coarse entry
    (o·4 + 2a + b, i·4 + 2p + q, s, t) is fine tap (u, v) of (o, i), or 0: a
    contraction with the 0/1 phase map on each axis, every sum one product
    and zeros, so exact; differentiable in ``weight`` and ``bias`` (the
    backward is the same contraction, with no scatter)."""
    cout, cin, kh, kw = weight.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"trunk convs are 3x3, got {kh}x{kw}")
    m = _phase_map(weight.device, weight.dtype)
    coarse = torch.einsum("spau,tqbv,oiuv->oabipqst", m, m, weight)
    return coarse.reshape(4 * cout, 4 * cin, 3, 3), bias.repeat_interleave(4)


def _conv3x3(x, weight, bias, cd):
    return F.conv2d(x.to(cd), weight.to(cd), padding=1) + bias.to(cd).view(1, -1, 1, 1)


def _group_norm(x, scale, bias, groups: int):
    """The model's GroupNorm as a function: statistics, normalise, scale and
    bias in f32 (eps 1e-6), the output in x's dtype."""
    return F.group_norm(x.float(), groups, scale, bias, 1e-6).to(x.dtype)


def _groups(model: SRResNet) -> int:
    return model.blocks[0].norm1.num_groups


def fine_trunk(model: SRResNet, out1: torch.Tensor) -> torch.Tensor:
    """The model's trunk written out (blocks, mid conv, global skip) on its
    parameters: ``out1`` (B, H, W, F) NHWC, the stem's output → the trunk's
    output, NHWC in the compute dtype. The oracle of :func:`s2d_trunk`."""
    cd, g = model.compute_dtype, _groups(model)
    x1 = out1.permute(0, 3, 1, 2).to(cd)
    out = x1
    for blk in model.blocks:
        y = _conv3x3(out, blk.conv1.weight, blk.conv1.bias, cd)
        y = torch.relu(_group_norm(y, blk.norm1.weight, blk.norm1.bias, g))
        y = _conv3x3(y, blk.conv2.weight, blk.conv2.bias, cd)
        out = _group_norm(y, blk.norm2.weight, blk.norm2.bias, g) + out
    out = _conv3x3(out, model.mid.weight, model.mid.bias, cd) + x1
    return out.permute(0, 2, 3, 1)


def s2d_trunk(model: SRResNet, out1: torch.Tensor) -> torch.Tensor:
    """The same trunk on ``pixel_unshuffle(out1, 2)`` at (H/2, W/2, 4F), its
    convs folded (:func:`fold_conv3x3_to_s2d`) and GroupNorm's scale and
    bias repeated, shuffled back at the end: :func:`fine_trunk`'s output to
    rounding. H and W must be even."""
    cd, g = model.compute_dtype, _groups(model)
    x1 = pixel_unshuffle(out1.to(cd), 2).permute(0, 3, 1, 2)
    out = x1
    for blk in model.blocks:
        k, b = fold_conv3x3_to_s2d(blk.conv1.weight, blk.conv1.bias)
        y = _conv3x3(out, k, b, cd)
        y = torch.relu(_group_norm(y, blk.norm1.weight.repeat_interleave(4),
                                   blk.norm1.bias.repeat_interleave(4), g))
        k, b = fold_conv3x3_to_s2d(blk.conv2.weight, blk.conv2.bias)
        y = _conv3x3(y, k, b, cd)
        out = _group_norm(y, blk.norm2.weight.repeat_interleave(4),
                          blk.norm2.bias.repeat_interleave(4), g) + out
    k, b = fold_conv3x3_to_s2d(model.mid.weight, model.mid.bias)
    out = _conv3x3(out, k, b, cd) + x1
    return pixel_shuffle(out.permute(0, 2, 3, 1), 2)
