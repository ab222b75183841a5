"""W-sharded inference for images larger than one device's memory, the
counterpart of ``srgan_tpu/parallel/spatial.py``.

JAX shards the image's width over a mesh and lets GSPMD insert the halo
exchanges the convolutions need. Here each rank of a process group holds
one vertical stripe and runs the model's own forward on it, with its two
kinds of non-local layer swapped for the call:

  - every stride-1 ``nn.Conv2d`` (the generator's ``Conv2d``) first takes
    ``k//2`` columns of W halo from the stripes beside it, zeros beyond the
    image's outer edges (SAME), then convolves with no W padding;
  - every ``nn.GroupNorm`` (the generator's ``GroupNorm``) takes its
    statistics over the whole width: each rank's per-group Σx and Σ(x−x̄)²
    of its stripe, in f32, gathered and combined over the ranks in fp64
    (Chan's parallel formula, so that the variance keeps the single-device
    forward's precision where the mean is large against the spread).

Pointwise layers and the pixel (un)shuffles act within a stripe; the
shuffles keep the stripes equal and even, which ``pixel_unshuffle`` (the
``coarse`` head) needs. The halo is gathered from every rank
(``all_gather``), so a stripe narrower than a halo (the 9x9 stem reaches
4 LR columns) takes columns from as many stripes as it needs. The output
stripes are gathered in rank order.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from srgan_tpu_torch.models.srresnet import SRResNet
from srgan_tpu_torch.parallel.mesh import all_gather_cat, world_size
from srgan_tpu_torch.utils.platform import disable_tf32, make_deterministic, resolve_device


def _with_halo(x: torch.Tensor, h: int, group) -> torch.Tensor:
    """A stripe (…, w) → (…, h + w + h): the h columns left and right of it
    from the other ranks' stripes, zeros beyond the first and last."""
    if h == 0:
        return x
    n, r = world_size(group), dist.get_rank(group)
    w = x.shape[-1]
    e = min(h, w)
    # every rank's first and last e columns, (n, 2, …, e)
    edges = all_gather_cat(torch.stack([x[..., :e], x[..., w - e:]])[None], group)
    k = -(-h // e)  # stripes a halo reaches into
    zeros = torch.zeros_like(edges[0, 0])
    left = [edges[r - j, 1] if r - j >= 0 else zeros for j in range(k, 0, -1)]
    right = [edges[r + j, 0] if r + j < n else zeros for j in range(1, k + 1)]
    return torch.cat([torch.cat(left, -1)[..., k * e - h:], x,
                      torch.cat(right, -1)[..., :h]], -1)


def _sharded_conv(conv: nn.Conv2d, forward, group):
    kh, kw = conv.kernel_size
    if (conv.stride != (1, 1) or conv.dilation != (1, 1) or conv.padding_mode != "zeros"
            or conv.padding != (kh // 2, kw // 2)):
        raise ValueError(
            "W-sharded inference takes stride-1 SAME convolutions only, got "
            f"kernel {conv.kernel_size}, stride {conv.stride}, padding {conv.padding}")

    def sharded(x):
        x = _with_halo(x, kw // 2, group)
        # the module's own forward, its W padding supplied by the halo
        conv.padding = (kh // 2, 0)
        try:
            return forward(x)
        finally:
            conv.padding = (kh // 2, kw // 2)

    return sharded


def _sharded_group_norm(norm: nn.GroupNorm, group):
    def sharded(x):
        x32 = x.float()
        b, g = x32.shape[0], norm.num_groups
        xg = x32.reshape(b, g, -1)
        n_loc = xg.shape[-1]
        s1 = xg.sum(-1)
        m2 = (xg - (s1 / n_loc)[..., None]).square().sum(-1)
        parts = all_gather_cat(torch.stack([s1, m2]).double()[None], group)
        n_tot = n_loc * parts.shape[0]  # the stripes are equal
        mean = parts[:, 0].sum(0) / n_tot
        m2 = parts[:, 1].sum(0) + (n_loc * (parts[:, 0] / n_loc - mean).square()).sum(0)
        rstd = torch.rsqrt(m2 / n_tot + norm.eps)
        y = ((xg - mean.float()[..., None]) * rstd.float()[..., None]).view_as(x32)
        if norm.affine:
            shape = (1, -1) + (1,) * (x32.dim() - 2)
            y = y * norm.weight.view(shape) + norm.bias.view(shape)
        return y.to(getattr(norm, "compute_dtype", x.dtype))

    return sharded


@contextlib.contextmanager
def _sharded_layers(model: nn.Module, group):
    """The model's convs and GroupNorms swapped for their W-sharded forms
    while the context is open."""
    swapped = []
    try:
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                m.forward = _sharded_conv(m, m.forward, group)
            elif isinstance(m, nn.GroupNorm):
                m.forward = _sharded_group_norm(m, group)
            else:
                continue
            swapped.append(m)
        yield model
    finally:
        for m in swapped:
            del m.forward  # the class's forward again


@torch.no_grad()
def upscale_spatially_sharded(
    model: nn.Module,
    image: np.ndarray,
    group=None,
    device=None,
) -> np.ndarray:
    """Super-resolve one HWC (or NHWC) float image with W sharded over the
    ranks of ``group``; every rank passes the same image and gets the whole
    output. ``device``: where this rank's stripe runs (None → the card; the
    model is moved there). ``group=None``, or a group of one rank, is the
    plain forward.

    Exactness, as JAX's: when the width divides by the world size, the
    output equals the single-device forward (the halos cover every stencil,
    GroupNorm's statistics are the whole image's). Otherwise the width is
    edge-padded up to divisibility first, and the output cropped: an
    APPROXIMATION near the right border (replicated-edge context instead of
    zero padding) that also shifts GroupNorm's statistics (the padded stripe
    is in them), exactly as JAX's sharded program computes it."""
    if not isinstance(model, SRResNet):
        # SwinIR's attention windows are no stencil a W halo covers
        raise ValueError(f"W-sharded serving swaps the convs and GroupNorms of an "
                         f"SRResNet; {type(model).__name__} is not one")
    dev = resolve_device(device)
    disable_tf32()
    make_deterministic()
    model = model.to(dev).eval()
    # torch's own strides (numpy can give a size-1 dim stride 0, which
    # steers the CPU convs to another kernel)
    arr = np.asarray(image, dtype=np.float32)
    x = torch.tensor(arr).view(-1).view(arr.shape)
    squeeze = x.dim() == 3
    if squeeze:
        x = x[None]
    n = world_size(group)
    w = x.shape[2]
    if n == 1:
        out = model(x.to(dev)).cpu().numpy()
        return out[0] if squeeze else out
    pad_w = (-w) % n
    if pad_w:  # edge mode, as JAX's np.pad
        x = torch.cat([x, x[:, :, -1:].expand(-1, -1, pad_w, -1)], 2)
    ws = x.shape[2] // n
    r = dist.get_rank(group)
    with _sharded_layers(model, group):
        part = model(x[:, :, r * ws:(r + 1) * ws].contiguous().to(dev))
    # every rank's output stripe, in rank order along W
    out = torch.cat(list(all_gather_cat(part.contiguous()[None], group)), 2)
    out = out.cpu().numpy()
    if pad_w:
        out = out[:, :, : out.shape[2] // x.shape[2] * w]
    return out[0] if squeeze else out
