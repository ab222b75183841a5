"""Pixel-shuffle (depth-to-space) for NHWC batches.

Counterpart of ``srgan_tpu/ops/pixel_shuffle.py``. The NHWC channel order
(c, rh, rw) equals ``F.pixel_shuffle`` on NCHW. Each function is a view, a
permute and one copy of the NHWC memory, so its output is a contiguous
NHWC batch; the model (``models/srresnet.py``) calls them on the NHWC
view of its channels-last activations, so they stay channels-last.
(torch's CUDA ``F.pixel_shuffle`` returns NCHW-contiguous output whatever
its input's layout.)
"""

from __future__ import annotations

import torch


def pixel_shuffle(x: torch.Tensor, upscale_factor: int = 2) -> torch.Tensor:
    """(B, H, W, C*r*r) → (B, H*r, W*r, C), torch channel convention."""
    r = upscale_factor
    b, h, w, c = x.shape
    if c % (r * r) != 0:
        raise ValueError(f"channels {c} not divisible by r^2={r * r}")
    y = x.reshape(b, h, w, c // (r * r), r, r).permute(0, 1, 4, 2, 5, 3)
    return y.reshape(b, h * r, w * r, c // (r * r))


def pixel_unshuffle(x: torch.Tensor, downscale_factor: int = 2) -> torch.Tensor:
    """Inverse of :func:`pixel_shuffle` (space-to-depth)."""
    r = downscale_factor
    b, h, w, c = x.shape
    if h % r or w % r:
        raise ValueError(f"spatial dims ({h},{w}) not divisible by r={r}")
    y = x.reshape(b, h // r, r, w // r, r, c).permute(0, 1, 3, 5, 2, 4)
    return y.reshape(b, h // r, w // r, c * r * r)
