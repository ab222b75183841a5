"""Pixel-shuffle (depth-to-space) for NHWC batches.

Counterpart of ``srgan_tpu/ops/pixel_shuffle.py``. The NHWC channel order
(c, rh, rw) equals ``F.pixel_shuffle`` on NCHW, so both functions are that
operator wrapped in the NHWC↔NCHW permutes. The model itself runs NCHW and
calls ``F.pixel_shuffle`` directly.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pixel_shuffle(x: torch.Tensor, upscale_factor: int = 2) -> torch.Tensor:
    """(B, H, W, C*r*r) → (B, H*r, W*r, C), torch channel convention."""
    r = upscale_factor
    if x.shape[-1] % (r * r) != 0:
        raise ValueError(f"channels {x.shape[-1]} not divisible by r^2={r * r}")
    y = F.pixel_shuffle(x.permute(0, 3, 1, 2), r)
    return y.permute(0, 2, 3, 1)


def pixel_unshuffle(x: torch.Tensor, downscale_factor: int = 2) -> torch.Tensor:
    """Inverse of :func:`pixel_shuffle` (space-to-depth)."""
    r = downscale_factor
    h, w = x.shape[1], x.shape[2]
    if h % r or w % r:
        raise ValueError(f"spatial dims ({h},{w}) not divisible by r={r}")
    y = F.pixel_unshuffle(x.permute(0, 3, 1, 2), r)
    return y.permute(0, 2, 3, 1)
