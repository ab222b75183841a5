"""Device-side resize / degradation transforms, the counterpart of
``srgan_tpu/ops/resize.py``.

``resize_bilinear`` reproduces ``jax.image.resize(..., "bilinear",
antialias=True)`` exactly: the same antialiased triangle
scale-and-translate weights, built as one small (in, out) matrix per
resized axis and applied along H and then W. (``F.interpolate(...,
antialias=True)`` is only within ~2e-3 of it.)

Random draws (noise severity, noise, flip masks) come from an explicit
``torch.Generator`` on the batch's device. The ``*_from`` functions take
those draws as tensors instead, so tests can feed both packages the same
numbers.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch


# Distinct (in, out) pairs kept. Training uses one size; an eval over a
# size-diverse set would otherwise keep every pair's matrix (on the card,
# for the device cache) for the life of the process.
WEIGHT_CACHE_SIZE = 64


@functools.lru_cache(maxsize=WEIGHT_CACHE_SIZE)
def _triangle_weights_np(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) float32 weights of jax's ``compute_weight_mat``
    for the antialiased triangle kernel (scale out/in, no translation)."""
    f32 = np.float32
    inv_scale = f32(in_size / out_size)
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None])
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x / kernel_scale))
    total = w.sum(axis=0, keepdims=True)
    w = np.where(
        np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
        w / np.where(total != 0, total, f32(1.0)),
        f32(0.0),
    )
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    w = np.where(inside[None, :], w, f32(0.0)).astype(f32)
    w.setflags(write=False)
    return w


@functools.lru_cache(maxsize=WEIGHT_CACHE_SIZE)
def _triangle_weights(in_size: int, out_size: int, device: torch.device):
    # cached per device: a per-step host→device copy would stall the queue
    return torch.from_numpy(_triangle_weights_np(in_size, out_size).copy()).to(device)


def resize_bilinear(img: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Antialiased bilinear resize of an HWC/NHWC float image to
    (height, width), as ``jax.image.resize`` computes it."""
    (h_in, w_in), (h_out, w_out) = img.shape[-3:-1], size
    out = img
    if h_in != h_out:
        wh = _triangle_weights(h_in, h_out, img.device)
        out = torch.einsum("...hwc,hk->...kwc", out, wh)
    if w_in != w_out:
        ww = _triangle_weights(w_in, w_out, img.device)
        out = torch.einsum("...hwc,wk->...hkc", out, ww)
    return out


def degrade_batch_from(
    hr: torch.Tensor, noise: torch.Tensor, std: torch.Tensor, factor: int
) -> torch.Tensor:
    """HR NHWC batch → LR: bilinear ÷``factor`` plus ``noise * std``
    (``noise`` of the LR shape, ``std`` of shape (B, 1, 1, 1))."""
    b, h, w, _ = hr.shape
    return resize_bilinear(hr, (h // factor, w // factor)) + noise * std


def degrade_batch(
    hr: torch.Tensor, generator: torch.Generator, *, factor: int = 4,
    noise_std_max: float = 0.03,
    salt_prob: float = 0.0, pepper_prob: float = 0.0, spot_size: int = 1,
) -> torch.Tensor:
    """HR NHWC batch → noisy LR batch: bilinear downscale by ``factor``,
    then gaussian noise whose std is drawn per image from
    U(0, noise_std_max) (reference ``src/transformers.py:73-77``)."""
    if salt_prob > 0.0 or pepper_prob > 0.0:
        raise NotImplementedError(
            "salt & pepper spots are not ported yet (ROADMAP.md, queue 1: "
            "batch prep, add_salt_pepper)"
        )
    b, h, w, c = hr.shape
    std = torch.rand(
        (b, 1, 1, 1), generator=generator, device=hr.device
    ) * noise_std_max
    noise = torch.randn(
        (b, h // factor, w // factor, c), generator=generator, device=hr.device
    )
    return degrade_batch_from(hr, noise, std, factor)


def apply_flips(
    imgs: torch.Tensor, flip_h: torch.Tensor, flip_v: torch.Tensor
) -> torch.Tensor:
    """Per-image horizontal (W) then vertical (H) flips under (B,) bool
    masks."""
    fh = flip_h.view(-1, 1, 1, 1)
    fv = flip_v.view(-1, 1, 1, 1)
    imgs = torch.where(fh, imgs.flip(2), imgs)
    return torch.where(fv, imgs.flip(1), imgs)


def random_flips(imgs: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Per-image random H/V flips (the 4 shape-preserving dihedral
    elements), applied to HR before degradation."""
    b = imgs.shape[0]
    u = torch.rand((2, b), generator=generator, device=imgs.device)
    return apply_flips(imgs, u[0] < 0.5, u[1] < 0.5)


def prepare_batch_from(
    hr_u8: torch.Tensor, noise: torch.Tensor, std: torch.Tensor, *,
    factor: int = 4,
    flip_h: Optional[torch.Tensor] = None,
    flip_v: Optional[torch.Tensor] = None,
):
    """:func:`prepare_batch` with its draws given as tensors."""
    if flip_h is not None:
        hr_u8 = apply_flips(hr_u8, flip_h, flip_v)
    hr = hr_u8.float() * (1.0 / 255.0)
    return hr, degrade_batch_from(hr, noise, std, factor)


def prepare_batch(
    hr_u8: torch.Tensor, generator: torch.Generator, *, factor: int = 4,
    noise_std_max: float = 0.03,
    salt_prob: float = 0.0, pepper_prob: float = 0.0, spot_size: int = 1,
    augment_flips: bool = False,
):
    """uint8 HR batch → (float32 HR, degraded float32 LR), on the batch's
    device. Batches travel as uint8; the /255 and the degradation run on
    the device."""
    if augment_flips:
        hr_u8 = random_flips(hr_u8, generator)
    hr = hr_u8.float() * (1.0 / 255.0)
    lr = degrade_batch(
        hr, generator, factor=factor, noise_std_max=noise_std_max,
        salt_prob=salt_prob, pepper_prob=pepper_prob, spot_size=spot_size,
    )
    return hr, lr


def gather_prepare_batch(
    dataset_u8: torch.Tensor, idx: torch.Tensor, generator: torch.Generator,
    **kwargs,
):
    """Device-resident-dataset path: gather a batch by index from the uint8
    dataset cached on the device, then convert and degrade — no
    host→device image bytes per step."""
    return prepare_batch(dataset_u8.index_select(0, idx), generator, **kwargs)
