"""Device-side resize / degradation transforms, the counterpart of
``srgan_tpu/ops/resize.py``.

``resize_bilinear`` and ``resize_bicubic`` reproduce ``jax.image.resize``
with ``antialias=True`` (``"bilinear"``; ``"cubic"``, Keys a = -0.5): the
same scale-and-translate weights, the kernel widened by the downscale
ratio, built as one small (in, out) matrix per resized axis and applied
along H and then W. (``F.interpolate(..., antialias=True)`` is only within
~2e-3 of it.)

Random draws (noise severity, noise, flip masks, salt and pepper) come
from an explicit ``torch.Generator`` on the batch's device. The ``*_from``
functions and ``add_salt_pepper_from`` take those draws as tensors instead,
so tests can feed both packages the same numbers.

Training across processes: each rank holds ``b`` rows of a global batch
of ``b·P``. ``shard=(index, P)`` draws every random number at the GLOBAL
batch's shape from the generator that every rank seeds alike, and keeps
this rank's rows ``[index·b, (index+1)·b)``, as JAX draws over the global
array: a P-process run sees the same noise, flips and spots as one
process training on the ranks' rows concatenated in rank order.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


# Distinct (in, out) pairs kept. Training uses one size; an eval over a
# size-diverse set would otherwise keep every pair's matrix (on the card,
# for the device cache) for the life of the process.
WEIGHT_CACHE_SIZE = 64


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel, a = -0.5, as jax writes it."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, np.float32(0.0), out).astype(np.float32)


_KERNELS = {"linear": _triangle, "cubic": _keys_cubic}


@functools.lru_cache(maxsize=WEIGHT_CACHE_SIZE)
def _weights_np(in_size: int, out_size: int, method: str = "linear") -> np.ndarray:
    """(in_size, out_size) float32 weights of jax's ``compute_weight_mat``
    for the antialiased ``method`` kernel (scale out/in, no translation)."""
    f32 = np.float32
    inv_scale = f32(in_size / out_size)
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None])
    w = _KERNELS[method](x / kernel_scale)
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
def _weights(in_size: int, out_size: int, device: torch.device, method: str = "linear"):
    # cached per device: a per-step host→device copy would stall the queue
    return torch.from_numpy(_weights_np(in_size, out_size, method).copy()).to(device)


def _resize(img: torch.Tensor, size: Tuple[int, int], method: str) -> torch.Tensor:
    (h_in, w_in), (h_out, w_out) = img.shape[-3:-1], size
    out = img
    if h_in != h_out:
        wh = _weights(h_in, h_out, img.device, method)
        out = torch.einsum("...hwc,hk->...kwc", out, wh)
    if w_in != w_out:
        ww = _weights(w_in, w_out, img.device, method)
        out = torch.einsum("...hwc,wk->...hkc", out, ww)
    return out


def resize_bilinear(img: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Antialiased bilinear resize of an HWC/NHWC float image to
    (height, width), as ``jax.image.resize`` computes it (torchvision
    ``Resize``'s default, ``src/transformers.py:74``)."""
    return _resize(img, size, "linear")


def resize_bicubic(img: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bicubic resize of an HWC/NHWC float image to (height, width),
    antialiased when it downsizes, as ``jax.image.resize(..., "cubic",
    antialias=True)`` computes it: the analogue of ``transforms.Resize(...,
    BICUBIC)`` (``src/transformers.py:80``)."""
    return _resize(img, size, "cubic")


def _own_rows(x: torch.Tensor, shard: Tuple[int, int]) -> torch.Tensor:
    """Rows ``[index·b, (index+1)·b)`` of a draw made at the global batch's
    shape (b·P rows)."""
    index, count = shard
    if count == 1:
        return x
    b = x.shape[0] // count
    return x[index * b:(index + 1) * b]


def add_gaussian_noise_from(img: torch.Tensor, noise: torch.Tensor,
                            std: float = 0.01, mean: float = 0.0) -> torch.Tensor:
    """:func:`add_gaussian_noise` with its standard-normal draw given."""
    return (img + (noise * std + mean)).clamp(0.0, 1.0)


def add_gaussian_noise(img: torch.Tensor, generator: torch.Generator,
                       std: float = 0.01, mean: float = 0.0) -> torch.Tensor:
    """``AddGaussianNoise`` (``src/transformers.py:9-36``): additive
    N(mean, std) noise, clipped back to [0, 1]."""
    noise = torch.randn(img.shape, generator=generator, device=img.device,
                        dtype=img.dtype)
    return add_gaussian_noise_from(img, noise, std, mean)


def grow_spots(seeds: torch.Tensor, spot_size: int) -> torch.Tensor:
    """Dilate a boolean (..., H, W) seed mask so each seed at (y, x) covers
    the square [y, y+spot_size) x [x, x+spot_size), the footprint of the
    reference's ``img[:, y:y+s, x:x+s] = v`` spot writes
    (``src/transformers.py:60,68``): a max-pool window of ``spot_size``
    over the mask padded by ``spot_size - 1`` above and to the left."""
    if spot_size <= 1:
        return seeds
    s = spot_size
    lead = seeds.shape[:-2]
    x = seeds.reshape(-1, 1, *seeds.shape[-2:]).float()
    x = F.max_pool2d(F.pad(x, (s - 1, 0, s - 1, 0)), s, stride=1)
    return (x > 0.0).reshape(*lead, *seeds.shape[-2:])


def draw_salt_pepper(b: int, h: int, w: int, generator: torch.Generator,
                     device, salt_prob: float, pepper_prob: float) -> dict:
    """The random numbers of :func:`add_salt_pepper_from` for ``b`` images
    of (h, w): each image's salt and pepper densities, U(0, p), and a
    U(0, 1) field each, whose values under the density seed spots."""
    def u(*shape):
        return torch.rand(shape, generator=generator, device=device)

    return {"salt_density": u(b) * salt_prob, "pepper_density": u(b) * pepper_prob,
            "salt_u": u(b, h, w), "pepper_u": u(b, h, w)}


def add_salt_pepper_from(img: torch.Tensor, draws: dict, spot_size: int = 1) -> torch.Tensor:
    """Salt-and-pepper spots on an NHWC batch (or one HWC image, with
    scalar densities and (H, W) fields) from :func:`draw_salt_pepper`'s
    numbers. The reference (``AddSaltPepperSpots``, ``src/transformers.py:
    39-70``) draws ``num_pixels · U(0, p)`` square spots; here every valid
    top-left position (``y ≤ h - s``, ``x ≤ w - s``) seeds independently
    with the density that gives the same expected count, ``(h·w) / ((h-s+1)
    (w-s+1))`` times U(0, p), and seeds grow to ``s``-squares
    (:func:`grow_spots`). Salt (1.0) first, then pepper (0.0), which wins
    where they overlap."""
    h, w = img.shape[-3:-1]
    s = spot_size
    scale = (h * w) / float((h - s + 1) * (w - s + 1))
    valid = torch.zeros((h, w), dtype=torch.bool, device=img.device)
    valid[: h - s + 1, : w - s + 1] = True

    def spot_mask(u, density):
        density = (density * scale).reshape(*density.shape, 1, 1)
        return grow_spots((u < density) & valid, s)[..., None]

    img = torch.where(spot_mask(draws["salt_u"], draws["salt_density"]), 1.0, img)
    return torch.where(spot_mask(draws["pepper_u"], draws["pepper_density"]), 0.0, img)




def degrade_batch_from(
    hr: torch.Tensor, noise: torch.Tensor, std: torch.Tensor, factor: int,
    spots: Optional[dict] = None, spot_size: int = 1,
) -> torch.Tensor:
    """HR NHWC batch → LR: bilinear ÷``factor`` plus ``noise * std``
    (``noise`` of the LR shape, ``std`` of shape (B, 1, 1, 1)), then the
    salt-and-pepper ``spots`` (:func:`draw_salt_pepper`'s numbers) where
    given."""
    b, h, w, _ = hr.shape
    lr = resize_bilinear(hr, (h // factor, w // factor)) + noise * std
    if spots is not None:
        lr = add_salt_pepper_from(lr, spots, spot_size)
    return lr


def degrade_batch(
    hr: torch.Tensor, generator: torch.Generator, *, factor: int = 4,
    noise_std_max: float = 0.03,
    salt_prob: float = 0.0, pepper_prob: float = 0.0, spot_size: int = 1,
    shard: Tuple[int, int] = (0, 1),
) -> torch.Tensor:
    """HR NHWC batch → noisy LR batch: bilinear downscale by ``factor``,
    then gaussian noise whose std is drawn per image from
    U(0, noise_std_max) (reference ``src/transformers.py:73-77``), then,
    where a probability is set, per-image salt-and-pepper spots
    (``src/transformers.py:39-70``, off by default like the reference's
    unused transform). ``shard``: draw for the global batch, keep this
    rank's rows (module docstring)."""
    b, h, w, c = hr.shape
    gb, lh, lw, dev = b * shard[1], h // factor, w // factor, hr.device
    std = _own_rows(
        torch.rand((gb, 1, 1, 1), generator=generator, device=dev), shard
    ) * noise_std_max
    noise = _own_rows(
        torch.randn((gb, lh, lw, c), generator=generator, device=dev), shard
    )
    spots = None
    if salt_prob > 0.0 or pepper_prob > 0.0:
        spots = {k: _own_rows(v, shard) for k, v in draw_salt_pepper(
            gb, lh, lw, generator, dev, salt_prob, pepper_prob).items()}
    return degrade_batch_from(hr, noise, std, factor, spots, spot_size)


def apply_flips(
    imgs: torch.Tensor, flip_h: torch.Tensor, flip_v: torch.Tensor
) -> torch.Tensor:
    """Per-image horizontal (W) then vertical (H) flips under (B,) bool
    masks."""
    fh = flip_h.view(-1, 1, 1, 1)
    fv = flip_v.view(-1, 1, 1, 1)
    imgs = torch.where(fh, imgs.flip(2), imgs)
    return torch.where(fv, imgs.flip(1), imgs)


def random_flips(imgs: torch.Tensor, generator: torch.Generator,
                 shard: Tuple[int, int] = (0, 1)) -> torch.Tensor:
    """Per-image random H/V flips (the 4 shape-preserving dihedral
    elements), applied to HR before degradation; ``shard`` as in
    :func:`degrade_batch`."""
    b = imgs.shape[0]
    u = torch.rand((2, b * shard[1]), generator=generator, device=imgs.device)
    u = _own_rows(u.T, shard).T
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
    augment_flips: bool = False, shard: Tuple[int, int] = (0, 1),
):
    """uint8 HR batch → (float32 HR, degraded float32 LR), on the batch's
    device. Batches travel as uint8; the /255 and the degradation run on
    the device. ``shard`` as in :func:`degrade_batch`."""
    if augment_flips:
        hr_u8 = random_flips(hr_u8, generator, shard)
    hr = hr_u8.float() * (1.0 / 255.0)
    lr = degrade_batch(
        hr, generator, factor=factor, noise_std_max=noise_std_max,
        salt_prob=salt_prob, pepper_prob=pepper_prob, spot_size=spot_size,
        shard=shard,
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
