"""PSNR and SSIM on NHWC batches, the counterpart of
``srgan_tpu/ops/metrics.py``.

  - PSNR: ``10*log10(R^2 / mse)``, MSE over all pixels and channels
    (``skimage.metrics.peak_signal_noise_ratio``, data_range 1).
  - SSIM: skimage's ``structural_similarity`` with win_size=3 and the
    correct channel axis: per channel a 3x3 uniform filter (valid, i.e.
    skimage's interior crop), sample covariance (N/(N-1)), K1=0.01,
    K2=0.03, mean of the map, averaged over channels.
  - ``psnr_masked`` / ``ssim_masked``: the same over the top-left valid
    region of padded images (the size-bucketed eval path).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def psnr(img1: torch.Tensor, img2: torch.Tensor, data_range: float = 1.0):
    """PSNR of a single image pair (any matching shapes), in dB."""
    mse = ((img1.float() - img2.float()) ** 2).mean()
    return 10.0 * torch.log10((data_range**2) / mse)


def _ssim_map(x: torch.Tensor, y: torch.Tensor, data_range: float):
    """(B, C, H-2, W-2) SSIM maps of NCHW batches, win_size=3."""
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    cov_norm = 9.0 / 8.0  # sample covariance, skimage's default

    def mean3(t):
        return F.avg_pool2d(t, 3, stride=1)

    ux, uy = mean3(x), mean3(y)
    vx = cov_norm * (mean3(x * x) - ux * ux)
    vy = cov_norm * (mean3(y * y) - uy * uy)
    vxy = cov_norm * (mean3(x * y) - ux * uy)
    a1 = 2.0 * ux * uy + c1
    a2 = 2.0 * vxy + c2
    b1 = ux * ux + uy * uy + c1
    b2 = vx + vy + c2
    return (a1 * a2) / (b1 * b2)


def ssim(img1: torch.Tensor, img2: torch.Tensor, data_range: float = 1.0):
    """SSIM of a single HWC image pair (win_size=3, channel-averaged)."""
    return batched_psnr_ssim(img1[None], img2[None], data_range)[1][0]


def _valid_mask(n: int, valid, device) -> torch.Tensor:
    return torch.arange(n, device=device) < torch.as_tensor(valid, device=device)


def psnr_masked(img1: torch.Tensor, img2: torch.Tensor, valid_h, valid_w,
                data_range: float = 1.0):
    """PSNR over the top-left ``valid_h x valid_w`` region of padded HWC
    images (``valid_*``: Python ints or 0-dim tensors). With the full region
    valid this equals :func:`psnr`."""
    a, b = img1.float(), img2.float()
    h, w, c = a.shape
    mask = (_valid_mask(h, valid_h, a.device)[:, None]
            & _valid_mask(w, valid_w, a.device)[None, :])[..., None]
    sq = torch.where(mask, (a - b) ** 2, 0.0)
    mse = sq.sum() / (mask.sum() * c)
    return 10.0 * torch.log10((data_range**2) / mse)


def ssim_masked(img1: torch.Tensor, img2: torch.Tensor, valid_h, valid_w,
                data_range: float = 1.0):
    """SSIM (win_size=3, skimage semantics) over only the 3x3 windows that
    lie fully inside the valid region of padded HWC images. With the full
    region valid this equals :func:`ssim` (every valid-conv window is
    kept, skimage's interior crop)."""
    a = img1.float().permute(2, 0, 1)[None]
    b = img2.float().permute(2, 0, 1)[None]
    _, _, h, w = a.shape
    # map index (i, j) covers pixels [i, i+2] x [j, j+2]
    map_mask = (_valid_mask(h - 2, torch.as_tensor(valid_h) - 2, a.device)[:, None]
                & _valid_mask(w - 2, torch.as_tensor(valid_w) - 2, a.device)[None, :])
    smap = _ssim_map(a, b, data_range)[0]  # (C, H-2, W-2)
    per_channel = torch.where(map_mask, smap, 0.0).sum((1, 2)) / map_mask.sum()
    return per_channel.mean()


def batched_psnr_ssim(batch1: torch.Tensor, batch2: torch.Tensor,
                      data_range: float = 1.0):
    """Per-image PSNR and SSIM over an NHWC batch: two (B,) tensors."""
    a = batch1.float()
    b = batch2.float()
    mse = ((a - b) ** 2).flatten(1).mean(1)
    p = 10.0 * torch.log10((data_range**2) / mse)
    smap = _ssim_map(a.permute(0, 3, 1, 2), b.permute(0, 3, 1, 2), data_range)
    # mean over each channel's map, then over channels: equal-size maps,
    # so one mean over (C, H-2, W-2)
    return p, smap.flatten(1).mean(1)
