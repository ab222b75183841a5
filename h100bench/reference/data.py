"""What a training step is fed, worked out from the benchmark's clips and
seed alone.

- Rows: the reference's 70/30 split made reproducible (a permutation of the
  train set by numpy's ``default_rng(split_seed)``, the first 70 % kept),
  reshuffled every epoch by ``default_rng((seed, epoch))``, dealt out in
  batches in that order (``DistributedSampler(shuffle=True)`` with
  ``set_epoch``, ``src/train.py:82-103``). Over P ranks each rank keeps
  the strided shard ``rows[r::P]``, cut to the shards' common length, and
  deals it out in batches; global batch k is the ranks' batches k in rank
  order.
- LR: the HR clip / 255, an antialiased bilinear downscale by the factor
  (``jax.image.resize``'s triangle kernel widened by the ratio and
  renormalised where it leaves the image), plus gaussian noise whose std is
  U(0, noise_std_max) an image (``src/transformers.py:73-77``). The draws
  come from a ``torch.Generator`` on the batch's device seeded for the
  epoch by ``SeedSequence((seed, epoch))``: per batch the (B, 1, 1, 1)
  uniforms, then the normals at the LR shape, B the global batch.
"""

from __future__ import annotations

import numpy as np
import torch


def mix(seed: int, k: int) -> int:
    return int(np.random.SeedSequence((seed, k)).generate_state(1)[0])


def train_rows(n_images: int, split_ratio: float, split_seed: int,
               seed: int, epoch: int) -> np.ndarray:
    kept = np.random.default_rng(split_seed).permutation(n_images)[: int(split_ratio * n_images)]
    return kept[np.random.default_rng((seed, epoch)).permutation(len(kept))]


def batch_rows(rows: np.ndarray, batch: int, k: int, world: int = 1) -> np.ndarray:
    """The rows of global batch ``k`` of an epoch over ``world`` ranks of
    ``batch`` rows each, in rank order."""
    if world == 1:
        return rows[k * batch:(k + 1) * batch]
    per = len(rows) // world
    return np.concatenate([rows[r::world][:per][k * batch:(k + 1) * batch]
                           for r in range(world)])


def downscale_matrix(n_in: int, n_out: int) -> torch.Tensor:
    """(n_in, n_out) weights of the antialiased triangle-kernel resize."""
    scale = n_in / n_out
    centre = (np.arange(n_out) + 0.5) * scale - 0.5
    dist = np.abs(np.arange(n_in)[:, None] - centre[None, :]) / max(scale, 1.0)
    w = np.maximum(0.0, 1.0 - dist)
    return torch.from_numpy(w / w.sum(axis=0, keepdims=True)).float()


def downscale(hr: torch.Tensor, factor: int) -> torch.Tensor:
    b, h, w, c = hr.shape
    wh = downscale_matrix(h, h // factor).to(hr.device)
    ww = downscale_matrix(w, w // factor).to(hr.device)
    return torch.einsum("bhwc,hk,wl->bklc", hr, wh, ww)


class Degrader:
    """The LR batches of one epoch, in order."""

    def __init__(self, device, seed: int, epoch: int, factor: int, noise_std_max: float):
        self.gen = torch.Generator(device=device).manual_seed(mix(seed, epoch))
        self.device, self.factor, self.noise = device, factor, noise_std_max

    def __call__(self, hr_u8: torch.Tensor):
        hr = hr_u8.to(self.device).float() / 255.0
        b, h, w, c = hr.shape
        std = torch.rand((b, 1, 1, 1), generator=self.gen, device=self.device) * self.noise
        z = torch.randn((b, h // self.factor, w // self.factor, c),
                        generator=self.gen, device=self.device)
        return hr, downscale(hr, self.factor) + z * std
