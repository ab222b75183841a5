"""SRResNet super-resolution generator, the PyTorch counterpart of
``srgan_tpu/models/srresnet.py``.

conv9x9 stem + LeakyReLU(0.2) → N residual blocks (conv3x3 → GroupNorm →
ReLU → conv3x3 → GroupNorm → +skip) → conv3x3 + global skip → the head:

  - ``subpixel`` (default): log2(r)−1 stages of [conv3x3 (F→4F) →
    pixel-shuffle(2) → ReLU], then conv3x3 (F→4F) → ReLU → phase conv5x5
    (4F→4C) → pixel-shuffle(2);
  - ``coarse``: the phase conv folded one level further down (unshuffle →
    conv3x3 (16F→16C) → two shuffles) when r ≥ 4, else as ``subpixel``;
  - ``reference``: log2(r) stages of [conv3x3 → pixel-shuffle → ReLU] and a
    conv9x9 to RGB at full resolution.

The public layout is NHWC in and out, like the JAX module; inside, the
model runs NCHW. Traps against flax: ``nn.GroupNorm`` here is built with
eps 1e-6 (flax's default; torch's is 1e-5), and flax computes the variance
as E[x²]−E[x]² where torch takes E[(x−μ)²] — equal up to rounding. Every
conv carries a bias, as flax's ``nn.Conv`` does.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from srgan_tpu_torch.config import ModelConfig

HEADS = ("subpixel", "coarse", "reference")


def _norm(norm: str, groups: int, features: int) -> nn.Module:
    if norm == "group":
        return nn.GroupNorm(groups, features, eps=1e-6)
    if norm != "none":
        raise ValueError(f"norm must be 'group' or 'none', got {norm!r}")
    return nn.Identity()


class ResidualBlock(nn.Module):
    """conv3x3 → norm → ReLU → conv3x3 → norm, plus identity skip."""

    def __init__(self, num_features: int, norm: str = "group",
                 group_norm_groups: int = 8):
        super().__init__()
        f = num_features
        self.conv1 = nn.Conv2d(f, f, 3, padding=1)
        self.norm1 = _norm(norm, group_norm_groups, f)
        self.conv2 = nn.Conv2d(f, f, 3, padding=1)
        self.norm2 = _norm(norm, group_norm_groups, f)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.norm1(self.conv1(x)))
        return self.norm2(self.conv2(out)) + x


class SRResNet(nn.Module):
    """The flagship generator. Input/output: NHWC float in [0, 1] (the
    output is unclamped, like the reference's)."""

    def __init__(
        self,
        in_channels: int = 3,
        num_features: int = 64,
        num_residuals: int = 16,
        upscale_factor: int = 4,
        norm: str = "group",
        group_norm_groups: int = 8,
        head: str = "subpixel",
        remat: bool = False,
        compute_dtype: str = "float32",
    ):
        super().__init__()
        f = upscale_factor
        if f < 2 or (f & (f - 1)) != 0:
            raise ValueError(
                f"upscale_factor must be a power of two >= 2 (2/4/8...), "
                f"got {f}"
            )
        if head not in HEADS:
            raise ValueError(
                "head must be 'subpixel', 'coarse' or 'reference', "
                f"got {head!r}"
            )
        if compute_dtype != "float32":
            raise NotImplementedError(
                f"compute_dtype={compute_dtype!r}: the port runs float32 "
                "only so far (ROADMAP.md, queue 1: bf16 compute)"
            )
        nf, c = num_features, in_channels
        self.head = head
        self.remat = remat
        self.num_stages = int(math.log2(f))
        self.stem = nn.Conv2d(c, nf, 9, padding=4)
        self.blocks = nn.ModuleList(
            ResidualBlock(nf, norm, group_norm_groups)
            for _ in range(num_residuals)
        )
        self.mid = nn.Conv2d(nf, nf, 3, padding=1)
        self.upsample = nn.ModuleList(
            nn.Conv2d(nf, nf * 4, 3, padding=1) for _ in range(self.num_stages)
        )
        if head == "reference":
            self.tail = nn.Conv2d(nf, c, 9, padding=4)
        elif self._coarse:
            self.tail = nn.Conv2d(nf * 16, c * 16, 3, padding=1)
        else:
            self.tail = nn.Conv2d(nf * 4, c * 4, 5, padding=2)

    @property
    def _coarse(self) -> bool:
        return self.head == "coarse" and self.num_stages >= 2

    @classmethod
    def from_config(cls, cfg: ModelConfig) -> "SRResNet":
        return cls(
            in_channels=cfg.in_channels,
            num_features=cfg.num_features,
            num_residuals=cfg.num_residuals,
            upscale_factor=cfg.upscale_factor,
            norm=cfg.norm,
            group_norm_groups=cfg.group_norm_groups,
            head=cfg.head,
            remat=cfg.remat,
            compute_dtype=cfg.compute_dtype,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        out1 = F.leaky_relu(self.stem(x), 0.2)
        out = out1
        for block in self.blocks:
            if self.remat and torch.is_grad_enabled():
                out = checkpoint(block, out, use_reentrant=False)
            else:
                out = block(out)
        out = self.mid(out) + out1  # global skip

        if self.head == "reference":
            for conv in self.upsample:
                out = F.relu(F.pixel_shuffle(conv(out), 2))
            out = self.tail(out)
        else:
            # fold the RGB head through the last shuffle: conv → ReLU
            # (commuted through the shuffle) → phase conv → shuffle(s)
            for conv in self.upsample[:-1]:
                out = F.relu(F.pixel_shuffle(conv(out), 2))
            out = F.relu(self.upsample[-1](out))
            if self._coarse:
                out = self.tail(F.pixel_unshuffle(out, 2))
                out = F.pixel_shuffle(F.pixel_shuffle(out, 2), 2)
            else:
                out = F.pixel_shuffle(self.tail(out), 2)
        return out.permute(0, 2, 3, 1).contiguous()


@torch.no_grad()
def _init_like_flax(model: nn.Module, generator: torch.Generator) -> None:
    """flax's initialisers: conv kernels lecun_normal (a normal truncated at
    ±2σ, rescaled to variance 1/fan_in), conv biases zero, GroupNorm scale
    one and bias zero. Drawn in module order from ``generator``."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(
                m.weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator
            )
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.GroupNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)


def init_generator(
    cfg: ModelConfig,
    seed: int = 0,
    device: Optional[torch.device] = None,
) -> SRResNet:
    """A generator with random weights made from ``seed`` (drawn on the CPU,
    so a seed gives the same weights on every device), moved to
    ``device``."""
    model = SRResNet.from_config(cfg)
    _init_like_flax(model, torch.Generator().manual_seed(seed))
    return model.to(device) if device is not None else model
