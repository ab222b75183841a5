"""Fully-convolutional patch discriminator, the PyTorch counterpart of
``srgan_tpu/models/discriminator.py`` (reference ``src/models.py:90-120``).

Up to four stages of [strided conv → 3x3/s2 max-pool → InstanceNorm →
LeakyReLU(0.2)], the last stage without the LeakyReLU, then a sigmoid.
Stage convs: k8 s2 p2 (3→F), then k4 s2 p1 for F→2F→4F→8F. For a 512x1024
HR input the 4-stage patch output is (B, 8F, 1, 3) here, NCHW, and
(B, 1, 3, 8F) in the JAX package's NHWC.

The input is NHWC, like the generator's output; inside, the model runs
NCHW. Traps against flax: the InstanceNorm is flax's
``GroupNorm(num_groups=features)`` with no scale or bias and eps 1e-6, not
``nn.InstanceNorm2d`` (eps 1e-5). It is computed as flax computes it
(:class:`InstanceNorm`): torch's fused group norm is not exact where a
group holds one value (the last stage is 1x1 at the smallest input), which
flax maps to 0. The convs are the generator's ``Conv2d`` (bias added after
the conv, in the compute dtype). The sigmoid runs in the compute dtype and
the output is cast to f32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from srgan_tpu_torch.config import DiscriminatorConfig
from srgan_tpu_torch.models.srresnet import Conv2d, _dtype, _init_like_flax

# (channel multiplier, kernel, padding) of each stage; every conv is stride 2
_STAGES = ((1, 8, 2), (2, 4, 1), (4, 4, 1), (8, 4, 1))


class InstanceNorm(nn.Module):
    """flax ``nn.GroupNorm(num_groups=C, use_scale=False, use_bias=False,
    dtype=compute_dtype)`` on NCHW: each sample's and channel's mean and
    variance in f32 (E[x²] − E[x]², clamped at 0: flax's fast variance),
    ``(x − mean) · rsqrt(var + 1e-6)``, one rounding to the compute dtype."""

    def __init__(self, compute_dtype: torch.dtype = torch.float32, eps: float = 1e-6):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        mean = x.mean((2, 3), keepdim=True)
        var = (x.square().mean((2, 3), keepdim=True) - mean.square()).clamp_min(0.0)
        return ((x - mean) * torch.rsqrt(var + self.eps)).to(self.compute_dtype)


def min_input_size(num_stages: int = 4) -> int:
    """Smallest spatial input surviving ``num_stages`` of conv/s2 + pool/s2,
    by exact inversion of the shape arithmetic (conv out =
    floor((in + 2p - k)/2) + 1, pool k3 s2 VALID): 428 px at 4 stages."""
    size = 1
    for stage in range(num_stages - 1, -1, -1):
        size = 2 * (size - 1) + 3                      # invert pool k3 s2
        k_minus_2p = 4 if stage == 0 else 2            # k8 p2 / k4 p1
        size = 2 * (size - 1) + k_minus_2p             # invert conv s2
    return size


class Discriminator(nn.Module):
    def __init__(self, input_channels: int = 3, num_filters: int = 64,
                 num_stages: int = 4, compute_dtype: str = "float32"):
        super().__init__()
        if not 1 <= num_stages <= 4:
            raise ValueError(
                f"num_stages must be 1..4 (reference stack is 4, "
                f"src/models.py:90-120), got {num_stages}"
            )
        cd = self.compute_dtype = _dtype(compute_dtype)
        self.num_stages = num_stages
        self.convs = nn.ModuleList()
        self.norms = nn.ModuleList()
        c_in = input_channels
        for mult, k, p in _STAGES[:num_stages]:
            c_out = num_filters * mult
            self.convs.append(Conv2d(c_in, c_out, k, stride=2, padding=p,
                                     compute_dtype=cd))
            self.norms.append(InstanceNorm(cd))
            c_in = c_out

    @classmethod
    def from_config(cls, cfg: DiscriminatorConfig) -> "Discriminator":
        return cls(
            input_channels=cfg.in_channels,
            num_filters=cfg.num_filters,
            num_stages=cfg.num_stages,
            compute_dtype=cfg.compute_dtype,
        )

    def check_input_size(self, h: int, w: int) -> None:
        floor = min_input_size(self.num_stages)
        if h < floor or w < floor:
            raise ValueError(
                f"Discriminator input {h}x{w} too small: the "
                f"{self.num_stages}-stage conv/pool stack needs >= {floor}px "
                "per side (the reference crashes mid-stack below this)."
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC in [0, 1] → the NCHW patch map, f32."""
        self.check_input_size(x.shape[1], x.shape[2])
        x = x.permute(0, 3, 1, 2)  # the first conv casts it
        last = self.num_stages - 1
        for i, (conv, norm) in enumerate(zip(self.convs, self.norms)):
            # torch MaxPool2d(3, stride=2): VALID padding, floor sizes
            x = norm(F.max_pool2d(conv(x), 3, 2))
            if i < last:
                x = F.leaky_relu(x, 0.2)
        return torch.sigmoid(x).float()


def init_discriminator(
    cfg: DiscriminatorConfig,
    seed: int = 0,
    device: Optional[torch.device] = None,
    sample_hw=None,
) -> Discriminator:
    """A discriminator with random weights made from ``seed`` (flax's
    initialisers, drawn on the CPU), moved to ``device``. ``sample_hw``:
    the input size it will see, checked against ``min_input_size`` now, as
    the JAX package's init does with its sample input."""
    model = Discriminator.from_config(cfg)
    if sample_hw is not None:
        model.check_input_size(*sample_hw)
    _init_like_flax(model, torch.Generator().manual_seed(seed))
    return model.to(device) if device is not None else model
