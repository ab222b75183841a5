"""Inputs made from the run's seed, on the device, in a few large calls:
clips for training and serving, and every network's weights. The program
and the reference are handed the same tensors.

Clips are smooth random images (bicubic upsampling of coarse uniform noise,
as the repo's smoke test makes them) with the detail and contrast that
photos differ in: image i's noise cells are ``CELLS[i % 4]`` pixels wide,
its contrast U(0.2, 1) about its brightness. Every seed gives the same mix of
cell sizes; only the pixels change. Each image also has a mean
brightness U(0.15, 0.85), as photos do; so the per-image losses differ, and a
step that drops part of its batch shows in the batch's loss.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

CELLS = (8, 16, 32, 64)  # noise cell widths at the HR (training) scale


def seed_for(seed: int, *purpose: int) -> int:
    return int(np.random.SeedSequence((seed, *purpose)).generate_state(1)[0])


@torch.no_grad()
def clips_u8(n: int, hw: Tuple[int, int], seed: int, device, cells=CELLS,
             chunk: int = 32) -> torch.Tensor:
    """(n, H, W, 3) uint8 clips on ``device``."""
    h, w = hw
    g = torch.Generator(device=device).manual_seed(seed)
    out = torch.empty((n, h, w, 3), dtype=torch.uint8, device=device)
    contrast = torch.rand(n, generator=g, device=device) * 0.8 + 0.2
    bright = torch.rand(n, generator=g, device=device) * 0.7 + 0.15
    for k, cell in enumerate(cells[:n]):
        idx = torch.arange(k, n, len(cells), device=device)
        ch, cw = max(2, math.ceil(h / cell)), max(2, math.ceil(w / cell))
        for s in range(0, len(idx), chunk):
            part = idx[s:s + chunk]
            coarse = torch.rand((len(part), 3, ch, cw), generator=g, device=device)
            img = F.interpolate(coarse, size=(h, w), mode="bicubic", align_corners=False)
            img = (img - 0.5) * contrast[part].view(-1, 1, 1, 1) + bright[part].view(-1, 1, 1, 1)
            out[part] = (img.clamp(0, 1) * 255).round().to(torch.uint8).permute(0, 2, 3, 1)
    return out


def _scale(name: str, shape: tuple) -> Tuple[float, float]:
    """(offset, scale) of a parameter's normal draw: conv kernels
    N(0, 1/fan_in), conv biases N(0, 0.01²), norm scales N(1, 0.05²), norm
    biases N(0, 0.05²)."""
    if len(shape) == 4:
        return 0.0, 1.0 / math.sqrt(math.prod(shape[1:]))
    if ".norm" in name:
        return (1.0, 0.05) if name.endswith("weight") else (0.0, 0.05)
    return 0.0, 0.01


@torch.no_grad()
def weights(shapes: List[Tuple[str, tuple]], seed: int, device,
            scale: Callable[[str, tuple], Tuple[float, float]] = _scale) -> Dict[str, torch.Tensor]:
    """Float32 weights for ``shapes``: one normal draw on the device, cut
    into the parameters, each drawn as N(offset, scale²) by ``scale(name,
    shape)`` (an architecture's ``param_scale``)."""
    g = torch.Generator(device=device).manual_seed(seed)
    total = sum(math.prod(s) for _, s in shapes)
    flat = torch.randn(total, generator=g, device=device)
    out, at = {}, 0
    for name, shape in shapes:
        size = math.prod(shape)
        off, sc = scale(name, shape)
        out[name] = (flat[at:at + size] * sc + off).view(shape)
        at += size
    return out
