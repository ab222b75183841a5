"""A test-only architecture, planted through ``arch.load`` by pointing
``arch.DIR`` here: a per-pixel linear layer (C → C·r²), a LayerNorm over
its channels, a pixel shuffle by r, and 0.5 + 0.25·y. Its work is one
item of op ``"matmul"``. Every call of the seam's functions is recorded in
``CALLS``. ``model.planted_out_scale`` in place of 0.25 makes the
reference differ from the port."""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

CALLS: list = []
EPS = 1e-5


def _width(m) -> tuple:
    c, r = m["in_channels"], m["upscale_factor"]
    return c, c * r * r


def param_shapes(m):
    CALLS.append("param_shapes")
    c, n = _width(m)
    return [("proj.weight", (n, c)), ("proj.bias", (n,)), ("norm.weight", (n,)),
            ("norm.bias", (n,))]


def param_scale(name, shape):
    CALLS.append("param_scale")
    if name == "proj.weight":
        return 0.0, 1.0 / math.sqrt(shape[1])
    if name.startswith("norm."):
        return (1.0, 0.05) if name.endswith("weight") else (0.0, 0.05)
    return 0.0, 0.01


def forward(p, x, m, quant=None):
    CALLS.append("forward")
    q = quant or (lambda t: t)
    y = q(F.linear(q(x), q(p["proj.weight"]), p["proj.bias"]))
    y = F.layer_norm(y, y.shape[-1:], p["norm.weight"], p["norm.bias"], EPS)
    y = F.pixel_shuffle(y.permute(0, 3, 1, 2), m["upscale_factor"]).permute(0, 2, 3, 1)
    return 0.5 + m.get("planted_out_scale", 0.25) * y


@dataclass(frozen=True)
class Matmul:
    rows: int
    k: int
    n: int

    op = "matmul"

    def flops(self, batch):
        return 2.0 * batch * self.rows * self.k * self.n

    def bytes(self, batch, width):
        return width * (batch * self.rows * (self.k + self.n) + self.k * self.n)


def train_ops(m, lr_hw):
    CALLS.append("train_ops")
    c, n = _width(m)
    return [Matmul(lr_hw[0] * lr_hw[1], c, n)] * 2  # forward and weight gradient


def forward_ops(m, lr_hw):
    CALLS.append("forward_ops")
    c, n = _width(m)
    return [Matmul(lr_hw[0] * lr_hw[1], c, n)]


class Planted(nn.Module):
    def __init__(self, c: int, r: int):
        super().__init__()
        self.r = r
        self.proj = nn.Linear(c, c * r * r)
        self.norm = nn.LayerNorm(c * r * r, eps=EPS)

    def forward(self, x):
        y = self.norm(self.proj(x.float()))
        y = F.pixel_shuffle(y.permute(0, 3, 1, 2), self.r).permute(0, 2, 3, 1)
        return 0.5 + 0.25 * y


def port_model(model_cfg):
    CALLS.append("port_model")
    return Planted(model_cfg.in_channels, model_cfg.upscale_factor)
