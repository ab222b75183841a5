"""Plain fp32 forward passes of the benchmark's networks, written from the
published descriptions and the configuration files alone.

SRResNet (Ledig et al., arXiv:1609.04802 §2.2): conv9x9 stem + LeakyReLU
0.2, B residual blocks (conv3x3, GroupNorm, ReLU, conv3x3, GroupNorm, +
skip), conv3x3 + global skip, then the ``subpixel`` head: log2(r) − 1
stages of [conv3x3 (F → 4F), pixel shuffle 2, ReLU], conv3x3 (F → 4F),
ReLU, conv5x5 (4F → 4C), pixel shuffle 2. GroupNorm takes the place of the
paper's BatchNorm, with the configuration's groups and eps.

Patch discriminator (the reference repo's ``src/models.py:90-120``): stages
of [strided conv, 3x3/2 max pool, instance norm without affine, LeakyReLU
0.2 (not after the last)], then a sigmoid.

Images are NHWC floats in [0, 1]; weights are OIHW, keyed by name. Every
conv goes through ``conv``, so that a control can round its operands, its
output and their gradients to a lower precision (``quant``), as well as
the discriminator's output.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]

# (channel multiplier, kernel, padding) of each discriminator stage; stride 2
D_STAGES = ((1, 8, 2), (2, 4, 1), (4, 4, 1), (8, 4, 1))


def generator_param_shapes(m: dict) -> List[Tuple[str, tuple]]:
    """(name, shape) of every SRResNet parameter, in a fixed order."""
    c, f, k = m["in_channels"], m["num_features"], []

    def conv(name, cin, cout, ks):
        k.append((f"{name}.weight", (cout, cin, ks, ks)))
        k.append((f"{name}.bias", (cout,)))

    conv("stem", c, f, 9)
    for i in range(m["num_residuals"]):
        for j in (1, 2):
            conv(f"blocks.{i}.conv{j}", f, f, 3)
            k.append((f"blocks.{i}.norm{j}.weight", (f,)))
            k.append((f"blocks.{i}.norm{j}.bias", (f,)))
    conv("mid", f, f, 3)
    for j in range(int(math.log2(m["upscale_factor"]))):
        conv(f"upsample.{j}", f, 4 * f, 3)
    conv("tail", 4 * f, 4 * c, 5)
    return k


def discriminator_param_shapes(d: dict) -> List[Tuple[str, tuple]]:
    out, cin = [], d["in_channels"]
    for i, (mult, ks, _) in enumerate(D_STAGES[: d["num_stages"]]):
        cout = d["num_filters"] * mult
        out.append((f"convs.{i}.weight", (cout, cin, ks, ks)))
        out.append((f"convs.{i}.bias", (cout,)))
        cin = cout
    return out


def conv(x, w, b, stride=1, padding=0, quant: Quant = None):
    if quant is None:
        return F.conv2d(x, w, b, stride=stride, padding=padding)
    return quant(F.conv2d(quant(x), quant(w), None, stride=stride, padding=padding)
                 + b.view(1, -1, 1, 1))


def srresnet(p: Dict[str, torch.Tensor], x: torch.Tensor, m: dict,
             quant: Quant = None) -> torch.Tensor:
    """NHWC LR in → NHWC SR out, unclamped, fp32."""
    g, eps = m["group_norm_groups"], m["group_norm_eps"]

    def cv(name, h, pad):
        return conv(h, p[f"{name}.weight"], p[f"{name}.bias"], 1, pad, quant)

    h = x.permute(0, 3, 1, 2)
    out1 = F.leaky_relu(cv("stem", h, 4), 0.2)
    out = out1
    for i in range(m["num_residuals"]):
        r = cv(f"blocks.{i}.conv1", out, 1)
        r = F.group_norm(r, g, p[f"blocks.{i}.norm1.weight"], p[f"blocks.{i}.norm1.bias"], eps)
        r = cv(f"blocks.{i}.conv2", F.relu(r), 1)
        r = F.group_norm(r, g, p[f"blocks.{i}.norm2.weight"], p[f"blocks.{i}.norm2.bias"], eps)
        out = out + r
    out = cv("mid", out, 1) + out1
    stages = int(math.log2(m["upscale_factor"]))
    for j in range(stages - 1):
        out = F.relu(F.pixel_shuffle(cv(f"upsample.{j}", out, 1), 2))
    out = F.relu(cv(f"upsample.{stages - 1}", out, 1))
    out = F.pixel_shuffle(cv("tail", out, 2), 2)
    return out.permute(0, 2, 3, 1)


def discriminator(p: Dict[str, torch.Tensor], x: torch.Tensor, d: dict,
                  quant: Quant = None) -> torch.Tensor:
    """NHWC image in → NCHW patch probabilities, fp32."""
    h = x.permute(0, 3, 1, 2)
    n = d["num_stages"]
    for i, (_, _, pad) in enumerate(D_STAGES[:n]):
        h = conv(h, p[f"convs.{i}.weight"], p[f"convs.{i}.bias"], 2, pad, quant)
        h = F.max_pool2d(h, 3, 2)
        h = F.instance_norm(h, eps=d["instance_norm_eps"])
        if i < n - 1:
            h = F.leaky_relu(h, 0.2)
    out = torch.sigmoid(h)
    return out if quant is None else quant(out)
