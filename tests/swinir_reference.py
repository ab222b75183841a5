"""A plain fp32 SwinIR forward on a param dict, for the CPU tests of the
port's ``models/swinir.py``: written from the paper (Liang et al., ICCVW
2021, arXiv:2108.10257) and the official ``models/network_swinir.py``
(``upsampler="pixelshuffle"``, ``resi_connection="1conv"``, ``ape=False``,
``patch_norm=True``), in the official order of operations: each layer's
LayerNorm, ``torch.roll`` by (−shift, −shift) in the odd layers,
``window_partition``, the ``qkv`` Linear on the windows, (q·scale)·kᵀ +
the relative position bias (+ the −100 region mask of ``calculate_mask`` in
a shifted layer), softmax, ·v, ``proj``, ``window_reverse``, the roll back;
then the MLP with exact GELU.

Departures: stochastic depth (the recipe's drop_path_rate 0.1) is left out,
as dropout is (0 in the recipe); the relative position table is gathered by
a one-hot product, the same numbers as an index.

Imports nothing of the port. Params are keyed by the official
``state_dict`` names, less its buffers; ``m`` holds the widths under
``ModelConfig``'s names.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

RGB_MEAN = (0.4488, 0.4371, 0.4040)
EPS = 1e-5


def _linear(p, name, x):
    return F.linear(x, p[f"{name}.weight"], p[f"{name}.bias"])


def _layer_norm(p, name, x):
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"], p[f"{name}.bias"], EPS)


def _conv(p, name, x):
    return F.conv2d(x, p[f"{name}.weight"], p[f"{name}.bias"], padding=1)


def window_partition(x, ws):
    b, h, w, c = x.shape
    x = x.view(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, c)


def window_reverse(windows, ws, h, w):
    b = windows.shape[0] // (h * w // ws // ws)
    x = windows.view(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def calculate_mask(h, w, ws, shift):
    img_mask = torch.zeros((1, h, w, 1))
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img_mask[:, hs, wsl, :] = cnt
            cnt += 1
    mask_windows = window_partition(img_mask, ws).view(-1, ws * ws)
    attn_mask = mask_windows.unsqueeze(1) - mask_windows.unsqueeze(2)
    return attn_mask.masked_fill(attn_mask != 0, -100.0).masked_fill(attn_mask == 0, 0.0)


def relative_position_index(ws):
    coords = torch.stack(torch.meshgrid(torch.arange(ws), torch.arange(ws), indexing="ij"))
    flat = torch.flatten(coords, 1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def attention(p, name, x, heads, ws, mask):
    """WindowAttention.forward on windows x (B_, N, C)."""
    b_, n, c = x.shape
    qkv = _linear(p, f"{name}.qkv", x).reshape(b_, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    q = q * (c // heads) ** -0.5
    attn = q @ k.transpose(-2, -1)
    table = p[f"{name}.relative_position_bias_table"]
    onehot = F.one_hot(relative_position_index(ws).view(-1), table.shape[0]).to(table)
    bias = (onehot @ table).view(n, n, -1).permute(2, 0, 1)
    attn = attn + bias.unsqueeze(0)
    if mask is not None:
        nw = mask.shape[0]
        attn = attn.view(b_ // nw, nw, heads, n, n) + mask.unsqueeze(1).unsqueeze(0)
        attn = attn.view(-1, heads, n, n)
    attn = attn.softmax(-1)
    x = (attn @ v).transpose(1, 2).reshape(b_, n, c)
    return _linear(p, f"{name}.proj", x)


def swin_layer(p, name, x, hw, heads, ws, shift):
    """SwinTransformerBlock.forward on tokens x (B, H·W, C)."""
    h, w = hw
    b, _, c = x.shape
    shortcut = x
    x = _layer_norm(p, f"{name}.norm1", x).view(b, h, w, c)
    if shift:
        x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
    windows = window_partition(x, ws).view(-1, ws * ws, c)
    mask = calculate_mask(h, w, ws, shift).to(x.device) if shift else None
    windows = attention(p, f"{name}.attn", windows, heads, ws, mask).view(-1, ws, ws, c)
    x = window_reverse(windows, ws, h, w)
    if shift:
        x = torch.roll(x, shifts=(shift, shift), dims=(1, 2))
    x = shortcut + x.reshape(b, h * w, c)
    y = _linear(p, f"{name}.mlp.fc1", _layer_norm(p, f"{name}.norm2", x))
    return x + _linear(p, f"{name}.mlp.fc2", F.gelu(y))


def forward(p, x, m):
    """NHWC LR in [0, 1] → NHWC SR, unclamped, fp32."""
    ws, f = m["window_size"], m["upscale_factor"]
    b, h, w, c = x.shape
    mean = torch.tensor(RGB_MEAN[:c], device=x.device).view(1, c, 1, 1)
    img = x.permute(0, 3, 1, 2) - mean
    img = F.pad(img, (0, (ws - w % ws) % ws, 0, (ws - h % ws) % ws), "reflect")
    hp, wp = img.shape[2:]
    feat = _conv(p, "conv_first", img)
    t = _layer_norm(p, "patch_embed.norm", feat.flatten(2).transpose(1, 2))
    for i, (depth, heads) in enumerate(zip(m["depths"], m["num_heads"])):
        y = t
        for j in range(depth):
            y = swin_layer(p, f"layers.{i}.residual_group.blocks.{j}", y, (hp, wp), heads, ws,
                           0 if j % 2 == 0 else ws // 2)
        y = _conv(p, f"layers.{i}.conv", y.transpose(1, 2).view(b, -1, hp, wp))
        t = y.flatten(2).transpose(1, 2) + t
    t = _layer_norm(p, "norm", t)
    out = _conv(p, "conv_after_body", t.transpose(1, 2).view(b, -1, hp, wp)) + feat
    out = F.leaky_relu(_conv(p, "conv_before_upsample.0", out), 0.01)
    for j in range(int(math.log2(f))):
        out = F.pixel_shuffle(_conv(p, f"upsample.{2 * j}", out), 2)
    out = _conv(p, "conv_last", out) + mean
    return out[:, :, :h * f, :w * f].permute(0, 2, 3, 1)
