"""SwinIR (Liang et al., "SwinIR: Image Restoration Using Swin Transformer",
ICCVW 2021, arXiv:2108.10257), classical SR with the ``pixelshuffle``
upsampler and ``1conv`` residual connection, as the official
``models/network_swinir.py`` builds it: the benchmark's plain fp32
reference, its work counts and the weights' draw.

The reference follows the official order of operations: (x − mean),
reflect-padded up to a multiple of the window, ``conv_first``, tokens,
``patch_embed.norm``; each residual group's Swin layers (LayerNorm, roll
by (−shift, −shift) in the odd layers, window partition, the ``qkv``
Linear on the windows, (q·scale)·kᵀ + the relative position bias (+ the
−100 region mask in a shifted layer), softmax, ·v, ``proj``, windows back,
roll back, + skip; LayerNorm, fc1, exact GELU, fc2, + skip), its 3x3 conv
and skip; ``norm``, ``conv_after_body`` + the ``conv_first`` output,
``conv_before_upsample`` with LeakyReLU 0.01, log2(r) x [conv, pixel
shuffle 2], ``conv_last``, + mean, cropped. Stochastic depth (the recipe's
0.1) is left out, as it is in the program. Each Swin layer is recomputed
in the backward where a graph is kept (``torch.utils.checkpoint``), which
changes no number: the fp32 graph of 32 rows would not fit the card.

``quant`` rounds where the port rounds in bf16: each conv's and Linear's
operands and output, each LayerNorm's output, the attention's output and
GELU's; the token stream between layers is not rounded, as the port keeps
it f32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from h100bench import work

RGB_MEAN = (0.4488, 0.4371, 0.4040)
EPS = 1e-5
TABLE_STD = 0.5  # the relative position bias's draw: of the scores' own scale
LAST_SCALE = 0.1  # conv_last's kernel draw, of 1/sqrt(fan_in) (param_scale)


def _m(m):
    return (m["embed_dim"], list(m["depths"]), list(m["num_heads"]), m["window_size"],
            int(m["embed_dim"] * m["mlp_ratio"]))


def param_shapes(m):
    """(name, shape) in the order of the official ``state_dict`` (less its
    buffers), which the port's ``named_parameters`` keeps."""
    c, f, nf = m["in_channels"], m["upscale_factor"], m["num_features"]
    e, depths, heads, ws, hidden = _m(m)
    out = []

    def conv(name, cin, cout):
        out.extend([(f"{name}.weight", (cout, cin, 3, 3)), (f"{name}.bias", (cout,))])

    def pair(name, shape_w, n):
        out.extend([(f"{name}.weight", shape_w), (f"{name}.bias", (n,))])

    conv("conv_first", c, e)
    pair("patch_embed.norm", (e,), e)
    for i, (depth, h) in enumerate(zip(depths, heads)):
        for j in range(depth):
            b = f"layers.{i}.residual_group.blocks.{j}"
            pair(f"{b}.norm1", (e,), e)
            out.append((f"{b}.attn.relative_position_bias_table", ((2 * ws - 1) ** 2, h)))
            pair(f"{b}.attn.qkv", (3 * e, e), 3 * e)
            pair(f"{b}.attn.proj", (e, e), e)
            pair(f"{b}.norm2", (e,), e)
            pair(f"{b}.mlp.fc1", (hidden, e), hidden)
            pair(f"{b}.mlp.fc2", (e, hidden), e)
        conv(f"layers.{i}.conv", e, e)
    pair("norm", (e,), e)
    conv("conv_after_body", e, e)
    conv("conv_before_upsample.0", e, nf)
    for j in range(int(math.log2(f))):
        conv(f"upsample.{2 * j}", nf, 4 * nf)
    conv("conv_last", nf, c)
    return out


def param_scale(name, shape):
    """(offset, scale) of a parameter's normal draw. Conv kernels and Linear
    weights N(0, 1/fan_in), so that q·k·scale has unit spread and every
    layer hands on its input's scale; LayerNorm scales N(1, 0.05²) and
    biases N(0, 0.05²), as SRResNet's norms; the relative position tables
    N(0, 0.5²), half the scores' spread, so that the bias moves the
    softmax; other biases N(0, 0.01²). The LayerNorm before each layer
    keeps 36 residual layers in range. ``conv_last``'s kernel is drawn at
    ``LAST_SCALE`` of that, so that the first SR is the mean image plus a
    small residual: the L1 loss's sign at a pixel is then the data's, and
    bf16's rounding of the SR flips few of them, where a unit-spread SR
    flips enough to swing the first steps' gradients as far as a wrong
    attention does."""
    if name.endswith("relative_position_bias_table"):
        return 0.0, TABLE_STD
    if "norm" in name.split(".")[-2]:
        return (1.0, 0.05) if name.endswith("weight") else (0.0, 0.05)
    if name.endswith("weight"):
        scale = LAST_SCALE if name == "conv_last.weight" else 1.0
        return 0.0, scale / math.sqrt(math.prod(shape[1:]))
    return 0.0, 0.01


# ------------------------------------------------------------ reference --


def _conv(p, name, x, q):
    w, b = p[f"{name}.weight"], p[f"{name}.bias"]
    if q is None:
        return F.conv2d(x, w, b, padding=1)
    return q(F.conv2d(q(x), q(w), None, padding=1) + b.view(1, -1, 1, 1))


def _linear(p, name, x, q):
    w, b = p[f"{name}.weight"], p[f"{name}.bias"]
    if q is None:
        return F.linear(x, w, b)
    return q(F.linear(q(x), q(w), b))


def _layer_norm(p, name, x, q):
    y = F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"], p[f"{name}.bias"], EPS)
    return y if q is None else q(y)


def _partition(x, ws):
    b, h, w, c = x.shape
    x = x.view(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def _reverse(windows, ws, h, w):
    b = windows.shape[0] // (h * w // ws // ws)
    x = windows.view(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def _mask(h, w, ws, shift, device):
    img = torch.zeros((1, h, w, 1), device=device)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, hs, wsl, :] = cnt
            cnt += 1
    win = _partition(img, ws).squeeze(-1)
    diff = win.unsqueeze(1) - win.unsqueeze(2)
    return diff.masked_fill(diff != 0, -100.0).masked_fill(diff == 0, 0.0)


def _bias_onehot(ws, device):
    """(N·N, (2·ws − 1)²): the official ``relative_position_index`` as a
    one-hot product, whose gradient is a matmul (deterministic on the card)."""
    coords = torch.stack(torch.meshgrid(torch.arange(ws), torch.arange(ws), indexing="ij"))
    flat = coords.flatten(1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0) + (ws - 1)
    idx = rel[..., 0] * (2 * ws - 1) + rel[..., 1]
    return F.one_hot(idx.view(-1), (2 * ws - 1) ** 2).float().to(device)


def _swin_layer(p, name, x, hw, heads, ws, shift, onehot, mask, q):
    h, w = hw
    b, _, c = x.shape
    n = ws * ws
    y = _layer_norm(p, f"{name}.norm1", x, q).view(b, h, w, c)
    if shift:
        y = torch.roll(y, shifts=(-shift, -shift), dims=(1, 2))
    win = _partition(y, ws)
    qkv = _linear(p, f"{name}.attn.qkv", win, q)
    qkv = qkv.reshape(-1, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    attn = (qkv[0] * (c // heads) ** -0.5) @ qkv[1].transpose(-2, -1)
    table = p[f"{name}.attn.relative_position_bias_table"]
    attn = attn + (onehot @ table).view(n, n, heads).permute(2, 0, 1).unsqueeze(0)
    if shift:
        nw = mask.shape[0]
        attn = (attn.view(-1, nw, heads, n, n) + mask[None, :, None]).view(-1, heads, n, n)
    o = (attn.softmax(-1) @ qkv[2]).transpose(1, 2).reshape(-1, n, c)
    if q is not None:
        o = q(o)
    o = _reverse(_linear(p, f"{name}.attn.proj", o, q), ws, h, w)
    if shift:
        o = torch.roll(o, shifts=(shift, shift), dims=(1, 2))
    x = x + o.reshape(b, h * w, c)
    y = F.gelu(_linear(p, f"{name}.mlp.fc1", _layer_norm(p, f"{name}.norm2", x, q), q))
    if q is not None:
        y = q(y)
    return x + _linear(p, f"{name}.mlp.fc2", y, q)


def forward(p, x, m, quant=None):
    """NHWC LR in → NHWC SR out, unclamped, fp32."""
    e, depths, heads, ws, _ = _m(m)
    f, c = m["upscale_factor"], m["in_channels"]
    b, h, w, _ = x.shape
    mean = torch.tensor(RGB_MEAN[:c], device=x.device).view(1, c, 1, 1)
    img = x.permute(0, 3, 1, 2) - mean
    img = F.pad(img, (0, (ws - w % ws) % ws, 0, (ws - h % ws) % ws), "reflect")
    hp, wp = img.shape[2:]
    onehot = _bias_onehot(ws, x.device)
    mask = _mask(hp, wp, ws, ws // 2, x.device)
    feat = _conv(p, "conv_first", img, quant)
    t = _layer_norm(p, "patch_embed.norm", feat.flatten(2).transpose(1, 2), quant)
    for i, (depth, nh) in enumerate(zip(depths, heads)):
        y = t
        for j in range(depth):
            args = (f"layers.{i}.residual_group.blocks.{j}", (hp, wp), nh, ws,
                    0 if j % 2 == 0 else ws // 2, onehot, mask, quant)
            if torch.is_grad_enabled():
                y = checkpoint(lambda z, a=args: _swin_layer(p, a[0], z, *a[1:]), y,
                               use_reentrant=False)
            else:
                y = _swin_layer(p, args[0], y, *args[1:])
        y = _conv(p, f"layers.{i}.conv", y.transpose(1, 2).reshape(b, e, hp, wp), quant)
        t = y.flatten(2).transpose(1, 2) + t
    t = _layer_norm(p, "norm", t, quant)
    out = _conv(p, "conv_after_body", t.transpose(1, 2).reshape(b, e, hp, wp), quant) + feat
    out = F.leaky_relu(_conv(p, "conv_before_upsample.0", out, quant), 0.01)
    for j in range(int(math.log2(f))):
        out = F.pixel_shuffle(_conv(p, f"upsample.{2 * j}", out, quant), 2)
    out = _conv(p, "conv_last", out, quant) + mean
    return out[:, :, :h * f, :w * f].permute(0, 2, 3, 1)


# ----------------------------------------------------------------- work --


@dataclass(frozen=True)
class Matmul:
    """One pass of a Linear over ``rows`` tokens, k → n: the forward, the
    input gradient or the weight gradient, each 2·rows·k·n."""

    rows: int
    k: int
    n: int

    op = "matmul"

    def flops(self, batch):
        return 2.0 * batch * self.rows * self.k * self.n

    def bytes(self, batch, width):
        return width * (batch * self.rows * (self.k + self.n) + self.k * self.n)


@dataclass(frozen=True)
class WindowAttn:
    """The windowed attention of one layer over ``tokens`` tokens of width
    ``channels`` in windows of ``n``: forward 4·T·n·C FLOPs (S = q·kᵀ and
    P·v), backward 2.5 times that; bytes q, k, v and O at the compute width
    (backward also dO, dq, dk and dv), each read or written once; the
    bias, the log-sum-exp and dBias are under 1 %."""

    tokens: int
    channels: int
    n: int
    backward: bool = False

    op = "window_attn"

    def flops(self, batch):
        return (2.5 if self.backward else 1.0) * 4.0 * batch * self.tokens * self.n * self.channels

    def bytes(self, batch, width):
        return width * batch * self.tokens * self.channels * (8 if self.backward else 4)


def _padded(m, lr_hw):
    ws = m["window_size"]
    return tuple(v + (-v) % ws for v in lr_hw)


def _convs(m, hp, wp):
    c, f, nf = m["in_channels"], m["upscale_factor"], m["num_features"]
    e, depths, _, _, _ = _m(m)
    Conv = work.Conv
    out = [Conv(c, e, 3, hp, wp, hp, wp)]
    out += [Conv(e, e, 3, hp, wp, hp, wp)] * (len(depths) + 1)
    out.append(Conv(e, nf, 3, hp, wp, hp, wp))
    for j in range(int(math.log2(f))):
        s = 2 ** j
        out.append(Conv(nf, 4 * nf, 3, hp * s, wp * s, hp * s, wp * s))
    out.append(Conv(nf, c, 3, hp * f, wp * f, hp * f, wp * f))
    return out


def _layers(m, hp, wp):
    """(the Linears, the attention) of every Swin layer."""
    e, depths, _, ws, hidden = _m(m)
    t = hp * wp
    lin = [Matmul(t, e, 3 * e), Matmul(t, e, e), Matmul(t, e, hidden), Matmul(t, hidden, e)]
    n_layers = sum(depths)
    return lin * n_layers, [(t, e, ws * ws)] * n_layers


def forward_ops(m, lr_hw):
    hp, wp = _padded(m, lr_hw)
    lin, attn = _layers(m, hp, wp)
    return [*_convs(m, hp, wp), *lin, *(WindowAttn(*a) for a in attn)]


def train_ops(m, lr_hw):
    """Every conv's forward, weight gradient and input gradient but the
    stem's; every Linear's forward and its two gradients; every attention's
    forward and backward."""
    hp, wp = _padded(m, lr_hw)
    lin, attn = _layers(m, hp, wp)
    return [*work.passes(_convs(m, hp, wp), ("fwd", "wgrad", "dgrad")), *lin * 3,
            *(WindowAttn(*a) for a in attn), *(WindowAttn(*a, backward=True) for a in attn)]


def port_model(model_cfg):
    from srgan_tpu_torch.models.swinir import SwinIR

    return SwinIR.from_config(model_cfg)
