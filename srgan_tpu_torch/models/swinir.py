"""SwinIR (Liang et al., "SwinIR: Image Restoration Using Swin Transformer",
ICCVW 2021, arXiv:2108.10257) for classical super-resolution, as the
official ``models/network_swinir.py`` builds it with
``upsampler="pixelshuffle"`` and ``resi_connection="1conv"``; SwinIR-M x4
(``ModelConfig``'s defaults with ``generator="swinir"``) is its
``001_classicalSR_DF2K_s64w8_SwinIR-M_x4``: embed 180, 6 residual Swin
groups (RSTB) of 6 layers, 6 heads of 30, window 8, MLP 360, 11,900,199
parameters.

NHWC in [0, 1] in, NHWC SR out, unclamped, as ``SRResNet``. The forward:

  x − mean (DIV2K's RGB mean, img_range 1), reflect-padded at the bottom and
  right up to a multiple of the window → ``conv_first`` (3x3) → tokens
  (B, H·W, C), ``patch_embed.norm`` → each RSTB: its layers, then the
  tokens back to an image, a 3x3 ``conv``, back to tokens, + the group's
  input → ``norm`` → image, ``conv_after_body`` + the ``conv_first``
  output → ``conv_before_upsample`` (3x3 → ``num_features``, LeakyReLU
  0.01) → ``upsample``: log2(r) x [3x3 conv to 4·``num_features``, pixel
  shuffle 2] → ``conv_last`` (3x3 → RGB) → + mean, cropped to (H·r, W·r).

A Swin layer: ``x = x + proj(attn(norm1(x)))``, then ``x = x + fc2(GELU(
fc1(norm2(x))))`` (exact GELU). The attention is
``ops/window_attention.py``'s op on the ``qkv`` Linear's output in the
image's token order: its route folds the roll, the window partition and
the mask of the odd layers, which shift by window // 2. Its bias is the
(2·window − 1)² x heads table gathered per head by a one-hot product
(``rel_onehot``, a buffer that is not saved), whose gradient is a matmul,
deterministic on the card, where a gather's is a scatter-add.

Parameter names and their order are the official ``state_dict``'s, less
its buffers. Left out: stochastic depth (the recipe's drop_path_rate 0.1),
dropout (0 in the recipe) and the absolute position embedding (off).

``compute_dtype="bfloat16"``: the params stay f32, the master copy Adam
updates. Rounding points: every conv (the port's ``Conv2d``: operands and
bias cast to bf16, the output bf16) and every Linear (operands and bias
cast to bf16, f32 accumulation, the output bf16); each LayerNorm takes its
statistics, normalise, scale and bias in f32 and rounds once at the output;
the attention computes S, the softmax and P·v in f32 and rounds its output
once; GELU and LeakyReLU run on their bf16 inputs. The token stream
between the layers (the residual adds inside and around each group) stays
f32; the skip over the body, the upsampler and its shuffles are bf16, and
the output comes back as f32, so the loss kernels keep their f32 input.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from srgan_tpu_torch.config import ModelConfig
from srgan_tpu_torch.models.srresnet import Conv2d, _dtype
from srgan_tpu_torch.ops.window_attention import relative_position_index, window_attention
from srgan_tpu_torch.utils.profiling import span

RGB_MEAN = (0.4488, 0.4371, 0.4040)  # DIV2K's, the official default
LAYER_NORM_EPS = 1e-5


class LayerNorm(nn.LayerNorm):
    """Statistics, normalise, scale and bias in f32; one rounding to the
    compute dtype at the output."""

    def __init__(self, features: int, compute_dtype: torch.dtype = torch.float32):
        super().__init__(features, eps=LAYER_NORM_EPS)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias,
                            self.eps).to(self.compute_dtype)


class Linear(nn.Linear):
    """Input, weight and bias cast to the compute dtype on each call, the
    output in it."""

    def __init__(self, fan_in: int, fan_out: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(fan_in, fan_out)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        return F.linear(x.to(cd), self.weight.to(cd), self.bias.to(cd))


class WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, cd: torch.dtype):
        super().__init__()
        self.heads, self.window = heads, window
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, heads))
        self.qkv = Linear(dim, 3 * dim, cd)
        self.proj = Linear(dim, dim, cd)

    def forward(self, x, onehot, shift: int, grid):
        n = self.window * self.window
        bias = (onehot @ self.relative_position_bias_table).view(n, n, self.heads)
        out = window_attention(self.qkv(x), bias.permute(2, 0, 1).contiguous(), self.heads,
                               self.window, shift, grid)
        return self.proj(out)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, cd: torch.dtype):
        super().__init__()
        self.fc1 = Linear(dim, hidden, cd)
        self.fc2 = Linear(hidden, dim, cd)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class SwinLayer(nn.Module):
    """The official ``SwinTransformerBlock``; ``shift`` 0 or window // 2."""

    def __init__(self, dim: int, heads: int, window: int, shift: int, mlp_ratio: float,
                 cd: torch.dtype):
        super().__init__()
        self.shift = shift
        self.norm1 = LayerNorm(dim, cd)
        self.attn = WindowAttention(dim, heads, window, cd)
        self.norm2 = LayerNorm(dim, cd)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), cd)

    def forward(self, x, onehot, grid):
        # f32 + bf16 promotes inside the add: one pass, no f32 copy of the branch
        x = x + self.attn(self.norm1(x), onehot, self.shift, grid)
        return x + self.mlp(self.norm2(x))


class RSTB(nn.Module):
    """A residual Swin group: its layers, a 3x3 conv, + the group's input."""

    def __init__(self, dim: int, depth: int, heads: int, window: int, mlp_ratio: float,
                 cd: torch.dtype):
        super().__init__()
        self.residual_group = nn.ModuleDict({"blocks": nn.ModuleList(
            SwinLayer(dim, heads, window, 0 if i % 2 == 0 else window // 2, mlp_ratio, cd)
            for i in range(depth))})
        self.conv = Conv2d(dim, dim, 3, padding=1, compute_dtype=cd)
        self.shifted = [i for i, layer in enumerate(self.residual_group["blocks"])
                        if layer.shift]

    def forward(self, x, onehot, grid):
        _, h, w = grid
        y = x
        for layer in self.residual_group["blocks"]:
            y = layer(y, onehot, grid)
        y = self.conv(_image(y, h, w))
        return _tokens(y) + x


def _image(t: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Tokens (B, H·W, C) → NCHW."""
    return t.transpose(1, 2).reshape(t.shape[0], t.shape[2], h, w)


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """NCHW → tokens (B, H·W, C)."""
    return x.flatten(2).transpose(1, 2)


class SwinIR(nn.Module):
    def __init__(
        self,
        in_channels: int = 3,
        num_features: int = 64,
        upscale_factor: int = 4,
        embed_dim: int = 180,
        depths: Sequence[int] = (6, 6, 6, 6, 6, 6),
        num_heads: Sequence[int] = (6, 6, 6, 6, 6, 6),
        window_size: int = 8,
        mlp_ratio: float = 2.0,
        compute_dtype: str = "float32",
    ):
        super().__init__()
        f = upscale_factor
        if f < 2 or (f & (f - 1)) != 0:
            raise ValueError(f"upscale_factor must be a power of two >= 2, got {f}")
        if len(depths) != len(num_heads):
            raise ValueError(f"depths {tuple(depths)} and num_heads {tuple(num_heads)} "
                             "must name the same groups")
        cd = self.compute_dtype = _dtype(compute_dtype)
        c, e, nf = in_channels, embed_dim, num_features
        self.upscale_factor, self.window_size = f, window_size
        conv = functools.partial(Conv2d, compute_dtype=cd)
        self.conv_first = conv(c, e, 3, padding=1)
        self.patch_embed = nn.ModuleDict({"norm": LayerNorm(e, cd)})
        self.layers = nn.ModuleList(
            RSTB(e, d, h, window_size, mlp_ratio, cd) for d, h in zip(depths, num_heads))
        self.norm = LayerNorm(e, cd)
        self.conv_after_body = conv(e, e, 3, padding=1)
        self.conv_before_upsample = nn.Sequential(conv(e, nf, 3, padding=1),
                                                  nn.LeakyReLU(0.01))
        ups = []
        for _ in range(int(math.log2(f))):
            ups += [conv(nf, 4 * nf, 3, padding=1), nn.PixelShuffle(2)]
        self.upsample = nn.Sequential(*ups)
        self.conv_last = conv(nf, c, 3, padding=1)
        idx = relative_position_index(window_size).flatten()
        self.register_buffer("rel_onehot", F.one_hot(idx, (2 * window_size - 1) ** 2).float(),
                             persistent=False)
        self.register_buffer("mean", torch.tensor(RGB_MEAN[:c]).view(1, c, 1, 1),
                             persistent=False)

    @classmethod
    def from_config(cls, cfg: ModelConfig) -> "SwinIR":
        """Refuses, by name, the options whose contracts are SRResNet's."""
        refused = [name for name, on in (
            ("remat (--remat): SRResNet's residual blocks", cfg.remat),
            (f"head={cfg.head!r}: SRResNet's output heads", cfg.head != "subpixel"),
            (f"norm={cfg.norm!r}: SRResNet's GroupNorm", cfg.norm != "group"),
        ) if on]
        if refused:
            raise ValueError("SwinIR does not take " + "; ".join(refused))
        return cls(
            in_channels=cfg.in_channels,
            num_features=cfg.num_features,
            upscale_factor=cfg.upscale_factor,
            embed_dim=cfg.embed_dim,
            depths=cfg.depths,
            num_heads=cfg.num_heads,
            window_size=cfg.window_size,
            mlp_ratio=cfg.mlp_ratio,
            compute_dtype=cfg.compute_dtype,
        )

    def pad_pixels(self, h: int, w: int) -> int:
        """The LR pixels the reflect padding adds to an H x W image."""
        ws = self.window_size
        return (h + (-h) % ws) * (w + (-w) % ws) - h * w

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        ws = self.window_size
        x = x.permute(0, 3, 1, 2) - self.mean
        if h % ws or w % ws:
            x = F.pad(x, (0, (-w) % ws, 0, (-h) % ws), mode="reflect")
        hp, wp = x.shape[2:]
        grid = (b, hp, wp)
        feat = self.conv_first(x)
        t = self.patch_embed["norm"](_tokens(feat)).float()
        windows = b * (hp // ws) * (wp // ws)
        for i, group in enumerate(self.layers):
            with span("model.swin_group", group=i, tokens=b * hp * wp, windows=windows,
                      shifted=group.shifted):
                t = group(t, self.rel_onehot, grid)
        out = self.conv_after_body(_image(self.norm(t), hp, wp)) + feat
        out = self.conv_last(self.upsample(self.conv_before_upsample(out)))
        out = out.float() + self.mean
        f = self.upscale_factor
        return out[:, :, :h * f, :w * f].permute(0, 2, 3, 1).contiguous()


@torch.no_grad()
def _init_like_official(model: SwinIR, generator: torch.Generator) -> None:
    """The official initialisation, drawn in module order from
    ``generator``: Linear weights and the bias tables trunc_normal(std
    0.02) (timm's: cut at ±2, effectively untruncated), Linear biases zero,
    LayerNorm one and zero, convs torch's default (kaiming_uniform with a =
    √5, biases U(±1/√fan_in))."""
    for m in model.modules():
        if isinstance(m, nn.Linear):
            nn.init.trunc_normal_(m.weight, 0.0, 0.02, -2.0, 2.0, generator=generator)
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.Conv2d):
            nn.init.kaiming_uniform_(m.weight, a=math.sqrt(5), generator=generator)
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            nn.init.uniform_(m.bias, -bound, bound, generator=generator)
        elif isinstance(m, WindowAttention):
            nn.init.trunc_normal_(m.relative_position_bias_table, 0.0, 0.02, -2.0, 2.0,
                                  generator=generator)


def init_swinir(cfg: ModelConfig, seed: int = 0,
                device: Optional[torch.device] = None) -> SwinIR:
    """A SwinIR with random weights made from ``seed`` (drawn on the CPU, so
    a seed gives the same weights on every device), moved to ``device``."""
    model = SwinIR.from_config(cfg)
    _init_like_official(model, torch.Generator().manual_seed(seed))
    return model.to(device) if device is not None else model
