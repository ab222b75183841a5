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
modules see NCHW-shaped tensors in channels-last (NHWC) memory from the
stem to the head: the input's NCHW view is laid out channels-last (a copy
only where the batch is not NHWC-contiguous), cuDNN's convs keep it,
GroupNorm's NHWC kernels read and write it (forward and backward,
``ops/cuda/group_norm_kernel.py``), and the pixel (un)shuffles are
written on the NHWC memory (:func:`pixel_shuffle`), so no conv gets an
NCHW tensor to transpose. Traps against flax: ``nn.GroupNorm`` here is
built with eps 1e-6 (flax's default; torch's is 1e-5), and flax computes
the variance as E[x²]−E[x]² where torch takes E[(x−μ)²] — equal up to
rounding. Every conv carries a bias, as flax's ``nn.Conv`` does.

``compute_dtype="bfloat16"`` puts the roundings where flax's
``dtype=bfloat16`` modules put them, by explicit casts (``torch.autocast``
would run ``group_norm`` in f32 and carry the block output in f32). The
params stay f32, the master copy Adam updates; each conv casts its input,
kernel and bias to bf16 and returns bf16 (flax ``promote_dtype``), so the
f32 parameters get f32 gradients through the cast. GroupNorm takes its
statistics, normalise, scale and bias in f32 and rounds once, at the
output (flax ``_normalize``). The input is cast once, by the stem;
LeakyReLU, ReLU, the pixel (un)shuffles, both skip adds and the block
carry stay bf16; the output comes back as f32, so the loss kernels keep
their f32 input.

``remat=True`` recomputes each residual block's branch in the backward
(:class:`RematBlock`), keeping only the block's input alive, on one model
and under the vmap pool executor's ``torch.func.vmap`` alike.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from srgan_tpu_torch.config import ModelConfig
from srgan_tpu_torch.ops import pixel_shuffle as nhwc
from srgan_tpu_torch.ops.cuda import group_norm_kernel

HEADS = ("subpixel", "coarse", "reference")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(name: str) -> torch.dtype:
    if name not in DTYPES:
        raise ValueError(
            f"compute_dtype must be 'float32' or 'bfloat16', got {name!r}"
        )
    return DTYPES[name]


class Conv2d(nn.Conv2d):
    """flax ``nn.Conv(dtype=compute_dtype)``: input, kernel and bias cast to
    the compute dtype on each call, the output in it. The bias is added
    after the conv, in the compute dtype, as flax adds it (a bf16 conv
    rounds its sum before the bias; on the CPU a fused bias would not)."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        y = F.conv2d(x.to(cd), self.weight.to(cd), stride=self.stride,
                     padding=self.padding)
        return y + self.bias.to(cd).view(1, -1, 1, 1)


class GroupNorm(nn.GroupNorm):
    """flax ``nn.GroupNorm(dtype=compute_dtype)``: statistics, normalise,
    scale and bias in f32, one rounding to the compute dtype at the
    output. On the card by the kernels of ``ops/cuda/group_norm_kernel.py``
    (the NHWC ones for the model's channels-last activations, with their
    backward); on the CPU by torch's ``native_group_norm`` on the f32 cast
    (the route is ``group_norm_kernel.group_norm``'s)."""

    def __init__(self, groups: int, features: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(groups, features, eps=1e-6)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm_kernel.group_norm(x, self.weight, self.bias, self.num_groups,
                                            self.eps, self.compute_dtype)


def pixel_shuffle(x: torch.Tensor) -> torch.Tensor:
    """``F.pixel_shuffle(x, 2)`` of an NCHW-shaped batch, returned in
    channels-last memory: one copy, of the NHWC memory (a channels-last x's
    NHWC view is free)."""
    return nhwc.pixel_shuffle(x.permute(0, 2, 3, 1), 2).permute(0, 3, 1, 2)


def pixel_unshuffle(x: torch.Tensor) -> torch.Tensor:
    """``F.pixel_unshuffle(x, 2)``, likewise channels-last."""
    return nhwc.pixel_unshuffle(x.permute(0, 2, 3, 1), 2).permute(0, 3, 1, 2)


def _norm(norm: str, groups: int, features: int, compute_dtype) -> nn.Module:
    if norm == "group":
        return GroupNorm(groups, features, compute_dtype)
    if norm != "none":
        raise ValueError(f"norm must be 'group' or 'none', got {norm!r}")
    return nn.Identity()


class ResidualBlock(nn.Module):
    """conv3x3 → norm → ReLU → conv3x3 → norm, plus identity skip."""

    def __init__(self, num_features: int, norm: str = "group",
                 group_norm_groups: int = 8,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        f, cd = num_features, compute_dtype
        self.conv1 = Conv2d(f, f, 3, padding=1, compute_dtype=cd)
        self.norm1 = _norm(norm, group_norm_groups, f, cd)
        self.conv2 = Conv2d(f, f, 3, padding=1, compute_dtype=cd)
        self.norm2 = _norm(norm, group_norm_groups, f, cd)
        # fixed here: under torch.func.functional_call the params are plain
        # tensors, which named_parameters() does not list
        self._param_names = [name for name, _ in self.named_parameters()]

    def params(self) -> list:
        """The block's params in ``_param_names`` order, as it holds them
        now (functional_call's tensors inside it)."""
        return [functools.reduce(getattr, name.split("."), self)
                for name in self._param_names]

    def forward(self, x: torch.Tensor, skip: bool = True) -> torch.Tensor:
        """The block's output, or with ``skip=False`` its residual branch
        alone (what :class:`RematBlock` recomputes)."""
        out = self.norm2(self.conv2(F.relu(self.norm1(self.conv1(x)))))
        return out + x if skip else out


def _branch(block: ResidualBlock):
    """``block``'s residual branch as a function of ``(x, *params)``, the
    params in ``_param_names`` order in place of its own."""
    def branch(x, *params):
        return torch.func.functional_call(
            block, dict(zip(block._param_names, params)), (x,), {"skip": False})
    return branch


def _recompute_grads(fn, saved, g):
    """Rerun ``fn(*saved)`` with a graph and return the gradient of its output
    (cotangent ``g``) to each saved input."""
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_() for t in saved]
        return torch.autograd.grad(fn(*inputs), inputs, g)


class RematBlock(torch.autograd.Function):
    """A residual block's branch, recomputed in the backward (``nn.remat`` in
    JAX): the forward runs without a graph and keeps only the block's input
    and params; the backward reruns the branch with one and differentiates
    it. Called as ``RematBlock.apply(block, x, *params) + x``, params in the
    block's ``_param_names`` order. The skip add stays outside, so the
    input's two gradients meet in autograd's engine as they do without
    remat (the same bits); the bf16 casts live in the branch and are
    recomputed with it. The forward runs without a graph and the recompute
    with one; GroupNorm's route gives both the same forward kernels (on the
    card the NHWC ones, on the CPU torch's), so the activations downstream
    are the ones the gradient is taken at.

    Under ``torch.func.vmap`` (the vmap pool executor, whose members' params
    are batched) the rule hands the unwrapped (N, …) tensors to
    :class:`PooledRematBlock`, so the saved input and the recompute live
    outside the vmap, where the executor's backward runs:
    ``torch.utils.checkpoint`` would save the vmap's batched tensors, which
    are gone by then."""

    @staticmethod
    def forward(block, x, *params):
        return _branch(block)(x, *params)

    @staticmethod
    def setup_context(ctx, inputs, output):
        block, x, *params = inputs
        ctx.block = block
        ctx.save_for_backward(x, *params)

    @staticmethod
    def backward(ctx, g):
        return None, *_recompute_grads(_branch(ctx.block), ctx.saved_tensors, g)

    @staticmethod
    def vmap(info, in_dims, block, x, *params):
        n = info.batch_size
        args = [t.expand(n, *t.shape) if d is None else t.movedim(d, 0)
                for t, d in zip((x, *params), in_dims[1:])]
        return PooledRematBlock.apply(block, *args), 0


class PooledRematBlock(torch.autograd.Function):
    """:class:`RematBlock` of N members at once: ``x`` and every param carry
    the member axis first; the branch runs under ``torch.func.vmap``, in the
    forward without a graph and again in the backward."""

    @staticmethod
    def forward(block, x, *params):
        return torch.func.vmap(_branch(block))(x, *params)

    setup_context = RematBlock.setup_context

    @staticmethod
    def backward(ctx, g):
        return None, *_recompute_grads(torch.func.vmap(_branch(ctx.block)),
                                       ctx.saved_tensors, g)


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
        cd = self.compute_dtype = _dtype(compute_dtype)
        nf, c = num_features, in_channels
        self.upscale_factor = f
        self.norm = norm
        self.head = head
        self.remat = remat
        self.num_stages = int(math.log2(f))
        conv = functools.partial(Conv2d, compute_dtype=cd)
        self.stem = conv(c, nf, 9, padding=4)
        self.blocks = nn.ModuleList(
            ResidualBlock(nf, norm, group_norm_groups, cd)
            for _ in range(num_residuals)
        )
        self.mid = conv(nf, nf, 3, padding=1)
        self.upsample = nn.ModuleList(
            conv(nf, nf * 4, 3, padding=1) for _ in range(self.num_stages)
        )
        if head == "reference":
            self.tail = conv(nf, c, 9, padding=4)
        elif self._coarse:
            self.tail = conv(nf * 16, c * 16, 3, padding=1)
        else:
            self.tail = conv(nf * 4, c * 4, 5, padding=2)

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
        # the NCHW view in channels-last memory: free for an NHWC-contiguous
        # batch (serving's); batch prep's LR comes out of its resize einsum
        # (B, H, C, W)-ordered, and cuDNN would run such an input, and every
        # layer after it, NCHW. The stem casts it to the compute dtype.
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        out1 = F.leaky_relu(self.stem(x), 0.2)
        out = out1
        for block in self.blocks:
            if self.remat and torch.is_grad_enabled():
                out = RematBlock.apply(block, out, *block.params()) + out
            else:
                out = block(out)
        out = self.mid(out) + out1  # global skip

        if self.head == "reference":
            for conv in self.upsample:
                out = F.relu(pixel_shuffle(conv(out)))
            out = self.tail(out)
        else:
            # fold the RGB head through the last shuffle: conv → ReLU
            # (commuted through the shuffle) → phase conv → shuffle(s)
            for conv in self.upsample[:-1]:
                out = F.relu(pixel_shuffle(conv(out)))
            out = F.relu(self.upsample[-1](out))
            if self._coarse:
                out = self.tail(pixel_unshuffle(out))
                out = pixel_shuffle(pixel_shuffle(out))
            else:
                out = pixel_shuffle(self.tail(out))
        return out.permute(0, 2, 3, 1).float().contiguous()


@torch.no_grad()
def _init_like_flax(model: nn.Module, generator: torch.Generator) -> None:
    """flax's initialisers: conv and dense kernels lecun_normal (a normal
    truncated at ±2σ, rescaled to variance 1/fan_in), their biases zero,
    GroupNorm scale one and bias zero. Drawn in module order from
    ``generator``."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
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


def _fold(k: np.ndarray, b: np.ndarray, out_k: int, reach: int):
    """The shared index algebra of the head folds (r = 2, torch
    pixel-shuffle channel order (c, rh, rw)): fine output pixel (2i+a,
    2j+b) reads fine input (2i+a+u, 2j+b+v) = coarse (i+s, j+t) phase (p,
    q), with u = 2s + p − a and v = 2t + q − b; the coarse kernel is
    ``out_k`` wide and zero where |u| or |v| exceeds ``reach``."""
    kh, kw, cin, cout = k.shape
    half = out_k // 2
    out = np.zeros((out_k, out_k, 4 * cin, 4 * cout), np.float32)
    for p in range(2):
        for q in range(2):
            for a in range(2):
                for bb in range(2):
                    for s in range(-half, half + 1):
                        for t in range(-half, half + 1):
                            u, v = 2 * s + p - a, 2 * t + q - bb
                            if -reach <= u <= reach and -reach <= v <= reach:
                                out[s + half, t + half, p * 2 + q::4, a * 2 + bb::4] = (
                                    k[u + kh // 2, v + kw // 2])
    return out, np.repeat(np.asarray(b, np.float32), 4)


def reference_head_to_subpixel(k9, b3):
    """A reference-head tail kernel → the equivalent subpixel-head phase
    kernel (JAX ``models/srresnet.py:271``). ``k9``: (9, 9, F, C) HWIO
    kernel of the post-shuffle conv9x9, ``b3``: (C,) bias (numpy arrays or
    CPU tensors). Returns numpy ``(k5, b12)``, k5 (5, 5, 4F, 4C), such that
    ``conv9x9(pixel_shuffle(x)) == pixel_shuffle(conv5x5(x))`` exactly (2
    coarse pad rows are 4 fine ones)."""
    k9 = np.asarray(k9, np.float32)
    if k9.shape[:2] != (9, 9):
        raise ValueError(f"expected a (9, 9, F, C) kernel, got {k9.shape}")
    return _fold(k9, b3, 5, 4)


def fold_phase_conv_to_coarse(k5, b12):
    """A subpixel-head phase kernel → the equivalent coarse-head kernel
    (JAX ``models/srresnet.py:320``). ``k5``: (5, 5, C_in, C_out) HWIO kernel
    of the conv after one pixel shuffle, ``b12``: (C_out,). Returns numpy
    ``(k3, b48)``, k3 (3, 3, 4·C_in, 4·C_out), such that ``ps(conv5x5(x))
    == ps(ps(conv3x3(unshuffle(x))))`` exactly."""
    k5 = np.asarray(k5, np.float32)
    if k5.shape[:2] != (5, 5):
        raise ValueError(f"expected a (5, 5, C_in, C_out) kernel, got {k5.shape}")
    return _fold(k5, b12, 3, 2)
