"""SwinIR's windowed multi-head self-attention as one autograd op
(``WindowAttention.forward`` of the official ``models/network_swinir.py``,
with the block's ``torch.roll`` and ``window_partition`` around it):

    window_attention(qkv, bias, heads, window, shift, grid) → out

``qkv``: the ``qkv`` Linear's output, (B, H·W, 3C) in the image's row-major
token order, [q | k | v] each split into ``heads`` heads of C / heads;
``grid``: (B, H, W), H and W multiples of ``window``; ``bias``: (heads, N,
N) float32, N = window², the relative position table gathered; ``shift``:
0 in a plain layer, window // 2 in a shifted one. Returns the heads'
outputs, (B, H·W, C), in the same token order and qkv's dtype.

Per window and head, as the official code: the image rolled by (−shift,
−shift), cut into windows, S = (q·scale)·kᵀ + bias (+ −100 between tokens
of different regions of the rolled image, in a shifted layer), softmax,
P·v, and the windows put back and rolled by (+shift, +shift); scale =
head_dim^−0.5. Computed in f32 whatever qkv's dtype, the output rounded
once to it.

The route is picked by device, with no fallback, and counted in ``paths``:
a CPU tensor takes the plain torch version (:func:`window_attention_plain`,
autograd through torch's ops), a CUDA tensor the hand-written kernels
(``ops/cuda/window_attention_kernel.py``), forward and backward. On the card
the kernels' design follows qkv's dtype: bf16 the tensor-core kernels (the
products on ``mma.sync``; P and dS, f32 intermediates, enter them as a bf16
hi and lo term each, so the f32 contract above holds), f32 the CUDA-core
kernels. ``window_attention_kernel.launches`` counts each call by design
(``forward_mma`` / ``backward_mma``, ``forward_simt`` / ``backward_simt``).
"""

from __future__ import annotations

import torch

from srgan_tpu_torch.ops.cuda import window_attention_kernel as wk

MASK_VALUE = -100.0
# Every call by its route
paths = {"cuda": 0, "cpu": 0}


def reset_paths() -> None:
    for k in paths:
        paths[k] = 0


def shift_mask(height: int, width: int, window: int, shift: int) -> torch.Tensor:
    """(windows of one image, N, N): 0 between tokens of one region of the
    rolled image, −100 between regions (``calculate_mask`` of the official
    code)."""
    img = torch.zeros(height, width)
    label = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[hs, ws] = label
            label += 1
    n = window * window
    wins = img.view(height // window, window, width // window, window).transpose(1, 2)
    wins = wins.reshape(-1, n)
    diff = wins[:, None, :] - wins[:, :, None]
    return torch.where(diff != 0, MASK_VALUE, 0.0)


def relative_position_index(window: int) -> torch.Tensor:
    """(N, N): the row of the (2·window − 1)² table that each pair of a
    window's tokens reads (the official ``relative_position_index``)."""
    coords = torch.stack(torch.meshgrid(torch.arange(window), torch.arange(window),
                                        indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0) + (window - 1)
    return rel[..., 0] * (2 * window - 1) + rel[..., 1]


def window_attention_plain(qkv, bias, heads: int, window: int, shift: int, grid):
    """The op in plain torch, in f32 (float64 for a float64 ``qkv``), the
    output rounded to qkv's dtype."""
    b, h, w = grid
    c3 = qkv.shape[-1]
    c, n = c3 // 3, window * window
    x = qkv.to(torch.promote_types(qkv.dtype, torch.float32)).view(b, h, w, c3)
    if shift:
        x = torch.roll(x, (-shift, -shift), (1, 2))
    x = x.view(b, h // window, window, w // window, window, c3).transpose(2, 3)
    q, k, v = x.reshape(-1, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    attn = (q * (c // heads) ** -0.5) @ k.transpose(-2, -1) + bias[None]
    if shift:
        mask = shift_mask(h, w, window, shift).to(attn.device)
        attn = (attn.view(b, -1, heads, n, n) + mask[None, :, None]).view(-1, heads, n, n)
    out = (attn.softmax(-1) @ v).transpose(1, 2)
    out = out.reshape(b, h // window, w // window, window, window, c).transpose(2, 3)
    out = out.reshape(b, h, w, c)
    if shift:
        out = torch.roll(out, (shift, shift), (1, 2))
    return out.reshape(b, h * w, c).to(qkv.dtype)


class WindowAttention(torch.autograd.Function):
    """The op by the kernels: the forward saves its inputs, O and the rows'
    log-sum-exp (never P); the backward recomputes P."""

    @staticmethod
    def forward(ctx, qkv, bias, heads, window, shift, grid):
        out, lse = wk.window_attention_cuda(qkv, bias, heads, window, shift, grid)
        ctx.save_for_backward(qkv, bias, out, lse)
        ctx.geometry = (heads, window, shift, grid)
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, bias, out, lse = ctx.saved_tensors
        dqkv, dbias = wk.window_attention_backward_cuda(qkv, bias, out, lse, dout,
                                                        *ctx.geometry)
        return dqkv, dbias, None, None, None, None


def window_attention(qkv, bias, heads: int, window: int, shift: int, grid):
    """The op, by the route of the module docstring."""
    if qkv.is_cuda:
        paths["cuda"] += 1
        return WindowAttention.apply(qkv.contiguous(), bias.contiguous(), heads, window,
                                     shift, tuple(grid))
    paths["cpu"] += 1
    return window_attention_plain(qkv, bias, heads, window, shift, grid)
