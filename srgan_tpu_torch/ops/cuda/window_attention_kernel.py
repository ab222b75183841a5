"""Wrapper of SwinIR's windowed attention kernels (``csrc/window_attention.cu``).

  ``window_attention_cuda(qkv, bias, heads, window, shift, grid)``
      the forward: ``(out, lse)``
  ``window_attention_backward_cuda(qkv, bias, out, lse, dout, heads, window,
      shift, grid)``  the backward: ``(dqkv, dbias)``

``grid`` is ``(B, H, W)``, the image the tokens of ``qkv`` (B, H·W, 3C)
tile in row-major order; ``bias`` is (heads, N, N) float32, N = window². The
kernels take f32 or bf16 ``qkv``, compute in f32 and write the input's
dtype; a call on CUDA tensors launches or raises, with no fallback.

The design follows qkv's dtype (``DESIGNS``): bf16 runs the tensor-core
kernels (``window_attn_fwd_mma_kernel``, ``window_attn_bwd_mma_kernel``:
the products on ``mma.sync``, P and dS fed as a bf16 hi and lo term each, so
the op still computes in f32), f32 the CUDA-core kernels
(``window_attn_fwd_kernel``, ``window_attn_bwd_kernel``), which tensor cores
would round to bf16 or TF32. Both backwards sum dBias's partials with
``window_attn_dbias_kernel``. Each forward and backward counts once in
``launches["forward"]`` / ``["backward"]`` and once under its design
(``forward_mma``, ``backward_mma``, ``forward_simt``, ``backward_simt``):
a bf16 SwinIR-M step counts 36 + 36 mma and no simt. The library is built
by the first call that needs it, not by ``build()``'s default set. The
``_launch_*`` functions take the library, so that a CPU build of the source
can be driven with CPU tensors (``tests/test_torch_window_attn_source.py``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from srgan_tpu_torch.ops.cuda.build import current_stream, on_device

launches = {"forward": 0, "backward": 0, "forward_mma": 0, "backward_mma": 0,
            "forward_simt": 0, "backward_simt": 0}
# The kernels each design launches, by name: ``h100bench/groups.py`` files
# none of them in a group
KERNELS_BY_DESIGN = {
    "simt": ("window_attn_fwd_kernel", "window_attn_bwd_kernel", "window_attn_dbias_kernel"),
    "mma": ("window_attn_fwd_mma_kernel", "window_attn_bwd_mma_kernel",
            "window_attn_dbias_kernel"),
}
KERNELS = tuple(dict.fromkeys(k for names in KERNELS_BY_DESIGN.values() for k in names))
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
DESIGNS = {torch.float32: "simt", torch.bfloat16: "mma"}
MAX_HEAD_DIM = 32
MAX_TOKENS = 64


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.window_attn_error_string.argtypes = [I]
    lib.window_attn_error_string.restype = ctypes.c_char_p
    lib.window_attn_groups.argtypes = [I, I, I, I]
    lib.window_attn_groups.restype = I
    lib.window_attn_forward.argtypes = [P, I, P, I, I, I, I, I, I, I, F, P, P, P]
    lib.window_attn_forward.restype = I
    lib.window_attn_backward.argtypes = [P, P, P, P, P, I, I, I, I, I, I, I, I, F, P, P, P, P]
    lib.window_attn_backward.restype = I
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from srgan_tpu_torch.ops.cuda.build import load

    return _bind(load("window_attention"))


def _raise_if_failed(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.window_attn_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def _dims(qkv: torch.Tensor, heads: int, window: int, grid) -> tuple:
    """``(windows, N, head_dim)`` of a call."""
    b, h, w = grid
    return b * (h // window) * (w // window), window * window, qkv.shape[-1] // 3 // heads


def _check(qkv, bias, heads: int, window: int, shift: int, grid) -> None:
    b, h, w = grid
    c3 = qkv.shape[-1]
    for t in (qkv, bias):
        if t.device != qkv.device:
            raise ValueError(f"expected tensors on one device, got {t.device}")
    if qkv.dtype not in DTYPE_CODES or not qkv.is_contiguous():
        raise TypeError(f"expected contiguous float32 or bfloat16 qkv, got {qkv.dtype}")
    if qkv.shape != (b, h * w, c3) or c3 % (3 * heads):
        raise ValueError(f"qkv {tuple(qkv.shape)} is not ({b}, {h * w}, 3 x {heads} heads x d)")
    n, d = window * window, c3 // 3 // heads
    if n > MAX_TOKENS or d > MAX_HEAD_DIM or h % window or w % window or not 0 <= shift < window:
        raise ValueError(f"window {window}, shift {shift}, head dim {d} over ({h}, {w}): the "
                         f"kernels take windows of up to {MAX_TOKENS} tokens tiling the image, "
                         f"0 <= shift < window and heads of up to {MAX_HEAD_DIM}")
    if (bias.dtype != torch.float32 or bias.shape != (heads, n, n)
            or not bias.is_contiguous()):
        raise ValueError(f"expected contiguous float32 ({heads}, {n}, {n}) bias")


# -------------------------------------------------------------- launches --
# Each takes the library, so that a build of the source for the CPU can be
# driven with CPU tensors; the caller checks the arguments and passes the
# stream (0 there).


def _launch_forward(lib, qkv, bias, heads: int, window: int, shift: int, grid, stream: int):
    windows, n, d = _dims(qkv, heads, window, grid)
    out = torch.empty((*qkv.shape[:2], heads * d), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((windows, heads, n), dtype=torch.float32, device=qkv.device)
    rc = lib.window_attn_forward(qkv.data_ptr(), DTYPE_CODES[qkv.dtype], bias.data_ptr(),
                                 *grid, window, shift, heads, d, d ** -0.5,
                                 out.data_ptr(), lse.data_ptr(), stream)
    _raise_if_failed(lib, rc, "window_attn_forward")
    return out, lse


def _launch_backward(lib, qkv, bias, out, lse, dout, heads: int, window: int, shift: int,
                     grid, stream: int):
    _, n, d = _dims(qkv, heads, window, grid)
    groups = lib.window_attn_groups(*grid, window)
    dqkv = torch.empty_like(qkv)
    partials = torch.empty((groups, heads, n, n), dtype=torch.float32, device=qkv.device)
    dbias = torch.empty((heads, n, n), dtype=torch.float32, device=qkv.device)
    rc = lib.window_attn_backward(
        qkv.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(), bias.data_ptr(),
        DTYPE_CODES[qkv.dtype], *grid, window, shift, heads, d, d ** -0.5, dqkv.data_ptr(),
        partials.data_ptr(), dbias.data_ptr(), stream)
    _raise_if_failed(lib, rc, "window_attn_backward")
    return dqkv, dbias


# -------------------------------------------------------------- wrappers --


def window_attention_cuda(qkv, bias, heads: int, window: int, shift: int, grid):
    """The forward by the kernels: ``(out, lse)``, out (B, H·W, C) of qkv's
    dtype, lse (windows, heads, N) float32."""
    if not qkv.is_cuda:
        raise ValueError(f"expected CUDA tensors, got {qkv.device}")
    _check(qkv, bias, heads, window, shift, grid)
    with on_device(qkv):
        out_lse = _launch_forward(_lib(), qkv, bias, heads, window, shift, grid,
                                  current_stream(qkv))
    launches["forward"] += 1
    launches[f"forward_{DESIGNS[qkv.dtype]}"] += 1
    return out_lse


def window_attention_backward_cuda(qkv, bias, out, lse, dout, heads: int, window: int,
                                   shift: int, grid):
    """The backward by the kernels: ``(dqkv, dbias)``."""
    _check(qkv, bias, heads, window, shift, grid)
    dout = dout.to(qkv.dtype).contiguous()
    with on_device(qkv):
        grads = _launch_backward(_lib(), qkv, bias, out, lse, dout, heads, window, shift,
                                 grid, current_stream(qkv))
    launches["backward"] += 1
    launches[f"backward_{DESIGNS[qkv.dtype]}"] += 1
    return grads
