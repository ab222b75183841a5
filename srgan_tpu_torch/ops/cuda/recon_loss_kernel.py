"""Wrappers of the reconstruction-loss kernels K1-K3 (``csrc/recon_loss.cu``)
and their ``torch.autograd.Function``.

  ``edge_stats(hr)``                  K1 + finalise → stats
  ``loss_sums(hr, sr, stats)``        K2 + finalise → (edge_loss, tv_loss)
  ``loss_grad(hr, sr, stats, ge, gt)`` K3 → d loss / d sr

``stats`` is a float32 device vector ``[mean, std, Σe, tv_mean]``: K1 fills
the first two (statistics of the raw edge map), K2 the last two (sum of
the normalized map, the TV mean before the relu). Every scalar stays on the
device, so the forward makes no host sync.

Each wrapper launches its kernel for CUDA tensors, adds one to its count in
``launches`` there, and raises if the launch fails; for CPU tensors it runs
its plain version (``*_plain`` below, built from ``ops.recon_loss``). No
path falls back from the kernel to the plain version. K2 and K3 take their
16-byte path where every row starts 16-byte aligned (``vector_path``) and
their scalar path otherwise, counted in ``paths``. The ``_launch_*``
functions do the launches for a given library, the card's or a CPU build
of the source (``tests/test_torch_recon_source.py``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from srgan_tpu_torch.ops import recon_loss
from srgan_tpu_torch.ops.filters import DIFF_KERNEL, depthwise_conv3x3, sobel_edge_map
from srgan_tpu_torch.ops.recon_loss import normalize_edges

# Launches of each kernel on the card (finalise launches included with
# their kernel); CPU calls do not count. ``paths`` splits K2's and K3's by
# the path they took: ``_vec`` the 16-byte loads, ``_scalar`` the others.
launches = {"edge_stats": 0, "loss_sums": 0, "loss_grad": 0}
paths = {"loss_sums_vec": 0, "loss_sums_scalar": 0,
         "loss_grad_vec": 0, "loss_grad_scalar": 0}
MAX_CHANNELS = 4  # kMaxChannels in the source: bounds the shared memory


def reset_launches() -> None:
    for counts in (launches, paths):
        for k in counts:
            counts[k] = 0


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.recon_fwd_blocks.argtypes = [I, I, I]
    lib.recon_fwd_blocks.restype = I
    lib.recon_sums_blocks.argtypes = [I, I, I, I]
    lib.recon_sums_blocks.restype = I
    lib.recon_error_string.argtypes = [I]
    lib.recon_error_string.restype = ctypes.c_char_p
    lib.recon_edge_stats.argtypes = [P, I, I, I, I, P, P, P]
    lib.recon_edge_stats.restype = I
    lib.recon_loss_sums.argtypes = [P, P, I, I, I, I, I, P, P, P, P, P]
    lib.recon_loss_sums.restype = I
    lib.recon_loss_grad.argtypes = [P, P, I, I, I, I, I, P, P, P, P, P]
    lib.recon_loss_grad.restype = I
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from srgan_tpu_torch.ops.cuda.build import load

    return _bind(load("recon_loss"))


def _raise_if_failed(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.recon_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def _check(*tensors: torch.Tensor) -> None:
    shape, device = tensors[0].shape, tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != device:
            raise ValueError(f"expected CUDA tensors on one device, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"expected float32, got {t.dtype}")
        if t.dim() != 4 or t.shape != shape:
            raise ValueError(f"expected matching NHWC batches, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError("expected contiguous NHWC tensors")
    if not 1 <= shape[-1] <= MAX_CHANNELS:
        raise ValueError(f"channels must be 1..{MAX_CHANNELS}, got {shape[-1]}")


def vector_path(*tensors: torch.Tensor) -> bool:
    """Whether K2 / K3 take their 16-byte path for these contiguous NHWC
    tensors: every row starts 16-byte aligned, i.e. W·C % 4 == 0 and each
    tensor's data 16-byte aligned. Others take the scalar path."""
    _, _, w, c = tensors[0].shape
    return (w * c) % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# -------------------------------------------------------- plain versions --


def edge_stats_plain(hr: torch.Tensor) -> torch.Tensor:
    mean, std = recon_loss.edge_stats(hr)
    zero = torch.zeros_like(mean)
    return torch.stack([mean, std, zero, zero])


def loss_sums_plain(hr, sr, stats) -> Tuple[torch.Tensor, torch.Tensor]:
    e = normalize_edges(sobel_edge_map(hr), stats[0], stats[1])
    esum = e.sum()
    tv_mean = (depthwise_conv3x3(sr, DIFF_KERNEL).abs() * (1.0 - e)).mean()
    stats[2], stats[3] = esum, tv_mean
    return ((hr - sr).abs() * e).sum() / esum, torch.relu(tv_mean)


def loss_grad_plain(hr, sr, stats, g_edge, g_tv) -> torch.Tensor:
    e = normalize_edges(sobel_edge_map(hr), stats[0], stats[1])
    c_edge = g_edge / stats[2]
    c_tv = torch.where(stats[3] > 0, g_tv / sr.numel(), torch.zeros_like(g_tv))
    inner = torch.sign(depthwise_conv3x3(sr, DIFF_KERNEL)) * (1.0 - e)
    # DIFF is symmetric: the transpose of its correlation is itself
    g_tv_field = depthwise_conv3x3(inner, DIFF_KERNEL) * c_tv
    return -torch.sign(hr - sr) * e * c_edge + g_tv_field


# -------------------------------------------------------------- launches --
# Each takes the library, so that a build of the source for the CPU can be
# driven with CPU tensors; the caller checks the arguments and passes the
# stream (0 there).


def _launch_edge_stats(lib, hr, stream: int) -> torch.Tensor:
    """K1 + finalise; returns ``stats``."""
    b, h, w, c = hr.shape
    partials = torch.empty(lib.recon_fwd_blocks(b, h, w) * 2, dtype=torch.float64,
                           device=hr.device)
    stats = torch.empty(4, dtype=torch.float32, device=hr.device)
    rc = lib.recon_edge_stats(hr.data_ptr(), b, h, w, c, partials.data_ptr(),
                              stats.data_ptr(), stream)
    _raise_if_failed(lib, rc, "recon_edge_stats")
    return stats


def _launch_loss_sums(lib, hr, sr, stats, vec: bool, stream: int):
    """K2 + finalise; returns ``(edge_loss, tv_loss)`` and writes ``stats[2:4]``."""
    b, h, w, c = hr.shape
    partials = torch.empty(lib.recon_sums_blocks(b, h, w, c) * 3,
                           dtype=torch.float64, device=hr.device)
    edge_loss = torch.empty((), dtype=torch.float32, device=hr.device)
    tv_loss = torch.empty((), dtype=torch.float32, device=hr.device)
    rc = lib.recon_loss_sums(
        hr.data_ptr(), sr.data_ptr(), b, h, w, c, int(vec), partials.data_ptr(),
        stats.data_ptr(), edge_loss.data_ptr(), tv_loss.data_ptr(), stream,
    )
    _raise_if_failed(lib, rc, "recon_loss_sums")
    return edge_loss, tv_loss


def _launch_loss_grad(lib, hr, sr, stats, g_edge, g_tv, vec: bool,
                      stream: int) -> torch.Tensor:
    """K3; returns d loss / d sr."""
    b, h, w, c = hr.shape
    scalars = [
        g.detach().to(device=hr.device, dtype=torch.float32).reshape(())
        .contiguous()
        for g in (g_edge, g_tv)
    ]
    dsr = torch.empty_like(sr)
    rc = lib.recon_loss_grad(
        hr.data_ptr(), sr.data_ptr(), b, h, w, c, int(vec), stats.data_ptr(),
        scalars[0].data_ptr(), scalars[1].data_ptr(), dsr.data_ptr(), stream,
    )
    _raise_if_failed(lib, rc, "recon_loss_grad")
    return dsr


# -------------------------------------------------------------- wrappers --


def edge_stats(hr: torch.Tensor) -> torch.Tensor:
    """K1: ``[mean, std, ·, ·]`` of the raw Sobel edge map of ``hr``."""
    if not hr.is_cuda:
        return edge_stats_plain(hr)
    _check(hr)
    with torch.cuda.device(hr.device):
        stats = _launch_edge_stats(_lib(), hr, _stream(hr))
    launches["edge_stats"] += 1
    return stats


def loss_sums(hr, sr, stats) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: ``(edge_loss, tv_loss)``; writes ``stats[2:4]``."""
    if not hr.is_cuda:
        return loss_sums_plain(hr, sr, stats)
    _check(hr, sr)
    vec = vector_path(hr, sr)
    with torch.cuda.device(hr.device):
        out = _launch_loss_sums(_lib(), hr, sr, stats, vec, _stream(hr))
    launches["loss_sums"] += 1
    paths["loss_sums_vec" if vec else "loss_sums_scalar"] += 1
    return out


def loss_grad(hr, sr, stats, g_edge, g_tv) -> torch.Tensor:
    """K3: d(g_edge·edge_loss + g_tv·tv_loss)/d sr, NHWC like ``sr``."""
    if not hr.is_cuda:
        return loss_grad_plain(hr, sr, stats, g_edge, g_tv)
    _check(hr, sr)
    vec = vector_path(hr, sr)  # dsr is a fresh, aligned allocation
    with torch.cuda.device(hr.device):
        dsr = _launch_loss_grad(_lib(), hr, sr, stats, g_edge, g_tv, vec, _stream(hr))
    launches["loss_grad"] += 1
    paths["loss_grad_vec" if vec else "loss_grad_scalar"] += 1
    return dsr


class ReconstructionLoss(torch.autograd.Function):
    """``(edge_loss, tv_loss)`` with a kernel forward (K1 → K2) and a kernel
    backward (K3). ``hr`` is data and gets no gradient."""

    @staticmethod
    def forward(ctx, hr, sr):
        stats = edge_stats(hr)
        edge_loss, tv_loss = loss_sums(hr, sr, stats)
        ctx.save_for_backward(hr, sr, stats)
        return edge_loss, tv_loss

    @staticmethod
    def backward(ctx, g_edge, g_tv):
        hr, sr, stats = ctx.saved_tensors
        zero = torch.zeros((), dtype=torch.float32, device=sr.device)
        dsr = loss_grad(
            hr, sr, stats,
            zero if g_edge is None else g_edge,
            zero if g_tv is None else g_tv,
        )
        return None, dsr
