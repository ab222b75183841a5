"""Wrappers of the reconstruction-loss kernels K1-K3 (``csrc/recon_loss.cu``)
and their ``torch.autograd.Function``.

  ``edge_stats(hr, group)``           K1 + totals + finalise → stats
  ``loss_sums(hr, sr, stats, group)`` K2 + totals + finalise → (edge_loss, tv_loss)
  ``loss_grad(hr, sr, stats, ge, gt)`` K3 → d loss / d sr

``stats`` is a float32 device vector ``[mean, std, Σe, tv_mean, count]``:
K1's finalise fills the statistics of the raw edge map and the element
count, K2's the sum of the normalized map and the TV mean before the relu.
Every scalar stays on the device, so the forward makes no host sync.

K1 and K2 end in a totals stage (fp64 sums and the count) and a finalise.
With a process ``group`` (``torch.distributed``) the ranks' totals are
summed between the two (``parallel.mesh.sum_over_ranks``: an all_gather,
then a sum in rank order), so every rank finalises the global batch's
statistics and losses, and K3 gives each rank its rows' share of the
global loss's gradient. Without a group the totals go straight to the
finalise; at world size 1 both give the same bits.

Each wrapper launches its kernel for CUDA tensors, adds one to its count in
``launches`` there, and raises if the launch fails; for CPU tensors it runs
its plain version (``*_plain`` below, built from ``ops.recon_loss``). No
path falls back from the kernel to the plain version. Each kernel takes its
16-byte path where every row starts 16-byte aligned (``vector_path``) and
its scalar path otherwise, counted in ``paths``. The ``_launch_*``
functions do the launches for a given library, the card's or a CPU build
of the source (``tests/test_torch_recon_source.py``).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Tuple

import torch

from srgan_tpu_torch.ops import recon_loss
from srgan_tpu_torch.ops.filters import DIFF_KERNEL, depthwise_conv3x3, sobel_edge_map
from srgan_tpu_torch.ops.recon_loss import normalize_edges
from srgan_tpu_torch.parallel.mesh import sum_over_ranks, world_size

# Launches of each kernel on the card (finalise launches included with
# their kernel); CPU calls do not count. ``paths`` splits them by the path
# they took: ``_vec`` the 16-byte loads, ``_scalar`` the others.
launches = {"edge_stats": 0, "loss_sums": 0, "loss_grad": 0}
paths = {f"{name}_{path}": 0 for name in launches for path in ("vec", "scalar")}
# K1's and K2's launches whose totals were summed over a process group
group_sums = {"edge_stats": 0, "loss_sums": 0}
MAX_CHANNELS = 4  # kMaxChannels in the source: a pixel's neighbour lies
                  # in the same or the adjacent lane's float4


def reset_launches() -> None:
    for counts in (launches, paths, group_sums):
        for k in counts:
            counts[k] = 0


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.recon_stats_blocks.argtypes = [I, I, I, I]
    lib.recon_stats_blocks.restype = I
    lib.recon_sums_blocks.argtypes = [I, I, I, I]
    lib.recon_sums_blocks.restype = I
    lib.recon_error_string.argtypes = [I]
    lib.recon_error_string.restype = ctypes.c_char_p
    lib.recon_edge_stats.argtypes = [P, I, I, I, I, I, P, P, P]
    lib.recon_edge_stats.restype = I
    lib.recon_edge_stats_finalize.argtypes = [P, P, P]
    lib.recon_edge_stats_finalize.restype = I
    lib.recon_loss_sums.argtypes = [P, P, I, I, I, I, I, P, P, P, P]
    lib.recon_loss_sums.restype = I
    lib.recon_loss_sums_finalize.argtypes = [P, P, P, P, P]
    lib.recon_loss_sums_finalize.restype = I
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
    """Whether K1-K3 take their 16-byte path for these contiguous NHWC
    tensors: every row starts 16-byte aligned, i.e. W·C % 4 == 0 and each
    tensor's data 16-byte aligned. Others take the scalar path."""
    _, _, w, c = tensors[0].shape
    return (w * c) % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)


# A wrapper's host cost a call sits beside K1's ~0.03 ms on the card, so
# the two helpers below take the cheap routes: the raw handle of the
# current stream, as PyTorch's generated code reads it (a Stream object
# costs ~5 µs more), and the device guard only where another device is
# current (~3 µs).


def _stream(t: torch.Tensor) -> int:
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def _on_device(t: torch.Tensor):
    if t.device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(t.device)


@functools.lru_cache(maxsize=None)
def _blocks(lib, query: str, device: torch.device, shape: torch.Size) -> int:
    """A launch's block count (the size of its partials) from the library's
    ``query`` (``recon_stats_blocks``, ``recon_sums_blocks``): it depends on
    the shape and the device's SM count only, so it is asked once each."""
    return getattr(lib, query)(*shape)


# -------------------------------------------------------- plain versions --


# Without a group they compute in the input's dtype, as ``ops.recon_loss``
# does; with one, as the kernels do: fp64 totals, summed over the ranks,
# then the finalise's arithmetic in fp64.


def _totals(sums, count: int, group) -> torch.Tensor:
    totals = torch.stack([*(x.double() for x in sums),
                          torch.tensor(float(count), dtype=torch.float64,
                                       device=sums[0].device)])
    return sum_over_ranks(totals, group)


def edge_stats_plain(hr: torch.Tensor, group=None) -> torch.Tensor:
    zero = torch.zeros((), dtype=hr.dtype, device=hr.device)
    count = zero + hr.numel()
    if group is None:
        mean, std = recon_loss.edge_stats(hr)
        return torch.stack([mean, std, zero, zero, count])
    e = sobel_edge_map(hr).double()
    t = _totals([e.sum(), (e * e).sum()], hr.numel(), group)
    mean = t[0] / t[2]
    var = (t[1] - t[2] * mean * mean) / (t[2] - 1.0)
    return torch.stack([mean, var.clamp_min(0.0).sqrt(), zero, zero, t[2]]).to(hr.dtype)


def loss_sums_plain(hr, sr, stats, group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    e = normalize_edges(sobel_edge_map(hr), stats[0], stats[1])
    tv = depthwise_conv3x3(sr, DIFF_KERNEL).abs() * (1.0 - e)
    wdiff = (hr - sr).abs() * e
    if group is None:
        esum, tv_mean, edge_loss = e.sum(), tv.mean(), wdiff.sum() / e.sum()
    else:
        t = _totals([wdiff.sum(dtype=torch.float64), e.sum(dtype=torch.float64),
                     tv.sum(dtype=torch.float64)], hr.numel(), group)
        esum, tv_mean, edge_loss = (x.to(hr.dtype) for x in (t[1], t[2] / t[3],
                                                             t[0] / t[1]))
    stats[2], stats[3] = esum, tv_mean
    return edge_loss, torch.relu(tv_mean)


def loss_grad_plain(hr, sr, stats, g_edge, g_tv) -> torch.Tensor:
    e = normalize_edges(sobel_edge_map(hr), stats[0], stats[1])
    c_edge = g_edge / stats[2]
    c_tv = torch.where(stats[3] > 0, g_tv / stats[4], torch.zeros_like(g_tv))
    inner = torch.sign(depthwise_conv3x3(sr, DIFF_KERNEL)) * (1.0 - e)
    # DIFF is symmetric: the transpose of its correlation is itself
    g_tv_field = depthwise_conv3x3(inner, DIFF_KERNEL) * c_tv
    return -torch.sign(hr - sr) * e * c_edge + g_tv_field


# -------------------------------------------------------------- launches --
# Each takes the library, so that a build of the source for the CPU can be
# driven with CPU tensors; the caller checks the arguments and passes the
# stream (0 there).


def _launch_edge_totals(lib, hr, vec: bool, stream: int):
    """K1 + its totals stage; returns ``(totals, stats)``: the fp64
    ``[Σe, Σe², count]`` and the (unwritten) stats vector beside them."""
    b, h, w, c = hr.shape
    # one allocation: the partials, the totals (3 doubles), then stats (5
    # floats in 3 doubles)
    n = _blocks(lib, "recon_stats_blocks", hr.device, hr.shape) * 2
    buf = torch.empty(n + 6, dtype=torch.float64, device=hr.device)
    partials, totals = buf[:n], buf[n:n + 3]
    stats = buf[n + 3:].view(torch.float32)[:5]
    rc = lib.recon_edge_stats(hr.data_ptr(), b, h, w, c, int(vec),
                              partials.data_ptr(), totals.data_ptr(), stream)
    _raise_if_failed(lib, rc, "recon_edge_stats")
    return totals, stats


def _launch_edge_finalize(lib, totals, stats, stream: int) -> torch.Tensor:
    """K1's finalise: ``stats`` from (summed) ``totals``."""
    rc = lib.recon_edge_stats_finalize(totals.data_ptr(), stats.data_ptr(), stream)
    _raise_if_failed(lib, rc, "recon_edge_stats_finalize")
    return stats


def _launch_edge_stats(lib, hr, vec: bool, stream: int, group=None) -> torch.Tensor:
    """K1 + totals, the group's sum of the totals, + finalise; returns
    ``stats``."""
    totals, stats = _launch_edge_totals(lib, hr, vec, stream)
    return _launch_edge_finalize(lib, sum_over_ranks(totals, group), stats, stream)


def _launch_sums_totals(lib, hr, sr, stats, vec: bool, stream: int):
    """K2 + its totals stage; returns ``(totals, losses)``: the fp64
    ``[Σ|hr−sr|·e, Σe, Σtv, count]`` and the (unwritten) pair of losses."""
    b, h, w, c = hr.shape
    # one allocation: the partials, the totals (4 doubles), then the two
    # losses (2 floats in a double)
    n = _blocks(lib, "recon_sums_blocks", hr.device, hr.shape) * 3
    buf = torch.empty(n + 5, dtype=torch.float64, device=hr.device)
    partials, totals = buf[:n], buf[n:n + 4]
    rc = lib.recon_loss_sums(
        hr.data_ptr(), sr.data_ptr(), b, h, w, c, int(vec), partials.data_ptr(),
        stats.data_ptr(), totals.data_ptr(), stream,
    )
    _raise_if_failed(lib, rc, "recon_loss_sums")
    return totals, buf[n + 4:].view(torch.float32)


def _launch_sums_finalize(lib, totals, stats, losses, stream: int):
    """K2's finalise: ``(edge_loss, tv_loss)`` and ``stats[2:4]`` from
    (summed) ``totals``."""
    edge_loss, tv_loss = losses
    rc = lib.recon_loss_sums_finalize(totals.data_ptr(), stats.data_ptr(),
                                      edge_loss.data_ptr(), tv_loss.data_ptr(),
                                      stream)
    _raise_if_failed(lib, rc, "recon_loss_sums_finalize")
    return edge_loss, tv_loss


def _launch_loss_sums(lib, hr, sr, stats, vec: bool, stream: int, group=None):
    """K2 + totals, the group's sum of the totals, + finalise; returns
    ``(edge_loss, tv_loss)`` and writes ``stats[2:4]``."""
    totals, losses = _launch_sums_totals(lib, hr, sr, stats, vec, stream)
    return _launch_sums_finalize(lib, sum_over_ranks(totals, group), stats, losses,
                                 stream)


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


def edge_stats(hr: torch.Tensor, group=None) -> torch.Tensor:
    """K1: ``[mean, std, ·, ·, count]`` of the raw Sobel edge map of ``hr``,
    over the group's batch where ``group`` is given."""
    if not hr.is_cuda:
        return edge_stats_plain(hr, group)
    _check(hr)
    vec = vector_path(hr)
    with _on_device(hr):
        stats = _launch_edge_stats(_lib(), hr, vec, _stream(hr), group)
    launches["edge_stats"] += 1
    group_sums["edge_stats"] += group is not None
    paths["edge_stats_vec" if vec else "edge_stats_scalar"] += 1
    return stats


def loss_sums(hr, sr, stats, group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: ``(edge_loss, tv_loss)``; writes ``stats[2:4]``. Over the group's
    batch where ``group`` is given."""
    if not hr.is_cuda:
        return loss_sums_plain(hr, sr, stats, group)
    _check(hr, sr)
    vec = vector_path(hr, sr)
    with _on_device(hr):
        out = _launch_loss_sums(_lib(), hr, sr, stats, vec, _stream(hr), group)
    launches["loss_sums"] += 1
    group_sums["loss_sums"] += group is not None
    paths["loss_sums_vec" if vec else "loss_sums_scalar"] += 1
    return out


def loss_grad(hr, sr, stats, g_edge, g_tv) -> torch.Tensor:
    """K3: d(g_edge·edge_loss + g_tv·tv_loss)/d sr, NHWC like ``sr``."""
    if not hr.is_cuda:
        return loss_grad_plain(hr, sr, stats, g_edge, g_tv)
    _check(hr, sr)
    vec = vector_path(hr, sr)  # dsr is a fresh, aligned allocation
    with _on_device(hr):
        dsr = _launch_loss_grad(_lib(), hr, sr, stats, g_edge, g_tv, vec, _stream(hr))
    launches["loss_grad"] += 1
    paths["loss_grad_vec" if vec else "loss_grad_scalar"] += 1
    return dsr


class ReconstructionLoss(torch.autograd.Function):
    """``(edge_loss, tv_loss)`` with a kernel forward (K1 → K2) and a kernel
    backward (K3). ``hr`` is data and gets no gradient. On CPU tensors the
    same three steps run their plain versions.

    With a process ``group`` of P ranks the losses are the global batch's
    on every rank, and the backward returns P times this rank's share of
    their gradient: the ranks' parameter gradients are then AVERAGED, as
    every other gradient of a step is (``parallel.mesh.average_grads``), and
    the average is the global loss's gradient. At P = 1 nothing is scaled."""

    @staticmethod
    def forward(ctx, hr, sr, group=None):
        stats = edge_stats(hr, group)
        edge_loss, tv_loss = loss_sums(hr, sr, stats, group)
        ctx.save_for_backward(hr, sr, stats)
        ctx.world = 1 if group is None else world_size(group)
        return edge_loss, tv_loss

    @staticmethod
    def backward(ctx, g_edge, g_tv):
        hr, sr, stats = ctx.saved_tensors
        zero = torch.zeros((), dtype=sr.dtype, device=sr.device)
        g_edge = zero if g_edge is None else g_edge
        g_tv = zero if g_tv is None else g_tv
        if ctx.world > 1:
            g_edge, g_tv = g_edge * ctx.world, g_tv * ctx.world
        return None, loss_grad(hr, sr, stats, g_edge, g_tv), None
