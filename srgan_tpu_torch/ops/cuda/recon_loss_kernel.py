"""Wrappers of the reconstruction-loss kernels K1-K3 (``csrc/recon_loss.cu``)
and their ``torch.autograd.Function``.

  ``edge_stats(hr, group)``           K1 + totals + finalise → stats
  ``loss_sums(hr, sr, stats, group)`` K2 + totals + finalise → (edge_loss, tv_loss)
  ``loss_grad(hr, sr, stats, ge, gt)`` K3 → d loss / d sr

``stats`` is a float32 device vector ``[mean, std, Σe, tv_mean, count]``:
K1's finalise fills the statistics of the raw edge map and the element
count, K2's the sum of the normalized map and the TV mean before the relu.
Every scalar stays on the device, so the forward makes no host sync.

The member axis (the vmap pool executor: N generators' SR against one HR):

  ``loss_sums_pooled(hr, sr, stats, group)``  K2 over sr (N, B, H, W, C) in
      one launch → ``(edge_loss (N,), tv_loss (N,), stats (N, 5))``
  ``loss_grad_pooled(hr, sr, stats, ge, gt)`` K3 in one launch, (N,)
      cotangents → d loss / d sr (N, B, H, W, C)

Member i's numbers are the bits of K2/K3 on ``sr[i]`` alone (the same
block partition and fixed-order sums a member); K1 runs once, on ``hr``.
``ReconstructionLoss``'s ``vmap`` rule calls them through
``PooledReconstructionLoss`` when only ``sr`` carries the vmapped dimension.

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

import ctypes
import functools
from typing import Tuple

import torch

from srgan_tpu_torch.ops import recon_loss
from srgan_tpu_torch.ops.cuda.build import current_stream as _stream
from srgan_tpu_torch.ops.cuda.build import on_device as _on_device
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
# K2's and K3's launches over a member axis (counted in ``launches`` too)
pooled = {"loss_sums": 0, "loss_grad": 0}
MAX_CHANNELS = 4  # kMaxChannels in the source: a pixel's neighbour lies
                  # in the same or the adjacent lane's float4


def reset_launches() -> None:
    for counts in (launches, paths, group_sums, pooled):
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
    lib.recon_loss_sums_pooled.argtypes = [P, P, I, I, I, I, I, I, P, P, P, P]
    lib.recon_loss_sums_pooled.restype = I
    lib.recon_loss_sums_finalize_pooled.argtypes = [P, P, P, P, P, I, P]
    lib.recon_loss_sums_finalize_pooled.restype = I
    lib.recon_loss_grad_pooled.argtypes = [P, P, I, I, I, I, I, I, P, P, P, P, P]
    lib.recon_loss_grad_pooled.restype = I
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


def _check_pooled(hr: torch.Tensor, sr: torch.Tensor) -> None:
    """hr (B, H, W, C) and the members' sr (N, B, H, W, C)."""
    if sr.dim() != 5 or sr.shape[1:] != hr.shape:
        raise ValueError(f"expected sr (N, *{tuple(hr.shape)}), got {tuple(sr.shape)}")
    _check(hr, sr[0])
    if not sr.is_contiguous():
        raise ValueError("expected contiguous members' sr")


def vector_path(*tensors: torch.Tensor) -> bool:
    """Whether K1-K3 take their 16-byte path for these contiguous NHWC
    tensors: every row starts 16-byte aligned, i.e. W·C % 4 == 0 and each
    tensor's data 16-byte aligned. Others take the scalar path."""
    w, c = tensors[0].shape[-2:]
    return (w * c) % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)


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


def _members(x: torch.Tensor) -> torch.Tensor:
    """An (N,) vector shaped to broadcast over (N, B, H, W, C)."""
    return x.reshape(-1, 1, 1, 1, 1)


def loss_sums_pooled_plain(hr, sr, stats, group=None):
    """``loss_sums_plain`` of each member's ``sr[i]`` against the shared
    ``hr``: ``(edge_loss (N,), tv_loss (N,), stats (N, 5))``, each member's
    stats row K1's with its own Σe and TV mean. The sums as the
    single-member version takes them: in the input's dtype without a group,
    fp64 totals summed over the ranks with one."""
    n = sr.shape[0]
    e = normalize_edges(sobel_edge_map(hr), stats[0], stats[1])
    tv = depthwise_conv3x3(sr.flatten(0, 1), DIFF_KERNEL).view_as(sr).abs() * (1.0 - e)
    wdiff = (hr - sr).abs() * e
    dims = (1, 2, 3, 4)
    if group is None:
        esum = e.sum().expand(n)
        tv_mean, edge_loss = tv.mean(dims), wdiff.sum(dims) / esum
    else:
        f64 = torch.float64
        sums = torch.stack([wdiff.sum(dims, dtype=f64), e.sum(dtype=f64).expand(n),
                            tv.sum(dims, dtype=f64),
                            torch.full((n,), float(hr.numel()), dtype=f64,
                                       device=hr.device)], 1)
        t = sum_over_ranks(sums, group)
        esum, tv_mean, edge_loss = (x.to(hr.dtype) for x in (t[:, 1], t[:, 2] / t[:, 3],
                                                             t[:, 0] / t[:, 1]))
    rows = stats.expand(n, 5).clone()
    rows[:, 2], rows[:, 3] = esum, tv_mean
    return edge_loss, torch.relu(tv_mean), rows


def loss_grad_pooled_plain(hr, sr, stats, g_edge, g_tv) -> torch.Tensor:
    """``loss_grad_plain`` of each member: ``sr`` (N, B, H, W, C), ``stats``
    (N, 5), ``g_edge`` and ``g_tv`` (N,)."""
    e = normalize_edges(sobel_edge_map(hr), stats[0, 0], stats[0, 1])
    c_edge = _members(g_edge / stats[:, 2])
    c_tv = _members(torch.where(stats[:, 3] > 0, g_tv / stats[:, 4],
                                torch.zeros_like(g_tv)))
    flat = sr.flatten(0, 1)
    inner = torch.sign(depthwise_conv3x3(flat, DIFF_KERNEL)) * (1.0 - e.repeat(sr.shape[0], 1, 1, 1))
    g_tv_field = depthwise_conv3x3(inner, DIFF_KERNEL).view_as(sr) * c_tv
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


def _launch_sums_totals_pooled(lib, hr, sr, stats, vec: bool, stream: int):
    """K2 over the members + the totals stage (one block a member); returns
    ``(totals, out)``: the fp64 (N, 4) totals and 7N unwritten floats, the
    two (N,) losses and the (N, 5) stats rows."""
    n = sr.shape[0]
    b, h, w, c = hr.shape
    k = _blocks(lib, "recon_sums_blocks", hr.device, hr.shape) * 3
    buf = torch.empty(n * (k + 4), dtype=torch.float64, device=hr.device)
    partials, totals = buf[:n * k], buf[n * k:].view(n, 4)
    rc = lib.recon_loss_sums_pooled(
        hr.data_ptr(), sr.data_ptr(), n, b, h, w, c, int(vec), partials.data_ptr(),
        stats.data_ptr(), totals.data_ptr(), stream,
    )
    _raise_if_failed(lib, rc, "recon_loss_sums_pooled")
    return totals, torch.empty(7 * n, dtype=torch.float32, device=hr.device)


def _launch_sums_finalize_pooled(lib, totals, stats, out, stream: int):
    """K2's finalise, one thread a member: ``(edge_loss, tv_loss, rows)``
    from (summed) ``totals`` and K1's ``stats``."""
    n = totals.shape[0]
    edge_loss, tv_loss, rows = out[:n], out[n:2 * n], out[2 * n:].view(n, 5)
    rc = lib.recon_loss_sums_finalize_pooled(
        totals.data_ptr(), stats.data_ptr(), rows.data_ptr(), edge_loss.data_ptr(),
        tv_loss.data_ptr(), n, stream)
    _raise_if_failed(lib, rc, "recon_loss_sums_finalize_pooled")
    return edge_loss, tv_loss, rows


def _launch_loss_sums_pooled(lib, hr, sr, stats, vec: bool, stream: int, group=None):
    """K2 over the members + totals, the group's sum of the (N, 4) totals, +
    finalise; returns ``(edge_loss (N,), tv_loss (N,), stats (N, 5))``."""
    totals, out = _launch_sums_totals_pooled(lib, hr, sr, stats, vec, stream)
    return _launch_sums_finalize_pooled(lib, sum_over_ranks(totals, group), stats,
                                        out, stream)


def _launch_loss_grad_pooled(lib, hr, sr, stats, g_edge, g_tv, vec: bool,
                             stream: int) -> torch.Tensor:
    """K3 over the members; ``stats`` (N, 5), ``g_edge``/``g_tv`` (N,)."""
    n = sr.shape[0]
    b, h, w, c = hr.shape
    scalars = [g.detach().to(device=hr.device, dtype=torch.float32).reshape(n)
               .contiguous() for g in (g_edge, g_tv)]
    dsr = torch.empty_like(sr)
    rc = lib.recon_loss_grad_pooled(
        hr.data_ptr(), sr.data_ptr(), n, b, h, w, c, int(vec), stats.data_ptr(),
        scalars[0].data_ptr(), scalars[1].data_ptr(), dsr.data_ptr(), stream,
    )
    _raise_if_failed(lib, rc, "recon_loss_grad_pooled")
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


def loss_sums_pooled(hr, sr, stats, group=None):
    """K2 over the members' ``sr`` (N, B, H, W, C) in one launch: ``(edge_loss
    (N,), tv_loss (N,), stats (N, 5))``. Over the group's batch where
    ``group`` is given."""
    if not hr.is_cuda:
        return loss_sums_pooled_plain(hr, sr, stats, group)
    _check_pooled(hr, sr)
    vec = vector_path(hr, sr)
    with _on_device(hr):
        out = _launch_loss_sums_pooled(_lib(), hr, sr, stats, vec, _stream(hr), group)
    launches["loss_sums"] += 1
    pooled["loss_sums"] += 1
    group_sums["loss_sums"] += group is not None
    paths["loss_sums_vec" if vec else "loss_sums_scalar"] += 1
    return out


def loss_grad_pooled(hr, sr, stats, g_edge, g_tv) -> torch.Tensor:
    """K3 over the members in one launch: d(Σ_i g_edge[i]·edge_loss[i] +
    g_tv[i]·tv_loss[i]) / d sr, (N, B, H, W, C) like ``sr``."""
    if not hr.is_cuda:
        return loss_grad_pooled_plain(hr, sr, stats, g_edge, g_tv)
    _check_pooled(hr, sr)
    vec = vector_path(hr, sr)
    with _on_device(hr):
        dsr = _launch_loss_grad_pooled(_lib(), hr, sr, stats, g_edge, g_tv, vec,
                                       _stream(hr))
    launches["loss_grad"] += 1
    pooled["loss_grad"] += 1
    paths["loss_grad_vec" if vec else "loss_grad_scalar"] += 1
    return dsr


def _cotangents(ctx, g_edge, g_tv, like):
    """The incoming gradients, zeros where None, scaled by the world size
    (see ``ReconstructionLoss``)."""
    g_edge = torch.zeros_like(like) if g_edge is None else g_edge
    g_tv = torch.zeros_like(like) if g_tv is None else g_tv
    if ctx.world > 1:
        g_edge, g_tv = g_edge * ctx.world, g_tv * ctx.world
    return g_edge, g_tv


def _setup(ctx, inputs, output):
    hr, sr, group = inputs
    stats = output[2]
    ctx.mark_non_differentiable(stats)
    ctx.save_for_backward(hr, sr, stats)
    ctx.world = 1 if group is None else world_size(group)


class ReconstructionLoss(torch.autograd.Function):
    """``(edge_loss, tv_loss, stats)`` with a kernel forward (K1 → K2) and a
    kernel backward (K3); ``stats`` (see above) is returned for the backward
    and takes no gradient. ``hr`` is data and gets no gradient. On CPU
    tensors the same three steps run their plain versions.

    With a process ``group`` of P ranks the losses are the global batch's
    on every rank, and the backward returns P times this rank's share of
    their gradient: the ranks' parameter gradients are then AVERAGED, as
    every other gradient of a step is (``parallel.mesh.average_grads``), and
    the average is the global loss's gradient. At P = 1 nothing is scaled.

    Under ``torch.func.vmap`` with only ``sr`` batched (the members of a
    pool against one HR batch), the rule runs ``PooledReconstructionLoss``:
    one K1, one K2 and one K3 launch for all members, on every device
    through the same wrappers."""

    @staticmethod
    def forward(hr, sr, group=None):
        stats = edge_stats(hr, group)
        edge_loss, tv_loss = loss_sums(hr, sr, stats, group)
        return edge_loss, tv_loss, stats

    setup_context = staticmethod(_setup)

    @staticmethod
    def backward(ctx, g_edge, g_tv, _):
        hr, sr, stats = ctx.saved_tensors
        zero = torch.zeros((), dtype=sr.dtype, device=sr.device)
        g_edge, g_tv = _cotangents(ctx, g_edge, g_tv, zero)
        return None, loss_grad(hr, sr, stats, g_edge, g_tv), None

    @staticmethod
    def vmap(info, in_dims, hr, sr, group=None):
        hr_dim, sr_dim, _ = in_dims
        if hr_dim is not None:
            raise NotImplementedError(
                "ReconstructionLoss under vmap takes a batched sr against one hr "
                "(the pool's members); hr carries the vmapped dimension here")
        out = PooledReconstructionLoss.apply(hr, sr.movedim(sr_dim, 0), group)
        return out, (0, 0, 0)


class PooledReconstructionLoss(torch.autograd.Function):
    """``ReconstructionLoss`` of N members' ``sr`` (N, B, H, W, C) against
    one ``hr``: ``(edge_loss (N,), tv_loss (N,), stats (N, 5))``. K1 once on
    ``hr`` (the shared edge statistics), K2 and K3 one launch each over the
    members; each member's numbers are those of ``ReconstructionLoss`` on
    ``sr[i]``, on the card bit for bit. The group as there."""

    @staticmethod
    def forward(hr, sr, group=None):
        stats = edge_stats(hr, group)
        return loss_sums_pooled(hr, sr.contiguous(), stats, group)

    setup_context = staticmethod(_setup)

    @staticmethod
    def backward(ctx, g_edge, g_tv, _):
        hr, sr, stats = ctx.saved_tensors
        zeros = torch.zeros(sr.shape[0], dtype=sr.dtype, device=sr.device)
        g_edge, g_tv = _cotangents(ctx, g_edge, g_tv, zeros)
        return None, loss_grad_pooled(hr, sr.contiguous(), stats, g_edge, g_tv), None
