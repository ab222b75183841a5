"""Wrapper of GroupNorm's forward kernels (``csrc/group_norm.cu``) and the
route the model's ``GroupNorm`` takes through them.

  ``group_norm(x, weight, bias, groups, eps, out_dtype)``  the route:
      the kernels where no gradient flows through the norm and every tensor
      is a plain CUDA tensor, else torch's ``native_group_norm`` on the f32
      cast (``native_group_norm``)
  ``native_route()``         a context in which every call takes torch's
  ``group_norm_cuda(...)``   the kernels: stats pass → finalise → apply
  ``group_norm_plain(...)``  flax's ``_normalize`` in float64, for the tests
      and for the comparison on the card

The routes, by what the call can observe (each counted in ``paths``):

  - ``x``, ``weight`` or ``bias`` wrapped by ``torch.func`` (the vmap pool
    executor) → native, ``vmap``;
  - inside ``native_route()`` → native, ``remat``: a remat block's forward
    (``models/srresnet.py:RematBlock``) runs without a graph, and its
    backward recomputes the branch with one, by torch's kernel; the forward
    takes the same route, so the activations downstream are the ones the
    gradient is taken at, bit for bit as without remat;
  - a CPU tensor → native, ``cpu`` (the CPU parity tests see torch's bits);
  - grad enabled and one of the three requiring grad (every training step)
    → native, ``grad``: its backward wants the f32 input, mean and rstd
    that ``native_group_norm`` saves;
  - x not of ``out_dtype`` → native, ``cast`` (the model's convs hand the
    norm their compute dtype, so it does not run there);
  - else (serving, scoring under ``torch.no_grad``) → the kernels, ``vec``
    or ``scalar`` by the path they took, and ``launches``.

The kernels read x in its dtype (f32 or bf16), compute in f32 over fp64
sums, and write x's dtype once; for a CUDA tensor they launch or raise,
with no fallback. The ``_launch_*`` functions do the launches for a given
library, the card's or a CPU build of the source
(``tests/test_torch_groupnorm_source.py``).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
import threading

import torch

from srgan_tpu_torch.ops.cuda.build import current_stream, on_device

# Calls of the kernels on the card (stats, finalise and apply count once)
launches = {"group_norm": 0}
# Every call of ``group_norm`` by its route: the kernels' two paths, and the
# native routes
paths = {"vec": 0, "scalar": 0, "grad": 0, "vmap": 0, "remat": 0, "cpu": 0, "cast": 0}
# The kernels' names in the source, and as the profiler prints each
# instance (bf16 and f32, both paths):
# ``h100bench/groups.py`` must file every one under ``groupnorm``
KERNELS = ("group_norm_stats_kernel", "group_norm_finalize_kernel",
           "group_norm_apply_kernel")
PROFILED_NAMES = tuple(
    [f"void (anonymous namespace)::group_norm_stats_kernel<{t}, {v}>"
     f"({t} const*, long, int, double*)"
     for t in ("float", "__nv_bfloat16") for v in ("true", "false")]
    + ["(anonymous namespace)::group_norm_finalize_kernel"
       "(double const*, int, double, float*)"]
    + [f"void (anonymous namespace)::group_norm_apply_kernel<{t}, {v}>"
       f"({t} const*, long, int, int, int, int, float const*, float const*, "
       f"float const*, float, {t}*)"
       for t in ("float", "__nv_bfloat16") for v in ("true", "false")])
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# depth of ``native_route()`` contexts, a thread each
_native = threading.local()


def reset_launches() -> None:
    for counts in (launches, paths):
        for k in counts:
            counts[k] = 0


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.group_norm_chunks.argtypes = [L]
    lib.group_norm_chunks.restype = I
    lib.group_norm_error_string.argtypes = [I]
    lib.group_norm_error_string.restype = ctypes.c_char_p
    lib.group_norm_stats.argtypes = [P, I, L, L, I, P, P]
    lib.group_norm_stats.restype = I
    lib.group_norm_finalize.argtypes = [P, L, L, P, P]
    lib.group_norm_finalize.restype = I
    lib.group_norm_apply.argtypes = [P, I, L, L, I, I, I, P, P, P, ctypes.c_float,
                                     P, P]
    lib.group_norm_apply.restype = I
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from srgan_tpu_torch.ops.cuda.build import load

    return _bind(load("group_norm"))


def _raise_if_failed(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.group_norm_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def _shape(x: torch.Tensor, groups: int):
    """``(rows, L, hw)``: the (image, group) rows, the values a row, the
    values a channel."""
    n, c = x.shape[:2]
    hw = math.prod(x.shape[2:])
    return n * groups, c // groups * hw, hw


def vector_path(x: torch.Tensor, y: torch.Tensor, groups: int) -> bool:
    """Whether the kernels take their 16-byte path: every row of x and y
    starts 16-byte aligned (a row a multiple of 8 values, aligned data)."""
    return (_shape(x, groups)[1] % 8 == 0 and x.data_ptr() % 16 == 0
            and y.data_ptr() % 16 == 0)


def _check(x, weight, bias, groups: int) -> None:
    for t in (x, weight, bias):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"expected CUDA tensors on one device, got {t.device}")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"expected float32 or bfloat16, got {x.dtype}")
    if x.dim() < 2 or x.numel() < 1:
        raise ValueError(f"expected a non-empty (N, C, ...) batch, got {tuple(x.shape)}")
    c = x.shape[1]
    if groups < 1 or c % groups:
        raise ValueError(f"{c} channels do not split into {groups} groups")
    for t in (weight, bias):
        if t.dtype != torch.float32 or t.shape != (c,) or not t.is_contiguous():
            raise ValueError(f"expected contiguous float32 ({c},) scale and bias")


# -------------------------------------------------------- plain versions --


def group_norm_plain(x, weight, bias, groups: int, eps: float):
    """flax's ``_normalize`` in float64: ``(y, mean, var)``, y float64 like
    x, mean and var (N, groups); var = max(0, E[x²] − E[x]²)."""
    n = x.shape[0]
    xg = x.double().reshape(n, groups, -1)
    mean = xg.mean(-1)
    var = ((xg * xg).mean(-1) - mean * mean).clamp_min(0.0)
    y = ((xg - mean[..., None]) * torch.rsqrt(var + eps)[..., None]).reshape(x.shape)
    per_channel = (1, -1) + (1,) * (x.dim() - 2)
    y = y * weight.double().view(per_channel) + bias.double().view(per_channel)
    return y, mean, var


def native_group_norm(x, weight, bias, groups: int, eps: float, out_dtype):
    """torch's own kernel on the f32 cast, rounded to ``out_dtype``: the
    route every gradient, vmap and CPU call takes. ``F.group_norm`` would
    ask for the input's memory format, which ``torch.func.vmap`` cannot
    answer (the vmap pool executor); the bits are the same."""
    x = x.float().contiguous()
    n, c = x.shape[:2]
    y = torch.native_group_norm(x, weight, bias, n, c, x[0, 0].numel(), groups, eps)[0]
    return y.to(out_dtype)


# -------------------------------------------------------------- launches --
# Each takes the library, so that a build of the source for the CPU can be
# driven with CPU tensors; the caller checks the arguments and passes the
# stream (0 there).


def _launch_stats(lib, x, groups: int, vec: bool, stream: int) -> torch.Tensor:
    """The stats pass; returns one fp64 buffer: the (rows, chunks, 2)
    partials, then room for the finalise's (rows, 2) f32 mean and var."""
    rows, row, _ = _shape(x, groups)
    n = rows * lib.group_norm_chunks(row) * 2
    buf = torch.empty(n + rows, dtype=torch.float64, device=x.device)
    rc = lib.group_norm_stats(x.data_ptr(), DTYPE_CODES[x.dtype], rows, row,
                              int(vec), buf.data_ptr(), stream)
    _raise_if_failed(lib, rc, "group_norm_stats")
    return buf


def _launch_finalize(lib, buf, x, groups: int, stream: int) -> torch.Tensor:
    """The finalise; returns the (rows, 2) f32 ``[mean, var]`` it wrote at
    the end of ``buf``."""
    rows, row, _ = _shape(x, groups)
    stats = buf[buf.numel() - rows:].view(torch.float32).view(rows, 2)
    rc = lib.group_norm_finalize(buf.data_ptr(), rows, row, stats.data_ptr(), stream)
    _raise_if_failed(lib, rc, "group_norm_finalize")
    return stats


def _launch_apply(lib, x, stats, weight, bias, groups: int, eps: float, y,
                  vec: bool, stream: int) -> torch.Tensor:
    """The apply pass into ``y`` (x's shape and dtype, contiguous)."""
    rows, row, hw = _shape(x, groups)
    rc = lib.group_norm_apply(
        x.data_ptr(), DTYPE_CODES[x.dtype], rows, row, hw, groups, int(vec),
        stats.data_ptr(), weight.data_ptr(), bias.data_ptr(), eps, y.data_ptr(),
        stream)
    _raise_if_failed(lib, rc, "group_norm_apply")
    return y


# -------------------------------------------------------------- wrappers --


def group_norm_cuda(x, weight, bias, groups: int, eps: float):
    """GroupNorm's forward by the kernels, of x's dtype."""
    _check(x, weight, bias, groups)
    x = x.contiguous()
    y = torch.empty_like(x)
    vec = vector_path(x, y, groups)
    with on_device(x):
        lib, stream = _lib(), current_stream(x)
        buf = _launch_stats(lib, x, groups, vec, stream)
        stats = _launch_finalize(lib, buf, x, groups, stream)
        _launch_apply(lib, x, stats, weight, bias, groups, eps, y, vec, stream)
    launches["group_norm"] += 1
    paths["vec" if vec else "scalar"] += 1
    return y


@contextlib.contextmanager
def native_route():
    """Every ``group_norm`` call of this thread inside takes torch's kernel
    (counted ``remat``)."""
    _native.depth = getattr(_native, "depth", 0) + 1
    try:
        yield
    finally:
        _native.depth -= 1


def group_norm(x, weight, bias, groups: int, eps: float, out_dtype):
    """The model's GroupNorm forward, by the route the module docstring
    lists: the kernels where nothing needs its gradient, else torch's."""
    wrapped = torch._C._functorch.is_functorch_wrapped_tensor
    if wrapped(x) or wrapped(weight) or wrapped(bias):
        route = "vmap"
    elif getattr(_native, "depth", 0):
        route = "remat"
    elif not x.is_cuda:
        route = "cpu"
    elif torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                      or bias.requires_grad):
        route = "grad"
    elif x.dtype != out_dtype:
        route = "cast"
    else:
        return group_norm_cuda(x, weight, bias, groups, eps)
    paths[route] += 1
    return native_group_norm(x, weight, bias, groups, eps, out_dtype)
