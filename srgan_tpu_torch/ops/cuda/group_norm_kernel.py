"""Wrapper of GroupNorm's kernels (``csrc/group_norm.cu``) and the route
the model's ``GroupNorm`` takes through them.

  ``group_norm(x, weight, bias, groups, eps, out_dtype)``  the route:
      channels-last CUDA input → the NHWC kernels, forward and backward
      (``GroupNormNHWC``); NCHW input → the NCHW forward kernels where no
      gradient flows, else torch's ``native_group_norm`` on the f32 cast
  ``group_norm_nhwc(...)``   the NHWC forward: sums → finalise → apply
  ``group_norm_cuda(...)``   the NCHW forward: stats pass → finalise → apply
  ``group_norm_plain(...)``  flax's ``_normalize`` in float64, for the tests
      and for the comparison on the card

The routes, by what the call can observe (each counted in ``paths``):

  - ``x``, ``weight`` or ``bias`` wrapped by ``torch.func`` (the vmap pool
    executor) → native, ``vmap``;
  - a CPU tensor → native, ``cpu`` (the CPU parity tests see torch's bits);
  - a 4-D ``x`` in channels-last memory (the model's activations on the
    card), of ``out_dtype`` → the NHWC kernels, ``nhwc`` without a
    gradient, ``nhwc_grad`` with one (``GroupNormNHWC``: it saves x in its
    dtype and the (N, G) mean and variance, and its backward is the
    kernels too); ``nhwc_scalar`` counts those of them that took the
    scalar path. The forward is the same kernels either way, so a remat
    block's forward (``models/srresnet.py:RematBlock``, run without a
    graph) gives the bits its recompute gives, as the step without remat
    does;
  - grad enabled and one of the three requiring grad → native, ``grad``;
  - x not of ``out_dtype`` → native, ``cast`` (the model's convs hand the
    norm their compute dtype, so it does not run there);
  - else (NCHW input under ``torch.no_grad``) → the NCHW kernels, ``vec``
    or ``scalar`` by the path they took.

The kernels read x in its dtype (f32 or bf16), compute in f32 over fp64
sums, and write x's dtype once; for a CUDA tensor they launch or raise,
with no fallback. ``launches`` counts the forward calls of either layout
(``group_norm``) and the NHWC backward's (``group_norm_backward``). The
``_launch_*`` functions do the launches for a given library, the card's or
a CPU build of the source (``tests/test_torch_groupnorm_source.py``).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from srgan_tpu_torch.ops.cuda.build import current_stream, on_device

# Calls of the kernels on the card: forward calls of either layout (its
# launches count once), and the NHWC backward's
launches = {"group_norm": 0, "group_norm_backward": 0}
# Every call of ``group_norm`` by its route: the NCHW kernels' two paths,
# the NHWC kernels without and with a gradient (and of those, the calls on
# the scalar path), and the native routes
paths = {"vec": 0, "scalar": 0, "nhwc": 0, "nhwc_grad": 0, "nhwc_scalar": 0, "grad": 0,
         "vmap": 0, "cpu": 0, "cast": 0}
# The kernels' names in the source, and as the profiler prints each
# instance (bf16 and f32, both paths):
# ``h100bench/groups.py`` must file every one under ``groupnorm``
KERNELS = ("group_norm_stats_kernel", "group_norm_finalize_kernel",
           "group_norm_apply_kernel", "group_norm_nhwc_sums_kernel",
           "group_norm_nhwc_finalize_kernel", "group_norm_nhwc_apply_kernel",
           "group_norm_nhwc_bwd_finalize_kernel", "group_norm_nhwc_bwd_params_kernel",
           "group_norm_nhwc_bwd_apply_kernel")
_TYPES = ("float", "__nv_bfloat16")
_BOOLS = ("true", "false")
PROFILED_NAMES = tuple(
    [f"void (anonymous namespace)::group_norm_stats_kernel<{t}, {v}>"
     f"({t} const*, long, int, double*)"
     for t in _TYPES for v in _BOOLS]
    + ["(anonymous namespace)::group_norm_finalize_kernel"
       "(double const*, int, double, float*)"]
    + [f"void (anonymous namespace)::group_norm_apply_kernel<{t}, {v}>"
       f"({t} const*, long, int, int, int, int, float const*, float const*, "
       f"float const*, float, {t}*)"
       for t in _TYPES for v in _BOOLS]
    + [f"void (anonymous namespace)::group_norm_nhwc_sums_kernel<{t}, {v}, {b}>"
       f"({t} const*, {t} const*, int, int, int, int, float const*, float, double*)"
       for t in _TYPES for v in _BOOLS for b in _BOOLS]
    + ["(anonymous namespace)::group_norm_nhwc_finalize_kernel"
       "(double const*, int, int, int, double, float*)"]
    + [f"void (anonymous namespace)::group_norm_nhwc_apply_kernel<{t}, {v}>"
       f"({t} const*, int, int, int, int, float const*, float const*, float const*, "
       f"float, {t}*)"
       for t in _TYPES for v in _BOOLS]
    + ["(anonymous namespace)::group_norm_nhwc_bwd_finalize_kernel"
       "(double const*, int, int, int, float const*, double, double*, float*)",
       "(anonymous namespace)::group_norm_nhwc_bwd_params_kernel"
       "(double const*, int, int, float*, float*)"]
    + [f"void (anonymous namespace)::group_norm_nhwc_bwd_apply_kernel<{t}, {v}>"
       f"({t} const*, {t} const*, int, int, int, int, float const*, float const*, "
       f"float const*, float, {t}*)"
       for t in _TYPES for v in _BOOLS])
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


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
    F = ctypes.c_float
    lib.group_norm_nhwc_chunks.argtypes = [I, L, L, I, I]
    lib.group_norm_nhwc_chunks.restype = I
    lib.group_norm_nhwc_forward.argtypes = [P, I, L, L, I, I, I, P, P, P, P, F, P, P]
    lib.group_norm_nhwc_forward.restype = I
    lib.group_norm_nhwc_backward.argtypes = [P, P, I, L, L, I, I, I, P, P, F, P, P, P, P,
                                             P, P, P]
    lib.group_norm_nhwc_backward.restype = I
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


def channels_last(x: torch.Tensor) -> bool:
    """Whether x is a 4-D batch in channels-last (NHWC) memory, the
    layout the NHWC kernels walk (also where it coincides with NCHW's)."""
    return x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last)


def nhwc_vector_path(c: int, *tensors: torch.Tensor) -> bool:
    """Whether the NHWC kernels take their 16-byte path: every pixel of
    each tensor starts 16-byte aligned (C a multiple of 16 bytes' values,
    aligned data)."""
    return (c * tensors[0].element_size() % 16 == 0
            and all(t.data_ptr() % 16 == 0 for t in tensors))


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


def _nhwc_dims(lib, x, groups: int):
    """``(n, hw, c, chunks)`` of a channels-last batch for the NHWC kernels;
    raises for a shape they refuse."""
    n, c = x.shape[:2]
    hw = x.shape[2] * x.shape[3]
    chunks = lib.group_norm_nhwc_chunks(DTYPE_CODES[x.dtype], n, hw, c, groups)
    if chunks < 0:
        raise ValueError(f"the NHWC GroupNorm kernels do not take {tuple(x.shape)} "
                         f"{x.dtype} in {groups} groups")
    return n, hw, c, chunks


def _launch_nhwc_forward(lib, x, weight, bias, groups: int, eps: float, vec: bool,
                         stream: int):
    """The NHWC forward of channels-last x: ``(y, stats)``, y of x's
    layout and dtype, stats the (N * groups, 2) f32 ``[mean, var]``."""
    n, hw, c, chunks = _nhwc_dims(lib, x, groups)
    partials = torch.empty(n * chunks * c * 2, dtype=torch.float64, device=x.device)
    stats = torch.empty(n * groups, 2, dtype=torch.float32, device=x.device)
    y = torch.empty_like(x, memory_format=torch.channels_last)
    rc = lib.group_norm_nhwc_forward(
        x.data_ptr(), DTYPE_CODES[x.dtype], n, hw, c, groups, int(vec), partials.data_ptr(),
        stats.data_ptr(), weight.data_ptr(), bias.data_ptr(), eps, y.data_ptr(), stream)
    _raise_if_failed(lib, rc, "group_norm_nhwc_forward")
    return y, stats


def _launch_nhwc_backward(lib, x, dy, stats, weight, groups: int, eps: float, vec: bool,
                          stream: int):
    """The NHWC backward at x (channels-last) from dy (x's layout and
    dtype) and the forward's stats: ``(dx, dweight, dbias)``, dx of x's
    layout and dtype, the other two f32."""
    n, hw, c, chunks = _nhwc_dims(lib, x, groups)
    rows = n * groups
    # the sums' partials, then the per-(image, channel) sums, then the
    # groups' two coefficients (f32)
    scratch = torch.empty(2 * n * c * (chunks + 1) + rows, dtype=torch.float64,
                          device=x.device)
    partials, ab = scratch[:2 * n * c * chunks], scratch[2 * n * c * chunks:-rows]
    coef = scratch[-rows:].view(torch.float32)
    dparams = torch.empty(2, c, dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    rc = lib.group_norm_nhwc_backward(
        x.data_ptr(), dy.data_ptr(), DTYPE_CODES[x.dtype], n, hw, c, groups, int(vec),
        stats.data_ptr(), weight.data_ptr(), eps, partials.data_ptr(), ab.data_ptr(),
        coef.data_ptr(), dparams[0].data_ptr(), dparams[1].data_ptr(), dx.data_ptr(),
        stream)
    _raise_if_failed(lib, rc, "group_norm_nhwc_backward")
    return dx, dparams[0], dparams[1]


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


def group_norm_nhwc(x, weight, bias, groups: int, eps: float):
    """GroupNorm's forward of a channels-last batch by the NHWC kernels:
    ``(y, stats)``, y channels-last of x's dtype, stats as
    ``_launch_nhwc_forward``'s."""
    _check(x, weight, bias, groups)
    if not channels_last(x):
        raise ValueError("expected a 4-D batch in channels-last memory")
    vec = nhwc_vector_path(x.shape[1], x)  # y is fresh, so aligned
    with on_device(x):
        y, stats = _launch_nhwc_forward(_lib(), x, weight, bias, groups, eps, vec,
                                        current_stream(x))
    launches["group_norm"] += 1
    paths["nhwc_scalar"] += not vec
    return y, stats


class GroupNormNHWC(torch.autograd.Function):
    """The NHWC kernels as an op with a gradient: the forward saves x in
    its dtype and the (N, G) mean and variance; the backward is the
    kernels' sums → finalise → apply, dx of x's dtype and layout, the scale
    and bias gradients f32."""

    @staticmethod
    def forward(x, weight, bias, groups: int, eps: float):
        return group_norm_nhwc(x, weight, bias, groups, eps)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, weight, _, groups, eps = inputs
        ctx.save_for_backward(x, weight, output[1])
        ctx.groups, ctx.eps = groups, eps
        ctx.mark_non_differentiable(output[1])

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy, _):
        x, weight, stats = ctx.saved_tensors
        dy = dy.to(x.dtype).contiguous(memory_format=torch.channels_last)
        vec = nhwc_vector_path(x.shape[1], x, dy)
        with on_device(x):
            grads = _launch_nhwc_backward(_lib(), x, dy, stats, weight, ctx.groups,
                                          ctx.eps, vec, current_stream(x))
        launches["group_norm_backward"] += 1
        return *grads, None, None


def group_norm(x, weight, bias, groups: int, eps: float, out_dtype):
    """The model's GroupNorm forward, by the route the module docstring
    lists: the NHWC kernels for channels-last input; for NCHW input the
    kernels where nothing needs its gradient, else torch's."""
    wrapped = torch._C._functorch.is_functorch_wrapped_tensor
    needs_grad = torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                              or bias.requires_grad)
    if wrapped(x) or wrapped(weight) or wrapped(bias):
        route = "vmap"
    elif not x.is_cuda:
        route = "cpu"
    elif channels_last(x) and x.dtype == out_dtype:
        paths["nhwc_grad" if needs_grad else "nhwc"] += 1
        if needs_grad:
            return GroupNormNHWC.apply(x, weight, bias, groups, eps)[0]
        return group_norm_nhwc(x, weight, bias, groups, eps)[0]
    elif needs_grad:
        route = "grad"
    elif x.dtype != out_dtype:
        route = "cast"
    else:
        return group_norm_cuda(x, weight, bias, groups, eps)
    paths[route] += 1
    return native_group_norm(x, weight, bias, groups, eps, out_dtype)
