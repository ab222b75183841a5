"""The fused residual tower: N blocks of conv3x3 (no bias) → GroupNorm(8)
→ ReLU → conv3x3 → GroupNorm → +skip, the counterpart of
``srgan_tpu/ops/pallas/residual_tower_kernel.py``.

  ``residual_tower(x, params, compute_dtype)``  the op: x (B, H, W, F) NHWC
  ``residual_tower_reference``                 the oracle (f32 carry)
  ``residual_tower_plain``                     the plain version of K4
  ``tower_fwd`` / ``tower_bwd``                 the wrappers of K4 and K5
                                               (``csrc/residual_tower.cu``)

``TowerParams`` holds conv weights (N, 3, 3, F, F) in HWIO, as in JAX, and
GroupNorm scales and biases (N, F). Conv operands are rounded to
``compute_dtype`` (float32 or bfloat16); accumulation, statistics and
GroupNorm stay float32. GroupNorm is JAX's: var = E[c²] − E[c]² over
H·W·F/8 values, then rsqrt(var + 1e-6).

Like the JAX op, the tower is not wired into ``SRResNet``: its convs carry
no bias, the model's do. A CUDA tensor goes through ``ResidualTower``
(forward K4, backward K5, saving only x and the params); a CPU tensor goes
through ``residual_tower_plain`` and autograd. No path falls back from a
kernel to the plain version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

EPS = 1e-6  # flax GroupNorm default
GROUPS = 8
KERNEL_FEATURES = (16, 32, 64, 128)  # instantiated in the source

# Launches on the card, one per wrapper call (all of that call's CUDA
# launches included); CPU calls do not count.
launches = {"tower_fwd": 0, "tower_bwd": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


class TowerParams(NamedTuple):
    """Stacked block parameters. F features, N blocks."""

    w1: torch.Tensor  # (N, 3, 3, F, F) HWIO per tap
    s1: torch.Tensor  # (N, F) GroupNorm scale
    b1: torch.Tensor  # (N, F) GroupNorm bias
    w2: torch.Tensor  # (N, 3, 3, F, F)
    s2: torch.Tensor  # (N, F)
    b2: torch.Tensor  # (N, F)


def group_indicator(f: int, g: int) -> np.ndarray:
    ind = np.zeros((f, g), np.float32)
    for c in range(f):
        ind[c, c // (f // g)] = 1.0
    return ind


# -------------------------------------------------------- plain versions --
# NHWC at the boundary, NCHW inside. A bf16 conv with f32 accumulation is
# an f32 conv of operands rounded to bf16 (a product of two bf16 values is
# exact in f32), with TF32 off on the card.


class _Round(torch.autograd.Function):
    """Rounds to a narrower dtype and back. The gradient passes unrounded:
    K5, like the JAX kernel's backward, carries its gradient in f32 and
    rounds only the conv operands. (Autograd through a plain cast would
    round the gradient to bf16 at every block.)"""

    @staticmethod
    def forward(ctx, t, dtype):
        return t.to(dtype).to(t.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _round(t: torch.Tensor, compute_dtype) -> torch.Tensor:
    return t if compute_dtype == torch.float32 else _Round.apply(t, compute_dtype)


def _conv(a: torch.Tensor, w_hwio: torch.Tensor, compute_dtype) -> torch.Tensor:
    w = _round(w_hwio, compute_dtype).permute(3, 2, 0, 1)  # HWIO → OIHW
    return F.conv2d(_round(a, compute_dtype), w, padding=1)


def _group_norm(c: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor):
    """JAX's GroupNorm on NCHW: (c − μ)·rsqrt(σ² + ε)·scale + bias."""
    b, f, h, w = c.shape
    cg = c.reshape(b, GROUPS, f // GROUPS, h, w)
    mean = cg.mean(dim=(2, 3, 4), keepdim=True)
    var = (cg * cg).mean(dim=(2, 3, 4), keepdim=True) - mean * mean
    z = ((cg - mean) * torch.rsqrt(var + EPS)).reshape(b, f, h, w)
    return z * scale.reshape(1, f, 1, 1) + bias.reshape(1, f, 1, 1)


def _tower(x, params: TowerParams, compute_dtype, round_carry: bool):
    _check_shapes(x, params)
    round_c = (lambda t: _round(t, compute_dtype)) if round_carry else (lambda t: t)
    a = round_c(x.float().permute(0, 3, 1, 2))
    for n in range(params.w1.shape[0]):
        g1 = _group_norm(_conv(a, params.w1[n], compute_dtype),
                         params.s1[n], params.b1[n])
        r = round_c(torch.relu(g1))
        g2 = _group_norm(_conv(r, params.w2[n], compute_dtype),
                         params.s2[n], params.b2[n])
        a = round_c(g2 + a)
    return a.permute(0, 2, 3, 1).contiguous().to(x.dtype)


def residual_tower_reference(x, params: TowerParams,
                             compute_dtype=torch.float32) -> torch.Tensor:
    """The oracle (``residual_tower_reference`` in JAX): conv operands in
    ``compute_dtype``, the carry in f32, the result in ``x.dtype``."""
    return _tower(x, params, compute_dtype, round_carry=False)


def residual_tower_plain(x, params: TowerParams,
                         compute_dtype=torch.float32) -> torch.Tensor:
    """The plain version of K4, with its rounding schedule: x, r = relu(GN1)
    and the carry after every block are rounded to ``compute_dtype``. Equal
    to the reference in f32. Its autograd is the plain version of K5."""
    return _tower(x, params, compute_dtype, round_carry=True)


def _check_shapes(x: torch.Tensor, params: TowerParams) -> None:
    if x.dim() != 4:
        raise ValueError(f"expected x of shape (B, H, W, F), got {tuple(x.shape)}")
    f = x.shape[-1]
    if f % GROUPS:
        raise ValueError(f"F must be a multiple of {GROUPS} (GroupNorm groups), got {f}")
    n = params.w1.shape[0]
    for name, t in zip(TowerParams._fields, params):
        want = (n, 3, 3, f, f) if name.startswith("w") else (n, f)
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: expected shape {want}, got {tuple(t.shape)}")


# -------------------------------------------------------------- wrappers --


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.tower_error_string.argtypes = [I]
    lib.tower_error_string.restype = ctypes.c_char_p
    for fn in (lib.tower_partials_doubles, lib.tower_wgrad_floats):
        fn.argtypes = [I, I, I, I]
        fn.restype = I
    lib.tower_forward.argtypes = [P] * 8 + [I] * 6 + [P] * 5 + [P]
    lib.tower_forward.restype = I
    lib.tower_backward.argtypes = [P] * 10 + [I] * 6 + [P] * 18 + [P]
    lib.tower_backward.restype = I
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from srgan_tpu_torch.ops.cuda.build import load

    return _bind(load("residual_tower"))


def _check_kernel_args(x, params: TowerParams, compute_dtype) -> None:
    _check_shapes(x, params)
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype}")
    if x.device.type != "cuda":
        raise ValueError(f"expected a CUDA tensor, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x: expected float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x: expected a contiguous NHWC tensor")
    for name, t in zip(TowerParams._fields, params):
        if t.device != x.device:
            raise ValueError(f"{name}: expected a tensor on {x.device}, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
    if x.numel() >= 2**31:
        raise ValueError("x: the kernels index a batch with 32-bit integers")
    if x.shape[-1] not in KERNEL_FEATURES:
        raise ValueError(
            f"F={x.shape[-1]}: the tower kernels are built for F in {KERNEL_FEATURES}"
        )


def _raise_if_failed(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.tower_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def _kernel_weights(params: TowerParams, compute_dtype, transposed: bool):
    """(w1, w2) in the compute dtype (the bf16 tiles read bf16 weights);
    ``transposed``: the taps flipped and each (F_in, F_out) matrix
    transposed, the weights of the conv that is the transpose of the
    forward's (the dX conv)."""
    out = []
    for w in (params.w1, params.w2):
        w = w.to(compute_dtype)
        if transposed:
            w = w.flip(1, 2).transpose(3, 4)
        out.append(w.contiguous())
    return out


def _launch_fwd(lib, x, params: TowerParams, compute_dtype, stream: int):
    """K4 on ``stream``; returns y in the compute dtype. The caller checks."""
    b, h, w, f = x.shape
    n = params.w1.shape[0]
    dev = x.device
    xc = x.to(compute_dtype).contiguous()
    w1, w2 = _kernel_weights(params, compute_dtype, transposed=False)
    y = torch.empty_like(xc)
    carry = torch.empty((min(n - 1, 2) or 1, b, h, w, f), dtype=compute_dtype, device=dev)
    c1 = torch.empty(x.shape, dtype=torch.float32, device=dev)
    c2 = torch.empty_like(c1)
    stats = torch.empty(4 * b * GROUPS, dtype=torch.float32, device=dev)
    partials = torch.empty(lib.tower_partials_doubles(b, h, w, f),
                           dtype=torch.float64, device=dev)
    rc = lib.tower_forward(
        xc.data_ptr(), y.data_ptr(), w1.data_ptr(), params.s1.data_ptr(),
        params.b1.data_ptr(), w2.data_ptr(), params.s2.data_ptr(),
        params.b2.data_ptr(), n, b, h, w, f, int(compute_dtype == torch.bfloat16),
        carry.data_ptr(), c1.data_ptr(), c2.data_ptr(), stats.data_ptr(),
        partials.data_ptr(), stream,
    )
    _raise_if_failed(lib, rc, "tower_forward")
    return y


def _launch_bwd(lib, dy, x, params: TowerParams, compute_dtype, stream: int):
    """K5 on ``stream``; returns dx and the param gradients, all f32."""
    b, h, w, f = x.shape
    n = params.w1.shape[0]
    dev = x.device
    act = (b, h, w, f)
    f32 = dict(dtype=torch.float32, device=dev)
    xc = x.to(compute_dtype).contiguous()
    dyf = dy.to(torch.float32).contiguous()
    w1, w2 = _kernel_weights(params, compute_dtype, transposed=False)
    wt1, wt2 = _kernel_weights(params, compute_dtype, transposed=True)
    dx = torch.empty(act, **f32)
    grads = [torch.empty(t.shape, **f32) for t in params]
    carry = torch.empty((max(n - 1, 1), *act), dtype=compute_dtype, device=dev)
    c1 = torch.empty((n, *act), **f32)
    c2 = torch.empty((n, *act), **f32)
    stats = torch.empty(n * 4 * b * GROUPS, **f32)
    partials = torch.empty(lib.tower_partials_doubles(b, h, w, f),
                           dtype=torch.float64, device=dev)
    sums = torch.empty(b * f * 2, dtype=torch.float64, device=dev)
    m = torch.empty(b * GROUPS * 2, **f32)
    dc = torch.empty(act, **f32)
    dr = torch.empty(act, **f32)
    da = torch.empty((2, *act), **f32)
    wpart = torch.empty(lib.tower_wgrad_floats(b, h, w, f), **f32)
    dw1, ds1, db1, dw2, ds2, db2 = grads
    rc = lib.tower_backward(
        dyf.data_ptr(), xc.data_ptr(), w1.data_ptr(), params.s1.data_ptr(),
        params.b1.data_ptr(), w2.data_ptr(), params.s2.data_ptr(),
        params.b2.data_ptr(), wt1.data_ptr(), wt2.data_ptr(),
        n, b, h, w, f, int(compute_dtype == torch.bfloat16),
        dx.data_ptr(), dw1.data_ptr(), ds1.data_ptr(), db1.data_ptr(),
        dw2.data_ptr(), ds2.data_ptr(), db2.data_ptr(), carry.data_ptr(),
        c1.data_ptr(), c2.data_ptr(), stats.data_ptr(), partials.data_ptr(),
        sums.data_ptr(), m.data_ptr(), dc.data_ptr(), dr.data_ptr(),
        da.data_ptr(), wpart.data_ptr(), stream,
    )
    _raise_if_failed(lib, rc, "tower_backward")
    return dx, TowerParams(*grads)


def tower_fwd(x, params: TowerParams, compute_dtype=torch.float32) -> torch.Tensor:
    """K4: the tower's output, shaped and typed like ``x``."""
    _check_kernel_args(x, params, compute_dtype)
    with torch.cuda.device(x.device):
        y = _launch_fwd(_lib(), x, params, compute_dtype,
                        torch.cuda.current_stream(x.device).cuda_stream)
    launches["tower_fwd"] += 1
    return y.to(x.dtype)


def tower_bwd(dy, x, params: TowerParams,
              compute_dtype=torch.float32) -> Tuple[torch.Tensor, TowerParams]:
    """K5: (dx, d params) of ``sum(tower(x) * dy)``; dx in ``x.dtype``, the
    param gradients in the params' dtype (f32)."""
    _check_kernel_args(x, params, compute_dtype)
    if dy.shape != x.shape or dy.device != x.device:
        raise ValueError(f"dy: expected shape {tuple(x.shape)} on {x.device}")
    if dy.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dy: expected float32 or bfloat16, got {dy.dtype}")
    if not dy.is_contiguous():
        raise ValueError("dy: expected a contiguous NHWC tensor")
    with torch.cuda.device(x.device):
        dx, grads = _launch_bwd(_lib(), dy, x, params, compute_dtype,
                                torch.cuda.current_stream(x.device).cuda_stream)
    launches["tower_bwd"] += 1
    return dx.to(x.dtype), grads


class ResidualTower(torch.autograd.Function):
    """The tower with a kernel forward (K4) and a kernel backward (K5). Like
    the JAX custom VJP it saves only x and the params: K5 replays the
    forward."""

    @staticmethod
    def forward(ctx, x, w1, s1, b1, w2, s2, b2, compute_dtype):
        params = TowerParams(w1, s1, b1, w2, s2, b2)
        ctx.compute_dtype = compute_dtype
        ctx.save_for_backward(x, *params)
        return tower_fwd(x, params, compute_dtype)

    @staticmethod
    def backward(ctx, dy):
        x, *params = ctx.saved_tensors
        dx, grads = tower_bwd(dy.contiguous(), x, TowerParams(*params),
                              ctx.compute_dtype)
        return (dx, *grads, None)


def residual_tower(x, params: TowerParams,
                   compute_dtype=torch.float32) -> torch.Tensor:
    """The fused N-block residual tower on x (B, H, W, F); returns the same
    shape and dtype. A CUDA tensor runs K4 (and K5 for its gradient), a CPU
    tensor the plain version under autograd."""
    _check_shapes(x, params)
    if not x.is_cuda:
        return residual_tower_plain(x, params, compute_dtype)
    return ResidualTower.apply(x, *params, compute_dtype)
