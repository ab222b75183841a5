"""The CUDA source of SwinIR's windowed attention (``csrc/window_attention.cu``)
compiled with g++ against a CPU stand-in for the CUDA runtime
(``tests/cuda_emu/``) and run on the CPU through the wrapper's
``_launch_*`` functions, against the op's plain route
(``ops/window_attention.py:window_attention_plain``) in float64. This
checks the kernels' window walk, roll, region mask, softmax, the
recomputed backward and dBias's partials here: the CUDA-core kernels (f32)
and the tensor-core kernels (bf16), whose ``mma.sync``, ``ldmatrix`` and
``cp.async`` run as the warp-cooperative stand-ins of
``tests/cuda_emu/tower_mma.cuh``. Whether nvcc accepts the source, and the
kernels on the card, only a chip run shows (``tests/test_torch_cuda.py``,
``chip_smoke.py``).

Bars: the kernels compute in f32 and the plain route here in float64, so
out, dqkv and dbias are held at 2e-5 of their largest magnitude (a sum of
64 f32 products, a softmax, and dbias's sums over the windows). A bf16
input gives a bf16 output within one bf16 ulp of the float64 result
rounded once; its gradients within 1e-2 (dqkv, rounded to bf16) and 2e-3
(dbias; the CUDA-core backward's D_i = dO_i·O_i reads the rounded O, the
tensor-core backward takes D_i = sum_j P_ij dP_ij in f32 and comes far
under the bar). Two launches give the same bits.

Cases: shifted and plain layers, head dims 30 (SwinIR-M's) and 12, windows
8 and 4, one and two images, several windows a side, and more windows than
one backward block walks (dBias over several partials); for bf16 also an
odd head dim and a qkv two bytes off a 4-byte boundary, which the
tensor-core kernels copy a value at a time.
"""

import numpy as np
import pytest
import torch

from cuda_emu.emu_build import compile_source
from srgan_tpu_torch.ops import window_attention as wa
from srgan_tpu_torch.ops.cuda import window_attention_kernel as wk

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def emulated_lib(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("window_attn_emu")
    return wk._bind(compile_source("window_attention", tmp, "-DEMU_STATIC_SHARED"))


def _inputs(grid, heads, hd, window, dtype, seed=0):
    rng = np.random.default_rng(seed)
    b, h, w = grid
    n = window * window
    qkv = torch.from_numpy(rng.standard_normal((b, h * w, 3 * heads * hd))).to(dtype)
    bias = torch.from_numpy(rng.standard_normal((heads, n, n)) * 0.5).float()
    dout = torch.from_numpy(rng.standard_normal((b, h * w, heads * hd))).to(dtype)
    return qkv, bias, dout


def _plain64(qkv, bias, dout, heads, window, shift, grid):
    """out, dqkv, dbias of the plain route in float64."""
    q = qkv.double().requires_grad_()
    bb = bias.double().requires_grad_()
    out = wa.window_attention_plain(q, bb, heads, window, shift, grid)
    dq, db = torch.autograd.grad(out, [q, bb], dout.double())
    return out.detach(), dq, db


def _kernels(lib, qkv, bias, dout, heads, window, shift, grid):
    out, lse = wk._launch_forward(lib, qkv, bias, heads, window, shift, grid, 0)
    dqkv, dbias = wk._launch_backward(lib, qkv, bias, out, lse, dout, heads, window, shift,
                                      grid, 0)
    return out, lse, dqkv, dbias


def _close(got, want, bar=2e-5):
    err = float((got.double() - want).abs().max())
    assert err <= bar * float(want.abs().max()), (err, float(want.abs().max()))


CASES = [  # (grid, heads, head dim, window, shift)
    ((1, 16, 16), 2, 30, 8, 4),
    ((1, 16, 16), 2, 30, 8, 0),
    ((2, 8, 24), 3, 12, 4, 2),
    ((2, 8, 24), 3, 12, 4, 0),
    ((1, 12, 20), 1, 12, 4, 2),
]


@pytest.mark.parametrize("grid,heads,hd,window,shift", CASES,
                         ids=[f"{'x'.join(map(str, g))}-h{h}d{d}-w{w}s{s}"
                              for g, h, d, w, s in CASES])
def test_window_attn_source_matches_plain(emulated_lib, grid, heads, hd, window, shift):
    qkv, bias, dout = _inputs(grid, heads, hd, window, torch.float32)
    wk._check(qkv, bias, heads, window, shift, grid)
    out, lse, dqkv, dbias = _kernels(emulated_lib, qkv, bias, dout, heads, window, shift, grid)
    out_p, dqkv_p, dbias_p = _plain64(qkv, bias, dout, heads, window, shift, grid)
    _close(out, out_p)
    _close(dqkv, dqkv_p)
    _close(dbias, dbias_p)
    assert out.dtype == dqkv.dtype == torch.float32 and dbias.shape == bias.shape

    again = _kernels(emulated_lib, qkv, bias, dout, heads, window, shift, grid)
    for a, b in zip((out, lse, dqkv, dbias), again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("grid,heads,hd,window,shift", CASES,
                         ids=[f"{'x'.join(map(str, g))}-h{h}d{d}-w{w}s{s}"
                              for g, h, d, w, s in CASES])
def test_window_attn_source_bf16(emulated_lib, grid, heads, hd, window, shift):
    """bf16 in, the tensor-core kernels, f32 inside, bf16 out rounded once:
    within one bf16 ulp of the float64 result; dbias stays f32."""
    qkv, bias, dout = _inputs(grid, heads, hd, window, torch.bfloat16, seed=1)
    out, _, dqkv, dbias = _kernels(emulated_lib, qkv, bias, dout, heads, window, shift, grid)
    _hold_bf16(qkv, bias, dout, heads, window, shift, grid, out, dqkv, dbias)


def _hold_bf16(qkv, bias, dout, heads, window, shift, grid, out, dqkv, dbias):
    out_p, dqkv_p, dbias_p = _plain64(qkv, bias, dout, heads, window, shift, grid)
    assert out.dtype == dqkv.dtype == torch.bfloat16 and dbias.dtype == torch.float32
    want = out_p.float().to(torch.bfloat16).double()
    mag = torch.maximum(want.abs(), out.double().abs()).clamp_min(2.0 ** -120)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    assert bool(((out.double() - want).abs() <= ulp + 1e-6 * float(want.abs().max())).all())
    _close(dqkv, dqkv_p, 1e-2)  # each of dq, dk, dv rounded once to bf16
    # D_i = dO_i·O_i reads the bf16-rounded O in the CUDA-core backward (as
    # flash attention's backward does), a relative error of ~2^-9 in every
    # dS of the row
    _close(dbias, dbias_p, 2e-3)


def test_window_attn_source_bf16_dbias_over_groups(emulated_lib):
    """The tensor-core backward over more windows than a block walks (8):
    dBias is the sum of several blocks' partials, in a fixed order, and two
    launches give the same bits."""
    grid, heads, hd, window, shift = (3, 8, 16), 2, 12, 4, 2  # 24 windows, 3 groups
    assert emulated_lib.window_attn_groups(*grid, window) == 3
    qkv, bias, dout = _inputs(grid, heads, hd, window, torch.bfloat16, seed=3)
    out, lse, dqkv, dbias = _kernels(emulated_lib, qkv, bias, dout, heads, window, shift, grid)
    _hold_bf16(qkv, bias, dout, heads, window, shift, grid, out, dqkv, dbias)
    again = _kernels(emulated_lib, qkv, bias, dout, heads, window, shift, grid)
    for a, b in zip((out, lse, dqkv, dbias), again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("hd,offset", [(9, 0), (12, 1)],
                         ids=["odd-head-dim", "qkv-off-by-2-bytes"])
def test_window_attn_source_bf16_copies_a_value_at_a_time(emulated_lib, hd, offset):
    """Where a head's values do not pair into 4-byte words (an odd head dim,
    or a qkv view two bytes off a 4-byte boundary), the tensor-core kernels
    copy and store them one at a time, with the same results."""
    grid, heads, window, shift = (1, 8, 12), 2, 4, 2
    qkv, bias, dout = _inputs(grid, heads, hd, window, torch.bfloat16, seed=4)
    if offset:
        storage = torch.empty(qkv.numel() + offset, dtype=qkv.dtype)
        storage[offset:] = qkv.flatten()
        qkv = storage[offset:].view(qkv.shape)
        assert qkv.data_ptr() % 4 == 2 and qkv.is_contiguous()
    out, _, dqkv, dbias = _kernels(emulated_lib, qkv, bias, dout, heads, window, shift, grid)
    _hold_bf16(qkv, bias, dout, heads, window, shift, grid, out, dqkv, dbias)


def test_window_attn_designs_follow_the_dtype():
    """bf16 takes the tensor-core kernels and f32 the CUDA-core ones, each
    counted under its design beside the totals."""
    assert wk.DESIGNS == {torch.bfloat16: "mma", torch.float32: "simt"}
    assert set(wk.DTYPE_CODES) == set(wk.DESIGNS) and set(wk.KERNELS_BY_DESIGN) == {"mma", "simt"}
    assert set(wk.launches) == {"forward", "backward", "forward_mma", "backward_mma",
                                "forward_simt", "backward_simt"}


def test_window_attn_source_dbias_over_groups(emulated_lib):
    """More windows than a backward block walks (8): dBias is the sum of
    several blocks' partials, in a fixed order."""
    grid, heads, hd, window, shift = (3, 8, 16), 1, 12, 4, 2  # 24 windows, 3 groups
    assert emulated_lib.window_attn_groups(*grid, window) == 3
    qkv, bias, dout = _inputs(grid, heads, hd, window, torch.float32, seed=2)
    _, _, _, dbias = _kernels(emulated_lib, qkv, bias, dout, heads, window, shift, grid)
    _close(dbias, _plain64(qkv, bias, dout, heads, window, shift, grid)[2])


def test_window_attn_source_refuses_what_it_cannot_take(emulated_lib):
    """A head dim over 32, a window over 8, a shift of a whole window and an
    image that windows do not tile are refused with an error code."""
    p = None
    ok = dict(batch=1, height=8, width=8, window=4, shift=2, heads=1, head_dim=12)
    for bad in (dict(head_dim=33), dict(window=9, height=9, width=9), dict(shift=4),
                dict(width=10), dict(dtype=2)):
        a = {**ok, "dtype": 0, **bad}
        rc = emulated_lib.window_attn_forward(
            p, a["dtype"], p, a["batch"], a["height"], a["width"], a["window"], a["shift"],
            a["heads"], a["head_dim"], 1.0, p, p, p)
        assert rc != 0, bad
    with pytest.raises(ValueError, match="head dim 33"):
        wk._check(torch.zeros(1, 64, 3 * 33), torch.zeros(1, 16, 16), 1, 4, 2, (1, 8, 8))


@pytest.mark.parametrize("name", wk.KERNELS)
def test_kernel_names_stay_out_of_every_group(name):
    """The kernels' names, as the profiler prints them, land in no kernel
    group of the benchmark (``other``): the old cells' groups do not move,
    and ``window_attn_ms.train`` reads them by their prefix."""
    from h100bench.groups import group_of

    printed = [f"(anonymous namespace)::{name}({t} const*, ...)"
               for t in ("float", "__nv_bfloat16")]
    for full in (name, *printed):
        assert full.startswith("window_attn_") or "::window_attn_" in full
        assert group_of(full) == "other"
