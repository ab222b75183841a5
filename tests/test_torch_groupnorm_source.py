"""The CUDA source of GroupNorm's kernels (``csrc/group_norm.cu``) compiled
with g++ against a CPU stand-in for the CUDA runtime (``tests/cuda_emu/``)
and run on the CPU through the wrapper's ``_launch_*`` functions, as the
model runs them, against the plain version in float64: the NCHW forward
(stats pass → finalise → apply), and the NHWC forward and backward (sums →
finalise → apply) on channels-last input. This checks the kernels'
chunking, vector and scalar paths, channel walk and reductions here;
whether nvcc accepts the source, and the kernels on the card, only a chip
run shows (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Inputs sit on a 1/64 grid in [-1, 2] (exact in bf16, and every f32 and
fp64 sum of theirs exact), so the mean and variance must match the float64
version to rounding of its last division; scale and bias differ by channel,
so a wrong channel shows in the output. Bars: mean and var rel 1e-6; a bf16
output within one bf16 ulp of the plain version's result rounded once to
f32 and then to bf16, an f32 one within 2e-6 of the largest |y|. The
output is of the input's dtype.

Shapes: a row of 5 chunks (8,192 values a chunk), rows shorter than one,
row lengths that are not a multiple of 8 (the scalar path, rows that start
unaligned), one of them over two chunks; (C, G) = (64, 8) and (16, 8);
batch 1 and 3.

NHWC (a chunk is 256 pixels at C = 64 in bf16, 128 in f32): images shorter
than a chunk and over 5 and 9, (C, G) = (64, 8), (16, 8), (8, 8) (one
channel a group), and on the scalar path (40, 8) (five slots a pixel, so
idle threads) and (12, 4) (a slot of half its width in bf16), and (256, 8)
and (512, 8) (32 and 64 slots a pixel, so 8 and 4 pixel lanes a block);
dx, the scale and the bias gradients against
float64 autograd of the plain version, with bars as the forward's: dx
within one bf16 ulp (f32: 4e-6 of the largest |dx|) plus 1e-5 of the
largest |dx| for the f32 arithmetic of its three terms, the parameter
gradients within 1e-6 of the sum of their terms' magnitudes.

The module's route on the CPU (torch's kernel, counted ``cpu``, also in a
remat block's forward; under ``torch.func.vmap``, ``vmap``), the NHWC op's
autograd wiring on the emulated kernels, and the kernels' names in the
benchmark's kernel groups are checked here too.
"""

import contextlib

import numpy as np
import pytest
import torch

from cuda_emu.emu_build import compile_source
from srgan_tpu_torch.models.srresnet import GroupNorm, ResidualBlock, RematBlock
from srgan_tpu_torch.ops.cuda import group_norm_kernel as gk

torch.set_num_threads(1)
EPS = 1e-6


@pytest.fixture(scope="module")
def emulated_lib(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("group_norm_emu")
    return gk._bind(compile_source("group_norm", tmp, "-DEMU_STATIC_SHARED"))


def _inputs(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(-64, 129, shape) / 64.0).to(dtype)
    c = shape[1]
    weight = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32))
    bias = torch.from_numpy(rng.uniform(-0.5, 0.5, c).astype(np.float32))
    return x, weight, bias


def _run(lib, x, weight, bias, vec):
    y = torch.empty_like(x)
    buf = gk._launch_stats(lib, x, 8, vec, 0)
    stats = gk._launch_finalize(lib, buf, x, 8, 0)
    gk._launch_apply(lib, x, stats, weight, bias, 8, EPS, y, vec, 0)
    return y, stats


CASES = [  # (shape, vec): rows of 5 chunks, 288, 70, 2184 and 9768 values
    ((1, 16, 128, 160), True), ((1, 16, 128, 160), False),
    ((3, 16, 9, 16), True), ((3, 16, 9, 16), False),
    ((3, 16, 7, 5), False),
    ((1, 64, 13, 21), False),
    ((1, 64, 33, 37), False),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bfloat16", "float32"])
@pytest.mark.parametrize("shape,vec", CASES,
                         ids=[f"{'x'.join(map(str, s))}-{'vec' if v else 'scalar'}"
                              for s, v in CASES])
def test_group_norm_source_matches_plain(emulated_lib, shape, vec, dtype):
    x, weight, bias = _inputs(shape, dtype)
    assert gk.vector_path(x, torch.empty_like(x), 8) or not vec
    y, stats = _run(emulated_lib, x, weight, bias, vec)

    y_p, mean_p, var_p = gk.group_norm_plain(x, weight, bias, 8, EPS)
    np.testing.assert_allclose(stats[:, 0].double(), mean_p.flatten(), rtol=1e-6)
    np.testing.assert_allclose(stats[:, 1].double(), var_p.flatten(), rtol=1e-6)
    y_k = y.double()
    if dtype == torch.bfloat16:
        want = y_p.float().to(torch.bfloat16).double()
        # one bf16 ulp at the larger of the two magnitudes (8 significant bits)
        mag = torch.maximum(want.abs(), y_k.abs()).clamp_min(2.0 ** -120)
        ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
        assert bool(((y_k - want).abs() <= ulp).all())
    else:
        assert float((y_k - y_p).abs().max()) <= 2e-6 * float(y_p.abs().max())

    # two launches give the same bits; so does the scalar path on rows the
    # vector path takes (the same values a thread, in the same order)
    y2, stats2 = _run(emulated_lib, x, weight, bias, vec)
    assert torch.equal(y, y2) and torch.equal(stats, stats2)
    if vec:
        y3, stats3 = _run(emulated_lib, x, weight, bias, False)
        assert torch.equal(y, y3) and torch.equal(stats, stats3)


def test_group_norm_source_refuses_what_it_cannot_take(emulated_lib):
    """The vector path on rows that do not start aligned, and unknown
    dtypes, are refused with a CUDA error code, not run."""
    x, weight, bias = _inputs((1, 16, 7, 5), torch.float32)
    with pytest.raises(RuntimeError, match="group_norm_stats"):
        gk._launch_stats(emulated_lib, x, 8, True, 0)
    y = torch.empty(x.shape)
    rc = emulated_lib.group_norm_apply(
        x.data_ptr(), 2, 8, 70, 35, 8, 0, y.data_ptr(), weight.data_ptr(),
        bias.data_ptr(), EPS, y.data_ptr(), 0)
    assert rc != 0


def test_group_norm_chunks_follow_the_shape(emulated_lib):
    """8,192 values a chunk, whatever the batch: a 4K request's rows of
    4.15 M values take 507 chunks each; a row too long for the kernels'
    32-bit indices is refused."""
    assert [emulated_lib.group_norm_chunks(n) for n in (1, 8192, 8193, 4147200)] == \
        [1, 1, 2, 507]
    assert emulated_lib.group_norm_stats(None, 0, 1, 2**31, 0, None, None) != 0


NHWC_CASES = [  # (shape, groups, vec)
    ((2, 64, 9, 16), 8, True), ((1, 64, 24, 45), 8, True),
    ((3, 16, 20, 30), 8, True), ((2, 8, 33, 40), 8, True),
    ((1, 40, 37, 30), 8, False), ((2, 12, 13, 21), 4, False),
    ((2, 256, 5, 7), 8, True), ((1, 512, 3, 5), 8, True),
]


def _nhwc_inputs(shape, dtype, seed=0):
    x, weight, bias = _inputs(shape, dtype, seed)
    rng = np.random.default_rng(seed + 1)
    dy = torch.from_numpy(rng.integers(-64, 65, shape) / 64.0).to(dtype)
    cl = torch.channels_last
    return x.contiguous(memory_format=cl), dy.contiguous(memory_format=cl), weight, bias


def _plain_grads(x, weight, bias, dy, groups):
    """float64 autograd of ``group_norm_plain``: (y, dx, dweight, dbias), and
    per channel the sum of |dy * xhat| (the terms of dweight)."""
    xd, wd, bd = (t.detach().double().requires_grad_() for t in (x, weight, bias))
    y, mean, var = gk.group_norm_plain(xd, wd, bd, groups, EPS)
    y.backward(dy.double())
    n, c = x.shape[:2]
    xh = ((xd.detach().reshape(n, groups, -1) - mean.detach()[..., None])
          * torch.rsqrt(var.detach() + EPS)[..., None]).reshape(x.shape)
    terms = (dy.double() * xh).abs().sum((0, 2, 3)) + dy.double().abs().sum((0, 2, 3))
    return y.detach(), xd.grad, wd.grad, bd.grad, terms


def _run_nhwc(lib, x, dy, weight, bias, groups, vec):
    y, stats = gk._launch_nhwc_forward(lib, x, weight, bias, groups, EPS, vec, 0)
    return (y, stats, *gk._launch_nhwc_backward(lib, x, dy, stats, weight, groups, EPS, vec, 0))


def _within_bf16_ulp(got, want, slack):
    got, want = got.double(), want.double()
    mag = torch.maximum(want.abs(), got.abs()).clamp_min(2.0 ** -120)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return bool(((got - want).abs() <= ulp + slack).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bfloat16", "float32"])
@pytest.mark.parametrize("shape,groups,vec", NHWC_CASES,
                         ids=[f"{'x'.join(map(str, s))}-g{g}-{'vec' if v else 'scalar'}"
                              for s, g, v in NHWC_CASES])
def test_group_norm_nhwc_source_matches_plain(emulated_lib, shape, groups, vec, dtype):
    """The NHWC forward and backward on channels-last input: y, mean and
    var, dx, dweight and dbias against float64 autograd; every output in
    x's layout; two calls give the same bits, and so does the scalar path
    where the vector path runs."""
    x, dy, weight, bias = _nhwc_inputs(shape, dtype)
    assert gk.nhwc_vector_path(shape[1], x, dy) or not vec
    y, stats, dx, dw, db = out = _run_nhwc(emulated_lib, x, dy, weight, bias, groups, vec)
    assert gk.channels_last(y) and gk.channels_last(dx)
    assert y.dtype == dx.dtype == dtype and dw.dtype == db.dtype == torch.float32

    y_p, dx_p, dw_p, db_p, terms = _plain_grads(x, weight, bias, dy, groups)
    _, mean_p, var_p = gk.group_norm_plain(x, weight, bias, groups, EPS)
    np.testing.assert_allclose(stats[:, 0].double(), mean_p.flatten(), rtol=1e-6)
    np.testing.assert_allclose(stats[:, 1].double(), var_p.flatten(), rtol=1e-6)
    slack = 1e-5 * float(dx_p.abs().max())
    if dtype == torch.bfloat16:
        assert _within_bf16_ulp(y, y_p.float().to(dtype), 0.0)
        assert _within_bf16_ulp(dx, dx_p.float().to(dtype), slack)
    else:
        assert float((y.double() - y_p).abs().max()) <= 2e-6 * float(y_p.abs().max())
        assert float((dx.double() - dx_p).abs().max()) <= 4e-6 * float(dx_p.abs().max()) + slack
    assert bool(((dw.double() - dw_p).abs() <= 1e-6 * terms).all())
    assert bool(((db.double() - db_p).abs() <= 1e-6 * terms).all())

    again = _run_nhwc(emulated_lib, x, dy, weight, bias, groups, vec)
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    if vec:
        scalar = _run_nhwc(emulated_lib, x, dy, weight, bias, groups, False)
        assert all(torch.equal(a, b) for a, b in zip(out, scalar))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bfloat16", "float32"])
def test_group_norm_nhwc_source_misaligned(emulated_lib, dtype):
    """A channels-last batch whose data starts off a 16-byte boundary: the
    vector path is refused with a CUDA error code, and the scalar path
    gives the aligned batch's bits."""
    x, dy, weight, bias = _nhwc_inputs((2, 64, 9, 16), dtype)

    def shifted(t):
        flat = torch.empty(t.numel() + 1, dtype=dtype)
        nhwc = flat[1:].view(t.shape[0], t.shape[2], t.shape[3], t.shape[1])
        nhwc.copy_(t.permute(0, 2, 3, 1))
        return nhwc.permute(0, 3, 1, 2)

    xs, dys = shifted(x), shifted(dy)
    assert gk.channels_last(xs) and not gk.nhwc_vector_path(64, xs)
    with pytest.raises(RuntimeError, match="group_norm_nhwc_forward"):
        gk._launch_nhwc_forward(emulated_lib, xs, weight, bias, 8, EPS, True, 0)
    want = _run_nhwc(emulated_lib, x, dy, weight, bias, 8, True)
    got = _run_nhwc(emulated_lib, xs, dys, weight, bias, 8, False)
    assert all(torch.equal(a, b) for a, b in zip(want, got))


def test_group_norm_nhwc_source_refuses_what_it_cannot_take(emulated_lib):
    """A pixel wider than the block's threads can take (C = 4,096 in bf16,
    512 slots), unknown dtypes and channels that do not split into the
    groups give -1 chunks; a chunk is 8 steps of the pixel lanes: 256
    pixels at C = 64 in bf16, 128 in f32, 8 at C = 2,048 in bf16."""
    chunks = emulated_lib.group_norm_nhwc_chunks
    assert chunks(1, 24, 128 * 256, 64, 8) == 128 and chunks(0, 24, 128 * 256, 64, 8) == 256
    assert chunks(1, 1, 540 * 960, 64, 8) == 2025
    assert chunks(1, 1, 16, 4096, 8) == -1 and chunks(1, 1, 16, 2048, 8) == 2  # 8 pixels
    assert chunks(2, 1, 16, 64, 8) == -1 and chunks(1, 1, 16, 60, 8) == -1


def test_nhwc_autograd_op_on_the_emulated_kernels(emulated_lib, monkeypatch):
    """``GroupNormNHWC`` on the emulated kernels: its forward is the
    kernels' forward, its backward takes a gradient in any layout (here
    NCHW-contiguous and expanded) to the kernels' backward of its
    channels-last copy, and the calls are counted."""
    monkeypatch.setattr(gk, "_lib", lambda: emulated_lib)
    monkeypatch.setattr(gk, "current_stream", lambda t: 0)
    monkeypatch.setattr(gk, "on_device", lambda t: contextlib.nullcontext())
    monkeypatch.setattr(gk, "_check", lambda *a: None)
    x, dy, weight, bias = _nhwc_inputs((2, 16, 20, 30), torch.bfloat16)
    w, b = weight.clone().requires_grad_(), bias.clone().requires_grad_()
    xr = x.clone().requires_grad_()
    gk.reset_launches()
    y = gk.GroupNormNHWC.apply(xr, w, b, 8, EPS)[0]
    y.backward(dy.contiguous())
    want = _run_nhwc(emulated_lib, x, dy, weight, bias, 8, True)
    assert torch.equal(y.detach(), want[0])
    assert torch.equal(xr.grad, want[2]) and gk.channels_last(xr.grad)
    assert torch.equal(w.grad, want[3]) and torch.equal(b.grad, want[4])
    assert gk.launches == {"group_norm": 1, "group_norm_backward": 1}
    (gk.GroupNormNHWC.apply(xr, w, b, 8, EPS)[0].float().sum()).backward()  # expanded dy
    assert gk.launches == {"group_norm": 2, "group_norm_backward": 2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_module_route_on_cpu_is_torchs(dtype):
    """On the CPU the module takes torch's kernel on the f32 cast, with or
    without a gradient, and counts it ``cpu``; the kernels never count."""
    x, _, _ = _inputs((2, 16, 6, 5), dtype)
    norm = GroupNorm(8, 16, dtype)
    with torch.no_grad():
        norm.weight.uniform_(0.5, 1.5)
        norm.bias.uniform_(-0.5, 0.5)
    gk.reset_launches()
    with torch.no_grad():
        y = norm(x)
    y_grad = norm(x.requires_grad_())
    want = torch.native_group_norm(x.detach().float(), norm.weight, norm.bias, 2, 16, 30,
                                   8, 1e-6)[0].to(dtype)
    assert torch.equal(y, want) and torch.equal(y_grad.detach(), want)
    assert gk.paths == {"vec": 0, "scalar": 0, "nhwc": 0, "nhwc_grad": 0, "nhwc_scalar": 0,
                        "grad": 0, "vmap": 0, "cpu": 2, "cast": 0}
    assert gk.launches == {"group_norm": 0, "group_norm_backward": 0}
    # a channels-last batch too: the CPU keeps torch's kernel
    gk.reset_launches()
    y_cl = norm(x.detach().contiguous(memory_format=torch.channels_last))
    assert torch.equal(y_cl.detach(), want) and gk.paths["cpu"] == 1


def test_module_route_under_vmap():
    """Under ``torch.func.vmap`` (the vmap pool executor) the module takes
    torch's kernel, counted ``vmap``, member by member the unbatched result
    up to the order of its sums (vmap folds the members into the rows)."""
    x, _, _ = _inputs((3, 2, 16, 4, 5), torch.float32)
    norm = GroupNorm(8, 16)
    gk.reset_launches()
    y = torch.func.vmap(norm)(x)
    assert gk.paths["vmap"] >= 1 and gk.paths["cpu"] == 0
    for i in range(3):
        torch.testing.assert_close(y[i], norm(x[i]), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_module_route_in_a_remat_block(dtype):
    """A remat block's forward runs without a graph and its backward
    recomputes the branch with one: on the CPU both take torch's kernel
    (counted ``cpu``; on the card both the NHWC kernels), so the output and
    every gradient equal the block's without remat bit for bit."""
    torch.manual_seed(0)
    block = ResidualBlock(16, compute_dtype=dtype)
    with torch.no_grad():
        for norm in (block.norm1, block.norm2):
            norm.weight.uniform_(0.5, 1.5)
            norm.bias.uniform_(-0.5, 0.5)
    x, _, _ = _inputs((2, 16, 6, 5), dtype)
    outs = {}
    for remat in (True, False):
        xr = x.clone().requires_grad_()
        gk.reset_launches()
        y = (RematBlock.apply(block, xr, *block.params()) + xr if remat
             else block(xr))
        counted = dict(gk.paths)
        grads = torch.autograd.grad(y.float().square().sum(), [xr, *block.params()])
        outs[remat] = (y.detach(), grads, counted)
    assert outs[True][2]["cpu"] == outs[False][2]["cpu"] == 2
    assert torch.equal(outs[True][0], outs[False][0])
    for a, b in zip(outs[True][1], outs[False][1]):
        assert torch.equal(a, b)
    assert gk.launches == {"group_norm": 0, "group_norm_backward": 0}


@pytest.mark.parametrize("name", gk.PROFILED_NAMES)
def test_kernel_names_land_in_the_groupnorm_group(name):
    """Each kernel's name as the profiler prints it lands in the benchmark's
    ``groupnorm`` group (``groupnorm_ms.serve`` / ``.train``), not in
    ``copy`` or ``conv``, which are tried first."""
    from h100bench.groups import group_of

    assert any(k in name for k in gk.KERNELS)
    assert group_of(name) == "groupnorm"
