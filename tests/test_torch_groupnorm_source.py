"""The CUDA source of GroupNorm's forward kernels (``csrc/group_norm.cu``)
compiled with g++ against a CPU stand-in for the CUDA runtime
(``tests/cuda_emu/``) and run on the CPU through the wrapper's
``_launch_*`` functions, stats pass → finalise → apply as the model runs
them, against the plain version in float64. This checks the kernels'
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

The module's route on the CPU (torch's kernel, counted ``cpu``; under
``torch.func.vmap``, ``vmap``; in a remat block's forward, ``remat``) and
the kernels' names in the benchmark's kernel groups are checked here too.
"""

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
    assert gk.paths == {"vec": 0, "scalar": 0, "grad": 0, "vmap": 0, "remat": 0,
                        "cpu": 2, "cast": 0}
    assert gk.launches == {"group_norm": 0}


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
    recomputes the branch with one: both take torch's kernel (the forward
    counted ``remat``, the recompute ``cpu`` here, ``grad`` on the card),
    so the output and every gradient equal the block's without remat bit
    for bit."""
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
    assert outs[True][2]["remat"] == 2 and outs[False][2]["remat"] == 0
    assert torch.equal(outs[True][0], outs[False][0])
    for a, b in zip(outs[True][1], outs[False][1]):
        assert torch.equal(a, b)
    assert gk.launches == {"group_norm": 0}


@pytest.mark.parametrize("name", gk.PROFILED_NAMES)
def test_kernel_names_land_in_the_groupnorm_group(name):
    """Each kernel's name as the profiler prints it lands in the benchmark's
    ``groupnorm`` group (``groupnorm_ms.serve`` / ``.train``), not in
    ``copy`` or ``conv``, which are tried first."""
    from h100bench.groups import group_of

    assert any(k in name for k in gk.KERNELS)
    assert group_of(name) == "groupnorm"
