"""The CUDA source of the reconstruction-loss kernels (``csrc/recon_loss.cu``,
K1-K3) compiled with g++ against a CPU stand-in for the CUDA runtime
(``tests/cuda_emu/``) and run on the CPU through the wrappers' ``_launch_*``
functions, K1 → K2 → K3 as a training step runs them, against the plain
versions in float64. This checks the kernels' arithmetic, row windows,
lane exchanges, run splitting and reductions here; whether nvcc accepts the
source, and the kernels on the card, only a chip run shows
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Inputs sit on a 1/256 grid, so every stencil sum is exact in fp32 and the
sign() kinks agree with the float64 version: hr black with one bright
square an image (sparse edges, so the TV term is live: relu(tv mean) > 0
and its gradient takes part), sr rough and independent. Bars as on the
card: losses and statistics rel 1e-4, d/d sr 1e-3·max|g|.

Every kernel runs on the path the case names. Shapes: C in 1..4; two
bands a row or one (a band is 30 float4 columns in K1 and K2, 28 in K3;
(1, 17, 33, 1) has a row narrower than a band; (2, 13, 62, 2) has 31
float4 columns, so K1's and K2's second band owns a single one beside its
halo lanes); H not a multiple of a warp's run of rows (8 here: the
stand-in's card has 2 SMs), so runs cross into the next image; W·C % 4 ==
0 on both paths, W·C % 4 != 0 on the scalar path.
"""

import numpy as np
import pytest
import torch

from cuda_emu.emu_build import compile_source
from srgan_tpu_torch.ops.cuda import recon_loss_kernel as rk

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def emulated_lib(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("recon_emu")
    return rk._bind(compile_source("recon_loss", tmp, "-DEMU_STATIC_SHARED"))


def _pair(shape, seed=0):
    rng = np.random.default_rng(seed)
    b, h, w, c = shape
    k = max(2, h // 6)
    hr = np.zeros(shape, np.int64)
    for i in range(b):
        y, x = rng.integers(0, h - k), rng.integers(0, w - k)
        hr[i, y:y + k, x:x + k] = rng.integers(128, 256, c)
    sr = rng.integers(0, 256, shape)
    return [torch.from_numpy((a / 256.0).astype(np.float32)) for a in (hr, sr)]


def _run(lib, hr, sr, vec, g_edge, g_tv):
    stats = rk._launch_edge_stats(lib, hr, vec, 0)
    edge_loss, tv_loss = rk._launch_loss_sums(lib, hr, sr, stats, vec, 0)
    dsr = rk._launch_loss_grad(lib, hr, sr, stats, torch.tensor(g_edge),
                               torch.tensor(g_tv), vec, 0)
    return stats, edge_loss, tv_loss, dsr


CASES = [
    ((2, 19, 44, 3), True), ((2, 19, 44, 3), False),
    ((1, 17, 33, 1), False),
    ((1, 9, 36, 4), True), ((1, 9, 36, 4), False),
    ((1, 21, 66, 2), True), ((1, 21, 66, 2), False),
    ((2, 13, 62, 2), True), ((2, 13, 62, 2), False),
]


@pytest.mark.parametrize("g_edge,g_tv", [(1.0, 1.0), (0.5, -2.0)])
@pytest.mark.parametrize("shape,vec", CASES,
                         ids=[f"{'x'.join(map(str, s))}-{'vec' if v else 'scalar'}"
                              for s, v in CASES])
def test_recon_source_matches_plain(emulated_lib, shape, vec, g_edge, g_tv):
    hr, sr = _pair(shape)
    assert rk.vector_path(hr, sr) or not vec
    stats, edge_loss, tv_loss, dsr = _run(emulated_lib, hr, sr, vec, g_edge, g_tv)

    hr64, sr64 = hr.double(), sr.double()
    want = rk.edge_stats_plain(hr64)
    e_p, tv_p = rk.loss_sums_plain(hr64, sr64, want)
    g_p = rk.loss_grad_plain(hr64, sr64, want, torch.tensor(g_edge, dtype=torch.float64),
                             torch.tensor(g_tv, dtype=torch.float64))
    assert float(want[3]) > 0  # the TV term and its gradient are live
    np.testing.assert_allclose(stats.double().numpy(), want.numpy(), rtol=1e-4)
    assert float(edge_loss) == pytest.approx(float(e_p), rel=1e-4)
    assert float(tv_loss) == pytest.approx(float(tv_p), rel=1e-4)
    err = float((dsr.double() - g_p).abs().max())
    assert err <= 1e-3 * float(g_p.abs().max()), f"dsr max|Δ| {err:.3e}"


@pytest.mark.parametrize("shape,vec", CASES,
                         ids=[f"{'x'.join(map(str, s))}-{'vec' if v else 'scalar'}"
                              for s, v in CASES])
def test_recon_source_edge_stats_dense(emulated_lib, shape, vec):
    """K1 on a dense hr, so that every column and row of every band and run
    carries edges: a float missed or counted twice moves the sums (the
    sparse pairs above have no edges at most band seams)."""
    rng = np.random.default_rng(2)
    hr = torch.from_numpy((rng.integers(0, 256, shape) / 256.0).astype(np.float32))
    assert rk.vector_path(hr) or not vec
    stats = rk._launch_edge_stats(emulated_lib, hr, vec, 0)
    want = rk.edge_stats_plain(hr.double())
    np.testing.assert_allclose(stats.double().numpy(), want.numpy(), rtol=1e-4)


@pytest.mark.parametrize("vec", [True, False], ids=["vec", "scalar"])
def test_recon_source_bit_identical(emulated_lib, vec):
    """Two calls give the same bits: no float atomics, fixed sum orders."""
    hr, sr = _pair((2, 19, 44, 3), seed=1)
    first, second = (_run(emulated_lib, hr, sr, vec, 1.0, 1.0) for _ in range(2))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_recon_source_refuses_misaligned_vector_path(emulated_lib):
    """Rows that do not start 16-byte aligned: ``vector_path`` picks the
    scalar path, and the entry points refuse the vector path."""
    flat = torch.zeros(1 + 9 * 36 * 4)
    hr = flat[1:].view(1, 9, 36, 4)  # contiguous, 4 bytes off
    sr = torch.zeros_like(hr)
    assert hr.is_contiguous() and not rk.vector_path(hr) and not rk.vector_path(hr, sr)
    with pytest.raises(RuntimeError, match="recon_edge_stats"):
        rk._launch_edge_stats(emulated_lib, hr, True, 0)
    stats = rk._launch_edge_stats(emulated_lib, hr, False, 0)
    with pytest.raises(RuntimeError, match="recon_loss_sums"):
        rk._launch_loss_sums(emulated_lib, hr, sr, stats, True, 0)
    with pytest.raises(RuntimeError, match="recon_loss_grad"):
        rk._launch_loss_grad(emulated_lib, hr, sr, stats, torch.tensor(1.0),
                             torch.tensor(1.0), True, 0)
    rk._launch_loss_sums(emulated_lib, hr, sr, stats, False, 0)
    odd = torch.zeros(1, 9, 33, 1)  # W·C % 4 != 0
    assert not rk.vector_path(odd, odd)


# ------------------------------------------------- the split finalise ----
# K1 and K2 end in a totals stage and a finalise; a process group sums the
# ranks' totals between the two. One rank must give the bits of no group;
# two half-batches' totals summed must give the whole batch's.


@pytest.fixture(scope="module")
def world1():
    """A one-rank gloo group, destroyed after this module."""
    import socket

    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def _run_group(lib, hr, sr, vec, g_edge, g_tv, group):
    stats = rk._launch_edge_stats(lib, hr, vec, 0, group)
    edge_loss, tv_loss = rk._launch_loss_sums(lib, hr, sr, stats, vec, 0, group)
    dsr = rk._launch_loss_grad(lib, hr, sr, stats, torch.tensor(g_edge),
                               torch.tensor(g_tv), vec, 0)
    return stats, edge_loss, tv_loss, dsr


@pytest.mark.parametrize("vec", [True, False], ids=["vec", "scalar"])
def test_recon_source_world1_group_is_bit_identical(emulated_lib, world1, vec):
    hr, sr = _pair((2, 19, 44, 3), seed=3)
    alone = _run_group(emulated_lib, hr, sr, vec, 1.0, -0.5, None)
    grouped = _run_group(emulated_lib, hr, sr, vec, 1.0, -0.5, world1)
    assert float(alone[0][3]) > 0  # the TV term and its gradient are live
    for a, b in zip(alone, grouped):
        assert torch.equal(a, b)
    assert float(alone[0][4]) == hr.numel()  # the count rides in stats


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    ia, ib = (t.contiguous().view(torch.int32).long() for t in (a, b))
    return int((ia - ib).abs().max())


@pytest.mark.parametrize("vec", [True, False], ids=["vec", "scalar"])
def test_recon_source_half_batch_totals_sum_to_the_whole(emulated_lib, vec):
    """Two ranks of one image each: their totals, summed in rank order,
    equal the two-image batch's totals to fp64 rounding, and the finalised
    statistics, losses and K3's gradient (on the global stats, each rank's
    rows) agree with the whole batch's within 1 ulp."""
    hr, sr = _pair((2, 19, 44, 3), seed=4)
    lib = emulated_lib
    whole_t, whole_stats = rk._launch_edge_totals(lib, hr, vec, 0)
    halves = [rk._launch_edge_totals(lib, hr[i:i + 1].contiguous(), vec, 0) for i in (0, 1)]
    summed = halves[0][0] + halves[1][0]
    np.testing.assert_allclose(summed.numpy(), whole_t.numpy(), rtol=1e-15, atol=0)
    stats_g = rk._launch_edge_finalize(lib, summed, halves[0][1], 0)
    stats_w = rk._launch_edge_finalize(lib, whole_t, whole_stats, 0)
    assert float(stats_g[4]) == float(stats_w[4]) == hr.numel()
    assert _ulps(stats_g[:2], stats_w[:2]) <= 1

    sums_w, losses_w = rk._launch_sums_totals(lib, hr, sr, stats_w, vec, 0)
    parts = [rk._launch_sums_totals(lib, hr[i:i + 1].contiguous(),
                                    sr[i:i + 1].contiguous(), stats_g, vec, 0)
             for i in (0, 1)]
    summed = parts[0][0] + parts[1][0]
    np.testing.assert_allclose(summed.numpy(), sums_w.numpy(), rtol=1e-12, atol=0)
    loss_g = rk._launch_sums_finalize(lib, summed, stats_g, parts[0][1], 0)
    loss_w = rk._launch_sums_finalize(lib, sums_w, stats_w, losses_w, 0)
    assert float(stats_w[3]) > 0
    for a, b in zip(loss_g, loss_w):
        assert _ulps(a.reshape(1), b.reshape(1)) <= 1
    assert _ulps(stats_g[2:4], stats_w[2:4]) <= 1

    g = (torch.tensor(1.0), torch.tensor(0.5))
    d_w = rk._launch_loss_grad(lib, hr, sr, stats_w, *g, vec, 0)
    d_g = torch.cat([rk._launch_loss_grad(lib, hr[i:i + 1].contiguous(),
                                          sr[i:i + 1].contiguous(), stats_g, *g, vec, 0)
                     for i in (0, 1)])
    err = float((d_g - d_w).abs().max())
    assert err <= 1e-6 * float(d_w.abs().max()), f"dsr max|Δ| {err:.3e}"


# ----------------------------------------------------- the member axis ----
# K2 and K3 over N members' sr against one hr (the vmap pool executor):
# member i must give the bits of the single launch on sr[i], and the float64
# pooled plain version within the bars.


@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("shape,vec", CASES,
                         ids=[f"{'x'.join(map(str, s))}-{'vec' if v else 'scalar'}"
                              for s, v in CASES])
def test_recon_source_member_axis(emulated_lib, shape, vec, n):
    lib = emulated_lib
    hr, _ = _pair(shape)
    srs = torch.stack([_pair(shape, seed=i)[1] for i in range(n)])
    assert rk.vector_path(hr, srs) or not vec
    g_edge = torch.tensor([1.0, 0.5, -1.5][:n])
    g_tv = torch.tensor([1.0, -2.0, 0.25][:n])
    stats = rk._launch_edge_stats(lib, hr, vec, 0)
    edge, tv, rows = rk._launch_loss_sums_pooled(lib, hr, srs, stats, vec, 0)
    dsr = rk._launch_loss_grad_pooled(lib, hr, srs, rows, g_edge, g_tv, vec, 0)
    for i in range(n):
        one = stats.clone()
        e_i, tv_i = rk._launch_loss_sums(lib, hr, srs[i], one, vec, 0)
        assert torch.equal(edge[i], e_i) and torch.equal(tv[i], tv_i)
        assert torch.equal(rows[i], one)
        d_i = rk._launch_loss_grad(lib, hr, srs[i], one, g_edge[i], g_tv[i], vec, 0)
        assert torch.equal(dsr[i], d_i)

    hr64, srs64 = hr.double(), srs.double()
    want_stats = rk.edge_stats_plain(hr64)
    e_p, tv_p, rows_p = rk.loss_sums_pooled_plain(hr64, srs64, want_stats)
    g_p = rk.loss_grad_pooled_plain(hr64, srs64, rows_p, g_edge.double(), g_tv.double())
    # member 0 is the case's pair, its TV term live; where another member's
    # TV mean is <= 0, its own relu gate must zero its TV gradient alone
    assert float(rows_p[0, 3]) > 0
    np.testing.assert_allclose(rows.double().numpy(), rows_p.numpy(), rtol=1e-4)
    np.testing.assert_allclose(edge.double().numpy(), e_p.numpy(), rtol=1e-4)
    np.testing.assert_allclose(tv.double().numpy(), tv_p.numpy(), rtol=1e-4)
    for i in range(n):
        err = float((dsr[i].double() - g_p[i]).abs().max())
        assert err <= 1e-3 * float(g_p[i].abs().max()), f"member {i} dsr max|Δ| {err:.3e}"
