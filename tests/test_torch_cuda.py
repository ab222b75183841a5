"""The port's CUDA kernels on the card, against their plain versions.

A CUDA kernel has no CPU mode: every test here carries the ``cuda`` marker
and skips where ``torch.cuda.is_available()`` is False. The file imports
no JAX, so it runs on a machine with only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Inputs sit on a 1/256 grid so every stencil sum is exact in fp32 and the
sign() kinks of the gradient agree bit for bit between the kernel and the
plain version; tolerances: losses rel 1e-4, d/d sr 1e-3·max|g|.
"""

import math

import numpy as np
import pytest
import torch

from srgan_tpu_torch.ops import recon_loss as trl
from srgan_tpu_torch.ops.cuda import recon_loss_kernel as rk
from srgan_tpu_torch.utils.platform import disable_tf32


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    disable_tf32()
    return torch.device("cuda")


def _grid_pair(shape, device):
    g = torch.Generator(device=device).manual_seed(0)
    hr_u8 = torch.randint(0, 256, shape, generator=g, device=device)
    noise = torch.randint(-9, 10, shape, generator=g, device=device)
    return hr_u8.float() / 256.0, (hr_u8 + noise).clamp(0, 255).float() / 256.0


@pytest.mark.cuda
class TestCudaKernels:
    @pytest.mark.parametrize("shape", [(2, 48, 100, 3), (1, 17, 33, 1)])
    def test_kernels_match_plain(self, cuda_device, shape):
        hr, sr = _grid_pair(shape, cuda_device)
        rk.reset_launches()
        s = sr.clone().requires_grad_(True)
        e_k, tv_k = trl.reconstruction_loss(hr, s)
        (g_k,) = torch.autograd.grad(e_k + tv_k, s)
        e_k, tv_k = e_k.detach(), tv_k.detach()
        assert rk.launches == {"edge_stats": 1, "loss_sums": 1, "loss_grad": 1}
        # the reference runs in float64: tv is a sum whose terms cancel
        # (1−e changes sign), so two fp32 summation orders already differ
        # by ~1e-4 relative while the kernel's fp64 block sums do not
        s_p = sr.cpu().double().requires_grad_(True)
        e_p, tv_p = trl.reconstruction_loss(hr.cpu().double(), s_p)
        (g_p,) = torch.autograd.grad(e_p + tv_p, s_p)
        e_p, tv_p = e_p.detach(), tv_p.detach()
        assert float(e_k) == pytest.approx(float(e_p), rel=1e-4)
        assert float(tv_k) == pytest.approx(float(tv_p), rel=1e-4)
        assert float((g_k.cpu().double() - g_p).abs().max()) <= 1e-3 * float(g_p.abs().max())

    def test_wrappers_reject_bad_input(self, cuda_device):
        x = torch.zeros(1, 8, 8, 3, device=cuda_device)
        with pytest.raises(TypeError):
            rk.edge_stats(x.double())
        with pytest.raises(ValueError):
            rk.edge_stats(x.permute(0, 2, 1, 3))
        with pytest.raises(ValueError):
            rk.edge_stats(torch.zeros(1, 8, 8, 5, device=cuda_device))

    def test_pixel_step_matches_cpu(self, cuda_device):
        """One pixel step through the kernels on the card against the same
        step through the plain versions on the CPU, same weights and batch."""
        from srgan_tpu_torch.config import ModelConfig
        from srgan_tpu_torch.models.srresnet import init_generator
        from srgan_tpu_torch.training.steps import generator_pixel_step
        from srgan_tpu_torch.training.train_state import TrainState

        rng = np.random.default_rng(0)
        hr = rng.random((2, 32, 64, 3), dtype=np.float32)
        lr_imgs = rng.random((2, 8, 16, 3), dtype=np.float32)
        cfg = ModelConfig(num_features=8, num_residuals=2)
        out = []
        for d in (cuda_device, torch.device("cpu")):
            state = TrainState(init_generator(cfg, seed=0, device=d))
            _, m = generator_pixel_step(
                state, torch.from_numpy(hr).to(d), torch.from_numpy(lr_imgs).to(d), 1e-3
            )
            out.append(m["packed"].cpu())
        np.testing.assert_allclose(out[0][:3].numpy(), out[1][:3].numpy(), rtol=1e-4)


def _sparse_pair(shape, device, seed=0):
    """hr black with one bright square an image, sr rough and independent,
    both on the 1/256 grid: the edges are sparse, so the TV term is live and
    its gradient takes part (on dense random hr it is relu-gated to 0)."""
    rng = np.random.default_rng(seed)
    b, h, w, c = shape
    k = max(2, h // 6)
    hr = np.zeros(shape, np.int64)
    for i in range(b):
        y, x = rng.integers(0, h - k), rng.integers(0, w - k)
        hr[i, y:y + k, x:x + k] = rng.integers(128, 256, c)
    sr = rng.integers(0, 256, shape)
    return [torch.from_numpy((a / 256.0).astype(np.float32)).to(device) for a in (hr, sr)]


def _misaligned(t):
    """A contiguous copy of ``t`` whose data starts 4 bytes past a 16-byte
    boundary: its rows cannot take the vector path."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


# C = 1..4; H ragged for the warps' runs of rows; W·C % 4 == 0 (both paths)
# and != 0 (scalar only); one band or several a row; (3, 70, 257, 3) has a
# row of 771 floats, (4, 300, 640, 3) a larger image set
_BAND_CASES = [
    ((2, 37, 100, 3), "vec"), ((2, 37, 100, 3), "scalar"),
    ((1, 17, 33, 1), "scalar"), ((3, 70, 257, 3), "scalar"),
    ((1, 9, 130, 4), "vec"), ((1, 9, 130, 4), "scalar"),
    ((1, 21, 66, 2), "vec"), ((1, 21, 66, 2), "scalar"),
    ((4, 300, 640, 3), "vec"),
]


@pytest.mark.cuda
class TestCudaLossPaths:
    """K1, K2 and K3 on their vector path (16-byte loads) and scalar path
    against the plain versions in float64, through the public wrappers.
    The scalar path of a shape with W·C % 4 == 0 is reached by a
    misaligned but contiguous copy, as the wrapper picks the path."""

    @pytest.mark.parametrize("shape,path", _BAND_CASES,
                             ids=[f"{'x'.join(map(str, s))}-{p}" for s, p in _BAND_CASES])
    def test_paths_match_plain(self, cuda_device, shape, path):
        hr, sr = _sparse_pair(shape, cuda_device)
        if path == "scalar" and (shape[2] * shape[3]) % 4 == 0:
            hr, sr = _misaligned(hr), _misaligned(sr)
        assert rk.vector_path(hr, sr) == (path == "vec")
        rk.reset_launches()
        g_edge = torch.tensor(0.5, device=cuda_device)
        g_tv = torch.tensor(-2.0, device=cuda_device)
        stats = rk.edge_stats(hr)
        e_k, tv_k = rk.loss_sums(hr, sr, stats)
        dsr = rk.loss_grad(hr, sr, stats, g_edge, g_tv)
        torch.cuda.synchronize()
        other = "scalar" if path == "vec" else "vec"
        assert rk.paths == {f"{name}_{p}": int(p == path)
                            for name in ("edge_stats", "loss_sums", "loss_grad")
                            for p in (path, other)}

        hr64, sr64 = hr.cpu().double(), sr.cpu().double()
        want = rk.edge_stats_plain(hr64)
        e_p, tv_p = rk.loss_sums_plain(hr64, sr64, want)
        g_p = rk.loss_grad_plain(hr64, sr64, want, g_edge.cpu().double(),
                                 g_tv.cpu().double())
        assert float(want[3]) > 0  # the TV term is live
        np.testing.assert_allclose(stats.cpu().double().numpy(), want.numpy(), rtol=1e-4)
        assert float(e_k) == pytest.approx(float(e_p), rel=1e-4)
        assert float(tv_k) == pytest.approx(float(tv_p), rel=1e-4)
        err = float((dsr.cpu().double() - g_p).abs().max())
        assert err <= 1e-3 * float(g_p.abs().max())

    @pytest.mark.parametrize("path", ["vec", "scalar"])
    def test_two_calls_bit_identical(self, cuda_device, path):
        hr, sr = _sparse_pair((2, 37, 100, 3), cuda_device, seed=1)
        if path == "scalar":
            hr, sr = _misaligned(hr), _misaligned(sr)
        one = torch.ones((), device=cuda_device)
        runs = []
        for _ in range(2):
            st = rk.edge_stats(hr)
            runs.append([st[:2].clone(), *rk.loss_sums(hr, sr, st), st,
                         rk.loss_grad(hr, sr, st, one, one)])
        for a, b in zip(*runs):
            assert torch.equal(a, b)


def _tower_inputs(shape, n, margin, device):
    """x, dy and TowerParams on ``device``. ``margin``: GN1 scale 0.1 and
    bias 1.0, so GN1's output stays above 0 and the ReLU never clips (see
    ``test_tower_kernels_match_plain``); else the JAX tests' values."""
    from srgan_tpu_torch.ops.cuda import residual_tower_kernel as tk

    rng = np.random.default_rng(0)
    f = shape[-1]
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)
    w = lambda: t(rng.standard_normal((n, 3, 3, f, f)) / np.sqrt(9 * f))
    full = lambda v: t(np.full((n, f), v))
    params = tk.TowerParams(w(), full(0.1 if margin else 1.1),
                            full(1.0 if margin else 0.05), w(), full(0.9), full(-0.02))
    return t(rng.standard_normal(shape)), t(rng.standard_normal(shape)), params


@pytest.mark.cuda
class TestCudaTower:
    """K4 and K5 against the plain version and its autograd, at shapes whose
    H and W are not multiples of the conv tiles (f32: 16 x 16 pixels at
    F=64, 8 x 16 at F=128; bf16: 8 x 16) nor of the wgrad tiles' 8 x 16;
    F=128 is the tiles' largest shared-memory footprint (118 KB a bf16
    conv block, 217 KB an f32 wgrad block) and their F_out split. Bars:
    max|Δ| ≤ 1e-3·max (f32) and 2e-2·max (bf16) for y, and for every
    gradient where the ReLU never clips (``margin``). With the JAX tests'
    GN values the ReLU clips,
    and a value within rounding of a kink can fall on one side in the
    kernel and on the other in the plain version (other f32 summation
    orders), where the gradient jumps: there the gradients are held to
    ||Δ||/||g|| ≤ 1e-2 (f32) / 1e-1 (bf16), as in chip_smoke.py."""

    @pytest.mark.parametrize("margin", [True, False], ids=["margin", "clips"])
    @pytest.mark.parametrize("shape,n", [((2, 9, 21, 16), 2), ((1, 16, 32, 64), 3),
                                         ((1, 12, 20, 128), 2), ((3, 17, 35, 64), 2)])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_tower_kernels_match_plain(self, cuda_device, shape, n, dtype, margin):
        from srgan_tpu_torch.ops.cuda import residual_tower_kernel as tk

        cd = getattr(torch, dtype)
        tol = 1e-3 if cd == torch.float32 else 2e-2
        norm_tol = 1e-2 if cd == torch.float32 else 1e-1
        x, dy, params = _tower_inputs(shape, n, margin, cuda_device)
        outs = []
        for fn in (tk.residual_tower, tk.residual_tower_plain):
            tk.reset_launches()
            xr = x.clone().requires_grad_(True)
            pr = [p.clone().requires_grad_(True) for p in params]
            y = fn(xr, tk.TowerParams(*pr), cd)
            grads = torch.autograd.grad(y, [xr, *pr], dy)
            outs.append([y.detach(), *grads])
            if fn is tk.residual_tower:
                assert tk.launches == {"tower_fwd": 1, "tower_bwd": 1}
        assert tk.launches == {"tower_fwd": 0, "tower_bwd": 0}
        for name, a, b in zip(["y", "dx", *tk.TowerParams._fields], *outs):
            if margin or name == "y":
                err = float((a - b).abs().max() / b.abs().max())
                assert err <= tol, f"{name}: max|Δ| {err:.2e}·max > {tol}"
            else:
                err = float((a - b).norm() / b.norm())
                assert err <= norm_tol, f"{name}: ||Δ||/||g|| {err:.2e} > {norm_tol}"

    def test_tower_wrappers_reject_bad_input(self, cuda_device):
        from srgan_tpu_torch.ops.cuda import residual_tower_kernel as tk

        x, dy, params = _tower_inputs((1, 8, 8, 16), 1, False, cuda_device)
        with pytest.raises(ValueError, match="contiguous"):
            tk.tower_fwd(x.transpose(1, 2), params)
        with pytest.raises(TypeError):
            tk.tower_fwd(x.double(), params)
        with pytest.raises(TypeError):
            tk.tower_bwd(dy, x, tk.TowerParams(*(p.double() for p in params)))
        x12, _, p12 = _tower_inputs((1, 8, 8, 12), 1, False, cuda_device)
        with pytest.raises(ValueError, match="multiple of 8"):
            tk.tower_fwd(x12, p12)
        x24, _, p24 = _tower_inputs((1, 8, 8, 24), 1, False, cuda_device)
        with pytest.raises(ValueError, match="16, 32, 64, 128"):
            tk.residual_tower(x24, p24)


# W·C % 4 == 0 takes the vector path, != 0 the scalar one
_MEMBER_CASES = [((2, 37, 100, 3), "vec"), ((1, 21, 66, 2), "vec"),
                 ((1, 17, 33, 1), "scalar"), ((3, 70, 257, 3), "scalar")]


@pytest.mark.cuda
class TestCudaMemberAxis:
    """K2 and K3 over a member axis (the vmap pool executor): each member
    bit-identical to the single launch on its sr, and the pooled Function
    under ``torch.func.vmap`` in a pool step against the CPU."""

    @pytest.mark.parametrize("shape,path", _MEMBER_CASES,
                             ids=[f"{'x'.join(map(str, s))}-{p}" for s, p in _MEMBER_CASES])
    def test_member_axis_matches_single_launches(self, cuda_device, shape, path):
        hr, _ = _sparse_pair(shape, cuda_device)
        srs = torch.stack([_sparse_pair(shape, cuda_device, seed=i)[1] for i in range(3)])
        assert rk.vector_path(hr, srs) == (path == "vec")
        ge = torch.tensor([1.0, 0.5, -1.5], device=cuda_device)
        gt = torch.tensor([1.0, -2.0, 0.25], device=cuda_device)
        rk.reset_launches()
        stats = rk.edge_stats(hr)
        edge, tv, rows = rk.loss_sums_pooled(hr, srs, stats)
        dsr = rk.loss_grad_pooled(hr, srs, rows, ge, gt)
        assert rk.pooled == {"loss_sums": 1, "loss_grad": 1}
        for i in range(3):
            one = stats.clone()
            e_i, tv_i = rk.loss_sums(hr, srs[i], one)
            d_i = rk.loss_grad(hr, srs[i], one, ge[i], gt[i])
            assert torch.equal(edge[i], e_i) and torch.equal(tv[i], tv_i)
            assert torch.equal(rows[i], one) and torch.equal(dsr[i], d_i)
        hr64, srs64 = hr.cpu().double(), srs.cpu().double()
        e_p, tv_p, rows_p = rk.loss_sums_pooled_plain(hr64, srs64, rk.edge_stats_plain(hr64))
        g_p = rk.loss_grad_pooled_plain(hr64, srs64, rows_p, ge.cpu().double(),
                                        gt.cpu().double())
        np.testing.assert_allclose(edge.cpu().double(), e_p, rtol=1e-4)
        np.testing.assert_allclose(tv.cpu().double(), tv_p, rtol=1e-4)
        for i in range(3):
            err = float((dsr[i].cpu().double() - g_p[i]).abs().max())
            assert err <= 1e-3 * float(g_p[i].abs().max())

    def test_vmap_pool_step_matches_cpu(self, cuda_device):
        """One pixel step of the vmap executor (N=3) on the card, its loss
        through one K1, K2 and K3 launch, against the same step on the CPU."""
        from srgan_tpu_torch.config import ModelConfig
        from srgan_tpu_torch.models.srresnet import init_generator
        from srgan_tpu_torch.training.stacked_pool import stacked_pool_step
        from srgan_tpu_torch.training.train_state import TrainState

        rng = np.random.default_rng(0)
        hr = rng.random((2, 32, 64, 3), dtype=np.float32)
        lr_imgs = rng.random((2, 8, 16, 3), dtype=np.float32)
        cfg = ModelConfig(num_features=8, num_residuals=2)
        out = []
        for d in (cuda_device, torch.device("cpu")):
            states = [TrainState(init_generator(cfg, seed=i, device=d)) for i in range(3)]
            rk.reset_launches()
            _, m = stacked_pool_step(states, torch.from_numpy(hr).to(d),
                                     torch.from_numpy(lr_imgs).to(d), 1e-3)
            out.append((m["packed"].cpu(), dict(rk.launches)))
        assert out[0][1] == {"edge_stats": 1, "loss_sums": 1, "loss_grad": 1}
        np.testing.assert_allclose(out[0][0][:3].numpy(), out[1][0][:3].numpy(), rtol=1e-4)

    def test_vmap_remat_pool_step_matches_cpu(self, cuda_device):
        """One pixel step of the vmap executor (N=3) on remat models on the
        card: its losses equal the card's step without remat bit for bit and
        the CPU's remat step at rel 1e-4, the members' Adam moments (their
        gradients) the CPU's at 1e-2 of their norm; one K1, K2 and K3
        launch."""
        from srgan_tpu_torch.config import ModelConfig
        from srgan_tpu_torch.models.srresnet import init_generator
        from srgan_tpu_torch.training.stacked_pool import stacked_pool_step
        from srgan_tpu_torch.training.train_state import TrainState

        rng = np.random.default_rng(0)
        hr = rng.random((2, 32, 64, 3), dtype=np.float32)
        lr_imgs = rng.random((2, 8, 16, 3), dtype=np.float32)
        out = {}
        for d, remat in ((cuda_device, True), (cuda_device, False),
                         (torch.device("cpu"), True)):
            cfg = ModelConfig(num_features=8, num_residuals=2, remat=remat)
            states = [TrainState(init_generator(cfg, seed=i, device=d)) for i in range(3)]
            rk.reset_launches()
            states, m = stacked_pool_step(states, torch.from_numpy(hr).to(d),
                                          torch.from_numpy(lr_imgs).to(d), 1e-3)
            out[d.type, remat] = (m["packed"].cpu(), dict(rk.launches),
                                  torch.cat([mu.cpu().flatten() for st in states for mu in st.mu]))
        card, plain, cpu = out["cuda", True], out["cuda", False], out["cpu", True]
        assert card[1] == {"edge_stats": 1, "loss_sums": 1, "loss_grad": 1}
        assert torch.equal(card[0], plain[0])
        np.testing.assert_allclose(card[0][:3].numpy(), cpu[0][:3].numpy(), rtol=1e-4)
        assert float((card[2] - cpu[2]).norm()) <= 1e-2 * float(cpu[2].norm())


def _bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got − want| in bf16 ulps at the larger magnitude."""
    got, want = got.double(), want.double()
    mag = torch.maximum(got.abs(), want.abs()).clamp_min(2.0 ** -120)
    return float(((got - want).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)).max())


@pytest.mark.cuda
class TestCudaGroupNorm:
    """GroupNorm's forward kernels (``csrc/group_norm.cu``) against torch's
    ``native_group_norm`` on the f32 cast (the route they replace) and the
    float64 plain version, at the serving shape (a 4K request's LR 540x960,
    batch 1) and the scoring shape (batch 24 of 128x256), bf16 in and out;
    and the module's routes on the card."""

    @pytest.mark.parametrize("shape", [(1, 64, 540, 960), (24, 64, 128, 256)],
                             ids=["serve", "score"])
    def test_kernel_matches_native(self, cuda_device, shape):
        from srgan_tpu_torch.ops.cuda import group_norm_kernel as gk

        g = torch.Generator(device=cuda_device).manual_seed(0)
        x = (torch.randn(shape, generator=g, device=cuda_device) * 1.5 + 0.3).bfloat16()
        w = torch.rand(64, generator=g, device=cuda_device) + 0.5
        b = torch.rand(64, generator=g, device=cuda_device) - 0.5
        gk.reset_launches()
        y = gk.group_norm_cuda(x, w, b, 8, 1e-6)
        y2 = gk.group_norm_cuda(x, w, b, 8, 1e-6)
        torch.cuda.synchronize()
        assert gk.launches == {"group_norm": 2} and gk.paths["vec"] == 2
        assert torch.equal(y, y2)  # fixed-order sums: the same bits twice
        # the float64 plain version (on a part of the scoring batch): within
        # one bf16 ulp of its result rounded once
        n = 1 if shape[0] == 1 else 2
        y_p, _, _ = gk.group_norm_plain(x[:n], w, b, 8, 1e-6)
        assert _bf16_ulps(y[:n], y_p.float().bfloat16()) <= 1
        # torch's route: its f32 statistics over 4.1 M values a row move
        # outputs near 0 by several of their own ulps, so the bar is one ulp
        # at the largest |y|
        native = gk.native_group_norm(x, w, b, 8, 1e-6, torch.bfloat16)
        top = float(native.abs().max())
        assert float((y.double() - native.double()).abs().max()) <= 2.0 ** (math.floor(math.log2(top)) - 7)

    def test_kernel_names_are_the_listed_ones(self, cuda_device):
        """Every instance the model can launch shows in the profiler under a
        name of ``PROFILED_NAMES`` (which the CPU test files under the
        benchmark's ``groupnorm`` group)."""
        from torch.profiler import ProfilerActivity, profile

        from srgan_tpu_torch.ops.cuda import group_norm_kernel as gk

        x = torch.randn(2, 16, 9, 16, device=cuda_device)
        w, b = torch.ones(16, device=cuda_device), torch.zeros(16, device=cuda_device)
        odd = torch.randn(2, 16, 7, 5, device=cuda_device)  # the scalar path
        with profile(activities=[ProfilerActivity.CUDA]):  # starts device tracing
            gk.group_norm_cuda(x, w, b, 8, 1e-6)
            torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for t in (x, odd):
                for dt in (torch.float32, torch.bfloat16):
                    gk.group_norm_cuda(t.to(dt), w, b, 8, 1e-6)
            torch.cuda.synchronize()
        names = {e.name for e in prof.events() if "group_norm" in e.name}
        assert names == set(gk.PROFILED_NAMES), sorted(names)

    def test_kernel_wrapper_rejects_bad_input(self, cuda_device):
        from srgan_tpu_torch.ops.cuda import group_norm_kernel as gk

        x = torch.zeros(1, 16, 4, 4, device=cuda_device)
        w, b = torch.ones(16, device=cuda_device), torch.zeros(16, device=cuda_device)
        with pytest.raises(TypeError):
            gk.group_norm_cuda(x.double(), w, b, 8, 1e-6)
        with pytest.raises(ValueError):
            gk.group_norm_cuda(x, w, b, 5, 1e-6)
        with pytest.raises(ValueError):
            gk.group_norm_cuda(x, w.cpu(), b, 8, 1e-6)
        with pytest.raises(ValueError):
            gk.group_norm_cuda(x, w.bfloat16(), b, 8, 1e-6)

    def test_grad_route_keeps_torchs_bits(self, cuda_device):
        """With a gradient the module runs torch's kernel on the f32 cast, as
        before the kernels existed, and counts ``grad``; its backward runs."""
        from srgan_tpu_torch.models.srresnet import GroupNorm
        from srgan_tpu_torch.ops.cuda import group_norm_kernel as gk

        norm = GroupNorm(8, 64, torch.bfloat16).to(cuda_device)
        x = torch.randn(2, 64, 24, 40, device=cuda_device).bfloat16().requires_grad_()
        gk.reset_launches()
        y = norm(x)
        xf = x.detach().float()
        want = torch.native_group_norm(xf, norm.weight, norm.bias, 2, 64, 960, 8,
                                       1e-6)[0].bfloat16()
        assert torch.equal(y.detach(), want)
        y.float().sum().backward()
        assert x.grad is not None and norm.weight.grad is not None
        assert gk.paths["grad"] == 1 and gk.launches == {"group_norm": 0}

    def test_vmap_route(self, cuda_device):
        from srgan_tpu_torch.models.srresnet import GroupNorm
        from srgan_tpu_torch.ops.cuda import group_norm_kernel as gk

        norm = GroupNorm(8, 16).to(cuda_device)
        x = torch.randn(3, 2, 16, 6, 5, device=cuda_device)
        gk.reset_launches()
        with torch.no_grad():
            torch.func.vmap(norm)(x)
        assert gk.paths["vmap"] >= 1 and gk.launches == {"group_norm": 0}

    def test_4k_request_takes_the_kernels(self, cuda_device):
        """One ``upscale_u8`` of a 4K frame (LR 540x960) in bf16 at the
        flagship width: 32 norms, all by the kernels' vector path, none by
        torch's; the same request twice gives the same bytes."""
        from srgan_tpu_torch.config import ModelConfig
        from srgan_tpu_torch.eval.inference import Upscaler
        from srgan_tpu_torch.models.srresnet import init_generator
        from srgan_tpu_torch.ops.cuda import group_norm_kernel as gk

        model = init_generator(ModelConfig(compute_dtype="bfloat16"), seed=0,
                               device=cuda_device)
        up = Upscaler(model, device=cuda_device)
        img = np.random.default_rng(0).integers(0, 256, (540, 960, 3), dtype=np.uint8)
        gk.reset_launches()
        out = up.upscale_u8(img)
        assert out.shape == (2160, 3840, 3)
        assert gk.launches == {"group_norm": 32}
        assert gk.paths == {"vec": 32, "scalar": 0, "grad": 0, "vmap": 0, "remat": 0,
                            "cpu": 0, "cast": 0}
        assert np.array_equal(out, up.upscale_u8(img))

    def test_fetch_hands_each_caller_its_own_array(self, cuda_device):
        """``upscale_u8`` and ``upscale`` fetch into page-locked memory from
        torch's caching host allocator: a result the caller keeps is not
        written by the next requests, and it equals a plain ``.cpu()`` of
        the same forward."""
        from srgan_tpu_torch.config import ModelConfig
        from srgan_tpu_torch.eval.inference import Upscaler
        from srgan_tpu_torch.models.srresnet import init_generator

        model = init_generator(ModelConfig(num_features=16, num_residuals=2,
                                           compute_dtype="bfloat16"),
                               seed=0, device=cuda_device)
        up = Upscaler(model, device=cuda_device)
        rng = np.random.default_rng(0)
        imgs = [rng.integers(0, 256, (48, 80, 3), dtype=np.uint8) for _ in range(3)]
        with torch.no_grad():
            want = [up._run(up._batch(im)[0], u8=True).cpu().numpy()[0] for im in imgs]
        kept = [up.upscale_u8(im) for im in imgs]  # each kept while the next runs
        for _ in range(4):  # blocks dropped and taken again
            up.upscale_u8(imgs[0])
        for got, w in zip(kept, want):
            assert np.array_equal(got, w)
        assert len({a.__array_interface__["data"][0] for a in kept}) == 3
        f = up.upscale(imgs[1])
        assert f.dtype == np.float32 and f.shape == (192, 320, 3)
        assert np.array_equal(kept[1], want[1])

    def test_remat_step_matches_without_remat(self, cuda_device):
        """One bf16 pixel step of a remat generator on the card equals the
        step without remat bit for bit (losses, SR, every updated param):
        the remat block's forward takes torch's GroupNorm, as its
        backward's recompute does, and no norm of the step takes the
        kernels."""
        from srgan_tpu_torch.config import ModelConfig
        from srgan_tpu_torch.models.srresnet import init_generator
        from srgan_tpu_torch.ops.cuda import group_norm_kernel as gk
        from srgan_tpu_torch.training.steps import generator_pixel_step
        from srgan_tpu_torch.training.train_state import TrainState

        rng = np.random.default_rng(0)
        hr = torch.from_numpy(rng.random((2, 256, 256, 3), dtype=np.float32)).to(cuda_device)
        lr_imgs = torch.from_numpy(rng.random((2, 64, 64, 3), dtype=np.float32)).to(cuda_device)
        out = {}
        for remat in (True, False):
            cfg = ModelConfig(num_features=64, num_residuals=4, remat=remat,
                              compute_dtype="bfloat16")
            state = TrainState(init_generator(cfg, seed=0, device=cuda_device))
            gk.reset_launches()
            state, m = generator_pixel_step(state, hr, lr_imgs, 1e-3, return_sr=True)
            torch.cuda.synchronize()
            out[remat] = (m["packed"].cpu(), m["sr"].cpu(),
                          [p.detach().cpu() for p in state.params], dict(gk.paths),
                          dict(gk.launches))
        remat, plain = out[True], out[False]
        assert remat[3]["remat"] == 8 and plain[3]["remat"] == 0
        assert remat[4] == plain[4] == {"group_norm": 0}
        assert torch.equal(remat[0], plain[0]) and torch.equal(remat[1], plain[1])
        assert all(torch.equal(a, b) for a, b in zip(remat[2], plain[2]))


@pytest.mark.cuda
class TestWindowAttention:
    """SwinIR's windowed attention kernels (``csrc/window_attention.cu``)
    against the op's plain route in float64 on the card, and SwinIR through
    them against the CPU's plain route. bf16 takes the tensor-core kernels,
    f32 the CUDA-core ones, as ``launches`` counts by design. Bars as
    ``tests/test_torch_window_attn_source.py`` holds the emulated source:
    f32 2e-5 of the largest magnitude; bf16 out one bf16 ulp at it, dqkv
    1e-2 (rounded to bf16), dbias 2e-3 (the CUDA-core backward's D_i reads
    the rounded O)."""

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
    @pytest.mark.parametrize("grid,heads,window,shift", [
        ((2, 32, 48), 6, 8, 4), ((2, 32, 48), 6, 8, 0), ((3, 12, 20), 3, 4, 2)])
    def test_kernels_match_plain(self, cuda_device, dtype, grid, heads, window, shift):
        from srgan_tpu_torch.ops import window_attention as wa
        from srgan_tpu_torch.ops.cuda import window_attention_kernel as wk

        b, h, w = grid
        d, n = (30 if window == 8 else 12), window * window
        g = torch.Generator(device=cuda_device).manual_seed(0)
        qkv = torch.randn((b, h * w, 3 * heads * d), generator=g, device=cuda_device).to(dtype)
        bias = torch.randn((heads, n, n), generator=g, device=cuda_device) * 0.5
        dout = torch.randn((b, h * w, heads * d), generator=g, device=cuda_device).to(dtype)
        wa.reset_paths()
        wk.reset_launches()
        x = qkv.clone().requires_grad_()
        bb = bias.clone().requires_grad_()
        out = wa.window_attention(x, bb, heads, window, shift, grid)
        dq, db = torch.autograd.grad(out, [x, bb], dout)
        assert wa.paths == {"cuda": 1, "cpu": 0}
        design, other = ("mma", "simt") if dtype == torch.bfloat16 else ("simt", "mma")
        assert wk.launches == {"forward": 1, "backward": 1, f"forward_{design}": 1,
                               f"backward_{design}": 1, f"forward_{other}": 0,
                               f"backward_{other}": 0}
        x64 = qkv.double().requires_grad_()
        b64 = bias.double().requires_grad_()
        o64 = wa.window_attention_plain(x64, b64, heads, window, shift, grid)
        dq64, db64 = torch.autograd.grad(o64, [x64, b64], dout.double())
        rel = lambda a, e: float((a.double() - e).abs().max() / e.abs().max())  # noqa: E731
        bars = (2.0 ** -7, 1e-2, 2e-3) if dtype == torch.bfloat16 else (2e-5, 2e-5, 2e-5)
        assert out.dtype == dq.dtype == dtype and db.dtype == torch.float32
        for got, want, bar in zip((out, dq, db), (o64.detach(), dq64, db64), bars):
            assert rel(got, want) <= bar

    def test_dbias_is_bit_identical_across_runs(self, cuda_device):
        from srgan_tpu_torch.ops.cuda import window_attention_kernel as wk

        grid, heads, window, shift = (4, 64, 64), 6, 8, 4
        g = torch.Generator(device=cuda_device).manual_seed(1)
        qkv = torch.randn((4, 4096, 540), generator=g, device=cuda_device).bfloat16()
        bias = torch.randn((heads, 64, 64), generator=g, device=cuda_device) * 0.5
        dout = torch.randn((4, 4096, 180), generator=g, device=cuda_device).bfloat16()
        runs = []
        for _ in range(2):
            out, lse = wk.window_attention_cuda(qkv, bias, heads, window, shift, grid)
            runs.append((out, *wk.window_attention_backward_cuda(qkv, bias, out, lse, dout,
                                                                 heads, window, shift, grid)))
        for a, b in zip(*runs):
            assert torch.equal(a, b)

    @pytest.mark.parametrize("shift", [4, 0])
    def test_bf16_kernels_at_the_step_shape(self, cuda_device, shift):
        """The tensor-core kernels at SwinIR-M x4's training step (32 x 64 x
        64 tokens, 6 heads of 30, window 8) against the plain route in
        float64, at the emulated test's bf16 bars; two launches give the
        same bits, and only the mma design ran."""
        from srgan_tpu_torch.ops import window_attention as wa
        from srgan_tpu_torch.ops.cuda import window_attention_kernel as wk

        grid, heads, window = (32, 64, 64), 6, 8
        g = torch.Generator(device=cuda_device).manual_seed(2 + shift)
        qkv = torch.randn((32, 4096, 540), generator=g, device=cuda_device).bfloat16()
        bias = torch.randn((heads, 64, 64), generator=g, device=cuda_device) * 0.5
        dout = torch.randn((32, 4096, 180), generator=g, device=cuda_device).bfloat16()
        wk.reset_launches()
        runs = []
        for _ in range(2):
            out, lse = wk.window_attention_cuda(qkv, bias, heads, window, shift, grid)
            runs.append((out, lse, *wk.window_attention_backward_cuda(
                qkv, bias, out, lse, dout, heads, window, shift, grid)))
        assert wk.launches == {"forward": 2, "backward": 2, "forward_mma": 2, "backward_mma": 2,
                               "forward_simt": 0, "backward_simt": 0}
        for a, b in zip(*runs):
            assert torch.equal(a, b)
        out, _, dq, db = runs[0]
        del runs
        x64 = qkv.double().requires_grad_()
        b64 = bias.double().requires_grad_()
        o64 = wa.window_attention_plain(x64, b64, heads, window, shift, grid)
        dq64, db64 = torch.autograd.grad(o64, [x64, b64], dout.double())
        want = o64.detach().float().bfloat16().double()
        mag = torch.maximum(want.abs(), out.double().abs()).clamp_min(2.0 ** -120)
        ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
        assert bool(((out.double() - want).abs() <= ulp + 1e-6 * float(want.abs().max())).all())
        rel = lambda a, e: float((a.double() - e).abs().max() / e.abs().max())  # noqa: E731
        assert rel(dq, dq64) <= 1e-2 and rel(db, db64) <= 2e-3

    def test_swinir_bf16_step_takes_the_mma_kernels(self, cuda_device):
        """A small SwinIR (2 groups of 2 layers) in bf16: one forward and
        backward launch the tensor-core kernels once a layer each and the
        CUDA-core kernels never."""
        from srgan_tpu_torch.config import ModelConfig
        from srgan_tpu_torch.models import init_generator
        from srgan_tpu_torch.ops.cuda import window_attention_kernel as wk

        cfg = ModelConfig(generator="swinir", embed_dim=36, depths=(2, 2), num_heads=(3, 3),
                          window_size=4, num_features=16, compute_dtype="bfloat16")
        card = init_generator(cfg, seed=0, device=cuda_device)
        x = torch.rand(2, 12, 20, 3, generator=torch.Generator().manual_seed(0))
        wk.reset_launches()
        y = card(x.to(cuda_device))
        torch.autograd.grad(y.float().square().mean(), list(card.parameters()))
        assert wk.launches == {"forward": 4, "backward": 4, "forward_mma": 4, "backward_mma": 4,
                               "forward_simt": 0, "backward_simt": 0}

    def test_swinir_on_the_card_matches_the_cpu(self, cuda_device):
        """A small SwinIR (embed 36, 2 groups of 2 layers, 3 heads of 12,
        window 4) in fp32 on a non-multiple-of-window image: the card's
        output (the kernels) within 1e-4 of max|y| of the CPU's (the plain
        route), and its gradients within 1e-3 of each leaf's norm."""
        from srgan_tpu_torch.config import ModelConfig
        from srgan_tpu_torch.models import init_generator
        from srgan_tpu_torch.ops.cuda import window_attention_kernel as wk

        cfg = ModelConfig(generator="swinir", embed_dim=36, depths=(2, 2), num_heads=(3, 3),
                          window_size=4, num_features=16)
        cpu = init_generator(cfg, seed=0)
        card = init_generator(cfg, seed=0, device=cuda_device)
        x = torch.rand(2, 12, 20, 3, generator=torch.Generator().manual_seed(0))
        wk.reset_launches()
        y_card = card(x.to(cuda_device))
        g_card = torch.autograd.grad(y_card.square().mean(), list(card.parameters()))
        assert wk.launches == {"forward": 4, "backward": 4, "forward_mma": 0, "backward_mma": 0,
                               "forward_simt": 4, "backward_simt": 4}
        y_cpu = cpu(x)
        g_cpu = torch.autograd.grad(y_cpu.square().mean(), list(cpu.parameters()))
        assert float((y_card.detach().cpu() - y_cpu).abs().max()) <= \
            1e-4 * float(y_cpu.abs().max())
        for a, b in zip(g_card, g_cpu):
            assert float((a.cpu() - b).norm()) <= 1e-3 * max(float(b.norm()), 1e-12)
