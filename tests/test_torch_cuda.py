"""The port's CUDA kernels on the card, against their plain versions.

A CUDA kernel has no CPU mode: every test here carries the ``cuda`` marker
and skips where ``torch.cuda.is_available()`` is False. The file imports
no JAX, so it runs on a machine with only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Inputs sit on a 1/256 grid so every stencil sum is exact in fp32 and the
sign() kinks of the gradient agree bit for bit between the kernel and the
plain version; tolerances: losses rel 1e-4, d/d sr 1e-3·max|g|.
"""

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
