"""The port's stencils and reconstruction loss against the JAX package:
the XLA graph (``srgan_tpu.ops.recon_loss``) and the Pallas kernels
(``reconstruction_loss_pallas``) in interpret mode, as
``tests/test_pallas.py`` runs them on the CPU.

Tolerances: loss values rel 1e-4, d/d sr rtol 1e-3 atol 1e-5 (those of
``tests/test_pallas.py``); sign() kinks at hr == sr or DIFF*sr == 0 lie on
a measure-zero set random floats do not hit. The CUDA kernels themselves
run only on the card: ``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srgan_tpu.ops.pallas.recon_loss_kernel as jrk
from srgan_tpu.ops import filters as jf
from srgan_tpu.ops import recon_loss as jrl
from srgan_tpu_torch.ops import filters as tf
from srgan_tpu_torch.ops import recon_loss as trl
from srgan_tpu_torch.ops.cuda import recon_loss_kernel as rk

torch.set_num_threads(1)


@pytest.fixture
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jrk, "_INTERPRET", True)


def _pair(rng, shape=(2, 16, 32, 3)):
    hr = rng.random(shape).astype(np.float32)
    sr = np.clip(hr + 0.1 * rng.standard_normal(shape), 0, 1).astype(np.float32)
    return hr, sr


class TestFilters:
    @pytest.mark.parametrize("name", ["SOBEL_X", "SOBEL_Y", "DIFF_KERNEL"])
    def test_kernels_equal(self, name):
        np.testing.assert_array_equal(getattr(tf, name), getattr(jf, name))

    @pytest.mark.parametrize("name", ["SOBEL_X", "DIFF_KERNEL"])
    def test_depthwise_matches_jax(self, rng, name):
        x = rng.random((2, 9, 13, 3)).astype(np.float32)
        k = getattr(jf, name)
        want = np.asarray(jf.depthwise_conv3x3(jnp.asarray(x), k))
        got = tf.depthwise_conv3x3(torch.from_numpy(x), k).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)

    def test_sobel_and_sharpen_match_jax(self, rng):
        x = rng.random((2, 9, 13, 3)).astype(np.float32)
        np.testing.assert_allclose(
            tf.sobel_edge_map(torch.from_numpy(x)).numpy(),
            np.asarray(jf.sobel_edge_map(jnp.asarray(x))), rtol=1e-6, atol=1e-5,
        )
        np.testing.assert_allclose(
            tf.sharpen(torch.from_numpy(x), 0.7).numpy(),
            np.asarray(jf.sharpen(jnp.asarray(x), 0.7)), rtol=1e-6, atol=1e-6,
        )


class TestPlainLoss:
    def test_std_is_bessel(self, rng):
        x = rng.random(1000).astype(np.float32)
        got = float(trl._std(torch.from_numpy(x)))
        assert got == pytest.approx(float(jrl._std(jnp.asarray(x))), rel=1e-5)
        assert got == pytest.approx(float(np.std(x, ddof=1)), rel=1e-5)

    def test_edge_map_matches_jax(self, rng):
        hr, _ = _pair(rng)
        np.testing.assert_allclose(
            trl.edge_importance_map(torch.from_numpy(hr)).numpy(),
            np.asarray(jrl.edge_importance_map(jnp.asarray(hr))),
            rtol=1e-5, atol=1e-5,
        )

    @pytest.mark.parametrize("shape", [(2, 16, 32, 3), (1, 13, 21, 3)])
    def test_values_match_jax_xla(self, rng, shape):
        hr, sr = _pair(rng, shape)
        e_j, tv_j = jrl.reconstruction_loss(
            jnp.asarray(hr), jnp.asarray(sr), use_pallas=False
        )
        e_t, tv_t = trl.reconstruction_loss(torch.from_numpy(hr), torch.from_numpy(sr))
        assert float(e_t) == pytest.approx(float(e_j), rel=1e-4)
        assert float(tv_t) == pytest.approx(float(tv_j), rel=1e-4)

    def test_values_match_jax_pallas(self, rng, interpret_mode):
        hr, sr = _pair(rng)
        e_j, tv_j = jrk.reconstruction_loss_pallas(jnp.asarray(hr), jnp.asarray(sr))
        e_t, tv_t = trl.reconstruction_loss(torch.from_numpy(hr), torch.from_numpy(sr))
        assert float(e_t) == pytest.approx(float(e_j), rel=1e-4)
        assert float(tv_t) == pytest.approx(float(tv_j), rel=1e-4)

    def _jax_grad(self, hr, sr, pallas):
        def loss(s):
            if pallas:
                e, tv = jrk.reconstruction_loss_pallas(jnp.asarray(hr), s)
            else:
                e, tv = jrl.reconstruction_loss(jnp.asarray(hr), s, use_pallas=False)
            return e + tv

        return np.asarray(jax.grad(loss)(jnp.asarray(sr)))

    @pytest.mark.parametrize("pallas", [False, True])
    def test_autograd_matches_jax_grad(self, rng, interpret_mode, pallas):
        hr, sr = _pair(rng, (1, 16, 32, 3))
        s = torch.from_numpy(sr).requires_grad_(True)
        e, tv = trl.reconstruction_loss(torch.from_numpy(hr), s)
        (g,) = torch.autograd.grad(e + tv, s)
        np.testing.assert_allclose(
            g.numpy(), self._jax_grad(hr, sr, pallas), rtol=1e-3, atol=1e-5
        )

    def test_tv_relu_gate(self):
        """A constant SR has DIFF*sr == 0 inside: tv ≥ 0 and the gate holds."""
        hr = torch.rand(1, 8, 8, 3, generator=torch.Generator().manual_seed(0))
        sr = torch.zeros(1, 8, 8, 3, requires_grad=True)
        e, tv = trl.reconstruction_loss(hr, sr)
        assert float(tv.detach()) == 0.0
        (g,) = torch.autograd.grad(tv, sr)
        assert float(g.abs().max()) == 0.0


class TestKernelPlainVersions:
    """The plain versions the wrappers run for CPU tensors: the same
    arithmetic as K1-K3, held against the JAX package."""

    def test_cpu_wrappers_run_plain_and_count_nothing(self, rng):
        hr, sr = (torch.from_numpy(a) for a in _pair(rng))
        rk.reset_launches()
        stats = rk.edge_stats(hr)
        e, tv = rk.loss_sums(hr, sr, stats)
        dsr = rk.loss_grad(hr, sr, stats, torch.tensor(1.0), torch.tensor(1.0))
        assert dsr.shape == sr.shape
        assert rk.launches == {"edge_stats": 0, "loss_sums": 0, "loss_grad": 0}

    def test_stats_match_jax_pallas_scalars(self, rng, interpret_mode):
        """K1's (mean, std) and K2's (Σe, tv mean) against the residuals of
        the Pallas forward."""
        hr, sr = _pair(rng)
        e_j, tv_j, (mean, std, esum, tv_mean) = jrk._forward_impl(
            jnp.asarray(hr), jnp.asarray(sr)
        )
        stats = rk.edge_stats(torch.from_numpy(hr))
        e_t, tv_t = rk.loss_sums(torch.from_numpy(hr), torch.from_numpy(sr), stats)
        got = stats.numpy()[:4]  # the count follows in stats[4]
        want = np.array([mean, std, esum, tv_mean], np.float32)
        np.testing.assert_allclose(got, want, rtol=1e-4)
        assert float(e_t) == pytest.approx(float(e_j), rel=1e-4)
        assert float(tv_t) == pytest.approx(float(tv_j), rel=1e-4)

    @pytest.mark.parametrize("g_edge,g_tv", [(1.0, 1.0), (0.5, -2.0)])
    def test_grad_matches_jax_pallas_vjp(self, rng, interpret_mode, g_edge, g_tv):
        hr, sr = _pair(rng, (1, 16, 32, 3))
        _, vjp = jax.vjp(
            lambda s: jrk.reconstruction_loss_pallas(jnp.asarray(hr), s),
            jnp.asarray(sr),
        )
        (want,) = vjp((jnp.float32(g_edge), jnp.float32(g_tv)))
        h, s = torch.from_numpy(hr), torch.from_numpy(sr)
        stats = rk.edge_stats(h)
        rk.loss_sums(h, s, stats)
        got = rk.loss_grad(h, s, stats, torch.tensor(g_edge), torch.tensor(g_tv))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-5)

    def test_autograd_function_on_cpu(self, rng):
        hr, sr = (torch.from_numpy(a) for a in _pair(rng, (1, 16, 32, 3)))
        s1 = sr.clone().requires_grad_(True)
        e1, tv1 = rk.ReconstructionLoss.apply(hr, s1)
        (g1,) = torch.autograd.grad(e1 + tv1, s1)
        e1, tv1 = e1.detach(), tv1.detach()
        s2 = sr.clone().requires_grad_(True)
        e2, tv2 = trl.reconstruction_loss(hr, s2)
        (g2,) = torch.autograd.grad(e2 + tv2, s2)
        e2, tv2 = e2.detach(), tv2.detach()
        assert float(e1) == pytest.approx(float(e2), rel=1e-6)
        assert float(tv1) == pytest.approx(float(tv2), rel=1e-6)
        torch.testing.assert_close(g1, g2, rtol=1e-3, atol=1e-9)
