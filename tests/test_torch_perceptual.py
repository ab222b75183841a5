"""The port's perceptual prior against the JAX package on the CPU: the VGG19
extractor (features at its real channel widths, the early exit, the layer
check, both packages' ``.npz`` archives both ways, the torchvision loader,
the cache and the loud random fallback), the contrastive encoder (taps,
``embed``, its archive both ways, the extractor without ``proj``), the
perceptual term, every generator step with the term (pixel, GAN, fused GAN,
the pool's scan executor), the ``Trainer`` with ``--perceptual-encoder`` and
with ``--vgg-weights`` on a JAX-written archive, and
``evaluate_model(perceptual_metric=…)``. Weights cross through
``utils/params.py``; torch cannot reproduce ``jax.random``.

Sizes: VGG on 32x32 (its widths are VGG19's, 64 to 512), the steps at F=8,
1 block, HR 32x64, D 2 stages at 8 filters, VGG taps conv1_2 and conv2_2.
Bars: features max|Δ| ≤ 1e-4·max|y|, the encoder's embedding 1e-5 abs; the
losses rel 1e-4 in fp32 (p_loss included) and 2e-2 in bf16, the adversarial
terms and the moments as tests/test_torch_gan.py sets them (each network's
Adam first moment after step 1 within GRAD_RTOL of its norm: 1e-2 fp32, 0.5
bf16). The perceptual weight is large (P_WEIGHT) so that the term's share
of the gradient is one the moments bar can see: the pixel step without it
fails that bar.
"""

import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from srgan_tpu.config import Config as JConfig
from srgan_tpu.config import DataConfig as JDataConfig
from srgan_tpu.config import ModelConfig as JModelConfig
from srgan_tpu.config import TrainConfig as JTrainConfig
from srgan_tpu.data.pipeline import TrainPipeline as JTrainPipeline
from srgan_tpu.eval import evaluation as jeval
from srgan_tpu.models import encoder as jenc
from srgan_tpu.models import vgg as jvgg
from srgan_tpu.models.srresnet import init_generator as j_init_generator
from srgan_tpu.training import stacked_pool as jsp
from srgan_tpu.training import steps as jsteps
from srgan_tpu.training import train_state as jts
from srgan_tpu.training.loop import Trainer as JTrainer
from srgan_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from srgan_tpu_torch.data.pipeline import TrainPipeline
from srgan_tpu_torch.eval import evaluation as teval
from srgan_tpu_torch.models import encoder as tenc
from srgan_tpu_torch.models import vgg as tvgg
from srgan_tpu_torch.models.srresnet import SRResNet
from srgan_tpu_torch.training import stacked_pool as tsp
from srgan_tpu_torch.training import steps as tsteps
from srgan_tpu_torch.training import train_state as tts
from srgan_tpu_torch.training.loop import Trainer
from srgan_tpu_torch.utils.params import (
    encoder_from_jax_params,
    encoder_to_jax_params,
    from_jax_params,
    vgg_from_jax_params,
    vgg_to_jax_params,
)

from test_torch_eval import _pairs, _upscalers
from test_torch_gan import (
    ADV_ATOL,
    GRAD_RTOL,
    _jax_d,
    _perturbed,
    _port_d,
    _sparse_edges,
    assert_moments_close,
    d_moments,
    g_moments,
)
from test_torch_pool import _check_pool_moments, _ds, _member_moments, _pools
from test_vgg import _FakeTorchVGG19

torch.set_num_threads(1)

SMALL_G = dict(num_features=8, num_residuals=1, upscale_factor=4)
SMALL_D = dict(num_filters=8, num_stages=2)
STEP_TAPS = ("conv1_2", "conv2_2")
ALL_TAPS = tuple(jvgg.LAYER_NAME_MAPPING.values())
P_WEIGHT = 2.0
LR = 1e-5
LOSS_REL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.fixture(scope="module")
def vgg_params():
    """JAX's VGG19 params through conv5_3 (numpy), from one init (jitted:
    flax initialises eagerly, op by op, otherwise), with random non-zero
    biases so that a dropped bias shows."""
    model = jvgg.VGG19Features(layers=ALL_TAPS)
    params = jax.jit(model.init)(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))["params"]
    rng = np.random.default_rng(7)
    return {k: {"kernel": np.asarray(v["kernel"]),
                "bias": 0.05 * rng.standard_normal(v["bias"].shape).astype(np.float32)}
            for k, v in jax.device_get(params).items()}


def _template(layers):
    """The JAX extractor's param template at ``layers``: shapes only
    (``jax.eval_shape``), all its loaders read."""
    model = jvgg.VGG19Features(layers=layers)
    return jax.eval_shape(model.init, jax.random.key(0), jnp.zeros((1, 32, 32, 3)))["params"]


def _vgg_pair(params, layers):
    """(JAX model, its params, the port's extractor) at ``layers``, the same
    weights."""
    port = tvgg.frozen(tvgg.VGG19Features(layers))
    sub = {name: params[name] for name, _ in port.named_children()}
    port.load_state_dict(vgg_from_jax_params(sub))
    return jvgg.VGG19Features(layers=layers), sub, port


@pytest.fixture(scope="module")
def jax_encoder():
    """One JAX encoder (features 8, 16; embed 16) as ``init_encoder``
    makes it, its init jitted; numpy params."""
    model = jenc.ConvEncoder(features=(8, 16), embed_dim=16)
    init = jax.jit(lambda k, x: model.init(k, x, method=jenc.ConvEncoder.embed))
    return model, jax.device_get(init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))["params"])


def _jax_encoder(jax_encoder, seed=0):
    """The JAX encoder with every leaf perturbed (biases, GroupNorm
    affines) from ``seed``."""
    model, params = jax_encoder
    return model, _perturbed(np.random.default_rng(seed), params)


def _port_encoder(model_j, params) -> tenc.ConvEncoder:
    model = tenc.ConvEncoder(model_j.features, model_j.group_norm_groups,
                             model_j.embed_dim)
    model.load_state_dict(encoder_from_jax_params(jax.device_get(params)))
    return model


def _close(got: torch.Tensor, want, rel=1e-4):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=rel * float(np.abs(want).max()), rtol=0)


class TestVGG:
    @pytest.mark.parametrize("layers", [("conv3_3", "conv4_3"), ALL_TAPS],
                             ids=["default_taps", "all_taps"])
    def test_features_match_jax(self, vgg_params, rng, layers):
        model_j, sub, port = _vgg_pair(vgg_params, layers)
        # the early exit: the convs up to the deepest tap, named as in JAX
        want_names = _template(layers)
        names = [n for n, _ in port.named_children()]
        assert sorted(names) == sorted(want_names)
        if layers[-1] == "conv4_3":
            assert names[-1] == "conv_25" and len(names) == 12
        x = rng.random((2, 32, 32, 3)).astype(np.float32)
        want = model_j.apply({"params": sub}, jnp.asarray(x))
        with torch.no_grad():
            got = port(torch.from_numpy(x))
        assert list(got) == list(layers)
        for name in layers:
            _close(got[name], want[name])
        # bf16 input is cast up: the extractor is f32 whatever the SR's dtype
        with torch.no_grad():
            got16 = port(torch.from_numpy(x).bfloat16())
        assert all(v.dtype == torch.float32 for v in got16.values())

    def test_unknown_layer_raises_as_jax(self):
        with pytest.raises(ValueError, match="unknown VGG19 layer"):
            tvgg.VGG19Features(("conv4_4",))
        with pytest.raises(ValueError, match="unknown VGG19 layer"):
            jvgg.VGG19Features(layers=("conv4_4",)).init(
                jax.random.key(0), jnp.zeros((1, 16, 16, 3)))

    def test_npz_both_ways(self, vgg_params, rng, tmp_path):
        """JAX's archive read by the port (equal features) and the port's
        read by JAX (equal arrays), through the loaders' own templates."""
        layers = ("conv3_3",)
        model_j, sub, port = _vgg_pair(vgg_params, layers)
        j_path, t_path = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
        jvgg.save_vgg19_weights_npz(sub, j_path)
        tvgg.save_vgg19_weights_npz(port, t_path)
        assert sorted(np.load(j_path).files) == sorted(np.load(t_path).files)
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)  # no fallback
            loaded = tvgg.init_vgg_extractor(layers=layers, weights_npz=j_path)
        x = rng.random((1, 32, 32, 3)).astype(np.float32)
        want = model_j.apply({"params": sub}, jnp.asarray(x))
        with torch.no_grad():
            _close(loaded(torch.from_numpy(x))["conv3_3"], want["conv3_3"])
        template = _template(layers)
        back = jvgg.load_vgg19_weights_npz(t_path, template)
        for name in sub:
            for k in ("kernel", "bias"):
                np.testing.assert_array_equal(np.asarray(back[name][k]), sub[name][k])

    @pytest.mark.parametrize("kind", ["partial", "misshaped"])
    def test_npz_partial_or_misshaped_raises_as_jax(self, tmp_path, kind):
        path = str(tmp_path / f"{kind}.npz")
        if kind == "partial":
            np.savez(path, **{"conv_0.kernel": np.zeros((3, 3, 3, 64), np.float32)})
            exc, match = KeyError, "missing"
        else:
            np.savez(path, **{
                "conv_0.kernel": np.zeros((3, 3, 3, 32), np.float32),
                "conv_0.bias": np.zeros((32,), np.float32),
                "conv_2.kernel": np.zeros((3, 3, 64, 64), np.float32),
                "conv_2.bias": np.zeros((64,), np.float32),
            })
            exc, match = ValueError, "kernel shape"
        template = _template(("conv1_2",))
        with pytest.raises(exc, match=match):
            jvgg.load_vgg19_weights_npz(path, template)
        with pytest.raises(exc, match=match):
            tvgg.init_vgg_extractor(layers=("conv1_2",), weights_npz=path)

    def test_torchvision_state_dict_cache_and_export(self, rng, tmp_path, monkeypatch):
        """A torchvision-layout ``state_dict`` (random weights, made here):
        ``load_torch_vgg19_weights`` gives torch's own features; the cached
        ``vgg19*.pth`` is found without a warning; the exported archive is
        read by JAX as the same weights."""
        torch.manual_seed(3)
        fake = _FakeTorchVGG19().eval()
        with torch.no_grad():
            for p in fake.parameters():
                p.mul_(0.2)
        hub = tmp_path / ".cache" / "torch" / "hub" / "checkpoints"
        os.makedirs(hub)
        torch.save(fake.state_dict(), hub / "vgg19-dcbb9e9d.pth")
        layers = ("conv1_2", "conv2_2", "conv3_3")
        port = tvgg.load_torch_vgg19_weights(str(hub / "vgg19-dcbb9e9d.pth"),
                                             tvgg.VGG19Features(layers))
        x = rng.random((2, 32, 32, 3)).astype(np.float32)
        with torch.no_grad():
            got = port(torch.from_numpy(x))
            want = fake.extract(torch.from_numpy(x).permute(0, 3, 1, 2), set(layers))
        for name in layers:
            _close(got[name], want[name].permute(0, 2, 3, 1).numpy())
        monkeypatch.setenv("HOME", str(tmp_path))
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)
            cached = tvgg.init_vgg_extractor(layers=layers)
        assert all(torch.equal(a, b) for a, b in zip(cached.state_dict().values(),
                                                     port.state_dict().values()))
        out = tvgg.export_torch_vgg19_to_npz(str(tmp_path / "vgg.npz"))
        template = _template(("conv5_3",))
        via_npz = jvgg.load_vgg19_weights_npz(out, template)
        via_torch = jvgg.load_torch_vgg19_weights(str(hub / "vgg19-dcbb9e9d.pth"), template)
        assert len(via_npz) == 16
        for name in template:
            for k in ("kernel", "bias"):
                np.testing.assert_array_equal(np.asarray(via_npz[name][k]),
                                              np.asarray(via_torch[name][k]))

    def test_random_fallback_warns(self, tmp_path, monkeypatch):
        """No archive, no cache: random weights with JAX's RuntimeWarning;
        flax's layout, zero biases, seeded, frozen."""
        monkeypatch.setenv("HOME", str(tmp_path))
        with pytest.warns(RuntimeWarning, match="RANDOM feature weights"):
            a = tvgg.init_vgg_extractor(seed=4)
        with pytest.warns(RuntimeWarning, match="RANDOM feature weights"):
            jvgg.init_vgg_extractor(jax.random.key(0), layers=("conv1_2",))
        with pytest.warns(RuntimeWarning, match="RANDOM feature weights"):
            b = tvgg.init_vgg_extractor(seed=4)
        tree = vgg_to_jax_params(a.state_dict())
        want = _template(("conv3_3", "conv4_3"))
        assert {k: (v["kernel"].shape, v["bias"].shape) for k, v in tree.items()} == {
            k: (v["kernel"].shape, v["bias"].shape) for k, v in want.items()}
        assert all(not v["bias"].any() for v in tree.values())
        assert all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))
        assert not any(p.requires_grad for p in a.parameters()) and not a.training

    def test_perceptual_term_matches_jax(self, vgg_params, rng):
        model_j, sub, port = _vgg_pair(vgg_params, STEP_TAPS)
        sr = rng.random((2, 32, 48, 3)).astype(np.float32)
        hr = rng.random((2, 32, 48, 3)).astype(np.float32)
        want = float(jvgg.perceptual_loss(jnp.asarray(sr), jnp.asarray(hr),
                                          model_j.apply, sub))
        got = tvgg.perceptual_loss(torch.from_numpy(sr), torch.from_numpy(hr), port)
        assert float(got) == pytest.approx(want, rel=1e-4) and want > 0
        f_real = tsteps.real_features(port, torch.from_numpy(hr))
        assert float(tsteps.perceptual_term(torch.from_numpy(sr), f_real, port)) == float(got)
        assert float(tsteps.perceptual_term(torch.from_numpy(hr), f_real, port)) == 0.0


class TestEncoder:
    def test_taps_and_embed_match_jax(self, jax_encoder, rng):
        """A non-square input (odd sizes after the first stride-2 stage):
        taps 1e-4·max, embeddings 1e-5 abs and of unit norm."""
        model_j, params = _jax_encoder(jax_encoder)
        port = _port_encoder(model_j, params)
        x = rng.random((2, 50, 66, 3)).astype(np.float32)
        want = model_j.apply({"params": params}, jnp.asarray(x))
        with torch.no_grad():
            got = port(torch.from_numpy(x))
            z = port.embed(torch.from_numpy(x))
        assert list(got) == ["stage1", "stage2"]
        assert got["stage2"].shape == (2, 13, 17, 16)
        for k in want:
            _close(got[k], want[k])
        z_j = np.asarray(model_j.apply({"params": params}, jnp.asarray(x),
                                       method=jenc.ConvEncoder.embed))
        np.testing.assert_allclose(z.numpy(), z_j, atol=1e-5, rtol=0)
        np.testing.assert_allclose(z.norm(dim=-1).numpy(), 1.0, atol=1e-5)

    def test_archive_both_ways(self, jax_encoder, rng, tmp_path):
        model_j, params = _jax_encoder(jax_encoder, 1)
        port = _port_encoder(model_j, params)
        j_path, t_path = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
        jenc.save_encoder_npz(model_j, params, j_path)
        tenc.save_encoder_npz(port, t_path)
        jf, tf = np.load(j_path), np.load(t_path)
        assert sorted(jf.files) == sorted(tf.files)
        assert bytes(jf["__meta__"]) == bytes(tf["__meta__"])
        x = rng.random((1, 32, 40, 3)).astype(np.float32)
        want = model_j.apply({"params": params}, jnp.asarray(x))
        from_jax = tenc.load_encoder_npz(j_path)
        assert from_jax.proj is not None
        model_back, params_back = jenc.load_encoder_npz(t_path)
        assert model_back.features == model_j.features
        back = model_back.apply({"params": params_back}, jnp.asarray(x))
        with torch.no_grad():
            got = from_jax(torch.from_numpy(x))
        for k in want:
            _close(got[k], want[k])
            np.testing.assert_array_equal(np.asarray(back[k]), np.asarray(want[k]))
        # the extractors drop the projection head, in both packages
        ex = tenc.init_encoder_extractor(j_path)
        assert ex.proj is None and not any(p.requires_grad for p in ex.parameters())
        assert "proj" not in encoder_to_jax_params(ex.state_dict())
        assert "proj" not in jenc.init_encoder_extractor(t_path)[1]

    def test_foreign_and_missing_archives_raise(self, tmp_path):
        foreign = str(tmp_path / "foreign.npz")
        np.savez(foreign, a=np.zeros(3))
        for load in (jenc.load_encoder_npz, tenc.load_encoder_npz):
            with pytest.raises(KeyError, match="__meta__"):
                load(foreign)
        for init in (jenc.init_encoder_extractor, tenc.init_encoder_extractor):
            with pytest.raises(FileNotFoundError):
                init(str(tmp_path / "none.npz"))

    def test_init_layout_and_alignment_loss(self, jax_encoder, rng):
        _, params = jax_encoder
        port = tenc.init_encoder(3, features=(8, 16), embed_dim=16)
        got = encoder_to_jax_params(port.state_dict())
        shapes = jax.tree.map(lambda a: a.shape, jax.device_get(params))
        assert jax.tree.map(lambda a: a.shape, got) == shapes
        assert not got["proj"]["bias"].any() and (got["gn_a_0"]["scale"] == 1).all()
        z1 = rng.standard_normal((5, 16)).astype(np.float32)
        z2 = rng.standard_normal((5, 16)).astype(np.float32)
        assert float(tenc.alignment_loss(torch.from_numpy(z1), torch.from_numpy(z2))) \
            == pytest.approx(float(jenc.alignment_loss(z1, z2)), rel=1e-6)


def _g_pair(rng, dtype="float32", seed=1):
    kw = dict(compute_dtype=dtype, **SMALL_G)
    model_j, params = j_init_generator(JModelConfig(**kw), jax.random.key(seed),
                                       sample_hw=(8, 16))
    params = _perturbed(rng, params)
    g_t = SRResNet.from_config(ModelConfig(**kw))
    g_t.load_state_dict(from_jax_params(jax.device_get(params)))
    return (jts.TrainState.create(apply_fn=model_j.apply, params=params),
            tts.TrainState(g_t))


def _batches(rng, k=3):
    return [(_sparse_edges(rng, (2, 32, 64, 3)),
             rng.random((2, 8, 16, 3)).astype(np.float32)) for _ in range(k)]


def _compare(got, want, rel_idx, dtype):
    """``rel_idx``: the packed entries held relatively (pixel terms, p_loss),
    the rest (adversarial) absolutely."""
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    is_rel = np.zeros(got.size, bool)
    is_rel[rel_idx] = True
    g, w = got.reshape(-1), want.reshape(-1)
    np.testing.assert_allclose(g[is_rel], w[is_rel], rtol=LOSS_REL[dtype], atol=1e-7)
    np.testing.assert_allclose(g[~is_rel], w[~is_rel], rtol=0, atol=ADV_ATOL[dtype])


class TestStepsWithPerceptualTerm:
    """Three steps of each generator step with the term against JAX's, the
    same weights and batches: the losses after every step, the moments
    after the first."""

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_pixel_step_matches_jax(self, vgg_params, rng, dtype):
        model_j, sub, ext = _vgg_pair(vgg_params, STEP_TAPS)
        j_state, t_state = _g_pair(rng, dtype)
        before = [p.clone() for p in ext.parameters()]
        for k, (hr, lr_imgs) in enumerate(_batches(rng)):
            j_state, m_j = jsteps.generator_pixel_step(
                j_state, jnp.asarray(hr), jnp.asarray(lr_imgs), jnp.float32(LR),
                model_j.apply, sub, P_WEIGHT)
            t_state, m_t = tsteps.generator_pixel_step(
                t_state, torch.from_numpy(hr), torch.from_numpy(lr_imgs), LR, ext,
                P_WEIGHT)
            _compare(m_t["packed"], m_j["packed"], [0, 1, 2, 4], dtype)
            assert float(m_t["p_loss"]) > 0
            if k == 0:
                assert_moments_close(g_moments(t_state), j_state.opt_state.mu,
                                     GRAD_RTOL[dtype], "G")
        # the extractor is read, never changed, and collects no gradient
        assert all(torch.equal(a, b) for a, b in zip(ext.parameters(), before))
        assert all(p.grad is None for p in ext.parameters())

    def test_term_moves_the_gradient(self, vgg_params, rng):
        """The bar sees the term: one step of the port without it (and with it
        at a tenth of its weight) fails the moments bar against JAX's step
        with it; ``generator_perceptual_step`` is the pixel step with it."""
        model_j, sub, ext = _vgg_pair(vgg_params, STEP_TAPS)
        (hr, lr_imgs), = _batches(rng, 1)
        j_state, _ = _g_pair(np.random.default_rng(0))
        j_state, _ = jsteps.generator_pixel_step(
            j_state, jnp.asarray(hr), jnp.asarray(lr_imgs), jnp.float32(LR),
            model_j.apply, sub, P_WEIGHT)
        hr_t, lr_t = torch.from_numpy(hr), torch.from_numpy(lr_imgs)
        for kw in ({}, {"extractor": ext, "p_weight": P_WEIGHT / 10}):
            _, t_state = _g_pair(np.random.default_rng(0))
            tsteps.generator_pixel_step(t_state, hr_t, lr_t, LR, **kw)
            with pytest.raises(AssertionError, match="moments rel err"):
                assert_moments_close(g_moments(t_state), j_state.opt_state.mu,
                                     GRAD_RTOL["float32"], "G")
        _, a = _g_pair(np.random.default_rng(0))
        _, b = _g_pair(np.random.default_rng(0))
        _, m_a = tsteps.generator_perceptual_step(a, ext, hr_t, lr_t, LR, P_WEIGHT)
        _, m_b = tsteps.generator_pixel_step(b, hr_t, lr_t, LR, ext, P_WEIGHT)
        assert torch.equal(m_a["packed"], m_b["packed"])
        assert_moments_close(g_moments(a), j_state.opt_state.mu, GRAD_RTOL["float32"], "G")

    def test_gan_step_matches_jax(self, vgg_params, rng):
        model_j, sub, ext = _vgg_pair(vgg_params, STEP_TAPS)
        j_state, t_state = _g_pair(rng)
        d_model_j, dp = _jax_d(rng, **SMALL_D)
        d_t = _port_d(dp, **SMALL_D)
        for k, (hr, lr_imgs) in enumerate(_batches(rng)):
            j_state, m_j = jsteps.generator_gan_step(
                j_state, d_model_j.apply, dp, jnp.asarray(hr), jnp.asarray(lr_imgs),
                jnp.float32(LR), model_j.apply, sub, P_WEIGHT, return_sr=True)
            t_state, m_t = tsteps.generator_gan_step(
                t_state, d_t, torch.from_numpy(hr), torch.from_numpy(lr_imgs), LR,
                ext, P_WEIGHT, return_sr=True)
            _compare(m_t["packed"], m_j["packed"], [0, 1, 2, 4], "float32")
            if k == 0:
                assert_moments_close(g_moments(t_state), j_state.opt_state.mu,
                                     GRAD_RTOL["float32"], "G")
                _close(m_t["sr"], m_j["sr"])

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_fused_gan_step_matches_jax(self, vgg_params, rng, dtype):
        model_j, sub, ext = _vgg_pair(vgg_params, STEP_TAPS)
        jg, tg = _g_pair(rng, dtype)
        d_kw = dict(compute_dtype=dtype, **SMALL_D)
        d_model_j, dp = _jax_d(rng, **d_kw)
        jd = jts.TrainState.create(apply_fn=d_model_j.apply, params=dp)
        td = tts.TrainState(_port_d(dp, **d_kw))
        for k, (hr, lr_imgs) in enumerate(_batches(rng)):
            jg, jd, m_j = jsteps.gan_train_step(
                jg, jd, d_model_j.apply, jnp.asarray(hr), jnp.asarray(lr_imgs),
                jnp.float32(LR), jnp.float32(LR), model_j.apply, sub, P_WEIGHT)
            tg, td, m_t = tsteps.gan_train_step(
                tg, td, torch.from_numpy(hr), torch.from_numpy(lr_imgs), LR, LR,
                ext, P_WEIGHT)
            assert m_t["packed"].shape == (6,)
            _compare(m_t["packed"], m_j["packed"], [0, 1, 2, 4], dtype)
            if k == 0:
                assert_moments_close(g_moments(tg), jg.opt_state.mu, GRAD_RTOL[dtype], "G")
                assert_moments_close(d_moments(td), jd.opt_state.mu, GRAD_RTOL[dtype], "D")

    @pytest.mark.parametrize("gan", [False, True], ids=["pixel", "gan"])
    def test_pool_steps_match_jax(self, vgg_params, rng, gan):
        """The scan executor, N=3 (GAN: mask [1, 0, 1], D on member 2's SR):
        every member's objective carries p_weight·p, p_loss is reported per
        member, and the HR features are extracted once a batch."""
        model_j, sub, ext = _vgg_pair(vgg_params, STEP_TAPS)
        model, j_states, t_states = _pools(3)
        j_stacked, stacked = jsp.stack_states(j_states), tsp.stack_states(t_states)
        d_model, jd, td = _ds()
        mask = np.asarray([1.0, 0.0, 1.0], np.float32)
        calls = []
        ext.register_forward_pre_hook(lambda m, args: calls.append(args[0]))
        px_j = dict(vgg_apply_fn=model_j.apply, vgg_params=sub, p_weight=P_WEIGHT)
        px_t = dict(extractor=ext, p_weight=P_WEIGHT)
        for k in range(3):
            hr, lr_imgs = _sparse_edges(rng, (2, 32, 64, 3)), rng.random(
                (2, 8, 16, 3)).astype(np.float32)
            hr_t = torch.from_numpy(hr)
            calls.clear()
            if gan:
                j_stacked, jd, m_j = jsp.scanned_pool_gan_step(
                    j_stacked, jd, model.apply, d_model.apply, jnp.asarray(hr),
                    jnp.asarray(lr_imgs), jnp.asarray(mask), jnp.float32(LR),
                    jnp.float32(LR), d_target_idx=np.int32(2), **px_j)
                stacked, td, m_t = tsp.scanned_pool_gan_step(
                    stacked, td, hr_t, torch.from_numpy(lr_imgs), mask, LR, LR,
                    d_target_idx=2, **px_t)
                rel = [*range(9), *range(12, 15)]  # g, com, tv, p of each member
            else:
                j_stacked, m_j = jsp.scanned_pool_step(
                    j_stacked, model.apply, None, None, jnp.asarray(hr),
                    jnp.asarray(lr_imgs), jnp.zeros(3), jnp.float32(LR), **px_j)
                stacked, m_t = tsp.scanned_pool_step(
                    stacked, hr_t, torch.from_numpy(lr_imgs), LR, **px_t)
                rel = list(range(15))
            _compare(m_t["packed"], m_j["packed"], rel, "float32")
            assert (m_t["p_loss"] > 0).all()
            # one HR extraction a batch, then one a member
            assert len(calls) == 4 and sum(c is hr_t for c in calls) == 1
            assert calls[0] is hr_t
            if k == 0:
                if gan:
                    _check_pool_moments(stacked, td, j_stacked, jd, GRAD_RTOL["float32"])
                else:
                    for i, st in enumerate(stacked):
                        assert_moments_close(g_moments(st), _member_moments(j_stacked, i),
                                             GRAD_RTOL["float32"], f"member {i}")


def _folder(path, n, seed, hw=(32, 64)):
    os.makedirs(path)
    rng = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (*hw, 3), dtype=np.uint8)).save(
            os.path.join(path, f"img_{i:02d}.png"))
    return path


class TestTrainerAndEval:
    @pytest.mark.parametrize("prior", ["encoder", "vgg_npz"])
    def test_train_epoch_matches_jax(self, vgg_params, jax_encoder, tmp_path, prior):
        """One ``Trainer.train_epoch`` of each package on one PNG folder,
        the JAX trainer's generator bridged into the port's, the prior from
        one JAX-written archive: the epoch's losses (p_loss included) rel
        1e-4. noise_std_max=0 takes every random draw out."""
        folder = _folder(str(tmp_path / "train"), 10, 0)
        if prior == "encoder":
            model_j, params = _jax_encoder(jax_encoder, 2)
            path = str(tmp_path / "enc.npz")
            jenc.save_encoder_npz(model_j, params, path)
            train = dict(perceptual_encoder_npz=path)
        else:
            path = str(tmp_path / "vgg.npz")
            jvgg.save_vgg19_weights_npz(_vgg_pair(vgg_params, STEP_TAPS)[1], path)
            train = dict(vgg_weights_npz=path, vgg_layers=STEP_TAPS)
        common = dict(
            data=dict(hr_size=(32, 64), upscale_factor=4, batch_size=2,
                      noise_std_max=0.0, num_workers=1),
            train=dict(progress="off", perceptual_weight=0.5,
                       results_dir=str(tmp_path / "results"), **train),
        )
        model = dict(upscale_factor=4, num_features=8, num_residuals=1)
        cfg_j = JConfig(model=JModelConfig(**model), data=JDataConfig(**common["data"]),
                        train=JTrainConfig(**common["train"]))
        cfg_t = Config(model=ModelConfig(**model), data=DataConfig(**common["data"]),
                       train=TrainConfig(**common["train"]))
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)  # a prior, no fallback
            trainer_j = JTrainer(cfg_j, use_mesh=False)
            trainer_t = Trainer(cfg_t, device="cpu")
        assert not any(p.requires_grad for p in trainer_t.extractor.parameters())
        trainer_t.pool.leader.state.model.load_state_dict(
            from_jax_params(jax.device_get(trainer_j.pool.members[0].state.params)))
        pipe_j = JTrainPipeline(cfg_j.data, folder, seed=0)
        pipe_t = TrainPipeline(cfg_t.data, folder, seed=0, device="cpu")
        try:
            m_j = trainer_j.train_epoch(pipe_j, 0)
            m_t = trainer_t.train_epoch(pipe_t, 0)
        finally:
            pipe_j.close()
            pipe_t.close()
        assert m_t["n_batches"] == m_j["n_batches"] == 3
        assert m_t["p_loss"] > 0
        for k in ("g_loss", "com_loss", "tv_loss", "p_loss"):
            assert m_t[k] == pytest.approx(m_j[k], rel=1e-4), k

    def test_evaluate_model_perceptual_metric_matches_jax(self, jax_encoder, tmp_path,
                                                          capsys):
        """The third slot against JAX's, rel 1e-4, with the reference's
        quirks (the ÷4 downscale, the enhancer) and without them; the
        verbose ``enc_dist=`` line."""
        root = _pairs(str(tmp_path / "pairs"), [(24, 32), (24, 32), (16, 40)])
        model_j, params = _jax_encoder(jax_encoder, 3)
        path = str(tmp_path / "enc.npz")
        jenc.save_encoder_npz(model_j, params, path)
        jup, tup = _upscalers(upscale_factor=4)
        for kw in ({}, {"extra_downscale": False, "apply_enhance": False}):
            want = jeval.evaluate_model(root, "LRbicx4", "original", upscaler=jup,
                                        verbose=False, perceptual_metric=path, **kw)
            got = teval.evaluate_model(root, "LRbicx4", "original", upscaler=tup,
                                       verbose=True, perceptual_metric=path, **kw)
            assert abs(got[0] - want[0]) <= 1e-3 and abs(got[1] - want[1]) <= 1e-5
            assert want[2] > 0 and got[2] == pytest.approx(want[2], rel=1e-4)
            out = capsys.readouterr().out
            assert "enc_dist=" in out and "average encoder perceptual distance" in out
