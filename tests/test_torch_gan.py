"""The port's GAN phase against the JAX package: the discriminator (forward
in fp32 and bf16, ``min_input_size``, its refusals, the weight bridge), the
three adversarial losses, and the GAN steps (``generator_gan_step``,
``gan_train_step``, ``discriminator_step``, ``discriminator_step_on_sr``),
from the same weights (through the bridges) and the same batches; and the
rating curve, drawn without matplotlib.

Tolerances: fp32 forward max|Δ| ≤ 1e-4·max|y| (the generator's forward
bar; the last stage's variance over a few values cancels in E[x²]−E[x]²,
summed in another order than flax's); bf16 forward max|Δ| ≤ 4e-3 (two bf16
roundings of a sigmoid output below 1: its ulp there is 2^-8). Step losses:
the pixel terms rel 1e-4 in fp32 and 2e-2 in bf16. The adversarial terms
(g_d_loss, d_loss) are means of tanh(D(a) − D(b)), differences of two
sigmoid outputs, and sit near 0 (~1e-2 here), so they are held in absolute
terms, to bars set from the readings: ADV_ATOL.

The updates are held by their gradients, not by the params after Adam
(Adam moves every weight by about ±lr whatever its gradient, so a missing
or reversed update stays within a few lr of JAX's params). After the
first step both packages hold Adam's first moment mu = (1−b1)·g. The
port's is held to JAX's one network at a time on the whole network's
norm, ‖mu_port − mu_jax‖ ≤ GRAD_RTOL·‖mu_jax‖: a conv bias ahead of a norm
layer has a gradient that is 0 up to rounding, so no bar holds leaf by
leaf. The planted faults show that the bar catches a skipped, misordered
or misdirected update.
"""

import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srgan_tpu.config import DiscriminatorConfig as JDiscriminatorConfig
from srgan_tpu.config import ModelConfig as JModelConfig
from srgan_tpu.models import discriminator as jdisc
from srgan_tpu.models.srresnet import init_generator as j_init_generator
from srgan_tpu.ops import gan_loss as jgan
from srgan_tpu.training import steps as jsteps
from srgan_tpu.training import train_state as jts
from srgan_tpu_torch.config import DiscriminatorConfig, ModelConfig
from srgan_tpu_torch.models import discriminator as tdisc
from srgan_tpu_torch.models.srresnet import SRResNet
from srgan_tpu_torch.ops import gan_loss as tgan
from srgan_tpu_torch.training import steps as tsteps
from srgan_tpu_torch.training import train_state as tts
from srgan_tpu_torch.utils.params import (
    discriminator_from_jax_params,
    discriminator_to_jax_params,
    from_jax_params,
    to_jax_params,
)

torch.set_num_threads(1)

SMALL_G = dict(num_features=8, num_residuals=1, upscale_factor=4)
SMALL_D = dict(num_filters=8, num_stages=2)

# Bars set from the readings, the largest over these tests and
# tests/test_torch_pool.py on the CPU. The moments are held after the first
# step only, where both packages start from the same weights: later, the
# paths part (Adam moves a weight whose gradient is rounding noise by ±lr
# either way), and D's gradient, which passes through its last norm layer's
# cancellation (below), follows that drift. fp32: the moments agree to
# 3.3e-4, the adversarial terms to 7.6e-6 (values 1.7e-3 to 1.2e-2), and
# the planted faults move a network's moments by 7.8e-2 to 1.8 of their
# norm. bf16: the adversarial gradient is mostly rounding. It reaches the
# generator through the discriminator's last norm layer, whose incoming
# gradient is nearly constant over the few values it normalises and
# cancels, and JAX's own bf16 moments differ from its fp32 ones by 0.41 of
# the norm on a D kernel. The port's agree with JAX's bf16 ones to 0.37,
# the adversarial terms to 9.1e-4 (values 1.9e-3 to 1.2e-2); the planted
# faults are held in fp32.
GRAD_RTOL = {"float32": 1e-2, "bfloat16": 0.5}
ADV_ATOL = {"float32": 3e-5, "bfloat16": 2e-3}


def _perturbed(rng, params):
    """Random non-zero biases (flax inits them to 0), so that a dropped or
    misplaced bias shows."""
    return jax.tree.map(
        lambda p: p + 0.1 * rng.standard_normal(p.shape).astype(np.float32), params
    )


def _jax_d(rng, **kw):
    cfg = JDiscriminatorConfig(**kw)
    floor = jdisc.min_input_size(cfg.num_stages)
    model, params = jdisc.init_discriminator(cfg, jax.random.key(3),
                                             sample_hw=(floor, floor))
    return model, _perturbed(rng, params)


def _port_d(params, **kw):
    model = tdisc.Discriminator.from_config(DiscriminatorConfig(**kw))
    model.load_state_dict(discriminator_from_jax_params(jax.device_get(params)))
    return model


def _sparse_edges(rng, shape):
    """Black images with one bright square each: the TV term stays live."""
    b, h, w, c = shape
    k = max(2, h // 8)
    out = np.zeros(shape, np.float32)
    for i in range(b):
        y, x = rng.integers(2, h - k - 2), rng.integers(2, w - k - 2)
        out[i, y:y + k, x:x + k] = rng.uniform(0.5, 1.0, c)
    return out


def g_moments(state) -> dict:
    """A generator state's Adam first moments in flax's tree layout."""
    names = [n for n, _ in state.model.named_parameters()]
    return to_jax_params(dict(zip(names, state.mu)))


def d_moments(state) -> dict:
    """A discriminator state's Adam first moments in flax's tree layout."""
    names = [n for n, _ in state.model.named_parameters()]
    return discriminator_to_jax_params(dict(zip(names, state.mu)))


def assert_moments_close(got: dict, want, rtol: float, what: str) -> float:
    """‖got − want‖ ≤ rtol·‖want‖ over the whole tree of ``want`` (one
    network's moments). Returns the relative error."""
    d2 = n2 = 0.0
    for path, leaf in jax.tree_util.tree_leaves_with_path(jax.device_get(want)):
        node = got
        for k in path:
            node = node[k.key]
        leaf = np.asarray(leaf, np.float64)
        d2 += float(((np.asarray(node, np.float64) - leaf) ** 2).sum())
        n2 += float((leaf ** 2).sum())
    assert n2 > 0, f"{what}: JAX's moments are all 0"
    err = math.sqrt(d2 / n2)
    assert err <= rtol, f"{what}: moments rel err {err:.3e} > {rtol}"
    return err


def _fused_step(tg, td, hr, lr_imgs, lr):
    return tsteps.gan_train_step(tg, td, hr, lr_imgs, lr, lr)[2]["packed"]


def _d_update_skipped(tg, td, hr, lr_imgs, lr):
    tsteps.generator_gan_step(tg, td.model, hr, lr_imgs, lr)


def _d_on_post_update_sr(tg, td, hr, lr_imgs, lr):
    tsteps.generator_gan_step(tg, td.model, hr, lr_imgs, lr)
    tsteps.discriminator_step(td, tg.model, hr, lr_imgs, lr)


def _g_reads_post_update_d(tg, td, hr, lr_imgs, lr):
    tsteps.discriminator_step(td, tg.model, hr, lr_imgs, lr)
    tsteps.generator_gan_step(tg, td.model, hr, lr_imgs, lr)


def _no_adversarial_term(tg, td, hr, lr_imgs, lr):
    _, m = tsteps.generator_pixel_step(tg, hr, lr_imgs, lr, return_sr=True)
    tsteps.discriminator_step_on_sr(td, hr, m["sr"], lr)


# planted faults of the fused GAN step, made of the port's own steps (they
# update the states in place)
FAULTS = {
    "d_update_skipped": _d_update_skipped,
    "d_on_post_update_sr": _d_on_post_update_sr,
    "g_reads_post_update_d": _g_reads_post_update_d,
    "no_adversarial_term": _no_adversarial_term,
}


class TestDiscriminator:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("stages,filters,hw,batch", [
        (1, 8, (16, 24), 2), (2, 8, (32, 64), 2), (4, 64, (432, 432), 1),
    ], ids=["1_stage", "2_stages", "4_stages_full_width"])
    def test_forward_matches_jax(self, rng, stages, filters, hw, batch, dtype):
        kw = dict(num_stages=stages, num_filters=filters, compute_dtype=dtype)
        model_j, params = _jax_d(rng, **kw)
        x = rng.random((batch, *hw, 3)).astype(np.float32)
        want = np.asarray(model_j.apply({"params": params}, jnp.asarray(x)))
        with torch.no_grad():
            got = _port_d(params, **kw)(torch.from_numpy(x))
        assert got.dtype == torch.float32
        got = got.permute(0, 2, 3, 1).numpy()  # NCHW → the JAX layout
        assert got.shape == want.shape
        tol = 1e-4 * float(np.abs(want).max()) if dtype == "float32" else 4e-3
        np.testing.assert_allclose(got, want, atol=tol, rtol=0)

    def test_flagship_output_shape(self):
        """HR 512x1024 through 4 stages: (B, 8F, 1, 3) NCHW, JAX's
        (B, 1, 3, 8F) NHWC (shape arithmetic only, on the meta device)."""
        model = tdisc.Discriminator(num_filters=64, num_stages=4).to("meta")
        out = model(torch.empty((2, 512, 1024, 3), device="meta"))
        assert out.shape == (2, 512, 1, 3)

    def test_min_input_size_and_refusals(self):
        for stages, want in ((1, 8), (2, 28), (4, 428)):
            assert tdisc.min_input_size(stages) == jdisc.min_input_size(stages) == want
        for stages in (0, 5):
            with pytest.raises(ValueError, match="num_stages"):
                tdisc.Discriminator(num_stages=stages)
            with pytest.raises(ValueError, match="num_stages"):
                jdisc.init_discriminator(JDiscriminatorConfig(num_stages=stages),
                                         jax.random.key(0), sample_hw=(512, 512))
        model = tdisc.Discriminator(num_filters=8, num_stages=2)
        with pytest.raises(ValueError, match="too small"):
            model(torch.zeros((1, 27, 64, 3)))
        with pytest.raises(ValueError, match="too small"):
            tdisc.init_discriminator(DiscriminatorConfig(**SMALL_D), sample_hw=(32, 20))
        with pytest.raises(ValueError, match="too small"):
            jdisc.init_discriminator(JDiscriminatorConfig(**SMALL_D), jax.random.key(0),
                                     sample_hw=(32, 20))

    def test_bridge_round_trip_and_init_layout(self, rng):
        _, params = _jax_d(rng, num_filters=8, num_stages=4)
        tree = jax.device_get(params)
        back = discriminator_to_jax_params(discriminator_from_jax_params(tree))
        assert back.keys() == tree.keys()
        for name, leaf in tree.items():
            for k in ("kernel", "bias"):
                assert np.array_equal(back[name][k], np.asarray(leaf[k])), (name, k)
        # the port's own init: flax's names and shapes, zero biases, seeded
        model = tdisc.init_discriminator(DiscriminatorConfig(num_filters=8), seed=1)
        got = discriminator_to_jax_params(model.state_dict())
        assert {k: {kk: v.shape for kk, v in d.items()} for k, d in got.items()} == {
            k: {kk: v.shape for kk, v in d.items()} for k, d in tree.items()}
        assert all(not d["bias"].any() for d in got.values())
        again = tdisc.init_discriminator(DiscriminatorConfig(num_filters=8), seed=1)
        assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))


class TestLosses:
    @pytest.mark.parametrize("name", ["discriminator_loss", "generator_adversarial_loss"])
    def test_adversarial_losses_match_jax(self, rng, name):
        real = rng.random((2, 16, 1, 3)).astype(np.float32)
        fake = rng.random((2, 16, 1, 3)).astype(np.float32)
        want = float(getattr(jgan, name)(jnp.asarray(real), jnp.asarray(fake)))
        got = float(getattr(tgan, name)(torch.from_numpy(real), torch.from_numpy(fake)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-7)

    @pytest.mark.parametrize("b", [1, 2, 7])
    def test_uniformity_loss_matches_jax(self, rng, b):
        emb = (0.3 * rng.standard_normal((b, 16))).astype(np.float32)
        want = float(jgan.uniformity_loss(jnp.asarray(emb)))
        got = tgan.uniformity_loss(torch.from_numpy(emb))
        assert float(got) == pytest.approx(want, rel=1e-5, abs=1e-7)
        if b == 1:
            assert float(got) == 0.0 and got.shape == ()


class TestGanSteps:
    """Three steps of each GAN step against JAX's, at F=8, 1 block, HR
    32x64, D 2 stages at 8 filters: the losses after every step, each
    network's Adam moments after the first."""

    LR = 1e-5

    def _nets(self, rng, dtype="float32"):
        g_kw = dict(compute_dtype=dtype, **SMALL_G)
        d_kw = dict(compute_dtype=dtype, **SMALL_D)
        model_j, g_params = j_init_generator(JModelConfig(**g_kw), jax.random.key(1),
                                             sample_hw=(8, 16))
        g_params = _perturbed(rng, g_params)
        d_model_j, d_params = _jax_d(rng, **d_kw)
        g_t = SRResNet.from_config(ModelConfig(**g_kw))
        g_t.load_state_dict(from_jax_params(jax.device_get(g_params)))
        d_t = _port_d(d_params, **d_kw)
        return (model_j, g_params, d_model_j, d_params), (g_t, d_t)

    def _batches(self, rng, k=3):
        return [(_sparse_edges(rng, (2, 32, 64, 3)),
                 rng.random((2, 8, 16, 3)).astype(np.float32)) for _ in range(k)]

    def _compare(self, packed_t, packed_j, dtype):
        got, want = packed_t.numpy(), np.asarray(packed_j)
        assert got.shape == want.shape
        rel = 1e-4 if dtype == "float32" else 2e-2
        # g_loss, com, tv relative; g_d, p (0) and d_loss absolute
        np.testing.assert_allclose(got[:3], want[:3], rtol=rel, atol=1e-7)
        np.testing.assert_allclose(got[3:], want[3:], rtol=0, atol=ADV_ATOL[dtype])

    def test_generator_gan_step_matches_jax(self, rng):
        (model_j, gp, d_model_j, dp), (g_t, d_t) = self._nets(rng)
        j_state = jts.TrainState.create(apply_fn=model_j.apply, params=gp)
        t_state = tts.TrainState(g_t)
        d_before = [p.clone() for p in d_t.parameters()]
        for k, (hr, lr_imgs) in enumerate(self._batches(rng)):
            j_state, m_j = jsteps.generator_gan_step(
                j_state, d_model_j.apply, dp, jnp.asarray(hr), jnp.asarray(lr_imgs),
                jnp.float32(self.LR), return_sr=True)
            t_state, m_t = tsteps.generator_gan_step(
                t_state, d_t, torch.from_numpy(hr), torch.from_numpy(lr_imgs), self.LR,
                return_sr=True)
            self._compare(m_t["packed"], m_j["packed"], "float32")
            if k == 0:  # the pre-update SR, from equal weights: the forward bar
                assert_moments_close(g_moments(t_state), j_state.opt_state.mu,
                                     GRAD_RTOL["float32"], "G")
                want = np.asarray(m_j["sr"])
                np.testing.assert_allclose(m_t["sr"].numpy(), want,
                                           atol=1e-4 * np.abs(want).max())
        assert float(m_t["g_d_loss"]) != 0.0
        # D is read, never changed, and collects no gradient
        assert all(torch.equal(a, b) for a, b in zip(d_t.parameters(), d_before))
        assert all(p.grad is None for p in d_t.parameters())

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_gan_train_step_matches_jax(self, rng, dtype):
        (model_j, gp, d_model_j, dp), (g_t, d_t) = self._nets(rng, dtype)
        jg = jts.TrainState.create(apply_fn=model_j.apply, params=gp)
        jd = jts.TrainState.create(apply_fn=d_model_j.apply, params=dp)
        tg, td = tts.TrainState(g_t), tts.TrainState(d_t)
        for k, (hr, lr_imgs) in enumerate(self._batches(rng)):
            jg, jd, m_j = jsteps.gan_train_step(
                jg, jd, d_model_j.apply, jnp.asarray(hr), jnp.asarray(lr_imgs),
                jnp.float32(self.LR), jnp.float32(self.LR))
            tg, td, m_t = tsteps.gan_train_step(
                tg, td, torch.from_numpy(hr), torch.from_numpy(lr_imgs), self.LR, self.LR)
            assert m_t["packed"].shape == (6,)
            self._compare(m_t["packed"], m_j["packed"], dtype)
            if k == 0:
                assert_moments_close(g_moments(tg), jg.opt_state.mu, GRAD_RTOL[dtype],
                                     "G")
                assert_moments_close(d_moments(td), jd.opt_state.mu, GRAD_RTOL[dtype],
                                     "D")
        assert tg.count == td.count == 3

    def test_discriminator_steps_match_jax(self, rng):
        """discriminator_step (its own generator forward) and
        discriminator_step_on_sr (a given SR), three steps each; the moments
        after the first of each, from equal weights."""
        (model_j, gp, d_model_j, dp), (g_t, d_t) = self._nets(rng)
        jd = jts.TrainState.create(apply_fn=d_model_j.apply, params=dp)
        td = tts.TrainState(d_t)
        g_before = [p.clone() for p in g_t.parameters()]
        batches = self._batches(rng, 6)
        for k, (hr, lr_imgs) in enumerate(batches):
            if k == 3:  # the second kind from JAX's weights, Adam anew
                jd = jts.TrainState.create(apply_fn=d_model_j.apply, params=jd.params)
                d_t.load_state_dict(discriminator_from_jax_params(jax.device_get(jd.params)))
                td = tts.TrainState(d_t)
            if k < 3:
                jd, m_j = jsteps.discriminator_step(
                    jd, model_j.apply, gp, jnp.asarray(hr), jnp.asarray(lr_imgs),
                    jnp.float32(self.LR))
                td, m_t = tsteps.discriminator_step(
                    td, g_t, torch.from_numpy(hr), torch.from_numpy(lr_imgs), self.LR)
            else:
                sr = rng.random(hr.shape).astype(np.float32)
                jd, m_j = jsteps.discriminator_step_on_sr(
                    jd, jnp.asarray(hr), jnp.asarray(sr), jnp.float32(self.LR))
                td, m_t = tsteps.discriminator_step_on_sr(
                    td, torch.from_numpy(hr), torch.from_numpy(sr), self.LR)
            assert float(m_t["d_loss"]) == pytest.approx(
                float(m_j["d_loss"]), rel=0, abs=ADV_ATOL["float32"])
            if k in (0, 3):
                assert_moments_close(d_moments(td), jd.opt_state.mu, GRAD_RTOL["float32"],
                                     f"D step {k + 1}")
        assert all(torch.equal(a, b) for a, b in zip(g_t.parameters(), g_before))

    @pytest.mark.parametrize("fault", [None, *FAULTS], ids=["none", *FAULTS])
    def test_planted_faults_fail(self, rng, fault):
        """One fp32 step of JAX's ``gan_train_step`` at lr 1e-2 against the
        port's, and against planted faults built of the port's own steps:
        each fault must fail the moments bar (the first step's moments do
        not depend on the rate; a large one lets the post-update SR and D
        differ from the pre-update ones)."""
        lr = 1e-2
        (model_j, gp, d_model_j, dp), (g_t, d_t) = self._nets(rng)
        jg = jts.TrainState.create(apply_fn=model_j.apply, params=gp)
        jd = jts.TrainState.create(apply_fn=d_model_j.apply, params=dp)
        (hr, lr_imgs), = self._batches(rng, 1)
        jg, jd, m_j = jsteps.gan_train_step(jg, jd, d_model_j.apply, jnp.asarray(hr),
                                            jnp.asarray(lr_imgs), jnp.float32(lr),
                                            jnp.float32(lr))
        tg, td = tts.TrainState(g_t), tts.TrainState(d_t)
        step = FAULTS[fault] if fault else _fused_step
        packed = step(tg, td, torch.from_numpy(hr), torch.from_numpy(lr_imgs), lr)

        def check_moments():
            for got, want, what in ((g_moments(tg), jg.opt_state.mu, "G"),
                                    (d_moments(td), jd.opt_state.mu, "D")):
                assert_moments_close(got, want, GRAD_RTOL["float32"], what)

        if fault is None:
            self._compare(packed, m_j["packed"], "float32")
            check_moments()
        else:
            with pytest.raises(AssertionError, match="moments rel err"):
                check_moments()

    def test_fused_equals_two_dispatch(self, rng):
        """gan_train_step == generator_gan_step(return_sr=True) then
        discriminator_step_on_sr, in the port, bit for bit: both read the
        pre-update D and the pre-update SR."""
        _, (g_a, d_a) = self._nets(rng)
        g_b = SRResNet.from_config(ModelConfig(**SMALL_G))
        g_b.load_state_dict(g_a.state_dict())
        d_b = tdisc.Discriminator.from_config(DiscriminatorConfig(**SMALL_D))
        d_b.load_state_dict(d_a.state_dict())
        ga, da = tts.TrainState(g_a), tts.TrainState(d_a)
        gb, db = tts.TrainState(g_b), tts.TrainState(d_b)
        for hr, lr_imgs in self._batches(rng):
            hr, lr_imgs = torch.from_numpy(hr), torch.from_numpy(lr_imgs)
            ga, da, m_a = tsteps.gan_train_step(ga, da, hr, lr_imgs, self.LR, self.LR)
            gb, m_b = tsteps.generator_gan_step(gb, d_b, hr, lr_imgs, self.LR,
                                                return_sr=True)
            db, dm_b = tsteps.discriminator_step_on_sr(db, hr, m_b.pop("sr"), self.LR)
            assert torch.equal(m_a["packed"][:5], m_b["packed"])
            assert torch.equal(m_a["d_loss"], dm_b["d_loss"])
        for a, b in ((ga, gb), (da, db)):
            assert all(torch.equal(x, y) for x, y in zip(a.params + a.mu + a.nu,
                                                         b.params + b.mu + b.nu))

    def test_pixel_step_return_sr_and_pack_tail(self, rng):
        _, (g_t, _) = self._nets(rng)
        st = tts.TrainState(g_t)
        (hr, lr_imgs), = self._batches(rng, 1)
        with torch.no_grad():
            want = g_t(torch.from_numpy(lr_imgs))
        st, m = tsteps.generator_pixel_step(st, torch.from_numpy(hr),
                                            torch.from_numpy(lr_imgs), self.LR,
                                            return_sr=True)
        assert torch.equal(m["sr"], want) and not m["sr"].requires_grad
        metrics = {k: torch.tensor(float(i)) for i, k in enumerate(tsteps.PACKED_KEYS)}
        packed = tsteps.pack_metrics(metrics, torch.tensor(9.0))
        want = jsteps.pack_metrics({k: jnp.float32(i) for i, k in
                                    enumerate(jsteps.PACKED_KEYS)}, jnp.float32(9.0))
        assert packed.tolist() == np.asarray(want).tolist() == [0, 1, 2, 3, 4, 9]


def test_rating_curve_without_matplotlib(tmp_path, monkeypatch):
    """save_rating_curve draws the PNG with PIL alone: the JAX package's
    file name, matplotlib's 1000x600 figure, both series' colours (PSNR/30
    blue, SSIM red); a NaN epoch is left out, not drawn."""
    from PIL import Image

    from srgan_tpu_torch.utils.plotting import save_rating_curve

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError):
        import matplotlib  # noqa: F401
    path = save_rating_curve([1, 2, 3, 4], [20.0, 22.5, float("nan"), 24.0],
                             [0.55, 0.61, 0.6, 0.66], str(tmp_path), "Training")
    assert path == str(tmp_path / "Trainingtraining_loss_curve_0.png")
    img = Image.open(path)
    assert img.size == (1000, 600)
    px = np.asarray(img.convert("RGB")).reshape(-1, 3)
    colours = {tuple(c) for c in np.unique(px, axis=0)}
    assert (0, 0, 255) in colours and (255, 0, 0) in colours
    one = save_rating_curve([1], [30.0], [0.9], str(tmp_path), "One", rank=2)
    assert one.endswith("Onetraining_loss_curve_2.png")
