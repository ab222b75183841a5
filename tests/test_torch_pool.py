"""The port's generator pool against the JAX package: the stacked state's
helpers (one shared EMA decay, permute, mutual lerp), the scan executor's
steps (``scanned_pool_step``, ``scanned_pool_gan_step``) at N=3, the
scheduler (``GeneratorPool``) against JAX's ``StackedGeneratorPool`` over
20 batches and two epoch ends, the
checkpoint across phases and pool sizes. Sizes: F=8, 1 block, HR 32x64, D 2 stages at
8 filters.

Tolerances as in tests/test_torch_gan.py: pixel losses rel 1e-4 (fp32) /
2e-2 (bf16) after every step, the adversarial terms ADV_ATOL, each
network's Adam moments GRAD_RTOL after the first step (each member's
generator and the discriminator), and planted faults of the pool's GAN
step that must fail that bar. The scheduler's draws, masks and counters are equal; its float
bookkeeping within rel 1e-6.

The learning rates here are 1e-5: Adam moves every weight by about ±lr,
and a weight whose gradient is below the rounding noise moves either way,
so the members' paths part by a few lr a step.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from srgan_tpu.config import DiscriminatorConfig as JDiscriminatorConfig
from srgan_tpu.config import ModelConfig as JModelConfig
from srgan_tpu.config import PoolConfig as JPoolConfig
from srgan_tpu.models.discriminator import init_discriminator as j_init_discriminator
from srgan_tpu.models.srresnet import init_generator as j_init_generator
from srgan_tpu.training import checkpoint as jckpt
from srgan_tpu.training import pool as jpool
from srgan_tpu.training import stacked_pool as jsp
from srgan_tpu.training import train_state as jts
from srgan_tpu_torch.config import (
    Config,
    DataConfig,
    DiscriminatorConfig,
    ModelConfig,
    PoolConfig,
    TrainConfig,
)
from srgan_tpu_torch.models.discriminator import Discriminator
from srgan_tpu_torch.models.srresnet import SRResNet, init_generator
from srgan_tpu_torch.ops.gan_loss import discriminator_loss
from srgan_tpu_torch.training import checkpoint as ckpt
from srgan_tpu_torch.training import pool as tpool
from srgan_tpu_torch.training import stacked_pool as tsp
from srgan_tpu_torch.training import train_state as tts
from srgan_tpu_torch.training.loop import Trainer
from srgan_tpu_torch.training.steps import discriminator_step_on_sr, generator_pixel_step
from srgan_tpu_torch.utils.params import (
    discriminator_from_jax_params,
    from_jax_params,
    to_jax_params,
)
from test_torch_gan import ADV_ATOL, GRAD_RTOL, assert_moments_close, d_moments, g_moments

torch.set_num_threads(1)

SMALL_G = dict(num_features=8, num_residuals=1, upscale_factor=4)
SMALL_D = dict(num_filters=8, num_stages=2)
LR = 1e-5


def _sparse_edges(rng, shape):
    b, h, w, c = shape
    k = max(2, h // 8)
    out = np.zeros(shape, np.float32)
    for i in range(b):
        y, x = rng.integers(2, h - k - 2), rng.integers(2, w - k - 2)
        out[i, y:y + k, x:x + k] = rng.uniform(0.5, 1.0, c)
    return out


def _assert_tree_close(got: dict, want, atol, rtol=0.0):
    for path, leaf in jax.tree_util.tree_leaves_with_path(jax.device_get(want)):
        node = got
        for k in path:
            node = node[k.key]
        np.testing.assert_allclose(node, leaf, atol=atol, rtol=rtol)


def _pools(n, dtype="float32", ema_decays=None, **model):
    """n JAX generator states and the port's, same weights; ``model``: more
    ``ModelConfig`` fields for both."""
    ema_decays = ema_decays or [0.0] * n
    kw = dict(compute_dtype=dtype, **{**SMALL_G, **model})
    j_states, t_states = [], []
    for i in range(n):
        model, params = j_init_generator(JModelConfig(**kw), jax.random.key(i),
                                         sample_hw=(8, 16))
        j_states.append(jts.TrainState.create(apply_fn=model.apply, params=params,
                                              ema_decay=ema_decays[i]))
        g = SRResNet.from_config(ModelConfig(**kw))
        g.load_state_dict(from_jax_params(jax.device_get(params)))
        t_states.append(tts.TrainState(g, ema_decay=ema_decays[i]))
    return model, j_states, t_states


def _ds(dtype="float32"):
    kw = dict(compute_dtype=dtype, **SMALL_D)
    d_model, d_params = j_init_discriminator(JDiscriminatorConfig(**kw),
                                             jax.random.key(9), sample_hw=(32, 64))
    d_t = Discriminator.from_config(DiscriminatorConfig(**kw))
    d_t.load_state_dict(discriminator_from_jax_params(jax.device_get(d_params)))
    return (d_model, jts.TrainState.create(apply_fn=d_model.apply, params=d_params),
            tts.TrainState(d_t))


def _batch(rng):
    return _sparse_edges(rng, (2, 32, 64, 3)), rng.random((2, 8, 16, 3)).astype(np.float32)


def _member_tree(st):
    return to_jax_params(st.model.state_dict())


def _member_moments(j_stacked, i):
    return jax.tree.map(lambda x: np.asarray(x[i]), j_stacked.opt_state.mu)


def _check_pool_moments(stacked, td, j_stacked, jd, rtol):
    for i, st in enumerate(stacked):
        assert_moments_close(g_moments(st), _member_moments(j_stacked, i), rtol,
                             f"member {i}")
    assert_moments_close(d_moments(td), jd.opt_state.mu, rtol, "D")


def _d_update_skipped(monkeypatch, stacked, lr_imgs):
    def no_update(d_state, hr, sr, lr, real_preds=None):
        with torch.no_grad():
            d_loss = discriminator_loss(d_state.model(hr), d_state.model(sr))
        return d_state, {"d_loss": d_loss}

    monkeypatch.setattr(tsp, "discriminator_step_on_sr", no_update)
    return {}


def _d_on_post_update_sr(monkeypatch, stacked, lr_imgs):
    def post_update_sr(d_state, hr, sr, lr, real_preds=None):
        with torch.no_grad():
            sr = stacked[2].model(lr_imgs)
        return discriminator_step_on_sr(d_state, hr, sr, lr, real_preds=real_preds)

    monkeypatch.setattr(tsp, "discriminator_step_on_sr", post_update_sr)
    return {}


# planted faults of the pool's GAN step: each returns the arguments it
# changes and patches what it replaces
POOL_FAULTS = {
    "d_update_skipped": _d_update_skipped,
    "d_on_post_update_sr": _d_on_post_update_sr,
    "wrong_d_target": lambda mp, st, lr_imgs: {"d_target_idx": 0},
    "mask_ignored": lambda mp, st, lr_imgs: {"gan_mask": np.ones(3, np.float32)},
}


class TestStackedState:
    def test_one_shared_ema_decay_as_jax(self, rng):
        """stack_states keeps member 0's EMA decay for every member (JAX's
        0-dim ``ema_decay`` leaf), and a scanned step lerps every shadow
        with it: member 1 set up with 0.5 follows 0.9."""
        model, j_states, t_states = _pools(2, ema_decays=[0.9, 0.5])
        j_stacked = jsp.stack_states(j_states)
        assert np.ndim(j_stacked.ema_decay) == 0 and j_stacked.ema_decay == np.float32(0.9)
        stacked = tsp.stack_states(t_states)
        assert stacked == t_states and [s.ema_decay for s in stacked] == [0.9, 0.9]
        hr, lr_imgs = _batch(rng)
        j_before = jax.tree.map(lambda x: np.asarray(x[1]), j_stacked.ema_params)
        j_new, _ = jsp.scanned_pool_step(j_stacked, model.apply, None, None,
                                         jnp.asarray(hr), jnp.asarray(lr_imgs),
                                         jnp.zeros(2), jnp.float32(LR))
        before = [e.clone() for e in stacked[1].ema_params]
        stacked, _ = tsp.scanned_pool_step(stacked, torch.from_numpy(hr),
                                           torch.from_numpy(lr_imgs), LR)
        st = stacked[1]
        for e, b, p in zip(st.ema_params, before, st.params):
            torch.testing.assert_close(e, 0.9 * b + 0.1 * p, rtol=0, atol=1e-7)
        # JAX's member 1 follows the same decay (its shadow from its params)
        want = jax.tree.map(lambda b, p: 0.9 * b + 0.1 * np.asarray(p[1]), j_before,
                            j_new.params)
        _assert_tree_close(jax.tree.map(lambda x: np.asarray(x[1]), j_new.ema_params),
                           want, 1e-7)

    def test_permute_and_lerp_match_jax(self, rng):
        model, j_states, t_states = _pools(3, ema_decays=[0.9] * 3)
        j_stacked = jsp.stack_states(j_states)
        stacked = tsp.stack_states(t_states)
        perm = [2, 0, 1]
        j_stacked = jsp.permute_members(j_stacked, jnp.asarray(perm))
        stacked = tsp.permute_members(stacked, perm)
        assert stacked == [t_states[i] for i in perm]
        assert [s.ema_decay for s in stacked] == [0.9] * 3
        j_params = jsp.mutual_learning_lerp(j_stacked.params, 0.3)
        j_ema = jsp.mutual_learning_lerp(j_stacked.ema_params, 0.3)
        tsp.mutual_learning_lerp([st.params for st in stacked], 0.3)
        tsp.mutual_learning_lerp([st.ema_params for st in stacked], 0.3)
        for i, st in enumerate(stacked):
            _assert_tree_close(_member_tree(st), jax.tree.map(lambda x: x[i], j_params),
                               1e-7, 1e-6)
            names = [n for n, _ in st.model.named_parameters()]
            _assert_tree_close(to_jax_params(dict(zip(names, st.ema_params))),
                               jax.tree.map(lambda x: x[i], j_ema), 1e-7, 1e-6)


class TestScannedSteps:
    def test_scanned_pool_step_matches_jax(self, rng):
        model, j_states, t_states = _pools(3)
        j_stacked, stacked = jsp.stack_states(j_states), tsp.stack_states(t_states)
        for k in range(3):
            hr, lr_imgs = _batch(rng)
            j_stacked, m_j = jsp.scanned_pool_step(
                j_stacked, model.apply, None, None, jnp.asarray(hr), jnp.asarray(lr_imgs),
                jnp.zeros(3), jnp.float32(LR))
            stacked, m_t = tsp.scanned_pool_step(
                stacked, torch.from_numpy(hr), torch.from_numpy(lr_imgs), LR)
            assert m_t["packed"].shape == (5, 3)
            np.testing.assert_allclose(m_t["packed"].numpy(), np.asarray(m_j["packed"]),
                                       rtol=1e-4, atol=1e-7)
            if k == 0:
                for i, st in enumerate(stacked):
                    assert_moments_close(g_moments(st), _member_moments(j_stacked, i),
                                         GRAD_RTOL["float32"], f"member {i}")
        assert [st.count for st in stacked] == [3] * 3

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_scanned_pool_gan_step_matches_jax(self, rng, dtype):
        """N=3 with the mask [1, 0, 1] (every member reports g_d; member 1
        takes no adversarial gradient), D trained on member 2's SR."""
        model, j_states, t_states = _pools(3, dtype)
        d_model, jd, td = _ds(dtype)
        j_stacked, stacked = jsp.stack_states(j_states), tsp.stack_states(t_states)
        mask = np.asarray([1.0, 0.0, 1.0], np.float32)
        rel = 1e-4 if dtype == "float32" else 2e-2
        for k in range(3):
            hr, lr_imgs = _batch(rng)
            j_stacked, jd, m_j = jsp.scanned_pool_gan_step(
                j_stacked, jd, model.apply, d_model.apply, jnp.asarray(hr),
                jnp.asarray(lr_imgs), jnp.asarray(mask), jnp.float32(LR), jnp.float32(LR),
                d_target_idx=np.int32(2))
            stacked, td, m_t = tsp.scanned_pool_gan_step(
                stacked, td, torch.from_numpy(hr), torch.from_numpy(lr_imgs), mask,
                LR, LR, d_target_idx=2)
            got, want = m_t["packed"].numpy(), np.asarray(m_j["packed"])
            assert got.shape == want.shape == (16,)
            # (5, N) then d_loss: g, com, tv relative; g_d, p, d_loss absolute
            np.testing.assert_allclose(got[:9], want[:9], rtol=rel, atol=1e-7)
            np.testing.assert_allclose(got[9:], want[9:], rtol=0, atol=ADV_ATOL[dtype])
            assert (m_t["g_d_loss"] != 0).all()  # reported for mask 0 too
            if k == 0:
                _check_pool_moments(stacked, td, j_stacked, jd, GRAD_RTOL[dtype])

    @pytest.mark.parametrize("fault", [None, *POOL_FAULTS], ids=["none", *POOL_FAULTS])
    def test_planted_faults_fail(self, rng, monkeypatch, fault):
        """One fp32 step of the pool's GAN step at lr 1e-2 (mask [1, 0, 1],
        D on member 2's SR) against JAX's, and planted faults that must
        fail the moments bar: the D update skipped, D trained on member 2's
        post-update SR, D trained on member 0's SR, the mask ignored."""
        lr = 1e-2
        model, j_states, t_states = _pools(3)
        d_model, jd, td = _ds()
        j_stacked, stacked = jsp.stack_states(j_states), tsp.stack_states(t_states)
        mask = np.asarray([1.0, 0.0, 1.0], np.float32)
        hr, lr_imgs = _batch(rng)
        j_stacked, jd, m_j = jsp.scanned_pool_gan_step(
            j_stacked, jd, model.apply, d_model.apply, jnp.asarray(hr),
            jnp.asarray(lr_imgs), jnp.asarray(mask), jnp.float32(lr), jnp.float32(lr),
            d_target_idx=np.int32(2))
        hr, lr_imgs = torch.from_numpy(hr), torch.from_numpy(lr_imgs)
        kw = POOL_FAULTS[fault](monkeypatch, stacked, lr_imgs) if fault else {}
        args = dict(gan_mask=mask, d_target_idx=2) | kw
        stacked, td, m_t = tsp.scanned_pool_gan_step(stacked, td, hr, lr_imgs,
                                                     g_lr=lr, d_lr=lr, **args)
        if fault is None:
            got, want = m_t["packed"].numpy(), np.asarray(m_j["packed"])
            np.testing.assert_allclose(got[:9], want[:9], rtol=1e-4, atol=1e-7)
            np.testing.assert_allclose(got[9:], want[9:], rtol=0,
                                       atol=ADV_ATOL["float32"])
            _check_pool_moments(stacked, td, j_stacked, jd, GRAD_RTOL["float32"])
        else:
            with pytest.raises(AssertionError, match="moments rel err"):
                _check_pool_moments(stacked, td, j_stacked, jd, GRAD_RTOL["float32"])

    def test_mask_zero_is_the_pixel_update(self, rng):
        """Members with mask 0 update exactly as without a discriminator
        (their adversarial term carries no gradient), bit for bit."""
        _, _, a = _pools(2)
        _, _, b = _pools(2)
        _, _, td = _ds()
        sa, sb = tsp.stack_states(a), tsp.stack_states(b)
        hr, lr_imgs = (torch.from_numpy(x) for x in _batch(rng))
        _, _, m_a = tsp.scanned_pool_gan_step(sa, td, hr, lr_imgs, np.zeros(2), LR, LR)
        _, m_b = tsp.scanned_pool_step(sb, hr, lr_imgs, LR)
        for x, y in zip(sa, sb):
            assert all(torch.equal(p, q) for p, q in zip(x.params + x.mu, y.params + y.mu))
        assert torch.equal(m_a["com_loss"], m_b["com_loss"])
        assert torch.equal(m_a["g_loss"], m_a["com_loss"] + m_a["tv_loss"])


class TestStackedScheduler:
    @pytest.mark.parametrize("kw", [
        dict(p_gan_above=0.5),
        dict(starting_gan_loss=0.45, pre_loss_gate=True, p_gan_follower=0.3),
        dict(sort_ascending=False, mutual_learning=False, p_gan_above=0.7),
    ], ids=["auto_gate", "fixed_gate_pre_loss", "descending_no_mutual"])
    def test_matches_jax_over_two_epochs(self, rng, kw):
        """20 batches with an epoch end after the 10th and the 20th: the
        same probabilities, masks, counters, order, gate, snapshot, and
        params and EMA shadows after the permutation and the lerp."""
        _, j_states, t_states = _pools(3, ema_decays=[0.9] * 3)
        j = jsp.StackedGeneratorPool.create(j_states, JPoolConfig(num_generators=3, **kw),
                                            seed=(4, 1))
        t = tpool.GeneratorPool(t_states, PoolConfig(num_generators=3, **kw), seed=(4, 1))
        # the members' weights and shadows made distinct, as training would
        for i, st in enumerate(t.state):
            with torch.no_grad():
                for p, e in zip(st.params, st.ema_params):
                    e.add_(0.01 * (i + 1))
        j.state = j.state.replace(ema_params=jax.tree.map(
            lambda x: x + 0.01 * jnp.arange(1, 4, dtype=x.dtype).reshape(
                (3,) + (1,) * (x.ndim - 1)), j.state.ema_params))
        losses = rng.uniform(0.2, 0.8, (20, 3))
        n_gan = 0
        for b in range(20):
            np.testing.assert_array_equal(t.gan_probabilities(), j.gan_probabilities())
            m_t, m_j = t.sample_gan_mask(True), j.sample_gan_mask(True)
            np.testing.assert_array_equal(m_t, m_j)
            n_gan += int(m_t.sum())
            t.record_losses(losses[b])
            j.record_losses(losses[b])
            if b in (9, 19):
                t.end_epoch()
                j.end_epoch()
                assert t.snapshot() == j.snapshot()
                assert t.gan_threshold == j.gan_threshold
                for i in range(3):
                    got = t.state[i].params
                    want = jax.tree.map(lambda x: x[i], j.state.params)
                    names = [n for n, _ in t.state[i].model.named_parameters()]
                    _assert_tree_close(to_jax_params(dict(zip(names, got))), want,
                                       1e-7, 1e-6)
                    shadow = to_jax_params(dict(zip(names, t.state[i].ema_params)))
                    _assert_tree_close(shadow, jax.tree.map(lambda x: x[i],
                                                            j.state.ema_params), 1e-7, 1e-6)
        assert n_gan > 0
        assert t.leader.state is t.state[0]
        t.sample_gan_mask(False)
        j.sample_gan_mask(False)
        assert t.snapshot() == j.snapshot()


class TestOnePool:
    def test_views_follow_the_members(self):
        """The pool keeps its bookkeeping once, in its members: ``state``,
        ``running_loss`` and ``gan_updates`` read them in pool order, after
        the epoch end's re-sort too."""
        _, _, t_states = _pools(3)
        pool = tpool.GeneratorPool(t_states, PoolConfig(num_generators=3))
        pool.record_losses(np.array([0.5, 0.2, 0.4]))
        for i, m in enumerate(pool.members):
            m.gan_updates = i
        assert pool.state == t_states
        pool.end_epoch()
        assert pool.state == [t_states[1], t_states[2], t_states[0]]
        np.testing.assert_array_equal(pool.running_loss, [0.2, 0.4, 0.5])
        np.testing.assert_array_equal(pool.gan_updates, [1, 2, 0])
        assert [m["pre_loss"] for m in pool.snapshot()] == [0.2, 0.4, 0.5]

    def test_trainer_seams(self, tmp_path, folders):
        """What the benchmark harness relies on: ``spool`` is the pool
        itself where it has more than one member (None for one), ``train``
        calls an ``end_epoch`` set on that instance, and ``pool_steps`` is
        read at every batch."""
        assert Trainer(_gan_config(tmp_path / "one", 1), device="cpu").spool is None
        cfg = _gan_config(tmp_path, 3, p_gan_above=0.6)
        trainer = Trainer(cfg.replace(train=dataclasses.replace(cfg.train, num_epochs=1)),
                          device="cpu")
        assert trainer.spool is trainer.pool
        ends, calls = [], []
        end_epoch = trainer.spool.end_epoch
        trainer.spool.end_epoch = lambda: (ends.append(1), end_epoch())
        step, gan_step = trainer.pool_steps

        def later(*a, **k):
            calls.append("later")
            return gan_step(*a, **k)

        def first(*a, **k):
            calls.append("first")
            trainer.pool_steps = (step, later)  # from the next batch on
            return gan_step(*a, **k)

        trainer.pool_steps = (step, first)
        trainer.train(*folders)
        assert calls == ["first", "later", "later"] and ends == [1]


def _folder(path, n, seed):
    os.makedirs(path)
    rng = np.random.default_rng(seed)
    for i in range(n):
        img = rng.integers(0, 256, (32, 64, 3), dtype=np.uint8)
        Image.fromarray(img).save(os.path.join(path, f"img_{i:02d}.png"))
    return str(path)


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    return _folder(root / "train", 10, 0), _folder(root / "val", 4, 1)


def _gan_config(results, n=3, **pool):
    return Config(
        model=ModelConfig(**SMALL_G),
        discriminator=DiscriminatorConfig(**SMALL_D),
        data=DataConfig(hr_size=(32, 64), upscale_factor=4, batch_size=2,
                        noise_std_max=0.0, num_workers=1),
        pool=PoolConfig(num_generators=n, **pool),
        train=TrainConfig(num_epochs=2, score_max_batches=2, progress="off",
                          use_gan=True, results_dir=str(results), validate_every=0,
                          lr_generator=LR, lr_discriminator=LR / 2),
    )


class TestCheckpointAcrossPhasesAndSizes:
    def _run(self, tmp_path, folders, n, gan, epochs=1, **kw):
        cfg = _gan_config(tmp_path, n)
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, use_gan=gan,
                                                    num_epochs=epochs, **kw))
        trainer = Trainer(cfg, device="cpu")
        return trainer, trainer.train(*folders)

    def test_gan_snapshot_carries_d_and_resumes_it(self, tmp_path, folders):
        trainer, _ = self._run(tmp_path, folders, 3, True)
        d = trainer.d_state
        fresh = Trainer(trainer.cfg, device="cpu")
        assert not torch.equal(fresh.d_state.params[0], d.params[0])
        _, d_back, epoch = ckpt.restore_checkpoint(
            str(tmp_path), "Training", pool=fresh.pool, d_state=fresh.d_state)
        assert epoch == 1 and d_back is fresh.d_state and d_back.count == d.count > 0
        for a, b in zip(d_back.params + d_back.mu + d_back.nu, d.params + d.mu + d.nu):
            assert torch.equal(a, b)

    def test_pixel_snapshot_into_gan_trainer_keeps_fresh_d(self, tmp_path, folders):
        self._run(tmp_path, folders, 1, False)
        gan = Trainer(_gan_config(tmp_path, 1), device="cpu")
        d0 = [p.clone() for p in gan.d_state.params]
        ckpt.restore_checkpoint(str(tmp_path), "Training", pool=gan.pool,
                                d_state=gan.d_state)
        assert all(torch.equal(a, b) for a, b in zip(gan.d_state.params, d0))
        assert gan.d_state.count == 0

    def test_gan_snapshot_into_pixel_trainer_drops_d(self, tmp_path, folders):
        trainer, _ = self._run(tmp_path, folders, 1, True)
        cfg = trainer.cfg.replace(train=dataclasses.replace(trainer.cfg.train,
                                                            use_gan=False))
        pixel = Trainer(cfg, device="cpu")
        pool, d_state, epoch = ckpt.restore_checkpoint(str(tmp_path), "Training",
                                                       pool=pixel.pool)
        assert d_state is None and epoch == 1
        assert all(torch.equal(a, b) for a, b in zip(pool.leader.state.params,
                                                      trainer.pool.leader.state.params))

    @pytest.mark.parametrize("n_disk,n_pool", [(1, 3), (3, 1)], ids=["grow", "shrink"])
    def test_resize_as_jax(self, tmp_path, rng, capsys, n_disk, n_pool):
        """Grow: the extra members are copies of the restored leader (params
        and EMA shadows) with their own fresh Adam state; shrink: the first
        members. The same messages as JAX's restore."""
        def j_pool(n, seed):
            _, states, _ = _pools(n, ema_decays=[0.9] * n)
            states = [s.replace(params=jax.tree.map(lambda x: x + seed, s.params))
                      for s in states]
            return jpool.GeneratorPool([jpool.PoolMember(state=s) for s in states],
                                       JPoolConfig())

        def t_pool(n, seed):
            states = [tts.TrainState(init_generator(ModelConfig(**SMALL_G), seed=seed + i),
                                     ema_decay=0.9) for i in range(n)]
            return tpool.GeneratorPool(states, PoolConfig())

        saved = t_pool(n_disk, 0)
        hr, lr_imgs = (torch.from_numpy(x) for x in _batch(rng))
        for m in saved.members:
            generator_pixel_step(m.state, hr, lr_imgs, LR)
            m.running_loss = 0.3
        ckpt.save_checkpoint(str(tmp_path / "t"), "Training", pool=saved, epoch=2)
        jckpt.save_checkpoint(str(tmp_path / "j"), "Training", pool=j_pool(n_disk, 0.0),
                              d_state=None, epoch=2)
        capsys.readouterr()
        jckpt.restore_checkpoint(str(tmp_path / "j"), "Training", pool=j_pool(n_pool, 1.0),
                                 d_state=None)
        want_msg = capsys.readouterr().out
        back, _, epoch = ckpt.restore_checkpoint(str(tmp_path / "t"), "Training",
                                                 pool=t_pool(n_pool, 7))
        assert capsys.readouterr().out == want_msg
        assert ("warm-started" if n_pool > n_disk else "keeping the best (first) 1") in want_msg
        assert epoch == 2 and len(back.members) == n_pool
        lead = saved.members[0].state
        for k, m in enumerate(back.members):
            st = m.state
            src = saved.members[k].state if k < n_disk else lead
            assert all(torch.equal(a, b) for a, b in zip(st.params, src.params))
            assert all(torch.equal(a, b) for a, b in zip(st.ema_params, src.ema_params))
            if k >= n_disk:  # its own fresh Adam state and bookkeeping
                assert st.count == 0 and not any(t.any() for t in st.mu)
                assert m.running_loss == float("inf")
            else:
                assert st.count == 1 and m.running_loss == 0.3
        if n_pool > n_disk:  # copies, not the leader's tensors
            assert back.members[1].state.params[0] is not back.members[0].state.params[0]
