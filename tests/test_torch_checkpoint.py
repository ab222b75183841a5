"""The port's generator pool and checkpoints against the JAX package:
the pool's helpers and scheduler against ``srgan_tpu.training.pool``, the
snapshot directory rules against ``srgan_tpu.training.checkpoint``, the
async writer, the sidecar, and save → restore → K steps against the run
that was never stopped (bit for bit, on the CPU)."""

import dataclasses
import json
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srgan_tpu.config import ModelConfig as JModelConfig
from srgan_tpu.config import PoolConfig as JPoolConfig
from srgan_tpu.config import TrainConfig as JTrainConfig
from srgan_tpu.training import checkpoint as jckpt
from srgan_tpu.training import pool as jpool
from srgan_tpu_torch.config import ModelConfig, PoolConfig, TrainConfig, shared_fields
from srgan_tpu_torch.models.srresnet import init_generator
from srgan_tpu_torch.training import checkpoint as ckpt
from srgan_tpu_torch.training import pool as tpool
from srgan_tpu_torch.training import stacked_pool as tsp
from srgan_tpu_torch.training.steps import generator_pixel_step
from srgan_tpu_torch.training.train_state import TrainState

torch.set_num_threads(1)

TINY = ModelConfig(num_features=8, num_residuals=1, upscale_factor=2)


def _pool(ema_decay=0.0, seed=0, cfg=PoolConfig()):
    state = TrainState(init_generator(TINY, seed=seed), ema_decay=ema_decay)
    return tpool.GeneratorPool([state], cfg)


def _batches(k, seed=0):
    rng = np.random.default_rng(seed)
    return [(torch.from_numpy(rng.random((2, 16, 16, 3), dtype=np.float32)),
             torch.from_numpy(rng.random((2, 8, 8, 3), dtype=np.float32)))
            for _ in range(k)]


def _tensors(pool):
    st = pool.leader.state
    return [*st.params, *st.mu, *st.nu, *st.ema_params]


class TestPool:
    def test_interpolate_and_sort_match_jax(self, rng):
        a = [rng.standard_normal((3, 4)).astype(np.float32) for _ in range(2)]
        b = [rng.standard_normal((3, 4)).astype(np.float32) for _ in range(2)]
        want = jpool.interpolate_params([jnp.asarray(x) for x in a],
                                        [jnp.asarray(x) for x in b], 0.3)
        got = [torch.from_numpy(x.copy()) for x in a]
        tsp.interpolate_params(got, [torch.from_numpy(x) for x in b], 0.3)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)
        lists = (["a", "b", "c"], [1, 2, 3], [0.5, 0.1, 0.9])
        for reverse in (True, False):
            assert (tpool.sort_lists_in_same_order(*lists, reverse=reverse)
                    == jpool.sort_lists_in_same_order(*lists, reverse=reverse))

    @pytest.mark.parametrize("kw", [
        {}, dict(starting_gan_loss=0.3, pre_loss_gate=True),
        dict(sort_ascending=False, mutual_learning=False),
    ], ids=["auto_gate", "fixed_gate_pre_loss", "descending"])
    def test_scheduler_matches_jax(self, rng, kw):
        """Three members through two epochs of losses, the port's batch API
        (one mask and one (N,) loss record a batch) against JAX's member
        list (one ``choose_gan`` and one ``record_loss`` a member): the same
        gate probabilities, Bernoulli draws, order, threshold and
        snapshot."""
        losses = rng.uniform(0.1, 0.9, (2, 5, 3))

        class _State:  # the JAX pool's state stand-in: params only
            def __init__(self, v):
                self.params, self.ema_params = {"w": jnp.full(2, v)}, None

            def replace(self, **kw):
                out = _State(0.0)
                out.params, out.ema_params = kw["params"], kw["ema_params"]
                return out

        j = jpool.GeneratorPool([jpool.PoolMember(state=_State(i)) for i in range(3)],
                                JPoolConfig(**kw), seed=7)
        states = [TrainState(torch.nn.Linear(1, 2, bias=False)) for _ in range(3)]
        for i, st in enumerate(states):
            st.params[0].data.fill_(float(i))
        t = tpool.GeneratorPool(states, PoolConfig(**kw), seed=7)
        for epoch in range(2):
            for b in range(5):
                assert t.gan_probabilities().tolist() == [j.gan_probability(i)
                                                          for i in range(3)]
                used = [j.choose_gan(i) for i in range(3)]
                assert t.sample_gan_mask(True).astype(bool).tolist() == used
                t.record_losses(losses[epoch, b])
                for i in range(3):
                    j.record_loss(i, losses[epoch, b, i], used[i])
            t.end_epoch()
            j.end_epoch()
            np.testing.assert_equal(t.snapshot(), j.snapshot())
            assert t.gan_threshold == j.gan_threshold
            for tm, jm in zip(t.members, j.members):
                np.testing.assert_allclose(tm.state.params[0].detach().numpy().ravel(),
                                           np.asarray(jm.state.params["w"]), rtol=1e-6)
        t.reseed(3)
        j.reseed(3)
        assert ([t.sample_gan_mask(True).astype(bool).tolist() for _ in range(20)]
                == [[j.choose_gan(i) for i in range(3)] for _ in range(20)])


class TestCheckpointFiles:
    def test_versioned_names_and_slots_match_jax(self, tmp_path):
        """The same dir names and order as JAX: the "highest slot + 1" rule,
        temporary dirs of either package counted as used slots and never
        listed as snapshots, other prefixes ignored."""
        d = str(tmp_path)
        for name in ("Training_ckpt@3", "Training_ckpt@3.2", "Training_ckpt@12",
                     "Training-best_ckpt@9", "Training_ckpt@4.1.orbax-checkpoint-tmp-1",
                     "Training_ckpt@4" + ckpt.TMP_SUFFIX,
                     "Training_ckpt@6.2" + ckpt.TMP_SUFFIX):
            os.makedirs(tmp_path / name)
        want = [os.path.join(d, n) for n in ("Training_ckpt@3", "Training_ckpt@3.2",
                                             "Training_ckpt@12")]
        assert ckpt._committed_ckpt_dirs(d, "Training") == want
        assert jckpt._committed_ckpt_dirs(d, "Training") == want
        assert ckpt.latest_ckpt_dir(d, "Training-best").endswith("@9")
        for epoch, name in ((3, "@3.3"), (5, "@5"), (12, "@12.1")):
            assert ckpt._next_ckpt_dir(d, "Training", epoch).endswith(name)
            assert jckpt._next_ckpt_dir(d, "Training", epoch).endswith(name)
        # each package counts its own temporary dirs as used slots
        assert jckpt._next_ckpt_dir(d, "Training", 4).endswith("@4.2")
        assert ckpt._next_ckpt_dir(d, "Training", 6).endswith("@6.3")
        os.rmdir(tmp_path / "Training_ckpt@4.1.orbax-checkpoint-tmp-1")
        assert ckpt._next_ckpt_dir(d, "Training", 4).endswith("@4.1")
        assert ckpt.latest_ckpt_dir(str(tmp_path / "absent"), "Training") is None

    def test_gc_only_after_a_commit(self, tmp_path):
        d, pool = str(tmp_path), _pool()
        first = ckpt.save_checkpoint(d, "Training", pool=pool, epoch=1)
        # periodic: the newest committed snapshot survives until the next
        # save commits in its turn
        second = ckpt.save_checkpoint(d, "Training", pool=pool, epoch=2, block=False)
        ckpt.wait_for_checkpoints()
        assert ckpt._committed_ckpt_dirs(d, "Training") == [first, second]
        third = ckpt.save_checkpoint(d, "Training", pool=pool, epoch=2)
        assert third.endswith("@2.1")
        assert ckpt._committed_ckpt_dirs(d, "Training") == [third]
        assert sorted(os.listdir(d)) == ["Training_ckpt@2.1"]

    def test_async_save_survives_in_place_updates(self, tmp_path, monkeypatch):
        """save(block=False) copies every tensor to the host before it
        returns: the step's in-place updates after it do not reach the
        file, though the writer runs only after them."""
        updated = threading.Event()
        save = torch.save

        def save_after_the_updates(obj, f):
            assert updated.wait(timeout=60)
            save(obj, f)

        monkeypatch.setattr(ckpt.torch, "save", save_after_the_updates)
        pool = _pool(ema_decay=0.9)
        before = [t.clone() for t in _tensors(pool)]
        ckpt.save_checkpoint(str(tmp_path), "Training", pool=pool, epoch=1, block=False)
        st = pool.leader.state
        for hr, lr_imgs in _batches(2):
            generator_pixel_step(st, hr, lr_imgs, 1e-2)
        updated.set()
        ckpt.wait_for_checkpoints()
        monkeypatch.undo()
        fresh = _pool(ema_decay=0.9, seed=1)
        ckpt.restore_checkpoint(str(tmp_path), "Training", pool=fresh)
        assert all(torch.equal(a, b) for a, b in zip(_tensors(fresh), before))
        assert fresh.leader.state.count == 0

    def test_writer_error_reraises_at_wait(self, tmp_path, monkeypatch):
        def broken(obj, f):
            raise OSError("disk full")

        monkeypatch.setattr(ckpt.torch, "save", broken)
        ckpt.save_checkpoint(str(tmp_path), "Training", pool=_pool(), epoch=1,
                             block=False)
        with pytest.raises(OSError, match="disk full"):
            ckpt.wait_for_checkpoints()
        ckpt.wait_for_checkpoints()  # raised once, then settled
        assert ckpt.latest_ckpt_dir(str(tmp_path), "Training") is None

    def test_sidecar_is_jax_json(self, tmp_path):
        cfg = ModelConfig(num_features=16, head="coarse", compute_dtype="bfloat16")
        ckpt.save_checkpoint(str(tmp_path), "Run", pool=_pool(), epoch=1,
                             model_config=cfg)
        # srgan_tpu/training/checkpoint.py writes the sidecar with this call
        want = json.dumps(dataclasses.asdict(JModelConfig(**shared_fields(cfg))), indent=2)
        assert (tmp_path / "Run_model.json").read_text() == want
        assert ckpt.load_model_config(str(tmp_path), "Run") == cfg
        assert jckpt.load_model_config(str(tmp_path), "Run") == JModelConfig(
            **shared_fields(cfg))
        assert ckpt.load_model_config(str(tmp_path), "Absent") is None

    def test_finetune_entry_matches_jax(self):
        got = ckpt.finetune_entry(TrainConfig(lr_generator=3e-4))
        want = jckpt.finetune_entry(JTrainConfig(lr_generator=3e-4))
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


class TestRestore:
    @pytest.mark.parametrize("ema_decay", [0.0, 0.9], ids=["no_ema", "ema"])
    def test_save_restore_k_steps_equal_uninterrupted(self, tmp_path, ema_decay):
        """Save after 2 steps, restore into a fresh state, 3 more steps on
        each: params, Adam moments, EMA shadows and counters equal bit for
        bit to the run that was never stopped."""
        batches = _batches(5)
        run = _pool(ema_decay)
        for hr, lr_imgs in batches[:2]:
            generator_pixel_step(run.leader.state, hr, lr_imgs, 1e-3)
            run.sample_gan_mask(False)
            run.record_losses([0.5])
        run.end_epoch()
        ckpt.save_checkpoint(str(tmp_path), "Training", pool=run, epoch=1)
        back = _pool(ema_decay, seed=5)
        params_before = back.leader.state.params
        back, _, epoch = ckpt.restore_checkpoint(str(tmp_path), "Training", pool=back)
        assert epoch == 1
        assert back.leader.state.params is params_before  # copied in place
        assert back.snapshot() == run.snapshot()
        for hr, lr_imgs in batches[2:]:
            for pool in (run, back):
                generator_pixel_step(pool.leader.state, hr, lr_imgs, 1e-3)
        assert back.leader.state.count == run.leader.state.count == 5
        assert all(torch.equal(a, b) for a, b in zip(_tensors(back), _tensors(run)))
        assert all(torch.equal(a, b) for a, b in zip(
            back.leader.state.model.parameters(), run.leader.state.model.parameters()))

    def test_ema_run_warm_starts_from_a_pre_ema_snapshot(self, tmp_path, capsys):
        plain = _pool(0.0)
        generator_pixel_step(plain.leader.state, *_batches(1)[0], 1e-3)
        ckpt.save_checkpoint(str(tmp_path), "Training", pool=plain, epoch=1)
        ema = _pool(0.9, seed=2)
        ckpt.restore_checkpoint(str(tmp_path), "Training", pool=ema)
        st = ema.leader.state
        assert all(torch.equal(e, p) for e, p in zip(st.ema_params, st.params))
        assert "no EMA shadows; warm-starting" in capsys.readouterr().out
        # and the other way: a run without EMA drops the saved shadows
        ckpt.save_checkpoint(str(tmp_path), "Training", pool=ema, epoch=2)
        ckpt.restore_checkpoint(str(tmp_path), "Training", pool=_pool(0.0))

    def test_gate_threshold_and_generator_params(self, tmp_path):
        pool = _pool(0.9)
        pool.sample_gan_mask(False)
        pool.record_losses([0.4])
        ckpt.save_checkpoint(str(tmp_path), "Training", pool=pool, epoch=1)
        fresh = _pool(0.9)
        ckpt.restore_checkpoint(str(tmp_path), "Training", pool=fresh)
        assert fresh.gan_threshold is None  # NaN on disk: not calibrated yet
        pool.end_epoch()
        ckpt.save_checkpoint(str(tmp_path), "Training", pool=pool, epoch=2)
        ckpt.restore_checkpoint(str(tmp_path), "Training", pool=fresh)
        assert fresh.gan_threshold == pytest.approx(0.6 * 0.4)
        pinned = _pool(0.9, cfg=PoolConfig(starting_gan_loss=0.05))
        ckpt.restore_checkpoint(str(tmp_path), "Training", pool=pinned)
        assert pinned.gan_threshold == 0.05  # an explicit value wins

        sd = ckpt.restore_generator_params(str(tmp_path), "Training")
        model = init_generator(TINY, seed=9)
        model.load_state_dict(sd)  # strict: every key
        assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                     pool.leader.state.params))
        shadow = ckpt.restore_all_generator_params(str(tmp_path), "Training", ema=True)
        assert len(shadow) == 1 and shadow[0].keys() == sd.keys()

        ckpt.save_checkpoint(str(tmp_path), "Plain", pool=_pool(0.0), epoch=1)
        with pytest.raises(KeyError, match="no EMA shadows"):
            ckpt.restore_generator_params(str(tmp_path), "Plain", ema=True)
        with pytest.raises(FileNotFoundError):
            ckpt.restore_checkpoint(str(tmp_path), "Absent", pool=fresh)


def test_host_copies_are_one_buffer_a_dtype_and_copies():
    """The snapshot's host copies: equal to the tensors, of their shapes
    and dtypes (a 0-d one among them), views of one buffer a dtype, and
    unmoved by a later in-place update of the originals."""
    ts = [torch.arange(6.0).reshape(2, 3), torch.tensor(7, dtype=torch.int64),
          torch.ones(4, dtype=torch.bfloat16), torch.tensor(2.5), torch.zeros(0, 3)]
    out = ckpt._host(ts)
    for t, h in zip(ts, out):
        assert h.shape == t.shape and h.dtype == t.dtype and torch.equal(h, t)
    assert out[0].untyped_storage().data_ptr() == out[3].untyped_storage().data_ptr()
    assert out[0].untyped_storage().data_ptr() != out[2].untyped_storage().data_ptr()
    ts[0].add_(1.0)
    assert torch.equal(out[0], torch.arange(6.0).reshape(2, 3))
