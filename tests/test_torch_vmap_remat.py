"""The vmap pool executor on remat models (``ModelConfig.remat`` under
``member_exec="vmap"``: each residual block's ``RematBlock`` hands its
batched input and params out of the vmap to ``PooledRematBlock``, which
recomputes the members' branch in the backward) against JAX's vmapped steps
on ``remat=True`` models, against the port's vmap executor without remat,
and end to end (``Trainer.train`` against the JAX Trainer, ``train
--pool-exec vmap --remat``). Sizes, helpers and the ``batching_rules_only``
fixture (functorch's per-member fallback off) are those of
tests/test_torch_vmap_pool.py.

Tolerances: against JAX, those of tests/test_torch_pool.py (losses rel
1e-4 fp32 / 2e-2 bf16, adversarial terms ADV_ATOL, Adam moments GRAD_RTOL
after the first step). Against the vmap executor without remat: the losses
and SR bit-identical (the forward runs the same ops), params and Adam
moments within JAX's vmap-against-scan bars, rtol 2e-4 / atol 1e-6 (the
backward runs the same ops in another graph). With remat the bytes that
autograd saves for the backward are fewer: the recompute happens and
nothing keeps every activation.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srgan_tpu.config import Config as JConfig
from srgan_tpu.config import DataConfig as JDataConfig
from srgan_tpu.config import DiscriminatorConfig as JDiscriminatorConfig
from srgan_tpu.config import ModelConfig as JModelConfig
from srgan_tpu.config import PoolConfig as JPoolConfig
from srgan_tpu.config import TrainConfig as JTrainConfig
from srgan_tpu.training import stacked_pool as jsp
from srgan_tpu.training.loop import Trainer as JTrainer
from srgan_tpu_torch import cli
from srgan_tpu_torch.config import DiscriminatorConfig, ModelConfig, shared_fields
from srgan_tpu_torch.models.discriminator import init_discriminator
from srgan_tpu_torch.models.srresnet import init_generator
from srgan_tpu_torch.models.vgg import VGG19Features
from srgan_tpu_torch.ops.cuda import recon_loss_kernel as rk
from srgan_tpu_torch.training import stacked_pool as tsp
from srgan_tpu_torch.training import train_state as tts
from srgan_tpu_torch.training.loop import Trainer
from srgan_tpu_torch.utils.params import discriminator_from_jax_params, from_jax_params
from test_torch_gan import ADV_ATOL, GRAD_RTOL, assert_moments_close, g_moments
from test_torch_pool import (  # noqa: F401 (folders is a fixture)
    LR,
    SMALL_D,
    SMALL_G,
    _batch,
    _check_pool_moments,
    _ds,
    _gan_config,
    _member_moments,
    _pools,
    folders,
)
from test_torch_pool_run import _records_close
from test_torch_vmap_pool import _tensors, batching_rules_only  # noqa: F401 (autouse)

torch.set_num_threads(1)

REMAT_G = dict(SMALL_G, num_residuals=2)


class TestAgainstJax:
    def test_vmap_remat_pool_step_matches_jax(self, rng):
        model, j_states, t_states = _pools(3, remat=True)
        assert t_states[0].model.remat
        j_stacked, stacked = jsp.stack_states(j_states), tsp.stack_states(t_states)
        for k in range(2):
            hr, lr_imgs = _batch(rng)
            j_stacked, m_j = jsp.stacked_pool_step(
                j_stacked, model.apply, None, None, jnp.asarray(hr), jnp.asarray(lr_imgs),
                jnp.zeros(3), jnp.float32(LR), return_sr=True, d_target_idx=np.int32(1))
            stacked, m_t = tsp.stacked_pool_step(stacked, *_tensors(hr, lr_imgs), LR,
                                                 return_sr=True, d_target_idx=1)
            np.testing.assert_allclose(m_t["packed"].numpy(), np.asarray(m_j["packed"]),
                                       rtol=1e-4, atol=1e-7)
            np.testing.assert_allclose(m_t["sr"].numpy(), np.asarray(m_j["sr"]),
                                       rtol=1e-4, atol=1e-5)
            if k == 0:
                for i, st in enumerate(stacked):
                    assert_moments_close(g_moments(st), _member_moments(j_stacked, i),
                                         GRAD_RTOL["float32"], f"member {i}")

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_vmap_remat_pool_gan_step_matches_jax(self, rng, dtype):
        """N=3 with the mask [1, 0, 1], D trained on member 2's SR."""
        model, j_states, t_states = _pools(3, dtype, remat=True)
        d_model, jd, td = _ds(dtype)
        j_stacked, stacked = jsp.stack_states(j_states), tsp.stack_states(t_states)
        mask = np.asarray([1.0, 0.0, 1.0], np.float32)
        rel = 1e-4 if dtype == "float32" else 2e-2
        for k in range(2):
            hr, lr_imgs = _batch(rng)
            j_stacked, jd, m_j = jsp.stacked_pool_gan_step(
                j_stacked, jd, model.apply, d_model.apply, jnp.asarray(hr),
                jnp.asarray(lr_imgs), jnp.asarray(mask), jnp.float32(LR), jnp.float32(LR),
                d_target_idx=np.int32(2))
            stacked, td, m_t = tsp.stacked_pool_gan_step(
                stacked, td, *_tensors(hr, lr_imgs), mask, LR, LR, d_target_idx=2)
            got, want = m_t["packed"].numpy(), np.asarray(m_j["packed"])
            np.testing.assert_allclose(got[:9], want[:9], rtol=rel, atol=1e-7)
            np.testing.assert_allclose(got[9:], want[9:], rtol=0, atol=ADV_ATOL[dtype])
            if k == 0:
                _check_pool_moments(stacked, td, j_stacked, jd, GRAD_RTOL[dtype])

    def test_trainer_vmap_remat_matches_jax_trainer(self, tmp_path, folders):
        """Trainer.train with ``member_exec="vmap"`` and ``remat`` against
        JAX's, a GAN pool of 3 over 2 epochs: the JSONL records and the
        artifact names."""
        pool = dict(p_gan_above=0.6, member_exec="vmap")
        cfg_t = _gan_config(tmp_path / "torch", 3, **pool)
        cfg_t = cfg_t.replace(model=dataclasses.replace(cfg_t.model, remat=True))
        j_train = {**dataclasses.asdict(cfg_t.train), "results_dir": str(tmp_path / "jax")}
        cfg_j = JConfig(model=JModelConfig(**shared_fields(cfg_t.model)),
                        discriminator=JDiscriminatorConfig(
                            **dataclasses.asdict(cfg_t.discriminator)),
                        data=JDataConfig(**dataclasses.asdict(cfg_t.data)),
                        pool=JPoolConfig(num_generators=3, **pool),
                        train=JTrainConfig(**j_train))
        assert cfg_j.model.remat
        trainer_j = JTrainer(cfg_j, use_mesh=False)
        trainer_t = Trainer(cfg_t, device="cpu")
        assert trainer_t.pool_steps == (tsp.stacked_pool_step, tsp.stacked_pool_gan_step)
        assert all(m.state.model.remat for m in trainer_t.pool.members)
        for m_t, m_j in zip(trainer_t.pool.members, trainer_j.pool.members):
            m_t.state.model.load_state_dict(from_jax_params(jax.device_get(m_j.state.params)))
        trainer_t.d_state.model.load_state_dict(
            discriminator_from_jax_params(jax.device_get(trainer_j.d_state.params)))
        trainer_j.train(*folders)
        trainer_t.train(*folders)
        recs_t = trainer_t.logger.read_records()
        _records_close(recs_t, trainer_j.logger.read_records(), "float32")
        assert sum(m["gan_updates"] for m in recs_t[-1]["pool"]) > 0
        assert sorted(os.listdir(tmp_path / "torch")) == sorted(os.listdir(tmp_path / "jax"))


# against the port's vmap executor without remat, from the same weights


def _members(remat, dtype="float32", n=3):
    cfg = ModelConfig(compute_dtype=dtype, remat=remat, **REMAT_G)
    return [tts.TrainState(init_generator(cfg, seed=i)) for i in range(n)]


def _step(kind, dtype, remat, hr, lr_imgs):
    """One vmap step of ``kind`` from fresh members (and D, and the
    extractor): (metrics, every member's and D's state)."""
    members = _members(remat, dtype)
    if kind == "gan":
        d_state = tts.TrainState(init_discriminator(
            DiscriminatorConfig(compute_dtype=dtype, **SMALL_D), seed=9))
        members, d_state, m = tsp.stacked_pool_gan_step(
            members, d_state, hr, lr_imgs, np.asarray([1.0, 0.0, 1.0], np.float32), LR, LR,
            d_target_idx=2)
        return m, [*members, d_state]
    extractor = None
    if kind == "perceptual":
        torch.manual_seed(0)
        extractor = VGG19Features(layers=("conv1_2",)).requires_grad_(False)
    members, m = tsp.stacked_pool_step(members, hr, lr_imgs, LR, extractor=extractor,
                                       p_weight=0.1, return_sr=True, d_target_idx=1)
    return m, members


def _saved_bytes(monkeypatch, fn):
    """``fn()`` and the bytes autograd saves for the backward before the
    step's first ``torch.autograd.grad`` (each storage once)."""
    saved, counting = {}, [True]
    grad = torch.autograd.grad

    def first_grad(*args, **kw):
        counting[0] = False
        return grad(*args, **kw)

    def pack(t):
        if counting[0]:
            s = t.untyped_storage()
            saved[s.data_ptr()] = s.nbytes()
        return t

    monkeypatch.setattr(torch.autograd, "grad", first_grad)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    monkeypatch.setattr(torch.autograd, "grad", grad)
    return out, sum(saved.values())


_AGAINST_VMAP = [("pixel", "float32"), ("gan", "float32"), ("gan", "bfloat16"),
                 ("perceptual", "float32")]


class TestAgainstVmap:
    @pytest.mark.parametrize("kind,dtype", _AGAINST_VMAP,
                             ids=[f"{k}-{d}" for k, d in _AGAINST_VMAP])
    def test_same_step_as_without_remat(self, rng, kind, dtype):
        """The losses (and in the pixel steps member 1's pre-update SR)
        bit-identical; every member's and D's params and Adam moments
        within rtol 2e-4 / atol 1e-6."""
        hr, lr_imgs = _tensors(*_batch(rng))
        (m_r, st_r), (m_p, st_p) = (_step(kind, dtype, remat, hr, lr_imgs)
                                    for remat in (True, False))
        assert torch.equal(m_r["packed"], m_p["packed"])
        if kind == "perceptual":
            assert (m_r["p_loss"] > 0).all()
        if "sr" in m_r:
            assert torch.equal(m_r["sr"], m_p["sr"])
        for a, b in zip(st_r, st_p):
            for x, y in zip(a.params + a.mu + a.nu, b.params + b.mu + b.nu):
                torch.testing.assert_close(x, y, rtol=2e-4, atol=1e-6)

    @pytest.mark.parametrize("kind", ["pixel", "gan"])
    def test_saved_bytes_fewer_with_remat(self, rng, monkeypatch, kind):
        """The memory witness: the bytes saved for the backward, counted by
        ``saved_tensors_hooks`` up to the first gradient call, are fewer
        with remat (each block keeps its input and params, not its
        activations)."""
        hr, lr_imgs = _tensors(*_batch(rng))
        nbytes = {}
        for remat in (True, False):
            _, nbytes[remat] = _saved_bytes(
                monkeypatch, lambda: _step(kind, "float32", remat, hr, lr_imgs))
        # each of the 2 blocks drops at least one (3, 2, 8, 8, 16) f32
        # activation of its branch
        assert nbytes[False] - nbytes[True] >= 2 * 3 * 2 * 8 * 8 * 16 * 4, nbytes

    def test_one_k1_k2_k3_call_a_step(self, rng, monkeypatch):
        """The recompute leaves the loss alone: K1 once, K2 and K3 once each
        over the member axis (their plain versions here)."""
        calls = {}
        for name in ("edge_stats", "loss_sums", "loss_grad", "loss_sums_pooled",
                     "loss_grad_pooled"):
            fn = getattr(rk, name)

            def counted(*args, _fn=fn, _name=name, **kw):
                calls[_name] = calls.get(_name, 0) + 1
                return _fn(*args, **kw)
            monkeypatch.setattr(rk, name, counted)
        tsp.stacked_pool_step(_members(True), *_tensors(*_batch(rng)), LR)
        assert calls == {"edge_stats": 1, "loss_sums_pooled": 1, "loss_grad_pooled": 1}


@pytest.mark.parametrize("extra", [["--gan"], ["--bf16"]], ids=["gan", "bf16"])
def test_cli_train_pool_exec_vmap_remat(tmp_path, folders, capsys, extra):
    """``train --num-generators 2 --pool-exec vmap --remat`` runs end to end
    (GAN in fp32, pixel in bf16); its records equal those of the same run
    without ``--remat`` (the losses bit for bit)."""
    train_dir, val_dir = folders
    base = ["train", "--train-dir", train_dir, "--val-dir", val_dir,
            "--batch-size", "2", "--hr-height", "32", "--hr-width", "64",
            "--num-features", "8", "--num-residuals", "2", "--d-stages", "2",
            "--d-features", "8", "--progress", "off", "--device", "cpu",
            "--validate-every", "0", "--epochs", "1", "--num-generators", "2",
            "--pool-exec", "vmap", *extra]
    records = {}
    for tag, remat in (("remat", ["--remat"]), ("plain", [])):
        res = tmp_path / tag
        cli.main([*base, *remat, "--results-dir", str(res)])
        with open(res / "Training_metrics.jsonl") as f:
            records[tag] = [json.loads(ln) for ln in f if ln.strip()]
        assert (res / "Training_model.json").exists()
    assert "Epoch [1/1] Training" in capsys.readouterr().out
    r, p = records["remat"][-1], records["plain"][-1]
    assert r["n_batches"] == p["n_batches"] > 0
    for k in ("g_loss", "com_loss", "tv_loss", "g_d_loss", "d_loss", "pool"):
        assert r[k] == p[k], k
