"""The port's vmap pool executor (``stacked_pool_step``,
``stacked_pool_gan_step``: all members in one ``torch.func.vmap`` region,
the loss through the kernels' Function and its vmap rule) against JAX's
vmapped steps, against the port's own scan executor, and end to end
(``Trainer.train`` against the JAX Trainer with ``member_exec="vmap"``, and
``train --pool-exec vmap``). Also the pooled plain versions of K2/K3
against per-member calls, and one K1, K2 and K3 call a pool step. Sizes as
in tests/test_torch_pool.py (F=8, 1 block, HR 32x64, D 2 stages at 8
filters, lr 1e-5), whose helpers and bridge these tests reuse.

Every test runs with functorch's per-example fallback switched off and its
"performance drop" warning an error, so that an op without a batching rule
fails instead of looping over the members.

Tolerances: against JAX, those of tests/test_torch_pool.py (losses rel
1e-4 fp32 / 2e-2 bf16, adversarial terms ADV_ATOL, Adam moments GRAD_RTOL
after the first step). vmap against scan, JAX's own bars
(``tests/test_stacked_pool.py:151-255``): losses rel 1e-5 / abs 1e-7, SR
rtol 1e-5 / atol 1e-6, params and Adam moments rtol 2e-4 / atol 1e-6, on
``norm="none"`` models (with GroupNorm the residual convs' biases have an
exactly-zero true gradient, and Adam amplifies the rounding noise that
stands in for it); GroupNorm models on losses and SR only.
"""

import dataclasses
import os
import warnings

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
from srgan_tpu_torch.config import DiscriminatorConfig, ModelConfig
from srgan_tpu_torch.models.discriminator import init_discriminator
from srgan_tpu_torch.models.srresnet import init_generator
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

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def batching_rules_only():
    """No op may fall back to functorch's per-member loop."""
    fx = torch._C._functorch
    enabled = fx._is_vmap_fallback_enabled()
    fx._set_vmap_fallback_enabled(False)
    fx._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("error", message=".*performance drop.*")
            yield
    finally:
        fx._set_vmap_fallback_warning_enabled(False)
        fx._set_vmap_fallback_enabled(enabled)


def _tensors(*arrays):
    return [torch.from_numpy(a) for a in arrays]


class TestAgainstJax:
    def test_vmap_pool_step_matches_jax(self, rng):
        model, j_states, t_states = _pools(3)
        j_stacked, stacked = jsp.stack_states(j_states), tsp.stack_states(t_states)
        for k in range(3):
            hr, lr_imgs = _batch(rng)
            j_stacked, m_j = jsp.stacked_pool_step(
                j_stacked, model.apply, None, None, jnp.asarray(hr), jnp.asarray(lr_imgs),
                jnp.zeros(3), jnp.float32(LR), return_sr=True, d_target_idx=np.int32(1))
            stacked, m_t = tsp.stacked_pool_step(stacked, *_tensors(hr, lr_imgs), LR,
                                                 return_sr=True, d_target_idx=1)
            assert m_t["packed"].shape == (5, 3)
            np.testing.assert_allclose(m_t["packed"].numpy(), np.asarray(m_j["packed"]),
                                       rtol=1e-4, atol=1e-7)
            np.testing.assert_allclose(m_t["sr"].numpy(), np.asarray(m_j["sr"]),
                                       rtol=1e-4, atol=1e-5)
            if k == 0:
                for i, st in enumerate(stacked):
                    assert_moments_close(g_moments(st), _member_moments(j_stacked, i),
                                         GRAD_RTOL["float32"], f"member {i}")
        assert [st.count for st in stacked] == [3] * 3

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_vmap_pool_gan_step_matches_jax(self, rng, dtype):
        """N=3 with the mask [1, 0, 1], D trained on member 2's SR, against
        JAX's fused vmapped GAN step."""
        model, j_states, t_states = _pools(3, dtype)
        d_model, jd, td = _ds(dtype)
        j_stacked, stacked = jsp.stack_states(j_states), tsp.stack_states(t_states)
        mask = np.asarray([1.0, 0.0, 1.0], np.float32)
        rel = 1e-4 if dtype == "float32" else 2e-2
        for k in range(3):
            hr, lr_imgs = _batch(rng)
            j_stacked, jd, m_j = jsp.stacked_pool_gan_step(
                j_stacked, jd, model.apply, d_model.apply, jnp.asarray(hr),
                jnp.asarray(lr_imgs), jnp.asarray(mask), jnp.float32(LR), jnp.float32(LR),
                d_target_idx=np.int32(2))
            stacked, td, m_t = tsp.stacked_pool_gan_step(
                stacked, td, *_tensors(hr, lr_imgs), mask, LR, LR, d_target_idx=2)
            got, want = m_t["packed"].numpy(), np.asarray(m_j["packed"])
            assert got.shape == want.shape == (16,)
            np.testing.assert_allclose(got[:9], want[:9], rtol=rel, atol=1e-7)
            np.testing.assert_allclose(got[9:], want[9:], rtol=0, atol=ADV_ATOL[dtype])
            if k == 0:
                _check_pool_moments(stacked, td, j_stacked, jd, GRAD_RTOL[dtype])

    def test_trainer_vmap_matches_jax_trainer(self, tmp_path, folders):
        """Trainer.train with ``member_exec="vmap"`` against JAX's, a GAN pool
        of 3 over 2 epochs: the JSONL records and the artifact names."""
        pool = dict(p_gan_above=0.6, member_exec="vmap")
        cfg_t = _gan_config(tmp_path / "torch", 3, **pool)
        j_train = {**dataclasses.asdict(cfg_t.train), "results_dir": str(tmp_path / "jax")}
        cfg_j = JConfig(model=JModelConfig(**dataclasses.asdict(cfg_t.model)),
                        discriminator=JDiscriminatorConfig(
                            **dataclasses.asdict(cfg_t.discriminator)),
                        data=JDataConfig(**dataclasses.asdict(cfg_t.data)),
                        pool=JPoolConfig(num_generators=3, **pool),
                        train=JTrainConfig(**j_train))
        trainer_j = JTrainer(cfg_j, use_mesh=False)
        trainer_t = Trainer(cfg_t, device="cpu")
        assert trainer_t.pool_steps == (tsp.stacked_pool_step, tsp.stacked_pool_gan_step)
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


# vmap against scan: JAX's ``test_scanned_step_matches_vmapped`` and
# ``test_scanned_gan_step_matches_vmapped`` (``tests/test_stacked_pool.py``:
# F=8, 1 block, 2x, lr 1e-3, uniform random images), on the port's executors


def _members(n, norm, dtype="float32"):
    cfg = ModelConfig(num_features=8, num_residuals=1, upscale_factor=2, norm=norm,
                      compute_dtype=dtype)
    return [tts.TrainState(init_generator(cfg, seed=i)) for i in range(n)]


def _d_state(dtype="float32"):
    cfg = DiscriminatorConfig(compute_dtype=dtype, **SMALL_D)
    return tts.TrainState(init_discriminator(cfg, seed=9))


def _close_states(a, b):
    for x, y in zip(a, b):
        for p, q in zip(x.params + x.mu + x.nu, y.params + y.mu + y.nu):
            torch.testing.assert_close(p, q, rtol=2e-4, atol=1e-6)


def _close_losses(m_v, m_s, keys):
    for k in keys:
        torch.testing.assert_close(m_v[k], m_s[k], rtol=1e-5, atol=1e-7)


class TestAgainstScan:
    @pytest.mark.parametrize("norm", ["none", "group"])
    def test_pixel_step(self, rng, norm):
        """One pixel step of each executor from the same 3 members, HR
        16x16; member 1's pre-update SR."""
        a, b = _members(3, norm), _members(3, norm)
        hr = torch.from_numpy(rng.random((2, 16, 16, 3)).astype(np.float32))
        lr_imgs = torch.from_numpy(rng.random((2, 8, 8, 3)).astype(np.float32))
        a, m_v = tsp.stacked_pool_step(a, hr, lr_imgs, 1e-3, return_sr=True,
                                       d_target_idx=1)
        sr_scan = b[1].model(lr_imgs).detach()
        b, m_s = tsp.scanned_pool_step(b, hr, lr_imgs, 1e-3)
        _close_losses(m_v, m_s, ("com_loss", "tv_loss", "g_loss"))
        torch.testing.assert_close(m_v["sr"], sr_scan, rtol=1e-5, atol=1e-6)
        if norm == "none":
            _close_states(a, b)

    @pytest.mark.parametrize("norm", ["none", "group"])
    def test_gan_step(self, rng, norm):
        """One fused GAN step of each executor from the same 2 members and D,
        HR 64x64, mask [1, 1], D on member 1's SR: every loss, the members'
        and D's params and moments."""
        a, b = _members(2, norm), _members(2, norm)
        da, db = _d_state(), _d_state()
        hr = torch.from_numpy(rng.random((2, 64, 64, 3)).astype(np.float32))
        lr_imgs = torch.from_numpy(rng.random((2, 32, 32, 3)).astype(np.float32))
        mask = np.ones(2, np.float32)
        a, da, m_v = tsp.stacked_pool_gan_step(a, da, hr, lr_imgs, mask, 1e-3, 1e-3,
                                               d_target_idx=1)
        b, db, m_s = tsp.scanned_pool_gan_step(b, db, hr, lr_imgs, mask, 1e-3, 1e-3,
                                               d_target_idx=1)
        _close_losses(m_v, m_s, ("com_loss", "tv_loss", "g_d_loss", "g_loss", "d_loss"))
        if norm == "none":
            _close_states(a, b)
            _close_states([da], [db])

    def test_perceptual_pixel_step(self, rng):
        """The perceptual term: the extractor on the members' N·B SR images
        at once, each member's mean over its own slice."""
        from srgan_tpu_torch.models.vgg import VGG19Features

        torch.manual_seed(0)
        extractor = VGG19Features(layers=("conv1_2",)).requires_grad_(False)
        a, b = _members(2, "none"), _members(2, "none")
        hr = torch.from_numpy(rng.random((2, 16, 16, 3)).astype(np.float32))
        lr_imgs = torch.from_numpy(rng.random((2, 8, 8, 3)).astype(np.float32))
        a, m_v = tsp.stacked_pool_step(a, hr, lr_imgs, 1e-3, extractor=extractor,
                                       p_weight=0.1)
        b, m_s = tsp.scanned_pool_step(b, hr, lr_imgs, 1e-3, extractor=extractor,
                                       p_weight=0.1)
        assert (m_v["p_loss"] > 0).all()
        _close_losses(m_v, m_s, ("com_loss", "tv_loss", "p_loss", "g_loss"))
        _close_states(a, b)

    def test_one_k1_k2_k3_call_a_step(self, rng, monkeypatch):
        """The vmap step calls K1 once and the pooled K2 and K3 once each
        for all members (their plain versions here; the card counts the
        launches)."""
        calls = {}

        def counted(name):
            fn = getattr(rk, name)

            def wrapper(*args, **kw):
                calls[name] = calls.get(name, 0) + 1
                return fn(*args, **kw)
            monkeypatch.setattr(rk, name, wrapper)

        for name in ("edge_stats", "loss_sums", "loss_grad", "loss_sums_pooled",
                     "loss_grad_pooled"):
            counted(name)
        hr, lr_imgs = _tensors(*_batch(rng))
        members = [tts.TrainState(init_generator(ModelConfig(**SMALL_G), seed=i))
                   for i in range(3)]
        tsp.stacked_pool_step(members, hr, lr_imgs, LR)
        assert calls == {"edge_stats": 1, "loss_sums_pooled": 1, "loss_grad_pooled": 1}


class TestPooledPlain:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    def test_pooled_plain_matches_per_member(self, rng, dtype):
        """``loss_sums_pooled_plain`` / ``loss_grad_pooled_plain`` against
        ``loss_sums_plain`` / ``loss_grad_plain`` on each member's sr (rel
        1e-5 in fp32: the sums run over other axes)."""
        hr = torch.from_numpy(_batch(rng)[0]).to(dtype)
        srs = torch.from_numpy(rng.random((3, *hr.shape))).to(dtype)
        g_edge = torch.tensor([1.0, 0.5, -1.5], dtype=dtype)
        g_tv = torch.tensor([1.0, -2.0, 0.25], dtype=dtype)
        stats = rk.edge_stats_plain(hr)
        edge, tv, rows = rk.loss_sums_pooled_plain(hr, srs, stats)
        dsr = rk.loss_grad_pooled_plain(hr, srs, rows, g_edge, g_tv)
        rel = 1e-5 if dtype == torch.float32 else 1e-12
        for i in range(3):
            one = stats.clone()
            e_i, tv_i = rk.loss_sums_plain(hr, srs[i], one)
            torch.testing.assert_close(edge[i], e_i, rtol=rel, atol=0)
            torch.testing.assert_close(tv[i], tv_i, rtol=rel, atol=0)
            torch.testing.assert_close(rows[i], one, rtol=rel, atol=0)
            d_i = rk.loss_grad_plain(hr, srs[i], one, g_edge[i], g_tv[i])
            torch.testing.assert_close(dsr[i], d_i, rtol=rel, atol=rel * float(d_i.abs().max()))

    def test_function_under_vmap_matches_per_member(self, rng):
        """``ReconstructionLoss`` under ``torch.func.vmap`` over sr: the losses
        and the gradient of each member's are those of the Function on its
        own sr."""
        hr = torch.from_numpy(_batch(rng)[0])
        srs = torch.from_numpy(rng.random((3, *hr.shape)).astype(np.float32))
        s = srs.clone().requires_grad_(True)
        edge, tv, _ = torch.func.vmap(rk.ReconstructionLoss.apply, in_dims=(None, 0))(hr, s)
        (g,) = torch.autograd.grad((edge + 0.5 * tv).sum(), s)
        for i in range(3):
            si = srs[i].clone().requires_grad_(True)
            e_i, tv_i, _ = rk.ReconstructionLoss.apply(hr, si)
            (g_i,) = torch.autograd.grad(e_i + 0.5 * tv_i, si)
            torch.testing.assert_close(edge[i], e_i.detach(), rtol=1e-5, atol=0)
            torch.testing.assert_close(tv[i], tv_i.detach(), rtol=1e-5, atol=0)
            torch.testing.assert_close(g[i], g_i, rtol=1e-4, atol=1e-6 * float(g_i.abs().max()))


def test_cli_train_pool_exec_vmap(tmp_path, folders, capsys):
    """``train --gan --num-generators 2 --pool-exec vmap`` runs end to end;
    its first epoch's losses equal the scan executor's run within rel 1e-3
    (GroupNorm models: the rounding of the two executors' convs parts the
    runs slowly)."""
    import json

    train_dir, val_dir = folders
    base = ["train", "--train-dir", train_dir, "--val-dir", val_dir,
            "--batch-size", "2", "--hr-height", "32", "--hr-width", "64",
            "--num-features", "8", "--num-residuals", "1", "--d-stages", "2",
            "--d-features", "8", "--progress", "off", "--device", "cpu",
            "--validate-every", "0", "--epochs", "1", "--gan", "--num-generators", "2"]
    records = {}
    for ex in ("vmap", "scan"):
        res = tmp_path / ex
        cli.main([*base, "--pool-exec", ex, "--results-dir", str(res)])
        with open(res / "Training_metrics.jsonl") as f:
            records[ex] = [json.loads(ln) for ln in f if ln.strip()]
        assert (res / "Training_model.json").exists()
    assert "Epoch [1/1] Training" in capsys.readouterr().out
    v, s = records["vmap"][-1], records["scan"][-1]
    assert v["n_batches"] == s["n_batches"] > 0
    for k in ("g_loss", "com_loss", "tv_loss", "d_loss"):
        assert v[k] == pytest.approx(s[k], rel=1e-3), k
