"""The port's ``Trainer.train`` in the GAN phase against the JAX
package's: a pool of 3 on the scan executor and one generator (the fused
step), in fp32 and bf16, over 2 epochs; a SIGTERM stop and resume of the
pool, bit for bit; and the ``train`` CLI with ``--gan --num-generators 3``,
across the phase boundary.
Sizes and learning rates as in tests/test_torch_pool.py, which says why.

Tolerances: losses and PSNR rel 1e-4 (fp32) / 2e-2 (bf16); the
adversarial terms and SSIM abs 1e-4 / 4e-3 (SSIM 2e-2 in bf16, as the
pixel slice's test); the scheduler's counters equal.
"""

import dataclasses
import os
import signal

import jax
import pytest
import torch

from srgan_tpu.config import Config as JConfig
from srgan_tpu.config import DataConfig as JDataConfig
from srgan_tpu.config import DiscriminatorConfig as JDiscriminatorConfig
from srgan_tpu.config import ModelConfig as JModelConfig
from srgan_tpu.config import PoolConfig as JPoolConfig
from srgan_tpu.config import TrainConfig as JTrainConfig
from srgan_tpu.training.loop import Trainer as JTrainer
from srgan_tpu_torch import cli
from srgan_tpu_torch.config import shared_fields
from srgan_tpu_torch.data.pipeline import TrainPipeline
from srgan_tpu_torch.training import checkpoint as ckpt
from srgan_tpu_torch.training.loop import Trainer
from srgan_tpu_torch.utils.params import discriminator_from_jax_params, from_jax_params
from test_torch_pool import _gan_config, folders  # noqa: F401 (a fixture)

torch.set_num_threads(1)


def _records_close(recs_t, recs_j, dtype):
    rel, adv, ssim = (1e-4, 1e-4, 1e-4) if dtype == "float32" else (2e-2, 4e-3, 2e-2)
    assert [r["epoch"] for r in recs_t] == [r["epoch"] for r in recs_j] == [1, 2]
    for r_t, r_j in zip(recs_t, recs_j):
        assert r_t.keys() == r_j.keys()
        assert r_t["n_batches"] == r_j["n_batches"] == 3
        for k in ("g_loss", "com_loss", "tv_loss", "psnr"):
            assert r_t[k] == pytest.approx(r_j[k], rel=rel), (r_t["epoch"], k)
        for k in ("g_d_loss", "d_loss"):
            assert r_t[k] == pytest.approx(r_j[k], abs=adv), (r_t["epoch"], k)
        assert r_t["ssim"] == pytest.approx(r_j["ssim"], abs=ssim)
        assert r_t["gan_threshold"] == pytest.approx(r_j["gan_threshold"], rel=rel)
        assert len(r_t["pool"]) == len(r_j["pool"])
        for m_t, m_j in zip(r_t["pool"], r_j["pool"]):
            assert m_t.keys() == m_j.keys()
            assert (m_t["gan_updates"], m_t["pixel_updates"]) == (
                m_j["gan_updates"], m_j["pixel_updates"])
            for k in ("running_loss", "pre_loss", "gan_threshold"):
                assert m_t[k] == pytest.approx(m_j[k], rel=rel, nan_ok=True), k


class TestTrainerAgainstJax:
    @pytest.mark.parametrize("n,dtype", [
        (3, "float32"), (1, "float32"), (3, "bfloat16"), (1, "bfloat16"),
    ], ids=["pool3_stacked", "single", "pool3_stacked_bf16", "single_bf16"])
    def test_gan_train_matches_jax_trainer(self, tmp_path, folders, n, dtype):
        """Trainer.train with use_gan against the JAX Trainer.train, 2
        epochs with checkpoints and keep_best: the JSONL records (the pool
        snapshots, gan_threshold, d_loss), the artifact names, byte-equal
        sidecars. The JAX trainer's generators and D are bridged in."""
        pool = dict(p_gan_above=0.6)
        cfg_t = _gan_config(tmp_path / "torch", n, **pool)
        cfg_t = cfg_t.replace(
            model=dataclasses.replace(cfg_t.model, compute_dtype=dtype),
            discriminator=dataclasses.replace(cfg_t.discriminator, compute_dtype=dtype))
        flags = dict(checkpoint_every=1, keep_best=True)
        cfg_t = cfg_t.replace(train=dataclasses.replace(cfg_t.train, **flags))
        j_train = {**dataclasses.asdict(cfg_t.train), "results_dir": str(tmp_path / "jax")}
        cfg_j = JConfig(model=JModelConfig(**shared_fields(cfg_t.model)),
                        discriminator=JDiscriminatorConfig(
                            **dataclasses.asdict(cfg_t.discriminator)),
                        data=JDataConfig(**dataclasses.asdict(cfg_t.data)),
                        pool=JPoolConfig(num_generators=n, **pool),
                        train=JTrainConfig(**j_train))
        trainer_j = JTrainer(cfg_j, use_mesh=False)
        trainer_t = Trainer(cfg_t, device="cpu")
        assert trainer_j.use_stacked == (trainer_t.spool is trainer_t.pool) == (n > 1)
        for m_t, m_j in zip(trainer_t.pool.members, trainer_j.pool.members):
            m_t.state.model.load_state_dict(from_jax_params(jax.device_get(m_j.state.params)))
        trainer_t.d_state.model.load_state_dict(
            discriminator_from_jax_params(jax.device_get(trainer_j.d_state.params)))
        trainer_j.train(*folders)
        trainer_t.train(*folders)
        recs_t = trainer_t.logger.read_records()
        _records_close(recs_t, trainer_j.logger.read_records(), dtype)
        assert sum(m["gan_updates"] for m in recs_t[-1]["pool"]) > 0
        assert sorted(os.listdir(tmp_path / "torch")) == sorted(os.listdir(tmp_path / "jax"))
        for sidecar in ("Training_model.json", "Training-best_model.json"):
            assert ((tmp_path / "torch" / sidecar).read_bytes()
                    == (tmp_path / "jax" / sidecar).read_bytes())
        # the snapshot holds every member and the discriminator
        payload = torch.load(os.path.join(ckpt.latest_ckpt_dir(str(tmp_path / "torch"),
                                                               "Training"), "state.pt"),
                             weights_only=True)
        assert len(payload["generators"]) == n and "discriminator" in payload


def test_sigterm_then_resume_equals_uninterrupted_pool_gan(tmp_path, folders, monkeypatch):
    """N=3, GAN, EMA: a SIGTERM after the first batch of epoch 2,
    then resume, equals the stopped trainer carried on in memory (with the
    scheduler reseeded as the resume reseeds it), bit for bit: every
    member's params, Adam moments and shadows, D, and the pool's records."""
    cfg = _gan_config(tmp_path, 3, p_gan_above=0.6)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, num_epochs=3, ema_decay=0.9,
                                                checkpoint_every=1))
    epoch_of_pipeline = TrainPipeline.epoch
    sent = []

    def sigterm_after_first_batch_of_epoch_1(self, epoch, gen):
        for b, batch in enumerate(epoch_of_pipeline(self, epoch, gen)):
            yield batch
            if epoch == 1 and b == 0 and not sent:
                sent.append(True)
                signal.raise_signal(signal.SIGTERM)

    monkeypatch.setattr(TrainPipeline, "epoch", sigterm_after_first_batch_of_epoch_1)
    stopped = Trainer(cfg, device="cpu")
    out = stopped.train(*folders)
    monkeypatch.undo()
    assert out["interrupted"] and out["interrupted_after_batches"] == 1

    resumed = Trainer(cfg, device="cpu")
    resumed.train(*folders, resume=True)
    assert [r["epoch"] for r in resumed.logger.read_records()] == [1, 2, 3]

    stopped._stop_requested = False
    stopped.pool.reseed((cfg.train.seed, 1))  # what the resume does
    pipe = TrainPipeline(cfg.data, folders[0], seed=cfg.train.seed, device="cpu")
    try:
        for epoch in (1, 2):
            stopped.train_epoch(pipe, epoch)
            stopped.spool.end_epoch()
    finally:
        pipe.close()
    for a, b in ((resumed, stopped),):
        for sa, sb in zip(a.spool.state, b.spool.state):
            assert sa.count == sb.count
            assert all(torch.equal(x, y) for x, y in zip(
                sa.params + sa.mu + sa.nu + sa.ema_params,
                sb.params + sb.mu + sb.nu + sb.ema_params))
        da, db = a.d_state, b.d_state
        assert da.count == db.count
        assert all(torch.equal(x, y) for x, y in zip(da.params + da.mu + da.nu,
                                                     db.params + db.mu + db.nu))
    assert resumed.spool.snapshot() == stopped.spool.snapshot()
    assert sum(m["gan_updates"] for m in resumed.spool.snapshot()) > 0


def test_cli_gan_pool_run_and_phase_crossing(tmp_path, folders, capsys):
    """``train --gan --num-generators 3`` runs; a pixel run continued with
    ``--continue-training --gan --num-generators 3`` grows the pool 1 → 3
    from a snapshot without a discriminator."""
    train_dir, val_dir = folders
    base = ["train", "--train-dir", train_dir, "--val-dir", val_dir,
            "--batch-size", "2", "--hr-height", "32", "--hr-width", "64",
            "--num-features", "8", "--num-residuals", "1", "--d-stages", "2",
            "--d-features", "8", "--progress", "off", "--device", "cpu",
            "--validate-every", "0"]
    gan = tmp_path / "gan"
    cli.main([*base, "--epochs", "1", "--gan", "--num-generators", "3", "--bf16",
              "--results-dir", str(gan)])
    payload = torch.load(os.path.join(ckpt.latest_ckpt_dir(str(gan), "Training"),
                                      "state.pt"), weights_only=True)
    assert len(payload["generators"]) == 3 and "discriminator" in payload
    assert (gan / "Trainingtraining_loss_curve_0.png").exists()

    two = tmp_path / "two"
    cli.main([*base, "--epochs", "1", "--results-dir", str(two)])
    capsys.readouterr()
    cli.main([*base, "--epochs", "1", "--results-dir", str(two), "--continue-training",
              "--gan", "--num-generators", "3"])
    out = capsys.readouterr().out
    assert "has 1 generator(s); pool wants 3" in out
    assert "Epoch [1/1] Post-Training" in out
    names = set(os.listdir(two))
    assert {"Post-Training_metrics.jsonl", "Post-Training_model.json",
            "Post-Trainingtraining_loss_curve_0.png"} <= names
    payload = torch.load(os.path.join(ckpt.latest_ckpt_dir(str(two), "Post-Training"),
                                      "state.pt"), weights_only=True)
    assert len(payload["generators"]) == 3 and "discriminator" in payload
