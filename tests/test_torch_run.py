"""The port's ``train`` entry point against the JAX package's: a whole
``Trainer.train`` run on one PNG folder in both packages, the SIGTERM stop
and ``resume``, ``continue_training``, the keep_best watermark, and the
``train`` CLI.

Tolerances: losses and PSNR rel 1e-4 in both epochs (as the slice test).
Measured on the CPU: epoch 1 at most 4.0e-6 (tv_loss), epoch 2 at most
4.4e-6 (psnr). Epoch 2 starts from weights that differ by the last bits,
and Adam moves a weight whose gradient is near zero by about ±lr whichever
way its sign falls, so its bar is not tighter than epoch 1's.
"""

import json
import os
import signal

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from srgan_tpu.cli import _add_train as j_add_train
from srgan_tpu.config import Config as JConfig
from srgan_tpu.config import DataConfig as JDataConfig
from srgan_tpu.config import ModelConfig as JModelConfig
from srgan_tpu.config import TrainConfig as JTrainConfig
from srgan_tpu.training.loop import Trainer as JTrainer
from srgan_tpu_torch import cli
from srgan_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from srgan_tpu_torch.data.pipeline import TrainPipeline
from srgan_tpu_torch.training import checkpoint as ckpt
from srgan_tpu_torch.training.loop import Trainer
from srgan_tpu_torch.utils.params import from_jax_params

torch.set_num_threads(1)

SMALL = dict(num_features=8, num_residuals=2, upscale_factor=4)
HR = (32, 64)


def _folder(path, n, seed):
    os.makedirs(path)
    rng = np.random.default_rng(seed)
    for i in range(n):
        img = rng.integers(0, 256, HR + (3,), dtype=np.uint8)
        Image.fromarray(img).save(os.path.join(path, f"img_{i:02d}.png"))
    return str(path)


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    # 10 clips: the 0.7 split keeps 7, so 3 steps of 2 an epoch
    return _folder(root / "train", 10, 0), _folder(root / "val", 4, 1)


def _kw(results, **train):
    return dict(
        data=dict(hr_size=HR, upscale_factor=4, batch_size=2,
                  noise_std_max=0.0, num_workers=1),
        train={"num_epochs": 2, "score_max_batches": 2, "progress": "off",
               "results_dir": str(results), **train},
    )


def _config(results, model=None, **train):
    kw = _kw(results, **train)
    return Config(model=ModelConfig(**(model or SMALL)),
                  data=DataConfig(**kw["data"]), train=TrainConfig(**kw["train"]))


def _state(trainer):
    st = trainer.pool.leader.state
    return [*st.params, *st.mu, *st.nu, *st.ema_params], st.count


def _assert_states_equal(a, b):
    (ta, ca), (tb, cb) = _state(a), _state(b)
    assert ca == cb
    assert len(ta) == len(tb)
    assert all(torch.equal(x, y) for x, y in zip(ta, tb))


def test_train_matches_jax_trainer(tmp_path, folders):
    """Trainer.train against the JAX Trainer.train, 2 epochs with
    checkpoint_every=1, keep_best and validate_every=1: the same JSONL keys,
    losses and PSNR, the same artifact names, byte-equal sidecars."""
    train_dir, val_dir = folders
    flags = dict(validate_every=1, checkpoint_every=1, keep_best=True)
    kw = _kw(tmp_path / "jax", **flags)
    cfg_j = JConfig(model=JModelConfig(**SMALL), data=JDataConfig(**kw["data"]),
                    train=JTrainConfig(**kw["train"]))
    cfg_t = _config(tmp_path / "torch", **flags)
    trainer_j = JTrainer(cfg_j, use_mesh=False)
    trainer_t = Trainer(cfg_t, device="cpu")
    trainer_t.pool.leader.state.model.load_state_dict(
        from_jax_params(jax.device_get(trainer_j.pool.members[0].state.params))
    )
    last_j = trainer_j.train(train_dir, val_dir)
    last_t = trainer_t.train(train_dir, val_dir)
    assert last_t.keys() == last_j.keys()

    recs_j = trainer_j.logger.read_records()
    recs_t = trainer_t.logger.read_records()
    assert [r["epoch"] for r in recs_t] == [r["epoch"] for r in recs_j] == [1, 2]
    for r_t, r_j in zip(recs_t, recs_j):
        assert r_t.keys() == r_j.keys()
        assert r_t["pool"][0].keys() == r_j["pool"][0].keys()
        assert r_t["n_batches"] == r_j["n_batches"] == 3
        assert r_t["pool"][0]["pixel_updates"] == r_j["pool"][0]["pixel_updates"]
        for k in ("g_loss", "com_loss", "tv_loss", "psnr"):
            assert r_t[k] == pytest.approx(r_j[k], rel=1e-4), (r_t["epoch"], k)
        assert r_t["ssim"] == pytest.approx(r_j["ssim"], abs=1e-4)
        assert r_t["gan_threshold"] == pytest.approx(r_j["gan_threshold"], rel=1e-4)

    names_j = sorted(os.listdir(tmp_path / "jax"))
    names_t = sorted(os.listdir(tmp_path / "torch"))
    assert names_t == names_j
    for sidecar in ("Training_model.json", "Training-best_model.json"):
        assert ((tmp_path / "torch" / sidecar).read_bytes()
                == (tmp_path / "jax" / sidecar).read_bytes())


def test_sigterm_then_resume_equals_uninterrupted(tmp_path, folders, monkeypatch):
    """A SIGTERM after the first batch of epoch 2 snapshots at the batch
    boundary; a new Trainer with resume=True restarts that epoch and runs to
    the end. Its params, Adam moments, EMA shadows and counters equal, bit
    for bit, those of the stopped trainer carried on in memory."""
    train_dir, val_dir = folders
    cfg = _config(tmp_path, num_epochs=3, ema_decay=0.9, checkpoint_every=1,
                  validate_every=0)
    epoch_of_pipeline = TrainPipeline.epoch
    sent = []

    def sigterm_after_first_batch_of_epoch_1(self, epoch, gen):
        for b, batch in enumerate(epoch_of_pipeline(self, epoch, gen)):
            yield batch
            # the training pipeline's epoch 1 runs before any other epoch 1
            if epoch == 1 and b == 0 and not sent:
                sent.append(True)
                signal.raise_signal(signal.SIGTERM)

    monkeypatch.setattr(TrainPipeline, "epoch", sigterm_after_first_batch_of_epoch_1)
    handler = signal.getsignal(signal.SIGTERM)
    stopped = Trainer(cfg, device="cpu")
    out = stopped.train(train_dir, val_dir)
    monkeypatch.undo()
    assert out["interrupted"] and out["epoch"] == 1
    assert out["interrupted_after_batches"] == 1
    assert signal.getsignal(signal.SIGTERM) == handler  # restored
    # the blocking snapshot took the slot after the periodic one, then
    # removed it
    assert ckpt.latest_ckpt_dir(str(tmp_path), "Training").endswith("Training_ckpt@1.1")
    assert [r["epoch"] for r in stopped.logger.read_records()] == [1]

    resumed = Trainer(cfg, device="cpu")
    resumed.train(train_dir, val_dir, resume=True)
    assert [r["epoch"] for r in resumed.logger.read_records()] == [1, 2, 3]
    # the scheduler's RNG was reseeded with the resume epoch folded in (a
    # pixel-phase run draws nothing from it)
    reseeded = np.random.default_rng((cfg.train.seed, 1))
    assert resumed.pool._rng.random(4).tolist() == reseeded.random(4).tolist()

    # the stopped trainer carried on in memory: epoch 2 from its start,
    # then epoch 3, with the pool's epoch ends between
    stopped._stop_requested = False
    pipe = TrainPipeline(cfg.data, train_dir, seed=cfg.train.seed, device="cpu")
    try:
        for epoch in (1, 2):
            stopped.train_epoch(pipe, epoch)
            stopped.pool.end_epoch()
    finally:
        pipe.close()
    _assert_states_equal(resumed, stopped)
    assert resumed.pool.snapshot() == stopped.pool.snapshot()


def test_continue_training_and_watermark(tmp_path, folders, capsys):
    """continue_training restores, divides the LR by 5 and writes under the
    "Post-Training" prefix; resume reads the keep_best watermark from the
    JSONL, skipping NaN records."""
    train_dir, val_dir = folders
    cfg = _config(tmp_path, num_epochs=1, checkpoint_every=1, validate_every=0)
    first = Trainer(cfg, device="cpu")
    first.train(train_dir, val_dir)

    fine = Trainer(cfg, device="cpu")
    fine.train(train_dir, val_dir, continue_training=True)
    assert fine.cfg.train.lr_generator == pytest.approx(cfg.train.lr_generator / 5)
    assert fine.cfg.train.run_prefix == "Post-Training"
    assert os.path.exists(tmp_path / "Post-Training_metrics.jsonl")
    assert ckpt.latest_ckpt_dir(str(tmp_path), "Post-Training") is not None

    log = tmp_path / "Training_metrics.jsonl"
    rec = json.loads(log.read_text().splitlines()[0])
    log.write_text(json.dumps({**rec, "psnr": float("nan")}) + "\n"
                   + json.dumps({**rec, "psnr": 7.5}) + "\n")
    resumed = Trainer(cfg, device="cpu")
    resumed.train(train_dir, val_dir, resume=True)  # no epoch left to run
    assert resumed._best_psnr == 7.5


class TrainerBuilt(Exception):
    """Raised by ``spy_trainer``'s Trainer for a vmap pool: the CLI handed
    the config on."""


def spy_trainer(monkeypatch):
    """The CLI's Trainer, stopped where the config asks for the vmap pool
    executor (the message names ``member_exec``); every other config builds
    the real one."""
    from srgan_tpu_torch.training import loop

    real = loop.Trainer

    def build(cfg, device=None):
        if cfg.pool.member_exec == "vmap":
            raise TrainerBuilt(f"member_exec={cfg.pool.member_exec!r}")
        return real(cfg, device=device)

    monkeypatch.setattr(loop, "Trainer", build)


class TestCLI:
    @staticmethod
    def _train_actions(add_train):
        import argparse

        parser = argparse.ArgumentParser()
        add_train(parser.add_subparsers(dest="cmd"))
        sub = next(a for a in parser._actions
                   if isinstance(a, argparse._SubParsersAction))
        return {a.dest: (tuple(a.option_strings), a.default)
                for a in sub.choices["train"]._actions if a.dest != "help"}

    def test_train_flags_are_jax_flags_plus_device(self):
        """The JAX CLI's train flags and defaults, plus ``--device`` and the
        port's own architecture flags (SwinIR's, at defaults that build
        SRResNet)."""
        port = self._train_actions(cli._add_train)
        jax_flags = self._train_actions(j_add_train)
        assert port.pop("device") == (("--device",), "cuda")
        own = {k: port.pop(k) for k in ("arch", "embed_dim", "depths", "heads", "window",
                                        "mlp_ratio")}
        assert own == {"arch": (("--arch",), "srresnet"), "embed_dim": (("--embed-dim",), 180),
                       "depths": (("--depths",), (6,) * 6), "heads": (("--heads",), (6,) * 6),
                       "window": (("--window",), 8), "mlp_ratio": (("--mlp-ratio",), 2.0)}
        assert port == jax_flags

    def test_config_mapping_matches_jax_cli(self, tmp_path):
        """The flags reach the same Config fields as in the JAX CLI."""
        args = cli.build_parser().parse_args([
            "train", "--bf16", "--epochs", "3", "--batch-size", "4",
            "--hr-height", "64", "--hr-width", "96", "--upscale", "2",
            "--num-features", "16", "--num-residuals", "3", "--remat",
            "--ema-decay", "0.99", "--keep-best", "--checkpoint-every", "2",
            "--augment", "--noise-std-max", "0.01", "--lr-schedule", "cosine",
            "--prefix", "Run", "--results-dir", str(tmp_path), "--seed", "5",
        ])
        cfg = cli.config_from_args(args)
        assert cfg.model == ModelConfig(upscale_factor=2, num_features=16,
                                        num_residuals=3, remat=True,
                                        compute_dtype="bfloat16")
        assert cfg.discriminator.compute_dtype == "bfloat16"
        assert cfg.data.hr_size == (64, 96) and cfg.data.batch_size == 4
        assert cfg.data.augment_flips and cfg.data.noise_std_max == 0.01
        assert (cfg.train.num_epochs, cfg.train.ema_decay, cfg.train.seed) == (3, 0.99, 5)
        assert cfg.train.keep_best and cfg.train.checkpoint_every == 2
        assert cfg.train.lr_schedule == "cosine" and cfg.train.run_prefix == "Run"

    def test_main_runs_a_tiny_job(self, tmp_path, folders, capsys):
        train_dir, val_dir = folders
        results = tmp_path / "results"
        cli.main([
            "train", "--train-dir", train_dir, "--val-dir", val_dir,
            "--epochs", "1", "--batch-size", "2", "--hr-height", "32",
            "--hr-width", "64", "--num-features", "8", "--num-residuals", "1",
            "--validate-every", "1", "--results-dir", str(results),
            "--progress", "off", "--bf16", "--device", "cpu",
        ])
        assert "Epoch [1/1] Training" in capsys.readouterr().out
        names = set(os.listdir(results))
        assert {"Training_ckpt@1", "Training_model.json", "Training_metrics.jsonl",
                "Training_epoch_1_0_comparison.png",
                "Trainingtraining_loss_curve_0.png"} <= names
        assert ckpt.load_model_config(str(results), "Training").compute_dtype == "bfloat16"

    @pytest.mark.parametrize("flag,exc,item", [
        (["--profile-dir", "trace", "--perceptual-encoder", "e.npz"], ValueError,
         "perceptual_weight"),
        (["--multihost"], RuntimeError, "MASTER_ADDR"),
        (["--pool-exec", "vmap"], TrainerBuilt, "member_exec='vmap'"),
        (["--perceptual-encoder", "e.npz"], ValueError, "perceptual_weight"),
    ], ids=["profile_dir", "multihost", "pool_exec_vmap", "perceptual"])
    def test_unported_flags_name_roadmap(self, tmp_path, flag, exc, item, monkeypatch):
        """Every flag is ported. --pool-exec vmap reaches the Trainer as
        ``PoolConfig.member_exec="vmap"`` (``spy_trainer`` stops the run
        there). --profile-dir is ported: the run goes on to the Trainer, which
        refuses a feature prior given with --perceptual 0 (the JAX CLI's
        ValueError), as it does without the flag; --multihost is ported and
        names torchrun's variables where they are missing (the trace and a
        2-process run: ``tests/test_torch_parallel.py``,
        ``tests/test_torch_multiprocess.py``)."""
        from srgan_tpu_torch.parallel.mesh import ENV_VARS

        for var in ENV_VARS:
            monkeypatch.delenv(var, raising=False)
        spy_trainer(monkeypatch)
        with pytest.raises(exc, match=item):
            cli.main(["train", "--results-dir", str(tmp_path), "--device", "cpu",
                      *flag])
