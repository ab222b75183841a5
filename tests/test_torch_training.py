"""The port's train state, pixel step, scoring and Trainer against the JAX
package, from the same weights (through the bridge) and the same batches.

Tolerances: losses rel 1e-4; params after K Adam steps atol 2·lr·K, since
Adam moves each weight by about ±lr whatever its gradient's size, so a
gradient near zero whose sign differs in the last bits moves a weight the
other way; the Adam update alone (same gradients) atol 1e-6. In bf16 the
losses rel 2e-2 (the forward's bar, tests/test_torch_models.py) and the
params the same 2·lr·K: the master params are f32 in both packages, and the
Adam bound holds whatever the gradients' rounding.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn
from PIL import Image

from srgan_tpu.config import Config as JConfig
from srgan_tpu.config import DataConfig as JDataConfig
from srgan_tpu.config import ModelConfig as JModelConfig
from srgan_tpu.config import TrainConfig as JTrainConfig
from srgan_tpu.data.pipeline import TrainPipeline as JTrainPipeline
from srgan_tpu.models.srresnet import init_generator as j_init_generator
from srgan_tpu.training import steps as jsteps
from srgan_tpu.training import train_state as jts
from srgan_tpu.training.loop import Trainer as JTrainer
from srgan_tpu_torch.config import Config, DataConfig, ModelConfig, PoolConfig, TrainConfig
from srgan_tpu_torch.data.pipeline import TrainPipeline
from srgan_tpu_torch.models.srresnet import SRResNet
from srgan_tpu_torch.training import steps as tsteps
from srgan_tpu_torch.training import train_state as tts
from srgan_tpu_torch.training.loop import Trainer
from srgan_tpu_torch.training.stacked_pool import stacked_pool_gan_step, stacked_pool_step
from srgan_tpu_torch.utils.params import from_jax_params, to_jax_params

torch.set_num_threads(1)

SMALL = dict(num_features=8, num_residuals=2)


def _sparse_edges(rng, shape):
    """Black images with one small bright square each. With edges this
    sparse the normalized edge map sits below 1 almost everywhere, so the
    TV term relu(mean(|DIFF*sr|·(1−e))) is positive for a rough SR; on
    dense textures it clips to 0 and a test would not see it."""
    b, h, w, c = shape
    k = max(2, h // 8)
    out = np.zeros(shape, np.float32)
    for i in range(b):
        y, x = rng.integers(2, h - k - 2), rng.integers(2, w - k - 2)
        out[i, y:y + k, x:x + k] = rng.uniform(0.5, 1.0, c)
    return out


class _Params(nn.Module):
    def __init__(self, arrays):
        super().__init__()
        self.p = nn.ParameterList(nn.Parameter(torch.from_numpy(a.copy())) for a in arrays)


class TestTrainState:
    def test_adam_and_ema_match_jax(self, rng):
        shapes = [(3, 4), (5,), (2, 2, 3)]
        init = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
                 for _ in range(3)]
        j_state = jts.TrainState.create(
            apply_fn=None, params={str(i): jnp.asarray(a) for i, a in enumerate(init)},
            ema_decay=0.9,
        )
        t_state = tts.TrainState(_Params(init), ema_decay=0.9)
        for k, g in enumerate(grads):
            lr = 1e-2 / (k + 1)
            j_state = j_state.apply_gradients(
                {str(i): jnp.asarray(a) for i, a in enumerate(g)}, lr
            )
            t_state.apply_gradients([torch.from_numpy(a) for a in g], lr)
        for i in range(len(shapes)):
            np.testing.assert_allclose(
                t_state.params[i].detach().numpy(), np.asarray(j_state.params[str(i)]),
                atol=1e-6,
            )
            np.testing.assert_allclose(
                t_state.ema_params[i].numpy(), np.asarray(j_state.ema_params[str(i)]),
                atol=1e-6,
            )
        assert t_state.serve_model is t_state.ema_model

    def test_no_ema_serves_the_model(self):
        state = tts.TrainState(_Params([np.zeros(2, np.float32)]))
        assert state.ema_model is None and state.serve_model is state.model

    @pytest.mark.parametrize("schedule", ["linear", "cosine"])
    def test_lr_schedules_equal_jax(self, schedule):
        cfg_t = TrainConfig(num_epochs=10, lr_schedule=schedule)
        cfg_j = JTrainConfig(num_epochs=10, lr_schedule=schedule)
        for epoch in range(14):
            assert tts.epoch_lr(cfg_t, 1e-4, epoch) == jts.epoch_lr(cfg_j, 1e-4, epoch)


class TestSteps:
    @pytest.mark.parametrize("factor", [2, 4])
    def test_three_pixel_steps_match_jax(self, rng, factor):
        model_j, params = j_init_generator(
            JModelConfig(upscale_factor=factor, **SMALL), jax.random.key(1),
            sample_hw=(8, 16),
        )
        j_state = jts.TrainState.create(apply_fn=model_j.apply, params=params)
        model_t = SRResNet.from_config(ModelConfig(upscale_factor=factor, **SMALL))
        model_t.load_state_dict(from_jax_params(jax.device_get(params)))
        t_state = tts.TrainState(model_t)
        lr, steps = 1e-4, 3
        tv_seen = []
        for _ in range(steps):
            hr = _sparse_edges(rng, (2, 8 * factor, 16 * factor, 3))
            lr_imgs = rng.random((2, 8, 16, 3)).astype(np.float32)
            j_state, m_j = jsteps.generator_pixel_step(
                j_state, jnp.asarray(hr), jnp.asarray(lr_imgs), jnp.float32(lr)
            )
            t_state, m_t = tsteps.generator_pixel_step(
                t_state, torch.from_numpy(hr), torch.from_numpy(lr_imgs), lr
            )
            np.testing.assert_allclose(
                m_t["packed"].numpy(), np.asarray(m_j["packed"]), rtol=1e-4, atol=1e-7
            )
            tv_seen.append(float(m_t["tv_loss"]))
        assert max(tv_seen) > 0.0  # the TV term and its gate took part
        got = to_jax_params(model_t.state_dict())
        want = jax.device_get(j_state.params)
        for path, leaf in jax.tree_util.tree_leaves_with_path(want):
            node = got
            for k in path:
                node = node[k.key]
            np.testing.assert_allclose(node, leaf, atol=2 * lr * steps)

    def test_three_bf16_pixel_steps_match_jax(self, rng):
        cfg = dict(upscale_factor=4, compute_dtype="bfloat16", **SMALL)
        model_j, params = j_init_generator(JModelConfig(**cfg), jax.random.key(1),
                                           sample_hw=(8, 16))
        j_state = jts.TrainState.create(apply_fn=model_j.apply, params=params)
        model_t = SRResNet.from_config(ModelConfig(**cfg))
        model_t.load_state_dict(from_jax_params(jax.device_get(params)))
        t_state = tts.TrainState(model_t)
        lr, steps = 1e-4, 3
        for _ in range(steps):
            hr = _sparse_edges(rng, (2, 32, 64, 3))
            lr_imgs = rng.random((2, 8, 16, 3)).astype(np.float32)
            j_state, m_j = jsteps.generator_pixel_step(
                j_state, jnp.asarray(hr), jnp.asarray(lr_imgs), jnp.float32(lr)
            )
            t_state, m_t = tsteps.generator_pixel_step(
                t_state, torch.from_numpy(hr), torch.from_numpy(lr_imgs), lr
            )
            np.testing.assert_allclose(
                m_t["packed"].numpy(), np.asarray(m_j["packed"]), rtol=2e-2, atol=1e-7
            )
        assert all(p.dtype == torch.float32 for p in t_state.params + t_state.mu)
        got = to_jax_params(model_t.state_dict())
        for path, leaf in jax.tree_util.tree_leaves_with_path(jax.device_get(j_state.params)):
            node = got
            for k in path:
                node = node[k.key]
            np.testing.assert_allclose(node, leaf, atol=2 * lr * steps)

    def test_eval_and_infer_match_jax(self, rng):
        model_j, params = j_init_generator(
            JModelConfig(upscale_factor=2, **SMALL), jax.random.key(2), sample_hw=(8, 16)
        )
        model_t = SRResNet.from_config(ModelConfig(upscale_factor=2, **SMALL))
        model_t.load_state_dict(from_jax_params(jax.device_get(params)))
        hr = rng.random((2, 16, 32, 3)).astype(np.float32)
        lr_imgs = rng.random((2, 8, 16, 3)).astype(np.float32)
        p_j, s_j = jsteps.eval_step(model_j.apply, params, jnp.asarray(hr), jnp.asarray(lr_imgs))
        p_t, s_t = tsteps.eval_step(model_t, torch.from_numpy(hr), torch.from_numpy(lr_imgs))
        assert float(p_t) == pytest.approx(float(p_j), rel=1e-4)
        assert float(s_t) == pytest.approx(float(s_j), abs=1e-4)
        sr = tsteps.infer_step(model_t, torch.from_numpy(lr_imgs))
        assert sr.shape == (2, 16, 32, 3) and not sr.requires_grad

    def test_pack_metrics_layout(self):
        m = {k: torch.tensor(float(i)) for i, k in enumerate(tsteps.PACKED_KEYS)}
        assert tsteps.pack_metrics(m).tolist() == [0.0, 1.0, 2.0, 3.0, 4.0]
        assert tsteps.PACKED_KEYS == jsteps.PACKED_KEYS


class TestLogging:
    def test_metrics_logger_matches_jax(self, tmp_path):
        """A fresh run truncates a crashed attempt's records; a resumed one
        appends. Both packages write the same file."""
        from srgan_tpu.utils.logging import MetricsLogger as JMetricsLogger
        from srgan_tpu_torch.utils.logging import MetricsLogger

        records = [{"epoch": 0, "g_loss": 0.5}, {"epoch": 1, "g_loss": 0.25}]
        texts = []
        for cls, sub in ((JMetricsLogger, "jax"), (MetricsLogger, "torch")):
            results = str(tmp_path / sub)
            cls(results, "Training").log({"epoch": 7})  # the crashed attempt
            log = cls(results, "Training")
            for r in records:
                log.log(r)
            cls(results, "Training", append=True).log({"epoch": 2})
            with open(log.path) as f:
                texts.append(f.read())
        assert texts[0] == texts[1]
        assert log.read_records() == records + [{"epoch": 2}]

    def test_progress_line_and_throughput(self, capsys):
        from srgan_tpu_torch.utils.logging import ProgressLine, Throughput

        tp = Throughput()
        assert tp.images_per_sec() == 0.0
        tp.begin()
        tp.add(12)
        assert tp.images_per_sec() > 0.0
        line = ProgressLine("always", total=3)
        line.update(0, 1, {"g_loss": 0.5}, 2.0)
        line.close()
        assert "epoch 1 [1/3] g_loss=0.5000 (2.0 img/s)" in capsys.readouterr().err
        ProgressLine("off").update(0, 1, {"g_loss": 0.5}, 2.0)
        assert capsys.readouterr().err == ""


class TestTrainer:
    def test_unported_paths_name_roadmap(self, tmp_path):
        """Both are ported: ``member_exec="vmap"`` builds the vmap pool
        executor, with ``remat`` too (each block recomputed outside the
        vmap); the perceptual term builds its extractor."""
        pool = PoolConfig(num_generators=3, member_exec="vmap")
        trainer = Trainer(Config(model=ModelConfig(**SMALL), pool=pool), device="cpu")
        assert trainer.spool is not None
        assert trainer.pool_steps == (stacked_pool_step, stacked_pool_gan_step)
        trainer = Trainer(Config(model=ModelConfig(**SMALL, remat=True), pool=pool),
                          device="cpu")
        assert trainer.spool is not None
        assert trainer.pool_steps == (stacked_pool_step, stacked_pool_gan_step)
        assert all(m.state.model.remat for m in trainer.pool.members)
        cfg = Config(model=ModelConfig(**SMALL),
                     train=TrainConfig(perceptual_weight=0.1, vgg_layers=("conv1_2",),
                                       results_dir=str(tmp_path)))
        with pytest.warns(RuntimeWarning, match="RANDOM feature weights"):
            trainer = Trainer(cfg, device="cpu")
        assert [n for n, _ in trainer.extractor.named_children()] == ["conv_0", "conv_2"]

    @pytest.mark.parametrize("train,field", [
        (dict(stop_sync_every_batches=0), "stop_sync_every_batches"),
        (dict(vgg_weights_npz="vgg19.npz"), "vgg_weights_npz"),
        (dict(perceptual_encoder_npz="encoder.npz"), "perceptual_encoder_npz"),
    ], ids=["stop_sync_0", "vgg_weights_off", "encoder_weights_off"])
    def test_refuses_what_jax_trainer_refuses(self, train, field):
        """Each config the JAX Trainer refuses with ValueError (perceptual
        weights given with perceptual_weight 0 included) the port's refuses
        too, and names the field, before it touches a device."""
        model, data = dict(num_features=8, num_residuals=1), dict(hr_size=(32, 32))
        with pytest.raises(ValueError):
            JTrainer(JConfig(model=JModelConfig(**model), data=JDataConfig(**data),
                             train=JTrainConfig(**train)), use_mesh=False)
        with pytest.raises(ValueError, match=field):
            Trainer(Config(model=ModelConfig(**model), data=DataConfig(**data),
                           train=TrainConfig(**train)), device="cpu")

    def test_debug_nans_names_roadmap(self, tmp_path, rng):
        """debug_nans is ported: a batch made to give a NaN raises
        FloatingPointError naming its epoch and batch; without debug_nans
        the epoch runs through."""
        batches = [rng.random((2, 16, 32, 3)).astype(np.float32) for _ in range(3)]
        batches[1][0, 0, 0, 0] = np.nan  # the LR input of batch 2

        class NaNPipeline:
            device = torch.device("cpu")

            def steps_per_epoch(self):
                return len(batches)

            def epoch(self, epoch, gen):
                for lr_imgs in batches:
                    hr = _sparse_edges(rng, (2, 64, 128, 3))
                    yield torch.from_numpy(hr), torch.from_numpy(lr_imgs)

        for debug_nans in (True, False):
            cfg = Config(model=ModelConfig(upscale_factor=4, **SMALL),
                         train=TrainConfig(debug_nans=debug_nans, progress="off",
                                           results_dir=str(tmp_path)))
            trainer = Trainer(cfg, device="cpu")
            if debug_nans:
                with pytest.raises(FloatingPointError, match="epoch 1, batch 2"):
                    trainer.train_epoch(NaNPipeline(), 0)
            else:
                assert math.isnan(trainer.train_epoch(NaNPipeline(), 0)["g_loss"])

    def test_cuda_by_default_never_quietly_cpu(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        cfg = Config(model=ModelConfig(**SMALL))
        with pytest.raises(RuntimeError, match="CUDA"):
            Trainer(cfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            TrainPipeline(cfg.data, "unused")

    def test_slice_matches_jax_trainer(self, tmp_path, rng):
        """The whole slice on one PNG folder: Trainer.train_epoch then
        compute_score in both packages, the JAX trainer's initial params
        bridged into the port. noise_std_max=0 takes every random draw out;
        the clips are stored at the HR size, so decoding is exact in both."""
        self._slice(tmp_path, rng, "float32", rel=1e-4, ssim_abs=1e-4)

    def test_bf16_slice_matches_jax_trainer(self, tmp_path, rng):
        """The same in bf16: losses and PSNR rel 2e-2, SSIM abs 2e-2."""
        self._slice(tmp_path, rng, "bfloat16", rel=2e-2, ssim_abs=2e-2)

    @staticmethod
    def _slice(tmp_path, rng, compute_dtype, rel, ssim_abs):
        folder = str(tmp_path / "train")
        os.makedirs(folder)
        for i in range(10):
            img = rng.integers(0, 256, (32, 64, 3), dtype=np.uint8)
            Image.fromarray(img).save(os.path.join(folder, f"img_{i:02d}.png"))
        common = dict(
            data=dict(hr_size=(32, 64), upscale_factor=4, batch_size=2,
                      noise_std_max=0.0, num_workers=1),
            train=dict(score_max_batches=2, progress="off",
                       results_dir=str(tmp_path / "results")),
        )
        model = dict(upscale_factor=4, compute_dtype=compute_dtype, **SMALL)
        cfg_j = JConfig(model=JModelConfig(**model),
                        data=JDataConfig(**common["data"]),
                        train=JTrainConfig(**common["train"]))
        cfg_t = Config(model=ModelConfig(**model),
                       data=DataConfig(**common["data"]),
                       train=TrainConfig(**common["train"]))

        trainer_j = JTrainer(cfg_j, use_mesh=False)
        trainer_t = Trainer(cfg_t, device="cpu")
        trainer_t.pool.leader.state.model.load_state_dict(
            from_jax_params(jax.device_get(trainer_j.pool.members[0].state.params))
        )
        pipe_j = JTrainPipeline(cfg_j.data, folder, seed=0)
        val_j = JTrainPipeline(cfg_j.data, folder, use_split=False, seed=1, augment=False)
        pipe_t = TrainPipeline(cfg_t.data, folder, seed=0, device="cpu")
        val_t = TrainPipeline(cfg_t.data, folder, use_split=False, seed=1,
                              augment=False, device="cpu")
        try:
            m_j = trainer_j.train_epoch(pipe_j, 0)
            m_t = trainer_t.train_epoch(pipe_t, 0)
            score_j = trainer_j.compute_score(val_j, 0)
            score_t = trainer_t.compute_score(val_t, 0)
        finally:
            for p in (pipe_j, val_j, pipe_t, val_t):
                p.close()
        assert m_t["n_batches"] == m_j["n_batches"] == 3
        for k in ("g_loss", "com_loss", "tv_loss"):
            assert m_t[k] == pytest.approx(m_j[k], rel=rel), k
        assert score_t[0] == pytest.approx(score_j[0], rel=rel)
        assert score_t[1] == pytest.approx(score_j[1], abs=ssim_abs)
        # the drain feeds the one-member pool, as the JAX loop's does
        for m_jp, m_tp in zip(trainer_j.pool.snapshot(), trainer_t.pool.snapshot()):
            assert m_tp["pixel_updates"] == m_jp["pixel_updates"] == 3
            assert m_tp["running_loss"] == pytest.approx(m_jp["running_loss"], rel=rel)
