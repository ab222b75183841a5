"""The training loop for the single-generator pixel phase, the counterpart
of the ``generator_pixel_step`` path of ``srgan_tpu/training/loop.py``
(``Trainer.__init__``, ``train_epoch`` and ``compute_score``).

Loss scalars stay on the device: every step packs them into one tensor,
and the loop fetches batch k−1's while batch k is already queued on the
card (one host fetch per batch, the JAX loop's lagged drain).

Not ported yet (each raises or is absent, with its ROADMAP.md item):
generator pools, the GAN phase, the perceptual term, checkpoints,
``validate``, ``train()``, ``debug_nans`` and the CLI. Configs that the JAX
``Trainer`` refuses raise the same ``ValueError`` here.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from srgan_tpu_torch.config import Config
from srgan_tpu_torch.data.pipeline import TrainPipeline
from srgan_tpu_torch.models.srresnet import init_generator
from srgan_tpu_torch.training.steps import eval_step, generator_pixel_step
from srgan_tpu_torch.training.train_state import TrainState, epoch_lr
from srgan_tpu_torch.utils.logging import ProgressLine, Throughput
from srgan_tpu_torch.utils.platform import disable_tf32, resolve_device

_SUM_KEYS = ("g_loss", "com_loss", "tv_loss", "g_d_loss", "p_loss")


def _epoch_generator(device: torch.device, seed: int, epoch: int) -> torch.Generator:
    """A generator for one epoch's draws, seeded from (seed, epoch)."""
    mixed = int(np.random.SeedSequence((seed, epoch)).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(mixed)


class Trainer:
    def __init__(self, cfg: Config, device=None):
        # the JAX Trainer's refusals, before any device work
        if cfg.train.stop_sync_every_batches < 1:
            raise ValueError(
                "TrainConfig.stop_sync_every_batches must be >= 1 (it is a "
                "batch modulus; multi-process runs sync the preemption stop "
                f"at every Nth boundary), got {cfg.train.stop_sync_every_batches}"
            )
        if cfg.train.perceptual_weight <= 0.0 and (
            cfg.train.perceptual_encoder_npz or cfg.train.vgg_weights_npz
        ):
            # a feature prior given with the objective off would be dropped
            # silently: fail loudly instead
            raise ValueError(
                "TrainConfig.perceptual_encoder_npz / vgg_weights_npz were "
                "given but TrainConfig.perceptual_weight is 0 (off): set "
                "perceptual_weight > 0 to enable the objective, or drop the "
                "weights"
            )
        if cfg.train.debug_nans:
            raise NotImplementedError(
                "debug_nans: no NaN check is ported yet (ROADMAP.md, queue 1: "
                "Trainer.train and the CLI)"
            )
        if cfg.pool.num_generators > 1:
            raise NotImplementedError(
                "num_generators > 1: the generator pool is not ported yet "
                "(ROADMAP.md, queue 1: generator pool)"
            )
        if cfg.train.use_gan:
            raise NotImplementedError(
                "use_gan: the GAN phase is not ported yet (ROADMAP.md, "
                "queue 1: GAN path)"
            )
        if cfg.train.perceptual_weight > 0.0:
            raise NotImplementedError(
                "perceptual_weight > 0: the perceptual prior is not ported "
                "yet (ROADMAP.md, queue 1: perceptual prior)"
            )
        self.cfg = cfg
        self.device = resolve_device(device)
        # compute_dtype "float32" is full fp32: cuDNN convs default to TF32
        disable_tf32()
        model = init_generator(cfg.model, seed=cfg.train.seed, device=self.device)
        self.state = TrainState(
            model,
            b1=cfg.train.adam_b1,
            b2=cfg.train.adam_b2,
            ema_decay=cfg.train.ema_decay,
        )
        self.throughput = Throughput()

    def train_epoch(self, pipeline: TrainPipeline, epoch: int) -> dict:
        cfg = self.cfg
        g_lr = epoch_lr(cfg.train, cfg.train.lr_generator, epoch)
        gen = _epoch_generator(pipeline.device, cfg.train.seed, epoch)

        sums = dict.fromkeys(_SUM_KEYS + ("d_loss",), 0.0)
        n_batches = 0
        self.throughput.begin()
        progress = ProgressLine(cfg.train.progress, total=pipeline.steps_per_epoch())

        def drain(packed):
            # one host fetch per batch: the step's packed loss vector
            vals = packed.tolist()
            for k, v in zip(_SUM_KEYS, vals):
                sums[k] += v
            progress.update(
                epoch, n_batches, {"g_loss": vals[0]},
                self.throughput.images_per_sec(),
            )

        pending: Optional[torch.Tensor] = None
        for hr, lr_imgs in pipeline.epoch(epoch, gen):
            self.state, metrics = generator_pixel_step(self.state, hr, lr_imgs, g_lr)
            # batch k is queued before batch k−1's scalars are fetched
            if pending is not None:
                drain(pending)
            pending = metrics["packed"]
            n_batches += 1
            self.throughput.add(hr.shape[0])
        if pending is not None:
            drain(pending)
        progress.close()

        avg = {k: (v / max(1, n_batches)) for k, v in sums.items()}
        avg["images_per_sec"] = self.throughput.images_per_sec()
        avg["n_batches"] = n_batches
        return avg

    def compute_score(self, val_pipeline: TrainPipeline, epoch: int) -> tuple:
        """Mean PSNR/SSIM over ≤ score_max_batches validation batches
        (``src/train.py:263-294``), scoring the serving weights (the EMA
        shadow when trained)."""
        model = self.state.serve_model
        gen = _epoch_generator(val_pipeline.device, self.cfg.train.seed + 977, epoch)
        psnrs, ssims = [], []
        for b, (hr, lr_imgs) in enumerate(val_pipeline.epoch(epoch, gen)):
            if b >= self.cfg.train.score_max_batches:
                break
            p, s = eval_step(model, hr, lr_imgs)
            psnrs.append(p)
            ssims.append(s)
        if not psnrs:
            return float("nan"), float("nan")
        return (float(torch.stack(psnrs).mean()),
                float(torch.stack(ssims).mean()))
