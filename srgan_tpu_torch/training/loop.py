"""The training loop for the single-generator pixel phase, the counterpart of
``srgan_tpu/training/loop.py``: ``Trainer`` (``train``, ``train_epoch``,
``compute_score``, ``validate``) and the functional ``train``.

The ``Trainer`` holds a one-member ``GeneratorPool``, as the JAX one does;
the checkpoints and the epoch record are built on it. Loss scalars stay on
the device: every step packs them into one tensor, and the loop fetches
batch k−1's while batch k is already queued on the card (one host fetch per
batch, the JAX loop's lagged drain).

One process drives one device. Not ported yet (each raises, naming its
ROADMAP.md item): pools of more than one generator, the GAN phase and the
perceptual term. Configs that the JAX ``Trainer`` refuses raise the same
``ValueError`` here. ``debug_nans`` checks every drained loss vector and
raises ``FloatingPointError`` at the first non-finite one (JAX turns on
``jax_debug_nans``).
"""

from __future__ import annotations

import math
import os
import signal
import time
from typing import Optional

import numpy as np
import torch

from srgan_tpu_torch.config import Config
from srgan_tpu_torch.data.pipeline import DeviceCacheBudget, TrainPipeline
from srgan_tpu_torch.models.srresnet import init_generator
from srgan_tpu_torch.ops.resize import resize_bilinear
from srgan_tpu_torch.training import checkpoint as ckpt
from srgan_tpu_torch.training.pool import GeneratorPool, PoolMember
from srgan_tpu_torch.training.steps import (
    PACKED_KEYS,
    eval_step,
    generator_pixel_step,
    infer_step,
)
from srgan_tpu_torch.training.train_state import TrainState, epoch_lr
from srgan_tpu_torch.utils.logging import MetricsLogger, ProgressLine, Throughput
from srgan_tpu_torch.utils.platform import disable_tf32, resolve_device
from srgan_tpu_torch.utils.plotting import save_comparison, save_rating_curve

# the epoch record's loss keys, in the JAX loop's order
_SUM_KEYS = ("g_loss", "com_loss", "tv_loss", "g_d_loss", "d_loss", "p_loss")


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
        if cfg.pool.num_generators > 1:
            raise NotImplementedError(
                "num_generators > 1: pools of more than one generator are "
                "not ported yet (ROADMAP.md, queue 1, item 7: generator pool)"
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
        state = TrainState(
            model,
            b1=cfg.train.adam_b1,
            b2=cfg.train.adam_b2,
            ema_decay=cfg.train.ema_decay,
        )
        self.pool = GeneratorPool([PoolMember(state=state)], cfg.pool,
                                  seed=cfg.train.seed)
        self._best_psnr = float("-inf")  # keep_best watermark
        # Preemption flags: the SIGTERM handler installed by train() sets
        # _stop_requested; train_epoch then breaks at the next batch
        # boundary and marks the epoch interrupted. Set here so that
        # train_epoch also runs without train().
        self._stop_requested = False
        self._epoch_interrupted = False
        self.logger = MetricsLogger(cfg.train.results_dir, self._log_prefix())
        self.throughput = Throughput()
        self.history = {"epochs": [], "psnr": [], "ssim": []}

    # ------------------------------------------------------------------ #

    def _log_prefix(self) -> str:
        """Metrics-JSONL prefix: one process, so the run prefix as is (JAX
        suffixes the ranks of other processes)."""
        return self.cfg.train.run_prefix

    def _leader(self, *, serve: bool = False) -> torch.nn.Module:
        """The current best generator. ``serve=True`` prefers the EMA shadow
        when one is trained (validation and scoring read the weights a user
        would serve)."""
        state = self.pool.leader.state
        return state.serve_model if serve else state.model

    def _should_stop(self, batch_idx: int) -> bool:
        """Batch-boundary preemption check: one process reads its own flag
        at every batch."""
        return self._stop_requested

    def train_epoch(self, pipeline: TrainPipeline, epoch: int) -> dict:
        cfg = self.cfg
        g_lr = epoch_lr(cfg.train, cfg.train.lr_generator, epoch)
        gen = _epoch_generator(pipeline.device, cfg.train.seed, epoch)

        sums = dict.fromkeys(_SUM_KEYS, 0.0)
        n_batches = 0
        self.throughput.begin()
        progress = ProgressLine(cfg.train.progress, total=pipeline.steps_per_epoch())

        def drain(packed, batch_idx):
            # one host fetch per batch: the step's packed loss vector
            vals = packed.tolist()
            if cfg.train.debug_nans and not all(map(math.isfinite, vals)):
                raise FloatingPointError(
                    f"debug_nans: non-finite loss in epoch {epoch + 1}, batch "
                    f"{batch_idx + 1}: " + ", ".join(
                        f"{k}={v}" for k, v in zip(PACKED_KEYS, vals))
                )
            for k, v in zip(PACKED_KEYS, vals):
                sums[k] += v
            # the ordering signal is the pixel loss only
            self.pool.record_loss(0, vals[1], used_gan=False)
            progress.update(
                epoch, n_batches, {"g_loss": vals[0]},
                self.throughput.images_per_sec(),
            )

        member = self.pool.leader
        pending: Optional[tuple] = None
        for hr, lr_imgs in pipeline.epoch(epoch, gen):
            if self._should_stop(n_batches):
                # batch-boundary stop: the drain below settles the last step;
                # train() snapshots and --resume restarts this epoch
                self._epoch_interrupted = True
                break
            member.state, metrics = generator_pixel_step(
                member.state, hr, lr_imgs, g_lr
            )
            # batch k is queued before batch k−1's scalars are fetched
            if pending is not None:
                drain(*pending)
            pending = (metrics["packed"], n_batches)
            n_batches += 1
            self.throughput.add(hr.shape[0])
        if pending is not None:
            drain(*pending)
        progress.close()

        avg = {k: (v / max(1, n_batches)) for k, v in sums.items()}
        avg["images_per_sec"] = self.throughput.images_per_sec()
        avg["n_batches"] = n_batches
        return avg

    # ------------------------------------------------------------------ #

    def compute_score(self, val_pipeline: TrainPipeline, epoch: int) -> tuple:
        """Mean PSNR/SSIM over ≤ score_max_batches validation batches
        (``src/train.py:263-294``), scoring the serving weights (the EMA
        shadow when trained)."""
        model = self._leader(serve=True)
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

    def validate(self, val_pipeline: TrainPipeline, epoch: int) -> Optional[str]:
        """One validation batch → [LR↑ | SR | HR] comparison PNG
        (``src/train.py:233-260``), from the serving weights."""
        model = self._leader(serve=True)
        gen = _epoch_generator(val_pipeline.device, self.cfg.train.seed + 1389, epoch)
        for hr, lr_imgs in val_pipeline.epoch(epoch, gen):
            sr = infer_step(model, lr_imgs)
            lr_up = resize_bilinear(lr_imgs, (hr.shape[1], hr.shape[2]))
            return save_comparison(
                lr_up.cpu().numpy(), sr.cpu().numpy(), hr.cpu().numpy(),
                self.cfg.train.results_dir, self.cfg.train.run_prefix, epoch,
            )
        return None

    # ------------------------------------------------------------------ #

    def _save(self, prefix: str, epoch: int, block: bool = True) -> None:
        ckpt.save_checkpoint(
            self.cfg.train.results_dir, prefix, pool=self.pool, epoch=epoch,
            model_config=self.cfg.model, block=block,
        )

    def train(
        self,
        train_folder=None,
        val_folder=None,
        *,
        continue_training: bool = False,
        resume: bool = False,
    ) -> dict:
        """Full run, the ``train_example`` equivalent (``src/train.py:27-139``).
        ``train_folder`` / ``val_folder``: a folder or a dataset object
        (``data.dataset``), by default the config's folders.

        ``continue_training=True`` restores the checkpoint and enters the
        fine-tune phase (LR/5, "Post-Training" prefix, ``train.py:51-59``).
        ``resume=True`` continues the SAME run from the last snapshot's
        epoch (pair with ``TrainConfig.checkpoint_every``).
        """
        cfg = self.cfg
        start_epoch = 0
        if continue_training:
            self.pool, saved_epoch = ckpt.restore_checkpoint(
                cfg.train.results_dir, cfg.train.run_prefix, pool=self.pool
            )
            self.pool.reseed((cfg.train.seed, saved_epoch))
            self.cfg = cfg = cfg.replace(train=ckpt.finetune_entry(cfg.train))
            self.logger = MetricsLogger(cfg.train.results_dir, self._log_prefix())
        elif resume:
            self.pool, start_epoch = ckpt.restore_checkpoint(
                cfg.train.results_dir, cfg.train.run_prefix, pool=self.pool
            )
            self.pool.reseed((cfg.train.seed, start_epoch))
            # keep the earlier epochs' records and recover the keep_best
            # watermark from them; NaN psnr records (a diverged epoch, an
            # empty validation set) must not poison it
            self.logger = MetricsLogger(
                cfg.train.results_dir, self._log_prefix(), append=True
            )
            self._best_psnr = max(
                (p for r in self.logger.read_records()
                 if not math.isnan(p := float(r.get("psnr", float("-inf"))))),
                default=float("-inf"),
            )

        # one device-cache budget for both pipelines: train reserves first
        cache_budget = DeviceCacheBudget(cfg.data.device_cache_budget_bytes)
        pipeline = TrainPipeline(
            cfg.data,
            cfg.data.train_dir if train_folder is None else train_folder,
            use_split=True,
            seed=cfg.train.seed, device=self.device, cache_budget=cache_budget,
        )
        val_pipeline = TrainPipeline(
            cfg.data,
            cfg.data.val_dir if val_folder is None else val_folder,
            use_split=False,
            seed=cfg.train.seed + 1, device=self.device,
            cache_budget=cache_budget,
            augment=False,  # scoring sees the images, never flips of them
        )
        os.makedirs(cfg.train.results_dir, exist_ok=True)

        # Preemption: SIGTERM asks for a stop at the next batch boundary;
        # the full state is snapshotted and --resume restarts the
        # interrupted epoch from its beginning (its partial updates kept).
        self._stop_requested = False
        prev_handler = None
        handler_installed = False
        try:
            def _request_stop(signum, frame):
                self._stop_requested = True
                print(
                    "SIGTERM: will checkpoint and stop at the next batch "
                    "boundary", flush=True,
                )

            prev_handler = signal.signal(signal.SIGTERM, _request_stop)
            handler_installed = True
        except ValueError:
            pass  # not the main thread

        last = {}
        try:
            for epoch in range(start_epoch, cfg.train.num_epochs):
                t0 = time.perf_counter()
                self._epoch_interrupted = False
                train_metrics = self.train_epoch(pipeline, epoch)
                if self._epoch_interrupted:
                    # snapshot with epoch=epoch (not epoch+1) so that
                    # --resume restarts the interrupted epoch; no re-sort or
                    # scoring on a partial epoch
                    ckpt.wait_for_checkpoints()
                    self._save(cfg.train.run_prefix, epoch)
                    print(
                        f"stopped mid-epoch {epoch + 1} after "
                        f"{train_metrics['n_batches']} batches; --resume "
                        "restarts this epoch", flush=True,
                    )
                    # the last completed epoch's record, flagged
                    return {
                        **last,
                        "epoch": epoch,
                        "interrupted": True,
                        "interrupted_after_batches": train_metrics["n_batches"],
                    }
                self.pool.end_epoch()

                if (cfg.train.checkpoint_every
                        and (epoch + 1) % cfg.train.checkpoint_every == 0):
                    # non-blocking: the disk write overlaps the next epochs
                    self._save(cfg.train.run_prefix, epoch + 1, block=False)

                if (cfg.train.validate_every > 0
                        and (epoch + 1) % cfg.train.validate_every == 0):
                    self.validate(val_pipeline, epoch)

                psnr, ssim = self.compute_score(val_pipeline, epoch)
                self.history["epochs"].append(epoch + 1)
                self.history["psnr"].append(psnr)
                self.history["ssim"].append(ssim)

                if cfg.train.keep_best and psnr > self._best_psnr:
                    self._best_psnr = psnr
                    self._save(f"{cfg.train.run_prefix}-best", epoch + 1,
                               block=False)

                record = {
                    "epoch": epoch + 1,
                    "psnr": psnr,
                    "ssim": ssim,
                    "wall_s": time.perf_counter() - t0,
                    "pool": self.pool.snapshot(),
                    **train_metrics,
                }
                if self.pool.gan_threshold is not None:
                    # the gate's (possibly auto-calibrated) threshold
                    record["gan_threshold"] = self.pool.gan_threshold
                # cfg.train.reduce_metrics: the cross-process mean is the
                # identity on one process
                self.logger.log(record)
                last = record
                print(
                    f"Epoch [{epoch + 1}/{cfg.train.num_epochs}] "
                    f"{cfg.train.run_prefix} Loss: {train_metrics['g_loss']:.6f} "
                    f"psnr={psnr:.3f} ssim={ssim:.4f} "
                    f"({train_metrics['images_per_sec']:.1f} img/s)"
                )
                # epoch-boundary stop: a SIGTERM after the last batch
                if self._stop_requested:
                    ckpt.wait_for_checkpoints()
                    self._save(cfg.train.run_prefix, epoch + 1)
                    print(
                        f"stopped after epoch {epoch + 1}; resume with "
                        "--resume", flush=True,
                    )
                    return last

            ckpt.wait_for_checkpoints()  # settle in-flight periodic saves
            self._save(cfg.train.run_prefix, cfg.train.num_epochs)
            save_rating_curve(
                self.history["epochs"],
                self.history["psnr"],
                self.history["ssim"],
                cfg.train.results_dir,
                cfg.train.run_prefix,
            )
        finally:
            pipeline.close()
            val_pipeline.close()
            # settle an in-flight snapshot even on failure
            ckpt.wait_for_checkpoints()
            if handler_installed:
                # prev_handler is None when the prior disposition was
                # installed outside Python: fall back to the default
                signal.signal(
                    signal.SIGTERM,
                    prev_handler if prev_handler is not None
                    else signal.SIG_DFL,
                )
        return last


def train(cfg: Config, *, device=None, **kwargs) -> dict:
    """Functional entry point (the ``train_example`` CLI surface); the card
    unless ``device`` says otherwise."""
    return Trainer(cfg, device=device).train(**kwargs)
