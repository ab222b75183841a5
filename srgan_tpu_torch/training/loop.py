"""The training loop, the counterpart of ``srgan_tpu/training/loop.py``:
``Trainer`` (``train``, ``train_epoch``, ``compute_score``, ``validate``)
and the functional ``train``, for one generator or a pool of them, in the
pixel phase or the GAN phase.

The ``Trainer`` holds a ``GeneratorPool`` of N members, as the JAX one
does; the checkpoints and the epoch record are built on it. A pool of more
than one member runs the stacked pool (``training/stacked_pool.py``, the
scan executor) unless ``PoolConfig.stacked`` is off, which runs the member
list; the stacked state is mirrored back into the list pool before every
snapshot. With ``use_gan`` the Trainer also holds the shared
discriminator and its ``TrainState`` (Adam, no EMA). With
``perceptual_weight > 0`` it holds the frozen perceptual extractor, which
every generator step is given: the trained contrastive encoder of
``perceptual_encoder_npz``, else VGG19 at ``vgg_layers`` (weights from
``vgg_weights_npz``, the torchvision cache, or random with a warning).

Loss scalars stay on the device: every batch packs them into one tensor,
and the loop fetches batch k−1's while batch k is already queued on the
card (one host fetch per batch, the JAX loop's lagged drain).

One process drives one device. Where the process has joined a group
(``parallel.mesh.initialize_multihost``, ``train --multihost``) the run is
data-parallel over its ranks, as JAX's ``Trainer`` is over a mesh:

  - each rank trains on its shard of every epoch (``EpochSampler``) and
    draws the degradation for the global batch, keeping its rows;
  - the reconstruction loss is the global batch's (its totals summed over
    the ranks), every gradient is averaged before the in-place Adam step,
    and the packed loss scalars are averaged, so the pool's sort, its GAN
    gate and the discriminator's target read the same numbers on every
    rank (``TrainState.group``, ``training/steps.py``);
  - a SIGTERM on any rank stops every rank at the same batch boundary
    (checked collectively every ``stop_sync_every_batches``) or epoch end;
  - validation scores are the global mean (every rank's batch scores,
    gathered in rank order), so ``keep_best`` and the snapshots agree on
    every rank;
  - rank 0 alone writes checkpoints and sidecars into the shared results
    dir, and a barrier follows each blocking save; every rank reads on
    resume; each rank logs its own metrics JSONL (rank-suffixed after rank
    0), averaged across ranks with ``reduce_metrics``.

Configs that the JAX ``Trainer`` refuses raise the same ``ValueError``
here. ``debug_nans`` checks every drained loss vector and raises
``FloatingPointError`` at the first non-finite one (JAX turns on
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
from srgan_tpu_torch.models.discriminator import init_discriminator
from srgan_tpu_torch.models.encoder import init_encoder_extractor
from srgan_tpu_torch.models.srresnet import init_generator
from srgan_tpu_torch.models.vgg import init_vgg_extractor
from srgan_tpu_torch.ops.resize import resize_bilinear
from srgan_tpu_torch.parallel import mesh
from srgan_tpu_torch.training import checkpoint as ckpt
from srgan_tpu_torch.training.pool import GeneratorPool, PoolMember
from srgan_tpu_torch.training.stacked_pool import (
    StackedGeneratorPool,
    scanned_pool_gan_step,
    scanned_pool_step,
    stacked_pool_gan_step,
    stacked_pool_step,
)
from srgan_tpu_torch.training.steps import (
    PACKED_KEYS,
    discriminator_step_on_sr,
    eval_step,
    gan_train_step,
    generator_gan_step,
    generator_pixel_step,
    infer_step,
)
from srgan_tpu_torch.training.train_state import TrainState, epoch_lr
from srgan_tpu_torch.utils.logging import MetricsLogger, ProgressLine, Throughput
from srgan_tpu_torch.utils.platform import (
    disable_tf32,
    make_deterministic,
    resolve_device,
)
from srgan_tpu_torch.utils.plotting import save_comparison, save_rating_curve

# the epoch record's loss keys, in the JAX loop's order
_SUM_KEYS = ("g_loss", "com_loss", "tv_loss", "g_d_loss", "d_loss", "p_loss")


def _mix(seed: int, k: int) -> int:
    """One int seed from (seed, k)."""
    return int(np.random.SeedSequence((seed, k)).generate_state(1)[0])


def _epoch_generator(device: torch.device, seed: int, epoch: int) -> torch.Generator:
    """A generator for one epoch's draws, seeded from (seed, epoch)."""
    return torch.Generator(device=device).manual_seed(_mix(seed, epoch))


def _packed_names(n_members: int, has_d: bool) -> list:
    """The names of a stacked batch's packed values: (5, N) in PACKED_KEYS
    order, then d_loss."""
    names = [f"{k}[{i}]" for k in PACKED_KEYS for i in range(n_members)]
    return names + ["d_loss"] if has_d else names


class Trainer:
    def __init__(self, cfg: Config, device=None):
        """``device``: the card by default. The process group, where the
        process has joined one, is the world group (``--multihost``)."""
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
        n = cfg.pool.num_generators
        # pools of more than one member run the stacked pool by default
        self.use_stacked = cfg.pool.stacked and n > 1
        if self.use_stacked and cfg.pool.member_exec not in ("vmap", "scan"):
            raise ValueError(
                f"PoolConfig.member_exec must be 'vmap' or 'scan', got "
                f"{cfg.pool.member_exec!r}"
            )
        if self.use_stacked and cfg.pool.member_exec == "vmap" and cfg.model.remat:
            # JAX remats inside its vmap; torch.utils.checkpoint recomputes
            # outside torch.func.vmap, where its saved inputs are gone
            raise ValueError(
                "PoolConfig.member_exec='vmap' cannot run ModelConfig.remat: "
                "torch.utils.checkpoint does not recompute under torch.func."
                "vmap; 'scan' computes the same updates with one member's "
                "activations alive at a time"
            )
        # the stacked pool's executor: the member loop, or the vmap region
        self.pool_steps = (
            (stacked_pool_step, stacked_pool_gan_step)
            if cfg.pool.member_exec == "vmap"
            else (scanned_pool_step, scanned_pool_gan_step)
        )
        self.cfg = cfg
        self.device = resolve_device(device)
        self.group = mesh.default_group()
        self._n_processes, self._rank = mesh.process_shard_info(self.group)
        # compute_dtype "float32" is full fp32: cuDNN convs default to TF32;
        # and a run's numbers depend on its command only
        disable_tf32()
        make_deterministic()
        # member i's weights from (seed, i), D's from (seed, N + 1), as JAX
        # splits its key into N + 2 and gives D the last
        members = []
        for i in range(n):
            model = init_generator(cfg.model, seed=_mix(cfg.train.seed, i),
                                   device=self.device)
            members.append(PoolMember(state=TrainState(
                model,
                b1=cfg.train.adam_b1,
                b2=cfg.train.adam_b2,
                ema_decay=cfg.train.ema_decay,
            )))
        self.pool = GeneratorPool(members, cfg.pool, seed=cfg.train.seed)
        self.d_state: Optional[TrainState] = None
        if cfg.train.use_gan:
            d_model = init_discriminator(
                cfg.discriminator, seed=_mix(cfg.train.seed, n + 1),
                device=self.device, sample_hw=cfg.data.hr_size,
            )
            self.d_state = TrainState(d_model, b1=cfg.train.adam_b1,
                                      b2=cfg.train.adam_b2)
        # the frozen perceptual extractor (opt-in; the reference builds its
        # VGG at ``train.py:49`` and ships the loss off): the trained
        # encoder when given, else VGG19, its random weights from
        # (seed, N) as JAX gives it the key before D's
        self.extractor = None
        if cfg.train.perceptual_weight > 0.0:
            if cfg.train.perceptual_encoder_npz:
                self.extractor = init_encoder_extractor(
                    cfg.train.perceptual_encoder_npz, device=self.device)
            else:
                self.extractor = init_vgg_extractor(
                    _mix(cfg.train.seed, n), layers=tuple(cfg.train.vgg_layers),
                    weights_npz=cfg.train.vgg_weights_npz, device=self.device)
        self._attach_group()
        self.spool: Optional[StackedGeneratorPool] = None
        if self.use_stacked:
            self.spool = StackedGeneratorPool.create(
                [m.state for m in members], cfg.pool, seed=cfg.train.seed
            )
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
        """Metrics-JSONL prefix: plain on rank 0, rank-suffixed elsewhere
        (the reference's per-rank curves, ``src/train.py:123-137``, without
        two processes writing one file)."""
        prefix = self.cfg.train.run_prefix
        return prefix if self._rank == 0 else f"{prefix}_rank{self._rank}"

    def _attach_group(self) -> None:
        """Give every state the process group (their gradient all-reduce)
        and start every rank from rank 0's weights: the same seeds make
        them equal already, the broadcast makes sure."""
        states = [m.state for m in self.pool.members]
        if self.d_state is not None:
            states.append(self.d_state)
        for st in states:
            st.group = self.group
            mesh.replicate(st.model, self.group)
            if st.ema_model is not None:
                mesh.replicate(st.ema_model, self.group)

    def _leader(self, *, serve: bool = False) -> torch.nn.Module:
        """The current best generator. ``serve=True`` prefers the EMA shadow
        when one is trained (validation and scoring read the weights a user
        would serve)."""
        if self.spool is not None:
            state = self.spool.state[0]
        else:
            state = self.pool.leader.state
        return state.serve_model if serve else state.model

    def _sync_pool_from_stacked(self) -> None:
        """Mirror the stacked pool into the member list (the checkpoint
        format): its states in pool order and its bookkeeping."""
        if self.spool is None:
            return
        for m, s, meta in zip(self.pool.members, self.spool.state,
                              self.spool.snapshot()):
            m.state = s
            m.running_loss = meta["running_loss"]
            m.pre_loss = meta["pre_loss"]
            m.gan_updates = meta["gan_updates"]
            m.pixel_updates = meta["pixel_updates"]
        self.pool.gan_threshold = self.spool.gan_threshold

    def _rebuild_stacked_from_pool(self, start_epoch: int = 0) -> None:
        """Rebuild the stacked pool after a restore, with all of the pool's
        bookkeeping, and the scheduler reseeded from (seed, start_epoch) so
        that its draws do not replay the run's start."""
        if self.spool is None:
            return
        members = self.pool.members
        self.spool = StackedGeneratorPool.create(
            [m.state for m in members], self.cfg.pool,
            seed=(self.cfg.train.seed, start_epoch),
        )
        self.spool.running_loss = np.asarray([m.running_loss for m in members])
        self.spool.pre_loss = np.asarray([m.pre_loss for m in members])
        self.spool.gan_updates = np.asarray([m.gan_updates for m in members], np.int64)
        self.spool.pixel_updates = np.asarray([m.pixel_updates for m in members],
                                              np.int64)
        self.spool.gan_threshold = self.pool.gan_threshold

    def _should_stop(self, batch_idx: int) -> bool:
        """Batch-boundary preemption check. One process reads its own flag
        at every batch. Across processes the decision is collective (a rank
        leaving the loop of collective steps alone would leave the others
        blocked in the next step): the ranks OR their flags every
        ``stop_sync_every_batches``-th boundary, all at the same ones, and
        stop together or not at all."""
        if self._n_processes == 1:
            return self._stop_requested
        if batch_idx % self.cfg.train.stop_sync_every_batches:
            return False
        return mesh.any_process_flag(self._stop_requested, self.group)

    def _check_finite(self, vals, names, epoch: int, batch_idx: int) -> None:
        if self.cfg.train.debug_nans and not all(map(math.isfinite, vals)):
            raise FloatingPointError(
                f"debug_nans: non-finite loss in epoch {epoch + 1}, batch "
                f"{batch_idx + 1}: " + ", ".join(
                    f"{k}={v}" for k, v in zip(names, vals))
            )

    def _d_target(self, batch_idx: int) -> int:
        """The member whose SR the discriminator trains on this batch
        (``PoolConfig.d_train_target``): the leader, or each in turn."""
        if self.cfg.pool.d_train_target == "round_robin":
            return batch_idx % len(self.pool.members)
        return 0

    def _train_epoch_stacked(self, pipeline: TrainPipeline, epoch: int) -> dict:
        """One epoch of the stacked pool: every member updates on every
        batch through the executor ``PoolConfig.member_exec`` names (the
        member loop, or all members in one vmapped region), and with a
        discriminator, the one D update of the batch follows."""
        cfg = self.cfg
        pool_step, pool_gan_step = self.pool_steps
        g_lr = epoch_lr(cfg.train, cfg.train.lr_generator, epoch)
        d_lr = epoch_lr(cfg.train, cfg.train.lr_discriminator, epoch)
        gen = _epoch_generator(pipeline.device, cfg.train.seed, epoch)
        use_gan = self.d_state is not None
        names = _packed_names(self.spool.n, use_gan)
        px = dict(extractor=self.extractor, p_weight=cfg.train.perceptual_weight)

        sums = dict.fromkeys(_SUM_KEYS, 0.0)
        n_batches = 0
        self.throughput.begin()
        progress = ProgressLine(cfg.train.progress, total=pipeline.steps_per_epoch())

        def drain(packed, batch_idx):
            # one host fetch a batch: (5, N) losses, + d_loss in the GAN phase
            vals = packed.reshape(-1).tolist()
            self._check_finite(vals, names, epoch, batch_idx)
            if use_gan:
                sums["d_loss"] += vals.pop()
            g, com, tv, g_d, p = np.asarray(vals).reshape(5, -1)
            self.spool.record_losses(com)
            for k, v in zip(PACKED_KEYS, (g, com, tv, g_d, p)):
                sums[k] += float(v[0])  # the epoch record logs member 0
            progress.update(
                epoch, n_batches,
                {"g_loss": float(g[0]),
                 "d_loss": sums["d_loss"] / max(1, n_batches) if use_gan else None},
                self.throughput.images_per_sec(),
            )

        pending: Optional[tuple] = None
        for hr, lr_imgs in pipeline.epoch(epoch, gen):
            if self._should_stop(n_batches):
                self._epoch_interrupted = True
                break
            # batch k's mask is drawn before batch k−1's losses are drained:
            # the gate reads losses through batch k−2, as in JAX
            gan_mask = self.spool.sample_gan_mask(use_gan)
            if use_gan:
                self.spool.state, self.d_state, metrics = pool_gan_step(
                    self.spool.state, self.d_state, hr, lr_imgs, gan_mask,
                    g_lr, d_lr, d_target_idx=self._d_target(n_batches), **px,
                )
            else:
                self.spool.state, metrics = pool_step(
                    self.spool.state, hr, lr_imgs, g_lr, **px,
                )
            if pending is not None:
                drain(*pending)
            pending = (metrics["packed"], n_batches)
            n_batches += 1
            self.throughput.add(hr.shape[0])
        if pending is not None:
            drain(*pending)
        progress.close()
        return self._epoch_average(sums, n_batches)

    def _epoch_average(self, sums: dict, n_batches: int) -> dict:
        avg = {k: (v / max(1, n_batches)) for k, v in sums.items()}
        avg["images_per_sec"] = self.throughput.images_per_sec()
        avg["n_batches"] = n_batches
        return avg

    def train_epoch(self, pipeline: TrainPipeline, epoch: int) -> dict:
        """One epoch. The member list: each member in pool order takes a
        pixel or a GAN update (one ``rng.random()`` a member with a
        discriminator); the d-target member's pre-update SR then feeds the
        shared D update. A one-member pool whose member chose GAN runs the
        fused ``gan_train_step``, its ``d_loss`` in its packed 6-vector."""
        if self.spool is not None:
            return self._train_epoch_stacked(pipeline, epoch)
        cfg = self.cfg
        g_lr = epoch_lr(cfg.train, cfg.train.lr_generator, epoch)
        d_lr = epoch_lr(cfg.train, cfg.train.lr_discriminator, epoch)
        gen = _epoch_generator(pipeline.device, cfg.train.seed, epoch)
        members = self.pool.members
        has_d = self.d_state is not None
        px = dict(extractor=self.extractor, p_weight=cfg.train.perceptual_weight)

        sums = dict.fromkeys(_SUM_KEYS, 0.0)
        n_batches = 0
        self.throughput.begin()
        progress = ProgressLine(cfg.train.progress, total=pipeline.steps_per_epoch())

        def drain(packed, layout, batch_idx):
            # one host fetch a batch: every member's packed vector, then a
            # separate D update's loss
            vals = packed.tolist()
            names = [f"{k}[{i}]" for i, _, size in layout
                     for k in (*PACKED_KEYS, "d_loss")[:size]]
            if len(names) < len(vals):
                names.append("d_loss")
            self._check_finite(vals, names, epoch, batch_idx)
            at = 0
            for i, used_gan, size in layout:
                v = vals[at:at + size]
                at += size
                if size == 6:
                    sums["d_loss"] += v[5]
                # the ordering signal is the pixel loss only
                self.pool.record_loss(i, v[1], used_gan=used_gan)
                if i == 0:
                    for k, x in zip(PACKED_KEYS, v):
                        sums[k] += x
            if at < len(vals):
                sums["d_loss"] += vals[at]
            progress.update(
                epoch, n_batches,
                {"g_loss": vals[0],
                 "d_loss": sums["d_loss"] / max(1, n_batches) if has_d else None},
                self.throughput.images_per_sec(),
            )

        pending: Optional[tuple] = None
        for hr, lr_imgs in pipeline.epoch(epoch, gen):
            if self._should_stop(n_batches):
                # batch-boundary stop: the drain below settles the last step;
                # train() snapshots and --resume restarts this epoch
                self._epoch_interrupted = True
                break
            d_idx = self._d_target(n_batches) if has_d else None
            packed, layout = [], []
            sr_for_d, d_in_packed = None, False
            for i, member in enumerate(members):
                used_gan = has_d and self.pool.choose_gan(i)
                want_sr = i == d_idx
                if used_gan and want_sr and len(members) == 1:
                    # one member: its GAN update and the D update fuse; with
                    # more, members after d_idx would read the updated D
                    member.state, self.d_state, metrics = gan_train_step(
                        member.state, self.d_state, hr, lr_imgs, g_lr, d_lr, **px,
                    )
                    d_in_packed = True
                elif used_gan:
                    member.state, metrics = generator_gan_step(
                        member.state, self.d_state.model, hr, lr_imgs, g_lr,
                        return_sr=want_sr, **px,
                    )
                else:
                    member.state, metrics = generator_pixel_step(
                        member.state, hr, lr_imgs, g_lr, return_sr=want_sr, **px,
                    )
                if want_sr and "sr" in metrics:
                    sr_for_d = metrics.pop("sr")
                packed.append(metrics["packed"])
                layout.append((i, used_gan, metrics["packed"].numel()))
            if has_d and not d_in_packed:
                # the shared D, after every member read it
                self.d_state, d_metrics = discriminator_step_on_sr(
                    self.d_state, hr, sr_for_d, d_lr
                )
                packed.append(d_metrics["d_loss"].reshape(1))
            # batch k is queued before batch k−1's scalars are fetched
            if pending is not None:
                drain(*pending)
            pending = (torch.cat(packed), layout, n_batches)
            n_batches += 1
            self.throughput.add(hr.shape[0])
        if pending is not None:
            drain(*pending)
        progress.close()
        return self._epoch_average(sums, n_batches)

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
        if not psnrs:  # on every rank alike: the ranks' val shards are equal
            return float("nan"), float("nan")
        # across processes the mean over every rank's batches, the global
        # batches JAX scores (equal shards: each rank's batch k is a part of
        # global batch k of equal size); the ranks' values in rank order
        psnr = mesh.all_gather_cat(torch.stack(psnrs), self.group)
        ssim = mesh.all_gather_cat(torch.stack(ssims), self.group)
        return float(psnr.mean()), float(ssim.mean())

    def validate(self, val_pipeline: TrainPipeline, epoch: int) -> Optional[str]:
        """One validation batch → [LR↑ | SR | HR] comparison PNG
        (``src/train.py:233-260``), from the serving weights."""
        model = self._leader(serve=True)
        gen = _epoch_generator(val_pipeline.device, self.cfg.train.seed + 1389, epoch)
        for hr, lr_imgs in val_pipeline.epoch(epoch, gen):
            sr = infer_step(model, lr_imgs)
            lr_up = resize_bilinear(lr_imgs, (hr.shape[1], hr.shape[2]))
            # each rank renders the grid of its own rows (the reference's
            # per-rank comparison PNGs, ``src/train.py:233-260``)
            return save_comparison(
                lr_up.cpu().numpy(), sr.cpu().numpy(), hr.cpu().numpy(),
                self.cfg.train.results_dir, self.cfg.train.run_prefix, epoch,
                rank=self._rank,
            )
        return None

    # ------------------------------------------------------------------ #

    def _save(self, prefix: str, epoch: int, block: bool = True) -> None:
        """Snapshot the run. Rank 0 alone writes into the shared results
        dir; a blocking save ends in a barrier, so that no rank reads or
        exits before the snapshot is committed."""
        self._sync_pool_from_stacked()
        if self._rank == 0:
            ckpt.save_checkpoint(
                self.cfg.train.results_dir, prefix, pool=self.pool,
                d_state=self.d_state, epoch=epoch, model_config=self.cfg.model,
                block=block,
            )
        if block:
            mesh.barrier(self.group)

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
            self.pool, self.d_state, saved_epoch = ckpt.restore_checkpoint(
                cfg.train.results_dir, cfg.train.run_prefix, pool=self.pool,
                d_state=self.d_state,
            )
            self.pool.reseed((cfg.train.seed, saved_epoch))
            self._rebuild_stacked_from_pool(saved_epoch)
            self.cfg = cfg = cfg.replace(train=ckpt.finetune_entry(cfg.train))
            self.logger = MetricsLogger(cfg.train.results_dir, self._log_prefix())
        elif resume:
            self.pool, self.d_state, start_epoch = ckpt.restore_checkpoint(
                cfg.train.results_dir, cfg.train.run_prefix, pool=self.pool,
                d_state=self.d_state,
            )
            self.pool.reseed((cfg.train.seed, start_epoch))
            self._rebuild_stacked_from_pool(start_epoch)
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
        shards = dict(num_shards=self._n_processes, shard_index=self._rank)
        pipeline = TrainPipeline(
            cfg.data,
            cfg.data.train_dir if train_folder is None else train_folder,
            use_split=True, **shards,
            seed=cfg.train.seed, device=self.device, cache_budget=cache_budget,
        )
        val_pipeline = TrainPipeline(
            cfg.data,
            cfg.data.val_dir if val_folder is None else val_folder,
            use_split=False, **shards,
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
                active_pool = self.spool if self.spool is not None else self.pool
                active_pool.end_epoch()

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
                    "pool": active_pool.snapshot(),
                    **train_metrics,
                }
                if active_pool.gan_threshold is not None:
                    # the gate's (possibly auto-calibrated) threshold
                    record["gan_threshold"] = active_pool.gan_threshold
                if cfg.train.reduce_metrics:
                    record = mesh.reduce_metrics(record, self.group)
                self.logger.log(record)
                last = record
                print(
                    f"Epoch [{epoch + 1}/{cfg.train.num_epochs}] "
                    f"{cfg.train.run_prefix} Loss: {train_metrics['g_loss']:.6f} "
                    f"psnr={psnr:.3f} ssim={ssim:.4f} "
                    f"({train_metrics['images_per_sec']:.1f} img/s)"
                )
                # epoch-boundary stop: a SIGTERM after the last batch;
                # collective, as in _should_stop
                if mesh.any_process_flag(self._stop_requested, self.group):
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
                rank=self._rank,
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
