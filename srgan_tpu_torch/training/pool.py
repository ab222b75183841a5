"""The generator pool and its scheduler, the counterpart of
``srgan_tpu/training/pool.py`` (the README algorithm, ``readme.md:1-17``):

  - N generators ordered by running contrastive (pixel) loss, ascending;
  - per batch, each member picks a pixel or a GAN update with a probability
    from its own loss and the two-regime ``Starting_GAN_loss`` gate;
  - at the end of an epoch, re-sort by loss, then weak learns from strong by
    ``param = α·strong + (1−α)·weak``.

One class schedules every pool, one member or many, with the batch API of
the JAX scheduler of the stacked state (``srgan_tpu/training/
stacked_pool.py``): one ``rng.random(n)`` a batch for the GAN mask (the same
doubles as n successive ``rng.random()`` calls of JAX's member list), the
EMA over the batch's (N,) pixel losses, and ``np.argsort`` at the epoch
end. The bookkeeping lives in the members
(``PoolMember``, the checkpoint's layout); ``state``, ``running_loss`` and
``gan_updates`` are read-only views of it in pool order. The parameters are
the members' ``TrainState`` tensors, which the executors of
``training/stacked_pool.py`` update, and the mutual-learning lerp runs in
place on them.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from srgan_tpu_torch.config import PoolConfig
from srgan_tpu_torch.training.stacked_pool import (
    mutual_learning_lerp,
    permute_members,
    stack_states,
)
from srgan_tpu_torch.training.train_state import TrainState


def sort_lists_in_same_order(*lists, reverse: bool = True):
    """Sort N parallel lists by the *last* list's values: the reference
    helper ``shuffle_lists_in_same_order`` (``src/utils.py:102-110``), which
    sorts, descending by default. The pool itself sorts ascending."""
    combined = sorted(zip(*lists), key=lambda t: t[-1], reverse=reverse)
    return [list(t) for t in zip(*combined)]


@dataclasses.dataclass
class PoolMember:
    state: TrainState
    # Running (EMA) contrastive/pixel loss: the ordering and gating signal.
    running_loss: float = float("inf")
    # Previous epoch's running loss ("pre_loss", ``readme.md:5``).
    pre_loss: float = float("inf")
    gan_updates: int = 0
    pixel_updates: int = 0


class GeneratorPool:
    """Ordered pool of generator train states with the README scheduler.
    The states share member 0's EMA decay (:func:`stack_states`)."""

    def __init__(self, states: Sequence[TrainState], cfg: PoolConfig, seed=0):
        self.members: List[PoolMember] = [PoolMember(state=s)
                                          for s in stack_states(states)]
        self.cfg = cfg
        self._rng = np.random.default_rng(seed)
        # The two-regime gate threshold: the configured value, or None =
        # auto, calibrated at the first epoch end (see end_epoch); until
        # then every member reads as above-regime.
        self.gan_threshold: float | None = cfg.starting_gan_loss

    @property
    def leader(self) -> PoolMember:
        """Generator 0, the "main information generator" (``readme.md:7``)."""
        return self.members[0]

    @property
    def state(self) -> List[TrainState]:
        """The members' states in pool order, what the executors step."""
        return [m.state for m in self.members]

    @property
    def running_loss(self) -> np.ndarray:
        return np.array([m.running_loss for m in self.members])

    @property
    def gan_updates(self) -> np.ndarray:
        return np.array([m.gan_updates for m in self.members], np.int64)

    def gan_probabilities(self) -> np.ndarray:
        """Per-member P(GAN update) this batch: the two-regime gate of
        ``readme.md:10`` with PoolConfig's probabilities, modulated by the
        opt-in pre_loss gate (``pre_loss_boost`` where the loss improved
        since the last epoch end, ``pre_loss_damp`` where it regressed)."""
        loss = self.running_loss
        p = np.zeros(len(loss))
        finite = np.isfinite(loss)  # a member with no signal yet: pixel
        if not finite.any():
            return p
        min_loss = loss[finite].min()
        thr = (
            self.gan_threshold
            if self.gan_threshold is not None
            else float("-inf")  # auto, before calibration: above-regime
        )
        for i in np.flatnonzero(finite):
            if loss[i] > thr:
                p[i] = self.cfg.p_gan_above
            elif i == 0 or loss[i] <= min_loss:
                p[i] = self.cfg.p_gan_leader
            else:
                p[i] = self.cfg.p_gan_follower
        if self.cfg.pre_loss_gate:
            pre = np.array([m.pre_loss for m in self.members])
            factor = np.where(loss < pre, self.cfg.pre_loss_boost,
                              self.cfg.pre_loss_damp)
            p = np.where(np.isfinite(pre), np.minimum(1.0, p * factor), p)
        return p

    def sample_gan_mask(self, use_gan: bool) -> np.ndarray:
        """The batch's (N,) GAN mask, one ``rng.random(n)`` a batch with a
        discriminator (all zeros without one), each member's update counted
        as drawn."""
        n = len(self.members)
        mask = np.zeros(n, np.float32)
        if use_gan:
            mask = (self._rng.random(n) < self.gan_probabilities()).astype(np.float32)
        for m, gan in zip(self.members, mask):
            if gan:
                m.gan_updates += 1
            else:
                m.pixel_updates += 1
        return mask

    def record_losses(self, com_losses) -> None:
        """The EMA of each member's pixel loss, the ordering signal; a
        member's first loss starts it."""
        e = self.cfg.loss_ema
        for m, x in zip(self.members, np.asarray(com_losses, np.float64).tolist()):
            m.running_loss = (x if not np.isfinite(m.running_loss)
                              else e * m.running_loss + (1 - e) * x)

    def reseed(self, seed) -> None:
        """Re-key the scheduler RNG (after a restore, with the resume epoch
        folded in, so the pixel-or-GAN draws do not replay the run's
        start)."""
        self._rng = np.random.default_rng(seed)

    def end_epoch(self):
        """Epoch-end re-sort (``readme.md:8``, ``np.argsort``, reversed when
        descending) and weak-learns-from-strong mutual learning
        (``readme.md:13``) of the params and the EMA shadows. The first
        epoch end calibrates an auto gate threshold to ``gate_auto_frac`` x
        the median running loss."""
        order = np.argsort(self.running_loss)
        if not self.cfg.sort_ascending:
            order = order[::-1]
        self.members = permute_members(self.members, order)
        loss = self.running_loss
        if self.cfg.starting_gan_loss is None and self.gan_threshold is None:
            finite = loss[np.isfinite(loss)]
            if finite.size:
                self.gan_threshold = float(self.cfg.gate_auto_frac * np.median(finite))
        for m in self.members:
            m.pre_loss = m.running_loss
        if self.cfg.mutual_learning and len(self.members) > 1:
            states = self.state
            mutual_learning_lerp([s.params for s in states], self.cfg.mutual_alpha)
            if states[0].ema_params:
                mutual_learning_lerp([s.ema_params for s in states],
                                     self.cfg.mutual_alpha)

    def snapshot(self) -> List[dict]:
        # gan_threshold rides in every record; NaN = not calibrated yet, so
        # a run resumed before its first end_epoch calibrates as a fresh
        # one would
        gate = (
            float(self.gan_threshold)
            if self.gan_threshold is not None
            else float("nan")
        )
        return [
            {
                "running_loss": float(m.running_loss),
                "pre_loss": float(m.pre_loss),
                "gan_updates": int(m.gan_updates),
                "pixel_updates": int(m.pixel_updates),
                "gan_threshold": gate,
            }
            for m in self.members
        ]
