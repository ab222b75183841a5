"""The generator pool and its scheduler, the counterpart of
``srgan_tpu/training/pool.py`` (the README algorithm, ``readme.md:1-17``):

  - N generators ordered by running contrastive (pixel) loss, ascending;
  - per batch, each member picks a pixel or a GAN update with a probability
    from its own loss and the two-regime ``Starting_GAN_loss`` gate;
  - at the end of an epoch, re-sort by loss, then weak learns from strong by
    ``param = α·strong + (1−α)·weak``.

The bookkeeping is plain numpy and Python floats, as in JAX; the parameters
are the members' ``TrainState`` tensors, and the mutual-learning lerp runs in
place on them. The port's ``Trainer`` holds a one-member pool (pools of more
members are ROADMAP.md queue 1, item 7).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

from srgan_tpu_torch.config import PoolConfig
from srgan_tpu_torch.training.train_state import TrainState


@torch.no_grad()
def interpolate_params(params: Sequence[torch.Tensor],
                       target_params: Sequence[torch.Tensor],
                       alpha: float = 0.2) -> None:
    """``param = alpha*target + (1-alpha)*param`` in place over two lists of
    tensors (reference ``interpolate_models``, ``src/utils.py:113-115``)."""
    params = list(params)
    torch._foreach_mul_(params, 1.0 - alpha)
    torch._foreach_add_(params, list(target_params), alpha=alpha)


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
    """Ordered pool of generator train states with the README scheduler."""

    def __init__(self, members: Sequence[PoolMember], cfg: PoolConfig, seed=0):
        self.members: List[PoolMember] = list(members)
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

    def min_loss(self) -> float:
        return min(m.running_loss for m in self.members)

    def gan_probability(self, index: int) -> float:
        """P(GAN update) for member ``index`` this batch: the two-regime gate
        of ``readme.md:10`` with PoolConfig's probabilities, modulated by
        the opt-in pre_loss gate."""
        m = self.members[index]
        if not np.isfinite(m.running_loss):
            return 0.0  # no signal yet: pixel phase
        thr = (
            self.gan_threshold
            if self.gan_threshold is not None
            else float("-inf")  # auto, before calibration: above-regime
        )
        if m.running_loss > thr:
            p = self.cfg.p_gan_above
        elif index == 0:
            p = self.cfg.p_gan_leader
        elif m.running_loss > self.min_loss():
            p = self.cfg.p_gan_follower
        else:
            p = self.cfg.p_gan_leader
        return min(1.0, p * self._pre_loss_factor(m.running_loss, m.pre_loss))

    def _pre_loss_factor(self, running_loss: float, pre_loss: float) -> float:
        """``pre_loss_boost`` when the loss improved since the last epoch
        end, ``pre_loss_damp`` when it regressed; 1.0 with the gate off or
        before the first epoch end."""
        if not self.cfg.pre_loss_gate or not np.isfinite(pre_loss):
            return 1.0
        return (
            self.cfg.pre_loss_boost
            if running_loss < pre_loss
            else self.cfg.pre_loss_damp
        )

    def reseed(self, seed) -> None:
        """Re-key the scheduler RNG (after a restore, with the resume epoch
        folded in, so the pixel-or-GAN draws do not replay the run's
        start)."""
        self._rng = np.random.default_rng(seed)

    def choose_gan(self, index: int) -> bool:
        """Host-side Bernoulli draw selecting the GAN step for this batch."""
        return bool(self._rng.random() < self.gan_probability(index))

    def record_loss(self, index: int, pixel_loss: float, used_gan: bool):
        m = self.members[index]
        if not np.isfinite(m.running_loss):
            m.running_loss = float(pixel_loss)
        else:
            e = self.cfg.loss_ema
            m.running_loss = e * m.running_loss + (1.0 - e) * float(pixel_loss)
        if used_gan:
            m.gan_updates += 1
        else:
            m.pixel_updates += 1

    def end_epoch(self):
        """Epoch-end re-sort (``readme.md:8``) and weak-learns-from-strong
        mutual learning (``readme.md:13``). The first epoch end calibrates
        an auto gate threshold to ``gate_auto_frac`` x the median running
        loss."""
        self.members.sort(
            key=lambda m: m.running_loss, reverse=not self.cfg.sort_ascending
        )
        if self.cfg.starting_gan_loss is None and self.gan_threshold is None:
            finite = [
                m.running_loss
                for m in self.members
                if np.isfinite(m.running_loss)
            ]
            if finite:
                self.gan_threshold = float(
                    self.cfg.gate_auto_frac * np.median(finite)
                )
        for m in self.members:
            m.pre_loss = m.running_loss
        if self.cfg.mutual_learning and len(self.members) > 1:
            strong = self.members[0].state
            for m in self.members[1:]:
                # the shadow gets the same lerp as the params it averages
                interpolate_params(m.state.params, strong.params,
                                   self.cfg.mutual_alpha)
                if m.state.ema_params:
                    interpolate_params(m.state.ema_params, strong.ema_params,
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
                "running_loss": m.running_loss,
                "pre_loss": m.pre_loss,
                "gan_updates": m.gan_updates,
                "pixel_updates": m.pixel_updates,
                "gan_threshold": gate,
            }
            for m in self.members
        ]
