"""Train state: a generator, its Adam moments and an optional EMA shadow —
the counterpart of ``srgan_tpu/training/train_state.py``.

Adam is ``optax.scale_by_adam`` (b1 0.9, b2 0.999, eps 1e-8 added outside
the square root, bias-corrected moments) and the −lr is applied per step,
so the per-epoch schedule is a plain host float (reference: torch
``optim.Adam`` + ``LinearLR``, ``src/train.py:61-71``). The update runs
in place with ``torch._foreach_*`` over the parameter list; nothing in it
reads a device value on the host.
"""

from __future__ import annotations

import copy
import math
from typing import List, Sequence

import torch
import torch.nn as nn

from srgan_tpu_torch.config import TrainConfig


class TrainState:
    def __init__(self, model: nn.Module, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, ema_decay: float = 0.0):
        self.model = model
        self.params: List[torch.Tensor] = list(model.parameters())
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0
        self.b1, self.b2, self.eps = b1, b2, eps
        self.ema_decay = float(ema_decay)
        # The EMA shadow (None = off): a copy of the model whose weights
        # follow ema ← d·ema + (1−d)·params after every update.
        self.ema_model = None
        self.ema_params: List[torch.Tensor] = []
        if self.ema_decay > 0.0:
            self.ema_model = copy.deepcopy(model).requires_grad_(False)
            self.ema_params = list(self.ema_model.parameters())

    @property
    def serve_model(self) -> nn.Module:
        """The model to evaluate/serve: the EMA shadow when enabled."""
        return self.model if self.ema_model is None else self.ema_model

    @torch.no_grad()
    def update_ema(self) -> None:
        if self.ema_model is None:
            return
        d = self.ema_decay
        torch._foreach_mul_(self.ema_params, d)
        torch._foreach_add_(self.ema_params, self.params, alpha=1.0 - d)

    @torch.no_grad()
    def apply_gradients(self, grads: Sequence[torch.Tensor], lr: float) -> None:
        """One Adam step with learning rate ``lr``, then the EMA step."""
        grads = list(grads)
        self.count += 1
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - b2)
        denom = torch._foreach_div(self.nu, 1.0 - b2**self.count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        update = torch._foreach_div(self.mu, 1.0 - b1**self.count)
        torch._foreach_div_(update, denom)
        torch._foreach_add_(self.params, update, alpha=-lr)
        self.update_ema()


def epoch_lr(cfg: TrainConfig, base_lr: float, epoch: int) -> float:
    """Per-epoch LR from the configured schedule."""
    if cfg.lr_schedule == "cosine":
        return cosine_lr(cfg, base_lr, epoch)
    return linear_lr(cfg, base_lr, epoch)


def linear_lr(cfg: TrainConfig, base_lr: float, epoch: int) -> float:
    """torch ``LinearLR(start_factor=1, end_factor=0.01,
    total_iters=num_epochs)`` (``src/train.py:70-71``): the factor
    interpolates linearly per epoch and stays at ``end_factor`` after
    ``total_iters`` epochs."""
    t = min(epoch, cfg.num_epochs)
    frac = t / cfg.num_epochs
    factor = cfg.lr_start_factor + (cfg.lr_end_factor - cfg.lr_start_factor) * frac
    return base_lr * factor


def cosine_lr(
    cfg: TrainConfig, base_lr: float, epoch: int, eta_min_ratio: float = 0.5
) -> float:
    """The reference's commented-out CosineAnnealingLR variant
    (``src/train.py:68-69``), torch's closed form, continuing past
    ``T_max`` where the cosine rises back toward ``base_lr``."""
    t_max = max(1, cfg.num_epochs - cfg.num_epochs // 5)
    eta_min = base_lr * eta_min_ratio
    return (
        eta_min
        + (base_lr - eta_min) * (1 + math.cos(math.pi * epoch / t_max)) / 2
    )
