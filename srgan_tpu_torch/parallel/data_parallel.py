"""The reference's DDP formulation of the pixel step, the counterpart of
``srgan_tpu/parallel/data_parallel.py`` (``make_shardmap_pixel_step``).

The ``Trainer``'s multi-process path computes the reconstruction loss over
the GLOBAL batch: its edge statistics and sums are summed over the ranks
before their finalise (``ops/cuda/recon_loss_kernel.py``), the same
function as one process on the whole batch. The reference's DDP does
otherwise (``src/train.py:45,194``): each GPU's ``g_criterion`` sees only
its own rows, so each rank normalises its edge map with its own
statistics, and DDP averages the gradients. That is this step: a per-rank
loss, the gradients averaged across the group before the (identical) Adam
step on every rank, and the loss scalars averaged for the record. The two
differ by O(1e-4) on the loss for typical batches.
"""

from __future__ import annotations

from typing import Tuple

import torch

from srgan_tpu_torch.parallel.mesh import average_, average_grads
from srgan_tpu_torch.training.steps import generator_pixel_loss_fn
from srgan_tpu_torch.training.train_state import TrainState


def make_shardmap_pixel_step(group=None):
    """The DDP pixel step over ``group`` (the identity collective without
    one). Returns ``step(state, hr, lr_imgs, lr) -> (state, metrics)``: each
    rank passes its own rows, and ``state`` (``group`` None: this step
    averages the gradients itself) ends the same on every rank. ``metrics``
    holds the group-mean ``g_loss``, ``com_loss``, ``tv_loss`` and
    ``p_loss``, and a zero ``g_d_loss``, the JAX step's keys."""

    def step(state: TrainState, hr: torch.Tensor, lr_imgs: torch.Tensor,
             lr: float) -> Tuple[TrainState, dict]:
        if state.group is not None:
            raise ValueError(
                "make_shardmap_pixel_step averages the gradients itself: "
                "pass a state without a group"
            )
        state.model.train()
        # no group: this rank's rows alone set the edge statistics
        loss, aux = generator_pixel_loss_fn(state.model, hr, lr_imgs)
        grads = torch.autograd.grad(loss, state.params)
        state.apply_gradients(average_grads(grads, group), lr)
        scalars = torch.stack([loss.detach(), aux["com_loss"].detach(),
                               aux["tv_loss"].detach(), aux["p_loss"].detach()])
        g_loss, com, tv, p = average_(scalars, group)
        return state, {"g_loss": g_loss, "com_loss": com, "tv_loss": tv,
                       "p_loss": p, "g_d_loss": torch.zeros_like(g_loss)}

    return step
