"""Train, eval and infer steps for the pixel phase, the counterpart of the
single-generator pixel path of ``srgan_tpu/training/steps.py``.

A step runs eagerly: forward, the reconstruction loss (kernels K1 + K2 on
the card), backward (K3 for the loss, cuDNN for the convs) and the Adam
update in place. Loss scalars stay on the device; ``metrics["packed"]``
stacks them so the loop fetches one array per batch.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from srgan_tpu_torch.ops.metrics import batched_psnr_ssim
from srgan_tpu_torch.ops.recon_loss import reconstruction_loss
from srgan_tpu_torch.training.train_state import TrainState

# Layout of the fetch-once loss vector every train step also returns as
# ``metrics["packed"]``.
PACKED_KEYS = ("g_loss", "com_loss", "tv_loss", "g_d_loss", "p_loss")


def pack_metrics(metrics: dict) -> torch.Tensor:
    """Stack the standard loss scalars (PACKED_KEYS order) into one device
    tensor for a single fetch."""
    return torch.stack([torch.as_tensor(metrics[k]) for k in PACKED_KEYS])


def generator_pixel_loss_fn(model: nn.Module, hr, lr_imgs):
    """Pixel-phase objective: edge-weighted L1 + masked TV
    (``src/train.py:194-195``: ``g_loss = com_loss + tv_loss``)."""
    sr = model(lr_imgs)
    com_loss, tv_loss = reconstruction_loss(hr, sr)
    g_loss = com_loss + tv_loss
    return g_loss, {"com_loss": com_loss, "tv_loss": tv_loss,
                    "p_loss": torch.zeros((), device=hr.device)}


def generator_pixel_step(
    g_state: TrainState,
    hr: torch.Tensor,
    lr_imgs: torch.Tensor,
    lr: float,
) -> Tuple[TrainState, dict]:
    """One pixel-loss generator update (``train_generator``,
    ``src/train.py:175-203``). Updates ``g_state`` in place and returns it
    with the step's metrics."""
    model = g_state.model
    model.train()
    g_loss, aux = generator_pixel_loss_fn(model, hr, lr_imgs)
    grads = torch.autograd.grad(g_loss, g_state.params)
    g_state.apply_gradients(grads, lr)
    metrics = {"g_loss": g_loss.detach(), "g_d_loss": torch.zeros_like(aux["p_loss"]),
               **{k: v.detach() for k, v in aux.items()}}
    metrics["packed"] = pack_metrics(metrics)
    return g_state, metrics


@torch.no_grad()
def eval_step(model: nn.Module, hr: torch.Tensor, lr_imgs: torch.Tensor):
    """Score one batch on the device: SR forward + mean per-image
    PSNR/SSIM. SR is left unclamped, the reference's training-metric quirk
    (``srgan_tpu/training/steps.py:295-303``)."""
    model.eval()
    sr = model(lr_imgs)
    psnr_b, ssim_b = batched_psnr_ssim(sr, hr)
    return psnr_b.mean(), ssim_b.mean()


@torch.no_grad()
def infer_step(model: nn.Module, lr_imgs: torch.Tensor) -> torch.Tensor:
    """Plain SR forward for validation grids / inference."""
    model.eval()
    return model(lr_imgs)
