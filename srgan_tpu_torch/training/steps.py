"""Train, eval and infer steps, the counterpart of
``srgan_tpu/training/steps.py``: the pixel step, the GAN steps (generator,
discriminator, and the two fused) and the eval and infer steps.

A step runs eagerly: forward, the reconstruction loss (kernels K1 + K2 on
the card), backward (K3 for the loss, cuDNN for the convs) and the Adam
update in place. Loss scalars stay on the device; ``metrics["packed"]``
stacks them so the loop fetches one array per batch.

The GAN steps keep JAX's "simultaneous" semantics although Adam runs in
place: the generator's adversarial term reads the discriminator before its
update, the discriminator trains on the generator's pre-update SR
(detached), and a step takes every gradient it needs before it applies
either Adam update. Gradients are taken with ``torch.autograd.grad`` of
the state's own parameters only, so the other network's parameters collect
nothing.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from srgan_tpu_torch.ops.gan_loss import discriminator_loss, generator_adversarial_loss
from srgan_tpu_torch.ops.metrics import batched_psnr_ssim
from srgan_tpu_torch.ops.recon_loss import reconstruction_loss
from srgan_tpu_torch.training.train_state import TrainState

# Layout of the fetch-once loss vector every train step also returns as
# ``metrics["packed"]``.
PACKED_KEYS = ("g_loss", "com_loss", "tv_loss", "g_d_loss", "p_loss")


def pack_metrics(metrics: dict, d_loss=None) -> torch.Tensor:
    """Stack the standard loss scalars (PACKED_KEYS order), and append
    ``d_loss`` when given, into one device tensor for a single fetch. Per-
    member (N,) losses stack to (5, N), flattened to (5N + 1,) with
    ``d_loss``."""
    packed = torch.stack([torch.as_tensor(metrics[k]) for k in PACKED_KEYS])
    if d_loss is not None:
        packed = torch.cat([packed.reshape(-1), d_loss.reshape(1)])
    return packed


def generator_pixel_loss_fn(model: nn.Module, hr, lr_imgs):
    """Pixel-phase objective: edge-weighted L1 + masked TV
    (``src/train.py:194-195``: ``g_loss = com_loss + tv_loss``)."""
    sr = model(lr_imgs)
    com_loss, tv_loss = reconstruction_loss(hr, sr)
    g_loss = com_loss + tv_loss
    return g_loss, {"com_loss": com_loss, "tv_loss": tv_loss,
                    "p_loss": torch.zeros((), device=hr.device), "sr": sr}


def generator_pixel_step(
    g_state: TrainState,
    hr: torch.Tensor,
    lr_imgs: torch.Tensor,
    lr: float,
    return_sr: bool = False,
) -> Tuple[TrainState, dict]:
    """One pixel-loss generator update (``train_generator``,
    ``src/train.py:175-203``). Updates ``g_state`` in place and returns it
    with the step's metrics. ``return_sr=True`` keeps ``metrics["sr"]``, the
    pre-update SR (detached), for a following discriminator update."""
    model = g_state.model
    model.train()
    g_loss, aux = generator_pixel_loss_fn(model, hr, lr_imgs)
    grads = torch.autograd.grad(g_loss, g_state.params)
    g_state.apply_gradients(grads, lr)
    metrics = {"g_loss": g_loss.detach(), "g_d_loss": torch.zeros_like(aux["p_loss"]),
               **{k: v.detach() for k, v in aux.items() if k != "sr"}}
    metrics["packed"] = pack_metrics(metrics)
    if return_sr:
        metrics["sr"] = aux["sr"].detach()
    return g_state, metrics


def generator_gan_loss_fn(model: nn.Module, d_model: nn.Module, hr, lr_imgs,
                          real_preds=None):
    """GAN-phase objective: the pixel terms plus the relativistic term
    ``mean(tanh(D(hr) - D(sr)))`` (``src/train.py:184-192``), D(hr)
    detached. ``real_preds``: D(hr) where the caller has it (with its graph,
    for a fused discriminator update), else computed here without one.
    Returns the loss and its parts, D(sr) among them."""
    sr = model(lr_imgs)
    com_loss, tv_loss = reconstruction_loss(hr, sr)
    if real_preds is None:
        with torch.no_grad():
            real_preds = d_model(hr)
    fake_preds = d_model(sr)
    g_d_loss = generator_adversarial_loss(real_preds.detach(), fake_preds)
    g_loss = com_loss + tv_loss + g_d_loss
    return g_loss, {
        "com_loss": com_loss, "tv_loss": tv_loss, "g_d_loss": g_d_loss,
        "p_loss": torch.zeros((), device=hr.device), "sr": sr,
        "fake_preds": fake_preds,
    }


def _gan_metrics(g_loss, aux) -> dict:
    return {"g_loss": g_loss.detach(),
            **{k: aux[k].detach() for k in ("com_loss", "tv_loss", "g_d_loss", "p_loss")}}


def generator_gan_step(
    g_state: TrainState,
    d_model: nn.Module,
    hr: torch.Tensor,
    lr_imgs: torch.Tensor,
    lr: float,
    return_sr: bool = False,
) -> Tuple[TrainState, dict]:
    """One GAN-phase generator update against ``d_model``, which it does
    not change. ``return_sr`` as in :func:`generator_pixel_step`."""
    g_state.model.train()
    g_loss, aux = generator_gan_loss_fn(g_state.model, d_model, hr, lr_imgs)
    grads = torch.autograd.grad(g_loss, g_state.params)
    g_state.apply_gradients(grads, lr)
    metrics = _gan_metrics(g_loss, aux)
    metrics["packed"] = pack_metrics(metrics)
    if return_sr:
        metrics["sr"] = aux["sr"].detach()
    return g_state, metrics


def gan_train_step(
    g_state: TrainState,
    d_state: TrainState,
    hr: torch.Tensor,
    lr_imgs: torch.Tensor,
    g_lr: float,
    d_lr: float,
) -> Tuple[TrainState, TrainState, dict]:
    """Generator and discriminator GAN updates in one step, the same as
    :func:`generator_gan_step` (``return_sr=True``) followed by
    :func:`discriminator_step_on_sr`: D(hr) and D(sr) are computed once and
    serve both losses (D's gradient does not depend on whether sr carries a
    graph). Both gradients are taken before either update."""
    g_state.model.train()
    real_preds = d_state.model(hr)
    g_loss, aux = generator_gan_loss_fn(g_state.model, d_state.model, hr, lr_imgs,
                                        real_preds)
    d_loss = discriminator_loss(real_preds, aux["fake_preds"])
    g_grads = torch.autograd.grad(g_loss, g_state.params, retain_graph=True)
    d_grads = torch.autograd.grad(d_loss, d_state.params)
    g_state.apply_gradients(g_grads, g_lr)
    d_state.apply_gradients(d_grads, d_lr)
    d_loss = d_loss.detach()
    metrics = {**_gan_metrics(g_loss, aux), "d_loss": d_loss}
    metrics["packed"] = pack_metrics(metrics, d_loss)
    return g_state, d_state, metrics


def discriminator_step(
    d_state: TrainState,
    g_model: nn.Module,
    hr: torch.Tensor,
    lr_imgs: torch.Tensor,
    lr: float,
) -> Tuple[TrainState, dict]:
    """One discriminator update (``train_discriminator``,
    ``src/train.py:206-230``) on the SR of ``g_model``, which it does not
    change."""
    with torch.no_grad():
        sr = g_model(lr_imgs)
    return discriminator_step_on_sr(d_state, hr, sr, lr)


def discriminator_step_on_sr(
    d_state: TrainState,
    hr: torch.Tensor,
    sr: torch.Tensor,
    lr: float,
    real_preds: torch.Tensor | None = None,
) -> Tuple[TrainState, dict]:
    """One discriminator update on a precomputed (pre-update) SR batch: the
    objective of :func:`discriminator_step` without a second generator
    forward. ``real_preds``: D(hr) with its graph, where the caller has
    it."""
    if real_preds is None:
        real_preds = d_state.model(hr)
    d_loss = discriminator_loss(real_preds, d_state.model(sr.detach()))
    grads = torch.autograd.grad(d_loss, d_state.params)
    d_state.apply_gradients(grads, lr)
    return d_state, {"d_loss": d_loss.detach()}


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
