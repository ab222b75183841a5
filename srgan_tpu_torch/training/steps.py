"""Train, eval and infer steps, the counterpart of
``srgan_tpu/training/steps.py``: the pixel step, the GAN steps (generator,
discriminator, and the two fused), the perceptual term that every generator
step adds when it is given a feature extractor, the eval step and the
serving steps:
the plain forward, the pool ensemble (the member mean), the x8 dihedral
self-ensemble (TTA) and their twins that quantise to uint8 on the device.

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

The perceptual term (``extractor``: ``models/vgg.py:VGG19Features`` or
``models/encoder.py:ConvEncoder``, frozen; ``p_weight``): the HR features
are taken under ``torch.no_grad()``, ``g_loss += p_weight · p_loss``, and the
unweighted ``p_loss`` rides the packed metrics. The extractor runs in f32
whatever the generator's dtype, as in JAX.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import torch
import torch.nn as nn

from srgan_tpu_torch.ops.filters import sharpen
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


def perceptual_term(sr: torch.Tensor, f_real: dict, extractor: nn.Module) -> torch.Tensor:
    """Summed per-tap mean |f(sr) − f_real| over ``f_real``'s taps, in its key
    order (reference ``perceptal_loss`` [sic], ``src/utils.py:154-166``).
    ``f_real``, the HR features, carries no generator gradient: the caller
    extracts it once and passes it in."""
    f_fake = extractor(sr)
    p_loss = torch.zeros((), device=sr.device)
    for key in f_real:
        p_loss = p_loss + (f_fake[key] - f_real[key]).abs().mean()
    return p_loss


def real_features(extractor: nn.Module, hr: torch.Tensor) -> dict:
    """The HR features of the perceptual term, without a graph."""
    with torch.no_grad():
        return extractor(hr)


def _add_perceptual(g_loss, sr, hr, extractor, p_weight):
    """``(g_loss + p_weight·p_loss, p_loss)``; p_loss 0 without an
    extractor."""
    if extractor is None:
        return g_loss, torch.zeros((), device=hr.device)
    p_loss = perceptual_term(sr, real_features(extractor, hr), extractor)
    return g_loss + p_weight * p_loss, p_loss


def generator_pixel_loss_fn(model: nn.Module, hr, lr_imgs, extractor=None,
                            p_weight: float = 0.0):
    """Pixel-phase objective: edge-weighted L1 + masked TV
    (``src/train.py:194-195``: ``g_loss = com_loss + tv_loss``), plus the
    opt-in perceptual term (``src/utils.py:154-166``)."""
    sr = model(lr_imgs)
    com_loss, tv_loss = reconstruction_loss(hr, sr)
    g_loss, p_loss = _add_perceptual(com_loss + tv_loss, sr, hr, extractor, p_weight)
    return g_loss, {"com_loss": com_loss, "tv_loss": tv_loss, "p_loss": p_loss, "sr": sr}


def generator_pixel_step(
    g_state: TrainState,
    hr: torch.Tensor,
    lr_imgs: torch.Tensor,
    lr: float,
    extractor: nn.Module | None = None,
    p_weight: float = 0.0,
    return_sr: bool = False,
) -> Tuple[TrainState, dict]:
    """One pixel-loss generator update (``train_generator``,
    ``src/train.py:175-203``), with the weighted perceptual term when
    ``extractor`` is given. Updates ``g_state`` in place and returns it with
    the step's metrics. ``return_sr=True`` keeps ``metrics["sr"]``, the
    pre-update SR (detached), for a following discriminator update."""
    model = g_state.model
    model.train()
    g_loss, aux = generator_pixel_loss_fn(model, hr, lr_imgs, extractor, p_weight)
    grads = torch.autograd.grad(g_loss, g_state.params)
    g_state.apply_gradients(grads, lr)
    metrics = {"g_loss": g_loss.detach(), "g_d_loss": torch.zeros_like(aux["p_loss"]),
               **{k: v.detach() for k, v in aux.items() if k != "sr"}}
    metrics["packed"] = pack_metrics(metrics)
    if return_sr:
        metrics["sr"] = aux["sr"].detach()
    return g_state, metrics


def generator_gan_loss_fn(model: nn.Module, d_model: nn.Module, hr, lr_imgs,
                          real_preds=None, extractor=None, p_weight: float = 0.0):
    """GAN-phase objective: the pixel terms plus the relativistic term
    ``mean(tanh(D(hr) - D(sr)))`` (``src/train.py:184-192``), D(hr)
    detached, plus the opt-in perceptual term. ``real_preds``: D(hr) where
    the caller has it (with its graph, for a fused discriminator update),
    else computed here without one. Returns the loss and its parts, D(sr)
    among them."""
    sr = model(lr_imgs)
    com_loss, tv_loss = reconstruction_loss(hr, sr)
    if real_preds is None:
        with torch.no_grad():
            real_preds = d_model(hr)
    fake_preds = d_model(sr)
    g_d_loss = generator_adversarial_loss(real_preds.detach(), fake_preds)
    g_loss, p_loss = _add_perceptual(com_loss + tv_loss + g_d_loss, sr, hr,
                                     extractor, p_weight)
    return g_loss, {
        "com_loss": com_loss, "tv_loss": tv_loss, "g_d_loss": g_d_loss,
        "p_loss": p_loss, "sr": sr, "fake_preds": fake_preds,
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
    extractor: nn.Module | None = None,
    p_weight: float = 0.0,
    return_sr: bool = False,
) -> Tuple[TrainState, dict]:
    """One GAN-phase generator update against ``d_model``, which it does
    not change. ``extractor``, ``p_weight`` and ``return_sr`` as in
    :func:`generator_pixel_step`."""
    g_state.model.train()
    g_loss, aux = generator_gan_loss_fn(g_state.model, d_model, hr, lr_imgs,
                                        extractor=extractor, p_weight=p_weight)
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
    extractor: nn.Module | None = None,
    p_weight: float = 0.0,
) -> Tuple[TrainState, TrainState, dict]:
    """Generator and discriminator GAN updates in one step, the same as
    :func:`generator_gan_step` (``return_sr=True``) followed by
    :func:`discriminator_step_on_sr`: D(hr) and D(sr) are computed once and
    serve both losses (D's gradient does not depend on whether sr carries a
    graph). Both gradients are taken before either update."""
    g_state.model.train()
    real_preds = d_state.model(hr)
    g_loss, aux = generator_gan_loss_fn(g_state.model, d_state.model, hr, lr_imgs,
                                        real_preds, extractor, p_weight)
    d_loss = discriminator_loss(real_preds, aux["fake_preds"])
    g_grads = torch.autograd.grad(g_loss, g_state.params, retain_graph=True)
    d_grads = torch.autograd.grad(d_loss, d_state.params)
    g_state.apply_gradients(g_grads, g_lr)
    d_state.apply_gradients(d_grads, d_lr)
    d_loss = d_loss.detach()
    metrics = {**_gan_metrics(g_loss, aux), "d_loss": d_loss}
    metrics["packed"] = pack_metrics(metrics, d_loss)
    return g_state, d_state, metrics


def generator_perceptual_step(
    g_state: TrainState,
    extractor: nn.Module,
    hr: torch.Tensor,
    lr_imgs: torch.Tensor,
    lr: float,
    weight: float,
) -> Tuple[TrainState, dict]:
    """Pixel objective + the feature-L1 perceptual term, as one update: the
    reference builds the extractor but leaves the loss out of its loop
    (``src/train.py:49,157``); here ``TrainConfig.perceptual_weight`` /
    ``--perceptual`` reach it. :func:`generator_pixel_step` with the
    extractor threaded through."""
    return generator_pixel_step(g_state, hr, lr_imgs, lr, extractor, weight)


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


def _member_fns(members, params=None) -> list:
    """Each pool member's forward: ``members`` is a sequence of modules, or
    one module whose ``params`` is a sequence of ``state_dict``s (on the
    input's device), called through ``torch.func.functional_call``."""
    if params is None:
        return [m.eval() for m in members]
    members.eval()
    return [functools.partial(torch.func.functional_call, members, p)
            for p in params]


def _ensemble_fwd(members, params=None):
    fns = _member_fns(members, params)
    return lambda x: torch.stack([f(x) for f in fns]).mean(0)


@torch.no_grad()
def infer_step_ensemble(members, lr_imgs: torch.Tensor,
                        params: Sequence[dict] | None = None) -> torch.Tensor:
    """Pool-ensemble SR forward: the mean of every member's output
    (``srgan_tpu/training/steps.py:313``). The reference serves only member
    0 (``src/evaluation.py:22-31``); the mean puts the pool's other members
    to work at inference."""
    return _ensemble_fwd(members, params)(lr_imgs)


def _dihedral_mean(fwd, lr_imgs: torch.Tensor) -> torch.Tensor:
    """Mean of ``fwd`` over the 8 dihedral transforms of the NHWC input,
    each output mapped back through the inverse transform (x8 geometric
    self-ensemble), in JAX's order: transpose, then H flip, then W flip.
    The transposed four run at (W, H)."""
    outs = []
    for t in range(2):
        xt = lr_imgs.transpose(1, 2) if t else lr_imgs
        for fh in range(2):
            for fw in range(2):
                xx = xt
                if fh:
                    xx = xx.flip(1)
                if fw:
                    xx = xx.flip(2)
                y = fwd(xx)
                if fw:
                    y = y.flip(2)
                if fh:
                    y = y.flip(1)
                if t:
                    y = y.transpose(1, 2)
                outs.append(y)
    return torch.stack(outs).mean(0)


@torch.no_grad()
def infer_step_tta(model, lr_imgs: torch.Tensor, ensemble: bool = False,
                   params: Sequence[dict] | None = None) -> torch.Tensor:
    """x8 dihedral TTA forward; ``ensemble=True``: each of the 8 forwards is
    the member mean (``model`` and ``params`` as in
    :func:`infer_step_ensemble`), 8N forwards in all."""
    fwd = _ensemble_fwd(model, params) if ensemble else model.eval()
    return _dihedral_mean(fwd, lr_imgs)


def quantize_u8(sr: torch.Tensor) -> torch.Tensor:
    """SR → uint8 on its device: clip to [0, 1], x255 + 0.5, floor (the
    formula of ``utils.image_io.array_to_image``, bit for bit)."""
    return torch.floor(sr.float().clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


def _u8(sr: torch.Tensor, enhance_out: bool) -> torch.Tensor:
    return quantize_u8(sharpen(sr) if enhance_out else sr)


@torch.no_grad()
def infer_step_u8(model: nn.Module, lr_imgs: torch.Tensor,
                  enhance_out: bool = False) -> torch.Tensor:
    """SR forward quantised to uint8 on the device, optionally through the
    sharpen epilogue first: the serving path fetches a quarter of the
    float bytes."""
    return _u8(infer_step(model, lr_imgs), enhance_out)


@torch.no_grad()
def infer_step_ensemble_u8(members, lr_imgs: torch.Tensor,
                           enhance_out: bool = False,
                           params: Sequence[dict] | None = None) -> torch.Tensor:
    """The uint8 twin of :func:`infer_step_ensemble`."""
    return _u8(infer_step_ensemble(members, lr_imgs, params), enhance_out)


@torch.no_grad()
def infer_step_tta_u8(model, lr_imgs: torch.Tensor, enhance_out: bool = False,
                      ensemble: bool = False,
                      params: Sequence[dict] | None = None) -> torch.Tensor:
    """The uint8 twin of :func:`infer_step_tta`."""
    return _u8(infer_step_tta(model, lr_imgs, ensemble, params), enhance_out)
