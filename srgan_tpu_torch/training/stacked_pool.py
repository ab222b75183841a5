"""The executors of a pool of more than one generator, the counterpart of
``srgan_tpu/training/stacked_pool.py``: the scan executor
(:func:`scanned_pool_step`, :func:`scanned_pool_gan_step`; the default,
``member_exec="scan"``) and the vmap executor (``"vmap"``), with the
helpers of JAX's stacked state that the one scheduler,
``training/pool.py:GeneratorPool``, uses.

In JAX the members' states are stacked on a leading pool axis and one
compiled step scans over it, each iteration taking its member's gradient
and Adam step. Here there is no pool axis: the executors take the
members' ``TrainState``s in pool order (``GeneratorPool.state``) and the
scan is a loop over them: each member's forward, loss (K1-K3 on the card,
once per member), backward and in-place Adam step in turn, so one member's
activations are alive at a time. A permute is a reorder of the list and the
mutual-learning lerp is ``interpolate_params`` in place. As in JAX, the
pool keeps ONE EMA decay, member 0's, for every member
(:func:`stack_states`).

The GAN steps keep JAX's pairing: every member reads the discriminator
before its update, D(hr) is computed once a batch (with its graph, which
D's own loss reuses; the members read it detached), and the one D update
trains on the selected member's pre-update SR, after the member loop.
Each member's loss is ``com + tv + mask·g_d + p_weight·p``; ``g_d`` is
reported for every member, and a member with mask 0 takes it without a
graph through D (its gradient contribution is exactly 0). With a perceptual
extractor the HR features are taken once a batch, before the member loop,
as JAX hoists them out of its scan; they carry no graph, so every member
may share them although each member's Adam step runs before the next
member's forward.

The vmap executor (:func:`stacked_pool_step`, :func:`stacked_pool_gan_step`)
differentiates the SUM of the members' objectives in one region, as JAX's
``_stacked_loss_fn`` does: the members' params are stacked into (N, …)
leaves, member 0's module runs under ``torch.func.vmap`` through
``torch.func.functional_call`` (a conv with a batched weight becomes a
grouped conv), and ``torch.autograd.grad`` of the sum gives every member its
own gradient. All N members' activations are alive at the backward (the
scan keeps one member's). The loss runs through the kernels' Function,
whose vmap rule launches K1 once on HR and K2 and K3 once each over the
member axis. D(hr) and the HR features are taken once, outside the vmap;
D(sr) runs inside it, the perceptual extractor outside it on the N·B SR
images. Each member's slice of the gradients then goes to its own
``TrainState.apply_gradients`` (its in-place Adam, averaged over the group
under ``--multihost``): JAX's ``vmap(member_update)``. The stacked leaves
are copies; a step reads the members' params afresh. A model with
``remat`` runs as it comes: each residual block's ``RematBlock`` has a
vmap rule that takes the (N, …) block input and params out of the vmap
into ``PooledRematBlock``, which keeps only those for the backward and
recomputes the N members' branch there, under a vmap of its own (JAX's
``nn.remat`` blocks inside ``jax.vmap``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from srgan_tpu_torch.ops.cuda.recon_loss_kernel import ReconstructionLoss
from srgan_tpu_torch.ops.gan_loss import generator_adversarial_loss
from srgan_tpu_torch.ops.recon_loss import reconstruction_loss
from srgan_tpu_torch.training.steps import (
    discriminator_step_on_sr,
    pack_metrics,
    perceptual_term,
    real_features,
)
from srgan_tpu_torch.training.train_state import TrainState
from srgan_tpu_torch.utils.profiling import span


@torch.no_grad()
def interpolate_params(params: Sequence[torch.Tensor],
                       target_params: Sequence[torch.Tensor],
                       alpha: float = 0.2) -> None:
    """``param = alpha*target + (1-alpha)*param`` in place over two lists of
    tensors (reference ``interpolate_models``, ``src/utils.py:113-115``)."""
    params = list(params)
    torch._foreach_mul_(params, 1.0 - alpha)
    torch._foreach_add_(params, list(target_params), alpha=alpha)


def stack_states(states: Sequence[TrainState]) -> List[TrainState]:
    """Per-member states → the stacked state, their list in pool order. The
    EMA decay is member 0's for every member (JAX stacks a 0-dim
    ``ema_decay`` leaf as one shared scalar): the members' ``ema_decay`` is
    set to it."""
    shared = states[0].ema_decay
    for s in states:
        s.ema_decay = shared
    return list(states)


def permute_members(members: Sequence, perm) -> list:
    """Epoch-end re-sort: member ``perm[i]`` becomes member i (the states,
    or the pool's members with their bookkeeping). The shared EMA decay has
    no pool axis and stays."""
    return [members[int(i)] for i in perm]


@torch.no_grad()
def mutual_learning_lerp(member_params: Sequence[Sequence[torch.Tensor]],
                         alpha: float = 0.2):
    """Weak learns from strong: every member after the first moves toward
    member 0, ``p ← alpha·p0 + (1−alpha)·p`` (``src/utils.py:113-115``), in
    place. Returns ``member_params``."""
    leader = member_params[0]
    for follower in member_params[1:]:
        interpolate_params(follower, leader, alpha)
    return member_params


def _scan_pool_update(states: Sequence[TrainState], hr, lr_imgs, g_lr: float,
                      d_model: Optional[nn.Module] = None, d_real=None,
                      gan_mask=None, d_target_idx: int = 0,
                      extractor: Optional[nn.Module] = None, p_weight: float = 0.0):
    """The member loop: each member's gradient and Adam step in turn, against
    ``d_model`` where given (read, not changed; ``d_real`` is D(hr),
    detached), with the perceptual term where ``extractor`` is given (the HR
    features taken once, here). Returns the (N,) losses ``(com, tv, g_d, p,
    g)`` and member ``d_target_idx``'s pre-update SR (detached)."""
    mask = np.zeros(len(states)) if gan_mask is None else np.asarray(gan_mask)
    zero = torch.zeros((), device=hr.device)
    f_real = None if extractor is None else real_features(extractor, hr)
    com_l, tv_l, g_d_l, p_l, g_l = [], [], [], [], []
    sr_keep = None
    for i, st in enumerate(states):
        with span("step.member", member=i, gan=bool(mask[i])):
            st.model.train()
            sr = st.model(lr_imgs)
            com, tv = reconstruction_loss(hr, sr, st.group)
            g_d = zero
            if d_model is not None:
                # a member with mask 0 takes no gradient through D
                with torch.set_grad_enabled(bool(mask[i])):
                    g_d = generator_adversarial_loss(d_real, d_model(sr))
            loss = com + tv + float(mask[i]) * g_d
            p = zero
            if f_real is not None:
                p = perceptual_term(sr, f_real, extractor)
                loss = loss + p_weight * p
            grads = torch.autograd.grad(loss, st.params)
            st.apply_gradients(grads, g_lr)
        if i == d_target_idx:
            sr_keep = sr.detach()
        com_l.append(com.detach())
        tv_l.append(tv.detach())
        g_d_l.append(g_d.detach())
        p_l.append(p.detach())
        g_l.append(loss.detach())
    return tuple(map(torch.stack, (com_l, tv_l, g_d_l, p_l, g_l))), sr_keep


def _metrics(losses) -> dict:
    com, tv, g_d, p, g = losses
    return {"com_loss": com, "tv_loss": tv, "g_d_loss": g_d, "p_loss": p, "g_loss": g}


def scanned_pool_step(
    states: List[TrainState],
    hr: torch.Tensor,
    lr_imgs: torch.Tensor,
    lr: float,
    extractor: Optional[nn.Module] = None,
    p_weight: float = 0.0,
) -> Tuple[List[TrainState], dict]:
    """One pixel update of every member on one batch (the pool's pixel
    phase), with the perceptual term where ``extractor`` is given.
    ``metrics["packed"]`` is (5, N)."""
    losses, _ = _scan_pool_update(states, hr, lr_imgs, lr, extractor=extractor,
                                  p_weight=p_weight)
    metrics = _metrics(losses)
    metrics["packed"] = pack_metrics(metrics, group=states[0].group)
    return states, metrics


def scanned_pool_gan_step(
    states: List[TrainState],
    d_state: TrainState,
    hr: torch.Tensor,
    lr_imgs: torch.Tensor,
    gan_mask,
    g_lr: float,
    d_lr: float,
    d_target_idx: int = 0,
    extractor: Optional[nn.Module] = None,
    p_weight: float = 0.0,
) -> Tuple[List[TrainState], TrainState, dict]:
    """The member loop against the pre-update D, then the one D update on
    member ``d_target_idx``'s pre-update SR. ``gan_mask``: (N,) host floats,
    1 where the member takes the adversarial term. D(hr) is computed once,
    with its graph for D's loss; the members read it detached. The
    perceptual term as in :func:`scanned_pool_step`. ``metrics["packed"]``
    is the flat (5N + 1,) vector, ``d_loss`` last."""
    real_preds = d_state.model(hr)
    losses, sr_d = _scan_pool_update(states, hr, lr_imgs, g_lr, d_state.model,
                                     real_preds.detach(), gan_mask, d_target_idx,
                                     extractor, p_weight)
    with span("step.d"):
        d_state, d_metrics = discriminator_step_on_sr(d_state, hr, sr_d, d_lr,
                                                      real_preds=real_preds)
    metrics = {**_metrics(losses), "d_loss": d_metrics["d_loss"]}
    metrics["packed"] = pack_metrics(metrics, d_metrics["d_loss"], states[0].group)
    return states, d_state, metrics


def _member_perceptual(srs, f_real: dict, extractor: nn.Module) -> torch.Tensor:
    """``perceptual_term`` of each member's SR, (N,): the extractor runs once
    on the N·B images (its features of a member's images are those it gives
    them alone), each tap's mean taken over the member's slice."""
    n = srs.shape[0]
    f_fake = extractor(srs.flatten(0, 1))
    p = torch.zeros(n, device=srs.device)
    for key in f_real:
        diff = f_fake[key].unflatten(0, (n, -1)) - f_real[key]
        p = p + diff.abs().flatten(1).mean(1)
    return p


def _vmap_pool_update(states: Sequence[TrainState], hr, lr_imgs, g_lr: float,
                      d_model: Optional[nn.Module] = None, d_real=None,
                      gan_mask=None, d_target_idx: int = 0,
                      extractor: Optional[nn.Module] = None, p_weight: float = 0.0):
    """All members in one differentiated region (see the module docstring),
    then each member's Adam step. Arguments and returns as
    ``_scan_pool_update``'s."""
    n = len(states)
    model = states[0].model
    model.train()
    names = [name for name, _ in model.named_parameters()]
    with torch.no_grad():
        stacked = [torch.stack([st.params[j] for st in states]).requires_grad_()
                   for j in range(len(names))]
    mask = torch.as_tensor(np.zeros(n) if gan_mask is None else np.asarray(gan_mask),
                           dtype=torch.float32, device=hr.device)
    group = states[0].group
    zero = torch.zeros((), device=hr.device)

    def one(params, m):
        sr = torch.func.functional_call(model, dict(zip(names, params)), (lr_imgs,))
        com, tv, _ = ReconstructionLoss.apply(hr, sr, group)
        g_d = zero if d_model is None else generator_adversarial_loss(d_real, d_model(sr))
        return com + tv + m * g_d, com, tv, g_d, sr

    loss, com, tv, g_d, srs = torch.func.vmap(one)(stacked, mask)
    p = torch.zeros(n, device=hr.device)
    if extractor is not None:
        p = _member_perceptual(srs, real_features(extractor, hr), extractor)
        loss = loss + p_weight * p
    grads = torch.autograd.grad(loss.sum(), stacked)
    for i, st in enumerate(states):
        st.apply_gradients([g[i] for g in grads], g_lr)
    losses = tuple(x.detach() for x in (com, tv, g_d, p, loss))
    return losses, srs[d_target_idx].detach()


def stacked_pool_step(
    states: List[TrainState],
    hr: torch.Tensor,
    lr_imgs: torch.Tensor,
    lr: float,
    extractor: Optional[nn.Module] = None,
    p_weight: float = 0.0,
    d_target_idx: int = 0,
    return_sr: bool = False,
) -> Tuple[List[TrainState], dict]:
    """The vmap executor's pixel update of every member on one batch, with
    the perceptual term where ``extractor`` is given. ``metrics["packed"]``
    is (5, N); ``return_sr`` adds ``metrics["sr"]``, member
    ``d_target_idx``'s pre-update SR."""
    with span("step.pool"):
        losses, sr = _vmap_pool_update(states, hr, lr_imgs, lr, d_target_idx=d_target_idx,
                                       extractor=extractor, p_weight=p_weight)
    metrics = _metrics(losses)
    metrics["packed"] = pack_metrics(metrics, group=states[0].group)
    if return_sr:
        metrics["sr"] = sr
    return states, metrics


def stacked_pool_gan_step(
    states: List[TrainState],
    d_state: TrainState,
    hr: torch.Tensor,
    lr_imgs: torch.Tensor,
    gan_mask,
    g_lr: float,
    d_lr: float,
    d_target_idx: int = 0,
    extractor: Optional[nn.Module] = None,
    p_weight: float = 0.0,
) -> Tuple[List[TrainState], TrainState, dict]:
    """:func:`scanned_pool_gan_step` through the vmap executor: every member
    reads the pre-update D (D(hr) once, with its graph for D's loss; the
    members read it detached), then the one D update on member
    ``d_target_idx``'s pre-update SR."""
    real_preds = d_state.model(hr)
    with span("step.pool"):
        losses, sr_d = _vmap_pool_update(states, hr, lr_imgs, g_lr, d_state.model,
                                         real_preds.detach(), gan_mask, d_target_idx,
                                         extractor, p_weight)
    with span("step.d"):
        d_state, d_metrics = discriminator_step_on_sr(d_state, hr, sr_d, d_lr,
                                                      real_preds=real_preds)
    metrics = {**_metrics(losses), "d_loss": d_metrics["d_loss"]}
    metrics["packed"] = pack_metrics(metrics, d_metrics["d_loss"], states[0].group)
    return states, d_state, metrics
