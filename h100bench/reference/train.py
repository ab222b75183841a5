"""Plain fp32 training steps: the pixel step, the pool of generators with
its GAN gate and shared discriminator, Adam, and the epoch end's mutual
learning.

Adam (Kingma & Ba) with bias-corrected moments and eps added outside the
square root, the reference's ``optim.Adam`` (``src/train.py:61-62``).

The pool (``readme.md:1-17``): every batch each member takes one update,
pixel (edge L1 + TV) or GAN (the same plus the generator's adversarial term
against the discriminator before its update); the discriminator then takes
one update on the leader's pre-update SR. A member's GAN draw is a uniform
below its probability: ``p_gan_above`` while the gate's threshold is not
yet calibrated (the first epoch) and the member's running loss is known,
else 0; one ``rng.random(N)`` a batch from ``default_rng(seed)``. Losses
reach the gate one batch late (batch k's draw sees losses through batch
k − 2). At an epoch end the members are sorted by running loss, ascending,
and every member after the first moves toward it:
``p ← α·p_first + (1 − α)·p`` (``src/utils.py:113-115``).

Data parallel over P ranks (``shards``, the pixel phase): the loss is the
global batch's, its edge statistics and sums over all rows, and its
gradient is worked out one rank's rows at a time and summed, so that no
pass holds more rows than one rank's; every rank takes the one Adam step
on that sum.

The generator is the configuration's architecture (``arch/``).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from h100bench import arch
from h100bench.reference import loss as L
from h100bench.reference import model as M

Params = Dict[str, torch.Tensor]


class Adam:
    def __init__(self, params: Params, lr: float, b1: float, b2: float, eps: float = 1e-8):
        self.p = params
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Params) -> None:
        self.t += 1
        for k, g in grads.items():
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            mhat = self.m[k] / (1 - self.b1 ** self.t)
            vhat = self.v[k] / (1 - self.b2 ** self.t)
            self.p[k].sub_(self.lr * mhat / (vhat.sqrt() + self.eps))


def _grads(loss: torch.Tensor, params: Params) -> Params:
    keys = list(params)
    return dict(zip(keys, torch.autograd.grad(loss, [params[k] for k in keys])))


def trainable(params: Params) -> Params:
    return {k: v.detach().clone().float().requires_grad_() for k, v in params.items()}


class Record:
    """What the comparison reads of a run of steps: each step's losses,
    GAN draws, LR batch and every network's gradient; the params after
    the first ``least`` steps; and for each member's first GAN update, its
    step, the member's and the discriminator's params before it, the LR
    batch and the member's gradient (``gan``)."""

    def __init__(self):
        self.losses: List[List[float]] = []
        self.grads: List[List[Params]] = []
        self.lr_batches: List[torch.Tensor] = []
        self.masks: List[np.ndarray] = []
        self.after_least: List[Params] = []
        self.gan: List[dict] = []

    @property
    def first_grads(self) -> List[Params]:
        return self.grads[0]


def gan_draws(cfg: dict, n: int, seed: int):
    """Each batch's GAN draws of the first epoch, (n,) floats: 0 until the
    members' losses have reached the gate (two batches), then a uniform
    below ``p_gan_above``."""
    p_cfg = cfg.get("pool", {})
    rng = np.random.default_rng(seed)
    k = 0
    while True:
        probs = np.full(n, p_cfg["p_gan_above"] if k >= 2 else 0.0)
        yield (rng.random(n) < probs).astype(np.float32)
        k += 1


def enough(masks: Sequence[np.ndarray], least: int, gan: bool) -> bool:
    """Whether the steps so far are all that is compared: at least
    ``least`` of them, and with a discriminator a GAN update of every
    member among them."""
    if len(masks) < least:
        return False
    return not gan or bool(np.all(np.sum(masks, axis=0) > 0))


def member_loss(cfg: dict, params: Params, hr, lr, edges, d_params=None, real=None,
                quant=None):
    """(loss, SR) of one generator's update: the reconstruction loss, plus
    the adversarial term against ``d_params`` where that is given (a GAN
    update; ``real`` is D(hr), held fixed)."""
    sr = arch.load(cfg["model"]).forward(params, lr, cfg["model"], quant)
    l1, tv = L.reconstruction(hr, sr, edges)
    loss = l1 + tv
    if d_params is not None:
        fake = M.discriminator(d_params, sr, cfg["discriminator"], quant)
        loss = loss + L.generator_adversarial(real, fake)
    return loss, sr


def sharded_loss_grads(cfg: dict, params: Params, hr, lr, edges, shards: int,
                       quant=None) -> tuple:
    """(loss, gradient) of one generator's pixel update on the global batch
    (``hr``, ``lr``, ``edges`` over every row), ``shards`` blocks of rows
    at a time: a pass without a graph for the global sums (the TV term's
    relu needs its sign), then each block's share of the loss's gradient,
    summed."""
    m = cfg["model"]
    forward = arch.load(m).forward
    blocks = [slice(s * (len(hr) // shards), (s + 1) * (len(hr) // shards))
              for s in range(shards)]
    e_sum, count = edges.double().sum(), edges.numel()
    with torch.no_grad():
        parts = [L.reconstruction_sums(hr[b], forward(params, lr[b], m, quant), edges[b])
                 for b in blocks]
    l1_sum, tv_sum = (sum(p[i] for p in parts) for i in (0, 1))
    loss = (l1_sum / e_sum).float() + torch.relu(tv_sum / count).float()
    tv_on = float(tv_sum > 0)
    grads = None
    for b in blocks:
        l1_b, tv_b = L.reconstruction_sums(hr[b], forward(params, lr[b], m, quant), edges[b])
        g = _grads((l1_b / e_sum + tv_on * tv_b / count).float(), params)
        grads = g if grads is None else {k: grads[k] + g[k] for k in g}
    return loss, grads


def gan_grad(cfg: dict, params: Params, d_params: Params, hr, lr, quant=None) -> Params:
    """A generator's gradient of its GAN update from ``params`` against
    ``d_params``."""
    real = M.discriminator(d_params, hr, cfg["discriminator"], quant).detach()
    loss, _ = member_loss(cfg, params, hr, lr, L.edge_map(hr), d_params, real, quant)
    return {k: v.detach() for k, v in _grads(loss, params).items()}


def _clone(params: Params) -> Params:
    return {k: v.detach().clone() for k, v in params.items()}


def run_steps(cfg: dict, members: Sequence[Params], d_params, batches, seed: int,
              quant=None, least=None, shards: int = 1) -> tuple:
    """Train ``members`` (and the discriminator ``d_params`` where the
    configuration has one) on ``batches``, an iterable of (hr, lr) pairs,
    from the first step of the first epoch: all of them, or with ``least``
    only until ``enough``. ``shards``: the ranks that share each global
    batch (module docstring). Returns (members, d_params, Record), the
    params updated in place."""
    t_cfg, d_cfg = cfg["train"], cfg.get("discriminator")
    use_gan = bool(t_cfg.get("use_gan"))
    n = len(members)
    if use_gan and n == 1:
        raise NotImplementedError("the fused one-generator GAN step has no reference here")
    if use_gan and shards > 1:
        raise NotImplementedError("the GAN phase over several ranks has no reference here")
    opt = [Adam(p, t_cfg["lr_generator"], t_cfg["adam_b1"], t_cfg["adam_b2"]) for p in members]
    d_opt = (Adam(d_params, t_cfg["lr_discriminator"], t_cfg["adam_b1"], t_cfg["adam_b2"])
             if use_gan else None)
    draws = gan_draws(cfg, n, seed)
    rec = Record()
    for hr, lr in batches:
        rec.lr_batches.append(lr)
        mask = next(draws) if use_gan else np.zeros(n, np.float32)
        seen = np.sum(rec.masks, axis=0) if rec.masks else np.zeros(n)
        rec.masks.append(mask)
        edges = L.edge_map(hr)
        real = M.discriminator(d_params, hr, d_cfg, quant).detach() if use_gan else None
        d_before = _clone(d_params) if use_gan and mask.any() else None
        step_losses, grads_all, sr_lead = [], [], None
        for i, p in enumerate(members):
            before = _clone(p) if mask[i] and not seen[i] else None
            if shards > 1:
                loss, g = sharded_loss_grads(cfg, p, hr, lr, edges, shards, quant)
                sr = None
            else:
                loss, sr = member_loss(cfg, p, hr, lr, edges, d_params if mask[i] else None,
                                       real, quant)
                g = _grads(loss, p)
            opt[i].step(g)
            grads_all.append(g)
            step_losses.append(float(loss.detach()))
            if before is not None:
                rec.gan.append(dict(step=len(rec.masks) - 1, member=i, params=before,
                                    d_params=d_before, lr=lr, grad=g))
            if i == 0 and use_gan:
                sr_lead = sr.detach()
        if use_gan:
            d_loss = L.discriminator_adversarial(M.discriminator(d_params, hr, d_cfg, quant),
                                                 M.discriminator(d_params, sr_lead, d_cfg, quant))
            gd = _grads(d_loss, d_params)
            d_opt.step(gd)
            grads_all.append(gd)
            step_losses.append(float(d_loss.detach()))
        rec.losses.append(step_losses)
        rec.grads.append([{k: v.detach() for k, v in g.items()} for g in grads_all])
        if len(rec.losses) == least:
            rec.after_least = [_clone(p) for p in list(members) + ([d_params] if use_gan else [])]
        if least is not None and enough(rec.masks, least, use_gan):
            break
    return members, d_params, rec


@torch.no_grad()
def mutual_learning(members: Sequence[Params], running_loss, alpha: float) -> List[Params]:
    """The epoch end: sort ascending by running loss, then every member
    after the first moves toward it."""
    order = np.argsort(np.asarray(running_loss))
    out = [dict(members[int(i)]) for i in order]
    lead = out[0]
    for m in out[1:]:
        for k in m:
            m[k] = alpha * lead[k] + (1 - alpha) * m[k]
    return out
