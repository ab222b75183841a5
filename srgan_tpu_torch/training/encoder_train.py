"""Contrastive training of the image encoder (alignment + uniformity), the
counterpart of ``srgan_tpu/training/encoder_train.py``: the perceptual prior
the reference only planned (its ``uniformity_loss``, ``src/utils.py:118-137``,
is dead code upstream). Two augmented views of each image, alignment pulls
them together, the ported uniformity term spreads the batch over the
sphere; the result is the ``.npz`` that ``train --perceptual-encoder`` and
``eval --perceptual-metric`` read. Entry point: ``python -m
srgan_tpu_torch.cli train-encoder``.

The corpus is decoded once on the host and uploaded as uint8; each step's
batch is gathered, cropped, flipped and jittered on the device. The views'
random draws come from an explicit ``torch.Generator`` on the device
(:func:`draw_views`) and are applied by :func:`apply_view`, so a test can
inject the JAX package's draws (torch cannot reproduce ``jax.random``).
"""

from __future__ import annotations

import os
import sys
import time
from typing import Sequence

import numpy as np
import torch

from srgan_tpu_torch.data.dataset import list_image_files, load_hr_clip_u8
from srgan_tpu_torch.models.encoder import alignment_loss, init_encoder, save_encoder_npz
from srgan_tpu_torch.ops.gan_loss import uniformity_loss
from srgan_tpu_torch.training.train_state import TrainState
from srgan_tpu_torch.utils.platform import disable_tf32, make_deterministic, resolve_device


def load_corpus(folder: str, load_size: int) -> np.ndarray:
    """Every readable image of ``folder`` decoded and resized to
    (load_size, load_size), (N, S, S, 3) uint8."""
    imgs = []
    for f in list_image_files(folder):
        img = load_hr_clip_u8(os.path.join(folder, f), (load_size, load_size))
        if img is not None:
            imgs.append(img)
    if not imgs:
        raise FileNotFoundError(f"no readable images in {folder}")
    return np.stack(imgs)


def draw_views(n: int, size: int, crop: int, generator: torch.Generator) -> tuple:
    """The random draws of two views of ``n`` images of ``size``², as JAX's
    ``two_views`` makes them: per view and image a crop offset in
    [0, size − crop], an H and a W flip, brightness U(−0.15, 0.15),
    contrast U(0.8, 1.2) and unit Gaussian noise of the crop's shape. On
    ``generator``'s device."""
    dev = generator.device

    def one():
        return {
            "oy": torch.randint(0, size - crop + 1, (n,), generator=generator, device=dev),
            "ox": torch.randint(0, size - crop + 1, (n,), generator=generator, device=dev),
            "flip": torch.rand((n, 2), generator=generator, device=dev) < 0.5,
            "brightness": torch.empty(n, device=dev).uniform_(-0.15, 0.15,
                                                              generator=generator),
            "contrast": torch.empty(n, device=dev).uniform_(0.8, 1.2, generator=generator),
            "noise": torch.randn((n, crop, crop, 3), generator=generator, device=dev),
        }

    return one(), one()


def apply_view(imgs_u8: torch.Tensor, draws: dict, crop: int) -> torch.Tensor:
    """One view of (N, S, S, 3) uint8 images under given draws: the crop,
    /255, the flips, ``(x − 0.5)·contrast + 0.5 + brightness``, + 0.02·noise,
    clipped to [0, 1] (JAX's ``one_view``, in its order)."""
    n, dev = imgs_u8.shape[0], imgs_u8.device
    ar = torch.arange(crop, device=dev)
    rows = (draws["oy"][:, None] + ar)[:, :, None]
    cols = (draws["ox"][:, None] + ar)[:, None, :]
    x = imgs_u8[torch.arange(n, device=dev)[:, None, None], rows, cols].float() / 255.0
    fh = draws["flip"][:, 0].view(n, 1, 1, 1)
    fw = draws["flip"][:, 1].view(n, 1, 1, 1)
    x = torch.where(fh, x.flip(1), x)
    x = torch.where(fw, x.flip(2), x)
    c = draws["contrast"].view(n, 1, 1, 1)
    b = draws["brightness"].view(n, 1, 1, 1)
    x = (x - 0.5) * c + 0.5 + b
    x = x + 0.02 * draws["noise"]
    return x.clamp(0.0, 1.0)


def two_views(imgs_u8: torch.Tensor, crop: int, generator: torch.Generator) -> tuple:
    """Two independently augmented views of each image."""
    d1, d2 = draw_views(imgs_u8.shape[0], imgs_u8.shape[1], crop, generator)
    return apply_view(imgs_u8, d1, crop), apply_view(imgs_u8, d2, crop)


def encoder_train_step(state: TrainState, v1: torch.Tensor, v2: torch.Tensor,
                       lr: float, unif_weight: float = 1.0) -> tuple:
    """One update of ``align + unif_weight · unif``, ``unif`` the mean of
    the two views' uniformity losses. Returns ``(state, loss, align, unif)``,
    the losses as device scalars."""
    model = state.model
    z1, z2 = model.embed(v1), model.embed(v2)
    align = alignment_loss(z1, z2)
    unif = 0.5 * (uniformity_loss(z1) + uniformity_loss(z2))
    loss = align + unif_weight * unif
    grads = torch.autograd.grad(loss, state.params)
    state.apply_gradients(grads, lr)
    return state, loss.detach(), align.detach(), unif.detach()


def train_contrastive_encoder(
    data_dir: str,
    out_path: str,
    *,
    steps: int = 1500,
    batch: int = 32,
    crop: int = 96,
    load_size: int = 160,
    features: Sequence[int] = (32, 64, 128),
    embed_dim: int = 128,
    lr: float = 1e-3,
    unif_weight: float = 1.0,
    seed: int = 0,
    verbose: bool = True,
    device=None,
) -> dict:
    """Train the encoder on ``data_dir`` and write the ``.npz`` archive; the
    card unless ``device`` says otherwise. Returns the summary the CLI
    prints (``loss0`` / ``lossN`` / ``align`` / ``unif`` / ``wall_s`` …)."""
    if steps < 1:
        # never write a random-weight archive that looks like a trained prior
        raise ValueError(f"steps must be >= 1, got {steps}")
    dev = resolve_device(device)
    disable_tf32()  # f32 means f32 here too: no Trainer turns it off
    make_deterministic()
    corpus = load_corpus(data_dir, load_size)
    if verbose:
        print(f"corpus: {len(corpus)} images @ {load_size}px", file=sys.stderr)
    corpus_dev = torch.from_numpy(corpus).to(dev)
    state = TrainState(init_encoder(seed, features, embed_dim, device=dev))
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    t0 = time.perf_counter()
    loss0 = None
    for step in range(steps):
        idx = rng.choice(len(corpus), size=batch, replace=len(corpus) < batch)
        v1, v2 = two_views(corpus_dev[torch.from_numpy(idx).to(dev)], crop, gen)
        state, loss, align, unif = encoder_train_step(state, v1, v2, lr, unif_weight)
        if step == 0:
            loss0 = float(loss)
        if verbose and step % 100 == 0:
            print(f"step {step}: loss={float(loss):.4f} align={float(align):.4f} "
                  f"unif={float(unif):.4f}", file=sys.stderr, flush=True)
    save_encoder_npz(state.model, out_path)
    return {
        "out": out_path,
        "steps": steps,
        "images": len(corpus),
        "loss0": loss0,
        "lossN": float(loss),
        "align": float(align),
        "unif": float(unif),
        "wall_s": round(time.perf_counter() - t0, 1),
    }
