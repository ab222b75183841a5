"""The contrastive image encoder, the counterpart of
``srgan_tpu/models/encoder.py``: the reference's planned perceptual prior
(``src/utils.py:118-137``), trained with alignment + uniformity by
``training/encoder_train.py`` and read by ``train --perceptual-encoder`` and
``eval --perceptual-metric`` as a trained multi-scale feature extractor.

Each stage: stride-2 conv3x3 (padding 1) → GroupNorm → LeakyReLU(0.2) →
conv3x3 → GroupNorm → LeakyReLU(0.2). As an extractor (``forward``) it
returns one NHWC tap a stage, ``stage1`` … ``stageN``, the interface of
``models/vgg.py:VGG19Features``. ``embed`` pools the deepest tap over H and
W, projects it (``proj``, flax's Dense) and L2-normalises. NHWC in, NCHW
inside, f32 compute. Traps against flax: GroupNorm's eps is 1e-6 (flax's
default), ``min(groups, f)`` groups; flax's ``padding=1`` on a stride-2
conv is torch's (both floor odd sizes the same way).

The archive is the JAX package's ``.npz``: flat ``downs_0/kernel`` (HWIO),
``gn_a_0/scale``, …, ``proj/kernel`` (Dense, (in, out)), and the
architecture as JSON in ``__meta__`` (uint8), so each package reads the
other's.
"""

from __future__ import annotations

import json
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from srgan_tpu_torch.models.srresnet import _init_like_flax
from srgan_tpu_torch.models.vgg import frozen
from srgan_tpu_torch.utils.params import encoder_from_jax_params, encoder_to_jax_params

_META_KEY = "__meta__"


class ConvEncoder(nn.Module):
    """The encoder: ``forward`` gives the extractor's taps, ``embed`` the
    contrastive embedding."""

    def __init__(self, features: Sequence[int] = (32, 64, 128),
                 group_norm_groups: int = 8, embed_dim: int = 128):
        super().__init__()
        self.features = tuple(int(f) for f in features)
        self.group_norm_groups = int(group_norm_groups)
        self.embed_dim = int(embed_dim)
        ins = (3, *self.features[:-1])
        self.downs = nn.ModuleList(
            nn.Conv2d(c, f, 3, stride=2, padding=1) for c, f in zip(ins, self.features))
        self.convs = nn.ModuleList(nn.Conv2d(f, f, 3, padding=1) for f in self.features)
        self.gn_a = nn.ModuleList(self._norm(f) for f in self.features)
        self.gn_b = nn.ModuleList(self._norm(f) for f in self.features)
        # the projection head; None in a perceptual extractor
        self.proj = nn.Linear(self.features[-1], self.embed_dim)

    def _norm(self, f: int) -> nn.GroupNorm:
        return nn.GroupNorm(min(self.group_norm_groups, f), f, eps=1e-6)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(B, H, W, 3) → ``{"stage{i}": NHWC tap}``."""
        x = x.float().permute(0, 3, 1, 2)
        taps: Dict[str, torch.Tensor] = {}
        for i in range(len(self.features)):
            x = F.leaky_relu(self.gn_a[i](self.downs[i](x)), 0.2)
            x = F.leaky_relu(self.gn_b[i](self.convs[i](x)), 0.2)
            taps[f"stage{i + 1}"] = x.permute(0, 2, 3, 1)
        return taps

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) → (B, embed_dim) L2-normalised embeddings."""
        deepest = self(x)[f"stage{len(self.features)}"]
        z = self.proj(deepest.mean((1, 2)).float())
        return z / z.norm(dim=-1, keepdim=True).clamp_min(1e-8)

    def meta(self) -> dict:
        return {"features": list(self.features), "embed_dim": self.embed_dim,
                "group_norm_groups": self.group_norm_groups}


def init_encoder(seed: int = 0, features: Sequence[int] = (32, 64, 128),
                 embed_dim: int = 128, group_norm_groups: int = 8,
                 device=None) -> ConvEncoder:
    """A fresh encoder (trunk + projection head) for contrastive training,
    flax's initialisers drawn on the CPU from ``seed``, moved to
    ``device``."""
    model = ConvEncoder(features, group_norm_groups, embed_dim)
    _init_like_flax(model, torch.Generator().manual_seed(seed))
    return model.to(device) if device is not None else model


def alignment_loss(z1: torch.Tensor, z2: torch.Tensor) -> torch.Tensor:
    """Mean squared distance between two views' embeddings (the alignment
    term paired with the reference's uniformity term, Wang & Isola's α=2)."""
    return ((z1 - z2) ** 2).sum(-1).mean()


def save_encoder_npz(model: ConvEncoder, path: str) -> None:
    """The JAX package's archive: flat ``a/b`` keys and the ``__meta__``
    architecture record."""
    flat = {f"{name}/{k}": v
            for name, leaf in encoder_to_jax_params(model.state_dict()).items()
            for k, v in leaf.items()}
    meta = np.frombuffer(json.dumps(model.meta()).encode(), dtype=np.uint8)
    np.savez(path, **flat, **{_META_KEY: meta})


def load_encoder_npz(path: str) -> ConvEncoder:
    """Rebuild the encoder from a :func:`save_encoder_npz` archive of either
    package: the trunk, and the projection head where the archive has it
    (else ``proj`` is None)."""
    data = np.load(path)
    if _META_KEY not in data.files:
        raise KeyError(
            f"encoder archive {path!r} has no {_META_KEY} record — was it "
            "written by save_encoder_npz?"
        )
    meta = json.loads(bytes(data[_META_KEY].tobytes()).decode())
    model = ConvEncoder(meta["features"], meta["group_norm_groups"], meta["embed_dim"])
    tree: dict = {}
    for key in data.files:
        if key != _META_KEY:
            name, leaf = key.split("/")
            tree.setdefault(name, {})[leaf] = data[key]
    if "proj" not in tree:
        model.proj = None
    model.load_state_dict(encoder_from_jax_params(tree))
    return model


def init_encoder_extractor(weights_npz: str, device=None) -> ConvEncoder:
    """The perceptual extractor (the counterpart of
    ``vgg.init_vgg_extractor``): a TRAINED encoder archive, frozen, without
    its projection head, which the taps never read. No random fallback: a
    missing file is an error, not a silent change of objective."""
    model = load_encoder_npz(weights_npz)
    model.proj = None
    return frozen(model, device)
