"""VGG19 feature extractor for the perceptual loss, the counterpart of
``srgan_tpu/models/vgg.py`` (reference ``src/models.py:123-151``; the loss
``src/utils.py:154-166``).

torchvision's ``vgg19().features`` trunk, NHWC in and NHWC feature maps
out, like the port's other models; inside it runs NCHW. The compute is
f32 whatever the generator's dtype: the input is cast to f32 (a bf16 run's
SR included), as the JAX module does. Only the convs up to the deepest
requested tap are built (the reference's early exit). Each conv is named
``conv_{idx}`` after its index in torchvision's ``nn.Sequential``, so the
``state_dict`` reads ``conv_0.weight`` where torchvision's reads
``features.0.weight``; the post-ReLU index names a tap (``conv3_3`` is 17).

Weights: an ``.npz`` in the JAX package's archive format (``conv_k.kernel``
HWIO, ``conv_k.bias``), so each package reads the other's; else a cached
torchvision ``vgg19*.pth``; else random weights, with the JAX package's
``RuntimeWarning``. The extractor is frozen: its parameters take no
gradient, as JAX differentiates the generator's only.
"""

from __future__ import annotations

import os
import warnings
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from srgan_tpu_torch.models.srresnet import _init_like_flax
from srgan_tpu_torch.utils.params import vgg_from_jax_params, vgg_to_jax_params

# torchvision vgg19.features post-ReLU indices → canonical names
# (reference ``src/models.py:127-133``)
LAYER_NAME_MAPPING = {
    3: "conv1_2",
    8: "conv2_2",
    17: "conv3_3",
    26: "conv4_3",
    35: "conv5_3",
}

# VGG19 ``features``: conv channel counts, "M" = 2x2 max pool
_VGG19_CFG = (
    64, 64, "M",
    128, 128, "M",
    256, 256, 256, 256, "M",
    512, 512, 512, 512, "M",
    512, 512, 512, 512, "M",
)


class VGG19Features(nn.Module):
    """The VGG19 trunk up to the deepest tap in ``layers``; ``forward``
    returns ``{name: NHWC feature map}`` in depth order."""

    def __init__(self, layers: Sequence[str] = ("conv3_3", "conv4_3")):
        super().__init__()
        wanted = set(layers)
        known = set(LAYER_NAME_MAPPING.values())
        if not wanted <= known:
            # a typo ("conv4_4") would otherwise drop out of the objective
            raise ValueError(
                f"unknown VGG19 layer name(s) {sorted(wanted - known)}; "
                f"valid: {sorted(known)}"
            )
        # the forward's plan: ("pool",) or ("conv", name, tap or None), in
        # torchvision's order, ending at the deepest wanted tap
        self._plan = []
        found = 0
        torch_idx, in_ch = 0, 3
        for item in _VGG19_CFG:
            if item == "M":
                self._plan.append(("pool", None, None))
                torch_idx += 1
                continue
            name = f"conv_{torch_idx}"
            self.add_module(name, nn.Conv2d(in_ch, int(item), 3, padding=1))
            in_ch = int(item)
            tap = LAYER_NAME_MAPPING.get(torch_idx + 1)
            tap = tap if tap in wanted else None
            self._plan.append(("conv", name, tap))
            torch_idx += 2
            found += tap is not None
            if found == len(wanted):
                break

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = x.float().permute(0, 3, 1, 2)
        features: Dict[str, torch.Tensor] = {}
        for kind, name, tap in self._plan:
            if kind == "pool":
                x = F.max_pool2d(x, 2, 2)
                continue
            x = F.relu(getattr(self, name)(x))
            if tap is not None:
                features[tap] = x.permute(0, 2, 3, 1)
        return features


def perceptual_loss(sr: torch.Tensor, hr: torch.Tensor, extractor: nn.Module) -> torch.Tensor:
    """Summed per-tap L1 distance between the features of ``sr`` and of
    ``hr`` (reference ``perceptal_loss`` [sic], ``src/utils.py:154-166``).
    Standalone form: it extracts the HR features and delegates to the
    training path's ``steps.perceptual_term``, the objective's one
    implementation."""
    from srgan_tpu_torch.training.steps import perceptual_term  # avoid a cycle

    return perceptual_term(sr, extractor(hr), extractor)


def frozen(model: nn.Module, device=None) -> nn.Module:
    """``model`` on ``device``, in eval mode, its parameters taking no
    gradient."""
    model = model.to(device) if device is not None else model
    return model.eval().requires_grad_(False)


def init_vgg_extractor(
    seed: int = 0,
    layers: Sequence[str] = ("conv3_3", "conv4_3"),
    weights_npz: Optional[str] = None,
    device=None,
) -> VGG19Features:
    """The frozen extractor, its weights from, in order: ``weights_npz`` (an
    error if given and unreadable), a cached torchvision ``vgg19*.pth`` under
    ``~/.cache/torch/hub/checkpoints``, or random weights from ``seed``
    (flax's initialisers, drawn on the CPU) with a ``RuntimeWarning``: a
    random-feature metric is not the reference's pretrained perceptual
    loss."""
    model = VGG19Features(layers)
    if weights_npz is not None:
        return frozen(load_vgg19_weights_npz(weights_npz, model), device)
    ckpt = _find_cached_torch_vgg19()
    if ckpt is not None:
        return frozen(load_torch_vgg19_weights(ckpt, model), device)
    warnings.warn(
        "perceptual loss: no pretrained VGG19 weights found (no "
        "TrainConfig.vgg_weights_npz and no torchvision cache under "
        "~/.cache/torch/hub/checkpoints) — using RANDOM feature weights. "
        "This is a different objective than the reference's pretrained "
        "perceptual loss. Export weights once with "
        "srgan_tpu_torch.models.vgg.export_torch_vgg19_to_npz() on a machine "
        "that has them, then pass --vgg-weights.",
        RuntimeWarning,
        stacklevel=2,
    )
    _init_like_flax(model, torch.Generator().manual_seed(seed))
    return frozen(model, device)


def _find_cached_torch_vgg19() -> Optional[str]:
    hub_dir = os.path.expanduser("~/.cache/torch/hub/checkpoints")
    if os.path.isdir(hub_dir):
        for f in sorted(os.listdir(hub_dir)):
            if f.startswith("vgg19") and f.endswith(".pth"):
                return os.path.join(hub_dir, f)
    return None


def save_vgg19_weights_npz(model: nn.Module, path: str) -> None:
    """The extractor's convs as the JAX package's flat ``.npz``:
    ``conv_k.kernel`` (HWIO) and ``conv_k.bias``."""
    flat = {}
    for pname, leaf in vgg_to_jax_params(model.state_dict()).items():
        flat[f"{pname}.kernel"] = leaf["kernel"]
        flat[f"{pname}.bias"] = leaf["bias"]
    np.savez(path, **flat)


def load_vgg19_weights_npz(path: str, model: VGG19Features) -> VGG19Features:
    """Load a :func:`save_vgg19_weights_npz` archive (of either package)
    into ``model``. Every conv of ``model`` must be in it with its shape:
    a partial archive would train against half-random features."""
    data = np.load(path)
    tree = {}
    for pname, conv in model.named_children():
        kkey, bkey = f"{pname}.kernel", f"{pname}.bias"
        if kkey not in data or bkey not in data:
            raise KeyError(
                f"vgg weights archive {path!r} is missing {pname} "
                f"(has: {sorted(data.files)[:6]}…) — re-export with "
                "save_vgg19_weights_npz / export_torch_vgg19_to_npz"
            )
        want = tuple(conv.weight.shape[i] for i in (2, 3, 1, 0))
        if data[kkey].shape != want:
            raise ValueError(
                f"vgg weights archive {path!r}: {pname} kernel shape "
                f"{data[kkey].shape} != expected {want} (HWIO)"
            )
        tree[pname] = {"kernel": data[kkey], "bias": data[bkey]}
    model.load_state_dict(vgg_from_jax_params(tree))
    return model


def load_torch_vgg19_weights(path: str, model: VGG19Features) -> VGG19Features:
    """Fill ``model``'s convs from a torchvision VGG19 ``state_dict``
    (``features.{idx}.weight`` / ``.bias``, OIHW as here)."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    sd = {}
    for pname, _ in model.named_children():
        idx = int(pname.split("_")[1])
        sd[f"{pname}.weight"] = state[f"features.{idx}.weight"]
        sd[f"{pname}.bias"] = state[f"features.{idx}.bias"]
    model.load_state_dict(sd)
    return model


def export_torch_vgg19_to_npz(out_path: str, torch_ckpt: Optional[str] = None) -> str:
    """One-time export: a torchvision VGG19 ``.pth`` → the ``.npz`` archive,
    every conv through ``conv5_3``."""
    ckpt = torch_ckpt or _find_cached_torch_vgg19()
    if ckpt is None:
        raise FileNotFoundError("no torchvision vgg19*.pth cache found to export")
    model = VGG19Features(layers=tuple(LAYER_NAME_MAPPING.values()))
    save_vgg19_weights_npz(load_torch_vgg19_weights(ckpt, model), out_path)
    return out_path
