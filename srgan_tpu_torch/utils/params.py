"""The weight bridges: the flax param tree of
``srgan_tpu.models.srresnet.SRResNet`` ↔ this port's ``state_dict``, the
discriminator's (``Conv_i`` ↔ ``convs.i``), and the JAX residual tower's
``TowerParams`` ↔ the port's (at the end).

Conv kernels are HWIO in flax and OIHW in torch. Names map as:

  ``Conv_0``                               ↔ ``stem``
  ``ResidualBlock_i/Conv_0``, ``/Conv_1``  ↔ ``blocks.i.conv1``, ``.conv2``
  ``ResidualBlock_i/GroupNorm_0``, ``_1``  ↔ ``blocks.i.norm1``, ``.norm2``
  ``Conv_1``                               ↔ ``mid``
  ``Conv_{2+j}``, j < log2(r)              ↔ ``upsample.j``
  ``Conv_{2+log2(r)}``                     ↔ ``tail``

(the flax names are pinned at ``srgan_tpu/models/srresnet.py:195-204``;
every head builds log2(r) upsample convs and one tail conv). The tree is
plain numpy (``jax.device_get(params)``): this module imports no JAX.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_CONV = re.compile(r"Conv_(\d+)$")


def _conv_name(flax_idx: int, num_upsample: int) -> str:
    if flax_idx == 0:
        return "stem"
    if flax_idx == 1:
        return "mid"
    if flax_idx < 2 + num_upsample:
        return f"upsample.{flax_idx - 2}"
    return "tail"


def _num_upsample(tree: Mapping) -> int:
    convs = [int(m.group(1)) for k in tree if (m := _CONV.match(k))]
    return max(convs) - 2  # Conv_0 stem, Conv_1 mid, the last one the tail


def from_jax_params(tree: Mapping) -> Dict[str, torch.Tensor]:
    """flax param tree (nested dicts of arrays) → torch ``state_dict``."""
    n_up = _num_upsample(tree)
    sd: Dict[str, torch.Tensor] = {}

    def conv(prefix, leaf):
        k = np.asarray(leaf["kernel"], np.float32)
        sd[f"{prefix}.weight"] = torch.from_numpy(
            np.ascontiguousarray(k.transpose(3, 2, 0, 1))
        )
        sd[f"{prefix}.bias"] = torch.from_numpy(
            np.asarray(leaf["bias"], np.float32).copy()
        )

    for name, leaf in tree.items():
        if m := _CONV.match(name):
            conv(_conv_name(int(m.group(1)), n_up), leaf)
            continue
        i = int(name.rsplit("_", 1)[1])  # ResidualBlock_i
        for sub, sub_leaf in leaf.items():
            j = int(sub.rsplit("_", 1)[1]) + 1
            if sub.startswith("Conv_"):
                conv(f"blocks.{i}.conv{j}", sub_leaf)
            else:  # GroupNorm_k
                for flax_key, torch_key in (("scale", "weight"), ("bias", "bias")):
                    sd[f"blocks.{i}.norm{j}.{torch_key}"] = torch.from_numpy(
                        np.asarray(sub_leaf[flax_key], np.float32).copy()
                    )
    return sd


def to_jax_params(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """torch ``state_dict`` → flax param tree of numpy arrays (the inverse
    of :func:`from_jax_params`)."""
    n_up = 1 + max(
        (int(k.split(".")[1]) for k in state_dict if k.startswith("upsample.")),
        default=-1,
    )
    names = {"stem": "Conv_0", "mid": "Conv_1", "tail": f"Conv_{2 + n_up}"}
    names.update({f"upsample.{j}": f"Conv_{2 + j}" for j in range(n_up)})
    tree: dict = {}
    for key, value in state_dict.items():
        arr = value.detach().cpu().numpy().astype(np.float32)
        prefix, param = key.rsplit(".", 1)
        if prefix.startswith("blocks."):
            _, i, mod = prefix.split(".")
            node = tree.setdefault(f"ResidualBlock_{i}", {})
            kind, j = mod[:-1], int(mod[-1]) - 1
            sub = node.setdefault(
                f"Conv_{j}" if kind == "conv" else f"GroupNorm_{j}", {}
            )
        else:
            kind = "conv"
            sub = tree.setdefault(names[prefix], {})
        if kind == "conv":
            sub["kernel" if param == "weight" else "bias"] = (
                arr.transpose(2, 3, 1, 0) if param == "weight" else arr
            )
        else:
            sub["scale" if param == "weight" else "bias"] = arr
    return tree


def discriminator_from_jax_params(tree: Mapping) -> Dict[str, torch.Tensor]:
    """flax param tree of ``srgan_tpu.models.discriminator.Discriminator``
    → the port's ``state_dict``: ``Conv_i`` ↔ ``convs.i`` (its GroupNorms
    have no parameters)."""
    sd: Dict[str, torch.Tensor] = {}
    for name, leaf in tree.items():
        i = int(_CONV.match(name).group(1))
        k = np.asarray(leaf["kernel"], np.float32)
        sd[f"convs.{i}.weight"] = torch.from_numpy(
            np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
        sd[f"convs.{i}.bias"] = torch.from_numpy(
            np.asarray(leaf["bias"], np.float32).copy())
    return sd


def discriminator_to_jax_params(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The port's discriminator ``state_dict`` → flax param tree of numpy
    arrays (the inverse of :func:`discriminator_from_jax_params`)."""
    tree: dict = {}
    for key, value in state_dict.items():
        _, i, param = key.split(".")  # convs.i.weight | convs.i.bias
        arr = value.detach().cpu().numpy().astype(np.float32)
        tree.setdefault(f"Conv_{i}", {})[
            "kernel" if param == "weight" else "bias"
        ] = arr.transpose(2, 3, 1, 0) if param == "weight" else arr
    return tree


_TOWER_FIELDS = ("w1", "s1", "b1", "w2", "s2", "b2")


def tower_params_from_jax(tree):
    """JAX ``TowerParams`` fields (numpy, from ``jax.device_get``; a
    NamedTuple or a mapping) → the port's ``TowerParams``. Both keep conv
    weights in HWIO, so the arrays cross unchanged."""
    from srgan_tpu_torch.ops.cuda.residual_tower_kernel import TowerParams

    get = tree.__getitem__ if isinstance(tree, Mapping) else tree.__getattribute__
    return TowerParams(*(
        torch.from_numpy(np.array(get(k), dtype=np.float32)) for k in _TOWER_FIELDS
    ))


def tower_params_to_jax(params) -> dict:
    """The port's ``TowerParams`` → ``{field: numpy array}``, the inverse of
    :func:`tower_params_from_jax` (``TowerParams(**d)`` on the JAX side)."""
    return {
        k: getattr(params, k).detach().cpu().numpy().astype(np.float32)
        for k in _TOWER_FIELDS
    }
