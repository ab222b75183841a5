"""Load reference PyTorch SRResNet checkpoints into the port's ``SRResNet``,
the counterpart of ``srgan_tpu/utils/torch_port.py``.

The reference saves torch ``state_dict``s (``src/train.py:123-125``) and its
eval reloads them with DDP-prefix stripping (``src/evaluation.py:26-31``):

  - the reference's BatchNorm layers (``src/models.py:16,19``) are **folded
    into the preceding convs**: in eval mode BN is the per-channel affine
    y = (x − μ)·γ/√(σ²+ε) + β, which composes exactly with the conv that
    produces x. The result is the ``norm="none"``, ``head="reference"``
    SRResNet, equal to the torch model in eval mode up to fp32 rounding;
  - the conv kernels stay OIHW, the port's layout and the reference's;
  - a "module." DDP prefix is stripped, as the reference does.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from srgan_tpu_torch.config import ModelConfig


def _fold_bn(conv_w, conv_b, bn_gamma, bn_beta, bn_mean, bn_var, eps=1e-5):
    """Fold an eval-mode BatchNorm into the preceding conv (OIHW)."""
    inv = bn_gamma / torch.sqrt(bn_var + eps)
    return conv_w * inv[:, None, None, None], (conv_b - bn_mean) * inv + bn_beta


def port_torch_srresnet(
    state_dict: Dict[str, torch.Tensor],
    num_residuals: int | None = None,
) -> Tuple[ModelConfig, Dict[str, torch.Tensor]]:
    """Reference SRResNet ``state_dict`` → (ModelConfig, the port's
    ``state_dict``).

    Expects the reference's module names (``src/models.py:44-87``):
    ``conv1``, ``residual_blocks.{i}.{conv1,bn1,conv2,bn2}``, ``conv2``,
    ``upsample.{0,3,...}`` (convs at stride-3 positions in the Sequential),
    ``conv3``; a DDP ``module.`` prefix is stripped.
    """
    sd = {
        (k[7:] if k.startswith("module.") else k):  # evaluation.py:26-29
        torch.as_tensor(v).detach().to("cpu", torch.float32)
        for k, v in state_dict.items()
    }
    if num_residuals is None:
        num_residuals = 1 + max(
            (int(k.split(".")[1]) for k in sd if k.startswith("residual_blocks.")),
            default=-1,
        )

    out: Dict[str, torch.Tensor] = {}

    def conv(src, dst):
        out[f"{dst}.weight"] = sd[f"{src}.weight"].clone()
        out[f"{dst}.bias"] = sd[f"{src}.bias"].clone()

    def conv_bn(src, bn, dst):
        out[f"{dst}.weight"], out[f"{dst}.bias"] = _fold_bn(
            sd[f"{src}.weight"], sd[f"{src}.bias"],
            sd[f"{bn}.weight"], sd[f"{bn}.bias"],
            sd[f"{bn}.running_mean"], sd[f"{bn}.running_var"],
        )

    conv("conv1", "stem")
    for i in range(num_residuals):
        base = f"residual_blocks.{i}"
        conv_bn(f"{base}.conv1", f"{base}.bn1", f"blocks.{i}.conv1")
        conv_bn(f"{base}.conv2", f"{base}.bn2", f"blocks.{i}.conv2")
    conv("conv2", "mid")
    # upsample convs: Sequential indices 0, 3, 6, ... (conv, shuffle, relu)
    up_indices = sorted(
        int(k.split(".")[1]) for k in sd
        if k.startswith("upsample.") and k.endswith(".weight")
    )
    for j, idx in enumerate(up_indices):
        conv(f"upsample.{idx}", f"upsample.{j}")
    conv("conv3", "tail")

    cfg = ModelConfig(
        in_channels=sd["conv1.weight"].shape[1],
        num_features=sd["conv1.weight"].shape[0],
        num_residuals=num_residuals,
        upscale_factor=2 ** len(up_indices),
        norm="none",          # BN folded into the convs
        head="reference",     # post-shuffle conv9x9 tail, like the .pth
    )
    return cfg, out


def load_torch_checkpoint(path: str, num_residuals: int | None = None):
    """Read a reference ``.pth`` file and port it. Returns (ModelConfig,
    state_dict) for ``SRResNet.from_config(cfg).load_state_dict``."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    return port_torch_srresnet(state, num_residuals=num_residuals)
