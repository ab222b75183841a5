"""models of the PyTorch port (see srgan_tpu_torch/__init__.py); the
generator a ``ModelConfig`` names under ``generator``."""

from __future__ import annotations

from typing import Optional

import torch

from srgan_tpu_torch.config import ModelConfig

ARCHS = ("srresnet", "swinir")


def _check(cfg: ModelConfig) -> None:
    if cfg.generator not in ARCHS:
        raise ValueError(f"generator must be one of {ARCHS}, got {cfg.generator!r}")


def generator_from_config(cfg: ModelConfig) -> torch.nn.Module:
    """The generator ``cfg.generator`` names, uninitialised."""
    _check(cfg)
    if cfg.generator == "swinir":
        from srgan_tpu_torch.models.swinir import SwinIR

        return SwinIR.from_config(cfg)
    from srgan_tpu_torch.models.srresnet import SRResNet

    return SRResNet.from_config(cfg)


def init_generator(cfg: ModelConfig, seed: int = 0,
                   device: Optional[torch.device] = None) -> torch.nn.Module:
    """The generator ``cfg.generator`` names, with random weights made from
    ``seed`` by its own initialisers (``srresnet.init_generator``,
    ``swinir.init_swinir``)."""
    _check(cfg)
    if cfg.generator == "swinir":
        from srgan_tpu_torch.models.swinir import init_swinir

        return init_swinir(cfg, seed, device)
    from srgan_tpu_torch.models.srresnet import init_generator as init_srresnet

    return init_srresnet(cfg, seed, device)
