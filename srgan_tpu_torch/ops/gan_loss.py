"""Relativistic tanh-squashed adversarial losses, the counterpart of
``srgan_tpu/ops/gan_loss.py``:

  - discriminator: ``mean(tanh(fake_preds - real_preds))``
    (reference ``src/train.py:218``), minimised;
  - generator:     ``mean(tanh(real_preds - fake_preds))``
    (``src/train.py:190``, commented out there, active in the GAN phase).
"""

from __future__ import annotations

import torch


def discriminator_loss(real_preds: torch.Tensor, fake_preds: torch.Tensor) -> torch.Tensor:
    return torch.tanh(fake_preds - real_preds).mean()


def generator_adversarial_loss(real_preds: torch.Tensor,
                               fake_preds: torch.Tensor) -> torch.Tensor:
    return torch.tanh(real_preds - fake_preds).mean()


def uniformity_loss(embeddings: torch.Tensor, t: float = 2.0) -> torch.Tensor:
    """``log(mean(exp(-t·d² + 1e-7)))`` over the B(B-1)/2 unordered pairs of
    a (B, D) batch of embeddings (reference ``src/utils.py:124-137``); 0 for
    a batch of one. The squared distances come from explicit differences,
    the strict upper triangle (``torch.pdist``'s pairs)."""
    b = embeddings.shape[0]
    if b <= 1:
        return torch.zeros((), dtype=embeddings.dtype, device=embeddings.device)
    diffs = embeddings[:, None, :] - embeddings[None, :, :]
    d2 = (diffs * diffs).sum(-1)
    iu, ju = torch.triu_indices(b, b, offset=1, device=embeddings.device)
    return torch.log(torch.exp(-t * d2[iu, ju] + 1e-7).mean())
