"""Edge-weighted reconstruction loss + masked total-variation smoothness,
the counterpart of ``srgan_tpu/ops/recon_loss.py``.

  1. ``edges = clamp(normalize(max(|sobel_x*HR|, |sobel_y*HR|), mean=1,
     std=0.2), 0, 2)``, normalized over the whole batch tensor with a
     Bessel-corrected std (``_std``);
  2. ``edge_loss = sum(|HR - SR| * edges) / sum(edges)``;
  3. ``tv_loss = relu(mean(|DIFF_KERNEL * SR| * (1 - edges)))``.

The functions here are the PLAIN versions, in PyTorch. ``reconstruction_loss``
dispatches by device: CUDA tensors go to the hand-written kernels of
``ops.cuda.recon_loss_kernel`` (forward K1 + K2, backward K3), CPU tensors to
the plain version. There is no fallback between the two.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from srgan_tpu_torch.ops.filters import DIFF_KERNEL, depthwise_conv3x3, sobel_edge_map


def _std(x: torch.Tensor) -> torch.Tensor:
    """Bessel-corrected std over all elements, matching ``torch.std``
    (reference ``src/utils.py:200``)."""
    n = x.numel()
    mean = x.mean()
    return torch.sqrt(((x - mean) ** 2).sum() / (n - 1))


def edge_stats(hr: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean and Bessel std of the raw edge map over the whole batch — the
    plain version of kernel K1."""
    edges = sobel_edge_map(hr)
    return edges.mean(), _std(edges)


def normalize_edges(edges, mean, std) -> torch.Tensor:
    """Renormalize to mean 1 / std 0.2 and clamp to [0, 2]."""
    return ((edges - mean) / std * 0.2 + 1.0).clamp(0.0, 2.0)


def edge_importance_map(hr: torch.Tensor) -> torch.Tensor:
    """Normalized, clamped edge map of the HR batch (reference
    ``high_pass_filter``, ``src/utils.py:198-215``)."""
    edges = sobel_edge_map(hr)
    return normalize_edges(edges, edges.mean(), _std(edges))


def reconstruction_loss(
    hr: torch.Tensor, sr: torch.Tensor, group=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(edge_loss, tv_loss)`` for an NHWC batch pair; the edge map comes
    from ``hr``, the TV penalty applies to ``sr``. CUDA tensors launch the
    kernels; CPU tensors run the plain version.

    ``group``: a ``torch.distributed`` process group whose ranks hold the
    rows of one global batch. The statistics and both sums are then the
    global batch's (the JAX ``Trainer``'s loss over a mesh), and the
    gradient is scaled for averaging across ranks
    (``ops.cuda.recon_loss_kernel.ReconstructionLoss``); on CPU tensors
    through the kernels' plain versions, in fp64 totals as the kernels sum."""
    if hr.is_cuda or sr.is_cuda or group is not None:
        from srgan_tpu_torch.ops.cuda.recon_loss_kernel import ReconstructionLoss

        return ReconstructionLoss.apply(hr, sr, group)
    return reconstruction_loss_with_edges(hr, sr, edge_importance_map(hr))


def reconstruction_loss_with_edges(
    hr: torch.Tensor, sr: torch.Tensor, edges: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Loss terms given a precomputed edge map — with ``edges`` from
    :func:`normalize_edges`, the plain version of kernel K2."""
    edge_loss = ((hr - sr).abs() * edges).sum() / edges.sum()
    tv = depthwise_conv3x3(sr, DIFF_KERNEL).abs() * (1.0 - edges)
    return edge_loss, F.relu(tv.mean())
