"""Plain losses of the reference repo, in fp32 with float64 totals.

Reconstruction (``src/utils.py:181-215``, ``src/train.py:194-195``): the
edge map is max(|Sx * HR|, |Sy * HR|) per channel with the ±5 Sobel-like
kernels and zero padding, renormalised over the whole batch to mean 1 and
std 0.2 (Bessel) and clamped to [0, 2]; the loss is the edge-weighted L1
sum(|HR − SR|·e) / sum(e) plus relu(mean(|D * SR|·(1 − e))) with D the
8-neighbour difference kernel of unit centre.

Adversarial (``src/train.py:190,218``), relativistic and tanh-squashed:
the generator minimises mean(tanh(D(hr) − D(sr))) with D(hr) held fixed,
the discriminator mean(tanh(D(sr) − D(hr))).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

SOBEL_X = ((-5.0, 0.0, 5.0),) * 3
DIFF = ((-0.125, -0.125, -0.125), (-0.125, 1.0, -0.125), (-0.125, -0.125, -0.125))


def _stencil(x: torch.Tensor, k) -> torch.Tensor:
    """Per-channel 3x3 correlation of an NHWC batch, zero padded."""
    c = x.shape[-1]
    w = torch.tensor(k, dtype=x.dtype, device=x.device).expand(c, 1, 3, 3)
    return F.conv2d(x.permute(0, 3, 1, 2), w, padding=1, groups=c).permute(0, 2, 3, 1)


def edge_map(hr: torch.Tensor) -> torch.Tensor:
    sx = torch.tensor(SOBEL_X).T.tolist()
    e = torch.maximum(_stencil(hr, SOBEL_X).abs(), _stencil(hr, sx).abs())
    e64 = e.double()
    mean = e64.mean()
    std = torch.sqrt(((e64 - mean) ** 2).sum() / (e64.numel() - 1))
    return ((e - mean.float()) / std.float() * 0.2 + 1.0).clamp(0.0, 2.0)


def edge_totals(hr: torch.Tensor) -> torch.Tensor:
    """What the loss totals over a batch before it normalises, float64:
    (mean and std of the raw edge map, the sum of the normalised map, the
    element count)."""
    sx = torch.tensor(SOBEL_X).T.tolist()
    e64 = torch.maximum(_stencil(hr, SOBEL_X).abs(), _stencil(hr, sx).abs()).double()
    mean = e64.mean()
    std = torch.sqrt(((e64 - mean) ** 2).sum() / (e64.numel() - 1))
    return torch.stack([mean, std, edge_map(hr).double().sum(),
                        torch.tensor(float(hr.numel()), dtype=torch.float64, device=hr.device)])


def reconstruction(hr: torch.Tensor, sr: torch.Tensor, edges=None):
    """(edge-weighted L1, TV) of an NHWC pair."""
    e = edge_map(hr) if edges is None else edges
    l1 = ((hr - sr).abs() * e).double().sum() / e.double().sum()
    tv = (_stencil(sr, DIFF).abs() * (1.0 - e)).double().mean()
    return l1.float(), F.relu(tv).float()


def reconstruction_sums(hr: torch.Tensor, sr: torch.Tensor, edges: torch.Tensor):
    """One shard's part of the global batch's loss, float64: (Σ|HR − SR|·e,
    Σ|D * SR|·(1 − e)), with ``edges`` normalised over the global batch.
    The loss is the first over Σe and the relu of the second over the
    global element count, each summed over the shards."""
    return (((hr - sr).abs() * edges).double().sum(),
            (_stencil(sr, DIFF).abs() * (1.0 - edges)).double().sum())


def generator_adversarial(real: torch.Tensor, fake: torch.Tensor) -> torch.Tensor:
    return torch.tanh(real.detach() - fake).mean()


def discriminator_adversarial(real: torch.Tensor, fake: torch.Tensor) -> torch.Tensor:
    return torch.tanh(fake - real).mean()
