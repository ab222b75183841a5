"""Depthwise 3x3 stencil primitives (NHWC), the counterpart of
``srgan_tpu/ops/filters.py``: the reconstruction loss's plain version and
the image enhancer read them.

``depthwise_conv3x3`` is ``F.conv2d(..., groups=C)`` with one shared 3x3
kernel and zero padding, as the reference builds it. The stencils feed loss
values and metrics, so they must run in full fp32: cuDNN's TF32 default has
to be off on the card (``utils.platform.disable_tf32``), as the JAX package
runs them at ``Precision.HIGHEST``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# Sobel-like ±5 edge kernels (reference ``src/utils.py:181-188``)
SOBEL_X = np.array(
    [[-5.0, 0.0, 5.0], [-5.0, 0.0, 5.0], [-5.0, 0.0, 5.0]], dtype=np.float32
)
SOBEL_Y = SOBEL_X.T.copy()
# the 8-neighbour difference kernel with unit centre (``src/utils.py:192-194``)
DIFF_KERNEL = np.array(
    [
        [-1 / 8, -1 / 8, -1 / 8],
        [-1 / 8, 1.0, -1 / 8],
        [-1 / 8, -1 / 8, -1 / 8],
    ],
    dtype=np.float32,
)


def depthwise_conv3x3(x: torch.Tensor, kernel) -> torch.Tensor:
    """Depthwise 3x3 'same' correlation of an NHWC batch with one shared
    2-D kernel applied to every channel (zero padding, stride 1)."""
    c = x.shape[-1]
    k = torch.as_tensor(kernel, dtype=x.dtype, device=x.device)
    k = k.expand(c, 1, 3, 3)
    y = F.conv2d(x.permute(0, 3, 1, 2), k, padding=1, groups=c)
    return y.permute(0, 2, 3, 1)


def sobel_edge_map(images: torch.Tensor) -> torch.Tensor:
    """Raw edge magnitude: max(|sobel_x * I|, |sobel_y * I|) per channel."""
    ex = depthwise_conv3x3(images, SOBEL_X).abs()
    ey = depthwise_conv3x3(images, SOBEL_Y).abs()
    return torch.maximum(ex, ey)


def sharpen(x: torch.Tensor, factor: float = 1.0) -> torch.Tensor:
    """Laplacian-style sharpening with clamp to [0, 1]
    (``ImageEnhancer.forward``, reference ``src/models.py:37-41``)."""
    return (x + factor * depthwise_conv3x3(x, DIFF_KERNEL)).clamp(0.0, 1.0)
