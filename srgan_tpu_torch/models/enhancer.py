"""Post-inference image enhancer (Laplacian sharpen + clamp), the
counterpart of ``srgan_tpu/models/enhancer.py``.

Reference ``ImageEnhancer`` (``src/models.py:28-41``): a parameterless
depthwise 8-neighbour sharpening filter applied in the eval path only
(``src/evaluation.py:50``), here an epilogue on the SR batch on its device.
"""

from __future__ import annotations

import torch

from srgan_tpu_torch.ops.filters import sharpen


def enhance(x: torch.Tensor, factor: float = 1.0) -> torch.Tensor:
    """NHWC batch → sharpened batch, clamped to [0, 1]."""
    return sharpen(x, factor=factor)
