"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: asking for
CUDA where there is none raises instead of quietly running on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda``; anything else as given. Raises when a CUDA
    device is asked for and none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    return dev


def disable_tf32() -> None:
    """State TF32 explicitly, and turn it off: cuDNN convs default to TF32,
    while ``compute_dtype="float32"`` means full fp32 for the convs, the
    resize matrices and the loss and metric stencils (the JAX package runs
    the stencils at ``Precision.HIGHEST``)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
