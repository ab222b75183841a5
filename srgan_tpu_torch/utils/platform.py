"""Device selection and numerics for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: asking for
CUDA where there is none raises instead of quietly running on the CPU. Each
also turns TF32 off (``disable_tf32``) and deterministic algorithms on
(``make_deterministic``); there is no switch for either.
"""

from __future__ import annotations

import os

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


def make_deterministic() -> None:
    """Make a run's numbers a function of its command: the JAX package's
    runs are bit-deterministic given the same command and build, and so are
    the port's. cuDNN picks deterministic algorithms and does not
    benchmark; every other op that has only a nondeterministic CUDA form
    raises (``use_deterministic_algorithms`` in raising mode), instead of
    letting two runs drift apart. cuBLAS needs a fixed workspace for that
    (``CUBLAS_WORKSPACE_CONFIG``, set here where unset: it is read when
    cuBLAS first runs). The port's own kernels sum in a fixed order."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True)
    # The mode also fills every torch.empty with NaN, a memset a buffer;
    # determinism does not need it where every buffer is written before it
    # is read, as the port's kernels and ops write theirs.
    torch.utils.deterministic.fill_uninitialized_memory = False
