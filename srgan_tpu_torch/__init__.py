"""srgan_tpu_torch — the PyTorch/CUDA port of ``srgan_tpu``.

A second package beside the JAX one, which stays the reference. Module
names mirror ``srgan_tpu`` so each counterpart is easy to find; public
functions keep the JAX layout (NHWC in, NHWC out). The package imports
``torch`` and never ``jax`` or anything under ``srgan_tpu``.

The kernels that were Pallas TPU kernels in ``srgan_tpu`` are CUDA C++ for
Hopper here (``csrc/``), built with ``nvcc`` at first use and bound with
``ctypes`` (``ops/cuda/``). Each wrapper launches its kernel for a CUDA
tensor and runs its plain PyTorch version only for a CPU tensor.
"""

__version__ = "0.1.0"
