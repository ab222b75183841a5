"""Serving and evaluation: ``Upscaler``, ``upscale``, ``upscale_directory``
(``eval/inference.py``) and ``evaluate_model`` (``eval/evaluation.py``)."""

from srgan_tpu_torch.eval.evaluation import evaluate_model
from srgan_tpu_torch.eval.inference import Upscaler, upscale, upscale_directory

__all__ = ["evaluate_model", "Upscaler", "upscale", "upscale_directory"]
