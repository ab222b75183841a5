"""SRResNet (Ledig et al., arXiv:1609.04802 §2.2), the architecture of a
configuration that names none: the reference, the work counts and the
weights' draw of ``reference/model.py``, ``work.py`` and ``inputs.py``."""

from __future__ import annotations

from h100bench import inputs, work
from h100bench.reference import model as ref_model

param_shapes = ref_model.generator_param_shapes
param_scale = inputs._scale
forward = ref_model.srresnet
train_ops = work.generator_train
forward_ops = work.generator_forward


def port_model(model_cfg):
    from srgan_tpu_torch.models.srresnet import SRResNet

    return SRResNet.from_config(model_cfg)
