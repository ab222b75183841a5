"""The generator architectures the harness knows, one module each,
``arch/<name>.py``, picked by a configuration's ``model.arch`` (SRResNet
where it names none). A new architecture is a new file here; nothing else
of the harness changes.

Each module gives:

- ``param_shapes(m)``: (name, shape) of every parameter, in the order of
  the port module's ``named_parameters``;
- ``param_scale(name, shape)``: the (offset, scale) of each parameter's
  normal draw (``inputs.weights``);
- ``forward(p, x, m, quant=None)``: the plain fp32 reference, NHWC LR in
  and NHWC SR out, unclamped; ``quant`` rounds what a lower precision
  would (``control.py``);
- ``train_ops(m, lr_hw)`` and ``forward_ops(m, lr_hw)``: the work items
  (``work.py``) of one image's generator pass in a training step and in a
  forward;
- ``port_model(model_cfg)``: the port's module for serving, built from the
  port's ``ModelConfig``.
"""

from __future__ import annotations

import importlib.util
import re
import sys
import types
from pathlib import Path

DIR = Path(__file__).resolve().parent
DEFAULT = "srresnet"
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def load(m_cfg: dict) -> types.ModuleType:
    """The module of the architecture that ``m_cfg`` names under ``arch``,
    imported from its file once a process. Raises ``ValueError`` for a
    name that has no file, naming the file it looked for."""
    name = m_cfg.get("arch", DEFAULT)
    path = DIR / f"{name}.py"
    if not _NAME.match(str(name)) or not path.is_file():
        raise ValueError(f"model.arch {name!r}: no architecture file {path}")
    key = f"h100bench_arch_{name}"
    mod = sys.modules.get(key)
    if mod is None or Path(mod.__file__) != path:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod  # before it runs, as an import does (dataclasses look it up)
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[key]
            raise
    return mod
