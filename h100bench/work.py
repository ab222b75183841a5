"""The work a pass needs, counted from the configuration's shapes, and the
chip's peaks. Rooflines and MFU read these, whatever implements the pass.

A conv pass's FLOPs are 2·B·H_out·W_out·C_out·C_in·k² (multiply and add);
forward, input gradient (dgrad) and weight gradient (wgrad) each cost
that. Its bytes count each operand read once and the result written once,
activations and kernels at the compute dtype's width. A conv's least time
is max(FLOPs / peak FLOP/s, bytes / peak bytes/s). A training step's
generator pass is the forward, every wgrad, and every dgrad but the
stem's (the input needs no gradient).

Work items: a conv pass here, and whatever an architecture's file
(``arch/<name>.py``) defines. An item has ``op``, the class it is timed
under (``"conv"``), ``flops(batch)`` and ``bytes(batch, width)``; ``Work``
sums the FLOPs of every item and keeps each class's least time apart.

The loss kernels K1-K3 (``ops/cuda/recon_loss_kernel.py``) stream f32
NHWC images: K1 reads HR, K2 reads HR and SR, K3 reads both and writes
dSR, each byte once.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterable, List, Tuple

# NVIDIA H100 SXM data sheet, dense: bf16 tensor cores, HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES_S = 3.35e12
DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


@dataclass(frozen=True)
class Conv:
    cin: int
    cout: int
    k: int
    hout: int
    wout: int
    hin: int
    win: int

    op = "conv"

    def flops(self, batch: int) -> float:
        return conv_flops(self, batch)

    def bytes(self, batch: int, width: int) -> float:
        return conv_bytes(self, batch, width)


def _out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def srresnet_convs(m: dict, h: int, w: int) -> List[Conv]:
    """The generator's convs, in order, for an LR input of (h, w)."""
    c, f = m["in_channels"], m["num_features"]
    convs = [Conv(c, f, 9, h, w, h, w)]
    convs += [Conv(f, f, 3, h, w, h, w)] * (2 * m["num_residuals"] + 1)
    stages = int(math.log2(m["upscale_factor"]))
    for j in range(stages):
        s = 2 ** j
        convs.append(Conv(f, 4 * f, 3, h * s, w * s, h * s, w * s))
    s = 2 ** (stages - 1)
    convs.append(Conv(4 * f, 4 * c, 5, h * s, w * s, h * s, w * s))
    return convs


def discriminator_convs(d: dict, h: int, w: int) -> List[Conv]:
    stages = ((1, 8, 2), (2, 4, 1), (4, 4, 1), (8, 4, 1))[: d["num_stages"]]
    out, cin = [], d["in_channels"]
    for mult, k, p in stages:
        ho, wo = _out(h, k, 2, p), _out(w, k, 2, p)
        out.append(Conv(cin, d["num_filters"] * mult, k, ho, wo, h, w))
        cin = d["num_filters"] * mult
        h, w = _out(ho, 3, 2, 0), _out(wo, 3, 2, 0)
    return out


def conv_flops(c: Conv, batch: int) -> float:
    return 2.0 * batch * c.hout * c.wout * c.cout * c.cin * c.k * c.k


def conv_bytes(c: Conv, batch: int, width: int) -> float:
    """One pass's bytes: each pass reads two of (input, output, kernel) and
    writes the third (forward x, w → y; dgrad dy, w → dx; wgrad x, dy → dw)."""
    x = batch * c.hin * c.win * c.cin
    y = batch * c.hout * c.wout * c.cout
    return width * (x + y + c.cout * c.cin * c.k * c.k)


def passes(convs: List[Conv], kinds: Tuple[str, ...], skip_first_dgrad=True):
    """The conv of each pass of ``kinds`` over ``convs`` (every pass of a
    conv costs the same)."""
    for i, c in enumerate(convs):
        for kind in kinds:
            if kind == "dgrad" and i == 0 and skip_first_dgrad:
                continue
            yield c


class Work:
    """Analytic FLOPs of a run's work items, summed, and the least time of
    each op class (``min_s``)."""

    def __init__(self, dtype: str):
        self.dtype = dtype
        self.flops = 0.0
        self.min_s: Dict[str, float] = {"conv": 0.0}

    def add(self, items: Iterable, batch: int, times: float = 1.0):
        peak, width = PEAK_FLOPS[self.dtype], DTYPE_BYTES[self.dtype]
        for it in items:
            f = it.flops(batch)
            self.flops += f * times
            self.min_s[it.op] = self.min_s.get(it.op, 0.0) + times * max(
                f / peak, it.bytes(batch, width) / PEAK_BYTES_S)

    def as_dict(self) -> Dict[str, float]:
        """``flops``, then ``<op>_min_s`` of each op class, ``conv_min_s`` first."""
        return {"flops": self.flops, **{f"{op}_min_s": s for op, s in self.min_s.items()}}


def generator_train(m: dict, lr_hw) -> List[Conv]:
    return list(passes(srresnet_convs(m, *lr_hw), ("fwd", "wgrad", "dgrad")))


def generator_forward(m: dict, lr_hw) -> List[Conv]:
    return list(passes(srresnet_convs(m, *lr_hw), ("fwd",)))


def discriminator_passes(d: dict, hr_hw, kinds, skip_first_dgrad=True):
    return list(passes(discriminator_convs(d, *hr_hw), kinds, skip_first_dgrad))


def recon_loss_bytes(b: int, h: int, w: int, c: int) -> Dict[str, float]:
    """Bytes each loss kernel has to move for an f32 (b, h, w, c) pair."""
    img = 4.0 * b * h * w * c
    return {"K1": img, "K2": 2 * img, "K3": 3 * img}
