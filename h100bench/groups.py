"""Device kernels by group, the device's busy time as the union of its
intervals, and the idle gaps between them.

The groups are tried in order, first match wins. cuDNN's layout
transposes (``nchwToNhwcKernel``, ``nhwcToNchwKernel``) land in the copy
group, ahead of ``conv``, whose pattern would take them for ``cudnn``;
dtype casts are PyTorch's copy kernels (``bfloat16_copy_kernel_cuda``,
``direct_copy_kernel_cuda``). ``gpu_kernel_impl_nocast`` is the name of
every elementwise kernel that needs no cast, not a cast.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, List, Sequence, Tuple

LOSS_KERNEL_RE = re.compile(
    r"\b(edge_stats_kernel|edge_stats_finalize|loss_sums_kernel|loss_sums_finalize"
    r"|grad_kernel|partials_totals<[23]>)")
# the loss kernel each launch works for (its totals stage and finalise count with it)
LOSS_PART = (("K1", re.compile(r"edge_stats_kernel")),
             ("K2", re.compile(r"loss_sums_kernel")),
             ("K3", re.compile(r"\bgrad_kernel")))

GROUPS = [(g, re.compile(rx, re.I)) for g, rx in (
    ("loss", LOSS_KERNEL_RE.pattern),
    ("copy", r"nchwToNhwc|nhwcToNchw|copy_kernel|_copy|Memcpy|Memset|convert"),
    ("conv", r"conv|gemm|xmma|winograd|dgrad|wgrad|implicit|cudnn|sm\d\d_"),
    ("groupnorm", r"group_?norm|welford|moments|GammaBeta|ComputeFused"),
    ("adam", r"foreach|multi_tensor"),
    ("pool", r"max_pool"),
    ("nccl", r"nccl"),
    ("elementwise", r"elementwise|vectorized|unrolled|reduce"),
)]

Event = Tuple[str, float, float]  # (name, start s, end s)


def group_of(name: str) -> str:
    return next((g for g, rx in GROUPS if rx.search(name)), "other")


def seconds_by_group(events: Iterable[Event]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for name, t0, t1 in events:
        g = group_of(name)
        out[g] = out.get(g, 0.0) + (t1 - t0)
    return out


def seconds_by_name(events: Iterable[Event]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for name, t0, t1 in events:
        out[name] = out.get(name, 0.0) + (t1 - t0)
    return out


def union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merged, sorted intervals: overlapping kernels count once."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_seconds(events: Sequence[Event], t0: float, t1: float) -> float:
    """Seconds of [t0, t1] in which some device operation ran."""
    spans = union((max(a, t0), min(b, t1)) for _, a, b in events if b > t0 and a < t1)
    return sum(b - a for a, b in spans)


def idle_gaps(events: Sequence[Event], t0: float, t1: float) -> List[Tuple[float, float]]:
    """The intervals of [t0, t1] in which no device operation ran."""
    gaps, at = [], t0
    for a, b in union((max(a, t0), min(b, t1)) for _, a, b in events if b > t0 and a < t1):
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if t1 > at:
        gaps.append((at, t1))
    return gaps


def label_at(regions: Sequence[Tuple[str, float, float]], t: float, default: str) -> str:
    """The innermost host region (name, start, end) that holds ``t``."""
    best = None
    for name, a, b in regions:
        if a <= t < b and (best is None or b - a < best[2] - best[1]):
            best = (name, a, b)
    return best[0] if best else default
