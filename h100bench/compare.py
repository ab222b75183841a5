"""The numbers that decide ``correct``, each read as a gap between what the
program produced and what the plain reference gives, and held to the
cell's limits (``limits/<cell>.json``).

Training is compared by the worst leaf: for every parameter tensor the
gap between the program's norm and the reference's, or with ``dist`` the
norm of their difference, which sees direction too, over the larger of
the reference's norm of that leaf and the median leaf's norm of its
network. Leaves whose reference gradient is under a thousandth of the
median leaf's move under Adam by rounding alone and are left out.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

TINY_GRAD = 1e-3  # of the median leaf's first-gradient norm
NOTES: List[str] = []  # where each number was read, for standard error


def loss_gap(prog: Sequence[Sequence[float]], ref: Sequence[Sequence[float]]) -> float:
    """The largest relative gap of any step's loss of any generator."""
    worst = 0.0
    for p_step, r_step in zip(prog, ref, strict=True):
        for p, r in zip(p_step, r_step, strict=True):
            worst = max(worst, abs(p - r) / max(abs(r), 1e-12))
    return worst


def _norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in d.items()}


def worst_leaf(prog: List[Dict[str, torch.Tensor]], ref: List[Dict[str, torch.Tensor]],
               ref_grads: List[Dict[str, torch.Tensor]], label: str = "",
               dist: bool = False) -> float:
    """The worst leaf's gap over all networks (module docstring)."""
    worst, where, left_out = 0.0, "", []
    for i, (p_net, r_net, g_net) in enumerate(zip(prog, ref, ref_grads, strict=True)):
        pn, rn, gn = _norms(p_net), _norms(r_net), _norms(g_net)
        med_r, med_g = float(np.median(list(rn.values()))), float(np.median(list(gn.values())))
        for k in rn:
            if gn[k] < TINY_GRAD * med_g:
                left_out.append(f"{i}:{k}")
                continue
            if dist:
                diff = float((p_net[k].to(r_net[k].device).double() - r_net[k].double()).norm())
            else:
                diff = abs(pn[k] - rn[k])
            gap = diff / max(rn[k], med_r, 1e-30)
            if gap >= worst:
                worst = gap
                where = f"network {i} {k}: {pn[k]:.6g} against {rn[k]:.6g} (median leaf {med_r:.6g})"
    NOTES.append(f"{label} {'distance' if dist else 'norm'}: worst leaf {worst:.6g} {where}; "
                 f"left out {len(left_out)} {left_out[:6]}")
    return worst


def mutual_gap(mutual: dict, alpha: float) -> float:
    """The epoch end's sort and interpolation, followed from the program's
    params and running losses just before it: the largest relative
    distance of a leaf from what they give."""
    from h100bench.reference.train import mutual_learning

    pre = [dict(enumerate(ps)) for ps in mutual["pre"]]
    want = mutual_learning(pre, mutual["loss"], alpha)
    worst = 0.0
    for got, exp in zip(mutual["post"], want, strict=True):
        for k, p in enumerate(got):
            e = exp[k]
            worst = max(worst, float((p - e).double().norm() / max(float(e.double().norm()), 1e-30)))
    return worst


def u8_gaps(prog: np.ndarray, ref: np.ndarray) -> Dict[str, float]:
    d = np.abs(prog.astype(np.int16) - ref.astype(np.int16))
    return {"max": float(d.max()), "mean": float(d.mean())}


def judge(checks: Dict[str, float], limits: Dict[str, float]) -> tuple:
    """(correct, {name: [value, limit]}) over the numbers the cell's limits
    name; a limit without a number is not correct. A number without a
    limit (one with no upper reading to set one from) is only noted."""
    out, ok = {}, True
    for name in sorted(limits):
        val, lim = checks.get(name), limits[name]
        out[name] = [val, lim]
        if val is None or not np.isfinite(val) or val > lim:
            ok = False
    for name in sorted(set(checks) - set(limits)):
        NOTES.append(f"not compared {name}: {checks[name]!r}")
    return ok, out
