"""The numbers that decide `correct`: the program's outputs against the
reference's, each a single number that a limit holds.

Training (the first steps of the very object the window then drives):
  * loss_gap: the widest relative gap of a step's loss;
  * grad_gap: the first gradient as the optimizer got it (its first moment
    after one step), by the worst leaf: the gap between the program's norm
    and the reference's, over the larger of the reference's norm of that
    leaf and of the median leaf;
  * change_gap: the same for the parameters' change over the steps, over
    the leaves whose reference gradient is at least a thousandth of the
    median leaf's (a leaf under that moves under Adam by round-off alone);
  * grad_diff and change_diff: as grad_gap and change_gap, of the norm of
    the difference.
State build:
  * stats_rel: the widest relative (Frobenius) gap of psi0, psi2, psiY, yy;
  * n_gap: the gap in the count of points;
  * state_rel: the widest relative gap of L, LA and K_uu^-1 mean_u.
A number that is not finite reads as infinity: it fails any limit.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional

import torch

GRAD_FLOOR = 1e-3


def _finite(x: float) -> float:
    return x if math.isfinite(x) else math.inf


def leaves(tree) -> Dict[str, torch.Tensor]:
    """Leaves by "/"-joined path, in sorted key order."""
    out = {}

    def walk(t, prefix):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], prefix + (k,))
        else:
            out["/".join(prefix)] = t.detach().to("cpu", torch.float64)

    walk(tree, ())
    return out


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t))


def _worst(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
           keep: List[str], detail: Optional[dict] = None) -> tuple:
    """(worst gap of norms, worst norm of the difference), each over the
    larger of the leaf's reference norm and the median leaf's; `detail`
    receives each leaf's (gap, difference, reference norm)."""
    med = statistics.median(_norm(ref[k]) for k in keep)
    gap = diff = 0.0
    for k in keep:
        scale = max(_norm(ref[k]), med)
        g = _finite(abs(_norm(prog[k]) - _norm(ref[k])) / scale)
        d = _finite(_norm(prog[k] - ref[k]) / scale)
        gap, diff = max(gap, g), max(diff, d)
        if detail is not None:
            detail[k] = (g, d, _norm(ref[k]))
    return gap, diff


def train_numbers(prog: dict, ref: dict, params0, detail: Optional[dict] = None) -> Dict[str, float]:
    """`prog` and `ref`: {"losses", "m1", "params"} of the same steps from
    `params0`; `detail` receives the per-leaf readings."""
    loss_gap = max(_finite(abs(p - r) / abs(r)) for p, r in zip(prog["losses"], ref["losses"]))
    m_p, m_r = leaves(prog["m1"]), leaves(ref["m1"])
    names = list(m_r)
    sub = {} if detail is not None else None
    grad_gap, grad_diff = _worst(m_p, m_r, names, sub)
    if detail is not None:
        detail["grad"], sub = sub, {}
        detail["losses"] = [prog["losses"], ref["losses"]]
    med = statistics.median(_norm(m_r[k]) for k in names)
    moved = [k for k in names if _norm(m_r[k]) >= GRAD_FLOOR * med]
    p0 = leaves(params0)
    d_p = {k: v - p0[k] for k, v in leaves(prog["params"]).items()}
    d_r = {k: v - p0[k] for k, v in leaves(ref["params"]).items()}
    change_gap, change_diff = _worst(d_p, d_r, moved, sub)
    if detail is not None:
        detail["change"] = sub
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap,
            "grad_diff": grad_diff, "change_diff": change_diff}


def _rel(p: torch.Tensor, r: torch.Tensor) -> float:
    p = p.detach().to("cpu", torch.float64)
    r = r.detach().to("cpu", torch.float64)
    return _finite(_norm(p - r) / _norm(r))


def build_numbers(state, ref) -> Dict[str, float]:
    """`state`: the program's `PosteriorState`; `ref`: the reference's."""
    s, r = state.stats, ref.stats
    return {
        "stats_rel": max(_rel(getattr(s, k), getattr(r, k)) for k in ("psi0", "psi2", "psiY", "yy")),
        "n_gap": _finite(abs(float(s.n) - float(r.n))),
        "state_rel": max(_rel(getattr(state, k), getattr(ref, k)) for k in ("L", "LA", "Kuu_inv_mean")),
    }


def merge(numbers: List[Dict[str, float]]) -> Dict[str, float]:
    """The worst of several comparisons, number by number."""
    return {k: max(n[k] for n in numbers) for k in numbers[0]}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> tuple:
    """(correct, {name: {"value", "limit"}}) over the numbers that have a
    limit."""
    shown = {k: {"value": numbers[k], "limit": lim} for k, lim in limits.items()}
    ok = all(numbers[k] <= lim for k, lim in limits.items())
    return ok, shown
