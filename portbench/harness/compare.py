"""The numbers ``correct`` is decided by, each beside its limit."""

from __future__ import annotations

import math
import statistics
from typing import Dict


def relative(a: float, b: float) -> float:
    """|a − b| / |b|."""
    return abs(a - b) / abs(b) if b else abs(a)


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float]) -> Dict[str, float]:
    """Each leaf's gap between the program's and the reference's norm, over
    the larger of the reference's norm of that leaf and of the median leaf
    (a missing program leaf reads 0)."""
    median = statistics.median(ref.values())
    return {n: abs(prog.get(n, 0.0) - r) / max(r, median) for n, r in ref.items()}


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float]) -> float:
    return max(leaf_gaps(prog, ref).values())


def median_leaf(prog: Dict[str, float], ref: Dict[str, float]) -> float:
    return statistics.median(leaf_gaps(prog, ref).values())


def moved(loss_grads, floor: float = 1e-3) -> dict:
    """{leaf: mask of its elements whose reference loss gradient at the first
    step is at least ``floor`` × the median leaf's root mean square}: the
    others (a key's bias under softmax, a leaf the loss does not reach)
    move under Adam by round-off alone. Leaves with no such element are
    left out."""
    rms = {k: float(g.double().norm()) / math.sqrt(max(g.numel(), 1))
           for k, g in loss_grads.items()}
    scale = floor * statistics.median(rms.values())
    masks = {k: g.abs() >= scale for k, g in loss_grads.items()}
    return {k: m for k, m in masks.items() if bool(m.any())}


def change_norms(params, start, masks) -> Dict[str, float]:
    """Each masked leaf's norm of its change from ``start`` over its masked
    elements (``params`` may lie on the host)."""
    out = {}
    for k, m in masks.items():
        d = params[k].to(start[k].device).double() - start[k].double()
        out[k] = float(d[m].norm())
    return out


def difference(params, ref, start, masks) -> float:
    """‖change − reference change‖ / ‖reference change‖ over the masked
    elements of every leaf together: the change's whole error, where a gap
    of norms sees only its part along the change."""
    num = den = 0.0
    for k, m in masks.items():
        r = ref[k].double() - start[k].double()
        d = params[k].to(start[k].device).double() - ref[k].double()
        num += float(d[m].square().sum())
        den += float(r[m].square().sum())
    return math.sqrt(num / den) if den else math.inf


def number(name: str, value: float, limit: float) -> dict:
    return {"name": name, "value": float(value), "limit": float(limit),
            "ok": bool(math.isfinite(value) and value <= limit)}


def compared(values: Dict[str, float], limits: Dict[str, float], every: bool = False) -> list:
    """The numbers the cell's ``limits`` name, in their order; with
    ``every`` all of ``values`` (an unnamed one's limit is infinite)."""
    names = list(values) if every else list(limits)
    return [number(n, values[n], limits.get(n, math.inf)) for n in names]
