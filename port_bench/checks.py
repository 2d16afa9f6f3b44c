"""The comparison that decides `correct` (frozen yardstick).

Training (the first three steps of the window's own loop, against the
reference's three steps from the same weights, rows and draws):
  * loss_gap: the largest |loss - reference loss| / reference loss of the
    steps; loss1_gap: the first step's;
  * grad_gap: the first gradient as the optimizer got it (Adam's first moment
    after step 1 over 1 - beta1), by the worst leaf: |‖g‖ - ‖g_ref‖| over the
    larger of ‖g_ref‖ and the median leaf's ‖g_ref‖; grad_gap_median: the
    median leaf's gap in the same measure; grad_gap_net: the worst net's gap
    of its whole first gradient (the norm over all its leaves), which a net
    that takes no gradient, or is left out of the optimizer, reads as 1;
  * change_gap / change_gap_median: the parameters' change over the three
    steps, by the worst / the median leaf in the same measure; leaves whose
    reference gradient is under a thousandth of the median leaf's are left
    out (Adam moves those by round-off alone); change_gap_net: the worst net's
    gap of its whole change (the norm over all its moved leaves), which a net
    left unstepped, or a net that no gradient reaches, reads as 1;
A cell's file names the numbers it holds to a limit: the worst-leaf numbers,
or, where the look found them ruled by one small leaf or by the later steps
(PERF.md), the steady ones.
Views: view_gap, the largest mean |pixel - reference pixel| over the sampled
views of the window (every channel of every pixel of a view).

A run is correct when every number is finite and at or under its limit (the
cell's file holds the limits), and no step or view failed.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

Leaves = Dict[str, Dict[str, torch.Tensor]]


def _norms(tree: Leaves) -> Dict[tuple, float]:
    return {(m, k): float(torch.linalg.norm(v.float()))
            for m, leaves in tree.items() for k, v in leaves.items()}


def _median(values) -> float:
    v = sorted(values)
    n = len(v)
    return 0.5 * (v[(n - 1) // 2] + v[n // 2])


def _gaps(ours: Dict[tuple, float], ref: Dict[tuple, float], keys) -> list:
    med = _median(ref[k] for k in keys)
    return [abs(ours[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys]


def _worst_net(ours: Dict[tuple, float], ref: Dict[tuple, float], keys) -> float:
    """The largest gap of a net's whole norm over its leaves among `keys`."""
    gaps = []
    for net in {m for m, _ in keys}:
        a, b = (math.sqrt(sum(d[k] ** 2 for k in keys if k[0] == net)) for d in (ours, ref))
        gaps.append(abs(a - b) / max(b, 1e-30))
    return max(gaps)


def train_readings(ours: dict, ref: dict, start: Leaves) -> Dict[str, float]:
    """ours / ref: {'losses', 'grad1', 'params'} (reference.train_steps' form)."""
    losses = [abs(a - b) / abs(b) for a, b in zip(ours["losses"], ref["losses"])]
    g_ours, g_ref = _norms(ours["grad1"]), _norms(ref["grad1"])
    keys = list(g_ref)
    grad = _gaps(g_ours, g_ref, keys)
    med_g = _median(g_ref.values())
    moved = [k for k in keys if g_ref[k] >= 1e-3 * med_g]

    def change(tree):
        return {(m, k): float(torch.linalg.norm(tree[m][k].float() - start[m][k].float()))
                for m, k in moved}

    d_ours, d_ref = change(ours["params"]), change(ref["params"])
    change_ = _gaps(d_ours, d_ref, moved)
    return {"loss_gap": max(losses), "loss1_gap": losses[0],
            "grad_gap": max(grad), "grad_gap_median": _median(grad),
            "grad_gap_net": _worst_net(g_ours, g_ref, keys),
            "change_gap": max(change_), "change_gap_median": _median(change_),
            "change_gap_net": _worst_net(d_ours, d_ref, moved)}


def train_details(ours: dict, ref: dict, start: Leaves) -> dict:
    """The look behind train_readings: each step's loss gap, and each leaf's
    first-gradient and change gap with its reference norms."""
    g_ours, g_ref = _norms(ours["grad1"]), _norms(ref["grad1"])
    med = _median(g_ref.values())
    leaves = {}
    for (m, k), g in g_ref.items():
        d_ours = float(torch.linalg.norm(ours["params"][m][k].float() - start[m][k].float()))
        d_ref = float(torch.linalg.norm(ref["params"][m][k].float() - start[m][k].float()))
        leaves[f"{m}/{k}"] = {"grad_ref": g, "grad_gap": abs(g_ours[(m, k)] - g) / max(g, med),
                              "change_ref": d_ref, "change_ours": d_ours}
    return {"loss_gaps": [abs(a - b) / abs(b) for a, b in zip(ours["losses"], ref["losses"])],
            "leaves": leaves}


def view_gap(ours: torch.Tensor, ref: torch.Tensor) -> float:
    """Mean |pixel difference| of one view (every channel)."""
    return float((ours.float() - ref.float()).abs().mean())


def judge(readings: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """{name: {'value', 'limit', 'ok'}} of every limited number."""
    out = {}
    for name, limit in limits.items():
        value = readings.get(name, float("nan"))
        out[name] = {"value": value, "limit": limit,
                     "ok": math.isfinite(value) and value <= limit}
    return out
