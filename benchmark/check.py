"""The numbers that decide ``correct``, each held to a limit of its own
(``cells/<cell>.json``).

Training (the first three steps of the object the window then drives):

* ``loss_gap``: the first step's ``|L - L_ref| / L_ref``.  The later
  steps' losses carry rounding amplified by the steps before them (ReLU
  masks that flip on a rounding, Adagrad's normalised first steps), which
  reads alike in the program and in the reference run twice; the first
  step's does not (``PERF.md`` gives both readings).
* ``grad_gap``: the median leaf's ``|n - n_ref| / max(n_ref, median
  n_ref)`` of the first step's gradient norms, the program's worked out
  from its state after one step (SGD: the change over the learning rate;
  Adagrad: the square root of the accumulator, row-wise times the width).
  The worst leaf is a table whose summed gradient cancels, where the same
  amplified rounding reads up to ten times the median leaf's.
* ``change_gap``: the worst leaf's gap of the norms of each leaf's change
  after three steps, leaving out a leaf whose reference gradient norm is
  under a thousandth of the median leaf's (it moves by round-off alone).

A leaf is a dense weight or bias, or one table's touched rows.

Serving: ``score_gap``, the largest ``|p - p_ref|`` over every score of the
sampled batches that the window served; a missing or misshapen answer reads
infinite.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Sequence

LEAF_FLOOR = 1e-3   # of the median leaf's reference gradient norm


def leaf_gaps(prog: Sequence[float], ref: Sequence[float],
              keep: Sequence[bool]) -> List[float]:
    """``|n - n_ref| / max(n_ref, median n_ref)`` of each kept leaf."""
    scale = statistics.median(ref)
    return [abs(p - r) / max(r, scale, 1e-30)
            if math.isfinite(p) and math.isfinite(r) else math.inf
            for p, r, k in zip(prog, ref, keep) if k]


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog`` and ``ref`` hold ``losses`` (3), ``grad_norms`` and
    ``change_norms`` (one a leaf, in the same order)."""
    p, r = prog["losses"][0], ref["losses"][0]
    loss = abs(p - r) / max(abs(r), 1e-30) if math.isfinite(p) else math.inf
    if len(prog["losses"]) != len(ref["losses"]):
        loss = math.inf
    g_ref = ref["grad_norms"]
    floor = LEAF_FLOOR * statistics.median(g_ref)
    keep = [g >= floor for g in g_ref]
    return {"loss_gap": loss,
            "grad_gap": statistics.median(leaf_gaps(
                prog["grad_norms"], g_ref, [True] * len(g_ref))),
            "change_gap": max(leaf_gaps(prog["change_norms"],
                                        ref["change_norms"], keep))}


def leaves_left_out(ref: dict) -> List[int]:
    g_ref = ref["grad_norms"]
    floor = LEAF_FLOOR * statistics.median(g_ref)
    return [i for i, g in enumerate(g_ref) if g < floor]


def serve_numbers(pairs) -> Dict[str, float]:
    """``pairs``: (served scores, reference scores) of each compared
    answer, as tensors."""
    worst = 0.0 if pairs else math.inf
    for got, want in pairs:
        if got is None or tuple(got.shape) != tuple(want.shape):
            return {"score_gap": math.inf}
        d = (got.double() - want.double()).abs().max().item()
        worst = max(worst, d if math.isfinite(d) else math.inf)
    return {"score_gap": worst}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    missing = set(limits) - set(numbers)
    if missing:
        raise ValueError(f"no reading for the limits {sorted(missing)}")
    return all(numbers[k] <= limits[k] for k in limits)


def report(numbers: Dict[str, float], limits: Dict[str, float]) -> dict:
    """``{name: {"value", "limit"}}`` for the result line and stderr."""
    return {k: {"value": numbers[k] if math.isfinite(numbers[k]) else 1e300,
                "limit": limits[k]} for k in limits}
