"""Pond Eq.(1): combined-model constrained optimizer (§4.4, Figure 20).

    maximize  LI_PDM + UM
    s.t.      FP_PDM + OP  <=  100 - TP

Both terms are monotone tradeoff curves produced by the two models:
LI(FP) from the sensitivity model's threshold sweep, UM(OP) from the
untouched-memory model's quantile sweep.  Pond splits the (100-TP)
misprediction budget between FP and OP by grid search over the curves.
A copy of the reference's ``core/eqn1.py`` (host numpy): the scalar walk
``latency_engine.combine_grid`` is held to.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CombinedOperatingPoint:
    fp: float
    op: float
    li_frac: float            # workloads fully on pool
    um_frac: float            # untouched fraction pooled for the rest
    pool_dram_frac: float     # average cluster DRAM on pools
    mispredictions: float


def pool_fraction(li: float, um: float) -> float:
    """Average fraction of DRAM on the pool: insensitive VMs are fully
    pool-backed; the rest pool their untouched fraction (§4.4)."""
    return li + (1.0 - li) * um


def combine(li_curve, um_curve, pdm_budget: float,
            spill_harm_prob: float = 0.25) -> CombinedOperatingPoint:
    """li_curve: [(li_frac, fp_frac)]; um_curve: [(um_frac, op_frac)];
    budget = (100-TP)/100.  spill_harm_prob: probability an overprediction
    actually exceeds the PDM (~1/4 from Figure 16)."""
    best = CombinedOperatingPoint(0, 0, 0, 0, 0, 0)
    for li, fp in li_curve:
        if fp > pdm_budget:
            continue
        for um, op in um_curve:
            mis = fp + op * spill_harm_prob
            if mis > pdm_budget:
                continue
            pf = pool_fraction(li, um)
            if pf > best.pool_dram_frac:
                best = CombinedOperatingPoint(fp, op, li, um, pf, mis)
    return best


def frontier(li_curve, um_curve, budgets=None, spill_harm_prob=0.25):
    """Figure 20: pool fraction vs misprediction budget."""
    budgets = budgets if budgets is not None else \
        np.array([0.002, 0.005, 0.01, 0.02, 0.03, 0.05, 0.08, 0.12])
    return [(float(b), combine(li_curve, um_curve, float(b),
                               spill_harm_prob)) for b in budgets]
