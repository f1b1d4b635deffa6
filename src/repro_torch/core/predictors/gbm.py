"""Gradient-boosted trees with quantile (pinball) loss — Pond's
untouched-memory model core (§5: LightGBM quantile regression, rebuilt
from scratch).

Each stage fits a CART to the pinball-loss negative gradient
(tau - 1[y < F]) and then replaces leaf values with the tau-quantile of
the residuals inside the leaf (the exact line-search for pinball loss).
A lower tau gives a more conservative (under-)prediction of untouched
memory -> fewer overpredictions (OP), less pool usage (UM).  A copy of the
reference's numpy inference and fit (the packed multi-model inference of
the grid axis is ROADMAP M8b).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.predictors import trees as T


@dataclasses.dataclass
class QuantileGBM:
    f0: float
    stages: list
    lr: float
    tau: float

    def predict(self, x: np.ndarray) -> np.ndarray:
        """Batched prediction.  Row ``i`` is bit-identical to predicting
        row ``i`` alone: every stage's tree walk is an elementwise gather
        and the ``+=`` accumulates stage by stage in the same float32
        order for any batch size."""
        out = np.full(len(x), self.f0, np.float32)
        for t in self.stages:
            out += self.lr * t.predict(x)
        return out


def fit_gbm(x: np.ndarray, y: np.ndarray, tau: float = 0.2,
            n_stages: int = 60, lr: float = 0.15, max_depth: int = 4,
            min_leaf: int = 16, seed: int = 0) -> QuantileGBM:
    f = np.full(len(y), np.quantile(y, tau), np.float32)
    f0 = float(f[0])
    stages = []
    for s in range(n_stages):
        grad = np.where(y < f, tau - 1.0, tau).astype(np.float32)
        tree = T.fit_tree(x, grad, max_depth=max_depth, min_leaf=min_leaf,
                          rng=np.random.default_rng(seed + s))
        # exact leaf line-search: tau-quantile of residual within each leaf
        leaves = tree.leaf_index(x)
        resid = y - f
        new_vals = tree.value.copy()
        for leaf in np.unique(leaves):
            r = resid[leaves == leaf]
            if len(r):
                new_vals[leaf] = np.quantile(r, tau)
        tree.value[:] = new_vals
        f = f + lr * tree.predict(x)
        stages.append(tree)
    return QuantileGBM(f0, stages, lr, tau)
