"""RandomForest classifier — Pond's latency-insensitivity model core (§5).

Bootstrap + per-split feature subsampling over ``trees.py``'s CART;
predicted probability = ensemble mean of leaf class fractions.  A copy of
the reference's numpy inference and fit, and its packed inference in torch
(:meth:`RandomForest.predict_proba_torch`).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.predictors import trees as T
from repro_torch.device import resolve_device


@dataclasses.dataclass
class RandomForest:
    trees: list
    # the packed ensemble on each device it ran on (predict_proba_torch)
    packed: dict = dataclasses.field(default_factory=dict, repr=False,
                                     compare=False)

    def predict_proba(self, x: np.ndarray) -> np.ndarray:
        return np.mean([t.predict(x) for t in self.trees], axis=0)

    def predict_proba_batch(self, x: np.ndarray) -> np.ndarray:
        """Batched probabilities whose row ``i`` is BIT-IDENTICAL to
        ``predict_proba(x[i:i+1])[0]``.

        ``predict_proba`` on a one-row batch reduces a contiguous
        ``(T, 1)`` float32 column, which numpy sums pairwise; the same
        reduction over a ``(T, N)`` batch runs the strided sequential
        loop instead and can differ in the last ulp.  Reducing the
        TRANSPOSED (row-contiguous) stack restores the pairwise order per
        row, so the compiled policy engine scores every VM in one call and
        still matches the control plane's per-VM probabilities bit for
        bit.
        """
        preds = T.predict_stack(self.trees, x)        # (T, N)
        return np.mean(np.ascontiguousarray(preds.T), axis=1)

    def predict_proba_torch(self, x, device=None):
        """Probabilities by the packed ensemble on ``device`` (the card
        when None, ``"cpu"`` on purpose): float32, the numpy walk's to
        ensemble rounding.  Returns a (B,) tensor on the device."""
        dev = resolve_device(device)
        if dev not in self.packed:
            self.packed[dev] = T.upload(T.pack_trees(self.trees), dev)
        return T.predict_torch(self.packed[dev], x)


def fit_forest(x: np.ndarray, y: np.ndarray, n_trees: int = 40,
               max_depth: int = 7, min_leaf: int = 8,
               max_features: int | None = None,
               seed: int = 0) -> RandomForest:
    """y: binary {0,1}; trees regress the class mean (== probability)."""
    rng = np.random.default_rng(seed)
    if max_features is None:
        max_features = max(1, int(np.sqrt(x.shape[1])))
    forest = []
    n = len(y)
    for i in range(n_trees):
        idx = rng.integers(0, n, n)                  # bootstrap
        forest.append(T.fit_tree(x[idx], y[idx].astype(np.float32),
                                 max_depth=max_depth, min_leaf=min_leaf,
                                 max_features=max_features,
                                 rng=np.random.default_rng(seed + 100 + i)))
    return RandomForest(forest)
