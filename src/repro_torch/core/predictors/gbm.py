"""Gradient-boosted trees with quantile (pinball) loss — Pond's
untouched-memory model core (§5: LightGBM quantile regression, rebuilt
from scratch).

Each stage fits a CART to the pinball-loss negative gradient
(tau - 1[y < F]) and then replaces leaf values with the tau-quantile of
the residuals inside the leaf (the exact line-search for pinball loss).
A lower tau gives a more conservative (under-)prediction of untouched
memory -> fewer overpredictions (OP), less pool usage (UM).  A copy of the
reference's numpy inference and fit, and its packed inference in torch:
one model (:meth:`QuantileGBM.predict_torch`) or a stack of them priced in
one pass (:func:`pack_gbms`, :func:`predict_gbms_torch`, the tau axis of
the policy grid).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.predictors import trees as T
from repro_torch.device import resolve_device


@dataclasses.dataclass
class QuantileGBM:
    f0: float
    stages: list
    lr: float
    tau: float
    # the packed stages on each device they ran on (predict_torch)
    packed: dict = dataclasses.field(default_factory=dict, repr=False,
                                     compare=False)

    def predict(self, x: np.ndarray) -> np.ndarray:
        """Batched prediction.  Row ``i`` is bit-identical to predicting
        row ``i`` alone: every stage's tree walk is an elementwise gather
        and the ``+=`` accumulates stage by stage in the same float32
        order for any batch size."""
        out = np.full(len(x), self.f0, np.float32)
        for t in self.stages:
            out += self.lr * t.predict(x)
        return out

    def predict_torch(self, x, device=None):
        """Inference over the packed stage stack on ``device`` (the card
        when None): float32, :meth:`predict`'s to ensemble rounding, not
        bitwise.  Returns a (B,) tensor on the device."""
        dev = resolve_device(device)
        if dev not in self.packed:
            self.packed[dev] = T.upload(T.pack_trees(self.stages), dev)
        preds = T.predict_stack_torch(self.packed[dev], x)
        return self.f0 + self.lr * preds.sum(dim=0)


def pack_gbms(models: "list[QuantileGBM]") -> dict:
    """Stack several fitted GBMs into one padded set of numpy arrays.

    Pads every model's stages to a common (n_stages, n_nodes) shape —
    padding stages are single-leaf zero-value trees, so they contribute
    ``lr * 0`` — and stacks to ``(G, S, n)`` arrays plus per-model
    ``f0``/``lr`` float32 vectors.  :func:`predict_gbms_torch` prices all
    G models on one batch in one pass (upload it once with
    ``trees.upload``).
    """
    per = [T.pack_trees(m.stages) for m in models]
    s_max = max(p["feature"].shape[0] for p in per)
    n_max = max(p["feature"].shape[1] for p in per)

    def pad(p, key, fill):
        a = np.asarray(p[key])
        out = np.full((s_max, n_max), fill, a.dtype)
        out[:a.shape[0], :a.shape[1]] = a
        return out

    packed = {key: np.stack([pad(p, key, fill) for p in per])
              for key, fill in (("feature", -1), ("threshold", 0.0),
                                ("left", 0), ("right", 0), ("value", 0.0))}
    packed["depth"] = max(p["depth"] for p in per)
    packed["f0"] = np.array([m.f0 for m in models], np.float32)
    packed["lr"] = np.array([m.lr for m in models], np.float32)
    return packed


def predict_gbms_torch(packed: dict, x, device=None) -> torch.Tensor:
    """All models of a :func:`pack_gbms` stack on one batch: (G, B), on
    ``device`` (the card when None).  Every stage of every model walks in
    one gather loop; each model sums its stages, then ``f0 + lr * sum``
    in float32 as the reference's vmapped call does."""
    p = T.upload(packed, resolve_device(device))
    g, s, n = p["feature"].shape
    flat = {k: p[k].reshape(g * s, n)
            for k in ("feature", "threshold", "left", "right", "value")}
    preds = T.predict_stack_torch(dict(flat, depth=p["depth"]), x)
    return p["f0"][:, None] + p["lr"][:, None] \
        * preds.reshape(g, s, -1).sum(dim=1)


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
