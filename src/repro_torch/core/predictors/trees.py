"""CART decision trees: numpy fit, array-form vectorised inference.

Trees are stored as flat arrays (feature, threshold, left, right, value)
so inference is a fixed-depth gather loop, vectorised in numpy.  This is
the substrate of Pond's two models: the RandomForest
latency-insensitivity classifier and the quantile-GBM untouched-memory
regressor (§4.4/§5 — sklearn/LightGBM in the paper, written from scratch
here).  A copy of the reference's numpy half: the same generator calls in
the same order, so a fit gives the reference's arrays bit for bit.  The
packed-ensemble inference (:func:`predict_stack_torch`, the reference's
``predict_stack_jax``) is an eager, depth-bounded gather loop in torch on
the ensemble's device, float32 like the reference's: it agrees with the
numpy walk to float32 rounding of the ensemble sums, not bitwise.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Tree:
    feature: np.ndarray     # (n_nodes,) int32, -1 for leaf
    threshold: np.ndarray   # (n_nodes,) float32
    left: np.ndarray        # (n_nodes,) int32
    right: np.ndarray       # (n_nodes,) int32
    value: np.ndarray       # (n_nodes,) float32 (leaf prediction)
    depth: int

    def predict(self, x: np.ndarray) -> np.ndarray:
        return self.value[self.leaf_index(x)]

    def leaf_index(self, x: np.ndarray) -> np.ndarray:
        idx = np.zeros(len(x), np.int32)
        for _ in range(self.depth + 1):
            f = self.feature[idx]
            leaf = f < 0
            go_left = np.where(
                leaf, True,
                x[np.arange(len(x)), np.maximum(f, 0)] <= self.threshold[idx])
            nxt = np.where(go_left, self.left[idx], self.right[idx])
            idx = np.where(leaf, idx, nxt)
        return idx


def _best_split(x, y, feat_ids, min_leaf, n_thresholds=16):
    """Greedy variance-reduction split over candidate quantile thresholds."""
    n = len(y)
    best = (None, None, np.inf)
    parent = np.var(y) * n
    for f in feat_ids:
        xv = x[:, f]
        qs = np.unique(np.quantile(
            xv, np.linspace(0.05, 0.95, n_thresholds)))
        for t in qs:
            mask = xv <= t
            nl = int(mask.sum())
            if nl < min_leaf or n - nl < min_leaf:
                continue
            yl, yr = y[mask], y[~mask]
            score = np.var(yl) * nl + np.var(yr) * (n - nl)
            if score < best[2]:
                best = (f, t, score)
    if best[0] is None or best[2] >= parent - 1e-12:
        return None
    return best[0], best[1]


def fit_tree(x: np.ndarray, y: np.ndarray, max_depth: int = 6,
             min_leaf: int = 8, max_features: int | None = None,
             rng: np.random.Generator | None = None) -> Tree:
    rng = rng or np.random.default_rng(0)
    nodes = {"feature": [], "threshold": [], "left": [], "right": [],
             "value": []}

    def new_node():
        for k in nodes:
            nodes[k].append(0 if k != "feature" else -1)
        return len(nodes["feature"]) - 1

    def build(idx_samples, depth):
        nid = new_node()
        ys = y[idx_samples]
        nodes["value"][nid] = float(np.mean(ys)) if len(ys) else 0.0
        if depth >= max_depth or len(idx_samples) < 2 * min_leaf \
                or np.all(ys == ys[0]):
            return nid
        nfeat = x.shape[1]
        feats = (rng.choice(nfeat, size=min(max_features or nfeat, nfeat),
                            replace=False))
        sp = _best_split(x[idx_samples], ys, feats, min_leaf)
        if sp is None:
            return nid
        f, t = sp
        mask = x[idx_samples, f] <= t
        nodes["feature"][nid] = int(f)
        nodes["threshold"][nid] = float(t)
        nodes["left"][nid] = build(idx_samples[mask], depth + 1)
        nodes["right"][nid] = build(idx_samples[~mask], depth + 1)
        return nid

    build(np.arange(len(y)), 0)
    return Tree(np.array(nodes["feature"], np.int32),
                np.array(nodes["threshold"], np.float32),
                np.array(nodes["left"], np.int32),
                np.array(nodes["right"], np.int32),
                np.array(nodes["value"], np.float32),
                max_depth)


def pack_trees(trees: list[Tree]) -> dict:
    """Pad trees to equal node count -> stacked numpy arrays (T, n)."""
    n = max(len(t.feature) for t in trees)

    def pad(a, fill):
        return np.stack([np.pad(getattr(t, a), (0, n - len(t.feature)),
                                constant_values=fill) for t in trees])
    return {"feature": pad("feature", -1),
            "threshold": pad("threshold", 0.0),
            "left": pad("left", 0),
            "right": pad("right", 0),
            "value": pad("value", 0.0),
            "depth": max(t.depth for t in trees)}


def upload(packed: dict, device) -> dict:
    """A packed ensemble (:func:`pack_trees`, ``gbm.pack_gbms``) with its
    arrays as tensors on ``device``; ints (the depth) stay as they are."""
    return {k: torch.as_tensor(v, device=device)
            if isinstance(v, (np.ndarray, torch.Tensor)) else v
            for k, v in packed.items()}


def predict_stack_torch(packed: dict, x) -> torch.Tensor:
    """Per-tree predictions of a packed ensemble: x (B, F) -> (T, B).

    ``packed``: :func:`pack_trees`' arrays as tensors (:func:`upload`);
    every tree walks ``depth + 1`` steps, all trees and rows at once (a
    leaf stays where it is).  ``x`` goes to the ensemble's device as
    float32.  The substrate of the forest mean (:func:`predict_torch`),
    the GBM's ``f0 + lr * sum`` and the multi-model grid path
    (``gbm.predict_gbms_torch``).
    """
    feat, thr = packed["feature"], packed["threshold"]
    left, right, value = packed["left"], packed["right"], packed["value"]
    x = torch.as_tensor(x, dtype=torch.float32, device=feat.device)
    rows = torch.arange(x.shape[0], device=feat.device)[None, :]
    idx = torch.zeros((feat.shape[0], x.shape[0]), dtype=torch.long,
                      device=feat.device)
    for _ in range(packed["depth"] + 1):
        f = feat.gather(1, idx)
        xv = x[rows, f.clamp(min=0).long()]
        nxt = torch.where(xv <= thr.gather(1, idx), left.gather(1, idx),
                          right.gather(1, idx))
        idx = torch.where(f < 0, idx, nxt.long())
    return value.gather(1, idx)


def predict_torch(packed: dict, x) -> torch.Tensor:
    """Ensemble mean prediction.  x: (B, F) -> (B,) on the ensemble's
    device."""
    return predict_stack_torch(packed, x).mean(dim=0)


def predict_stack(trees: list[Tree], x: np.ndarray) -> np.ndarray:
    """numpy pendant of :func:`predict_stack_torch`: (T, B) per-tree
    predictions.  Each tree's gather loop is elementwise
    per row, so row ``i`` of the stack is bit-identical to predicting row
    ``i`` alone — the property the compiled policy engine's batched
    inference relies on."""
    return np.stack([t.predict(x) for t in trees])
