"""A fitted model's weights carried into the port from plain arrays.

The port fits its predictors itself (``trees.fit_tree``, ``fit_forest``,
``fit_gbm``: the reference's arrays bit for bit from the same data), and
these functions rebuild them from arrays fitted elsewhere: a tree is its
``feature``, ``threshold``, ``left``, ``right``, ``value`` arrays and its
``depth``; a forest its trees; a quantile GBM ``f0``, ``lr``, ``tau`` and
its stages.  Only numpy arrays and numbers go in, never another package's
objects; the arrays are copied in the dtypes the fit gives them.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.predictors.forest import RandomForest
from repro_torch.core.predictors.gbm import QuantileGBM
from repro_torch.core.predictors.models import (LatencySensitivityModel,
                                                UntouchedMemoryModel)
from repro_torch.core.predictors.trees import Tree

#: a tree's arrays and the dtypes ``fit_tree`` stores them in
TREE_ARRAYS = {"feature": np.int32, "threshold": np.float32,
               "left": np.int32, "right": np.int32, "value": np.float32}


def tree_from_arrays(feature, threshold, left, right, value,
                     depth: int) -> Tree:
    """One CART from its flat node arrays (all of one length)."""
    arrs = {k: np.array(a, dt) for (k, dt), a in zip(
        TREE_ARRAYS.items(), (feature, threshold, left, right, value))}
    n = len(arrs["feature"])
    if any(a.shape != (n,) for a in arrs.values()):
        raise ValueError("tree arrays must be 1-D of one length; got "
                         f"{ {k: a.shape for k, a in arrs.items()} }")
    n_leaf = int((arrs["feature"] < 0).sum())
    inner = arrs["feature"] >= 0
    if n and (n_leaf == 0 or (arrs["left"][inner] >= n).any()
              or (arrs["right"][inner] >= n).any()):
        raise ValueError("tree arrays: a child index is out of range or "
                         "the tree has no leaf")
    return Tree(**arrs, depth=int(depth))


def forest_from_arrays(trees: list[dict]) -> RandomForest:
    """A RandomForest from one dict of :func:`tree_from_arrays` arguments
    a tree."""
    return RandomForest([tree_from_arrays(**t) for t in trees])


def gbm_from_arrays(f0: float, lr: float, tau: float,
                    stages: list[dict]) -> QuantileGBM:
    """A QuantileGBM from its base value, rate, quantile and stages."""
    return QuantileGBM(float(f0), [tree_from_arrays(**t) for t in stages],
                       float(lr), float(tau))


def latency_model_from_arrays(pdm: float,
                              trees: list[dict]) -> LatencySensitivityModel:
    """Pond's latency-sensitivity model over a forest given as arrays."""
    model = LatencySensitivityModel(pdm=float(pdm))
    model.forest = forest_from_arrays(trees)
    return model


def untouched_model_from_arrays(tau: float, f0: float, lr: float,
                                stages: list[dict]) -> UntouchedMemoryModel:
    """Pond's untouched-memory model over a quantile GBM given as arrays."""
    model = UntouchedMemoryModel(float(tau))
    model.gbm = gbm_from_arrays(f0, lr, tau, stages)
    return model
