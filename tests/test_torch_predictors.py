"""Pond's predictors in the port against the reference's: trees, forests
and quantile GBMs fitted in both packages on the same seeded data give the
same arrays and bitwise-equal predictions; batched inference equals
per-row calls; ``convert.py`` rebuilds the reference's fitted models from
their arrays.  (The packed inference in torch is held to the reference's jax
inference in ``tests/test_torch_policy_grid.py``.)"""
import functools

import numpy as np
import pytest

from repro.core import traces as jax_traces
from repro.core.predictors import trees as jax_trees
from repro.core.predictors.forest import fit_forest as jax_fit_forest
from repro.core.predictors.gbm import fit_gbm as jax_fit_gbm
from repro.core.predictors.models import (
    LatencySensitivityModel as JaxLatencySensitivityModel,
    UntouchedMemoryModel as JaxUntouchedMemoryModel,
    heuristic_curve as jax_heuristic_curve)
from repro_torch.core import traces
from repro_torch.core.predictors import convert
from repro_torch.core.predictors import trees as T
from repro_torch.core.predictors.forest import fit_forest
from repro_torch.core.predictors.gbm import fit_gbm
from repro_torch.core.predictors.models import (LatencySensitivityModel,
                                                UntouchedMemoryModel,
                                                heuristic_curve)
from tests._torch_port_util import port_vms

TREE_KEYS = ("feature", "threshold", "left", "right", "value")


def _assert_tree_equal(got, want):
    assert got.depth == want.depth
    for k in TREE_KEYS:
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype and a.tolist() == b.tolist(), k


def _arrays(tree):
    return {k: np.asarray(getattr(tree, k)) for k in TREE_KEYS} \
        | {"depth": tree.depth}


# ----------------------------------------------------------------- trees ---
def test_tree_learns_axis_split_and_equals_reference(rng):
    x = rng.normal(size=(400, 4)).astype(np.float32)
    y = (x[:, 2] > 0.3).astype(np.float32)
    t = T.fit_tree(x, y, max_depth=3)
    acc = ((t.predict(x) > 0.5) == (y > 0.5)).mean()
    assert acc > 0.97
    _assert_tree_equal(t, jax_trees.fit_tree(x, y, max_depth=3))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fit_tree_and_best_split_equal_reference(seed):
    """Feature subsampling draws from the generator in the reference's
    order, so every node array comes out the same."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(300, 6)).astype(np.float32)
    y = (np.sin(x[:, 0]) + x[:, 1] * x[:, 2]).astype(np.float32)
    got = T.fit_tree(x, y, max_depth=5, max_features=3,
                     rng=np.random.default_rng(seed))
    want = jax_trees.fit_tree(x, y, max_depth=5, max_features=3,
                              rng=np.random.default_rng(seed))
    _assert_tree_equal(got, want)
    assert got.predict(x).tolist() == want.predict(x).tolist()
    assert got.leaf_index(x).tolist() == want.leaf_index(x).tolist()
    feats = np.array([0, 2, 5])
    assert T._best_split(x, y, feats, 8) == \
        jax_trees._best_split(x, y, feats, 8)
    stack = T.predict_stack([got, got], x)
    assert stack.shape == (2, 300)
    assert stack.tolist() == jax_trees.predict_stack([want, want],
                                                     x).tolist()


def test_pack_trees_equals_reference():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(200, 5)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.float32)
    ts = [T.fit_tree(x, y, max_depth=d, rng=np.random.default_rng(d))
          for d in (2, 4)]
    got = T.pack_trees(ts)
    want = jax_trees.pack_trees(
        [jax_trees.fit_tree(x, y, max_depth=d, rng=np.random.default_rng(d))
         for d in (2, 4)])
    assert got["depth"] == want["depth"] == 4
    for k in TREE_KEYS:
        a, b = got[k], np.asarray(want[k])
        assert a.dtype == b.dtype and a.tolist() == b.tolist(), k


# ---------------------------------------------------------- ensembles ----
@pytest.mark.parametrize("tau", [0.1, 0.25, 0.5, 0.75])
def test_gbm_quantile_coverage_and_equals_reference(tau):
    rng = np.random.default_rng(int(tau * 100))
    x = rng.normal(size=(800, 3)).astype(np.float32)
    y = (x[:, 0] * 0.5 + rng.normal(0, 0.3, 800)).astype(np.float32)
    g = fit_gbm(x, y, tau=tau, n_stages=40)
    cov = (y < g.predict(x)).mean()
    assert abs(cov - tau) < 0.12, (cov, tau)
    want = jax_fit_gbm(x, y, tau=tau, n_stages=40)
    assert (g.f0, g.lr, g.tau) == (want.f0, want.lr, want.tau)
    for a, b in zip(g.stages, want.stages, strict=True):
        _assert_tree_equal(a, b)
    assert g.predict(x).tolist() == want.predict(x).tolist()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_forest_equals_reference_and_batch_matches_per_row(seed):
    """Forests fitted in both packages are equal tree by tree; the port's
    ``predict_proba_batch`` row i == ``predict_proba(x[i:i+1])[0]``
    BITWISE (the transposed pairwise reduction) and == the reference's."""
    rng = np.random.default_rng(100 + seed)
    x = rng.normal(size=(257, 8)).astype(np.float32)
    y = (x[:, 0] * x[:, 1] > 0).astype(np.float32)
    f = fit_forest(x, y, n_trees=40, seed=seed)
    want = jax_fit_forest(x, y, n_trees=40, seed=seed)
    for a, b in zip(f.trees, want.trees, strict=True):
        _assert_tree_equal(a, b)
    batch = f.predict_proba_batch(x)
    rows = np.array([f.predict_proba(x[i:i + 1])[0]
                     for i in range(len(x))])
    assert batch.tolist() == rows.tolist()
    assert batch.tolist() == want.predict_proba_batch(x).tolist()
    assert f.predict_proba(x).tolist() == want.predict_proba(x).tolist()


@pytest.mark.parametrize("seed,tau", [(0, 0.05), (1, 0.2), (2, 0.5)])
def test_gbm_batched_inference_matches_scalar(seed, tau):
    """Batched GBM quantile inference == per-row predictions bitwise
    (stage-sequential float32 accumulation is elementwise), and == the
    reference's."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(300, 5)).astype(np.float32)
    y = (x[:, 0] * 0.5 + rng.normal(0, 0.3, 300)).astype(np.float32)
    g = fit_gbm(x, y, tau=tau, n_stages=30, seed=seed)
    batch = g.predict(x)
    rows = np.array([g.predict(x[i:i + 1])[0] for i in range(len(x))])
    assert batch.tolist() == rows.tolist()
    want = jax_fit_gbm(x, y, tau=tau, n_stages=30, seed=seed)
    assert batch.tolist() == want.predict(x).tolist()


# --------------------------------------------------------- Pond's models ---
@functools.cache
def _models():
    """Both packages' LI and UM models fitted on the same 600 training
    VMs, and 300 held-out VMs (reference records, port records)."""
    pop = jax_traces.Population(seed=0)
    train = pop.sample_vms(600, 86400 * 10, seed=1)
    test = pop.sample_vms(300, 86400 * 10, seed=2, start_id=10 ** 6)
    ptrain, ptest = port_vms(train), port_vms(test)
    jhist, phist = jax_traces.build_history(train), \
        traces.build_history(ptrain)
    ut = np.array([v.untouched for v in train])
    jli = JaxLatencySensitivityModel(pdm=0.05).fit(
        jax_traces.pmu_matrix(train), jax_traces.slowdowns(train, 182))
    pli = LatencySensitivityModel(pdm=0.05).fit(
        traces.pmu_matrix(ptrain), traces.slowdowns(ptrain, 182))
    jum = JaxUntouchedMemoryModel(0.05).fit(
        jax_traces.metadata_features(train, jhist), ut)
    pum = UntouchedMemoryModel(0.05).fit(
        traces.metadata_features(ptrain, phist), ut)
    return (train, test, jhist, jli, jum), (ptrain, ptest, phist, pli, pum)


def test_history_and_metadata_features_equal_reference():
    (train, test, jhist, *_), (ptrain, ptest, phist, *_) = _models()
    assert sorted(phist) == sorted(jhist)
    for c in jhist:
        assert phist[c].dtype == jhist[c].dtype
        assert phist[c].tolist() == jhist[c].tolist()
    for hist in (None, {}, jhist):
        got = traces.metadata_features(ptest, hist)
        want = jax_traces.metadata_features(test, hist)
        assert got.dtype == want.dtype == np.float32
        assert got.tolist() == want.tolist()


def test_pond_models_equal_reference_and_keep_their_findings():
    """The LI forest and the UM GBM fitted in both packages are equal and
    predict the same bits; the port's LI model still beats the
    single-counter heuristic (Finding 5) and its UM model the static
    strawman (Finding 6)."""
    (_, test, jhist, jli, jum), (_, ptest, phist, pli, pum) = _models()
    pmu, s_te = traces.pmu_matrix(ptest), traces.slowdowns(ptest, 182)
    for a, b in zip(pli.forest.trees, jli.forest.trees, strict=True):
        _assert_tree_equal(a, b)
    assert pli.p_sensitive(pmu).tolist() == \
        jli.p_sensitive(pmu).tolist()
    assert pli.p_sensitive_batch(pmu).tolist() == \
        jli.p_sensitive_batch(pmu).tolist()
    assert pli.insensitive(pmu, 0.3).tolist() == \
        jli.insensitive(pmu, 0.3).tolist()
    want_curve = jli.curve(pmu, s_te)
    assert [(p.threshold, p.li_frac, p.fp_frac)
            for p in pli.curve(pmu, s_te)] == \
        [(p.threshold, p.li_frac, p.fp_frac) for p in want_curve]
    pt = pli.threshold_for_fp(pmu, s_te, 0.02)
    want_pt = jli.threshold_for_fp(pmu, s_te, 0.02)
    assert (pt.threshold, pt.li_frac, pt.fp_frac) == \
        (want_pt.threshold, want_pt.li_frac, want_pt.fp_frac)
    heur = heuristic_curve(pmu[:, 0], s_te)
    assert [(p.threshold, p.li_frac, p.fp_frac) for p in heur] == \
        [(p.threshold, p.li_frac, p.fp_frac)
         for p in jax_heuristic_curve(pmu[:, 0], s_te)]
    assert pt.li_frac >= max((p.li_frac for p in heur
                              if p.fp_frac <= 0.02), default=0.0)
    meta = traces.metadata_features(ptest, phist)
    pred = pum.predict(meta)
    assert pred.tolist() == jum.predict(meta).tolist()
    ut_te = np.array([v.untouched for v in ptest])
    op, static_op = (ut_te < pred).mean(), (ut_te < pred.mean()).mean()
    assert op < static_op / 2.5 and pred.mean() > 0.15
    got = [(p.tau, p.um_frac, p.op_frac) for p in
           UntouchedMemoryModel.static_curve(ut_te)]
    assert got == [(p.tau, p.um_frac, p.op_frac) for p in
                   JaxUntouchedMemoryModel.static_curve(ut_te)]


def test_convert_rebuilds_the_reference_models_from_arrays():
    (_, test, jhist, jli, jum), (_, ptest, phist, _, _) = _models()
    li = convert.latency_model_from_arrays(
        jli.pdm, [_arrays(t) for t in jli.forest.trees])
    um = convert.untouched_model_from_arrays(
        jum.tau, jum.gbm.f0, jum.gbm.lr,
        [_arrays(t) for t in jum.gbm.stages])
    assert isinstance(li, LatencySensitivityModel) and li.pdm == jli.pdm
    for a, b in zip(li.forest.trees, jli.forest.trees, strict=True):
        _assert_tree_equal(a, b)
    pmu = traces.pmu_matrix(ptest)
    assert li.p_sensitive_batch(pmu).tolist() == \
        jli.p_sensitive_batch(pmu).tolist()
    meta = traces.metadata_features(ptest, phist)
    assert (um.tau, um.gbm.f0, um.gbm.lr) == \
        (jum.tau, jum.gbm.f0, jum.gbm.lr)
    assert um.predict(meta).tolist() == jum.predict(meta).tolist()


@pytest.mark.parametrize("breakage", ["length", "child", "no_leaf"])
def test_convert_refuses_inconsistent_tree_arrays(breakage):
    arrs = dict(feature=[0, -1, -1], threshold=[0.5, 0, 0], left=[1, 0, 0],
                right=[2, 0, 0], value=[0.0, 0.1, 0.9], depth=1)
    tree = convert.tree_from_arrays(**arrs)
    assert tree.predict(np.array([[0.0], [1.0]], np.float32)).tolist() == \
        [np.float32(0.1), np.float32(0.9)]
    if breakage == "length":
        arrs["value"] = [0.0, 0.1]
    elif breakage == "child":
        arrs["right"] = [3, 0, 0]
    else:
        arrs["feature"] = [0, 0, 0]
    with pytest.raises(ValueError):
        convert.tree_from_arrays(**arrs)
