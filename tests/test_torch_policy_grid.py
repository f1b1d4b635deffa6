"""The grid axis of Fig 17 in the port against the reference (ROADMAP M8b).

``policy_engine.PolicySetting``/``make_grid``/``thresholds_for_fp``/
``fit_um_grid``/``grid_decisions`` and the packed predictor inference
they call (``trees.predict_stack_torch``/``predict_torch``,
``RandomForest.predict_proba_torch``, ``QuantileGBM.predict_torch``,
``gbm.pack_gbms``/``predict_gbms_torch``), with models fitted in both
packages on the same seeded data:

* ``grid_decisions(backend="numpy")`` ``==`` the reference's and ``==`` a
  fresh port control plane a setting;
* the torch backend (on the CPU here) floors to the numpy backend's
  ``pool_gb`` and ``fully_pooled`` on the reference test's 300 VMs, as the
  reference holds its jax backend;
* the packed inference within float32 rounding (rtol and atol 1e-5) of
  the reference's jax inference and of the numpy walk;
* ``savings_analysis_batched(decisions=grid)`` ``==`` the reference's on
  the 8-server world.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import cluster_sim as jax_cs
from repro.core import policy_engine as jax_pe
from repro.core import traces as jax_traces
from repro.core.predictors import gbm as jax_gbm
from repro.core.predictors import trees as jax_trees
from repro.core.predictors.forest import fit_forest as jax_fit_forest
from repro.core.predictors.models import (
    LatencySensitivityModel as JaxLatencySensitivityModel)
from repro_torch.core import cluster_sim, policy_engine, traces
from repro_torch.core.control_plane import ControlPlane, ControlPlaneConfig
from repro_torch.core.pool_manager import PoolManager
from repro_torch.core.predictors import gbm as G
from repro_torch.core.predictors import trees as T
from repro_torch.core.predictors.forest import fit_forest
from repro_torch.core.predictors.models import LatencySensitivityModel
from tests._torch_port_util import PORT_WORLD_CFG, WORLD_CFG, port_vms

HORIZON = 5 * 86400
TOL = dict(rtol=1e-5, atol=1e-5)


@functools.cache
def _world():
    """The reference test's training world, fitted in both packages:
    (port: li, hist, meta, untouched, pmu, slowdowns; reference: li)."""
    train = jax_traces.Population(seed=0).sample_vms(600, HORIZON, seed=1)
    ptrain = port_vms(train)
    pmu, slows = traces.pmu_matrix(ptrain), traces.slowdowns(ptrain, 182)
    li = LatencySensitivityModel(pdm=0.05).fit(pmu, slows)
    ref_li = JaxLatencySensitivityModel(pdm=0.05).fit(
        jax_traces.pmu_matrix(train), jax_traces.slowdowns(train, 182))
    hist = traces.build_history(ptrain)
    meta = traces.metadata_features(ptrain, hist)
    ut = np.array([v.untouched for v in ptrain])
    return li, hist, meta, ut, pmu, slows, ref_li


@functools.cache
def _um_models(taus, package="port"):
    """``fit_um_grid`` of the training world, in one package, fitted once."""
    li, hist, meta, ut, *_ = _world()
    fit = policy_engine if package == "port" else jax_pe
    return fit.fit_um_grid(meta, ut, taus)


def _trace(n, seed):
    """(reference VMs, the same VMs in the port)."""
    vms = jax_traces.Population(seed=0).sample_vms(n, HORIZON, seed=seed,
                                                   start_id=10 ** 6)
    return vms, port_vms(vms)


def _tuples(dec):
    return [(float(l), float(p), bool(f), None if np.isnan(t) else float(t))
            for l, p, f, t in zip(dec.local_gb, dec.pool_gb,
                                  dec.fully_pooled, dec.t_migrate)]


def _fitted_arrays(um_models):
    return {tau: (m.gbm.f0, m.gbm.lr, [
        [getattr(s, k).tolist() for k in ("feature", "threshold", "left",
                                          "right", "value")]
        for s in m.gbm.stages]) for tau, m in um_models.items()}


# -------------------------------------------------------------- the grid ---
def test_fit_um_grid_gives_the_references_models():
    got = _um_models((0.05, 0.3, 0.05))
    want = _um_models((0.05, 0.3, 0.05), "reference")
    assert sorted(got) == sorted(want) == [0.05, 0.3]
    assert _fitted_arrays(got) == _fitted_arrays(want)


def test_make_grid_resolves_fp_targets_like_the_reference():
    li, hist, meta, ut, pmu, slows, ref_li = _world()
    got = policy_engine.make_grid(taus=(0.02, 0.2), pdms=(0.05, 0.1),
                                  fp_targets=(0.005, 0.02, 0.05),
                                  li_model=li, pmu=pmu, slowdowns=slows)
    want = jax_pe.make_grid(taus=(0.02, 0.2), pdms=(0.05, 0.1),
                            fp_targets=(0.005, 0.02, 0.05), li_model=ref_li,
                            pmu=pmu, slowdowns=slows)
    assert len(got) == 12
    assert [dataclasses.astuple(s) for s in got] == \
        [dataclasses.astuple(s) for s in want]
    assert [s.label for s in got] == [s.label for s in want]
    assert policy_engine.thresholds_for_fp(li, pmu, slows, (0.01,)) == \
        jax_pe.thresholds_for_fp(ref_li, pmu, slows, (0.01,))
    # a looser FP budget admits at least as large a threshold
    assert got[2].li_threshold >= got[0].li_threshold
    raw = policy_engine.make_grid(taus=(0.05,), li_thresholds=(0.05, 0.5))
    assert [dataclasses.astuple(s) for s in raw] == [
        dataclasses.astuple(s) for s in jax_pe.make_grid(
            taus=(0.05,), li_thresholds=(0.05, 0.5))]
    with pytest.raises(ValueError, match="fp_targets"):
        policy_engine.make_grid(taus=(0.05,), fp_targets=(0.01,))


@pytest.mark.parametrize("seed", [6, 7, 8])
def test_grid_decisions_numpy_equals_reference_and_fresh_planes(seed):
    """Every grid row ``==`` the reference's numpy grid and a fresh port
    control plane configured with that setting; two traces in one call."""
    li, hist, meta, ut, pmu, slows, ref_li = _world()
    taus = (0.05, 0.3)
    um_models = _um_models(taus)
    settings = policy_engine.make_grid(taus=taus, pdms=(0.02, 0.05),
                                       li_thresholds=(0.05, 0.4))
    ref_settings = jax_pe.make_grid(taus=taus, pdms=(0.02, 0.05),
                                    li_thresholds=(0.05, 0.4))
    traces_ = [_trace(250, seed), _trace(180, seed + 10)]
    grid = policy_engine.grid_decisions([p for _, p in traces_], settings,
                                        li, um_models, hist)
    want = jax_pe.grid_decisions([v for v, _ in traces_], ref_settings,
                                 ref_li, _um_models(taus, "reference"),
                                 hist, backend="numpy")
    assert len(grid) == 8 and all(len(r) == 2 for r in grid)
    for s, row, ref_row in zip(settings, grid, want):
        for k, (dec, ref) in enumerate(zip(row, ref_row)):
            assert _tuples(dec) == _tuples(ref), s.label
            assert (dec.mispredictions, dec.n_mitigations) == \
                (ref.mispredictions, ref.n_mitigations)
            cp = ControlPlane(ControlPlaneConfig(li_threshold=s.li_threshold),
                              li, um_models[s.tau],
                              PoolManager(pool_gb=4096, buffer_gb=64),
                              history=dict(hist))
            fresh, mis = cluster_sim.policy_decisions(
                traces_[k][1], "pond", cp, pdm=s.pdm, as_arrays=True)
            assert _tuples(dec) == _tuples(fresh), s.label
            assert dec.mispredictions == mis
            assert dec.n_mitigations == len(cp.mitigation.log)


def test_grid_torch_backend_floors_to_numpy():
    """The reference's jax-backend test: 300 VMs, two taus, two
    thresholds; the torch backend's floored decisions equal numpy's."""
    li, hist, meta, ut, *_ = _world()
    _, vms = _trace(300, 8)
    taus = (0.05, 0.2)
    um_models = _um_models(taus)
    settings = policy_engine.make_grid(taus=taus, li_thresholds=(0.05, 0.5))
    g_np = policy_engine.grid_decisions([vms], settings, li, um_models,
                                        hist, backend="numpy")
    g_t = policy_engine.grid_decisions([vms], settings, li, um_models, hist,
                                       backend="torch", device="cpu")
    for a, b in zip(g_np, g_t):
        assert a[0].pool_gb.tolist() == b[0].pool_gb.tolist()
        assert a[0].fully_pooled.tolist() == b[0].fully_pooled.tolist()
    with pytest.raises(ValueError, match="backend"):
        policy_engine.grid_decisions([vms], settings, li, um_models, hist,
                                     backend="jax")
    assert policy_engine.grid_decisions([], settings, li, um_models,
                                        hist) == [[]] * 4


def test_grid_prices_through_savings_analysis_batched():
    """Fig 17's path on the 8-server world: the grid's decisions priced
    by ``savings_analysis_batched(decisions=...)`` ``==`` the reference's
    (two settings x two traces, the trace list repeating per setting)."""
    li, hist, meta, ut, pmu, slows, ref_li = _world()
    taus = (0.05, 0.2)
    um_models = _um_models(taus)
    settings = policy_engine.make_grid(taus=taus, li_thresholds=(0.3,))
    horizon = 2 * 86400
    n = jax_cs.arrivals_for_util(WORLD_CFG, 0.8, horizon)
    ref_vms = [jax_traces.Population(seed=0).sample_vms(
        n, horizon, seed=s, start_id=10 ** 6) for s in (3, 4)]
    vms = [port_vms(v) for v in ref_vms]
    grid = policy_engine.grid_decisions(vms, settings, li, um_models, hist)
    ref_grid = jax_pe.grid_decisions(ref_vms, jax_pe.make_grid(
        taus=taus, li_thresholds=(0.3,)), ref_li,
        _um_models(taus, "reference"), hist, backend="numpy")
    flat = [grid[s][k] for s in range(2) for k in range(2)]
    got = cluster_sim.savings_analysis_batched(
        [v for _ in settings for v in vms], PORT_WORLD_CFG, "pond-grid",
        decisions=flat, device="cpu")
    want = jax_cs.savings_analysis_batched(
        [v for _ in settings for v in ref_vms], WORLD_CFG, "pond-grid",
        decisions=[ref_grid[s][k] for s in range(2) for k in range(2)])
    assert [dataclasses.astuple(r) for r in got] == \
        [dataclasses.astuple(r) for r in want]
    assert all(r.pool_group_gb > 0 for r in got)


# ----------------------------------------------------- packed inference ---
def _xy(seed, n, f):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    return rng, x


def test_packed_trees_match_reference_jax_and_numpy():
    rng, x = _xy(0, 300, 6)
    y = (np.sin(x[:, 0]) + x[:, 1] * x[:, 2]).astype(np.float32)
    ts = [T.fit_tree(x, y, max_depth=5, rng=np.random.default_rng(i))
          for i in range(4)]
    packed = T.upload(T.pack_trees(ts), "cpu")
    got = T.predict_torch(packed, x).numpy()
    ref = np.asarray(jax_trees.predict_jax(jax_trees.pack_trees(
        [jax_trees.fit_tree(x, y, max_depth=5, rng=np.random.default_rng(i))
         for i in range(4)]), jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(got, np.mean([t.predict(x) for t in ts], 0),
                               **TOL)
    # each tree's own walk: the same leaves as the numpy walk, exactly
    assert T.predict_stack_torch(packed, x).numpy().tolist() == \
        T.predict_stack(ts, x).tolist()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_forest_torch_matches_reference_jax_and_numpy(seed):
    rng, x = _xy(seed, 250, 8)
    y = (x[:, seed % 8] + rng.normal(0, 0.4, 250) > 0).astype(np.float32)
    f = fit_forest(x, y, n_trees=15, seed=seed)
    got = f.predict_proba_torch(x, "cpu").numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(
        got, np.asarray(jax_fit_forest(x, y, n_trees=15, seed=seed)
                        .predict_proba_jax(x)), **TOL)
    np.testing.assert_allclose(got, f.predict_proba(x), **TOL)
    assert len(f.packed) == 1          # packed and uploaded once a device
    f.predict_proba_torch(x[:7], "cpu")
    assert len(f.packed) == 1


@pytest.mark.parametrize("seed,tau", [(0, 0.05), (1, 0.2), (2, 0.5)])
def test_gbm_torch_matches_reference_jax_and_numpy(seed, tau):
    rng, x = _xy(seed, 300, 5)
    y = (x[:, 0] * 0.5 + rng.normal(0, 0.3, 300)).astype(np.float32)
    g = G.fit_gbm(x, y, tau=tau, n_stages=30, seed=seed)
    got = g.predict_torch(x, "cpu").numpy()
    ref = jax_gbm.fit_gbm(x, y, tau=tau, n_stages=30, seed=seed)
    np.testing.assert_allclose(got, np.asarray(ref.predict_jax(x)), **TOL)
    np.testing.assert_allclose(got, g.predict(x), rtol=1e-4, atol=2e-5)


def test_packed_gbm_grid_matches_reference_and_per_model():
    """``pack_gbms`` + ``predict_gbms_torch``, stage-count padding
    included, against the reference's vmapped call and each model's own
    torch inference."""
    rng, x = _xy(3, 200, 4)
    y = (x[:, 0] + rng.normal(0, 0.2, 200)).astype(np.float32)
    spec = ((0.05, 10), (0.2, 25), (0.5, 17))
    models = [G.fit_gbm(x, y, tau=t, n_stages=s) for t, s in spec]
    packed = G.pack_gbms(models)
    assert packed["feature"].shape[:2] == (3, 25)
    assert isinstance(packed["feature"], np.ndarray)
    grid = G.predict_gbms_torch(packed, x, "cpu").numpy()
    assert grid.shape == (3, 200)
    ref = np.asarray(jax_gbm.predict_gbms_jax(jax_gbm.pack_gbms(
        [jax_gbm.fit_gbm(x, y, tau=t, n_stages=s) for t, s in spec]), x))
    np.testing.assert_allclose(grid, ref, **TOL)
    for i, m in enumerate(models):
        np.testing.assert_allclose(grid[i], m.predict_torch(x, "cpu").numpy(),
                                   **TOL)
