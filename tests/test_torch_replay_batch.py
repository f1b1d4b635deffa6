"""The trace batch in the port against the reference's: ``CompiledReplayBatch``
rows ``==`` single-trace sweeps and the reference's batch, per-trace
candidates, refused shapes, ``search_min_multi`` replicating the scalar
bisection, ``peak_pool_demand``, ``pool_search_multi``, and
``savings_analysis_batched`` ``==`` the reference's for ``local``,
``static`` and ``pond`` (the pond planes' models carried across by
``predictors/convert.py``).  K1 runs its plain version here (CPU
tensors)."""
import dataclasses
import functools

import numpy as np
import pytest

from repro.core import cluster_sim as jax_cs
from repro.core import replay_engine as jax_re
from repro.core.control_plane import ControlPlane as JaxControlPlane
from repro.core.control_plane import ControlPlaneConfig as JaxCPConfig
from repro.core.pool_manager import PoolManager as JaxPoolManager
from repro_torch.core import cluster_sim as cs
from repro_torch.core import replay_engine as re
from repro_torch.core.control_plane import ControlPlane, ControlPlaneConfig
from repro_torch.core.pool_manager import PoolManager
from repro_torch.core.predictors import convert
from repro_torch.kernels.event_sweep import kernel as K
from repro_torch.kernels.event_sweep import ops
from tests._torch_port_util import (POOL, PORT_WORLD_CFG, SERVER, WORLD_CFG,
                                    _pond_models, port_decisions, port_world)

SEEDS = (3, 4, 5)
BIG_POOL = 768.0 * 8


@functools.cache
def _batches(policy):
    """(reference batch, port batch, port engines) over SEEDS."""
    worlds = [port_world(s, policy) for s in SEEDS]
    ref = jax_re.CompiledReplayBatch(
        [jax_re.CompiledReplay(v, d, WORLD_CFG) for v, d, _, _ in worlds])
    engines = [re.CompiledReplay(pv, pd, PORT_WORLD_CFG, device="cpu")
               for _, _, pv, pd in worlds]
    return ref, re.CompiledReplayBatch(engines), engines


@pytest.mark.parametrize("policy", ["static", "pond"])
def test_batch_rows_equal_single_sweeps_and_reference(policy):
    ref, batch, engines = _batches(policy)
    assert batch.k == ref.k == 3
    assert batch.n_vms.tolist() == ref.n_vms.tolist()
    assert batch.n_events.tolist() == ref.n_events.tolist()
    if policy == "pond":                 # MIGRATEs make the traces unequal
        assert len(set(batch.n_events.tolist())) > 1
    got = batch.reject_rates(SERVER, POOL)
    assert got.shape == (3, len(SERVER))
    want = np.stack([e.reject_rates(SERVER, POOL) for e in engines])
    assert got.tolist() == want.tolist()
    assert got.tolist() == ref.reject_rates(SERVER, POOL).tolist()
    assert (got > 0).any() and (got < got.max()).any()


@pytest.mark.parametrize("state_dtype", ["int16", "int32"])
def test_forced_state_dtype_equals_reference(state_dtype):
    ref, batch, _ = _batches("pond")
    got = batch.reject_rates(SERVER[1:6], POOL[1:6], state_dtype=state_dtype)
    want = ref.reject_rates(SERVER[1:6], POOL[1:6], state_dtype=state_dtype)
    assert got.tolist() == want.tolist()
    # the batch picks one state type: int16 only when every row packs
    sgb, pgb = re.sweep_core.quantize_capacities(
        np.broadcast_to(SERVER, (3, 8)), np.broadcast_to(POOL, (3, 8)))
    assert batch._pick_state_dtype(sgb, pgb) == ref._pick_state_dtype(sgb,
                                                                      pgb)
    big = np.full((3, 1), 40_000.0)
    assert batch._pick_state_dtype(big, big) == "int32"


def test_per_trace_candidates_and_narrow_batches():
    ref, batch, engines = _batches("static")
    per_s = np.stack([SERVER + 8.0 * i for i in range(3)])
    got = batch.reject_rates(per_s, POOL)
    assert got.tolist() == [e.reject_rates(per_s[i], POOL).tolist()
                            for i, e in enumerate(engines)]
    assert got.tolist() == ref.reject_rates(per_s, POOL).tolist()
    one = batch.reject_rates(250.0, 100.0)
    assert one.shape == (3, 1)
    assert one[:, 0].tolist() == [e.reject_rates(250.0, 100.0)[0]
                                  for e in engines]
    with pytest.raises(ValueError, match="per-trace"):
        batch.reject_rates(np.zeros((2, 4)), 0.0)


def test_batch_past_the_kernels_trace_limit_launches_in_parts(monkeypatch):
    """More traces than a launch takes (``kernel.MAX_TRACES``): the batch
    sweeps them in parts, one per launch, with the same rows."""
    ref, batch, _ = _batches("pond")
    want = batch.reject_rates(SERVER, POOL)
    monkeypatch.setattr(K, "MAX_TRACES", 2)
    re.stats_reset()
    assert batch.reject_rates(SERVER, POOL).tolist() == want.tolist()
    assert [n for n, _ in re.stage_times().sweeps] == [2 * 8, 8]
    assert re.stats_snapshot()["sweeps"] == 1


def test_batch_refuses_mismatched_shapes_and_unported_options():
    _, _, pvms, pdec = port_world(3, "static")
    eng = re.CompiledReplay(pvms, pdec, PORT_WORLD_CFG, device="cpu")
    other_cfg = cs.ClusterConfig(n_servers=4, pool_sockets=8,
                                 gb_per_core=4.75)
    other = re.CompiledReplay(pvms, pdec, other_cfg, device="cpu")
    with pytest.raises(ValueError, match="cluster shape"):
        re.CompiledReplayBatch([eng, other])
    with pytest.raises(ValueError):
        re.CompiledReplayBatch([])
    batch = re.CompiledReplayBatch([eng])
    # devices="all" on a CPU batch is the single-device path (M13)
    assert batch.reject_rates(SERVER, POOL, devices="all").tolist() == \
        batch.reject_rates(SERVER, POOL).tolist()
    frac = dataclasses.replace(pdec, pool_gb=pdec.pool_gb + 0.5)
    odd = re.CompiledReplay(pvms, frac, PORT_WORLD_CFG, device="cpu")
    # non-integral decisions: the integer sweep refuses them, "auto" asks
    # each engine (the numpy backend for the fractional trace, M1b)
    mixed = re.CompiledReplayBatch([eng, odd])
    with pytest.raises(NotImplementedError, match="numpy"):
        mixed.reject_rates(SERVER, POOL, backend="torch")
    assert mixed.reject_rates(SERVER, POOL).tolist() == [
        eng.reject_rates(SERVER, POOL).tolist(),
        odd.reject_rates(SERVER, POOL, backend="numpy").tolist()]
    with pytest.raises(RuntimeError, match="CUDA"):     # no card here
        re.CompiledReplayBatch([re.CompiledReplay(pvms, pdec,
                                                  PORT_WORLD_CFG)])


def test_batch_stats_count_like_the_reference():
    ref, batch, _ = _batches("pond")
    re.stats_reset()
    jax_re.stats_reset()
    batch.reject_rates(SERVER[:3], POOL[:3])
    ref.reject_rates(SERVER[:3], POOL[:3])
    got, want = re.stats_snapshot(), jax_re.stats_snapshot()
    for key in ("sweeps", "events", "candidate_events"):
        assert got[key] == want[key], key
    assert re.stage_times().sweeps == [(9, "int16")]


# ------------------------------------------------------------ searches ---
def test_search_min_multi_replicates_reference_and_scalar_bisection():
    ref, batch, _ = _batches("static")
    tol = batch.reject_rates(768.0, BIG_POOL)[:, 0] + 0.005
    assert tol.tolist() == (ref.reject_rates(768.0, BIG_POOL)[:, 0]
                            + 0.005).tolist()
    lo, hi = np.zeros(3), np.full(3, 768.0)
    got = re.search_min_multi(
        lambda g: batch.reject_rates(g, np.full_like(g, BIG_POOL))
        <= tol[:, None], lo, hi)
    want = jax_re.search_min_multi(
        lambda g: ref.reject_rates(g, np.full_like(g, BIG_POOL))
        <= tol[:, None], lo, hi)
    assert got.tolist() == want.tolist()
    for i, seed in enumerate(SEEDS):
        _, _, pvms, pdec = port_world(seed, "static")
        dec = pdec.as_vmdecisions()
        scalar = cs._search_min(
            lambda g: cs.replay_reject_rate(pvms, dec, PORT_WORLD_CFG, g,
                                            BIG_POOL) <= tol[i], 0.0, 768.0)
        assert got[i] == scalar


@pytest.mark.parametrize("policy", ["static", "pond"])
def test_peak_pool_demand_and_pool_search_multi_equal_reference(policy):
    ref, batch, engines = _batches(policy)
    for eng, want in zip(engines, ref.engines):
        peak = eng.peak_pool_demand()
        assert peak == want.peak_pool_demand() > 0.0
        # at pool >= peak the pool never binds: same rates as "infinite"
        assert eng.reject_rates(200.0, peak)[0] == \
            eng.reject_rates(200.0, BIG_POOL)[0]
    tol = batch.reject_rates(768.0, BIG_POOL)[:, 0] + 0.005
    cap = int(np.floor(tol * batch.n_vms).max())
    grids = np.stack([np.linspace(200.0 + 10 * i, 400.0, 7)
                      for i in range(3)])
    got = re.pool_search_multi(batch, grids, BIG_POOL, tol, reject_cap=cap)
    want = jax_re.pool_search_multi(ref, grids, BIG_POOL, tol,
                                    reject_cap=cap)
    assert got.tolist() == want.tolist()
    assert (got < BIG_POOL).any()
    with pytest.raises(ValueError, match="server_grids"):
        re.pool_search_multi(batch, grids[:2], BIG_POOL, tol)


# --------------------------------------------------- savings_analysis ---
def _planes(k):
    """k fresh (reference, port) pond control-plane pairs: the
    reference's models, and the same models rebuilt in the port from
    their arrays."""
    li, um, hist = _pond_models()
    arrays = [{f: getattr(t, f) for f in ("feature", "threshold", "left",
                                          "right", "value", "depth")}
              for t in li.forest.trees]
    pli = convert.latency_model_from_arrays(li.pdm, arrays)
    pum = convert.untouched_model_from_arrays(
        um.tau, um.gbm.f0, um.gbm.lr,
        [{f: getattr(t, f) for f in ("feature", "threshold", "left",
                                     "right", "value", "depth")}
         for t in um.gbm.stages])
    ref = [JaxControlPlane(JaxCPConfig(li_threshold=0.05, um_quantile=0.05),
                           li, um, JaxPoolManager(pool_gb=4096,
                                                  buffer_gb=64),
                           history=dict(hist)) for _ in range(k)]
    port = [ControlPlane(ControlPlaneConfig(li_threshold=0.05,
                                            um_quantile=0.05),
                         pli, pum, PoolManager(pool_gb=4096, buffer_gb=64),
                         history=dict(hist)) for _ in range(k)]
    return ref, port


def _fields(result):
    out = {f.name: getattr(result, f.name)
           for f in dataclasses.fields(cs.PolicyResult)}
    return out | {"savings": result.savings, "total_gb": result.total_gb}


def test_savings_analysis_batched_equals_reference_for_every_policy():
    """local, static and pond over three seeds, one shared cache in each
    package, as Fig 21 runs them: every PolicyResult field ==, the pond
    planes' end state == the reference's, and the summary rows ==."""
    worlds = [port_world(s, "static") for s in SEEDS]
    vms_list = [w[0] for w in worlds]
    pvms_list = [w[2] for w in worlds]
    cache, pcache = {}, {}
    ref_planes, port_planes = _planes(len(SEEDS))
    re.stats_reset()
    for policy, kw, pkw in (
            ("local", {}, {}),
            ("static", dict(static_pool_frac=0.25),
             dict(static_pool_frac=0.25)),
            ("pond", dict(control_planes=ref_planes),
             dict(control_planes=port_planes))):
        want = jax_cs.savings_analysis_batched(vms_list, WORLD_CFG, policy,
                                               cache=cache, **kw)
        got = cs.savings_analysis_batched(pvms_list, PORT_WORLD_CFG, policy,
                                          cache=pcache, device="cpu", **pkw)
        assert [_fields(r) for r in got] == [_fields(r) for r in want]
        assert cs.summarize_savings(got) == jax_cs.summarize_savings(want)
        if policy == "pond":
            assert all(r.mitigations > 0 and r.pool_group_gb > 0
                       for r in got)
            for p, r in zip(port_planes, ref_planes):
                assert [dataclasses.astuple(m) for m in p.mitigation.log] \
                    == [dataclasses.astuple(m) for m in r.mitigation.log]
                assert p.monitor.checks == r.monitor.checks
    assert sorted(map(str, pcache)) == sorted(map(str, cache))
    assert pcache["local_batch"].device.type == "cpu"
    times = re.stage_times()
    assert times.trajectory_s == 0.0        # the batched searches need none
    assert len(times.sweeps) == re.stats_snapshot()["sweeps"] > 0


def test_savings_analysis_batched_with_decisions_equals_reference():
    worlds = [port_world(s, "pond") for s in SEEDS[:2]]
    want = jax_cs.savings_analysis_batched(
        [w[0] for w in worlds], WORLD_CFG, "pond",
        decisions=[w[1] for w in worlds])
    got = cs.savings_analysis_batched(
        [w[2] for w in worlds], PORT_WORLD_CFG, "pond", device="cpu",
        decisions=[port_decisions(w[1]) for w in worlds])
    assert [_fields(r) for r in got] == [_fields(r) for r in want]


def test_savings_analysis_batched_refuses_what_is_not_ported():
    pvms = [port_world(s, "static")[2] for s in SEEDS[:2]]
    assert cs.savings_analysis_batched([], PORT_WORLD_CFG, "local") == []
    # streaming is ported (M5): a shard budget below 256 events is refused
    # as the reference's stream refuses it
    with pytest.raises(ValueError, match=">= 256"):
        cs.savings_analysis_batched(pvms, PORT_WORLD_CFG, "static",
                                    device="cpu", max_events_per_shard=100)
    with pytest.raises(ValueError, match="align"):
        cs.savings_analysis_batched(pvms, PORT_WORLD_CFG, "pond",
                                    device="cpu", decisions=[None])
    with pytest.raises(ValueError, match="control_plane"):
        cs.savings_analysis_batched(pvms, PORT_WORLD_CFG, "pond",
                                    device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        cs.savings_analysis_batched(pvms, PORT_WORLD_CFG, "local")


def test_launches_stay_zero_on_the_cpu():
    ops.launches = 0
    _, batch, _ = _batches("static")
    batch.reject_rates(SERVER[:2], POOL[:2])
    assert ops.launches == 0


def test_fig21_example_runs_on_the_cpu(capsys):
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "torch_fig21_savings.py")
    spec = importlib.util.spec_from_file_location("torch_fig21_savings",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    rows = mod.main(["--device", "cpu", "--servers", "8", "--days", "1",
                     "--seeds", "2", "--train-vms", "300"])
    assert list(rows) == ["local", "static", "pond"]
    assert all(r["n_seeds"] == 2 for r in rows.values())
    assert rows["local"]["savings_mean"] == 0.0
    assert rows["pond"]["savings_mean"] > 0.0
    assert "pond  : savings" in capsys.readouterr().out
