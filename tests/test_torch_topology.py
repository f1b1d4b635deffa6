"""The port's fleet topologies (ROADMAP M9) against the reference: the
cases of ``tests/test_topology_engine.py``, mirrored.

``CompiledReplay.reject_rates_fleet`` and
``CompiledReplayBatch.reject_rates_fleet`` of the port, on the CPU (the
``torch`` backend runs K4's plain version there) and through the
``numpy`` backend, ``==`` the reference's ``reject_rates_fleet`` (its jax
backend), the reference's scalar oracle ``replay_multi_pool`` and the
port's copy of it, on the same VMs, decisions and topologies (carried
across by ``tests/_torch_port_util.py``), over seeds, state types and
topology families, the MIGRATE quirk paths and the degenerate layouts
(one pod, a pod without members, orphan servers); the 1-pod and
partitioned lanes ``==`` the single-pool engine; batch rows ``==`` engine
rows; the errors; the topology builders ``==`` the reference's; the
port's ``examples/torch_fig_topology.py`` at the benchmark's quick sizes
``==`` ``tests/golden/fig_topology.json`` (read, not edited); and the two
``FleetPoolManager`` cases of ``tests/test_failures.py``.  Tolerance:
``==`` throughout (integer reject counts)."""
import copy
import importlib.util
import json
import os

import numpy as np
import pytest

from repro.core import cluster_sim as jax_cs
from repro.core import replay_engine as jax_re
from repro.core import topology as jax_top
from repro.core import traces as jax_traces
from repro_torch.core import cluster_sim, replay_engine, topology
from repro_torch.core.pool_manager import FleetPoolManager
from tests._torch_port_util import (port_decisions, port_topology,
                                    port_vms)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG_KW = dict(n_servers=8, pool_sockets=8, gb_per_core=4.75)
JAX_CFG = jax_cs.ClusterConfig(**CFG_KW)
CFG = cluster_sim.ClusterConfig(**CFG_KW)
HORIZON = 2 * 86400
SEEDS = (3, 4, 5)
BACKENDS = ("torch", "numpy")
#: (backend, forced state type) of the port; numpy carries float64 state
GRID_RUNS = (("torch", "int16"), ("torch", "int32"), ("numpy", None))


def _topologies():
    """The reference suite's three families plus the orphan degenerate, as
    the reference builds them."""
    return [jax_top.partitioned(8, 4), jax_top.overlapping(8, 4, 2),
            jax_top.sparse(8, 4, 2, seed=1),
            jax_top.sparse(8, 3, 2, seed=2, allow_orphans=True)]


def _lanes():
    """The reference suite's grid: tight/ample DRAM with tight/ample pool
    budgets, every total split integrally; (sgb, caps, reference
    topologies, port topologies)."""
    sgb, caps, lane_topos = [], [], []
    for server, total in ((200.0, 150.0), (200.0, 40.0), (140.0, 300.0),
                          (60.0, 6144.0)):
        for t in _topologies():
            sgb.append(server)
            caps.append(jax_top.split_pool(total, t.n_pods))
            lane_topos.append(t)
    return (np.asarray(sgb), caps, lane_topos,
            [port_topology(t) for t in lane_topos])


_WORLDS: dict = {}


def _world(seed, migrate=False):
    """(reference vms, reference decisions, port vms, port decisions) of
    the reference suite's world; ``migrate`` grafts QoS migrations onto a
    third of the pooled VMs, mid-lifetime, as it does."""
    key = (seed, migrate)
    if key not in _WORLDS:
        n = jax_cs.arrivals_for_util(JAX_CFG, 0.8, HORIZON)
        vms = jax_traces.Population(seed=0).sample_vms(n, HORIZON, seed=seed,
                                                       start_id=10 ** 6)
        dec, _ = jax_cs.policy_decisions(vms, "static", static_pool_frac=0.25,
                                         as_arrays=True)
        if migrate:
            pick = (np.asarray(dec.pool_gb) > 0) & (np.arange(n) % 3 == 0)
            life = np.array([vm.arrival + 0.5 * vm.lifetime for vm in vms])
            dec.t_migrate = np.where(pick, life, np.asarray(dec.t_migrate))
        _WORLDS[key] = (vms, dec, port_vms(vms), port_decisions(dec))
    return _WORLDS[key]


def _engines(seed, migrate=False, jax_cfg=JAX_CFG, cfg=CFG):
    vms, dec, pvms, pdec = _world(seed, migrate)
    return (jax_re.CompiledReplay(vms, dec, jax_cfg),
            replay_engine.CompiledReplay(pvms, pdec, cfg, device="cpu"))


_ORACLES: dict = {}


def _oracles(seed, migrate):
    """(the reference oracle's rates, the port oracle's) on the grid."""
    if (seed, migrate) not in _ORACLES:
        vms, dec, pvms, pdec = _world(seed, migrate)
        sgb, caps, jt, pt = _lanes()
        jd, pd = dec.as_vmdecisions(), pdec.as_vmdecisions()
        _ORACLES[seed, migrate] = (
            np.array([jax_cs.replay_multi_pool(vms, jd, JAX_CFG,
                                               float(sgb[i]), jt[i], caps[i])
                      for i in range(len(sgb))]),
            np.array([cluster_sim.replay_multi_pool(pvms, pd, CFG,
                                                    float(sgb[i]), pt[i],
                                                    caps[i])
                      for i in range(len(sgb))]))
    return _ORACLES[seed, migrate]


# ----------------------------------------------------- differential grid --
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("backend,state_dtype", GRID_RUNS)
def test_fleet_grid_equals_reference_and_both_oracles(seed, backend,
                                                      state_dtype):
    jeng, peng = _engines(seed)
    assert peng._exact                # integral static decisions
    sgb, caps, jt, pt = _lanes()
    want = jeng.reject_rates_fleet(sgb, caps, jt, backend="jax")
    got = peng.reject_rates_fleet(sgb, caps, pt, backend=backend,
                                  state_dtype=state_dtype)
    ref_oracle, port_oracle = _oracles(seed, False)
    assert got.tolist() == want.tolist()
    assert got.tolist() == ref_oracle.tolist() == port_oracle.tolist()
    # the grid discriminates: some lane rejects, some does not
    assert want.max() > 0.0 and want.min() < want.max()


@pytest.mark.parametrize("seed", SEEDS[:2])
@pytest.mark.parametrize("backend", BACKENDS)
def test_fleet_migrate_paths_equal_reference(seed, backend):
    """The MIGRATE quirk: pool back to the recorded pod, fallback VMs pay
    their server's first listed pod, orphan servers pay nothing — on a
    trace where a third of the pooled VMs migrate mid-lifetime."""
    jeng, peng = _engines(seed, migrate=True)
    assert peng._has_migrate          # the graft took
    sgb, caps, jt, pt = _lanes()
    want = jeng.reject_rates_fleet(sgb, caps, jt, backend="jax")
    ref_oracle, port_oracle = _oracles(seed, True)
    got = peng.reject_rates_fleet(sgb, caps, pt, backend=backend)
    assert got.tolist() == want.tolist() == ref_oracle.tolist() \
        == port_oracle.tolist()
    if backend == "torch":            # both packings on the quirk path
        got16 = peng.reject_rates_fleet(sgb, caps, pt, backend="torch",
                                        state_dtype="int16")
        assert got16.tolist() == want.tolist()


# ------------------------------------------------------ degenerate lanes --
@pytest.mark.parametrize("backend", BACKENDS)
def test_single_pool_lane_matches_single_pool_engine(backend):
    """single_pool(n) prices like the single-pool engine at equal capacity
    on an n_groups == 1 row (the engine's pool_gb is per group)."""
    kw = dict(n_servers=8, pool_sockets=16, gb_per_core=4.75)
    jeng, peng = _engines(3, jax_cfg=jax_cs.ClusterConfig(**kw),
                          cfg=cluster_sim.ClusterConfig(**kw))
    assert peng.n_groups == 1
    one = topology.single_pool(8)
    for sgb, pgb in ((200.0, 300.0), (140.0, 150.0), (60.0, 6144.0)):
        base = peng.reject_rates(sgb, pgb)
        got = peng.reject_rates_fleet(sgb, float(pgb), one, backend=backend)
        assert base.tolist() == got.tolist() == jeng.reject_rates(
            sgb, pgb).tolist(), (backend, sgb, pgb)


@pytest.mark.parametrize("backend", BACKENDS)
def test_partitioned_lane_matches_group_engine(backend):
    """partitioned(n, servers_per_group) with every pod at the per-group
    budget is the multi-group engine."""
    _, peng = _engines(3)
    assert CFG.n_groups == 2 and CFG.servers_per_group == 4
    part = topology.partitioned(8, 4)
    for sgb, pgb in ((200.0, 300.0), (140.0, 150.0), (60.0, 40.0)):
        base = peng.reject_rates(sgb, pgb)
        got = peng.reject_rates_fleet(sgb, np.array([pgb, pgb]), part,
                                      backend=backend)
        assert base.tolist() == got.tolist(), (backend, sgb, pgb)


@pytest.mark.parametrize("backend", BACKENDS)
def test_zero_member_pod_is_inert(backend):
    """A pod no incidence row points at never grants: its capacity is dead
    weight."""
    vms, dec, pvms, pdec = _world(4)
    _, peng = _engines(4)
    inc = np.zeros((8, 1), np.int32)          # 2 pods, every server pod 0
    t = topology.Topology("sparse", 8, 2, 1, inc)
    jt = jax_top.Topology("sparse", 8, 2, 1, inc.copy())
    assert t.members(1) == []
    got = {}
    for dead_cap in (6144.0, 0.0):
        caps = np.array([150.0, dead_cap])
        got[dead_cap] = peng.reject_rates_fleet(200.0, caps, t,
                                                backend=backend)
        want = jax_cs.replay_multi_pool(vms, dec.as_vmdecisions(), JAX_CFG,
                                        200.0, jt, caps)
        port = cluster_sim.replay_multi_pool(pvms, pdec.as_vmdecisions(),
                                             CFG, 200.0, t, caps)
        assert got[dead_cap].tolist() == [want] == [port]
    assert got[0.0].tolist() == got[6144.0].tolist()


@pytest.mark.parametrize("backend", BACKENDS)
def test_all_orphans_price_like_zero_pool(backend):
    """Servers reaching no pod take only the all-local fallback: an
    all-orphan topology prices like pool_gb == 0 on the single-pool
    engine."""
    jeng, peng = _engines(5)
    orphans = topology.Topology("sparse", 8, 1, 1,
                                np.full((8, 1), -1, np.int32))
    for sgb in (200.0, 140.0, 768.0):
        base = peng.reject_rates(sgb, 0.0)
        got = peng.reject_rates_fleet(sgb, 6144.0, orphans, backend=backend)
        assert base.tolist() == got.tolist() == jeng.reject_rates(
            sgb, 0.0).tolist(), (backend, sgb)


# -------------------------------------------------------- the trace batch --
@pytest.mark.parametrize("backend", BACKENDS)
def test_batch_fleet_matches_engine_rows(backend):
    sgb, caps, jt, pt = _lanes()
    pairs = [_engines(s) for s in SEEDS[:2]]
    expect = np.stack([p.reject_rates_fleet(sgb, caps, pt, backend=backend)
                       for _, p in pairs])
    batch = replay_engine.CompiledReplayBatch([p for _, p in pairs])
    got = batch.reject_rates_fleet(sgb, caps, pt, backend=backend)
    want = jax_re.CompiledReplayBatch([j for j, _ in pairs]) \
        .reject_rates_fleet(sgb, caps, jt, backend="jax")
    assert got.shape == expect.shape == want.shape
    assert got.tolist() == expect.tolist() == want.tolist()


def test_batch_packs_int16_only_where_every_engine_allows_it():
    """One launch shares one state type: a trace whose migrate-pool deficit
    needs int32 takes the whole batch to int32; the rows stay equal."""
    sgb, caps, jt, pt = _lanes()
    _, plain = _engines(3)
    _, mig = _engines(3, migrate=True)
    mig._mig_pool_sum = 1e9           # as if its MIGRATEs needed int32
    replay_engine.stats_reset()
    batch = replay_engine.CompiledReplayBatch([plain, mig])
    got = batch.reject_rates_fleet(sgb, caps, pt)
    assert [d for _, d in replay_engine.stage_times().sweeps] == ["int32"]
    replay_engine.stats_reset()
    alone = plain.reject_rates_fleet(sgb, caps, pt)
    assert [d for _, d in replay_engine.stage_times().sweeps] == ["int16"]
    assert got[0].tolist() == alone.tolist()
    assert got[1].tolist() == mig.reject_rates_fleet(sgb, caps, pt).tolist()


def test_non_integral_decisions_take_the_numpy_backend():
    """Non-integral decisions: ``auto`` takes the float64 numpy sweep,
    ``torch`` refuses; numpy ``==`` both oracles."""
    vms, dec, pvms, _ = _world(3)
    dec2 = copy.copy(dec)              # a 0.7 share of each pool: GB parts
    dec2.pool_gb = 0.7 * np.asarray(dec.pool_gb)
    dec2.local_gb = np.asarray(dec.local_gb) + 0.3 * np.asarray(dec.pool_gb)
    pdec2 = port_decisions(dec2)
    peng = replay_engine.CompiledReplay(pvms, pdec2, CFG, device="cpu")
    jeng = jax_re.CompiledReplay(vms, dec2, JAX_CFG)
    assert not peng._exact
    sgb, caps, jt, pt = _lanes()
    got = peng.reject_rates_fleet(sgb, caps, pt)
    assert got.tolist() == jeng.reject_rates_fleet(
        sgb, caps, jt, backend="numpy").tolist()
    for i in (0, 5, 11):
        assert got[i] == cluster_sim.replay_multi_pool(
            pvms, pdec2.as_vmdecisions(), CFG, float(sgb[i]), pt[i], caps[i])
    with pytest.raises(NotImplementedError, match="numpy"):
        peng.reject_rates_fleet(sgb, caps, pt, backend="torch")
    batch = replay_engine.CompiledReplayBatch([peng, peng])
    assert batch.reject_rates_fleet(sgb, caps, pt).tolist() == \
        [got.tolist()] * 2
    with pytest.raises(NotImplementedError, match="numpy"):
        batch.reject_rates_fleet(sgb, caps, pt, backend="torch")


# ------------------------------------------------------------ validation --
def test_fleet_rejects_mismatched_topology():
    _, peng = _engines(3)
    with pytest.raises(ValueError, match="n_servers|servers"):
        peng.reject_rates_fleet(200.0, 64.0, topology.partitioned(16, 4))
    batch = replay_engine.CompiledReplayBatch([peng])
    with pytest.raises(ValueError, match="servers"):
        batch.reject_rates_fleet(200.0, 64.0, topology.partitioned(16, 4))
    # one device is the single-device path (devices=, M13)
    assert batch.reject_rates_fleet(
        200.0, 64.0, topology.partitioned(8, 4), devices=["cpu"]).tolist() \
        == batch.reject_rates_fleet(200.0, 64.0,
                                    topology.partitioned(8, 4)).tolist()
    with pytest.raises(ValueError, match="backend"):
        peng.reject_rates_fleet(200.0, 64.0, topology.partitioned(8, 4),
                                backend="jax")


def test_fleet_rejects_bad_pod_capacity_shapes():
    _, peng = _engines(3)
    part = topology.partitioned(8, 4)           # 2 pods
    with pytest.raises(ValueError, match="SHARED"):
        peng.reject_rates_fleet(200.0, np.array([1.0, 2.0, 3.0]), part)
    with pytest.raises(ValueError, match="pod capacities"):
        peng.reject_rates_fleet(200.0, [np.array([1.0, 2.0, 3.0])], part)
    with pytest.raises(ValueError, match="broadcast"):
        peng.reject_rates_fleet(np.array([1.0, 2.0, 3.0]), 64.0,
                                [part, part])


def test_oracle_rejects_mismatches():
    _, _, pvms, pdec = _world(3)
    dec = pdec.as_vmdecisions()
    with pytest.raises(ValueError, match="pod capacities"):
        cluster_sim.replay_multi_pool(pvms, dec, CFG, 200.0,
                                      topology.partitioned(8, 4),
                                      np.array([1.0, 2.0, 3.0]))
    with pytest.raises(ValueError, match="servers"):
        cluster_sim.replay_multi_pool(pvms, dec, CFG, 200.0,
                                      topology.partitioned(16, 4), 64.0)


def test_topology_builders_equal_the_reference():
    pairs = [(topology.partitioned(13, 4), jax_top.partitioned(13, 4)),
             (topology.single_pool(9), jax_top.single_pool(9)),
             (topology.overlapping(16, 4, 3), jax_top.overlapping(16, 4, 3)),
             (topology.overlapping(8, 4, 5), jax_top.overlapping(8, 4, 5)),
             (topology.sparse(256, 4, 3, seed=9, allow_orphans=True),
              jax_top.sparse(256, 4, 3, seed=9, allow_orphans=True)),
             (topology.sparse(256, 6, 2, seed=8),
              jax_top.sparse(256, 6, 2, seed=8))]
    for mine, ref in pairs:
        assert mine.describe() == ref.describe()
        assert mine.inc.dtype == ref.inc.dtype
        assert mine.inc.tolist() == ref.inc.tolist()
        assert [mine.members(q) for q in range(mine.n_pods)] == \
            [ref.members(q) for q in range(ref.n_pods)]
        assert port_topology(ref).inc.tolist() == mine.inc.tolist()
    for total, n in ((15057.0, 32), (1883.0, 64), (0.5, 3)):
        assert topology.split_pool(total, n).tolist() == \
            jax_top.split_pool(total, n).tolist()
    topos = [p[0] for p in pairs[:3]]
    for pod_gb in (7.0, np.array([1.0, 2.0, 3.0]),
                   [np.array([5.0]), np.array([2.0]), np.arange(1.0, 5.0)]):
        assert topology.pod_caps_matrix(pod_gb, topos).tolist() == \
            jax_top.pod_caps_matrix(pod_gb, [p[1] for p in pairs[:3]]) \
            .tolist()
    for mod in (topology, jax_top):
        with pytest.raises(ValueError, match="pod capacities"):
            mod.pod_caps_matrix([1.0, np.arange(3.0), 1.0],
                                [p[1] for p in pairs[:3]])
    for bad in (np.array([[0, 0]]), np.array([[-1, 0]]), np.array([[2]])):
        for mod in (topology, jax_top):
            with pytest.raises(ValueError):
                mod.validate_incidence(bad, 2, 2)


# -------------------------------------------------- the benchmark's twin --
def _example():
    spec = importlib.util.spec_from_file_location(
        "torch_fig_topology", os.path.join(REPO, "examples",
                                           "torch_fig_topology.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fig_topology_example_equals_the_golden_counts():
    """The port's twin of benchmarks/fig_topology.py at its quick sizes, on
    the CPU: every lane's reject count == tests/golden/fig_topology.json,
    bit-exact against the port's oracle, topology moves rejects, the 1-pod
    lanes == the single-pool engine.  (The speed claim is the card's: on
    the CPU the sweep is its plain version, a loop of tensor ops.)"""
    with open(os.path.join(REPO, "tests", "golden",
                           "fig_topology.json")) as f:
        golden = json.load(f)
    res = _example().run(quick=True, device="cpu")
    assert res["reject_counts"] == golden["reject_counts"]
    assert res["n_vms"] == golden["n_vms"]
    assert res["topologies"] == golden["topologies"]
    assert res["dram_fracs"] == golden["dram_fracs"]
    assert res["pool_totals_gb"] == golden["pool_totals_gb"]
    claims = {name: ok for name, ok, _ in res["claims"]}
    assert claims["fleet sweep bit-exact vs scalar multi-pod oracle"]
    assert claims["topology choice moves rejects at equal hardware"]
    assert claims["1-pod fleet lane == single-pool engine bitwise"]


# --------------------------------------------------- the control plane ---
def test_fleet_pool_manager_pod_failure_is_isolated():
    """Whole-pod failure touches only that pod's members: sibling pods
    keep their grants, stats and free capacity untouched."""
    t = topology.partitioned(8, 4)              # pods {0..3}, {4..7}
    fpm = FleetPoolManager(t, 64.0)
    assert fpm.add_capacity(0, 8.0) == 0
    assert fpm.add_capacity(1, 4.0) == 0
    assert fpm.add_capacity(4, 8.0) == 1
    assert fpm.assigned_gb() == 20.0
    assert fpm.fail_pod(0) == [0, 1]
    assert fpm.pods[0].assigned_gb() == 0.0
    assert fpm.pods[0].stats.revoked_gb == 12.0
    assert fpm.pods[0].stats.outstanding() == 0
    # the sibling pod never saw the failure
    assert fpm.pods[1].assigned_gb() == 8.0
    assert fpm.pods[1].stats.revoked_gb == 0.0
    assert fpm.pods[1].stats.releases == 0
    assert fpm.host_pool_gb(4) == 8.0
    assert fpm.host_pool_gb(0) == 0.0


def test_fleet_pool_manager_first_reachable_pod_overflow():
    """Grants come from the FIRST reachable pod with room (the fleet
    engines' admission rule); a full first pod overflows to the next, and
    a host reaching no pod gets None (the all-local fallback)."""
    t = topology.overlapping(8, 4, 2)           # 2 pods, fanout 2
    fpm = FleetPoolManager(t, 16.0)
    assert fpm.add_capacity(0, 16.0) == 0       # fills pod 0
    assert fpm.add_capacity(1, 8.0) == 1        # overflow to pod 1
    assert fpm.add_capacity(2, 16.0) is None    # both pods short
    assert fpm.pod_free_gb().tolist() == [0.0, 8.0]
    fpm.release_capacity(0)
    # releases drain asynchronously (10-100 ms/GB offline path): the
    # capacity is back once the clock passes the drain window
    assert fpm.add_capacity(2, 16.0, now=0.0) is None
    assert fpm.add_capacity(2, 16.0, now=1e9) == 0
    # an orphan host (no reachable pod) can never draw pool
    orphans = topology.Topology("sparse", 4, 1, 1,
                                np.full((4, 1), -1, np.int32))
    fpm0 = FleetPoolManager(orphans, 64.0)
    assert fpm0.add_capacity(0, 1.0) is None
    assert fpm0.assigned_gb() == 0.0
    with pytest.raises(ValueError, match="pod capacities"):
        FleetPoolManager(t, [1.0, 2.0, 3.0])
