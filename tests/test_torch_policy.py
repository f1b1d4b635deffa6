"""Pond's own policy in the port against the reference's: the history
percentiles and UM features bit for bit, the ``pond`` decisions (local,
pool, fully pooled, migration times), the misprediction rate and the
control plane's end state (histories, monitor checks, the mitigation log)
``==`` the reference's on three seeds, the bundled fixture and without
models; the pool manager's flows, the QoS monitor and the control plane's
scalar flows.  The port fits its own models from the same data."""
import dataclasses
import functools

import numpy as np
import pytest

from repro.core import cluster_sim as jax_cs
from repro.core import policy_engine as jax_pe
from repro.core import traces as jax_traces
from repro.core.control_plane import ControlPlane as JaxControlPlane
from repro.core.control_plane import ControlPlaneConfig as JaxCPConfig
from repro.core.pool_manager import PoolManager as JaxPoolManager
from repro.core.predictors.models import (
    LatencySensitivityModel as JaxLatencySensitivityModel,
    UntouchedMemoryModel as JaxUntouchedMemoryModel)
from repro.core.qos import MitigationManager as JaxMitigationManager
from repro.core.qos import QoSMonitor as JaxQoSMonitor
from repro_torch.core import cluster_sim as cs
from repro_torch.core import policy_engine as pe
from repro_torch.core import traces
from repro_torch.core.control_plane import ControlPlane, ControlPlaneConfig
from repro_torch.core.pool_manager import PoolManager
from repro_torch.core.predictors.models import (LatencySensitivityModel,
                                                UntouchedMemoryModel)
from repro_torch.core.qos import MitigationManager, QoSMonitor
from repro_torch.core.slices import PermissionError_
from tests._torch_port_util import port_vms

HORIZON = 5 * 86400


@functools.cache
def _world():
    """The reference's models fitted on 600 training VMs, the port's own
    fitted on the same VMs, and the training history of each."""
    pop = jax_traces.Population(seed=0)
    train = pop.sample_vms(600, HORIZON, seed=1)
    ptrain = port_vms(train)
    ut = np.array([v.untouched for v in train])
    jhist = jax_traces.build_history(train)
    jli = JaxLatencySensitivityModel(pdm=0.05).fit(
        jax_traces.pmu_matrix(train), jax_traces.slowdowns(train, 182))
    jum = JaxUntouchedMemoryModel(0.05).fit(
        jax_traces.metadata_features(train, jhist), ut)
    phist = traces.build_history(ptrain)
    pli = LatencySensitivityModel(pdm=0.05).fit(
        traces.pmu_matrix(ptrain), traces.slowdowns(ptrain, 182))
    pum = UntouchedMemoryModel(0.05).fit(
        traces.metadata_features(ptrain, phist), ut)
    return pop, (jli, jum, jhist), (pli, pum, phist)


def _planes(models=(True, True), th=0.05):
    """(reference plane, port plane) with the same settings, each over
    its own package's models (``models`` says which of LI, UM exist)."""
    _, (jli, jum, jhist), (pli, pum, phist) = _world()
    use_li, use_um = models
    ref = JaxControlPlane(JaxCPConfig(li_threshold=th),
                          jli if use_li else None, jum if use_um else None,
                          JaxPoolManager(pool_gb=4096, buffer_gb=64),
                          history=dict(jhist))
    port = ControlPlane(ControlPlaneConfig(li_threshold=th),
                        pli if use_li else None, pum if use_um else None,
                        PoolManager(pool_gb=4096, buffer_gb=64),
                        history=dict(phist))
    return ref, port


def _assert_decisions_equal(got, want):
    for f in ("local_gb", "pool_gb", "fully_pooled", "t_migrate"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b)
    assert got.mispredictions == want.mispredictions
    assert got.n_mitigations == want.n_mitigations


def _assert_planes_equal(port, ref):
    assert sorted(port.history) == sorted(ref.history)
    for c in ref.history:
        assert list(port.history[c]) == list(ref.history[c]), c
    assert [dataclasses.astuple(m) for m in port.mitigation.log] == \
        [dataclasses.astuple(m) for m in ref.mitigation.log]
    assert port.mitigation.migrated == ref.mitigation.migrated
    assert port.monitor.checks == ref.monitor.checks


# ------------------------------------------------- history percentiles ----
def test_prefix_percentiles_match_reference_and_np_percentile():
    """Every prefix of every customer's history, seeds included: the
    port's sorted-segment percentiles == the reference's == a walk of
    ``np.percentile`` calls (numpy's lerp and its gamma >= 0.5 branch)."""
    rng = np.random.default_rng(0)
    n = 400
    customers = rng.integers(0, 12, n)
    untouched = rng.random(n)
    history = {c: rng.random(rng.integers(0, 7)).tolist()
               for c in range(0, 12, 2)}
    n_hist, percs = pe._prefix_percentiles(customers, untouched, history)
    w_hist, w_percs = jax_pe._prefix_percentiles(customers, untouched,
                                                 history)
    assert n_hist.tolist() == w_hist.tolist()
    assert percs.tolist() == w_percs.tolist()
    walk = {c: list(v) for c, v in history.items()}
    for i in range(n):
        h = walk.setdefault(int(customers[i]), [])
        assert n_hist[i] == len(h)
        want = [0.5] * 4 if len(h) < 3 else \
            np.percentile(h, [80, 90, 95, 99]).tolist()
        assert percs[i].tolist() == want
        h.append(float(untouched[i]))
    t = np.linspace(0.0, 1.0, 11)
    a, b = np.full(11, 0.2), np.full(11, 0.7)
    assert pe._np_lerp(a, b, t).tolist() == jax_pe._np_lerp(a, b, t).tolist()


def test_metadata_features_compiled_bitwise():
    pop, _, (pli, pum, phist) = _world()
    vms = port_vms(pop.sample_vms(300, HORIZON, seed=4, start_id=10 ** 6))
    table = traces.vm_table(vms)
    cp = ControlPlane(ControlPlaneConfig(), pli, pum,
                      PoolManager(pool_gb=4096), history=dict(phist))
    rows = []
    for vm in vms:
        rows.append(traces.metadata_features([vm], cp.history)[0])
        cp.record_untouched(vm.customer, vm.untouched)
    _, percs = pe._prefix_percentiles(table.customer, table.untouched,
                                      dict(phist))
    feat = pe.metadata_features_compiled(table, percs)
    assert feat.dtype == np.float32
    assert np.array_equal(feat, np.stack(rows))
    want = jax_pe.metadata_features_compiled(
        jax_traces.vm_table(pop.sample_vms(300, HORIZON, seed=4,
                                           start_id=10 ** 6)), percs)
    assert feat.tolist() == want.tolist()


# ------------------------------------------------------- pond decisions ---
@pytest.mark.parametrize("seed", [2, 7, 11])
def test_pond_decisions_and_plane_state_equal_reference(seed):
    pop, *_ = _world()
    vms = pop.sample_vms(700, HORIZON, seed=seed, start_id=10 ** 6)
    ref, port = _planes()
    want, w_mis = jax_cs.policy_decisions(vms, "pond", ref, as_arrays=True)
    got, g_mis = cs.policy_decisions(port_vms(vms), "pond", port,
                                     as_arrays=True)
    assert g_mis == w_mis
    _assert_decisions_equal(got, want)
    _assert_planes_equal(port, ref)
    assert np.isfinite(got.t_migrate).any()      # migrations exist
    assert got.fully_pooled.any()                # the LI shortcut fires
    assert got.n_mitigations == len(port.mitigation.log) > 0
    # the list form, as the scalar oracle reads it
    as_list = pe.PolicyDecisions(got.local_gb, got.pool_gb,
                                 got.fully_pooled,
                                 got.t_migrate).as_vmdecisions()
    assert [dataclasses.astuple(d) for d in as_list] == \
        [dataclasses.astuple(d) for d in want.as_vmdecisions()]


def test_pond_decisions_equal_reference_on_the_fixture():
    vms = jax_traces.load_trace_file(jax_traces.fixture_trace_path())
    ref, port = _planes()
    want, _ = jax_cs.policy_decisions(vms, "pond", ref, as_arrays=True)
    got, _ = cs.policy_decisions(port_vms(vms), "pond", port,
                                 as_arrays=True)
    _assert_decisions_equal(got, want)
    _assert_planes_equal(port, ref)
    # the fixture's VMs are integral: pond's split compiles to K1's domain
    assert (got.pool_gb == np.floor(got.pool_gb)).all()


@pytest.mark.parametrize("models", [(False, True), (True, False),
                                    (False, False)],
                         ids=["no_li", "no_um", "no_models"])
def test_pond_without_models_equals_reference(models):
    """No LI model: no fully-pooled shortcut and an all-sensitive monitor;
    no UM model: zero pool — as the reference."""
    pop, *_ = _world()
    vms = pop.sample_vms(200, HORIZON, seed=5, start_id=10 ** 6)
    ref, port = _planes(models)
    want, _ = jax_cs.policy_decisions(vms, "pond", ref, as_arrays=True)
    got, _ = cs.policy_decisions(port_vms(vms), "pond", port,
                                 as_arrays=True)
    _assert_decisions_equal(got, want)
    _assert_planes_equal(port, ref)
    if not models[0]:
        assert not got.fully_pooled.any()
    if not models[1] and not models[0]:
        assert not got.pool_gb.any()


def test_pond_on_a_shared_seed_history_keeps_it_private():
    """Two planes seeded from one history: each one's first write per
    customer copies, so the seed and the sibling plane see no appends."""
    pop, _, (pli, pum, phist) = _world()
    snapshot = {c: np.array(h) for c, h in phist.items()}
    vms = port_vms(pop.sample_vms(150, HORIZON, seed=9, start_id=10 ** 6))
    planes = [ControlPlane(ControlPlaneConfig(), pli, pum,
                           PoolManager(pool_gb=4096), history=dict(phist))
              for _ in range(2)]
    first, _ = cs.policy_decisions(vms, "pond", planes[0], as_arrays=True)
    assert any(len(planes[0].history[c]) > len(phist.get(c, ()))
               for c in planes[0].history)
    assert all(np.array_equal(planes[1].history[c], snapshot[c])
               for c in snapshot)
    for c, h in snapshot.items():
        assert np.array_equal(phist[c], h)
    second, _ = cs.policy_decisions(vms, "pond", planes[1], as_arrays=True)
    _assert_decisions_equal(second, first)
    planes[0].reset_history(phist)
    assert planes[0].history == dict(phist)


# --------------------------------------------------------- pool manager ---
def _pm_pair(*args, **kw):
    return PoolManager(*args, **kw), JaxPoolManager(*args, **kw)


def _assert_pm_equal(pm, ref):
    assert dataclasses.astuple(pm.stats) == dataclasses.astuple(ref.stats)
    assert pm.grants == ref.grants
    for a, b in zip(pm.emcs, ref.emcs, strict=True):
        assert a.owner.tolist() == b.owner.tolist()


def test_pool_manager_flows_and_blast_radius():
    for pm in _pm_pair(pool_gb=64, num_emcs=4, buffer_gb=8):
        assert pm.add_capacity(host=0, gb=20, now=0.0)
        assert pm.add_capacity(host=1, gb=20, now=0.0)
        assert pm.host_pool_gb(0) == 20
        assert pm.fail_emc(0) == [0]        # host0 got EMC0's 16 GB first
        pm.fail_pool_manager()
        assert not pm.add_capacity(host=2, gb=1, now=1.0)
    _assert_pm_equal(*_pm_pair(pool_gb=64, num_emcs=4, buffer_gb=8))


def test_pool_manager_release_replenishes_and_equals_reference():
    pms = _pm_pair(pool_gb=32, num_emcs=1, buffer_gb=8)
    for pm in pms:
        assert pm.add_capacity(0, 30, now=0.0)
        assert not pm.add_capacity(1, 4, now=0.0)   # blocked: buffer short
        pm.release_capacity(0, now=1.0)
        assert pm.add_capacity(1, 4, now=1.0 + 30 * 0.2)
        assert pm.stats.blocked_starts == 1
        assert pm.stats.outstanding() == 1
    _assert_pm_equal(*pms)
    assert pms[0].total_free_gb(10.0) == pms[1].total_free_gb(10.0)


def test_emc_failure_releases_only_that_emcs_grants():
    pms = _pm_pair(pool_gb=64, num_emcs=4)
    for pm in pms:
        assert pm.add_capacity(0, 24, now=0.0)      # EMC0 (16) + EMC1 (8)
        assert pm.add_capacity(1, 8, now=0.0)
        assert pm.add_capacity(2, 16, now=0.0)
        assert pm.fail_emc(0) == [0]
        assert [pm.host_pool_gb(h) for h in range(3)] == [8, 8, 16]
        assert pm.assigned_gb() == 32 and pm.emcs[0].free_gb() == 16
        assert pm.stats.revoked_gb == 16
        for emc in pm.emcs:
            emc.check_invariants()
    _assert_pm_equal(*pms)


def test_pm_down_blocks_reassignment_not_datapath_and_recovers():
    pm = PoolManager(pool_gb=32, num_emcs=2)
    assert pm.add_capacity(0, 8, now=0.0)
    granted = list(pm.grants[(0, 0)])
    pm.fail_pool_manager()
    assert not pm.add_capacity(1, 1, now=1.0)
    pm.release_capacity(0, now=1.0)
    assert pm.stats.releases == 0 and pm.host_pool_gb(0) == 8
    for sid in granted:
        pm.emcs[0].check_access(0, sid)
    with pytest.raises(PermissionError_):
        pm.emcs[0].check_access(2, granted[0])
    pm.recover_pool_manager()
    pm.fail_host(0, now=2.0)
    assert pm.alive and pm.host_pool_gb(0) == 0
    pm = PoolManager(pool_gb=32, num_emcs=1, buffer_gb=8)
    assert pm.add_capacity(0, 30, now=0.0)
    pm.release_capacity(0, now=1.0)
    assert not pm.add_capacity(1, 30, now=1.0)      # the drain is async
    assert pm.add_capacity(1, 30, now=1.0 + 30 * 0.2)
    assert pm.total_free_gb(now=1.0 + 30 * 0.2) == 2.0


# --------------------------------------------------- QoS and the planes ---
def test_qos_monitor_check_equals_reference():
    """The monitor mitigates a spilled, pool-backed, predicted-sensitive
    VM once; it skips the unspilled, the all-local and the migrated."""
    def p_sensitive(f):
        return f[:, 0]
    out = []
    for mm_cls, mon_cls in ((MitigationManager, QoSMonitor),
                            (JaxMitigationManager, JaxQoSMonitor)):
        mm = mm_cls()
        mon = mon_cls(0.05, p_sensitive, 0.5, mm)
        calls = [(1, 0.9, True, 4.0), (2, 0.1, True, 4.0),
                 (3, 0.9, False, 4.0), (4, 0.9, True, 0.0),
                 (1, 0.9, True, 4.0), (5, 0.5, True, 2.0)]
        got = [mon.check(v, np.array([p], np.float32), s, g, 10.0 * v)
               for v, p, s, g in calls]
        out.append(([None if m is None else dataclasses.astuple(m)
                     for m in got], mon.checks, sorted(mm.migrated)))
    assert out[0] == out[1]
    assert out[0][0][0] == (1, 10.0, 4.0, 0.2) and out[0][2] == [1, 5]


def test_control_plane_scalar_flows_equal_reference():
    """The A flow (decide, on_request, on_departure) and the B flow
    (monitor_step) VM by VM, with the same placements, pool grants,
    mitigations and histories as the reference's plane."""
    pop, *_ = _world()
    vms = pop.sample_vms(250, 86400, seed=6, start_id=2 * 10 ** 6)
    ref, port = _planes(th=0.2)
    for vm, pvm in zip(vms, port_vms(vms)):
        assert port.decide(pvm) == ref.decide(vm)
        a = port.on_request(pvm, host=pvm.vm_id % 8, now=pvm.arrival)
        b = ref.on_request(vm, host=vm.vm_id % 8, now=vm.arrival)
        assert dataclasses.astuple(a) == dataclasses.astuple(b)
        ma = port.monitor_step(pvm, pvm.arrival + 60)
        mb = ref.monitor_step(vm, vm.arrival + 60)
        assert (ma is None) == (mb is None)
        if ma is not None:
            assert port.placements[pvm.vm_id].pool_gb == 0
        port.on_departure(pvm, pvm.departure)
        ref.on_departure(vm, vm.departure)
    _assert_planes_equal(port, ref)
    _assert_pm_equal(port.pm, ref.pm)
    assert len(port.mitigation.log) > 0 and port.pm.assigned_gb() == 0
