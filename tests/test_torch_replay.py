"""``CompiledReplay`` of the port against the reference's: compiled event
arrays, the device event arrays, reject rates (``==`` against the
reference engine, the reference's scalar oracle and the port's own copy
of it), trajectories, peak pool demand and statistics, on the 8-server
world of ``tests/test_replay_engine.py``.  The port's sweep runs its plain
version here (CPU tensors)."""
import numpy as np
import pytest

from repro.core import cluster_sim as jax_cs
from repro.core import replay_engine as jax_re
from repro.core import traces as jax_traces
from repro_torch.core import cluster_sim as cs
from repro_torch.core import replay_engine as re
from repro_torch.core import traces
from repro_torch.core.policy_engine import PolicyDecisions
from repro_torch.runtime.fault import FailureSchedule
from tests._torch_port_util import (PORT_WORLD_CFG, POOL, SERVER, WORLD_CFG,
                                    port_world)

WORLDS = [(s, p) for s in (3, 4, 5) for p in ("static", "pond")]


def _engines(seed, policy):
    vms, dec, pvms, pdec = port_world(seed, policy)
    return (jax_re.CompiledReplay(vms, dec, WORLD_CFG),
            re.CompiledReplay(pvms, pdec, PORT_WORLD_CFG, device="cpu"))


@pytest.mark.parametrize("seed,policy", WORLDS)
def test_compiled_event_arrays_equal_reference(seed, policy):
    ref, eng = _engines(seed, policy)
    assert eng.n_events == ref.n_events
    assert eng.ev_time.tolist() == ref.ev_time.tolist()
    assert eng._ev_kind == ref._ev_kind and eng._ev_vm == ref._ev_vm
    for attr in ("_exact", "_has_migrate", "_mig_pool_sum", "_pay_mem_max",
                 "_pay_pool_max", "n_vms", "n_servers", "n_groups",
                 "cores_per_server"):
        assert getattr(eng, attr) == getattr(ref, attr), attr
    assert eng.group_of.tolist() == ref.group_of.tolist()
    assert eng._has_migrate == (policy == "pond")


@pytest.mark.parametrize("seed,policy", WORLDS[:2])
def test_device_events_are_the_unpadded_prefix_of_the_reference(seed,
                                                                policy):
    ref, eng = _engines(seed, policy)
    evs, group, n_slots = eng._device_events()
    r_evs, r_group, r_slots, _, _ = ref._jax_events()
    n = ref.n_events
    for got, want in zip(evs, r_evs):
        assert got.dtype.itemsize == 4 and got.shape == (n,)
        assert got.tolist() == np.asarray(want)[:n].tolist()
    assert group.tolist() == np.asarray(r_group)[:ref.n_servers].tolist()
    assert jax_re.sweep_core.pad_up(n_slots, 32) == r_slots
    assert eng._device_events() is eng._device_events()      # uploaded once


@pytest.mark.parametrize("seed,policy", WORLDS)
def test_reject_rates_equal_reference_and_both_oracles(seed, policy):
    ref, eng = _engines(seed, policy)
    vms, dec, pvms, pdec = port_world(seed, policy)
    got = eng.reject_rates(SERVER, POOL)
    want = ref.reject_rates(SERVER, POOL)
    jax_dec, port_dec = dec.as_vmdecisions(), pdec.as_vmdecisions()
    oracle = [jax_cs.replay_reject_rate(vms, jax_dec, WORLD_CFG, s, p)
              for s, p in zip(SERVER, POOL)]
    port_oracle = [cs.replay_reject_rate(pvms, port_dec, PORT_WORLD_CFG, s, p)
                   for s, p in zip(SERVER, POOL)]
    assert got.dtype == np.float64
    assert got.tolist() == want.tolist() == oracle == port_oracle


@pytest.mark.parametrize("state_dtype", ["int16", "int32"])
@pytest.mark.parametrize("policy", ["static", "pond"])
def test_forced_state_dtype_equals_reference(policy, state_dtype):
    ref, eng = _engines(4, policy)
    got = eng.reject_rates(SERVER, POOL, state_dtype=state_dtype)
    want = ref.reject_rates(SERVER, POOL, backend="jax",
                            state_dtype=state_dtype)
    assert got.tolist() == want.tolist()
    # the pick itself follows the reference's rules
    sgb, pgb = re.sweep_core.quantize_capacities(SERVER, POOL)
    assert eng._pick_state_dtype(sgb, pgb) == ref._pick_state_dtype(sgb,
                                                                     pgb)


@pytest.mark.parametrize("policy", ["static", "pond"])
def test_peak_pool_demand_and_trajectories_equal_reference(policy):
    ref, eng = _engines(5, policy)
    assert eng.peak_pool_demand() == ref.peak_pool_demand()
    for server_gb in (None, 200.0, 219.7):
        got, want = eng._trajectory(server_gb), ref._trajectory(server_gb)
        for f in ("server_gb", "total_rejects"):
            assert getattr(got, f) == getattr(want, f), f
        for f in ("need_srv", "need_pool", "snap_rejects", "snap_cores",
                  "snap_mem", "snap_pool", "srv", "arr_idx", "dep_idx",
                  "mig", "mig_idx"):
            a, b = getattr(got, f), getattr(want, f)
            assert a.dtype == b.dtype and a.tolist() == b.tolist(), f
        assert eng._trajectory(server_gb) is got              # cached


def test_stale_migrate_after_departure_is_dropped():
    """A t_migrate past the VM's departure is a no-op in the scalar
    oracle; the slot-addressed sweep must not let it corrupt whichever VM
    reused the slot (the reference's regression case, in the port)."""
    base = traces.Population(seed=0).sample_vms(3, 100.0, seed=1)
    for vm, (arr, life, cores, mem) in zip(
            base, [(0.0, 10.0, 2, 8.0), (20.0, 100.0, 2, 8.0),
                   (35.0, 50.0, 2, 8.0)]):
        vm.arrival, vm.lifetime, vm.cores, vm.mem_gb = arr, life, cores, mem
    decisions = [cs.VMDecision(4.0, 4.0, False, 30.0),   # after departure
                 cs.VMDecision(4.0, 4.0, False, None),
                 cs.VMDecision(4.0, 4.0, False, None)]
    cfg = cs.ClusterConfig(n_servers=1, pool_sockets=2, gb_per_core=4.75)
    eng = re.CompiledReplay(base, decisions, cfg, device="cpu")
    assert re.MIGRATE not in eng._ev_kind               # dropped
    jax_vms = jax_traces.Population(seed=0).sample_vms(3, 100.0, seed=1)
    for vm, src in zip(jax_vms, base):
        vm.arrival, vm.lifetime, vm.cores, vm.mem_gb = \
            src.arrival, src.lifetime, src.cores, src.mem_gb
    jax_dec = [jax_cs.VMDecision(d.local_gb, d.pool_gb, d.fully_pooled,
                                 d.t_migrate) for d in decisions]
    jax_cfg = jax_cs.ClusterConfig(n_servers=1, pool_sockets=2,
                                   gb_per_core=4.75)
    for s, p in ((16.0, 16.0), (12.0, 4.0), (8.0, 16.0)):
        want = cs.replay_reject_rate(base, decisions, cfg, s, p)
        assert want == jax_cs.replay_reject_rate(jax_vms, jax_dec, jax_cfg,
                                                 s, p)
        assert eng.reject_rates(s, p)[0] == want, (s, p)


def test_compiled_arrive_depart_equals_reference():
    vms, _, pvms, _ = port_world(4, "static")
    for got, want in zip(re.compiled_arrive_depart(pvms),
                         jax_re.compiled_arrive_depart(vms)):
        assert got.dtype == want.dtype and got.tolist() == want.tolist()


def test_scalar_broadcast_and_single_candidate():
    ref, eng = _engines(4, "static")
    one = eng.reject_rates(250.0, 100.0)
    assert one.shape == (1,) and one[0] == ref.reject_rates(250.0, 100.0)[0]
    row = eng.reject_rates(np.array([200.0, 250.0, 300.0]), 100.0)
    assert row.tolist() == ref.reject_rates(np.array([200.0, 250.0, 300.0]),
                                            100.0).tolist()


def test_engine_stats_count_like_the_reference():
    ref, eng = _engines(3, "static")
    server, pool = np.array([200.0, 300.0]), np.array([100.0, 200.0])
    jax_re.stats_reset()
    ref.reject_rates(server, pool)
    ref.reject_rates(250.0, 80.0)
    want = jax_re.stats_snapshot()
    re.stats_reset()
    eng.reject_rates(server, pool)
    eng.reject_rates(250.0, 80.0)
    got = re.stats_snapshot()
    for key in ("sweeps", "events", "candidate_events"):
        assert got[key] == want[key], key
    times = re.stage_times()
    assert times.sweeps == [(2, "int16"), (1, "int16")]
    assert times.sweep_s > 0 and got["wall_s"] > 0


def test_non_integral_decisions_and_failure_schedules_raise():
    _, _, pvms, pdec = port_world(3, "static")
    half = PolicyDecisions(pdec.local_gb + 0.5, pdec.pool_gb,
                           pdec.fully_pooled, pdec.t_migrate)
    eng = re.CompiledReplay(pvms, half, PORT_WORLD_CFG, device="cpu")
    assert not eng._exact
    # the integer sweep still refuses them; "auto" takes the numpy
    # divergence-window backend (M1b), == the scalar oracle
    with pytest.raises(NotImplementedError, match="numpy"):
        eng.reject_rates(SERVER, POOL, backend="torch")
    half_list = half.as_vmdecisions()
    assert eng.reject_rates(SERVER, POOL).tolist() == [
        cs.replay_reject_rate(pvms, half_list, PORT_WORLD_CFG, s, p)
        for s, p in zip(SERVER, POOL)]
    # failure schedules (M10): on non-integral decisions "auto" loops the
    # scalar oracle, as backend="oracle" does
    sched = FailureSchedule.generate(4 * 86400, PORT_WORLD_CFG.n_groups,
                                     4 * 3600.0, 1800.0, seed=0)
    eng_f = re.CompiledReplay(pvms, half, PORT_WORLD_CFG,
                              failure_schedule=sched, device="cpu")
    auto = eng_f.availability(SERVER[:2], POOL[:2])
    res = eng_f.availability(SERVER[:2], POOL[:2], backend="oracle")
    assert res.affected.shape == (2,) and res.n_failures == sched.n_failures
    for f in re.AVAILABILITY_FIELDS + ("affected_per_failure",):
        assert getattr(auto, f).tolist() == getattr(res, f).tolist(), f
    with pytest.raises(ValueError, match="align"):
        re.CompiledReplay(pvms, pdec.slice(0, 5), PORT_WORLD_CFG,
                          device="cpu")


def test_empty_trace_prices_nothing():
    eng = re.CompiledReplay([], PolicyDecisions(*(np.zeros(0),) * 4),
                            PORT_WORLD_CFG, device="cpu")
    assert eng.reject_rates(SERVER, POOL).tolist() == [0.0] * len(SERVER)
