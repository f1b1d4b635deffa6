"""The failure layer of the port (Pond §4.2, ROADMAP M10) against the
reference: ``CompiledReplay.availability`` and
``CompiledReplayBatch.availability`` on the CPU (K5's plain version) ``==``
the reference's jax backend and its scalar oracle — the five counters and
the per-failure distribution, both mitigations, both state types — on
seeded traces and the bundled fixture; the port's scalar oracle
``replay_with_failures`` and ``FailureSchedule`` ``==`` the reference's;
the reference's errors.  The cases mirror ``tests/test_failures.py`` (its
pool-manager and topology cases belong to M9)."""
import numpy as np
import pytest

from repro.core import cluster_sim as jax_cs
from repro.core import replay_engine as jax_re
from repro.core import traces as jax_traces
from repro.runtime.fault import FailureSchedule as JaxSchedule
from repro_torch.core import cluster_sim, replay_engine
from repro_torch.core.replay_engine import AVAILABILITY_FIELDS
from repro_torch.runtime.fault import FailureSchedule
from tests._torch_port_util import port_decisions, port_vms

CFG_KW = dict(n_servers=8, pool_sockets=8, gb_per_core=4.0)
JAX_CFG = jax_cs.ClusterConfig(**CFG_KW)
CFG = cluster_sim.ClusterConfig(**CFG_KW)
HORIZON = 86400
SERVER = np.array([768.0, 200.0, 96.0])
POOL = np.array([512.0, 300.0, 64.0])
MITIGATIONS = ("remigrate", "kill")


def _trace(seed, cfg=JAX_CFG, horizon=HORIZON):
    """(reference vms, reference decisions, port vms, port decisions),
    as tests/test_failures.py's ``_trace`` builds them."""
    n = jax_cs.arrivals_for_util(cfg, 0.8, horizon)
    vms = jax_traces.Population(seed=0).sample_vms(n, horizon, seed=seed,
                                                   start_id=10 ** 6)
    dec, _ = jax_cs.policy_decisions(vms, "static", static_pool_frac=0.25,
                                     as_arrays=True)
    return vms, dec, port_vms(vms), port_decisions(dec)


def _schedules(seed, mtbf_s=4 * 3600.0, n_groups=JAX_CFG.n_groups,
               horizon=HORIZON):
    """The reference's and the port's schedule from the same seed."""
    args = (horizon, n_groups, mtbf_s, 1800.0)
    return (JaxSchedule.generate(*args, seed=seed),
            FailureSchedule.generate(*args, seed=seed))


def _engines(seed, sched_seed=None, mtbf_s=4 * 3600.0):
    vms, dec, pvms, pdec = _trace(seed)
    js, ps = _schedules(seed if sched_seed is None else sched_seed, mtbf_s)
    return (jax_re.CompiledReplay(vms, dec, JAX_CFG, failure_schedule=js),
            replay_engine.CompiledReplay(pvms, pdec, CFG,
                                         failure_schedule=ps, device="cpu"))


def _assert_same(a, b, ctx, dist=True):
    for f in AVAILABILITY_FIELDS:
        assert np.array_equal(getattr(a, f), getattr(b, f)), (ctx, f)
    assert np.array_equal(a.n_failures, b.n_failures), ctx
    if dist:
        assert np.array_equal(a.affected_per_failure,
                              b.affected_per_failure), ctx


@pytest.mark.parametrize("mitigation", MITIGATIONS)
def test_availability_equals_reference_on_fixture(mitigation):
    vms = jax_traces.load_trace_file(jax_traces.fixture_trace_path())
    kw = dict(n_servers=4, pool_sockets=4, gb_per_core=4.0)
    jcfg, cfg = jax_cs.ClusterConfig(**kw), cluster_sim.ClusterConfig(**kw)
    dec, _ = jax_cs.policy_decisions(vms, "static", static_pool_frac=0.25,
                                     as_arrays=True)
    horizon = max(vm.departure for vm in vms)
    js, ps = _schedules(0, horizon / 6, jcfg.n_groups, horizon)
    assert ps.n_failures > 0
    jeng = jax_re.CompiledReplay(vms, dec, jcfg, failure_schedule=js)
    peng = replay_engine.CompiledReplay(port_vms(vms), port_decisions(dec),
                                        cfg, failure_schedule=ps,
                                        device="cpu")
    server = np.array([768.0, 120.0, 30.0])
    pool = np.array([512.0, 64.0, 512.0])
    oracle = jeng.availability(server, pool, mitigation, backend="oracle")
    for dt in ("int32", "int16"):
        jx = jeng.availability(server, pool, mitigation, backend="jax",
                               state_dtype=dt)
        got = peng.availability(server, pool, mitigation, state_dtype=dt)
        _assert_same(jx, got, (mitigation, dt))
        _assert_same(oracle, got, (mitigation, dt, "oracle"))
    _assert_same(oracle, peng.availability(server, pool, mitigation,
                                           backend="oracle"), "port oracle")


@pytest.mark.parametrize("state_dtype", ("int16", "int32"))
@pytest.mark.parametrize("seed", [3, 4, 5])
@pytest.mark.parametrize("mitigation", MITIGATIONS)
def test_availability_equals_reference_seeded(mitigation, seed,
                                              state_dtype):
    jeng, peng = _engines(seed)
    jx = jeng.availability(SERVER, POOL, mitigation, backend="jax",
                           state_dtype=state_dtype)
    got = peng.availability(SERVER, POOL, mitigation,
                            state_dtype=state_dtype)
    _assert_same(jx, got, (seed, mitigation, state_dtype))
    oracle = jeng.availability(SERVER, POOL, mitigation, backend="oracle")
    _assert_same(oracle, got, (seed, mitigation, "oracle"))
    # the schedule bites: failures touch pooled VMs somewhere
    assert int(np.asarray(got.affected).sum()) > 0
    assert got.mitigation == mitigation


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("mitigation", MITIGATIONS)
def test_port_oracle_equals_reference_oracle(mitigation, seed):
    vms, dec, pvms, pdec = _trace(seed)
    js, ps = _schedules(seed + 10, mtbf_s=2 * 3600.0)
    for s, p in zip(SERVER, POOL):
        want = jax_cs.replay_with_failures(vms, dec.as_vmdecisions(),
                                           JAX_CFG, s, p, js, mitigation)
        got = cluster_sim.replay_with_failures(pvms, pdec.as_vmdecisions(),
                                               CFG, s, p, ps, mitigation)
        for f in ("n_vms", "rejects", "n_failures", "affected_per_failure",
                  "killed", "remigrated", "lost_vm_minutes", "reject_rate",
                  "affected", "remigration_success_rate"):
            assert getattr(got, f) == getattr(want, f), (s, p, f)


def test_port_oracle_refuses_an_unknown_mitigation():
    _, _, pvms, pdec = _trace(3)
    _, ps = _schedules(3)
    with pytest.raises(ValueError, match="mitigation"):
        cluster_sim.replay_with_failures(pvms, pdec.as_vmdecisions(), CFG,
                                         200.0, 300.0, ps, "nope")


def test_failures_degrade_availability_not_happy_path():
    """reject_rates (the plain sweep, K1) ignores FAIL/RECOVER events;
    availability prices them: down domains grant no pool."""
    vms, dec, pvms, pdec = _trace(3)
    _, sched = _schedules(7, mtbf_s=2 * 3600.0)
    eng_f = replay_engine.CompiledReplay(pvms, pdec, CFG,
                                         failure_schedule=sched,
                                         device="cpu")
    eng_0 = replay_engine.CompiledReplay(pvms, pdec, CFG, device="cpu")
    assert eng_f.n_events == eng_0.n_events + len(sched)
    # merged failure events are no-ops in the plain sweep, in both types
    for dt in ("int16", "int32"):
        assert eng_f.reject_rates(SERVER, POOL, state_dtype=dt).tolist() \
            == eng_0.reject_rates(SERVER, POOL, state_dtype=dt).tolist()
    # ... and in the reference's, whose rates they equal
    jeng = jax_re.CompiledReplay(vms, dec, JAX_CFG)
    assert eng_f.reject_rates(SERVER, POOL).tolist() == \
        jeng.reject_rates(SERVER, POOL).tolist()
    av = eng_f.availability(SERVER, POOL, "kill")
    assert np.asarray(av.reject_rate).tolist() != \
        eng_0.reject_rates(SERVER, POOL).tolist()
    assert av.n_failures == sched.n_failures
    assert av.affected_per_failure.shape == (sched.n_failures, len(SERVER))
    assert (av.affected_per_failure.sum(0) == np.asarray(av.affected)).all()
    # without per-failure rows the counters are the same
    plain = eng_f.availability(SERVER, POOL, "kill", per_failure=False)
    assert plain.affected_per_failure is None
    _assert_same(av, plain, "rows", dist=False)


def test_remigrate_beats_kill_on_lost_minutes_with_headroom():
    _, peng = _engines(4, sched_seed=1)
    server, pool = np.array([768.0]), np.array([512.0])
    rem = peng.availability(server, pool, "remigrate")
    kil = peng.availability(server, pool, "kill")
    assert int(rem.killed[0]) == 0
    assert int(rem.lost_vm_minutes[0]) == 0
    assert int(kil.killed[0]) == int(kil.affected[0])
    assert rem.remigration_success_rate[0] == 1.0


@pytest.mark.parametrize("mitigation", MITIGATIONS)
def test_batch_availability_matches_single_rows_and_reference(mitigation):
    pairs = [_engines(seed, sched_seed=k)
             for k, seed in enumerate([3, 4, 5])]
    jbatch = jax_re.CompiledReplayBatch([j for j, _ in pairs])
    batch = replay_engine.CompiledReplayBatch([p for _, p in pairs])
    assert len({p.failure_schedule.n_failures for _, p in pairs}) > 1
    got = batch.availability(SERVER, POOL, mitigation)
    _assert_same(jbatch.availability(SERVER, POOL, mitigation,
                                     backend="jax"), got, mitigation,
                 dist=False)
    assert got.affected_per_failure is None
    for i, (_, e) in enumerate(pairs):
        r = e.availability(SERVER, POOL, mitigation, per_failure=False)
        for f in AVAILABILITY_FIELDS:
            assert np.array_equal(getattr(got, f)[i], getattr(r, f)), (i, f)
        assert got.n_failures[i] == r.n_failures
    # per-trace candidate grids, and the oracle backend, row for row
    grid_s = np.stack([SERVER, SERVER[::-1], SERVER])
    grid_p = np.stack([POOL, POOL, POOL[::-1]])
    _assert_same(batch.availability(grid_s, grid_p, mitigation),
                 batch.availability(grid_s, grid_p, mitigation,
                                    backend="oracle"), "oracle",
                 dist=False)


def test_availability_requires_schedule_and_a_known_mitigation():
    _, _, pvms, pdec = _trace(3)
    eng = replay_engine.CompiledReplay(pvms, pdec, CFG, device="cpu")
    with pytest.raises(ValueError, match="failure_schedule"):
        eng.availability(SERVER, POOL)
    with pytest.raises(ValueError, match="failure_schedule"):
        replay_engine.CompiledReplayBatch([eng]).availability(SERVER, POOL)
    _, peng = _engines(3)
    for call in (lambda: peng.availability(SERVER, POOL, "nope"),
                 lambda: replay_engine.CompiledReplayBatch(
                     [peng]).availability(SERVER, POOL, "nope")):
        with pytest.raises(ValueError, match="mitigation"):
            call()
    with pytest.raises(ValueError, match="backend"):
        peng.availability(SERVER, POOL, backend="jax")


def test_out_of_range_domain_rejected():
    vms, dec, pvms, pdec = _trace(3)
    args = (np.array([10.0]), np.array([CFG.n_groups]), np.array([False]))
    with pytest.raises(ValueError, match="domain"):
        jax_re.CompiledReplay(vms, dec, JAX_CFG,
                              failure_schedule=JaxSchedule(*args))
    with pytest.raises(ValueError, match="domain"):
        replay_engine.CompiledReplay(pvms, pdec, CFG,
                                     failure_schedule=FailureSchedule(*args),
                                     device="cpu")


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 11])
def test_failure_schedule_generate_equals_reference(seed):
    for n_domains, mtbf in ((2, 4 * 3600.0), (32, 24 * 3600.0),
                            (5, 600.0)):
        want = JaxSchedule.generate(7 * 86400, n_domains, mtbf, 1800.0,
                                    seed=seed)
        got = FailureSchedule.generate(7 * 86400, n_domains, mtbf, 1800.0,
                                       seed=seed)
        assert got.times.tolist() == want.times.tolist()
        assert got.domains.tolist() == want.domains.tolist()
        assert got.recovers.tolist() == want.recovers.tolist()
        assert len(got) == len(want) and got.n_failures == want.n_failures
        assert got.max_domain() == want.max_domain()
        # a FAIL sorts before a same-time RECOVER
        assert (np.diff(got.times) >= 0).all()


def test_failure_schedule_checks_like_the_reference():
    for cls in (JaxSchedule, FailureSchedule):
        with pytest.raises(ValueError, match="non-decreasing"):
            cls(np.array([5.0, 1.0]), np.array([0, 0]),
                np.array([False, True]))
        with pytest.raises(ValueError, match="negative"):
            cls(np.array([1.0]), np.array([-1]), np.array([False]))
        with pytest.raises(ValueError, match="align"):
            cls(np.array([1.0, 2.0]), np.array([0]), np.array([False]))
        empty = cls(np.zeros(0), np.zeros(0), np.zeros(0, bool))
        assert len(empty) == 0 and empty.n_failures == 0
        assert empty.max_domain() == -1


def test_an_empty_schedule_prices_the_happy_path():
    """A schedule with no events: availability's rates are reject_rates'
    and nothing is affected (as in the reference)."""
    vms, dec, pvms, pdec = _trace(4)
    args = (np.zeros(0), np.zeros(0, np.int64), np.zeros(0, bool))
    peng = replay_engine.CompiledReplay(pvms, pdec, CFG,
                                        failure_schedule=FailureSchedule(
                                            *args), device="cpu")
    jeng = jax_re.CompiledReplay(vms, dec, JAX_CFG,
                                 failure_schedule=JaxSchedule(*args))
    got = peng.availability(SERVER, POOL, "remigrate")
    _assert_same(jeng.availability(SERVER, POOL, "remigrate",
                                   backend="jax"), got, "empty")
    assert got.reject_rate.tolist() == peng.reject_rates(SERVER,
                                                         POOL).tolist()
    assert got.affected_per_failure.shape == (0, len(SERVER))


def test_fig_availability_example_equals_the_reference_benchmark(capsys):
    """examples/torch_fig_availability.py at the benchmark's quick sizes
    on the CPU: its claims hold and each domain size's frontier ``==``
    ``benchmarks/fig_availability.py::_frontier`` (the reference's jax
    backend) on the same world."""
    import importlib.util
    import os

    from benchmarks import fig_availability
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "torch_fig_availability.py")
    spec = importlib.util.spec_from_file_location("torch_fig_availability",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    res, ok = mod.main(["--device", "cpu"])
    assert len(ok) == 5 and all(ok)
    assert "[PASS] larger failure domains" in capsys.readouterr().out
    horizon, mtbfs = 2 * 86400, [4 * 3600.0, 24 * 3600.0]
    for sockets, got in res.items():
        cfg = jax_cs.ClusterConfig(n_servers=16, pool_sockets=sockets,
                                   gb_per_core=4.0)
        n = jax_cs.arrivals_for_util(cfg, 0.8, horizon)
        vms = jax_traces.Population(seed=0).sample_vms(
            n, horizon, seed=11, start_id=7 * 10 ** 6)
        dec, _ = jax_cs.policy_decisions(vms, "static",
                                         static_pool_frac=0.25)
        want = fig_availability._frontier(cfg, vms, dec, mtbfs, horizon,
                                          [1.0, 0.85, 0.7, 0.55])[0]
        for mit in MITIGATIONS:
            _assert_same(want[mit], got[mit], (sockets, mit), dist=False)
