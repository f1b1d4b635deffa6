"""The numpy divergence-window backend of the port's ``CompiledReplay``
against the reference's numpy backend and the scalar oracle, on integral
and non-integral decisions: rates ``==``, ``reject_cap``'s feasibility
classification, ``CompiledReplayBatch`` over non-integral traces,
``availability(backend="auto")`` taking the oracle on them, the savings
searches on a non-integral trace, the statistics, and ``"auto"`` choosing
by the decisions alone (the ``"torch"`` backend still refuses fractional
GB)."""
import copy
import dataclasses

import numpy as np
import pytest

from repro.core import cluster_sim as jax_cs
from repro.core import replay_engine as jax_re
from repro.core import traces as jax_traces
from repro.runtime.fault import FailureSchedule as JaxFailureSchedule
from repro_torch.core import cluster_sim as cs
from repro_torch.core import replay_engine as re
from repro_torch.core import traces
from repro_torch.runtime.fault import FailureSchedule
from tests._torch_port_util import (PORT_WORLD_CFG, POOL, SERVER, WORLD_CFG,
                                    WORLD_HORIZON, port_decisions, port_vms,
                                    port_world)

WORLDS = [(s, p) for s in (3, 4, 5) for p in ("static", "pond")]


def _fractional(dec, shift_local=0.5, shift_pool=0.25):
    """The decisions with a fraction of a GB added to every VM's local and
    pool split (the reference's PolicyDecisions; the port's follows)."""
    return dataclasses.replace(
        dec, local_gb=np.asarray(dec.local_gb) + shift_local,
        pool_gb=np.asarray(dec.pool_gb)
        + np.where(np.asarray(dec.pool_gb) > 0, shift_pool, 0.0))


def _engines(seed, policy, fractional=False, schedule=None):
    vms, dec, pvms, _ = port_world(seed, policy)
    if fractional:
        dec = _fractional(dec)
    kw = {}
    if schedule is not None:
        kw = dict(failure_schedule=JaxFailureSchedule(*schedule))
    ref = jax_re.CompiledReplay(vms, dec, WORLD_CFG, **kw)
    if schedule is not None:
        kw = dict(failure_schedule=FailureSchedule(*schedule))
    eng = re.CompiledReplay(pvms, port_decisions(dec), PORT_WORLD_CFG,
                            device="cpu", **kw)
    return vms, dec, pvms, ref, eng


def _oracle(pvms, eng, server, pool):
    dec = eng._decisions_src.as_vmdecisions()
    return [cs.replay_reject_rate(pvms, dec, PORT_WORLD_CFG, s, p)
            for s, p in zip(server, pool)]


@pytest.mark.parametrize("fractional", [False, True],
                         ids=["integral", "fractional"])
@pytest.mark.parametrize("seed,policy", WORLDS)
def test_numpy_backend_equals_reference_and_scalar_oracle(seed, policy,
                                                          fractional):
    vms, dec, pvms, ref, eng = _engines(seed, policy, fractional)
    assert eng._exact == ref._exact == (not fractional)
    got = eng.reject_rates(SERVER, POOL, backend="numpy")
    assert got.dtype == np.float64
    assert got.tolist() == ref.reject_rates(SERVER, POOL,
                                            backend="numpy").tolist()
    assert got.tolist() == _oracle(pvms, eng, SERVER, POOL)
    assert eng.reject_rates(SERVER, POOL).tolist() == got.tolist()
    # per-size trajectories (a pool-varying batch at few server sizes)
    s2, p2 = np.repeat(SERVER[1:4], 3), np.tile(POOL[1:4], 3)
    got2 = eng.reject_rates(s2, p2, backend="numpy")
    assert got2.tolist() == ref.reject_rates(s2, p2,
                                             backend="numpy").tolist()
    if fractional:
        assert got2.tolist() == _oracle(pvms, eng, s2, p2)
    else:
        assert got2.tolist() == eng.reject_rates(s2, p2).tolist()


@pytest.mark.parametrize("fractional", [False, True],
                         ids=["integral", "fractional"])
def test_reject_cap_classifies_feasibility_like_the_reference(fractional):
    vms, dec, pvms, ref, eng = _engines(3, "static", fractional)
    exact = eng.reject_rates(SERVER, POOL, backend="numpy")
    tol = float(exact.min()) + 0.005
    cap = int(np.floor(tol * len(vms)))
    capped = eng.reject_rates(SERVER, POOL, reject_cap=cap, backend="numpy")
    assert ((capped <= tol) == (exact <= tol)).all()
    assert capped.tolist() == ref.reject_rates(
        SERVER, POOL, reject_cap=cap, backend="numpy").tolist()
    # dropped candidates report the lower bound (cap + 1) / n
    over = exact > (cap + 0.5) / len(vms)
    assert over.any()
    assert (capped[over] == (cap + 1) / len(vms)).all()
    assert (capped[~over] == exact[~over]).all()
    # the torch path stays exact under a cap (integral decisions only)
    if not fractional:
        assert eng.reject_rates(SERVER, POOL, reject_cap=cap).tolist() \
            == exact.tolist()


def test_auto_chooses_by_the_decisions_and_torch_refuses_fractions():
    _, _, _, _, eng = _engines(4, "static")
    _, _, _, _, frac = _engines(4, "static", fractional=True)
    re.stats_reset()
    eng.reject_rates(SERVER, POOL)                      # integral: torch
    assert re.stage_times().sweeps == [(len(SERVER), "int16")]
    frac.reject_rates(SERVER, POOL)                     # fractional: numpy
    times = re.stage_times()
    assert times.sweeps == [(len(SERVER), "int16")]     # no launch
    assert times.sweep_s > 0
    with pytest.raises(NotImplementedError, match="numpy"):
        frac.reject_rates(SERVER, POOL, backend="torch")
    with pytest.raises(ValueError, match="backend"):
        frac.reject_rates(SERVER, POOL, backend="jax")
    # a fractional engine on the card would refuse the same way: the
    # choice reads only the decisions, so "auto" never reaches the card
    card = re.CompiledReplay.__new__(re.CompiledReplay)
    card.__dict__.update(frac.__dict__)
    card.device = "cuda"
    assert card.reject_rates(SERVER[:2], POOL[:2]).tolist() == \
        frac.reject_rates(SERVER[:2], POOL[:2]).tolist()


def test_numpy_stats_and_stage_times_count_like_the_reference():
    _, _, _, ref, eng = _engines(5, "pond", fractional=True)
    re.stats_reset()
    jax_re.stats_reset()
    eng.reject_rates(SERVER[:3], POOL[:3])
    ref.reject_rates(SERVER[:3], POOL[:3])
    got, want = re.stats_snapshot(), jax_re.stats_snapshot()
    for key in ("sweeps", "events", "candidate_events"):
        assert got[key] == want[key], key
    _, _, _, ref, eng = _engines(5, "pond")
    re.stats_reset()
    jax_re.stats_reset()
    eng.reject_rates(SERVER, POOL, backend="numpy")
    ref.reject_rates(SERVER, POOL, backend="numpy")
    got, want = re.stats_snapshot(), jax_re.stats_snapshot()
    for key in ("sweeps", "events", "candidate_events"):
        assert got[key] == want[key], key
    times = re.stage_times()
    assert times.trajectory_s > 0 and times.sweep_s > 0
    assert times.sweeps == []


def test_stale_migrate_after_departure_is_dropped_on_fractions():
    """tests/test_replay_engine.py's stale-MIGRATE case with fractional
    GB: the numpy backend == the scalar oracle in both packages."""
    pop = traces.Population(seed=0)
    base = pop.sample_vms(3, 100.0, seed=1)
    for vm, (arr, life, cores, mem) in zip(
            base, [(0.0, 10.0, 2, 8.5), (20.0, 100.0, 2, 8.5),
                   (35.0, 50.0, 2, 8.5)]):
        vm.arrival, vm.lifetime, vm.cores, vm.mem_gb = arr, life, cores, mem
    decisions = [cs.VMDecision(4.25, 4.25, False, 30.0),
                 cs.VMDecision(4.25, 4.25, False, None),
                 cs.VMDecision(4.25, 4.25, False, 25.0)]
    cfg = cs.ClusterConfig(n_servers=1, pool_sockets=2, gb_per_core=4.75)
    eng = re.CompiledReplay(base, decisions, cfg, device="cpu")
    for s, p in ((17.0, 17.0), (12.0, 4.25), (8.5, 16.0), (13.0, 4.0)):
        want = cs.replay_reject_rate(base, decisions, cfg, s, p)
        assert eng.reject_rates(s, p)[0] == want, (s, p)


# ------------------------------------------------------------ the batch ---
def _batch_pair(fractional=(True, True)):
    refs, engs = [], []
    for seed, frac in zip((3, 4), fractional):
        _, _, _, ref, eng = _engines(seed, "static", frac)
        refs.append(ref)
        engs.append(eng)
    return (jax_re.CompiledReplayBatch(refs), re.CompiledReplayBatch(engs),
            engs)


@pytest.mark.parametrize("fractional", [(True, True), (False, True)],
                         ids=["both", "one"])
def test_batch_over_fractional_traces_loops_the_numpy_backend(fractional):
    ref, batch, engs = _batch_pair(fractional)
    assert not batch._exact
    got = batch.reject_rates(SERVER, POOL)
    assert got.shape == (2, len(SERVER))
    assert got.tolist() == ref.reject_rates(SERVER, POOL).tolist()
    assert got.tolist() == [e.reject_rates(SERVER, POOL, backend="numpy")
                            .tolist() for e in engs]
    per = np.stack([SERVER, SERVER + 8.0])
    cap = 20
    assert batch.reject_rates(per, POOL, reject_cap=cap).tolist() == \
        ref.reject_rates(per, POOL, reject_cap=cap).tolist()
    with pytest.raises(NotImplementedError, match="numpy"):
        batch.reject_rates(SERVER, POOL, backend="torch")
    # integral traces take numpy only when asked, with the same rows
    ref_i, batch_i, _ = _batch_pair((False, False))
    assert batch_i.reject_rates(SERVER[:4], POOL[:4],
                                backend="numpy").tolist() == \
        batch_i.reject_rates(SERVER[:4], POOL[:4]).tolist() == \
        ref_i.reject_rates(SERVER[:4], POOL[:4], backend="numpy").tolist()


# --------------------------------------------------------- availability ---
_SCHED = dict(horizon_s=WORLD_HORIZON, n_domains=WORLD_CFG.n_groups,
              mtbf_s=6 * 3600.0, repair_s=1800.0)


def _schedules(seed):
    ref = JaxFailureSchedule.generate(seed=seed, **_SCHED)
    return (np.array(ref.times), np.array(ref.domains),
            np.array(ref.recovers))


@pytest.mark.parametrize("mitigation", ["remigrate", "kill"])
def test_availability_auto_takes_the_oracle_on_fractions(mitigation):
    vms, dec, pvms, ref, eng = _engines(3, "pond", True, _schedules(0))
    got = eng.availability(SERVER, POOL, mitigation)
    want = ref.availability(SERVER, POOL, mitigation)
    oracle = eng.availability(SERVER, POOL, mitigation, backend="oracle")
    for f in re.AVAILABILITY_FIELDS + ("affected_per_failure",):
        assert np.asarray(getattr(got, f)).tolist() == \
            np.asarray(getattr(want, f)).tolist() == \
            np.asarray(getattr(oracle, f)).tolist(), f
    assert got.n_failures == want.n_failures
    assert np.asarray(got.affected).sum() > 0
    # the batch's rows: the oracle loop, == the reference's batch
    engs, refs = [eng], [ref]
    for seed in (4,):
        *_, r, e = _engines(seed, "pond", True, _schedules(1))
        engs.append(e)
        refs.append(r)
    got_b = re.CompiledReplayBatch(engs).availability(SERVER[:4], POOL[:4],
                                                      mitigation)
    want_b = jax_re.CompiledReplayBatch(refs).availability(
        SERVER[:4], POOL[:4], mitigation)
    for f in re.AVAILABILITY_FIELDS:
        assert np.asarray(getattr(got_b, f)).tolist() == \
            np.asarray(getattr(want_b, f)).tolist(), f
    assert got_b.n_failures.tolist() == want_b.n_failures.tolist()
    with pytest.raises(ValueError, match="backend"):
        eng.availability(SERVER, POOL, backend="numpy")


# -------------------------------------------- savings on fractional sizes --
def _fraction_trace(seed):
    """The 8-server world's VMs with a quarter GB added to each: the
    reference's VMs and the port's copies."""
    vms, _, _, _ = port_world(seed, "static")
    vms = copy.deepcopy(vms)
    for v in vms:
        v.mem_gb += 0.25
    return vms, port_vms(vms)


@pytest.mark.parametrize("policy", ["local", "static"])
def test_savings_analysis_on_fractional_sizes_equals_reference(policy):
    vms, pvms = _fraction_trace(3)
    re.stats_reset()
    got = cs.savings_analysis(pvms, PORT_WORLD_CFG, policy,
                              static_pool_frac=0.3, device="cpu")
    assert re.stage_times().sweeps == []            # no K1 sweep at all
    want = jax_cs.savings_analysis(vms, WORLD_CFG, policy,
                                   static_pool_frac=0.3)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    scalar = cs.savings_analysis(pvms, PORT_WORLD_CFG, policy,
                                 static_pool_frac=0.3, use_engine=False,
                                 device="cpu")
    assert scalar.baseline_server_gb == got.baseline_server_gb
    assert scalar.server_gb == got.server_gb
    assert abs(scalar.savings - got.savings) <= 0.02


def test_savings_analysis_batched_on_fractional_sizes_equals_reference():
    pairs = [_fraction_trace(s) for s in (3, 4)]
    cache, jcache = {}, {}
    for policy in ("local", "static"):
        got = cs.savings_analysis_batched([p for _, p in pairs],
                                          PORT_WORLD_CFG, policy,
                                          static_pool_frac=0.3, cache=cache,
                                          device="cpu")
        want = jax_cs.savings_analysis_batched([v for v, _ in pairs],
                                               WORLD_CFG, policy,
                                               static_pool_frac=0.3,
                                               cache=jcache)
        assert [dataclasses.astuple(r) for r in got] == \
            [dataclasses.astuple(r) for r in want], policy


def test_fixture_with_fractional_sizes_round_trips_and_prices(tmp_path):
    """The bundled fixture with a quarter GB added to every VM, written by
    ``save_trace_csv`` and read back by ``load_trace_file`` in both
    packages: the same records, and the same provisioning."""
    vms = traces.load_trace_file(traces.fixture_trace_path())
    for v in vms:
        v.mem_gb += 0.25
    p = str(tmp_path / "frac.csv")
    traces.save_trace_csv(vms, p)
    pvms, jvms = traces.load_trace_file(p), jax_traces.load_trace_file(p)
    assert [v.mem_gb for v in pvms] == [v.mem_gb for v in jvms] \
        == [v.mem_gb for v in vms]
    cfg = cs.ClusterConfig(n_servers=4, pool_sockets=4, gb_per_core=4.0)
    jcfg = jax_cs.ClusterConfig(n_servers=4, pool_sockets=4, gb_per_core=4.0)
    cache, jcache = {}, {}
    for policy in ("local", "static"):
        got = cs.savings_analysis(pvms, cfg, policy, cache=cache,
                                  static_pool_frac=0.3, device="cpu")
        want = jax_cs.savings_analysis(jvms, jcfg, policy, cache=jcache,
                                       static_pool_frac=0.3)
        scalar = cs.savings_analysis(pvms, cfg, policy,
                                     static_pool_frac=0.3, use_engine=False)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
        assert dataclasses.astuple(scalar) == dataclasses.astuple(
            jax_cs.savings_analysis(jvms, jcfg, policy, static_pool_frac=0.3,
                                    use_engine=False))
    assert not cache["local_engine"]._exact
