"""``CompiledReplayStream`` of the port against the reference's: the shard
cuts and their bookkeeping, reject rates on both backends (``==`` against
the reference's stream, which pads its shards, and the port's monolithic
engine), chunked construction, the divergence-window skip, the
``reject_cap`` early exit, non-integral decisions, ``peak_pool_demand``,
the int16 boundary cases, the pool search and ``savings_analysis`` past the
shard budget.  Inputs come from numpy seeds; the port's sweeps run their
plain versions here (CPU tensors).  The reference's 100,000-VM acceptance
trace is mirrored by a 5,000-VM cut of its generator (the whole trace runs
on the card in ``chip_smoke.py``'s ``stream_full``)."""
import dataclasses

import numpy as np
import pytest

from repro.core import cluster_sim as jax_cs
from repro.core import replay_engine as jax_re
from repro.core import traces as jax_traces
from repro_torch.core import cluster_sim as cs
from repro_torch.core import replay_engine as re
from repro_torch.core import traces
from tests._torch_port_util import port_decisions, port_vms

KW = dict(n_servers=8, pool_sockets=8, gb_per_core=4.75)
JAX_CFG = jax_cs.ClusterConfig(**KW)
CFG = cs.ClusterConfig(**KW)
SERVER = np.array([768.0, 200.0, 140.0, 60.0, 219.7, 0.0])
POOL = np.array([6144.0, 300.0, 0.0, 6144.0, 83.3, 100.0])
BACKENDS = ("torch", "numpy")


def _trace(seed=3, horizon=3 * 86400, frac=0.25):
    """(reference vms, reference decisions, port vms, port decisions):
    the reference's ``tests/test_replay_stream.py::_trace``."""
    n = jax_cs.arrivals_for_util(JAX_CFG, 0.8, horizon)
    vms = jax_traces.Population(seed=0).sample_vms(n, horizon, seed=seed,
                                                   start_id=10 ** 6)
    dec, _ = jax_cs.policy_decisions(vms, "static", static_pool_frac=frac,
                                     as_arrays=True)
    return vms, dec, port_vms(vms), port_decisions(dec)


def _streams(budget, seed=3, horizon=3 * 86400):
    vms, dec, pvms, pdec = _trace(seed, horizon)
    return (jax_re.CompiledReplayStream(vms, dec, JAX_CFG,
                                        max_events_per_shard=budget),
            re.CompiledReplayStream(pvms, pdec, CFG, device="cpu",
                                    max_events_per_shard=budget))


def _assert_same_shards(ref, got):
    for attr in ("n_shards", "_n_slots", "shard_pad_events",
                 "peak_shard_bytes", "max_events_per_shard", "n_events",
                 "n_vms", "_exact", "_has_migrate", "_mig_pool_sum",
                 "_pay_mem_max", "_pay_pool_max"):
        assert getattr(got, attr) == getattr(ref, attr), attr
    assert got.peak_shard_bytes == 6 * 4 * got.shard_pad_events
    assert len(got._shards) == len(ref._shards)
    for a, b in zip(ref._shards, got._shards):
        for key in a:
            assert a[key].dtype == b[key].dtype, key
            assert a[key].tolist() == b[key].tolist(), key
    assert sum(got._shard_events) == got.n_events
    assert all(n == got.max_events_per_shard
               for n in got._shard_events[:-1])


def _vm_columns(n, seed=11, days=30):
    """The reference's 100,000-VM acceptance generator
    (``tests/test_replay_stream.py::test_stream_100k_vm_trace_...``):
    arrival-sorted columns of ``n`` VMs."""
    rng = np.random.default_rng(seed)
    arrival = np.sort(rng.uniform(0, days * 86400, n)).round(3)
    life = rng.integers(1800, 86400, n).astype(float)
    cores = rng.choice([2, 4, 8], n, p=[.5, .3, .2])
    mem = cores * rng.choice([2, 4], n)
    return arrival, life, cores, mem


@pytest.mark.parametrize("budget", [256, 300, 320, 1024, 4096])
def test_shard_bookkeeping_equals_reference(budget):
    ref, got = _streams(budget)
    _assert_same_shards(ref, got)
    assert got.max_events_per_shard == budget // 256 * 256
    assert got.shard_pad_events <= budget


def test_stream_bit_exact_on_fixture_both_backends():
    vms = jax_traces.load_trace_file(jax_traces.fixture_trace_path())
    kw = dict(n_servers=4, pool_sockets=4, gb_per_core=4.0)
    dec, _ = jax_cs.policy_decisions(vms, "static", static_pool_frac=0.25,
                                     as_arrays=True)
    pvms, pdec = port_vms(vms), port_decisions(dec)
    server = np.array([768.0, 120.0, 60.0, 30.0])
    pool = np.array([512.0, 64.0, 0.0, 512.0])
    want = jax_re.CompiledReplayStream(
        vms, dec, jax_cs.ClusterConfig(**kw),
        max_events_per_shard=256).reject_rates(server, pool)
    stream = re.CompiledReplayStream(pvms, pdec, cs.ClusterConfig(**kw),
                                     max_events_per_shard=256, device="cpu")
    mono = re.CompiledReplay(pvms, pdec, cs.ClusterConfig(**kw),
                             device="cpu").reject_rates(server, pool)
    for backend in BACKENDS:
        got = stream.reject_rates(server, pool, backend=backend)
        assert got.tolist() == want.tolist() == mono.tolist(), backend


@pytest.mark.parametrize("budget", [256, 320])   # aligned and ragged
def test_stream_multi_shard_carry_matches_monolithic(budget):
    ref, got = _streams(budget)
    vms, dec, pvms, pdec = _trace()
    assert got.n_shards > 1                       # the state is carried
    want = ref.reject_rates(SERVER, POOL)
    mono = re.CompiledReplay(pvms, pdec, CFG,
                             device="cpu").reject_rates(SERVER, POOL)
    assert want.tolist() == mono.tolist()
    for backend in BACKENDS:
        assert got.reject_rates(SERVER, POOL, backend=backend).tolist() \
            == want.tolist(), backend
    # without the divergence-window skip and with it, the same rates; and
    # the skip really starts past the first shard for generous lanes
    assert got.reject_rates(SERVER, POOL, skip_windows=False).tolist() \
        == want.tolist()
    skip = re._stream_reference(got)
    want_skip = jax_re._stream_reference(ref)
    assert skip["max_srv"].tolist() == want_skip["max_srv"].tolist()
    assert skip["max_pool"].tolist() == want_skip["max_pool"].tolist()
    assert re._skip_count(skip, 768.0, 6144.0, got.n_shards) \
        == jax_re._skip_count(want_skip, 768.0, 6144.0, ref.n_shards) \
        == got.n_shards


def _sorted_world():
    vms, _, _, _ = _trace()
    order = sorted(range(len(vms)), key=lambda i: vms[i].arrival)
    return [vms[i] for i in order]


def test_stream_chunked_construction_matches_monolithic():
    svms = _sorted_world()
    dec = jax_cs.policy_decisions(svms, "static", static_pool_frac=0.25)[0]
    pvms = port_vms(svms)
    pdec = [cs.VMDecision(d.local_gb, d.pool_gb, d.fully_pooled,
                          d.t_migrate) for d in dec]
    want = jax_re.CompiledReplay(svms, dec, JAX_CFG).reject_rates(SERVER,
                                                                 POOL)
    dmap = {id(v): d for v, d in zip(pvms, pdec)}
    stream = re.CompiledReplayStream(
        iter([pvms[i:i + 97] for i in range(0, len(pvms), 97)]), None, CFG,
        max_events_per_shard=256, device="cpu",
        decide=lambda ch: [dmap[id(v)] for v in ch])
    ref = jax_re.CompiledReplayStream(svms, dec, JAX_CFG,
                                      max_events_per_shard=256)
    assert stream.n_shards > 1
    _assert_same_shards(ref, stream)
    assert stream.reject_rates(SERVER, POOL).tolist() == want.tolist()
    # out-of-order chunks are refused, not silently mis-replayed
    with pytest.raises(ValueError, match="non-decreasing"):
        re.CompiledReplayStream(
            iter([pvms[100:], pvms[:100]]), None, CFG, device="cpu",
            max_events_per_shard=256,
            decide=lambda ch: [dmap[id(v)] for v in ch])
    with pytest.raises(ValueError, match="decide"):
        re.CompiledReplayStream(iter([pvms[:10]]), pdec[:10], CFG,
                                device="cpu")


def test_stream_chunked_soa_slice_decisions_match_monolithic():
    svms = _sorted_world()
    dec, _ = jax_cs.policy_decisions(svms, "static", static_pool_frac=0.25,
                                     as_arrays=True)
    pvms, pdec = port_vms(svms), port_decisions(dec)
    want = jax_re.CompiledReplay(svms, dec, JAX_CFG).reject_rates(SERVER,
                                                                 POOL)
    off = [0]

    def decide(chunk):
        lo = off[0]
        off[0] += len(chunk)
        return pdec.slice(lo, off[0])

    stream = re.CompiledReplayStream(
        iter([pvms[i:i + 97] for i in range(0, len(pvms), 97)]), None, CFG,
        max_events_per_shard=256, device="cpu", decide=decide)
    assert stream.n_shards > 1
    assert stream.reject_rates(SERVER, POOL).tolist() == want.tolist()
    # all-local by default: no decide
    local = re.CompiledReplayStream(
        iter([pvms[i:i + 97] for i in range(0, len(pvms), 97)]), None, CFG,
        max_events_per_shard=256, device="cpu")
    want_local = jax_re.CompiledReplayStream(
        iter([svms[i:i + 97] for i in range(0, len(svms), 97)]), None,
        JAX_CFG, max_events_per_shard=256).reject_rates(SERVER, POOL)
    assert local.reject_rates(SERVER, POOL).tolist() == want_local.tolist()


def test_stream_5000_vm_cut_of_the_acceptance_trace():
    """The first 5,000 VMs of the reference's 100,000-VM acceptance trace
    (112 servers, static floor 0.25) at a budget of 1,024: bit-exact
    against the reference's stream and the port's monolithic engine, the
    shard bookkeeping the reference's."""
    arrival, life, cores, mem = (a[:5000] for a in _vm_columns(100_000))
    pmu = np.zeros(jax_traces.N_PMU_FEATURES, np.float32)
    vms = [jax_traces.VM(i, 0, 0, 0, 0, int(cores[i]), float(mem[i]),
                         float(arrival[i]), float(life[i]), 0.5, 0.0, 0.0,
                         pmu) for i in range(len(arrival))]
    dec = [jax_cs.VMDecision(v.mem_gb - float(np.floor(v.mem_gb * 0.25)),
                             float(np.floor(v.mem_gb * 0.25)), False, None)
           for v in vms]
    pvms = port_vms(vms)
    pdec = [cs.VMDecision(d.local_gb, d.pool_gb, False, None) for d in dec]
    kw = dict(n_servers=112, pool_sockets=16, gb_per_core=4.75)
    server = np.array([768.0, 44.0, 30.0, 36.0])
    pool = np.array([6144.0, 512.0, 6144.0, 0.0])
    ref = jax_re.CompiledReplayStream(vms, dec, jax_cs.ClusterConfig(**kw),
                                      max_events_per_shard=1024)
    stream = re.CompiledReplayStream(pvms, pdec, cs.ClusterConfig(**kw),
                                     max_events_per_shard=1024,
                                     device="cpu")
    _assert_same_shards(ref, stream)
    assert stream.n_shards >= 6 and stream.shard_pad_events <= 1024
    want = ref.reject_rates(server, pool)
    assert len(set(want.tolist())) > 1            # memory binds
    mono = re.CompiledReplay(pvms, pdec, cs.ClusterConfig(**kw),
                             device="cpu").reject_rates(server, pool)
    got = stream.reject_rates(server, pool)
    assert got.tolist() == want.tolist() == mono.tolist()


def test_stream_reject_cap_equals_reference_and_keeps_feasibility():
    ref, got = _streams(256)
    vms = _trace()[0]
    tol = 0.02
    cap = int(tol * len(vms))
    full = got.reject_rates(SERVER, POOL)
    for backend in BACKENDS:
        capped = got.reject_rates(SERVER, POOL, reject_cap=cap,
                                  backend=backend)
        assert ((full <= tol) == (capped <= tol)).all(), backend
        # early-exited candidates report at or above the lower bound
        assert (capped[capped > tol] * len(vms) >= cap + 1).all()
        # the same early exit as the reference's (one candidate chunk
        # there, one launch here): the same shard, the same counts
        want = ref.reject_rates(SERVER, POOL, reject_cap=cap,
                                backend="jax" if backend == "torch"
                                else "numpy")
        assert capped.tolist() == want.tolist(), backend
    # every lane over the cap stops the stream before its last shard
    hopeless = np.array([30.0, 20.0])
    early = got.reject_rates(hopeless, 0.0, reject_cap=0)
    assert early.tolist() == ref.reject_rates(hopeless, 0.0,
                                              reject_cap=0).tolist()
    assert (early < got.reject_rates(hopeless, 0.0)).all()


def test_stream_fractional_decisions_go_to_numpy_and_match_the_oracle():
    vms, _, pvms, _ = _trace()
    dec = [jax_cs.VMDecision(vm.mem_gb - 0.5, 0.5, False, None)
           for vm in vms]
    pdec = [cs.VMDecision(vm.mem_gb - 0.5, 0.5, False, None) for vm in pvms]
    stream = re.CompiledReplayStream(pvms, pdec, CFG, device="cpu",
                                     max_events_per_shard=256)
    assert not stream._exact              # auto-routes to numpy/float64
    got = stream.reject_rates(SERVER[:3], POOL[:3])
    want = jax_re.CompiledReplayStream(
        vms, dec, JAX_CFG, max_events_per_shard=256).reject_rates(
        SERVER[:3], POOL[:3])
    oracle = [cs.replay_reject_rate(pvms, pdec, CFG, s, p)
              for s, p in zip(SERVER[:3], POOL[:3])]
    assert got.tolist() == want.tolist() == oracle
    with pytest.raises(NotImplementedError, match="numpy"):
        stream.reject_rates(SERVER[:3], POOL[:3], backend="torch")
    assert re._stream_reference(stream) is None    # no exact skip


def test_stream_peak_pool_demand_matches_monolithic():
    ref, got = _streams(256)
    vms, dec, pvms, pdec = _trace()
    mono = re.CompiledReplay(pvms, pdec, CFG, device="cpu")
    assert got.peak_pool_demand() == ref.peak_pool_demand() \
        == mono.peak_pool_demand()


def test_int16_matches_int32_near_boundary_on_the_stream():
    """The stream packs to int16 by the monolithic engine's rules, right
    up to the boundary (the reference's
    ``test_int16_matches_int32_near_boundary``, its stream parts)."""
    vms, dec, pvms, pdec = _trace()
    eng = re.CompiledReplay(pvms, pdec, CFG, device="cpu")
    safe = re.sweep_core.I16_SAFE
    server = np.array([safe - eng._pay_mem_max, 200.0, 140.0, 60.0])
    pool = np.array([safe - eng._pay_pool_max, 300.0, 0.0,
                     safe - eng._pay_pool_max])
    oracle = [cs.replay_reject_rate(pvms, pdec.as_vmdecisions(), CFG, s, p)
              for s, p in zip(server, pool)]
    stream = re.CompiledReplayStream(pvms, pdec, CFG, device="cpu",
                                     max_events_per_shard=256)
    ref = jax_re.CompiledReplayStream(vms, dec, JAX_CFG,
                                      max_events_per_shard=256)
    for q in (0.0, 1.0):
        for s_, p_ in ((server + q, pool), (server, pool + q)):
            assert stream._pick_state_dtype(np.floor(s_), np.floor(p_)) \
                == ref._pick_state_dtype(np.floor(s_), np.floor(p_))
    assert stream._pick_state_dtype(np.floor(server),
                                    np.floor(pool)) == "int16"
    s16 = stream.reject_rates(server, pool, state_dtype="int16")
    s32 = stream.reject_rates(server, pool, state_dtype="int32")
    assert s16.tolist() == s32.tolist() == oracle
    # MIGRATE-bearing: the used-pool deficit path, int16 at the bound
    mig = [cs.VMDecision(d.local_gb, d.pool_gb, d.fully_pooled,
                         pvms[i].arrival + 1.0)
           for i, d in enumerate(pdec.as_vmdecisions())]
    jmig = [jax_cs.VMDecision(d.local_gb, d.pool_gb, d.fully_pooled,
                              vms[i].arrival + 1.0)
            for i, d in enumerate(dec.as_vmdecisions())]
    st_mig = re.CompiledReplayStream(pvms, mig, CFG, device="cpu",
                                     max_events_per_shard=512)
    ref_mig = jax_re.CompiledReplayStream(vms, jmig, JAX_CFG,
                                          max_events_per_shard=512)
    assert st_mig._has_migrate
    assert st_mig._mig_pool_sum == ref_mig._mig_pool_sum
    assert st_mig._pick_state_dtype(np.floor(server),
                                    np.floor(pool)) == "int16"
    mig_oracle = [cs.replay_reject_rate(pvms, mig, CFG, s, p)
                  for s, p in zip(server, pool)]
    got = st_mig.reject_rates(server, pool, state_dtype="int16")
    assert got.tolist() == mig_oracle == ref_mig.reject_rates(
        server, pool, backend="jax", state_dtype="int16").tolist()


def test_int16_migrate_pool_deficit_boundary_on_the_stream():
    """The migrate-event pool total is the exact int16 gate of the stream
    too (the reference's ``test_int16_migrate_pool_deficit_boundary``)."""
    safe = re.sweep_core.I16_SAFE
    pmu = np.zeros(traces.N_PMU_FEATURES, np.float32)

    def build(n_vms, pool_gb=750.0, mem_gb=800.0):
        vms = [traces.VM(i, 0, 0, 0, 0, 2, mem_gb, float(10 * i), 5.0, 0.5,
                         0.0, 0.0, pmu) for i in range(n_vms)]
        dec = [cs.VMDecision(mem_gb - pool_gb, pool_gb, False,
                             vms[i].arrival + 1.0) for i in range(n_vms)]
        return vms, dec

    cfg = cs.ClusterConfig(n_servers=4, pool_sockets=8)
    server = np.array([900.0, 900.0])
    pool = np.array([800.0, 0.0])         # 0-pool lane: the deficit path
    vms, dec = build(39)                  # 39 * 750 + 750 == safe
    stream = re.CompiledReplayStream(vms, dec, cfg, device="cpu",
                                     max_events_per_shard=256)
    assert stream._mig_pool_sum + stream._pay_pool_max == safe
    assert stream._pick_state_dtype(np.floor(server),
                                    np.floor(pool)) == "int16"
    oracle = [cs.replay_reject_rate(vms, dec, cfg, s, p)
              for s, p in zip(server, pool)]
    assert stream.reject_rates(server, pool,
                               state_dtype="int16").tolist() == oracle
    assert stream.reject_rates(server, pool, state_dtype="int32",
                               skip_windows=False).tolist() == oracle
    vms40, dec40 = build(40)              # one more crosses the bound
    st40 = re.CompiledReplayStream(vms40, dec40, cfg, device="cpu",
                                   max_events_per_shard=256)
    assert st40._mig_pool_sum + st40._pay_pool_max > safe
    assert st40._pick_state_dtype(np.floor(server),
                                  np.floor(pool)) == "int32"


def test_pool_search_batched_on_a_stream_equals_reference():
    ref, got = _streams(256, horizon=2 * 86400)
    big_pool = 768.0 * 8
    tol = float(ref.reject_rates(768.0, big_pool)[0]) + 0.005
    cap = int(np.floor(tol * ref.n_vms))
    grid = np.linspace(150.0, 300.0, 4)
    want = jax_re.pool_search_batched(ref, grid, big_pool, tol,
                                      reject_cap=cap)
    assert re.pool_search_batched(got, grid, big_pool, tol,
                                  reject_cap=cap).tolist() == want.tolist()
    assert (want < big_pool).any()


def test_savings_analysis_streams_past_shard_budget():
    """``savings_analysis(max_events_per_shard=)`` prices on a stream, every
    field ``==`` the reference's streamed result; its server bisections
    replicate the monolithic probes, its optimum is feasible and within
    the stream's peak pool demand (the reference's own checks)."""
    vms, _, pvms, _ = _trace(horizon=2 * 86400)
    kw = dict(static_pool_frac=0.25, max_events_per_shard=256)
    want = jax_cs.savings_analysis(vms, JAX_CFG, "static", **kw)
    cache: dict = {}
    got = cs.savings_analysis(pvms, CFG, "static", device="cpu", cache=cache,
                              **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert isinstance(cache["local_engine"], re.CompiledReplayStream)
    mono = cs.savings_analysis(pvms, CFG, "static", device="cpu",
                               static_pool_frac=0.25)
    assert got.baseline_server_gb == mono.baseline_server_gb
    dec, _ = cs.policy_decisions(pvms, "static", static_pool_frac=0.25)
    stream = re.CompiledReplayStream(pvms, dec, CFG, device="cpu",
                                     max_events_per_shard=256)
    assert got.pool_group_gb <= stream.peak_pool_demand() + 1e-9
    assert got.server_gb <= got.baseline_server_gb + 1e-9
    r0 = float(stream.reject_rates(768.0, 768.0 * 8)[0])
    assert re.CompiledReplay(pvms, dec, CFG, device="cpu").reject_rates(
        got.server_gb, got.pool_group_gb)[0] <= r0 + 0.005
    with pytest.raises(ValueError, match=">= 256"):
        cs.savings_analysis(pvms, CFG, "static", device="cpu",
                            max_events_per_shard=255)


def test_engine_stats_count_true_lanes():
    """``EngineStats`` counts sweeps and events as the reference does; its
    candidate events count the true lanes of every swept shard, where the
    reference counts its padded candidate bucket (16 lanes for 6)."""
    ref, got = _streams(256)
    jax_re.stats_reset()
    re.stats_reset()
    ref.reject_rates(SERVER, POOL, skip_windows=False)
    got.reject_rates(SERVER, POOL, skip_windows=False)
    want, have = jax_re.stats_snapshot(), re.stats_snapshot()
    assert have["sweeps"] == want["sweeps"] == 1
    assert have["events"] == want["events"] == got.n_events
    assert have["candidate_events"] * 16 == want["candidate_events"] * 6
    assert have["candidate_events"] == \
        got.n_shards * got.shard_pad_events * len(SERVER)
    re.stats_reset()
    got.reject_rates(SERVER, POOL, backend="numpy")
    assert re.stats_snapshot()["candidate_events"] == \
        got.n_shards * got.shard_pad_events * len(SERVER)
    assert re.stage_times().sweeps == []         # numpy: no launch


def test_stream_refuses_what_it_does_not_take():
    _, _, pvms, pdec = _trace()
    with pytest.raises(ValueError, match=">= 256"):
        re.CompiledReplayStream(pvms, pdec, CFG, device="cpu",
                                max_events_per_shard=100)
    with pytest.raises(TypeError, match="cfg"):
        re.CompiledReplayStream(pvms, pdec, device="cpu")
    stream = re.CompiledReplayStream(pvms, pdec, CFG, device="cpu",
                                     max_events_per_shard=256)
    # devices="all" on a CPU stream is the single-device path (M13)
    assert stream.reject_rates(SERVER, POOL, devices="all").tolist() == \
        stream.reject_rates(SERVER, POOL).tolist()
    with pytest.raises(ValueError, match="backend"):
        stream.reject_rates(SERVER, POOL, backend="jax")
    with pytest.raises(RuntimeError, match="CUDA"):
        re.CompiledReplayStream(pvms, pdec, CFG, max_events_per_shard=256)
    empty = re.CompiledReplayStream([], None, CFG, device="cpu")
    assert empty.n_shards == 0 and empty.reject_rates(SERVER, POOL).tolist() \
        == [0.0] * len(SERVER)
