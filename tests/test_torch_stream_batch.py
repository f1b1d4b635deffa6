"""``CompiledReplayStreamBatch``, the fleet streams and the streaming
checkpoints of the port against the reference: K streams in one launch a
shard ``==`` K independent streams and the reference's stream batch (both
backends, both state types, per-trace grids), the memory bound, the
lockstep searches and ``savings_analysis_batched`` past the budget,
``reject_rates_fleet`` on a stream and a stream batch, kill-at-shard-k
resume (both backends, batched), fingerprints and the invariant guard.
Inputs come from numpy seeds; the port's sweeps run their plain versions
here (CPU tensors)."""
import dataclasses

import numpy as np
import pytest

from repro.core import cluster_sim as jax_cs
from repro.core import replay_engine as jax_re
from repro.core import topology as jax_top
from repro.core import traces as jax_traces
from repro_torch.core import cluster_sim as cs
from repro_torch.core import replay_engine as re
from repro_torch.core import sweep_core
from tests._torch_port_util import port_decisions, port_topology, port_vms

KW = dict(n_servers=8, pool_sockets=8, gb_per_core=4.75)
JAX_CFG = jax_cs.ClusterConfig(**KW)
CFG = cs.ClusterConfig(**KW)
SERVER = np.array([768.0, 200.0, 140.0, 60.0, 219.7, 0.0])
POOL = np.array([6144.0, 300.0, 0.0, 6144.0, 83.3, 100.0])
BACKENDS = ("torch", "numpy")
_WORLDS: dict = {}


def _world(seed=3, horizon=3 * 86400, frac=0.25, cfg=JAX_CFG):
    """(reference vms, reference decisions, port vms, port decisions)."""
    key = (seed, horizon, frac, cfg.n_servers, cfg.gb_per_core)
    if key not in _WORLDS:
        n = jax_cs.arrivals_for_util(cfg, 0.8, horizon)
        vms = jax_traces.Population(seed=0).sample_vms(
            n, horizon, seed=seed, start_id=10 ** 6)
        dec, _ = jax_cs.policy_decisions(vms, "static",
                                         static_pool_frac=frac,
                                         as_arrays=True)
        _WORLDS[key] = (vms, dec, port_vms(vms), port_decisions(dec))
    return _WORLDS[key]


def _pair(worlds, budget=256, jax_cfg=JAX_CFG, cfg=CFG):
    """The reference's and the port's stream batch over ``worlds``."""
    return (jax_re.CompiledReplayStreamBatch([
                jax_re.CompiledReplayStream(v, d, jax_cfg,
                                            max_events_per_shard=budget)
                for v, d, _, _ in worlds]),
            re.CompiledReplayStreamBatch([
                re.CompiledReplayStream(pv, pd, cfg, device="cpu",
                                        max_events_per_shard=budget)
                for _, _, pv, pd in worlds]))


# ------------------------------------------------------- the stream batch --
def test_stream_batch_bit_exact_vs_independent_streams():
    """K batched streams == K independent streams == the reference's
    batch, both backends, both forced state types, per-trace grids."""
    worlds = [_world(frac=f) for f in (0.10, 0.25, 0.40)]
    ref, batch = _pair(worlds)
    assert batch.n_shards > 1
    want = ref.reject_rates(SERVER, POOL)
    singles = np.stack([s.reject_rates(SERVER, POOL)
                        for s in batch.engines])
    assert singles.tolist() == want.tolist()
    for backend in BACKENDS:
        assert batch.reject_rates(SERVER, POOL, backend=backend).tolist() \
            == want.tolist(), backend
    assert batch.reject_rates(SERVER, POOL,
                              skip_windows=False).tolist() == want.tolist()
    srv16 = np.array([768.0, 200.0, 140.0, 60.0])
    pool16 = np.array([2048.0, 300.0, 0.0, 2048.0])
    sq = np.broadcast_to(np.floor(srv16), (3, 4))
    pq = np.broadcast_to(np.floor(pool16), (3, 4))
    assert batch._pick_state_dtype(sq, pq) == ref._pick_state_dtype(sq, pq) \
        == "int16"
    want16 = ref.reject_rates(srv16, pool16)
    for dt in ("int16", "int32"):
        assert batch.reject_rates(srv16, pool16, state_dtype=dt).tolist() \
            == want16.tolist(), dt
    per = np.stack([SERVER[:3], SERVER[1:4], SERVER[2:5]])
    perp = np.stack([POOL[:3], POOL[1:4], POOL[2:5]])
    assert batch.reject_rates(per, perp).tolist() == \
        ref.reject_rates(per, perp).tolist()


def test_stream_batch_of_unequal_streams_and_the_reject_cap():
    """Streams of different lengths: the shorter contributes no events to
    the trailing launches; under a shared cap the batch stops where the
    reference's does, with the same counts."""
    worlds = [_world(seed=3, horizon=2 * 86400),
              _world(seed=4, horizon=3 * 86400)]
    ref, batch = _pair(worlds)
    assert len({s.n_shards for s in batch.engines}) == 2
    assert batch.n_shards == ref.n_shards == max(s.n_shards
                                                 for s in batch.engines)
    want = ref.reject_rates(SERVER, POOL)
    assert batch.reject_rates(SERVER, POOL).tolist() == want.tolist()
    hopeless = np.array([30.0, 20.0])
    got = batch.reject_rates(hopeless, 0.0, reject_cap=0)
    assert got.tolist() == ref.reject_rates(hopeless, 0.0,
                                            reject_cap=0).tolist()
    assert (got < batch.reject_rates(hopeless, 0.0)).all()


def test_stream_batch_fixture_and_memory_bound():
    vms = jax_traces.load_trace_file(jax_traces.fixture_trace_path())
    kw = dict(n_servers=4, pool_sockets=4, gb_per_core=4.0)
    server = np.array([768.0, 120.0, 60.0, 30.0])
    pool = np.array([512.0, 64.0, 0.0, 512.0])
    worlds = []
    for frac in (0.15, 0.30):
        dec, _ = jax_cs.policy_decisions(vms, "static",
                                         static_pool_frac=frac,
                                         as_arrays=True)
        worlds.append((vms, dec, port_vms(vms), port_decisions(dec)))
    ref, batch = _pair(worlds, jax_cfg=jax_cs.ClusterConfig(**kw),
                       cfg=cs.ClusterConfig(**kw))
    want = ref.reject_rates(server, pool)
    for backend in BACKENDS:
        assert batch.reject_rates(server, pool, backend=backend).tolist() \
            == want.tolist(), backend
    # THE memory bound: one stacked shard batch of K rows, set by the
    # shard budget; the device feed holds two shards of at most that
    assert batch.shard_pad_events == ref.shard_pad_events <= 256
    assert batch.peak_shard_bytes == ref.peak_shard_bytes == \
        batch.k * 6 * 4 * batch.shard_pad_events
    feed = batch._feed()
    assert 2 * feed.host[0].numel() * 4 <= 2 * batch.peak_shard_bytes
    assert feed.host[0].shape[1] % 4 == 0
    assert np.isclose(batch.peak_pool_demand(),
                      ref.peak_pool_demand()).all()


def test_stream_batch_lockstep_search_equivalence():
    """search_min_multi / pool_search_multi on a streaming batch land on
    the reference's monolithic batch's exact results."""
    worlds = [_world(horizon=2 * 86400, frac=f) for f in (0.15, 0.30)]
    mono = jax_re.CompiledReplayBatch(
        [jax_re.CompiledReplay(v, d, JAX_CFG) for v, d, _, _ in worlds])
    _, sb = _pair(worlds)
    hi = CFG.cores_per_server * 12.0
    big_pool = hi * CFG.n_servers
    tol = mono.reject_rates(hi, big_pool)[:, 0] + 0.005
    cap = int(np.floor(tol * np.maximum(mono.n_vms, 1)).max())
    k = mono.k
    want_min = jax_re.search_min_multi(
        lambda g: mono.reject_rates(g, np.full_like(g, big_pool))
        <= tol[:, None], np.zeros(k), np.full(k, hi))
    got_min = re.search_min_multi(
        lambda g: sb.reject_rates(g, np.full_like(g, big_pool),
                                  reject_cap=cap)
        <= tol[:, None], np.zeros(k), np.full(k, hi))
    assert got_min.tolist() == want_min.tolist()
    grids = np.linspace(want_min, np.full(k, hi * 0.8), 3, axis=1)
    want_pool = jax_re.pool_search_multi(mono, grids, big_pool, tol)
    got_pool = re.pool_search_multi(sb, grids, big_pool, tol,
                                    reject_cap=cap)
    assert got_pool.tolist() == want_pool.tolist()


def test_savings_analysis_batched_streams_past_shard_budget():
    worlds = [_world(horizon=2 * 86400), _world(seed=4, horizon=2 * 86400)]
    kw = dict(static_pool_frac=0.25, max_events_per_shard=256)
    want = jax_cs.savings_analysis_batched([w[0] for w in worlds], JAX_CFG,
                                           "static", **kw)
    cache: dict = {}
    got = cs.savings_analysis_batched([w[2] for w in worlds], CFG, "static",
                                      device="cpu", cache=cache, **kw)
    assert isinstance(cache["local_batch"], re.CompiledReplayStreamBatch)
    assert [dataclasses.asdict(r) for r in got] == \
        [dataclasses.asdict(r) for r in want]
    # bit-exact probes: the monolithic batch's results
    mono = cs.savings_analysis_batched([w[2] for w in worlds], CFG,
                                       "static", device="cpu",
                                       static_pool_frac=0.25)
    assert [dataclasses.asdict(r) for r in got] == \
        [dataclasses.asdict(r) for r in mono]


def test_stream_batch_refuses_what_it_does_not_take():
    worlds = [_world(horizon=2 * 86400)]
    _, batch = _pair(worlds)
    # devices="all" on a CPU batch is the single-device path (M13)
    assert batch.reject_rates(SERVER, POOL, devices="all").tolist() == \
        batch.reject_rates(SERVER, POOL).tolist()
    with pytest.raises(ValueError, match="n_cand"):
        batch.reject_rates(np.zeros((2, 3)), np.zeros((2, 3)))
    with pytest.raises(ValueError, match="at most"):
        re.CompiledReplayStreamBatch(batch.engines * 257)
    with pytest.raises(ValueError, match=">= 1"):
        re.CompiledReplayStreamBatch([])


# ------------------------------------------------------------ the fleets --
def _topologies():
    """``tests/test_topology_engine.py``'s three families plus the orphan
    degenerate, at 8 servers."""
    return [jax_top.partitioned(8, 4), jax_top.overlapping(8, 4, 2),
            jax_top.sparse(8, 4, 2, seed=1),
            jax_top.sparse(8, 3, 2, seed=2, allow_orphans=True)]


def _lanes():
    """Its grid: (sgb, caps, reference topologies, port topologies)."""
    sgb, caps, lane_topos = [], [], []
    for server, total in ((200.0, 150.0), (200.0, 40.0), (140.0, 300.0),
                          (60.0, 6144.0)):
        for t in _topologies():
            sgb.append(server)
            caps.append(jax_top.split_pool(total, t.n_pods))
            lane_topos.append(t)
    return (np.asarray(sgb), caps, lane_topos,
            [port_topology(t) for t in lane_topos])


@pytest.mark.parametrize("backend", BACKENDS)
def test_stream_fleet_matches_monolithic(backend):
    """``tests/test_topology_engine.py::test_stream_fleet_matches_
    monolithic``: the fleet stream == the monolithic engine == the
    reference's stream; ``reject_cap`` is a lower-bound early exit."""
    vms, dec, pvms, pdec = _world(horizon=2 * 86400)
    sgb, caps, topos, ptopos = _lanes()
    stream = re.CompiledReplayStream(pvms, pdec, CFG, device="cpu",
                                     max_events_per_shard=256)
    assert stream.n_shards > 1
    want = jax_re.CompiledReplayStream(
        vms, dec, JAX_CFG, max_events_per_shard=256).reject_rates_fleet(
        sgb, caps, topos, backend="jax" if backend == "torch" else "numpy")
    mono = re.CompiledReplay(pvms, pdec, CFG, device="cpu") \
        .reject_rates_fleet(sgb, caps, ptopos, backend=backend)
    got = stream.reject_rates_fleet(sgb, caps, ptopos, backend=backend)
    assert got.tolist() == mono.tolist() == want.tolist()
    capped = stream.reject_rates_fleet(sgb, caps, ptopos, reject_cap=0,
                                       backend=backend)
    assert (capped <= got).all()


@pytest.mark.parametrize("backend", BACKENDS)
def test_batch_fleet_matches_engine_rows(backend):
    """The stream rows of ``tests/test_topology_engine.py::
    test_batch_fleet_matches_engine_rows``: a stream batch's fleet rows
    == each engine's == the reference's stream batch."""
    worlds = [_world(seed=s, horizon=2 * 86400) for s in (3, 4)]
    sgb, caps, topos, ptopos = _lanes()
    expect = np.stack([
        re.CompiledReplay(pv, pd, CFG, device="cpu").reject_rates_fleet(
            sgb, caps, ptopos, backend=backend) for _, _, pv, pd in worlds])
    ref, batch = _pair(worlds)
    got = batch.reject_rates_fleet(sgb, caps, ptopos, backend=backend)
    want = ref.reject_rates_fleet(sgb, caps, topos, backend="jax"
                                  if backend == "torch" else "numpy")
    assert got.shape == expect.shape
    assert got.tolist() == expect.tolist() == want.tolist()
    capped = batch.reject_rates_fleet(sgb, caps, ptopos, reject_cap=0,
                                      backend=backend)
    assert (capped <= got).all()


# ----------------------------------------------------------- checkpoints --
CKPT_KW = dict(n_servers=8, pool_sockets=8, gb_per_core=4.0)
CKPT_SERVER = np.array([768.0, 200.0, 140.0, 96.0])
CKPT_POOL = np.array([512.0, 300.0, 100.0, 64.0])


def _ckpt_stream(seed=3):
    """``tests/test_checkpoint_stream.py::_stream``: 2 days, 4 GB a core,
    static 0.25, 256 events a shard."""
    _, _, pvms, pdec = _world(seed=seed, horizon=2 * 86400,
                              cfg=jax_cs.ClusterConfig(**CKPT_KW))
    return re.CompiledReplayStream(pvms, pdec, cs.ClusterConfig(**CKPT_KW),
                                   device="cpu", max_events_per_shard=256)


@pytest.mark.chaos
@pytest.mark.parametrize("backend,state_dtype", [
    ("torch", "int32"), ("torch", "int16"), ("numpy", None)])
def test_kill_at_shard_k_resume_bit_exact(tmp_path, backend, state_dtype):
    stream = _ckpt_stream()
    assert stream.n_shards >= 3
    baseline = stream.reject_rates(CKPT_SERVER, CKPT_POOL, backend=backend,
                                   state_dtype=state_dtype)
    path = str(tmp_path / "sweep.ckpt.npz")
    kill = re.CheckpointSpec(path, every_shards=1, kill_after_shards=2)
    with pytest.raises(re.SweepInterrupted) as ei:
        stream.reject_rates(CKPT_SERVER, CKPT_POOL, backend=backend,
                            state_dtype=state_dtype, checkpoint=kill)
    assert ei.value.shards_done == 2
    assert (tmp_path / "sweep.ckpt.npz").exists()
    resume = re.CheckpointSpec(path, every_shards=4, resume=True)
    rates = stream.reject_rates(CKPT_SERVER, CKPT_POOL, backend=backend,
                                state_dtype=state_dtype, checkpoint=resume)
    assert rates.tolist() == baseline.tolist()
    assert not (tmp_path / "sweep.ckpt.npz").exists()   # completed


@pytest.mark.chaos
def test_kill_resume_with_more_lanes_than_a_reference_chunk(tmp_path):
    """The reference's ``test_kill_resume_mid_candidate_chunks``: past 96
    candidates the reference sweeps two chunks; the port prices all of
    them in one launch a shard, so a kill deep into the stream resumes
    from one cursor, bit-exact."""
    stream = _ckpt_stream()
    n_cand = 96 + 4
    server = np.linspace(120.0, 760.0, n_cand)
    pool = np.full(n_cand, 300.0)
    baseline = stream.reject_rates(server, pool)
    path = str(tmp_path / "lanes.ckpt.npz")
    with pytest.raises(re.SweepInterrupted):
        stream.reject_rates(server, pool, skip_windows=False,
                            checkpoint=re.CheckpointSpec(
                                path, every_shards=1,
                                kill_after_shards=stream.n_shards - 1))
    rates = stream.reject_rates(server, pool, skip_windows=False,
                                checkpoint=re.CheckpointSpec(path,
                                                             resume=True))
    assert rates.tolist() == baseline.tolist()


@pytest.mark.chaos
@pytest.mark.parametrize("backend", BACKENDS)
def test_batch_kill_resume_bit_exact(tmp_path, backend):
    batch = re.CompiledReplayStreamBatch([_ckpt_stream(s) for s in (3, 4)])
    baseline = batch.reject_rates(CKPT_SERVER, CKPT_POOL, backend=backend)
    path = str(tmp_path / "batch.ckpt.npz")
    with pytest.raises(re.SweepInterrupted):
        batch.reject_rates(CKPT_SERVER, CKPT_POOL, backend=backend,
                           checkpoint=re.CheckpointSpec(
                               path, every_shards=1, kill_after_shards=2))
    rates = batch.reject_rates(CKPT_SERVER, CKPT_POOL, backend=backend,
                               checkpoint=re.CheckpointSpec(path,
                                                            resume=True))
    assert rates.tolist() == baseline.tolist()


def test_fingerprint_mismatch_refuses_resume(tmp_path):
    stream = _ckpt_stream()
    path = str(tmp_path / "fp.ckpt.npz")
    with pytest.raises(re.SweepInterrupted):
        stream.reject_rates(CKPT_SERVER, CKPT_POOL, checkpoint=re.
                            CheckpointSpec(path, every_shards=1,
                                           kill_after_shards=1))
    with pytest.raises(ValueError, match="different sweep"):
        stream.reject_rates(CKPT_SERVER[:2], CKPT_POOL[:2],  # others
                            checkpoint=re.CheckpointSpec(path, resume=True))
    with pytest.raises(ValueError, match="different sweep"):
        stream.reject_rates(CKPT_SERVER, CKPT_POOL, backend="numpy",
                            checkpoint=re.CheckpointSpec(path, resume=True))


def test_checkpoint_without_resume_is_plain_sweep(tmp_path):
    stream = _ckpt_stream()
    baseline = stream.reject_rates(CKPT_SERVER, CKPT_POOL)
    path = str(tmp_path / "plain.ckpt.npz")
    rates = stream.reject_rates(
        CKPT_SERVER, CKPT_POOL,
        checkpoint=re.CheckpointSpec(path, every_shards=2))
    assert rates.tolist() == baseline.tolist()
    assert not (tmp_path / "plain.ckpt.npz").exists()


def test_invariant_guard_clean_on_healthy_sweep(monkeypatch):
    """POND_DEBUG_INVARIANTS=1 verifies the state and the event arrays
    after every shard without changing results, both backends and the
    batch."""
    stream = _ckpt_stream()
    batch = re.CompiledReplayStreamBatch([stream, _ckpt_stream(4)])
    plain = stream.reject_rates(CKPT_SERVER, CKPT_POOL)
    plain_batch = batch.reject_rates(CKPT_SERVER, CKPT_POOL)
    monkeypatch.setenv("POND_DEBUG_INVARIANTS", "1")
    assert sweep_core.invariants_enabled()
    dev = stream.reject_rates(CKPT_SERVER, CKPT_POOL)
    host = stream.reject_rates(CKPT_SERVER, CKPT_POOL, backend="numpy")
    got_batch = batch.reject_rates(CKPT_SERVER, CKPT_POOL)
    monkeypatch.delenv("POND_DEBUG_INVARIANTS")
    assert dev.tolist() == host.tolist() == plain.tolist()
    assert got_batch.tolist() == plain_batch.tolist()


def test_invariant_guard_catches_corrupt_events_and_state():
    stream = _ckpt_stream()
    stream._shards[0]["kind"][3] = 99
    with pytest.raises(sweep_core.SweepInvariantError,
                       match="kind out of range") as ei:
        stream._debug_check_events()
    assert ei.value.shard == 0 and ei.value.lane == 3
    fc = np.full((2, 3, 8), 32.0)
    fc[1, 2, 5] = -1.0
    with pytest.raises(sweep_core.SweepInvariantError,
                       match="free cores") as ei:
        sweep_core.check_invariants(fc, np.zeros_like(fc),
                                    np.zeros((2, 3, 1)), n_servers=8,
                                    cores_per_server=32.0, shard=4)
    assert (ei.value.shard, ei.value.trace, ei.value.lane) == (4, 1, 2)
