"""``devices=`` on the port's Pond engines, mirroring
``tests/test_device_shard.py``: ``resolve_devices``' semantics,
``lane_shard_count`` and the launch plans, then every engine family
(``CompiledReplay``, ``CompiledReplayBatch``, ``CompiledReplayStream``,
``CompiledReplayStreamBatch``; ``reject_rates`` and
``reject_rates_fleet``) split over 2-8 repeated CPU devices — the
reference's forced host devices — with even and uneven ``K % n``, both
state types: ``==`` the single-device path and the reference.  The
divergence-window cases of the reference's file run here too.  The split
over two or more cards is ``tests/test_torch_device_shard_cards.py``.
Inputs come from numpy seeds; the sweeps run their plain versions (CPU
tensors)."""
import numpy as np
import pytest
import torch

from repro.core import cluster_sim as jax_cs
from repro.core import replay_engine as jax_re
from repro.core import topology as jax_top
from repro.core import traces as jax_traces
from repro_torch.core import cluster_sim as cs
from repro_torch.core import obs
from repro_torch.core import replay_engine as re
from repro_torch.core import sweep_core
from repro_torch.core import topology
from repro_torch.core.sweep_core import (lane_plan, lane_shard_count,
                                         resolve_devices, row_plan)
from tests._torch_port_util import port_decisions, port_vms

KW = dict(n_servers=8, cores_per_server=16, pool_sockets=8,
          gb_per_core=4.75)
JAX_CFG = jax_cs.ClusterConfig(**KW)
CFG = cs.ClusterConfig(**KW)
SGB = np.linspace(120.0, 400.0, 5)
PGB = np.linspace(0.0, 900.0, 5)
CPU = torch.device("cpu")
_TRACES: dict = {}


def _trace(seed, n=300, horizon=2 * 86400):
    """(reference vms, reference decisions, port vms, port decisions)."""
    key = (seed, n, horizon)
    if key not in _TRACES:
        vms = jax_traces.Population(seed=0).sample_vms(
            n, horizon, seed=seed, start_id=10 ** 6)
        dec, _ = jax_cs.policy_decisions(vms, "static",
                                         static_pool_frac=0.3,
                                         as_arrays=True)
        _TRACES[key] = (vms, dec, port_vms(vms), port_decisions(dec))
    return _TRACES[key]


def _engine(seed, n=250):
    _, _, pv, pd = _trace(seed, n)
    return re.CompiledReplay(pv, pd, CFG, device="cpu")


def _stream(seed, n=250, budget=256):
    _, _, pv, pd = _trace(seed, n)
    return re.CompiledReplayStream(pv, pd, CFG, device="cpu",
                                   max_events_per_shard=budget)


def _cpus(n):
    return [CPU] * n


def _pods():
    topo = topology.partitioned(CFG.n_servers, 4)
    return topo, [topology.split_pool(p, 2)
                  for p in np.linspace(0.0, 600.0, 5)]


# ---------------------------------------------------------- resolution --
def test_resolve_devices_semantics():
    assert resolve_devices(None) is None
    assert resolve_devices(1, CPU) is None          # < 2 degrades
    assert resolve_devices("all", CPU) is None      # one CPU
    assert resolve_devices(3, CPU) is None
    assert resolve_devices(_cpus(4)) == _cpus(4)    # repeats count
    assert resolve_devices(["cpu", "cpu"]) == _cpus(2)
    assert resolve_devices(_cpus(1)) is None
    with pytest.raises(ValueError):
        resolve_devices("some", CPU)
    if not torch.cuda.is_available():
        # "all" names the cards: no silent CPU run without a CPU engine
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_devices("all")


def test_lane_shard_count_divides_width():
    assert lane_shard_count(16, 8) == 8
    assert lane_shard_count(16, 5) == 4
    assert lane_shard_count(96, 7) == 6
    assert lane_shard_count(2, 8) == 2
    for w in (2, 4, 16, 32, 96):
        for n in range(1, 9):
            assert w % lane_shard_count(w, n) == 0


def test_launch_plans_cover_every_lane_and_row_once():
    for width in (1, 2, 5, 6, 16, 96):
        for n in range(1, 9):
            plan = lane_plan(width, _cpus(n))
            k = lane_shard_count(width, n)
            if k < 2:
                assert plan is None
                continue
            assert [hi - lo for _, lo, hi in plan] == [width // k] * k
            assert plan[0][1] == 0 and plan[-1][2] == width
            assert all(a[2] == b[1] for a, b in zip(plan, plan[1:]))
    for k in range(1, 10):
        for n in range(1, 9):
            plan = row_plan(k, _cpus(n))
            if plan is None:
                assert min(k, n) < 2
                continue
            rows = [r for _, lo, hi in plan for r in range(lo, hi)]
            assert rows == list(range(k))
            assert len(plan) <= n
    assert lane_plan(16, None) is None and row_plan(4, None) is None


def test_launchers_are_keyed_by_device():
    base = sweep_core.get_sweep("int32")
    assert sweep_core.get_sweep("int32") is base
    on_cpu = sweep_core.get_sweep("int32", device=CPU)
    assert on_cpu is not base
    assert sweep_core.get_sweep("int32", device=CPU) is on_cpu
    assert ("int32", False, False, "cpu") in sweep_core.jit_cache_keys()
    assert sweep_core.get_pod_sweep("int16", device=CPU) is not \
        sweep_core.get_pod_sweep("int16")
    rec = obs.Recorder()
    with obs.use_recorder(rec):
        sweep_core.get_sweep("int16", batched=True, device=CPU)
    assert any(k.startswith("jit.sweep.int16.carry0.batched1.cpu.")
               for k in rec.metrics())
    with pytest.raises(ValueError):
        sweep_core.get_sweep("int8", device=CPU)


# ----------------------------------------------------- engine families --
@pytest.mark.parametrize("n_dev", [2, 3, 5, 8])
@pytest.mark.parametrize("state_dtype", ["int16", "int32"])
def test_single_trace_lane_split(n_dev, state_dtype):
    """``CompiledReplay``: the candidate lanes split over the devices (5
    lanes: one piece a lane wherever 5 devices fit, else single)."""
    vms, dec, _, _ = _trace(40, 250)
    want = jax_re.CompiledReplay(vms, dec, JAX_CFG).reject_rates(SGB, PGB)
    eng = _engine(40)
    base = eng.reject_rates(SGB, PGB, state_dtype=state_dtype)
    got = eng.reject_rates(SGB, PGB, state_dtype=state_dtype,
                           devices=_cpus(n_dev))
    assert got.tolist() == base.tolist() == want.tolist()
    wide_s, wide_p = np.repeat(SGB, 4), np.tile(PGB, 4)   # 20 lanes
    assert eng.reject_rates(wide_s, wide_p, state_dtype=state_dtype,
                            devices=_cpus(n_dev)).tolist() == \
        eng.reject_rates(wide_s, wide_p, state_dtype=state_dtype).tolist()
    assert eng.reject_rates(SGB, PGB, devices="all").tolist() == \
        base.tolist()


@pytest.mark.parametrize("n_dev", [2, 3, 8])
@pytest.mark.parametrize("state_dtype", ["int16", "int32"])
def test_batch_trace_and_lane_split(n_dev, state_dtype):
    """``CompiledReplayBatch``: K = 3 traces split by rows on 2 and 3
    devices (uneven and even ``K % n``), by lanes on 8."""
    worlds = [_trace(40 + i, 250) for i in range(3)]
    want = jax_re.CompiledReplayBatch([
        jax_re.CompiledReplay(v, d, JAX_CFG) for v, d, _, _ in worlds
    ]).reject_rates(SGB, PGB)
    batch = re.CompiledReplayBatch([_engine(40 + i) for i in range(3)])
    base = batch.reject_rates(SGB, PGB, state_dtype=state_dtype)
    kind = batch._split(_cpus(n_dev), len(SGB))[0]
    assert kind == ("rows" if n_dev <= 3 else "lanes")
    got = batch.reject_rates(SGB, PGB, state_dtype=state_dtype,
                             devices=_cpus(n_dev))
    assert got.tolist() == base.tolist() == want.tolist()
    per_trace = np.stack([SGB + 7.0 * i for i in range(3)])
    assert batch.reject_rates(per_trace, np.broadcast_to(PGB, (3, 5)),
                              devices=_cpus(n_dev)).tolist() == \
        batch.reject_rates(per_trace, np.broadcast_to(PGB, (3, 5))).tolist()


@pytest.mark.parametrize("n_dev", [2, 4])
def test_batch_fleet_split(n_dev):
    worlds = [_trace(40 + i, 250) for i in range(3)]
    topo, pods = _pods()
    jtopo = jax_top.partitioned(JAX_CFG.n_servers, 4)
    want = jax_re.CompiledReplayBatch([
        jax_re.CompiledReplay(v, d, JAX_CFG) for v, d, _, _ in worlds
    ]).reject_rates_fleet(SGB, pods, jtopo)
    batch = re.CompiledReplayBatch([_engine(40 + i) for i in range(3)])
    base = batch.reject_rates_fleet(SGB, pods, topo)
    got = batch.reject_rates_fleet(SGB, pods, topo, devices=_cpus(n_dev))
    assert got.tolist() == base.tolist() == want.tolist()
    eng = batch.engines[0]
    assert eng.reject_rates_fleet(SGB, pods, topo,
                                  devices=_cpus(n_dev)).tolist() == \
        eng.reject_rates_fleet(SGB, pods, topo).tolist() == want[0].tolist()


def test_fleet_split_keeps_the_grid_extents():
    """Lanes of 1 and of 2 pods split apart: each piece keeps the whole
    grid's pod columns."""
    eng = _engine(41)
    topos = [topology.single_pool(CFG.n_servers)] * 2 + \
        [topology.partitioned(CFG.n_servers, 4)] * 2
    caps = [[600.0], [120.0], [150.0] * 2, [30.0] * 2]
    sgb = [300.0, 200.0, 300.0, 200.0]
    base = eng.reject_rates_fleet(sgb, caps, topos)
    for n in (2, 4):
        assert eng.reject_rates_fleet(sgb, caps, topos,
                                      devices=_cpus(n)).tolist() == \
            base.tolist()


@pytest.mark.parametrize("n_dev", [2, 5])
@pytest.mark.parametrize("state_dtype", ["int16", "int32"])
def test_stream_lane_split(n_dev, state_dtype):
    """``CompiledReplayStream``: each piece streams every shard with its
    own state."""
    vms, dec, _, _ = _trace(20, 250)
    want = jax_re.CompiledReplayStream(
        vms, dec, JAX_CFG, max_events_per_shard=256).reject_rates(
            SGB, PGB, skip_windows=False)
    s = _stream(20)
    assert s.n_shards > 1
    for skip in (False, True):
        base = s.reject_rates(SGB, PGB, skip_windows=skip,
                              state_dtype=state_dtype)
        got = s.reject_rates(SGB, PGB, skip_windows=skip,
                             state_dtype=state_dtype, devices=_cpus(n_dev))
        assert got.tolist() == base.tolist() == want.tolist()
    topo, pods = _pods()
    assert s.reject_rates_fleet(SGB, pods, topo,
                                devices=_cpus(n_dev)).tolist() == \
        s.reject_rates_fleet(SGB, pods, topo).tolist()


@pytest.mark.parametrize("n_dev", [2, 3, 8])
@pytest.mark.parametrize("state_dtype", ["int16", "int32"])
def test_stream_batch_split(n_dev, state_dtype):
    """``CompiledReplayStreamBatch``: rows on 2 and 3 devices (K = 3:
    uneven and even), lanes on 8; ``==`` the single-device sweep and the
    reference's stream batch."""
    worlds = [_trace(20 + i, 250) for i in range(3)]
    want = jax_re.CompiledReplayStreamBatch([
        jax_re.CompiledReplayStream(v, d, JAX_CFG, max_events_per_shard=256)
        for v, d, _, _ in worlds]).reject_rates(SGB, PGB,
                                                skip_windows=False)
    sb = re.CompiledReplayStreamBatch([_stream(20 + i) for i in range(3)])
    for skip in (False, True):
        base = sb.reject_rates(SGB, PGB, skip_windows=skip,
                               state_dtype=state_dtype)
        got = sb.reject_rates(SGB, PGB, skip_windows=skip,
                              state_dtype=state_dtype, devices=_cpus(n_dev))
        assert got.tolist() == base.tolist() == want.tolist()
    topo, pods = _pods()
    assert sb.reject_rates_fleet(SGB, pods, topo,
                                 devices=_cpus(n_dev)).tolist() == \
        sb.reject_rates_fleet(SGB, pods, topo).tolist()


def test_stream_split_pieces_take_turns_a_shard_at_a_time():
    """A split stream's pieces take turns: every piece sweeps shard i
    before any piece sweeps shard i + 1 (the shard spans' order), for the
    single stream and its fleet (5 lanes on 5 devices), the stream batch
    (3 rows on 3) and its fleet."""
    s = _stream(20)
    sb = re.CompiledReplayStreamBatch([_stream(20 + i) for i in range(3)])
    topo, pods = _pods()
    calls = [("stream.shard", 5, lambda: s.reject_rates(
                 SGB, PGB, skip_windows=False, devices=_cpus(5))),
             ("stream.fleet.shard", 5, lambda: s.reject_rates_fleet(
                 SGB, pods, topo, devices=_cpus(5))),
             ("stream_batch.shard", 3, lambda: sb.reject_rates(
                 SGB, PGB, skip_windows=False, devices=_cpus(3))),
             ("stream_batch.fleet.shard", 5, lambda: sb.reject_rates_fleet(
                 SGB, pods, topo, devices=_cpus(5)))]
    assert s.n_shards > 1
    for name, n_pieces, call in calls:
        with obs.use_recorder(obs.Recorder()) as rec:
            call()
        order = [sp["args"]["shard"] for sp in rec.spans()
                 if sp["name"] == name]
        assert order == [si for si in range(s.n_shards)
                         for _ in range(n_pieces)], name


def test_stream_split_checkpoints_a_file_a_piece(tmp_path):
    """A split stream sweep killed mid-way resumes each piece from its own
    file and ends ``==`` the uninterrupted sweep."""
    sb = re.CompiledReplayStreamBatch([_stream(20 + i) for i in range(3)])
    want = sb.reject_rates(SGB, PGB, skip_windows=False)
    spec = re.CheckpointSpec(path=str(tmp_path / "ck.npz"), every_shards=1,
                             kill_after_shards=2)
    with pytest.raises(re.SweepInterrupted):
        sb.reject_rates(SGB, PGB, skip_windows=False, checkpoint=spec,
                        devices=_cpus(2))
    assert (tmp_path / "ck.npz.d0").exists()
    resume = re.CheckpointSpec(path=str(tmp_path / "ck.npz"), resume=True)
    assert sb.reject_rates(SGB, PGB, skip_windows=False, checkpoint=resume,
                           devices=_cpus(2)).tolist() == want.tolist()


def test_stream_split_under_a_cap_keeps_feasibility():
    """Under ``reject_cap`` each piece stops once its own lanes pass it:
    every lane is exact below the cap and a lower bound past it."""
    s = _stream(21)
    exact = s.reject_rates(SGB, PGB, skip_windows=False)
    cap = 3
    got = s.reject_rates(SGB, PGB, skip_windows=False, reject_cap=cap,
                         devices=_cpus(5))
    n = s.n_vms
    for g, e in zip(got, exact):
        if e * n <= cap:
            assert g == e
        else:
            assert (cap + 1) / n <= g <= e


# ---------------------------------------------- divergence windows --
def test_stream_skip_windows_bit_exact_and_fires():
    vms, dec, pv, pd = _trace(7, n=600, horizon=3 * 86400)
    stream = re.CompiledReplayStream(pv, pd, CFG, device="cpu",
                                     max_events_per_shard=256)
    assert stream.n_shards > 1
    gen_s, gen_p = SGB, np.linspace(150.0, 900.0, 5)
    mono = re.CompiledReplay(pv, pd, CFG, device="cpu").reject_rates(
        gen_s, gen_p)
    rec = obs.Recorder()
    with obs.use_recorder(rec):
        skipped = stream.reject_rates(gen_s, gen_p)
    full = stream.reject_rates(gen_s, gen_p, skip_windows=False)
    ref = jax_re.CompiledReplay(vms, dec, JAX_CFG).reject_rates(gen_s, gen_p)
    assert skipped.tolist() == full.tolist() == mono.tolist() == ref.tolist()
    assert rec.metrics().get("stream.shards_skipped", 0) > 0
    assert rec.metrics().get("stream.events_skipped", 0) > 0
    assert skipped.tolist() == stream.reject_rates(
        gen_s, gen_p, devices=_cpus(5)).tolist()


@pytest.mark.parametrize("state_dtype", [None, "int16"])
def test_stream_skip_windows_tight_caps_and_int16(state_dtype):
    _, _, pv, pd = _trace(9, n=500)
    stream = re.CompiledReplayStream(pv, pd, CFG, device="cpu",
                                     max_events_per_shard=256)
    tight_s, tight_p = [130.0], [10.0]
    assert stream.reject_rates(tight_s, tight_p,
                               state_dtype=state_dtype).tolist() == \
        stream.reject_rates(tight_s, tight_p, skip_windows=False).tolist()
    assert stream.reject_rates(SGB, PGB, state_dtype=state_dtype).tolist() \
        == stream.reject_rates(SGB, PGB, skip_windows=False).tolist()


def test_stream_batch_skip_windows_bit_exact():
    streams = [_stream(20 + i) for i in range(3)]
    sb = re.CompiledReplayStreamBatch(streams)
    full = sb.reject_rates(SGB, PGB, skip_windows=False)
    skipped = sb.reject_rates(SGB, PGB)
    per = np.stack([s.reject_rates(SGB, PGB, skip_windows=False)
                    for s in streams])
    assert skipped.tolist() == full.tolist() == per.tolist()
