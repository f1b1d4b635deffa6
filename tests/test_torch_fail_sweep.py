"""K5's module: the plain failure sweep of the port against the reference's
scan (``sweep_core.build_fail_sweep`` under ``jax.jit``, run with its
engine's padded shapes, ROADMAP F7) on the same numpy inputs — the five
counters and the per-FAIL affected rows compared with ``==`` — over the
hand-built edges of ``kernels/fail_sweep/cases.py`` and seeded streams, in
both state types and both mitigations; its trace axis against single
sweeps and the reference's vmapped scan; and the wrapper's checks and the
launch plan.  The CUDA kernel itself is held to the plain version on the
card by ``chip_smoke.py``."""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.core import sweep_core as jax_sc
from repro_torch.core import sweep_core as sc
from repro_torch.kernels.event_sweep.ops import pack_traces
from repro_torch.kernels.fail_sweep import cases, ops
from repro_torch.kernels.fail_sweep import kernel as K
from repro_torch.kernels.fail_sweep.cases import FAIL_EVENT_KEYS

DTYPES = ("int16", "int32")
MITIGATIONS = ("remigrate", "kill")


@functools.cache
def _jax_sweep(state_dtype, mitigation, with_dist, batched=False):
    fn = jax_sc.build_fail_sweep(state_dtype, mitigation, with_dist)
    if batched:
        fn = jax.vmap(fn, in_axes=((0,) * 8, None) + (0,) * 11)
    return jax.jit(fn)


def _ref_inputs(events, n_slots, n_servers, spg, cores, sgb, pgb,
                state_dtype, e_pad=None):
    """The reference's sweep arguments as its engine pads them: lanes to a
    candidate bucket (the last lane replicated), servers and groups to
    multiples of 16, slots to 32, events to 256 (PAD, domain -1)."""
    n = len(sgb)
    np_dt = sc.state_np_dtype(state_dtype)
    width = jax_sc.bucket_width(n)
    s_pad = jax_sc.pad_up(n_servers, jax_sc.LANE_PAD)
    g_pad = jax_sc.pad_up(-(-n_servers // spg), jax_sc.LANE_PAD)
    slot_pad = jax_sc.pad_up(max(n_slots, 1), jax_sc.SLOT_PAD)
    e_pad = e_pad or jax_sc.pad_up(len(events["kind"]), jax_sc.EVENT_PAD)
    caps = jax_sc.lane_capacities(np.asarray(sgb, float),
                                  np.asarray(pgb, float), 0, n, width, np_dt)
    state = jax_sc.init_state(width, n_servers, cores, s_pad, g_pad,
                              slot_pad, np_dt)[:4]
    fstate = jax_sc.init_fail_state(slot_pad, g_pad)
    group_of = np.zeros(s_pad, np.int32)
    group_of[:n_servers] = np.arange(n_servers) // spg
    evs = []
    for k in FAIL_EVENT_KEYS:
        fill = jax_sc.PAD if k == "kind" else (-1 if k == "dmn" else 0)
        a = np.full(e_pad, fill, np.int32)
        a[:len(events[k])] = events[k]
        evs.append(a)
    return tuple(evs), group_of, state + fstate, caps


def _reference(events, n_slots, n_servers, spg, cores, sgb, pgb,
               state_dtype, mitigation, with_dist):
    """(counters (5, n), per-FAIL rows (n_fail, n) or None) of the
    reference's scan, cut back to the true lanes; more than 96 lanes in
    chunks of 96, as its engine chunks them (``candidate_chunks``)."""
    n = len(sgb)
    if n > jax_sc.JAX_CHUNK:
        parts = [_reference(events, n_slots, n_servers, spg, cores,
                            sgb[lo:lo + jax_sc.JAX_CHUNK],
                            pgb[lo:lo + jax_sc.JAX_CHUNK], state_dtype,
                            mitigation, with_dist)
                 for lo in range(0, n, jax_sc.JAX_CHUNK)]
        return (np.concatenate([c for c, _ in parts], 1),
                None if not with_dist
                else np.concatenate([d for _, d in parts], 1))
    evs, group_of, state, caps = _ref_inputs(
        events, n_slots, n_servers, spg, cores, sgb, pgb, state_dtype)
    res = _jax_sweep(state_dtype, mitigation, with_dist)(
        evs, group_of, *state, *caps)
    counters = np.stack([np.asarray(a)[:n] for a in res[:5]])
    if not with_dist:
        return counters, None
    fail_pos = np.flatnonzero(np.asarray(events["kind"]) == sc.FAIL)
    return counters, np.asarray(res[5])[fail_pos, :n]


def _port_state(n_slots, n_servers, spg, cores, sgb, pgb, state_dtype):
    np_dt = sc.state_np_dtype(state_dtype)
    n_groups = -(-n_servers // spg)
    st = sc.init_state(len(sgb), n_servers, cores, n_servers, n_groups,
                       max(n_slots, 1), np_dt)[:4]
    st += (sc.init_fail_state(len(sgb), n_groups),
           np.asarray(sgb).astype(np_dt), np.asarray(pgb).astype(np_dt))
    return [torch.from_numpy(a.copy()) for a in st]


def _port(events, n_slots, n_servers, spg, cores, sgb, pgb, state_dtype,
          mitigation, with_dist):
    """(counters, per-FAIL rows or None, final state) of the port's plain
    version through the wrapper, on CPU tensors."""
    state = _port_state(n_slots, n_servers, spg, cores, sgb, pgb,
                        state_dtype)
    group_of = torch.from_numpy((np.arange(n_servers) // spg)
                                .astype(np.int32))
    n_fail = int((np.asarray(events["kind"]) == sc.FAIL).sum())
    dist = (torch.zeros((n_fail, len(sgb)), dtype=torch.int32)
            if with_dist else None)
    out = ops.fail_sweep(*(torch.from_numpy(events[k])
                           for k in FAIL_EVENT_KEYS), group_of, *state,
                         mitigation=mitigation, dist=dist)
    return (out.numpy(), None if dist is None else dist.numpy(),
            [t.numpy() for t in state[:5]])


def _both(events, n_slots, shape, lanes, state_dtype, mitigation,
          with_dist=True):
    lanes = np.asarray(lanes)
    args = (events, n_slots, shape["n_servers"], shape["spg"],
            shape["cores"], lanes[:, 0], lanes[:, 1], state_dtype,
            mitigation, with_dist)
    want = _reference(*args)
    got = _port(*args)
    assert got[0].tolist() == want[0].tolist()
    if with_dist:
        assert got[1].tolist() == want[1].tolist()
        assert (got[1].sum(0) == got[0][1]).all()
    else:
        assert got[1] is None
    return got


@pytest.mark.parametrize("with_dist", [True, False])
@pytest.mark.parametrize("mitigation", MITIGATIONS)
@pytest.mark.parametrize("state_dtype", DTYPES)
def test_plain_sweep_matches_reference_on_edge_stream(state_dtype,
                                                      mitigation, with_dist):
    events, n_slots = cases.edge_stream()
    assert set(events["kind"].tolist()) == {sc.ARRIVE, sc.DEPART,
                                            sc.MIGRATE, sc.FAIL, sc.RECOVER}
    (rej, aff, kill, rem, lost), dist, state = _both(
        events, n_slots, cases.EDGE_SHAPE, cases.EDGE_LANES, state_dtype,
        mitigation, with_dist)
    if with_dist:
        # FAIL(0) at 120 s hits v0 and v4 in lanes 0 and 1 (v1 has no
        # pool, v2 was migrated, v3 left at the failure instant); FAIL(0)
        # at 1,500 s finds nothing pooled anywhere
        assert dist[0, :2].tolist() == [2, 2]
        assert (dist[2] == 0).all()
        # no pool: nothing is ever affected; nothing fits: all rejected
        assert dist[:, 5].sum() == 0 and rej[4] == 10
    if mitigation == "remigrate":
        # lane 0 fits exactly at the first FAIL (both remigrated), lane 1
        # misses by 1 GB on server 0 (v0 killed) and fits on server 1
        assert rem[0] >= 2 and rem[1] == rem[0] - 1
    else:
        assert (rem == 0).all() and (kill == aff).all()
        # v8's departure minute lies before the FAIL: its kill costs 0
        assert (lost >= 0).all()
    fc, um, up, slots, down = state
    # the last FAIL(0) leaves domain 0 down and its pool empty
    assert (down[:, 0] == 1).all() and (down[:, 1] == 0).all()
    assert (up[:, 0] == 0).all()


@pytest.mark.parametrize("mitigation", MITIGATIONS)
def test_int16_demand_sum_past_2_15_is_summed_in_int32(mitigation):
    events, n_slots = cases.demand_stream()
    (rej, aff, kill, rem, lost), dist, _ = _both(
        events, n_slots, cases.DEMAND_SHAPE, cases.DEMAND_LANES, "int16",
        mitigation)
    if mitigation == "remigrate":
        # 35,000 GB of affected pool on server 1 does not fit 30,000 GB
        assert dist[:, 0].tolist() == [2, 7]
        assert rem.tolist() == [2, 2] and kill.tolist() == [7, 7]
    else:
        assert dist[:, 0].tolist() == [2, 5] and kill.tolist() == [7, 7]


# (servers, servers a group, lanes): 4 and 8 servers (not a multiple of
# 32), 33 (two servers a thread), 1 lane, 300 lanes (many blocks)
SHAPES = [(4, 2, 5), (8, 4, 12), (33, 8, 9), (7, 4, 1), (64, 8, 300)]


@pytest.mark.parametrize("mitigation", MITIGATIONS)
@pytest.mark.parametrize("state_dtype", DTYPES)
@pytest.mark.parametrize("n_servers,spg,n_lanes", SHAPES)
def test_plain_sweep_matches_reference_on_random_streams(
        n_servers, spg, n_lanes, state_dtype, mitigation):
    rng = np.random.default_rng(n_servers * 1000 + n_lanes)
    n_groups = -(-n_servers // spg)
    events, n_slots = cases.random_fail_stream(rng, 160, n_groups)
    assert (events["kind"] == sc.FAIL).sum() >= 2
    sgb, pgb = cases.lane_capacities(rng, n_lanes, n_servers, 64)
    lanes = np.stack([sgb, pgb], 1)
    shape = dict(n_servers=n_servers, spg=spg, cores=64)
    counters, _, _ = _both(events, n_slots, shape, lanes, state_dtype,
                           mitigation, with_dist=n_lanes != 300)
    assert counters[1].sum() > 0            # the failures bite somewhere


def _trace_streams():
    """Three seeded streams whose schedules differ in length."""
    out = []
    for seed, n_vms, frac in ((1, 120, 0.1), (2, 90, 0.3), (3, 150, 0.05)):
        rng = np.random.default_rng(seed)
        out.append(cases.random_fail_stream(rng, n_vms, 2, mtbf_frac=frac))
    return out


@pytest.mark.parametrize("mitigation", MITIGATIONS)
@pytest.mark.parametrize("state_dtype", DTYPES)
def test_trace_axis_matches_single_sweeps_and_the_vmapped_reference(
        state_dtype, mitigation):
    streams = _trace_streams()
    fails = [int((ev["kind"] == sc.FAIL).sum()) for ev, _ in streams]
    assert len(set(fails)) == len(fails)     # schedules of other lengths
    n_servers, spg, n_cand = 8, 4, 5
    shape = dict(n_servers=n_servers, spg=spg, cores=64)
    rng = np.random.default_rng(9)
    sgb, pgb = cases.lane_capacities(rng, n_cand, n_servers, 64)
    n_slots = max(n for _, n in streams)
    cols, counts = pack_traces([tuple(ev[k] for k in FAIL_EVENT_KEYS)
                                for ev, _ in streams],
                               fills=(sc.PAD, 0, 0, 0, 0, 0, 0, -1))
    k = len(streams)
    state = _port_state(n_slots, n_servers, spg, 64, np.tile(sgb, k),
                        np.tile(pgb, k), state_dtype)
    group_of = torch.from_numpy((np.arange(n_servers) // spg)
                                .astype(np.int32))
    out = ops.fail_sweep(*cols, group_of, *state, mitigation=mitigation,
                         trace_events=counts).numpy().reshape(5, k, n_cand)
    singles = np.stack([_port(ev, n_slots, n_servers, spg, 64, sgb, pgb,
                              state_dtype, mitigation, False)[0]
                        for ev, _ in streams], 1)
    assert out.tolist() == singles.tolist()
    # the reference's batched build: vmapped over the traces, each
    # stream padded to one length, the payload records a trace
    e_pad = jax_sc.pad_up(max(len(ev["kind"]) for ev, _ in streams),
                          jax_sc.EVENT_PAD)
    per = [_ref_inputs(ev, n_slots, n_servers, spg, 64, sgb, pgb,
                       state_dtype, e_pad) for ev, _ in streams]
    evs = tuple(np.stack([p[0][j] for p in per]) for j in range(8))
    stacked = [np.stack([p[2][j] for p in per]) for j in range(9)]
    caps = [np.stack([p[3][j] for p in per]) for j in range(2)]
    res = _jax_sweep(state_dtype, mitigation, False, batched=True)(
        evs, per[0][1], *stacked, *caps)
    want = np.stack([np.asarray(a)[:, :n_cand] for a in res[:5]])
    assert out.tolist() == want.tolist()


def test_wrapper_checks_its_arguments():
    events, n_slots = cases.edge_stream()
    evs = [torch.from_numpy(events[k]) for k in FAIL_EVENT_KEYS]
    group_of = torch.tensor([0, 0, 1, 1], dtype=torch.int32)
    lanes = np.asarray(cases.EDGE_LANES)

    def state(dt="int32"):
        return _port_state(n_slots, 4, 2, 16, lanes[:, 0], lanes[:, 1], dt)

    with pytest.raises(ValueError, match="mitigation"):
        ops.fail_sweep(*evs, group_of, *state(), mitigation="nope")
    with pytest.raises(ValueError, match="differ in length"):
        ops.fail_sweep(*evs[:7], evs[7][:-1], group_of, *state(),
                       mitigation="kill")
    st = state()
    st[3][0, 0] = 1                            # a slot that is not empty
    with pytest.raises(ValueError, match="empty"):
        ops.fail_sweep(*evs, group_of, *st, mitigation="kill")
    st = state()
    st[4] = st[4][:, :1].contiguous()          # down flags of one group
    with pytest.raises(ValueError, match="shapes"):
        ops.fail_sweep(*evs, group_of, *st, mitigation="kill")
    st = state()
    st[4] = st[4].to(torch.int16)
    with pytest.raises(TypeError, match="int32"):
        ops.fail_sweep(*evs, group_of, *st, mitigation="kill")
    st = state("int16")
    st[0] = st[0].to(torch.int32)
    with pytest.raises(TypeError, match="state dtype"):
        ops.fail_sweep(*evs, group_of, *st, mitigation="kill")
    # per-failure rows take one trace
    cols, counts = pack_traces([tuple(events[k] for k in FAIL_EVENT_KEYS)]
                               * 7, fills=(sc.PAD,) + (0,) * 6 + (-1,))
    st = _port_state(n_slots, 4, 2, 16, np.tile(lanes[:, 0], 7),
                     np.tile(lanes[:, 1], 7), "int32")
    with pytest.raises(ValueError, match="one trace"):
        ops.fail_sweep(*cols, group_of, *st, mitigation="kill",
                       dist=torch.zeros((4, 49), dtype=torch.int32),
                       trace_events=counts)
    with pytest.raises(ValueError, match="fail_sweep: 49 lanes"):
        ops.fail_sweep(*cols, group_of, *st, mitigation="kill",
                       trace_events=counts[:6] + [counts[6], 0])


def test_reference_and_port_refuse_an_unknown_mitigation():
    with pytest.raises(ValueError, match="mitigation"):
        jax_sc.build_fail_sweep(mitigation="nope")
    events, n_slots = cases.edge_stream()
    lanes = np.asarray(cases.EDGE_LANES)
    with pytest.raises(ValueError, match="mitigation"):
        ops.fail_sweep(*(torch.from_numpy(events[k])
                         for k in FAIL_EVENT_KEYS),
                       torch.tensor([0, 0, 1, 1], dtype=torch.int32),
                       *_port_state(n_slots, 4, 2, 16, lanes[:, 0],
                                    lanes[:, 1], "int32"),
                       mitigation="nope")
    assert sc.MITIGATIONS == jax_sc.MITIGATIONS


def test_init_fail_state_is_all_up():
    down = sc.init_fail_state(3, 5)
    assert down.shape == (3, 5) and down.dtype == np.int32
    assert not down.any()
    # the reference's down flags start the same (its payload records are
    # the port's per-lane arrival column, which the wrapper allocates)
    assert not jax_sc.init_fail_state(8, 5)[4].any()


def test_kernel_plan_takes_the_full_config_and_refuses_past_512_servers():
    # the full-width configuration: 256 servers, 1,517 slots, 6 lanes
    for item in (2, 4):
        plan = K.plan(6, 256, 1517, item, 132)
        assert plan == K.Plan(8, 1, "shared")
        need = K.shared_bytes(256, 1517, item, plan.lanes_per_block)
        assert need <= K.MAX_SHARED
    # 4 traces x 6 lanes; 300 lanes of one trace: three a block
    assert K.plan(6, 256, 1517, 2, 132, n_traces=4).lanes_per_block == 1
    assert K.plan(300, 64, 90, 2, 132).lanes_per_block == 3
    assert K.plan(1, 4, 10, 4, 132) == K.Plan(1, 1, "shared")
    # a slot column past shared memory's limit stays in global memory
    assert K.choose_slot_column(256, 100_000, 4) == "global"
    assert K.plan(16, 256, 100_000, 4, 132).slot_column == "global"
    with pytest.raises(ValueError, match="ROADMAP"):
        K.plan(16, 513, 100, 2, 132)
    with pytest.raises(ValueError, match="slot_column"):
        K.plan(16, 256, 100, 2, 132, slot_column="nowhere")


def test_shared_bytes_match_the_sources_layout():
    """kernel.py's shared-memory sum is the one the .cu computes: stages,
    group_of, then a lane's slot column and three int32 arrays of S, each
    rounded to 16 bytes."""
    stages = 2 * 6 * 1024 * 4
    assert K.shared_bytes(4, 10, 2, 1) == stages + 16 + 32 + 48
    assert K.shared_bytes(4, 10, 2, 3, "global") == stages + 16 + 3 * 48
    assert K.shared_bytes(256, 1517, 4, 2) == (
        stages + 1024 + 2 * (6080 + 3072))


def test_ptxas_report_reads_each_instantiation():
    log = (
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117"
        "fail_sweep_kernelIsLi8ELb0ELb1EEEvNS_6EventsEPKiPT_S6_S6_S6_PiPKS5_"
        "S9_S7_S7_S7_iiiiiiiiiiiNS_6TracesE' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_117fail\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 96 registers, used 0 barriers\n")
    (entry,) = K.ptxas_report(log)
    assert entry["registers"] == 96 and entry["spill_store_bytes"] == 0
    assert entry["state_dtype"] == "int16"
    assert entry["servers_per_thread"] == 8
    assert not entry["batched"] and entry["slot_column"] == "global"


def test_cpu_tensors_never_reach_the_kernel():
    events, n_slots = cases.edge_stream()
    before = ops.launches
    _port(events, n_slots, 4, 2, 16, [16, 15], [32, 32], "int32", "kill",
          True)
    assert ops.launches == before
