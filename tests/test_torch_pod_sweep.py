"""K4's module: the plain pod sweep of the port against the reference's scan
(``sweep_core.build_pod_sweep(dt, with_carry=True)`` under ``jax.jit``, run
with its engine's padded shapes, ROADMAP F7) on the same numpy inputs, the
whole final state compared with ``==``: the hand-built edges of
``kernels/pod_sweep/cases.py`` (a double MIGRATE, fallback MIGRATEs paying
the first pod, orphan servers, a pod without members, negative used pool,
int16 state at its bounds, pod ids at the int16 bound; the kernel table's
edges: rows listing two pods in opposite order, a pod in two threads'
tables, a fallback MIGRATE whose first pod is not the table's first
entry) and seeded streams over mixed topologies and over threads of many
or one distinct pods, in both state types; its trace axis against T single
sweeps and the reference's vmapped scan; the host helpers against the
reference's; the wrapper's checks and the launch plan (the table build
from an incidence's widest thread), with the kernel source's bounds.  The
CUDA kernel itself is held to the plain version on the card by
``chip_smoke.py``."""
import functools
import importlib.util
import os
import re

import jax
import numpy as np
import pytest
import torch

from repro.core import sweep_core as jax_sc
from repro_torch.core import sweep_core as sc
from repro_torch.kernels.event_sweep.ops import pack_traces
from repro_torch.kernels.pod_sweep import cases, ops
from repro_torch.kernels.pod_sweep import kernel as K
from repro_torch.kernels.pod_sweep.cases import EVENT_KEYS

DTYPES = ("int16", "int32")
STATE = ("fc", "um", "up", "slots", "pods", "rejects")


@functools.cache
def _jax_sweep(state_dtype, batched=False):
    fn = jax_sc.build_pod_sweep(state_dtype, with_carry=True)
    if batched:
        fn = jax.vmap(fn, in_axes=((0,) * 6, None) + (0,) * 8)
    return jax.jit(fn)


def _ref_inputs(events, n_slots, n_servers, cores, sgb, pgb, inc,
                state_dtype, e_pad=None):
    """The reference's sweep arguments as its engine pads them: lanes to a
    candidate bucket (the last lane replicated, ``pod_lane_arrays``),
    servers and pods to multiples of 16 (padded servers reach no pod),
    slots to 32, events to 256 (PAD)."""
    n, n_pods = pgb.shape
    np_dt = sc.state_np_dtype(state_dtype)
    width = jax_sc.bucket_width(n)
    s_pad = jax_sc.pad_up(n_servers, jax_sc.LANE_PAD)
    p_pad = jax_sc.pad_up(n_pods, jax_sc.LANE_PAD)
    slot_pad = jax_sc.pad_up(max(n_slots, 1), jax_sc.SLOT_PAD)
    e_pad = e_pad or jax_sc.pad_up(len(events["kind"]), jax_sc.EVENT_PAD)
    inc_p = np.full((n, s_pad, inc.shape[2]), -1, np.int32)
    inc_p[:, :n_servers] = inc
    pgb_p = np.zeros((n, p_pad))
    pgb_p[:, :n_pods] = pgb
    sgb_w, pgb_w, inc_w = jax_sc.pod_lane_arrays(
        np.asarray(sgb, float), pgb_p, inc_p, 0, n, width, np_dt)
    state = jax_sc.init_pod_state(width, n_servers, cores, s_pad, p_pad,
                                  slot_pad, np_dt)
    evs = []
    for k in EVENT_KEYS:
        a = np.full(e_pad, jax_sc.PAD if k == "kind" else 0, np.int32)
        a[:len(events[k])] = events[k]
        evs.append(a)
    return tuple(evs), inc_w, state, (sgb_w, pgb_w)


def _cut(res, n, n_servers, n_pods, n_slots):
    fc, um, up, slots, pods, rej = (np.asarray(a) for a in res)
    return [fc[:n, :n_servers], um[:n, :n_servers], up[:n, :n_pods],
            slots[:n_slots, :n], pods[:n_slots, :n], rej[:n]]


def _reference(events, n_slots, n_servers, cores, sgb, pgb, inc,
               state_dtype):
    """The reference scan's final state cut back to the true extents; more
    than 96 lanes in chunks of 96, as its engine chunks them
    (``candidate_chunks``)."""
    n = len(sgb)
    if n > jax_sc.JAX_CHUNK:
        parts = [_reference(events, n_slots, n_servers, cores,
                            sgb[lo:lo + jax_sc.JAX_CHUNK],
                            pgb[lo:lo + jax_sc.JAX_CHUNK],
                            inc[lo:lo + jax_sc.JAX_CHUNK], state_dtype)
                 for lo in range(0, n, jax_sc.JAX_CHUNK)]
        return [np.concatenate([p[i] for p in parts],
                               1 if i in (3, 4) else 0) for i in range(6)]
    evs, inc_w, state, caps = _ref_inputs(events, n_slots, n_servers, cores,
                                          sgb, pgb, inc, state_dtype)
    res = _jax_sweep(state_dtype)(evs, inc_w, *state, *caps)
    return _cut(res, n, n_servers, pgb.shape[1], n_slots)


def _port_state(n_slots, n_servers, cores, sgb, pgb, state_dtype):
    np_dt = sc.state_np_dtype(state_dtype)
    st = sc.init_pod_state(len(sgb), n_servers, cores, n_servers,
                           pgb.shape[1], max(n_slots, 1), np_dt)[:5]
    st += (np.asarray(sgb).astype(np_dt), np.asarray(pgb).astype(np_dt))
    return [torch.from_numpy(a.copy()) for a in st]


def _port(events, n_slots, n_servers, cores, sgb, pgb, inc, state_dtype,
          **kw):
    """The port's plain version through the wrapper on CPU tensors: the
    final (fc, um, up, slots, pods, rejects)."""
    state = _port_state(n_slots, n_servers, cores, sgb, pgb, state_dtype)
    rej = ops.pod_sweep(*(torch.from_numpy(events[k]) for k in EVENT_KEYS),
                        torch.from_numpy(np.ascontiguousarray(inc)),
                        *state, **kw)
    return [t.numpy() for t in state[:5]] + [rej.numpy()]


def _assert_equal(got, want, ctx=""):
    for name, a, b in zip(STATE, got, want):
        assert a.tolist() == b.tolist(), (ctx, name)


def _both(events, n_slots, shape, lanes, state_dtype):
    sgb, pgb, inc = lanes
    args = (events, n_slots, shape["n_servers"], shape["cores"], sgb, pgb,
            inc, state_dtype)
    got = _port(*args)
    _assert_equal(got, _reference(*args), state_dtype)
    return got


@pytest.mark.parametrize("state_dtype", DTYPES)
def test_plain_sweep_matches_reference_on_edge_stream(state_dtype):
    events, n_slots = cases.edge_stream()
    kinds = set(events["kind"].tolist())
    assert kinds == {sc.ARRIVE, sc.DEPART, sc.MIGRATE, sc.PAD, sc.FAIL,
                     sc.RECOVER}
    fc, um, up, slots, pods, rej = _both(events, n_slots, cases.EDGE_SHAPE,
                                         cases.edge_lanes(), state_dtype)
    # every VM has left: the cores are back; the MIGRATE quirk's second
    # move and its moves of fallback VMs leave local memory behind
    assert (fc == cases.EDGE_SHAPE["cores"]).all() and um.max() > 0
    assert (slots == -1).all() and (pods == -1).all()
    # v0's second MIGRATE (ample lane), the fallback VMs' MIGRATEs (no
    # pool): the pool paid back twice leaves used pool negative
    assert up[0].min() < 0 and up[2].min() < 0
    # pods without members stay untouched; all orphans pay nothing
    assert (up[4, 1:] == 0).all() and (up[7] == 0).all()
    # v4 is larger than a server everywhere; nothing fits in lane 5
    assert rej.min() >= 1 and rej[5] == 8


def test_int16_state_at_its_bounds_matches_int32_and_reference():
    events, n_slots = cases.bounds_stream()
    sgb, pgb, inc = cases.bounds_lanes()
    pay_mem = int((events["local"] + events["pool"]).max())
    pay_pool = int(events["pool"].max())
    mig_sum = float(events["pool"][events["kind"] == sc.MIGRATE].sum())
    for mod in (sc, jax_sc):
        assert mod.pick_pod_state_dtype(
            64, 2, sgb.astype(float), pgb.astype(float), pay_mem, pay_pool,
            mig_sum, 2) == "int16"
    got16 = _both(events, n_slots, cases.BOUNDS_SHAPE,
                  (sgb, pgb, inc), "int16")
    got32 = _both(events, n_slots, cases.BOUNDS_SHAPE,
                  (sgb, pgb, inc), "int32")
    _assert_equal(got16, got32)
    assert got16[2].min() < 0                # fallback MIGRATEs paid back


def test_pod_ids_at_the_int16_bound():
    rng = np.random.default_rng(5)
    events, n_slots = cases.random_stream(rng, 80)
    # the first 60 events: VMs still placed hold their pods at the end
    events = {k: a[:60].copy() for k, a in events.items()}
    lanes = cases.pod_bound_lanes(rng, 3, 8, 64)
    assert lanes[2].max() == cases.POD_BOUND_PODS - 1
    shape = dict(n_servers=8, cores=64)
    got = _both(events, n_slots, shape, lanes, "int16")
    assert got[4].max() > sc.I16_BIG // 2    # a high pod id was recorded
    # pod ids at the sentinel and past it take int32
    for mod in (sc, jax_sc):
        args = (64, 8, np.zeros(1), np.zeros(1), 0, 0, 0)
        assert mod.pick_pod_state_dtype(*args, sc.I16_BIG - 1) == "int16"
        assert mod.pick_pod_state_dtype(*args, sc.I16_BIG) == "int32"


@pytest.mark.parametrize("state_dtype", DTYPES)
def test_plain_sweep_matches_reference_on_table_edges(state_dtype):
    events, n_slots = cases.table_stream()
    lanes = cases.table_lanes()
    _, _, up, _, _, rej = _both(events, n_slots, cases.TABLE_SHAPE, lanes,
                                state_dtype)
    assert rej.tolist() == [0] * 5
    # no pool: every MIGRATE pays its server's first pod, pod 1 (first on
    # servers 1 and 2) most; local memory too small: nobody pays
    assert up[2].max() <= 0 and up[2, 1] < up[2, 0] < 0
    assert (up[4] == 0).all()
    # the first five events are v0-v4's ARRIVEs: the grants
    head = {k: a[:5].copy() for k, a in events.items()}
    assert (head["kind"] == sc.ARRIVE).all()
    _, _, _, slots, pods, _ = _both(head, n_slots, cases.TABLE_SHAPE, lanes,
                                    state_dtype)
    grants = pods[head["slot"][:4]].T.tolist()
    assert (slots[head["slot"][:4], 0] >> 1).tolist() == [0, 1, 2, 3]
    # roomy: each server's first pod, 0 and 1 on the two opposite rows of
    # thread 0, 1 and 2 on thread 1's; pod 1 with room for one VM: v2
    # takes its second, pod 2; no pool: no grant; pod 0 empty: v0 its
    # second, pod 1
    assert grants[0] == [0, 1, 1, 2]
    assert grants[1] == [0, 1, 2, 2]
    assert grants[2] == [-1] * 4
    assert grants[3][0] == 1


# (servers, widest thread's distinct pods): at each K the catch-all 3 K
# and, at K 8 and 16, just past the 8-entry build
WIDE = [(8, 3), (33, 6), (100, 12), (256, 9), (256, 24), (500, 48)]


@pytest.mark.parametrize("state_dtype", DTYPES)
@pytest.mark.parametrize("n_servers,n_distinct", WIDE)
def test_plain_sweep_matches_reference_on_wide_threads(
        n_servers, n_distinct, state_dtype):
    rng = np.random.default_rng(n_servers + 3 * n_distinct)
    events, n_slots = cases.random_stream(rng, 90)
    lanes = cases.wide_lanes(rng, 4, n_servers, 64, n_distinct)
    k = K.servers_per_thread(n_servers)
    assert int(K.widest_distinct(torch.from_numpy(lanes[2]), k)) \
        == n_distinct
    assert K.distinct_build(n_distinct, k) == \
        min(d for d in (8, 3 * k) if d >= n_distinct)
    got = _both(events, n_slots, dict(n_servers=n_servers, cores=64), lanes,
                state_dtype)
    head = {k: a[:len(a) // 2].copy() for k, a in events.items()}
    part = _both(head, n_slots, dict(n_servers=n_servers, cores=64), lanes,
                 state_dtype)
    assert (part[4] >= 0).any() and got[5].sum() >= part[5].sum()


@pytest.mark.parametrize("n_servers", [8, 33, 100, 256, 500])
def test_plain_sweep_matches_reference_on_one_pod_a_thread(n_servers):
    rng = np.random.default_rng(n_servers)
    events, n_slots = cases.random_stream(rng, 90)
    lanes = cases.aligned_lanes(rng, 5, n_servers, 64)
    k = K.servers_per_thread(n_servers)
    assert int(K.widest_distinct(torch.from_numpy(lanes[2]), k)) == 1
    assert K.plan(5, n_servers, 1, n_slots, 2, 132,
                  distinct=1).distinct == 1
    _both(events, n_slots, dict(n_servers=n_servers, cores=64), lanes,
          "int16")


# (servers, lanes, widest fanout): fewer servers than a warp, 33 (two a
# thread), one lane, 300 lanes (many blocks), rows of 1 to 3 pods
SHAPES = [(4, 5, 2), (8, 12, 3), (33, 9, 3), (7, 1, 1), (64, 300, 3)]


@pytest.mark.parametrize("state_dtype", DTYPES)
@pytest.mark.parametrize("n_servers,n_lanes,fanout", SHAPES)
def test_plain_sweep_matches_reference_on_random_streams(
        n_servers, n_lanes, fanout, state_dtype):
    rng = np.random.default_rng(n_servers * 1000 + n_lanes)
    events, n_slots = cases.random_stream(rng, 160)
    lanes = cases.random_lanes(rng, n_lanes, n_servers, 64, fanout)
    got = _both(events, n_slots, dict(n_servers=n_servers, cores=64), lanes,
                state_dtype)
    assert got[5].max() > got[5].min() or n_lanes == 1


def test_a_sweep_cut_in_two_carries_its_state():
    """The final state is written in place, so two sweeps over the halves
    of a stream are the sweep over the whole."""
    rng = np.random.default_rng(11)
    events, n_slots = cases.random_stream(rng, 120)
    sgb, pgb, inc = cases.random_lanes(rng, 6, 8, 64)
    whole = _port(events, n_slots, 8, 64, sgb, pgb, inc, "int32")
    state = _port_state(n_slots, 8, 64, sgb, pgb, "int32")
    rej = torch.zeros(6, dtype=torch.int32)
    half = len(events["kind"]) // 2
    for part in (slice(0, half), slice(half, None)):
        ops.pod_sweep(*(torch.from_numpy(events[k][part].copy())
                        for k in EVENT_KEYS), torch.from_numpy(inc), *state,
                      rej)
    _assert_equal([t.numpy() for t in state[:5]] + [rej.numpy()], whole)


def _reference_batched(streams, n_slots, n_servers, cores, sgb, pgb, inc,
                       state_dtype):
    """The reference's vmapped scan over the traces (each stream padded to
    one length, a carry a trace), cut back a trace."""
    e_pad = jax_sc.pad_up(max(len(ev["kind"]) for ev in streams),
                          jax_sc.EVENT_PAD)
    per = [_ref_inputs(ev, n_slots, n_servers, cores, sgb[i], pgb[i], inc,
                       state_dtype, e_pad) for i, ev in enumerate(streams)]
    evs = tuple(np.stack([p[0][j] for p in per]) for j in range(6))
    state = [np.stack([p[2][j] for p in per]) for j in range(6)]
    caps = [np.stack([p[3][j] for p in per]) for j in range(2)]
    res = _jax_sweep(state_dtype, batched=True)(evs, per[0][1], *state,
                                                *caps)
    return [_cut([np.asarray(a)[t] for a in res], len(sgb[t]), n_servers,
                 pgb.shape[2], n_slots) for t in range(len(streams))]


@pytest.mark.parametrize("state_dtype", DTYPES)
@pytest.mark.parametrize("n_traces,n_cand,n_servers",
                         [(1, 5, 7), (2, 3, 33), (3, 9, 8)])
def test_trace_axis_matches_single_sweeps_and_the_vmapped_reference(
        n_traces, n_cand, n_servers, state_dtype):
    """T traces of unequal lengths over one shared lane grid (the incidence
    a copy a trace): each trace's lanes == a single sweep of that trace and
    == the reference's vmapped scan, whole final state."""
    rng = np.random.default_rng(60 + 7 * n_traces + n_cand)
    streams, slot_counts = zip(*(cases.random_stream(rng, 90 + 41 * i)
                                 for i in range(n_traces)))
    n_slots = max(slot_counts)
    sgb, pgb, inc = cases.random_lanes(rng, n_cand, n_servers, 64)
    sgb_t = np.stack([sgb, rng.permutation(sgb), sgb[::-1]])[:n_traces]
    pgb_t = np.stack([pgb, pgb[::-1], pgb])[:n_traces]
    cols, counts = pack_traces([tuple(ev[k] for k in EVENT_KEYS)
                                for ev in streams])
    state = _port_state(n_slots, n_servers, 64, sgb_t.reshape(-1),
                        pgb_t.reshape(-1, pgb.shape[1]), state_dtype)
    ops.launches = 0
    rej = ops.pod_sweep(*cols, torch.from_numpy(np.tile(inc, (n_traces, 1,
                                                               1))),
                        *state, trace_events=counts)
    assert ops.launches == 0                 # the plain version ran
    got = [t.numpy() for t in state[:5]] + [rej.numpy()]
    want = _reference_batched(streams, n_slots, n_servers, 64, sgb_t, pgb_t,
                              inc, state_dtype)
    for t, ev in enumerate(streams):
        lanes = slice(t * n_cand, (t + 1) * n_cand)
        mine = [a[lanes] for a in got[:3]] + [a[:, lanes] for a in got[3:5]] \
            + [got[5][lanes]]
        single = _port(ev, n_slots, n_servers, 64, sgb_t[t], pgb_t[t], inc,
                       state_dtype)
        _assert_equal(mine, single, ("single", t))
        _assert_equal(mine, want[t], ("reference", t))


def test_host_helpers_match_the_reference():
    for width, s, p, n_slots in ((3, 8, 5, 7), (1, 256, 64, 1517)):
        for dt in DTYPES:
            np_dt = sc.state_np_dtype(dt)
            got = sc.init_pod_state(width, s, 64, s, p, n_slots, np_dt)
            want = jax_sc.init_pod_state(width, s, 64, s, p, n_slots, np_dt)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and a.tolist() == b.tolist()
    rng = np.random.default_rng(2)
    for _ in range(40):
        args = (64.0, int(rng.integers(1, 600)),
                rng.integers(0, 31000, 4).astype(float),
                rng.integers(0, 31000, (4, 3)).astype(float),
                float(rng.integers(0, 3000)), float(rng.integers(0, 3000)),
                float(rng.integers(0, 30000)), int(rng.integers(1, 20000)))
        assert sc.pick_pod_state_dtype(*args) == \
            jax_sc.pick_pod_state_dtype(*args)


def test_get_pod_sweep_is_k4_and_refuses_the_unported_keys():
    rng = np.random.default_rng(8)
    events, n_slots = cases.random_stream(rng, 60)
    sgb, pgb, inc = cases.random_lanes(rng, 4, 8, 64)
    state = _port_state(n_slots, 8, 64, sgb, pgb, "int16")
    rej = sc.get_pod_sweep("int16")(
        tuple(torch.from_numpy(events[k]) for k in EVENT_KEYS),
        torch.from_numpy(inc), *state)
    want = _port(events, n_slots, 8, 64, sgb, pgb, inc, "int16")
    assert rej.tolist() == want[5].tolist()
    # the carry launcher (the streaming engines'): the stream cut in two
    # shards, the state and the reject counters carried, is one sweep
    state = _port_state(n_slots, 8, 64, sgb, pgb, "int16")
    rej = torch.zeros(len(sgb), dtype=torch.int32)
    carry = sc.get_pod_sweep("int16", with_carry=True)
    inc_t = torch.from_numpy(inc)
    widest = ops.check_incidence(inc_t, pgb.shape[1])
    for lo, hi in ((0, 24), (24, len(events["kind"]))):
        out = carry(tuple(torch.from_numpy(events[k][lo:hi].copy())
                          for k in EVENT_KEYS), inc_t, *state[:5], rej,
                    *state[5:], widest=widest)
        assert out is rej
    _assert_equal([t.numpy() for t in state[:5]] + [rej.numpy()], want,
                  "carry")
    # a split launch's launcher is keyed by its device (devices=, M13)
    assert sc.get_pod_sweep("int32", batched=True,
                            device=torch.device("cpu")) is not \
        sc.get_pod_sweep("int32", batched=True)
    with pytest.raises(ValueError, match="state_dtype"):
        sc.get_pod_sweep("int8")


def test_wrapper_checks_its_arguments():
    events, n_slots = cases.edge_stream()
    evs = [torch.from_numpy(events[k]) for k in EVENT_KEYS]
    sgb, pgb, inc = cases.edge_lanes()
    inc_t = torch.from_numpy(inc)

    def state(dt="int32"):
        return _port_state(n_slots, 4, 8, sgb, pgb, dt)

    with pytest.raises(ValueError, match="differ in length"):
        ops.pod_sweep(*evs[:5], evs[5][:-1], inc_t, *state())
    st = state()
    st[4] = st[4][:-1].contiguous()            # pods shorter than slots
    with pytest.raises(ValueError, match="shapes"):
        ops.pod_sweep(*evs, inc_t, *st)
    with pytest.raises(ValueError, match="shapes"):
        ops.pod_sweep(*evs, inc_t[:, :3].contiguous(), *state())
    st = state()
    st[6] = st[6].to(torch.int16)              # pgb of another type
    with pytest.raises(TypeError, match="state dtype"):
        ops.pod_sweep(*evs, inc_t, *st)
    with pytest.raises(TypeError, match="int32"):
        ops.pod_sweep(*evs, inc_t.to(torch.int64), *state())
    for bad in (-2, 4):                        # 4 pods: ids 0..3
        wrong = inc_t.clone()
        wrong[1, 2, 0] = bad
        with pytest.raises(ValueError, match="incidence"):
            ops.pod_sweep(*evs, wrong, *state())
    with pytest.raises(ValueError, match="slot_column"):
        ops.pod_sweep(*evs, inc_t, *state(), slot_column="nowhere")
    with pytest.raises(ValueError, match="pod_sweep: 8 lanes"):
        ops.pod_sweep(*evs, inc_t, *state(), trace_events=[10, 10, 10])
    # a forced table build smaller than the widest thread (K 1: one
    # server's row, 2 pods in the overlapping lanes)
    with pytest.raises(ValueError, match="smaller than the widest"):
        ops.pod_sweep(*evs, inc_t, *state(), distinct=1)
    ops.pod_sweep(*evs, inc_t, *state(), distinct=2)


def test_kernel_plan_takes_the_full_config_and_refuses_its_limits():
    # TOPO_FULL: 256 servers, rows of up to 3 pods, 1,517 slots, 192 lanes
    # (two a block on 132 SMs), and the seed batch's 3 x 192
    # (the widest thread of TOPO_FULL's grid lists 6 pods: the 8-entry
    # table; partitioned(256, 8) and one pool: one entry)
    for item in (2, 4):
        plan = K.plan(192, 256, 3, 1517, item, 132, distinct=6)
        assert plan == K.Plan(8, 3, 2, "shared", 8)
        assert K.shared_bytes(1517, item, 2) <= K.MAX_SHARED
    assert K.plan(192, 256, 3, 1517, 2, 132, n_traces=3).lanes_per_block == 5
    assert K.plan(16, 256, 1, 1517, 2, 132, distinct=1) == \
        K.Plan(8, 1, 1, "shared", 1)
    # no count given: the catch-all, which holds any thread
    assert K.plan(3, 33, 2, 10, 4, 132) == K.Plan(2, 2, 1, "shared", 6)
    assert K.plan(300, 64, 3, 90, 2, 132).lanes_per_block == 3
    # two columns past shared memory's limit stay in global memory
    assert K.choose_slot_column(60_000, 2) == "global"
    assert K.choose_slot_column(40_000, 2) == "shared"
    assert K.plan(16, 256, 3, 100_000, 4, 132).slot_column == "global"
    with pytest.raises(ValueError, match="at most 512 servers"):
        K.plan(16, 513, 1, 100, 2, 132)
    with pytest.raises(ValueError, match="at most 3 pods"):
        K.plan(16, 256, 4, 100, 2, 132)
    with pytest.raises(ValueError, match="slot_column"):
        K.plan(16, 256, 1, 100, 2, 132, slot_column="nowhere")


def test_the_plan_refuses_a_thread_wider_than_every_build():
    # the catch-all at K 8 holds 3 x 8 = 24 pods, at K 1 three
    assert K.distinct_builds(8) == (1, 8, 24)
    assert K.distinct_builds(1) == (1, 3)
    assert K.plan(16, 256, 3, 100, 2, 132, distinct=24).distinct == 24
    with pytest.raises(ValueError, match="at most 24 at 8 servers"):
        K.plan(16, 256, 3, 100, 2, 132, distinct=25)
    with pytest.raises(ValueError, match="at most 3 at 1 servers"):
        K.distinct_build(4, 1)


def _fig_topology_topologies(n_servers):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "torch_fig_topology", os.path.join(root, "examples",
                                           "torch_fig_topology.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.topologies(n_servers, quick=False)


# fig_topology's eight topologies at 256 servers, in its order: the most
# distinct pods that one thread's 8 servers list
FIG_TOPOLOGY_WIDEST = [2, 1, 1, 3, 4, 4, 6, 4]


@pytest.mark.parametrize("index", range(8))
def test_the_table_build_of_each_fig_topology_topology(index):
    from repro_torch.core.replay_engine import _fleet_incidence
    topo = _fig_topology_topologies(256)[index]
    inc = torch.from_numpy(_fleet_incidence([topo], 256)[0])
    widest = int(K.widest_distinct(inc, 8))
    assert widest == FIG_TOPOLOGY_WIDEST[index]
    assert K.plan(1, 256, topo.fanout, 1517, 2, 132,
                  distinct=widest).distinct == (1 if widest == 1 else 8)


def test_a_mixed_grid_takes_its_widest_thread():
    """TOPO_FULL's launch mixes the eight topologies: the widest thread is
    the widest of any lane (sparse(256, 6, 2): 6), so the 8-entry build."""
    from repro_torch.core.replay_engine import _fleet_incidence
    topos = _fig_topology_topologies(256)
    inc = torch.from_numpy(_fleet_incidence(topos * 3, 256)[0])
    assert int(K.widest_distinct(inc, 8)) == max(FIG_TOPOLOGY_WIDEST)
    one = torch.from_numpy(_fleet_incidence(topos[1:3] * 8, 256)[0])
    assert int(K.widest_distinct(one, 8)) == 1


def _cu_constant(name):
    """An ``int`` constant of the kernel's source (``N`` or ``A << B``)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, K.SOURCE)) as f:
        expr = re.search(rf"constexpr int {name} = ([^;]+);", f.read())[1]
    a, _, b = expr.partition("<<")
    return int(a) << int(b or 0)


def test_kernel_py_and_the_source_share_their_bounds():
    """kernel.py's limits and shared-memory sum are the ones the .cu
    computes: stages, then a lane's slot and pod columns, each rounded to
    16 bytes; the packed key holds every server the registers take."""
    assert _cu_constant("kTile") == K.TILE
    assert _cu_constant("kStages") == K.STAGES
    assert _cu_constant("kMaxLanesPerBlock") == K.MAX_LANES_PER_BLOCK
    assert _cu_constant("kMaxTraces") == K.MAX_TRACES
    assert _cu_constant("kMaxShared") == K.MAX_SHARED
    assert _cu_constant("kMaxF") == K.MAX_FANOUT
    assert _cu_constant("kMidD") == K.MID_DISTINCT
    assert 32 * _cu_constant("kMaxK") == K.MAX_SERVERS
    assert K.MAX_SERVERS <= 1 << _cu_constant("kIndexBits")
    stages = 2 * 6 * 1024 * 4
    assert K.shared_bytes(10, 2, 1) == stages + 2 * 32
    assert K.shared_bytes(10, 2, 3, "global") == stages
    assert K.shared_bytes(1517, 4, 2) == stages + 2 * 2 * 6080
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, K.SOURCE)) as f:
        src = f.read()
    # the table builds: 1, kMidD below the catch-all, the catch-all
    # kMaxF x K, at each servers-a-thread the dispatch instantiates
    assert re.search(r"if \(kd == 1\) return launch<T>\(pod_sweep_kernel<"
                     r"T, K, 1,", src)
    assert re.search(r"if constexpr \(kMidD < kAll\)\s+if \(kd == kMidD\)",
                     src)
    assert "constexpr int kAll = kMaxF * K;" in src
    built_k = sorted(int(k) for k in re.findall(
        r"case (\d+): return by_distinct<T, \1,", src))
    assert built_k == [1, 2, 4, 8, 16]
    assert [K.distinct_builds(k) for k in built_k] == [
        (1, 3), (1, 6), (1, 8, 12), (1, 8, 24), (1, 8, 48)]


def test_ptxas_report_reads_each_instantiation():
    def entry(args, regs, stack):
        return (
            "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116"
            f"pod_sweep_kernel{args}EEvNS_6EventsEPKiPT_S6_S6_S6_S6_"
            "PKS5_S8_PiiiiiiiiiNS_6TracesE' for 'sm_90a'\n"
            "ptxas info    : Function properties for _ZN12_GLOBAL__N_116pod\n"
            f"    {stack} bytes stack frame, {stack} bytes spill stores, "
            f"{stack} bytes spill loads\n"
            f"ptxas info    : Used {regs} registers, used 1 barriers\n")
    # the main path's build (int16, K 8, the 8-entry table, batched) and
    # the catch-all at K 16 (int32, columns in global memory)
    log = entry("IsLi8ELi8ELb1ELb0E", 88, 0) + \
        entry("IiLi16ELi48ELb0ELb1E", 255, 8)
    first, second = K.ptxas_report(log)
    assert first["registers"] == 88 and first["spill_store_bytes"] == 0
    assert first["state_dtype"] == "int16" and first["distinct"] == 8
    assert first["servers_per_thread"] == 8
    assert first["batched"] and first["slot_column"] == "shared"
    assert second["state_dtype"] == "int32" and second["distinct"] == 48
    assert second["servers_per_thread"] == 16 and not second["batched"]
    assert second["slot_column"] == "global"
    assert second["stack_bytes"] == 8 and second["registers"] == 255


def test_cpu_tensors_never_reach_the_kernel():
    events, n_slots = cases.edge_stream()
    sgb, pgb, inc = cases.edge_lanes()
    before = ops.launches
    _port(events, n_slots, 4, 8, sgb, pgb, inc, "int32")
    assert ops.launches == before
