"""K1's module: the plain event sweep of the port against the reference's
scan (``sweep_core.build_sweep(dt, with_carry=True)`` under ``jax.jit``)
on the same numpy inputs, the whole final state compared with ``==``; its
trace axis against T single sweeps and the reference's vmapped scan over
a trace batch; the host helpers of ``core/sweep_core.py`` against the
reference's; and the wrapper's checks and the launch plan.  The CUDA kernel itself is held to the plain version on
the card by ``chip_smoke.py``."""
import functools
import os
import re

import jax
import numpy as np
import pytest
import torch

from repro.core import sweep_core as jax_sc
from repro_torch.core import sweep_core as sc
from repro_torch.core.replay_engine import CompiledReplay
from repro_torch.kernels.event_sweep import cases
from repro_torch.kernels.event_sweep import ops
from repro_torch.kernels.event_sweep.cases import EVENT_KEYS
from tests._torch_port_util import PORT_WORLD_CFG, POOL, SERVER, port_world

DTYPES = ("int16", "int32")


@functools.cache
def _jax_sweep(state_dtype):
    return jax.jit(jax_sc.build_sweep(state_dtype, with_carry=True))


def _reference(events, n_slots, n_servers, spg, cores, sgb, pgb,
               state_dtype):
    """The reference's scan run as its engine runs it: lanes padded to a
    candidate bucket (replicating the last lane), servers and groups to
    multiples of 16, slots to 32 and events to 256 (PAD); returns the
    final state cut back to the true extents.  (On unpadded int16 shapes
    the reference's scan can write a slot update into another row on this
    jax version: ROADMAP F7.)"""
    n = len(sgb)
    np_dt = sc.state_np_dtype(state_dtype)
    width = jax_sc.bucket_width(n)
    s_pad = jax_sc.pad_up(n_servers, jax_sc.LANE_PAD)
    n_groups = -(-n_servers // spg)
    g_pad = jax_sc.pad_up(n_groups, jax_sc.LANE_PAD)
    slot_pad = jax_sc.pad_up(n_slots, jax_sc.SLOT_PAD)
    e_pad = jax_sc.pad_up(len(events["kind"]), jax_sc.EVENT_PAD)
    caps = jax_sc.lane_capacities(np.asarray(sgb, float),
                                  np.asarray(pgb, float), 0, n, width,
                                  np_dt)
    state = jax_sc.init_state(width, n_servers, cores, s_pad, g_pad,
                              slot_pad, np_dt)
    group_of = np.zeros(s_pad, np.int32)
    group_of[:n_servers] = np.arange(n_servers) // spg
    evs = []
    for k in EVENT_KEYS:
        a = np.full(e_pad, jax_sc.PAD if k == "kind" else 0, np.int32)
        a[:len(events[k])] = events[k]
        evs.append(a)
    out = _jax_sweep(state_dtype)(tuple(evs), group_of, *state, *caps)
    fc, um, up, slots, rej = (np.asarray(a) for a in out)
    return [fc[:n, :n_servers], um[:n, :n_servers], up[:n, :n_groups],
            slots[:n_slots, :n], rej[:n]]


def _both(events, n_slots, n_servers, spg, cores, sgb, pgb, state_dtype):
    """Final (fc, um, up, slots, rejects) of the reference's scan and of
    the port's plain version, as numpy, from the same inputs."""
    np_dt = sc.state_np_dtype(state_dtype)
    n_groups = -(-n_servers // spg)
    state = sc.init_state(len(sgb), n_servers, cores, n_servers, n_groups,
                          n_slots, np_dt)
    group_of = (np.arange(n_servers) // spg).astype(np.int32)
    caps = (np.asarray(sgb).astype(np_dt), np.asarray(pgb).astype(np_dt))
    evs = tuple(np.asarray(events[k], np.int32) for k in EVENT_KEYS)
    want = _reference(events, n_slots, n_servers, spg, cores, sgb, pgb,
                      state_dtype)
    t = [torch.from_numpy(a.copy()) for a in (*state, *caps)]
    fc, um, up, slots, rej, sgb_t, pgb_t = t
    ops.event_sweep(*(torch.from_numpy(e) for e in evs),
                    torch.from_numpy(group_of), fc, um, up, slots, sgb_t,
                    pgb_t, rej)
    return want, [a.numpy() for a in (fc, um, up, slots, rej)]


def _assert_equal(want, got):
    for name, a, b in zip(("fc", "um", "up", "slots", "rejects"), want, got):
        assert a.dtype == b.dtype, name
        assert a.tolist() == b.tolist(), name


@pytest.mark.parametrize("state_dtype", DTYPES)
@pytest.mark.parametrize("policy", ["static", "pond"])
def test_plain_sweep_matches_reference_scan_on_world_streams(policy,
                                                             state_dtype):
    _, _, pvms, pdec = port_world(3, policy)
    eng = CompiledReplay(pvms, pdec, PORT_WORLD_CFG, device="cpu")
    evs, _, n_slots = eng._device_events()
    if policy == "pond":
        assert (evs[0] == sc.MIGRATE).any()       # QoS migrations replay
    events = dict(zip(EVENT_KEYS, (e.numpy() for e in evs)))
    sgb, pgb = sc.quantize_capacities(SERVER, POOL)
    want, got = _both(events, n_slots, 8, 4, 64, sgb, pgb, state_dtype)
    _assert_equal(want, got)
    assert 0 < got[4].min() < got[4].max() <= len(pvms)


@pytest.mark.parametrize("state_dtype", DTYPES)
def test_plain_sweep_matches_reference_scan_on_edge_stream(state_dtype):
    events, n_slots = cases.edge_stream()
    assert set(events["kind"].tolist()) == {sc.ARRIVE, sc.DEPART,
                                            sc.MIGRATE, sc.PAD, sc.FAIL,
                                            sc.RECOVER}
    lanes = np.asarray(cases.EDGE_LANES)
    want, got = _both(events, n_slots, 3, 2, 8, lanes[:, 0], lanes[:, 1],
                      state_dtype)
    _assert_equal(want, got)
    fc, um, up, slots, rej = got
    # every VM left: cores and slots are all back
    assert (fc == 8).all() and (slots == -1).all()
    # lane (16, 0): the fallback placed VM 2 all-local and its MIGRATE
    # still returned pool, so used pool stays negative (not clamped) and
    # as much local memory stays used (its DEPART returns mem_gb only)
    assert up[1, 0] < 0
    assert (um.sum(1) == -up.sum(1)).all()
    # nothing fits lane (0, 0); VM 3 (16 cores) fits no lane
    assert rej[4] == 6 and rej.min() == 1


@pytest.mark.parametrize("state_dtype", DTYPES)
@pytest.mark.parametrize("n_servers,spg,n_lanes,mig_frac",
                         [(1, 8, 1, 0.2), (7, 4, 16, 0.2), (33, 8, 5, 0.2),
                          (7, 4, 9, 0.0)])
def test_plain_sweep_matches_reference_scan_on_random_streams(
        n_servers, spg, n_lanes, mig_frac, state_dtype):
    rng = np.random.default_rng(n_servers * 100 + n_lanes)
    events, n_slots = cases.random_stream(rng, 250, mig_frac=mig_frac)
    if mig_frac:
        assert (events["kind"] == sc.MIGRATE).any()
    sgb, pgb = cases.lane_capacities(rng, n_lanes, n_servers, 64)
    want, got = _both(events, n_slots, n_servers, spg, 64, sgb, pgb,
                      state_dtype)
    _assert_equal(want, got)


def test_a_sweep_cut_in_two_carries_its_state():
    """The final state written in place is the carry: two sweeps over the
    halves of a stream give the sweep over the whole stream."""
    rng = np.random.default_rng(5)
    events, n_slots = cases.random_stream(rng, 200)
    sgb, pgb = cases.lane_capacities(rng, 6, 7, 64)
    want, _ = _both(events, n_slots, 7, 4, 64, sgb, pgb, "int32")
    state = [torch.from_numpy(a) for a in sc.init_state(
        6, 7, 64, 7, 2, n_slots, np.int32)]
    caps = [torch.from_numpy(a.astype(np.int32)) for a in (sgb, pgb)]
    group_of = torch.from_numpy((np.arange(7) // 4).astype(np.int32))
    half = len(events["kind"]) // 2
    for lo, hi in ((0, half), (half, None)):
        ops.event_sweep(*(torch.from_numpy(events[k][lo:hi].copy())
                          for k in EVENT_KEYS), group_of, *state[:4],
                        *caps, state[4])
    _assert_equal(want, [t.numpy() for t in state])


# ------------------------------------------------------------ host helpers --
def test_pick_state_dtype_matches_reference_at_its_boundaries():
    safe = sc.I16_SAFE
    assert safe == jax_sc.I16_SAFE and sc.I16_BIG == jax_sc.I16_BIG \
        and sc.I32_BIG == jax_sc.I32_BIG
    kw = dict(cores_per_server=64.0, n_servers=16, pay_mem_max=32.0,
              pay_pool_max=8.0)
    sgb = np.array([float(safe - 32)])
    pgb = np.array([float(safe - 8)])
    calls = [dict(sgb_i=sgb, pgb_i=pgb), dict(sgb_i=sgb + 1.0, pgb_i=pgb),
             dict(sgb_i=sgb, pgb_i=pgb + 1.0),
             dict(sgb_i=np.array([-1.0]), pgb_i=np.array([0.0])),
             dict(sgb_i=np.array([]), pgb_i=np.array([])),
             dict(sgb_i=sgb, pgb_i=np.array([0.0]),
                  mig_pool_sum=float(safe - 8)),
             dict(sgb_i=sgb, pgb_i=np.array([0.0]),
                  mig_pool_sum=float(safe - 7)),
             dict(sgb_i=sgb, pgb_i=pgb, cores_per_server=float(1 << 14)),
             dict(sgb_i=sgb, pgb_i=pgb, n_servers=(1 << 13))]
    got = [sc.pick_state_dtype(**(kw | c)) for c in calls]
    assert got == [jax_sc.pick_state_dtype(**(kw | c)) for c in calls]
    assert got == ["int16", "int32", "int32", "int32", "int32", "int16",
                   "int32", "int32", "int32"]


def test_quantize_and_init_state_match_reference():
    s = np.array([200.7, np.inf, -3.5, 0.0, 2.0 ** 40])
    p = np.array([-np.inf, 12.2, 0.0, 7.999, 5.0])
    for a, b in zip(sc.quantize_capacities(s, p),
                    jax_sc.quantize_capacities(s, p)):
        assert a.tolist() == b.tolist()
    for dt in (np.int16, np.int32):
        for args in ((3, 8, 64.0, 8, 1, 5), (1, 7, 48.0, 16, 2, 32)):
            for a, b in zip(sc.init_state(*args, dt),
                            jax_sc.init_state(*args, dt)):
                assert a.dtype == b.dtype and a.tolist() == b.tolist()


@pytest.mark.parametrize("policy", ["static", "pond"])
def test_assign_slots_matches_reference(policy):
    vms, dec, pvms, pdec = port_world(4, policy)
    eng = CompiledReplay(pvms, pdec, PORT_WORLD_CFG, device="cpu")
    got = sc.assign_slots(eng._ev_kind, eng._ev_vm, eng.n_vms)
    want = jax_sc.assign_slots(eng._ev_kind, eng._ev_vm, eng.n_vms)
    assert got[0].tolist() == want[0].tolist() and got[1] == want[1]


def test_get_sweep_is_k1_and_refuses_the_unported_keys():
    rng = np.random.default_rng(2)
    events, n_slots = cases.random_stream(rng, 40)
    sgb, pgb = cases.lane_capacities(rng, 3, 4, 64)
    want, _ = _both(events, n_slots, 4, 2, 64, sgb, pgb, "int16")
    st = [torch.from_numpy(a) for a in sc.init_state(3, 4, 64, 4, 2,
                                                     n_slots, np.int16)]
    rej = sc.get_sweep("int16")(
        tuple(torch.from_numpy(events[k]) for k in EVENT_KEYS),
        torch.from_numpy((np.arange(4) // 2).astype(np.int32)), *st[:4],
        *(torch.from_numpy(a.astype(np.int16)) for a in (sgb, pgb)))
    assert rej.tolist() == want[4].tolist()
    # the trace axis is served: one trace through it is the same sweep
    st = [torch.from_numpy(a) for a in sc.init_state(3, 4, 64, 4, 2,
                                                     n_slots, np.int16)]
    rej = sc.get_sweep("int16", batched=True)(
        tuple(torch.from_numpy(events[k]) for k in EVENT_KEYS),
        torch.from_numpy((np.arange(4) // 2).astype(np.int32)), *st[:4],
        *(torch.from_numpy(a.astype(np.int16)) for a in (sgb, pgb)),
        [len(events["kind"])])
    assert rej.tolist() == want[4].tolist()
    # the carry launchers (the streaming engines'): the stream cut in two
    # shards, the state and the reject counters carried, is one sweep;
    # batched, a trace with no events in a shard leaves its lanes alone
    group = torch.from_numpy((np.arange(4) // 2).astype(np.int32))
    caps = tuple(torch.from_numpy(a.astype(np.int16)) for a in (sgb, pgb))
    cut = (0, 17, len(events["kind"]))
    for batched in (False, True):
        st = [torch.from_numpy(a) for a in sc.init_state(
            3, 4, 64, 4, 2, n_slots, np.int16)]
        carry = sc.get_sweep("int16", with_carry=True, batched=batched)
        for lo, hi in zip(cut, cut[1:]):
            evs = tuple(torch.from_numpy(events[k][lo:hi].copy())
                        for k in EVENT_KEYS)
            extra = ([hi - lo],) if batched else ()
            out = carry(evs, group, *st[:4], st[4], *caps, *extra)
            assert out is st[4]
        if batched:
            carry(tuple(torch.from_numpy(events[k][:0].copy())
                        for k in EVENT_KEYS), group, *st[:4], st[4], *caps,
                  [0])
        for got, w in zip(st, want):
            assert got.tolist() == w.tolist(), batched
    # a split launch's launcher is keyed by its device (devices=, M13)
    assert sc.get_sweep("int32", device=torch.device("cpu")) is not \
        sc.get_sweep("int32")
    with pytest.raises(ValueError):
        sc.get_sweep("int8")


# ----------------------------------------------------------------- wrapper --
def _small_args(state_dtype=torch.int32):
    rng = np.random.default_rng(9)
    events, n_slots = cases.random_stream(rng, 30)
    np_dt = np.int16 if state_dtype == torch.int16 else np.int32
    st = sc.init_state(4, 5, 64, 5, 2, n_slots, np_dt)[:4]
    sgb, pgb = cases.lane_capacities(rng, 4, 5, 64)
    return ([torch.from_numpy(events[k]) for k in EVENT_KEYS],
            torch.from_numpy((np.arange(5) // 4).astype(np.int32)),
            [torch.from_numpy(a) for a in st],
            [torch.from_numpy(a.astype(np_dt)) for a in (sgb, pgb)])


def test_wrapper_takes_plain_path_on_cpu_and_counts_no_launch():
    events, group_of, st, caps = _small_args()
    ops.launches, ops.last_plan = 0, None
    rej = ops.event_sweep(*events, group_of, *st, *caps)
    assert rej.dtype == torch.int32 and rej.shape == (4,)
    assert ops.launches == 0 and ops.last_plan is None
    # a variant is the kernel's: the plain version gives the same answer
    events, group_of, st, caps = _small_args()
    assert ops.event_sweep(*events, group_of, *st, *caps,
                           variant="shared").tolist() == rej.tolist()
    assert ops.launches == 0 and ops.last_plan is None


@pytest.mark.parametrize("breakage", ["state_dtype", "event_dtype",
                                      "mixed_state", "lanes", "servers",
                                      "event_length", "noncontiguous",
                                      "device", "variant"])
def test_wrapper_refuses_bad_inputs(breakage):
    events, group_of, st, caps = _small_args()
    exc = ValueError
    if breakage == "state_dtype":
        st, caps, exc = [t.long() for t in st], [t.long() for t in caps], \
            TypeError
    elif breakage == "event_dtype":
        events[2], exc = events[2].long(), TypeError
    elif breakage == "mixed_state":
        st[1], exc = st[1].to(torch.int16), TypeError
    elif breakage == "lanes":
        caps[0] = caps[0][:3].contiguous()
    elif breakage == "servers":
        group_of = group_of[:4].contiguous()
    elif breakage == "event_length":
        events[5] = events[5][:-1].contiguous()
    elif breakage == "noncontiguous":
        st[0] = st[0].t().contiguous().t()
    elif breakage == "device":
        st[0] = st[0].to("meta")
    with pytest.raises(exc):
        ops.event_sweep(*events, group_of, *st, *caps,
                        variant="warp" if breakage == "variant" else None)


def test_kernel_plan_fits_the_full_config_and_refuses_too_large_a_lane():
    from repro_torch.kernels.event_sweep import kernel as K
    stages = K.STAGES * 6 * K.TILE * 4
    # the full-width row: 256 servers, 32 groups, 1,517 slots
    for item in (2, 4):
        plan = K.plan(16, 256, 32, 1517, item, 132)
        assert (plan.variant, plan.servers_per_thread,
                plan.lanes_per_block) == ("registers", 8, 1)
        # one lane an SM while there are no more lanes than SMs, then as
        # many as spread the lanes evenly over them
        assert K.lanes_per_block(132, 256, 32, 1517, item, 132) == 1
        assert K.lanes_per_block(200, 256, 32, 1517, item, 132) == 2
        assert K.lanes_per_block(528, 256, 32, 1517, item, 132) == 4
        assert K.lanes_per_block(5000, 256, 32, 1517, item, 132) == 8
        # a lane of the registers variant holds its slot column alone
        slot_col = -(-1517 * item // 16) * 16
        assert K.shared_bytes(256, 32, 1517, item, 8) \
            == stages + 256 * 4 + 8 * slot_col <= K.MAX_SHARED
        assert K.shared_bytes(256, 32, 1517, item, 8, "shared") \
            == stages + 256 * 4 + 8 * (-(-(2 * 256 + 32 + 1517) * item
                                         // 16) * 16) <= K.MAX_SHARED
    # a slot column too large for shared memory stays in global memory
    # (F8): the plan says so, and its lanes no longer count one
    for variant in ("registers", "shared"):
        for item in (2, 4):
            plan = K.plan(16, 256, 32, 100_000, item, 132, variant)
            assert (plan.variant, plan.slot_column) == (variant, "global")
            assert K.shared_bytes(256, 32, 100_000, item, 8, variant,
                                  "global") \
                == K.shared_bytes(256, 32, 0, item, 8, variant)
        # kept in shared memory, it does not fit: the limit is named
        with pytest.raises(ValueError, match="232448"):
            K.lanes_per_block(1, 256, 32, 100_000, 4, 132, variant)
    # the limits at 256 servers: 45,568 slots in int32, 91,136 in int16
    for item, most in ((4, 45_568), (2, 91_136)):
        assert K.plan(1, 256, 32, most, item, 132).slot_column == "shared"
        assert K.plan(1, 256, 32, most + 8, item,
                      132).slot_column == "global"
    assert K.plan(16, 256, 32, 1517, 4, 132,
                  slot_column="global").slot_column == "global"
    with pytest.raises(ValueError, match="slot_column"):
        K.plan(16, 256, 32, 1517, 4, 132, slot_column="local")
    # what stays refused: the shared variant's fc, um and up must fit
    # (about 15 k servers with int32 state)
    assert K.plan(1, 14_000, 1_000, 10, 4, 132).slot_column == "shared"
    with pytest.raises(ValueError, match="232448"):
        K.plan(1, 16_000, 1_000, 10, 4, 132)
    # lanes per block shrink to what the shared memory holds
    assert K.lanes_per_block(5000, 256, 32, 20_000, 4, 132) == 2
    assert K.lanes_per_block(5000, 256, 32, 20_000, 4, 132, "shared") == 2
    assert K.lanes_per_block(5000, 256, 32, 20_000, 4, 132,
                             slot_column="global") == 8


@pytest.mark.parametrize("n_servers,variant,k",
                         [(1, "registers", 1), (32, "registers", 1),
                          (33, "registers", 2), (256, "registers", 8),
                          (512, "registers", 16), (513, "shared", 0),
                          (600, "shared", 0)])
def test_kernel_variant_follows_the_server_count(n_servers, variant, k):
    from repro_torch.kernels.event_sweep import kernel as K
    plan = K.plan(16, n_servers, 8, 100, 2, 132)
    assert (plan.variant, plan.servers_per_thread) == (variant, k)
    assert K.MAX_REGISTER_SERVERS == 512
    forced = K.plan(16, n_servers, 8, 100, 2, 132, "shared")
    assert (forced.variant, forced.servers_per_thread) == ("shared", 0)
    if variant == "registers":
        regs = K.plan(16, n_servers, 8, 100, 4, 132, "registers")
        assert (regs.variant, regs.servers_per_thread) == (variant, k)
    else:     # beyond the registers variant's limit, named in the error
        with pytest.raises(ValueError, match="512"):
            K.plan(16, n_servers, 8, 100, 2, 132, "registers")
    with pytest.raises(ValueError, match="variant"):
        K.plan(16, n_servers, 8, 100, 2, 132, "warp")


def _cu_constant(name):
    """An ``int`` constant of the kernel's source (``N`` or ``A << B``)."""
    from repro_torch.kernels.event_sweep import kernel as K
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, K.SOURCE)) as f:
        expr = re.search(rf"constexpr int {name} = ([^;]+);", f.read())[1]
    a, _, b = expr.partition("<<")
    return int(a) << int(b or 0)


@pytest.mark.parametrize("item,n_servers,fits",
                         [(2, 1, True), (2, 512, True), (2, 513, False),
                          (4, 1, False), (4, 256, False)])
def test_packed_key_fits_at_its_boundary(item, n_servers, fits):
    """The registers variant takes its first minimum as the least of one
    32-bit key (f + kScoreOffset) << kIndexBits | server for int16 state
    (``item`` 2), two steps for int32: the key holds every int16 f and
    every server the variant takes, ordered as (f, server); neither a
    server past its limit (where the shared variant runs) nor an int32 f
    fits."""
    from repro_torch.kernels.event_sweep import kernel as K
    index_bits = _cu_constant("kIndexBits")
    offset = _cu_constant("kScoreOffset")
    assert 32 * _cu_constant("kMaxK") == K.MAX_REGISTER_SERVERS
    lo, hi = -(1 << (8 * item - 1)), (1 << (8 * item - 1)) - 1
    pairs = [(score, server) for score in (lo, -1, 0, 1, sc.I16_BIG, hi)
             for server in (0, 1, n_servers - 1)]
    keys = [(score + offset) << index_bits | server
            for score, server in pairs]
    got = (0 <= min(keys) and max(keys) < 1 << 32
           and n_servers <= 1 << index_bits
           and sorted(range(len(pairs)), key=keys.__getitem__)
           == sorted(range(len(pairs)), key=pairs.__getitem__))
    assert got is fits
    if item == 2:
        assert (K.choose_variant(n_servers) == "registers") is fits


def test_ptxas_report_reads_each_variant():
    from repro_torch.kernels.event_sweep import kernel as K
    names = ["_ZN12_GLOBAL__N_117sweep_regs_kernelIsLi8EEEvNS_6EventsE",
             "_ZN12_GLOBAL__N_117sweep_regs_kernelIiLi16EEEvNS_6EventsE",
             "_ZN12_GLOBAL__N_119sweep_shared_kernelIsEEvNS_6EventsE",
             "_ZN12_GLOBAL__N_117sweep_regs_kernelIsLi8ELb1EEEvNS_6EventsE",
             "_ZN12_GLOBAL__N_119sweep_shared_kernelIiLb0EEEvNS_6EventsE"]
    log = "ptxas info    : 0 bytes gmem\n"
    for i, n in enumerate(names):
        log += (f"ptxas info    : Compiling entry function '{n}' for "
                f"'sm_90a'\nptxas info    : Function properties for {n}\n"
                f"    {8 * i} bytes stack frame, {4 * i} bytes spill stores, "
                f"{4 * i} bytes spill loads\nptxas info    : Used {40 + i} "
                "registers, used 1 barriers, 448 bytes cmem[0]\n")
    got = K.ptxas_report(log)
    assert [(r["variant"], r["state_dtype"], r["servers_per_thread"],
             r["registers"], r["stack_bytes"], r["spill_store_bytes"])
            for r in got] == [("registers", "int16", 8, 40, 0, 0),
                              ("registers", "int32", 16, 41, 8, 4),
                              ("shared", "int16", 0, 42, 16, 8),
                              ("registers", "int16", 8, 43, 24, 12),
                              ("shared", "int32", 0, 44, 32, 16)]
    # the trace axis's batched build and the single-trace one
    assert [r["batched"] for r in got] == [False] * 3 + [True, False]
    assert {r["slot_column"] for r in got} == {"shared"}


def test_ptxas_report_reads_the_slot_column():
    from repro_torch.kernels.event_sweep import kernel as K
    names = ["_ZN12_GLOBAL__N_117sweep_regs_kernelIsLi8ELb0ELb1EEEvNS_6EventsE",
             "_ZN12_GLOBAL__N_117sweep_regs_kernelIiLi4ELb1ELb0EEEvNS_6EventsE",
             "_ZN12_GLOBAL__N_119sweep_shared_kernelIiLb1ELb1EEEvNS_6EventsE"]
    log = "".join(f"ptxas info    : Compiling entry function '{n}' for "
                  f"'sm_90a'\nptxas info    : Used {40 + i} registers\n"
                  for i, n in enumerate(names))
    got = K.ptxas_report(log)
    assert [(r["variant"], r["state_dtype"], r["servers_per_thread"],
             r["batched"], r["slot_column"], r["registers"])
            for r in got] == [("registers", "int16", 8, False, "global", 40),
                              ("registers", "int32", 4, True, "shared", 41),
                              ("shared", "int32", 0, True, "global", 42)]


# -------------------------------------------------------------- trace axis --
@functools.cache
def _jax_batched_sweep(state_dtype):
    return jax.jit(jax.vmap(jax_sc.build_sweep(state_dtype, with_carry=True),
                            in_axes=((0,) * 6, None, 0, 0, 0, 0, 0, 0, 0)))


def _reference_batched(streams, n_slots, n_servers, spg, cores, sgb, pgb,
                       state_dtype):
    """The reference's vmapped scan over a trace batch, padded as its
    engine pads it (rows to the longest trace's events rounded to 256 with
    PAD, lanes to a bucket, servers, groups and slots as in
    :func:`_reference`); returns each trace's final state at the true
    extents."""
    k, n = sgb.shape
    np_dt = sc.state_np_dtype(state_dtype)
    width = jax_sc.bucket_width(n)
    s_pad = jax_sc.pad_up(n_servers, jax_sc.LANE_PAD)
    n_groups = -(-n_servers // spg)
    g_pad = jax_sc.pad_up(n_groups, jax_sc.LANE_PAD)
    slot_pad = jax_sc.pad_up(n_slots, jax_sc.SLOT_PAD)
    e_pad = jax_sc.pad_up(max(len(ev["kind"]) for ev in streams),
                          jax_sc.EVENT_PAD)
    evs = []
    for key in EVENT_KEYS:
        a = np.full((k, e_pad), jax_sc.PAD if key == "kind" else 0,
                    np.int32)
        for i, ev in enumerate(streams):
            a[i, :len(ev[key])] = ev[key]
        evs.append(a)
    caps = [jax_sc.lane_capacities(np.asarray(sgb[i], float),
                                   np.asarray(pgb[i], float), 0, n, width,
                                   np_dt) for i in range(k)]
    state = jax_sc.init_state(width, n_servers, cores, s_pad, g_pad,
                              slot_pad, np_dt)
    group_of = np.zeros(s_pad, np.int32)
    group_of[:n_servers] = np.arange(n_servers) // spg
    out = _jax_batched_sweep(state_dtype)(
        tuple(evs), group_of, *(np.stack([a] * k) for a in state),
        *(np.stack([c[j] for c in caps]) for j in range(2)))
    fc, um, up, slots, rej = (np.asarray(a) for a in out)
    return [[fc[i, :n, :n_servers], um[i, :n, :n_servers],
             up[i, :n, :n_groups], slots[i, :n_slots, :n], rej[i, :n]]
            for i in range(k)]


def _trace_batch(rng, lengths, mig_frac=0.2):
    """Random streams of unequal lengths (and so unequal slot counts) and
    the port's trace-axis layout of them: (streams, n_slots per stream,
    six int32 arrays with every trace from a multiple of 4 events)."""
    streams, slot_counts = zip(*(cases.random_stream(rng, m,
                                                     mig_frac=mig_frac)
                                 for m in lengths))
    cols, _ = ops.pack_traces([tuple(ev[k] for k in EVENT_KEYS)
                               for ev in streams])
    return list(streams), list(slot_counts), [c.numpy() for c in cols]


@pytest.mark.parametrize("state_dtype", DTYPES)
@pytest.mark.parametrize("n_traces,n_cand,n_servers,spg",
                         [(1, 5, 7, 4), (2, 3, 33, 8), (3, 9, 7, 4),
                          (7, 2, 4, 2)])
def test_trace_axis_equals_single_sweeps_and_reference_batched_scan(
        n_traces, n_cand, n_servers, spg, state_dtype):
    """T traces of unequal lengths and peaks in one call: each trace's
    lanes == a single sweep of that trace alone (the port) and == the
    reference's vmapped scan over the batch, whole final state."""
    rng = np.random.default_rng(40 + n_traces * 7 + n_cand)
    streams, slot_counts, cols = _trace_batch(
        rng, [120 + 37 * i for i in range(n_traces)])
    assert len(set(slot_counts)) > 1 or n_traces == 1
    n_slots = max(slot_counts)
    caps = [cases.lane_capacities(rng, n_cand, n_servers, 64)
            for _ in range(n_traces)]
    sgb, pgb = (np.stack([c[j] for c in caps]) for j in range(2))
    np_dt = sc.state_np_dtype(state_dtype)
    n_groups = -(-n_servers // spg)
    group_of = torch.from_numpy((np.arange(n_servers) // spg)
                                .astype(np.int32))
    state = [torch.from_numpy(a) for a in sc.init_state(
        n_traces * n_cand, n_servers, 64, n_servers, n_groups, n_slots,
        np_dt)]
    ops.launches = 0
    ops.event_sweep(*(torch.from_numpy(c) for c in cols), group_of,
                    *state[:4], *(torch.from_numpy(a.reshape(-1)
                                                   .astype(np_dt))
                                  for a in (sgb, pgb)), state[4],
                    trace_events=[len(ev["kind"]) for ev in streams])
    assert ops.launches == 0                 # the plain version ran
    got = [[t.numpy() for t in state]]
    per_trace = [[a[i * n_cand:(i + 1) * n_cand] for a in got[0][:3]]
                 + [got[0][3][:, i * n_cand:(i + 1) * n_cand],
                    got[0][4][i * n_cand:(i + 1) * n_cand]]
                 for i in range(n_traces)]
    want = _reference_batched(streams, n_slots, n_servers, spg, 64, sgb,
                              pgb, state_dtype)
    for i, ev in enumerate(streams):
        single, _ = _both(ev, n_slots, n_servers, spg, 64, sgb[i], pgb[i],
                          state_dtype)[::-1]
        _assert_equal(single, per_trace[i])
        _assert_equal(want[i], per_trace[i])


def test_trace_axis_refuses_layouts_the_kernel_cannot_take():
    rng = np.random.default_rng(3)
    streams, slot_counts, cols = _trace_batch(rng, [30, 41])
    counts = [len(ev["kind"]) for ev in streams]
    st = sc.init_state(4, 5, 64, 5, 2, max(slot_counts), np.int32)[:4]
    sgb, pgb = cases.lane_capacities(rng, 4, 5, 64)

    def call(trace_events, events=cols):
        args = ([torch.from_numpy(c) for c in events],
                torch.from_numpy((np.arange(5) // 4).astype(np.int32)),
                [torch.from_numpy(a.copy()) for a in st],
                [torch.from_numpy(a.astype(np.int32)) for a in (sgb, pgb)])
        return ops.event_sweep(*args[0], args[1], *args[2], *args[3],
                               trace_events=trace_events)
    assert call(counts).shape == (4,)
    with pytest.raises(ValueError, match="split"):
        call(counts + [0])                      # 4 lanes, 3 traces
    need = ops.trace_starts(counts)[-1] + counts[-1]
    with pytest.raises(ValueError, match="hold"):
        call(counts, [c[:need - 1].copy() for c in cols])
    with pytest.raises(ValueError, match="traces"):
        call([])
    with pytest.raises(ValueError, match="traces"):
        call([counts[0], -1])


def test_trace_starts_keep_every_row_16_byte_aligned():
    assert ops.trace_starts([]) == []
    assert ops.trace_starts([0, 1, 4, 5, 3]) == [0, 0, 4, 8, 16]
    rng = np.random.default_rng(8)
    counts = rng.integers(0, 5000, 50).tolist()
    starts = ops.trace_starts(counts)
    assert all(s % 4 == 0 for s in starts)          # 16 bytes of int32
    assert all(b - a >= n for a, b, n in zip(starts, starts[1:], counts))
    from repro_torch.kernels.event_sweep import kernel as K
    assert _cu_constant("kMaxTraces") == K.MAX_TRACES


def test_pack_traces_lays_each_stream_at_its_start_with_pad_between():
    """Each stream's rows from its ``trace_starts`` offset, PAD (kind) and
    0 in the gaps, int32; numpy arrays and tensors alike."""
    rng = np.random.default_rng(9)
    streams = [cases.random_stream(rng, m)[0] for m in (5, 8, 1, 14)]
    rows = [tuple(ev[k] for k in EVENT_KEYS) for ev in streams]
    rows[1] = tuple(torch.from_numpy(np.asarray(a)) for a in rows[1])
    cols, counts = ops.pack_traces(rows)
    assert counts == [len(ev["kind"]) for ev in streams]
    starts = ops.trace_starts(counts)
    assert len(cols) == 6 and all(c.dtype == torch.int32
                                  and c.device.type == "cpu"
                                  and len(c) == starts[-1] + (-(-counts[-1]
                                                                // 4) * 4)
                                  for c in cols)
    filled = np.zeros(len(cols[0]), bool)
    for ev, e0, n in zip(streams, starts, counts):
        filled[e0:e0 + n] = True
        for j, key in enumerate(EVENT_KEYS):
            np.testing.assert_array_equal(cols[j][e0:e0 + n].numpy(),
                                          np.asarray(ev[key]))
    assert (cols[0].numpy()[~filled] == sc.PAD).all()
    assert all((c.numpy()[~filled] == 0).all() for c in cols[1:])


@pytest.mark.parametrize("n_traces,n_cand", [(1, 16), (3, 28), (3, 300),
                                             (7, 5), (2, 1), (40, 20),
                                             (256, 3)])
def test_lanes_per_block_never_straddles_a_trace(n_traces, n_cand):
    """A block replays one trace: its lanes are candidates of one trace
    (no more than a trace has), the grid (blocks a trace x traces) covers
    every lane once, and T = 1 plans as the single-trace sweep did."""
    from repro_torch.kernels.event_sweep import kernel as K
    for item, sms in ((2, 132), (4, 132), (4, 16)):
        plan = K.plan(n_cand, 256, 32, 1517, item, sms, n_traces=n_traces)
        lpb = plan.lanes_per_block
        assert 1 <= lpb <= min(n_cand, K.MAX_LANES_PER_BLOCK)
        blocks = -(-n_cand // lpb)
        lanes = [t * n_cand + b * lpb + w for t in range(n_traces)
                 for b in range(blocks) for w in range(lpb)
                 if b * lpb + w < n_cand]
        assert sorted(lanes) == list(range(n_traces * n_cand))
        if n_traces == 1:
            assert lpb == min(K.MAX_LANES_PER_BLOCK,
                              max(1, -(-n_cand // sms)))
    # 3 traces x 28 lanes on 132 SMs: one lane a block, 84 blocks
    assert K.plan(28, 256, 32, 1517, 2, 132, n_traces=3).lanes_per_block \
        == 1
    # 3 x 300 lanes spread over 132 SMs: 7 a block, which 300 is not a
    # multiple of (the last block of each trace holds an idle warp)
    assert K.plan(300, 256, 32, 1517, 2, 132,
                  n_traces=3).lanes_per_block == 7
