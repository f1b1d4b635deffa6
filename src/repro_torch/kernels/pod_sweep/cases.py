"""Event streams and fleet lanes that reach every branch of the pod sweep,
for holding K4 against its plain version (``chip_smoke.py``) and the plain
version against the reference's scan (``tests/test_torch_pod_sweep.py``).

Streams are compiled by K1's ``event_sweep.cases.compile_stream`` (PAD,
FAIL and RECOVER are no-ops in the pod sweep too); a VM may carry several
MIGRATE times there, to reach the quirk of a second MIGRATE.  A lane is
``(sgb, pod capacities (P,), incidence (S, F))``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import topology
from repro_torch.core.sweep_core import FAIL, I16_BIG, PAD, RECOVER
from repro_torch.kernels.event_sweep.cases import (  # noqa: F401
    EVENT_KEYS, compile_stream, random_stream)


def edge_stream():
    """Hand-built stream over 4 servers of 8 cores.  v0 migrates twice (the
    second MIGRATE returns its pool to the recorded pod again: used pool
    goes negative); v1's pool is large, so where it is short v1 is placed
    by the fallback and its MIGRATE pays the server's first listed pod (or
    nothing on an orphan server); v2 fills a server and needs no pool (no
    grant); v3 finds its server's first pod full in tight lanes and takes
    the second; v4 is larger than a server (a reject whose DEPART finds an
    empty slot); v5 reuses a freed slot and migrates; PAD, FAIL and RECOVER
    in between.  Which branch a lane takes depends on its capacities and
    incidence: see :func:`edge_lanes`."""
    vms = [(0.0, 100.0, 2, 2, 4, (10.0, 20.0)),
           (1.0, 100.0, 2, 2, 9, (15.0,)),
           (2.0, 50.0, 8, 4, 0, None),
           (3.0, 60.0, 2, 2, 3, None),
           (4.0, 30.0, 16, 4, 4, None),
           (5.0, 80.0, 2, 1, 5, (6.0, 40.0)),
           (55.0, 90.0, 2, 1, 2, (56.0,)),
           (57.0, 95.0, 4, 2, 6, None)]
    noops = [(0.5, PAD), (3.0, FAIL), (25.0, RECOVER), (55.0, PAD)]
    return compile_stream(vms, noops)


#: the edge stream's cluster: 4 servers of 8 cores, 4 pods, rows of 2
EDGE_SHAPE = dict(n_servers=4, cores=8, n_pods=4, fanout=2)


def edge_lanes():
    """``(sgb (C,), pgb (C, 4), inc (C, 4, 2))`` for :func:`edge_stream`:
    ample room (pod 3 reached by server 3 alone); a tight first pod (v3
    takes the second listed); no pool (every pooled VM falls back, each
    MIGRATE pays the first listed pod: used pool goes negative); orphan
    servers 0 and 3 (their fallback VMs' MIGRATEs pay nothing); one pod
    reached by all, pods 1-3 with no member and ample capacity (inert);
    nothing fits; local memory too small to take a MIGRATE; all orphans."""
    overlap = [[0, 1], [1, 2], [2, 0], [3, -1]]
    tight = [[0, 1], [0, 1], [1, 0], [1, -1]]
    orphans = [[-1, -1], [1, 0], [0, -1], [-1, -1]]
    one = [[0, -1]] * 4
    lanes = [(64, (64, 64, 64, 64), overlap),
             (64, (4, 8, 0, 0), tight),
             (16, (0, 0, 0, 0), overlap),
             (16, (8, 8, 0, 0), orphans),
             (64, (5, 100, 100, 100), one),
             (0, (0, 0, 0, 0), overlap),
             (5, (64, 64, 64, 64), tight),
             (64, (64, 64, 64, 64), [[-1, -1]] * 4)]
    sgb = np.array([x[0] for x in lanes], np.int64)
    pgb = np.array([x[1] for x in lanes], np.int64)
    inc = np.array([x[2] for x in lanes], np.int32)
    return sgb, pgb, inc


def bounds_stream():
    """Two servers of 64 cores for int16 state at its bounds: v0 and v1
    take 3,000 GB of pool each; six VMs of 3,000 GB that arrive next find
    small pods taken and are placed by the fallback (best fit packs them on
    one server, up to 24,800 of its 26,900 GB), and those whose server has
    room migrate (each pays its server's first pod: used pool negative);
    then four more pooled VMs arrive.  The largest capacity plus the
    largest payload is 30,000 = ``I16_SAFE`` (server 26,900 + 3,100, pod
    27,000 + 3,000), and the migrate-event pool 18,000 + 3,000:
    ``pick_pod_state_dtype`` keeps int16.  See :data:`BOUNDS_LANES`."""
    vms = [(0.0, 900.0, 4, 100, 3000, None),
           (1.0, 900.0, 4, 100, 3000, None)]
    vms += [(10.0 + i, 800.0, 4, 100, 3000, (100.0 + i,)) for i in range(6)]
    vms += [(200.0 + i, 700.0, 2, 100, 3000, None) for i in range(4)]
    return compile_stream(vms)


#: (sgb, pgb (2,), inc (2, 1)) lanes for :func:`bounds_stream`: a pod a
#: server, both small; one pod for both; two ample pods
BOUNDS_LANES = ((26900, (3000, 3000), ((0,), (1,))),
                (26900, (6000, 0), ((0,), (0,))),
                (26900, (27000, 27000), ((1,), (0,))))
BOUNDS_SHAPE = dict(n_servers=2, cores=64, n_pods=2, fanout=1)


def bounds_lanes():
    sgb = np.array([x[0] for x in BOUNDS_LANES], np.int64)
    pgb = np.array([x[1] for x in BOUNDS_LANES], np.int64)
    inc = np.array([x[2] for x in BOUNDS_LANES], np.int32)
    return sgb, pgb, inc


#: pod ids up to the int16 bound (``pick_pod_state_dtype`` keeps int16
#: below 2^14 pods): servers reach pods near the top of the range
POD_BOUND_PODS = I16_BIG - 1


def pod_bound_lanes(rng, n_lanes: int, n_servers: int, cores: int):
    """Lanes over :data:`POD_BOUND_PODS` pods whose rows list the highest
    ids (and a few low ones), capacities for a random stream."""
    top = POD_BOUND_PODS - 1 - np.arange(n_servers)
    inc = np.stack([top, top // 7], 1).astype(np.int32)
    inc = np.repeat(inc[None], n_lanes, 0)
    sgb, pool = random_capacities(rng, n_lanes, cores)
    pgb = np.zeros((n_lanes, POD_BOUND_PODS), np.int64)
    for i in range(n_lanes):
        pgb[i, np.unique(inc[i])] = pool[i] // 4
    return sgb, pgb, inc


def random_capacities(rng, n_lanes: int, cores: int):
    """(sgb, total pool) int arrays: from no memory to more than any VM of
    :func:`random_stream` needs, zero-pool and tight-pool lanes among them
    (within the int16 packing rules)."""
    per = cores * 8
    sgb = rng.integers(0, per + 1, n_lanes)
    pool = rng.integers(0, per * 4 + 1, n_lanes)
    pool[::4] = 0
    sgb[1::5] = per * 2
    return sgb.astype(np.int64), pool.astype(np.int64)


def random_topology(rng, n_servers: int, max_fanout: int):
    """A seeded topology of one of the families the fleet study prices:
    partitioned, single pool, overlapping, sparse (orphans allowed)."""
    pod_size = int(rng.integers(1, max(2, n_servers // 2) + 1))
    fanout = int(rng.integers(1, max_fanout + 1))
    pick = int(rng.integers(4))
    if pick == 0:
        return topology.partitioned(n_servers, pod_size)
    if pick == 1:
        return topology.single_pool(n_servers)
    if pick == 2:
        return topology.overlapping(n_servers, pod_size, fanout)
    n_pods = int(rng.integers(1, max(2, n_servers // 2) + 1))
    return topology.sparse(n_servers, n_pods, fanout,
                           seed=int(rng.integers(2 ** 31)),
                           allow_orphans=bool(rng.integers(2)))


def random_lanes(rng, n_lanes: int, n_servers: int, cores: int,
                 max_fanout: int = 3):
    """``(sgb (C,), pgb (C, P), inc (C, S, F))`` for ``n_lanes`` lanes,
    each its own seeded topology (mixed families and fanouts in one
    launch; P and F the largest), each lane's total pool split over its
    pods by ``topology.split_pool``."""
    topos = [random_topology(rng, n_servers, max_fanout)
             for _ in range(n_lanes)]
    sgb, pool = random_capacities(rng, n_lanes, cores)
    n_pods = max(t.n_pods for t in topos)
    fanout = max(t.fanout for t in topos)
    pgb = np.zeros((n_lanes, n_pods), np.int64)
    inc = np.full((n_lanes, n_servers, fanout), -1, np.int32)
    for i, t in enumerate(topos):
        pgb[i, :t.n_pods] = topology.split_pool(float(pool[i]), t.n_pods)
        inc[i, :, :t.inc.shape[1]] = t.inc
    return sgb, pgb, inc


def table_stream():
    """Hand-built stream over 64 servers of 8 cores (two a thread, K 2) for
    the kernel's table of a thread's distinct pods.  v0-v3 each fill a
    whole server (best fit takes servers 0, 1, 2, 3 in turn); each is
    migrated later, and v0 and v2 leave early, returning their pool.  See
    :func:`table_lanes` for the rows and capacities."""
    vms = [(0.0, 50.0, 8, 1, 2, (30.0,)),
           (1.0, 90.0, 8, 1, 2, (35.0,)),
           (2.0, 40.0, 8, 1, 2, (36.0,)),
           (3.0, 95.0, 8, 1, 2, (37.0,)),
           (4.0, 80.0, 4, 1, 3, None),
           (60.0, 85.0, 8, 1, 2, None),
           (61.0, 86.0, 8, 1, 2, (70.0,))]
    return compile_stream(vms, [(10.0, PAD), (20.0, FAIL), (21.0, RECOVER)])


#: the table stream's cluster: 64 servers of 8 cores, 8 pods, rows of 2
TABLE_SHAPE = dict(n_servers=64, cores=8, n_pods=8, fanout=2)


def table_lanes():
    """``(sgb (C,), pgb (C, 8), inc (C, 64, 2))`` for :func:`table_stream`.
    Thread 0 owns servers 0 and 1, which list pods 0 and 1 in opposite
    order (its table: 0, then 1), so with both pods roomy v0 is granted pod
    0 and v1 pod 1; thread 1's servers 2 and 3 list pods 1, 2 and 2, 1, so
    pod 1 has a copy in two threads' tables, granted by v1 and v2 and
    returned by v2's DEPART.  Servers 4-63 list pods 3-7 (one or two).
    Lanes: every pod roomy; pod 1 with room for one VM (v2 then takes pod
    2); no pool anywhere, so every pooled VM is placed by the fallback and
    each MIGRATE pays its server's FIRST listed pod (v1 on server 1: pod
    1, the second entry of thread 0's table); pod 0 alone empty (v0 takes
    pod 1 on server 0, its second listed); local memory too small to
    migrate."""
    inc = np.full((TABLE_SHAPE["n_servers"], 2), -1, np.int32)
    inc[:4] = [[0, 1], [1, 0], [1, 2], [2, 1]]
    rest = np.arange(4, TABLE_SHAPE["n_servers"])
    inc[4:, 0] = 3 + rest % 5
    inc[4::2, 1] = 3 + (rest[::2] + 2) % 5
    lanes = [(64, (64,) * 8),
             (64, (64, 2, 64, 64, 64, 64, 64, 64)),
             (64, (0,) * 8),
             (64, (0, 64, 64, 64, 64, 64, 64, 64)),
             (2, (64,) * 8)]
    sgb = np.array([x[0] for x in lanes], np.int64)
    pgb = np.array([x[1] for x in lanes], np.int64)
    return sgb, pgb, np.repeat(inc[None], len(lanes), 0)


def wide_lanes(rng, n_lanes: int, n_servers: int, cores: int,
               n_distinct: int):
    """``(sgb, pgb, inc)`` over ``n_distinct + 32`` pods whose every
    thread (``k`` servers, K1's ``servers_per_thread``) lists exactly
    ``n_distinct <= 3 k`` distinct pods: thread t's servers list, in rows
    of three, pods t, t + 1, ..., t + n_distinct - 1 cyclically, so
    neighbouring threads share pods; a random total pool split over the
    pods."""
    from repro_torch.kernels.event_sweep.kernel import servers_per_thread
    k = servers_per_thread(n_servers)
    srv = np.arange(n_servers)
    t, j = srv // k, srv % k
    q = np.arange(3)
    # thread t's entries run over n_distinct pods of its own window
    local = (j[:, None] * 3 + q[None, :]) % n_distinct
    n_pods = n_distinct + 32
    inc = ((t[:, None] + local) % n_pods).astype(np.int32)
    inc = np.repeat(inc[None], n_lanes, 0)
    sgb, pool = random_capacities(rng, n_lanes, cores)
    pgb = np.stack([topology.split_pool(float(x), n_pods) for x in pool])
    return sgb, pgb.astype(np.int64), inc


def aligned_lanes(rng, n_lanes: int, n_servers: int, cores: int):
    """``(sgb, pgb, inc)`` whose every thread lists one pod: partitioned
    pods of a whole thread's servers (or more) and one pool, so a launch
    takes the one-entry table build."""
    from repro_torch.kernels.event_sweep.kernel import servers_per_thread
    k = servers_per_thread(n_servers)
    topos = [topology.partitioned(n_servers, k * 2 ** (i % 3))
             if i % 4 else topology.single_pool(n_servers)
             for i in range(n_lanes)]
    sgb, pool = random_capacities(rng, n_lanes, cores)
    n_pods = max(x.n_pods for x in topos)
    pgb = np.zeros((n_lanes, n_pods), np.int64)
    inc = np.stack([x.inc for x in topos]).astype(np.int32)
    for i, x in enumerate(topos):
        pgb[i, :x.n_pods] = topology.split_pool(float(pool[i]), x.n_pods)
    return sgb, pgb, inc
