"""Event streams that reach every branch of the failure sweep, for holding
K5 against its plain version (``chip_smoke.py``) and the plain version
against the reference's scan (``tests/test_torch_fail_sweep.py``).

A stream is compiled the way ``core/replay_engine.py::CompiledReplay``
compiles a trace with a failure schedule — per VM (arrival, ARRIVE),
(t_migrate, MIGRATE)?, (departure, DEPART), the schedule's FAIL/RECOVER
events (VM 0's slot and payload, their domain in ``dmn``), then one stable
sort by (time, kind), so a failure sorts after same-time VM events — with
``x`` the departure minute at ARRIVE and the failure minute at FAIL.
"""
from __future__ import annotations

import math

import numpy as np

from repro_torch.core.sweep_core import (ARRIVE, DEPART, FAIL, MIGRATE, PAD,
                                         RECOVER, assign_slots)
from repro_torch.kernels.event_sweep.cases import (  # noqa: F401
    EVENT_KEYS, lane_capacities)
from repro_torch.runtime.fault import FailureSchedule

FAIL_EVENT_KEYS = EVENT_KEYS + ("x", "dmn")


def compile_fail_stream(vms, failures, x_override=None):
    """``vms``: rows ``(arrival, departure, cores, local, pool, t_migrate
    or None)``, mem = local + pool; ``failures``: rows ``(time, domain,
    recover)``; ``x_override``: {VM index: departure minute} set in place
    of the VM's own at its ARRIVE (to reach the lost-minutes clamp).
    Returns ``(events, n_slots)``: eight int32 arrays keyed by
    :data:`FAIL_EVENT_KEYS` and the slot count."""
    times, kinds, vmx, doms = [], [], [], []
    for v, (arr, dep, _, _, _, t_mig) in enumerate(vms):
        times.append(arr), kinds.append(ARRIVE), vmx.append(v)
        if t_mig is not None:
            times.append(t_mig), kinds.append(MIGRATE), vmx.append(v)
        times.append(dep), kinds.append(DEPART), vmx.append(v)
    doms = [-1] * len(times)
    for t, d, rec in failures:
        times.append(t), kinds.append(RECOVER if rec else FAIL)
        vmx.append(0), doms.append(d)
    times, kinds, vmx, doms = (np.asarray(times, float), np.asarray(kinds),
                               np.asarray(vmx), np.asarray(doms))
    order = np.lexsort((kinds, times))
    times, kinds, vmx, doms = (times[order], kinds[order], vmx[order],
                               doms[order])
    slot, n_slots = assign_slots(kinds.tolist(), vmx.tolist(), len(vms))
    rows = np.asarray([r[2:5] for r in vms], np.int64)
    cols = rows[vmx]
    dep_min = np.array([math.floor(r[1] / 60.0) for r in vms], np.int64)
    for v, minute in (x_override or {}).items():
        dep_min[v] = minute
    x = np.where(kinds == ARRIVE, dep_min[vmx],
                 np.where(kinds == FAIL, np.floor(times / 60.0), 0))
    events = dict(kind=kinds, slot=slot, cores=cols[:, 0], local=cols[:, 1],
                  pool=cols[:, 2], mem=cols[:, 1] + cols[:, 2], x=x,
                  dmn=doms)
    return {k: np.asarray(a, np.int32) for k, a in events.items()}, n_slots


def edge_stream():
    """Hand-built stream over 4 servers of 16 cores, two domains (servers
    0-1, 2-3).  FAIL(0) at 120 s meets: a pooled VM on each server of the
    domain (v0 on server 0, v4 on server 1), a VM with no pool (v1), a VM
    QoS-migrated before it (v2), one departing at the failure instant (v3),
    and a fallback-placed VM (v5, in lanes whose pool is short); lane 0
    remigrates server 0 exactly to its capacity (12 + 4 = 16 GB), lane 1
    misses there by 1 GB while server 1 fits.  While domain 0 is down a
    pooled arrival takes domain 1 (v6) or, where its pool is short, falls
    back onto domain 0's servers all-local (v7).  FAIL(1) at 200 s kills or
    remigrates v6 and v8, whose departure minute is set below the failure
    minute (lost minutes clamp at 0).  FAIL(0) at 1,500 s finds nothing
    pooled; v9 reuses a freed slot and is hit by FAIL(0) at 2,500 s.  Ties
    in free cores go to the lowest server.  See :data:`EDGE_LANES`."""
    vms = [(0.0, 6000.0, 4, 2, 4, None),      # v0: pooled, server 0
           (10.0, 6000.0, 4, 2, 0, None),     # v1: no pool
           (20.0, 6000.0, 4, 2, 6, 50.0),     # v2: QoS-migrated at 50 s
           (30.0, 120.0, 4, 2, 4, None),      # v3: leaves at the FAIL
           (40.0, 6000.0, 8, 3, 5, None),     # v4: pooled, server 1
           (45.0, 6000.0, 2, 1, 20, None),    # v5: fallback where short
           (130.0, 6000.0, 2, 1, 3, None),    # v6: arrives, domain 0 down
           (140.0, 6000.0, 2, 1, 3, None),    # v7: its fallback
           (150.0, 6000.0, 2, 1, 2, None),    # v8: x below the FAIL's
           (2000.0, 7000.0, 6, 2, 7, None)]   # v9: reuses a slot
    failures = [(120.0, 0, False), (200.0, 1, False), (1000.0, 0, True),
                (1100.0, 1, True), (1500.0, 0, False), (1600.0, 0, True),
                (2500.0, 0, False)]
    return compile_fail_stream(vms, failures, x_override={8: 1})


#: (sgb, pgb) lanes for :func:`edge_stream`: remigrate fits exactly; misses
#: by 1 GB on server 0, fits on server 1; a short pool (fallbacks); ample
#: room; nothing fits; no pool (no VM holds pool, no FAIL affects any);
#: domain 1's pool taken by v6 (v7 falls back onto domain 0).
EDGE_LANES = ((16, 32), (15, 32), (64, 16), (64, 64), (0, 0), (16, 0),
              (64, 3))
EDGE_SHAPE = dict(n_servers=4, spg=2, cores=16)


def demand_stream():
    """Two servers of 64 cores in one domain, for int16 state: FAIL(0)
    remigrates two VMs of 5,000 GB pool on server 0 (which fills its
    cores); their QoS MIGRATEs after it take the oracle's quirk and drive
    used pool to -10,000; seven VMs of 5,000 GB then fit the 25,000 GB pool
    on server 1, and at the second FAIL(0) server 1's affected demand is
    35,000 GB, past 2^15: summed in int32 it does not fit the 30,000 GB
    server, so they are killed (an int16 sum would wrap and remigrate
    them).  See :data:`DEMAND_LANES`."""
    vms = [(0.0, 9000.0, 32, 1, 5000, 300.0),
           (1.0, 9000.0, 32, 1, 5000, 301.0)]
    vms += [(400.0 + i, 9000.0, 4, 1, 5000, None) for i in range(7)]
    failures = [(100.0, 0, False), (200.0, 0, True), (1000.0, 0, False)]
    return compile_fail_stream(vms, failures)


DEMAND_LANES = ((30000, 25000), (30000, 25000))
DEMAND_SHAPE = dict(n_servers=2, spg=2, cores=64)


def refail_stream():
    """Hand-built stream over :data:`EDGE_SHAPE` (4 servers of 16 cores,
    domains 0-1 and 2-3) for a domain that fails twice: FAIL(0) at 100 s
    hits v0 and v2 on server 0 and v3 on server 1; v1 on server 0 holds no
    pool, so it is never affected.  v2 and v3 depart right after the FAIL
    (killed or remigrated); v4, with no pool, arrives while domain 0 is
    down and takes server 0 by the pooled test; after RECOVER(0) v5 takes
    pool on server 0 between the two FAILs of domain 0, and departs right
    after the second; v0's QoS MIGRATE at 300 s comes after it was
    remigrated (the reference's quirk: local grows again and used pool
    goes negative), and the second FAIL(0) leaves it alone.  See
    :data:`REFAIL_LANES`."""
    vms = [(0.0, 1000.0, 4, 2, 4, 300.0),     # v0: remigrated, MIGRATE later
           (10.0, 1000.0, 4, 2, 0, None),     # v1: no pool, server 0
           (20.0, 101.0, 4, 3, 5, None),      # v2: departs after the FAIL
           (30.0, 102.0, 8, 2, 6, None),      # v3: server 1, the same
           (150.0, 1000.0, 2, 1, 0, None),    # v4: no pool, domain 0 down
           (250.0, 401.0, 2, 1, 3, None)]     # v5: between the two FAILs
    failures = [(100.0, 0, False), (200.0, 0, True), (400.0, 0, False)]
    return compile_fail_stream(vms, failures)


#: (sgb, pgb) lanes for :func:`refail_stream`: both servers remigrate;
#: server 0 (7 GB local and 9 GB affected) kills while server 1 remigrates;
#: every server kills; ample room; v0 short of pool (its fallback is
#: migrated from the start).
REFAIL_LANES = ((16, 32), (12, 32), (7, 32), (64, 64), (16, 3))


def late_stream():
    """Two servers of 64 cores in one domain, for int16 state: three pooled
    VMs on server 0 leave in minutes 40,000, 33,000 and 70,000 (past
    int16's range, the last past 2^16, as in a trace of several weeks);
    FAIL(0) in minute 10 remigrates them (12 GB free: 6 GB local used and
    9 GB affected fit 16 GB) or kills them (14 GB), and then the kill's
    lost VM-minutes, 142,970, need the departure minutes in int32.  See
    :data:`LATE_LANES`."""
    vms = [(0.0, 2_400_000.0, 4, 2, 4, None),
           (1.0, 1_980_000.0, 4, 2, 2, None),
           (2.0, 4_200_000.0, 4, 2, 3, None)]
    failures = [(600.0, 0, False), (1200.0, 0, True)]
    return compile_fail_stream(vms, failures)


#: (sgb, pgb) lanes for :func:`late_stream`: remigrate fits; it does not
#: (all three killed); no pool (all fall back, none affected).
LATE_LANES = ((16, 32), (14, 32), (16, 0))


def random_schedule(rng, horizon: float, n_domains: int, mtbf: float,
                    repair: float):
    """``(time, domain, recover)`` rows of a ``FailureSchedule.generate``
    schedule, seeded from ``rng``."""
    sched = FailureSchedule.generate(horizon, n_domains, mtbf, repair,
                                     seed=int(rng.integers(2 ** 31)))
    return list(zip(sched.times.tolist(), sched.domains.tolist(),
                    sched.recovers.tolist()))


def random_fail_stream(rng, n_vms: int, n_groups: int,
                       mig_frac: float = 0.2, mtbf_frac: float = 0.15,
                       max_cores: int = 32):
    """``n_vms`` seeded VMs as ``event_sweep.cases.random_stream`` makes
    them (2..max_cores cores, 2/4/8 GB a core, a random pool share, some
    QoS migrations), whole minutes apart so that departure and failure
    minutes differ, and a random failure schedule over ``n_groups``
    domains (mean time between failures ``mtbf_frac`` of the horizon, a
    repair of 40 minutes), with PAD events mixed in."""
    arr = np.sort(rng.integers(0, n_vms * 3, n_vms)) * 60.0
    life = rng.integers(2, 240, n_vms) * 60.0
    cores = rng.choice([c for c in (2, 4, 8, 16, 32, 48) if c <= max_cores],
                       n_vms)
    mem = cores * rng.choice([2, 4, 8], n_vms)
    pool = np.floor(mem * rng.uniform(0.0, 0.6, n_vms)).astype(np.int64)
    mig = rng.random(n_vms) < mig_frac
    vms = []
    for i in range(n_vms):
        t_mig = arr[i] + 60.0 if mig[i] and 60.0 < life[i] else None
        vms.append((arr[i], arr[i] + life[i], int(cores[i]),
                    int(mem[i] - pool[i]), int(pool[i]), t_mig))
    horizon = float(arr[-1] + 60.0)
    failures = random_schedule(rng, horizon, n_groups, mtbf_frac * horizon,
                               2400.0)
    events, n_slots = compile_fail_stream(vms, failures)
    # PADs (no-ops) at random places, VM 0's slot and payload
    n_pad = max(1, n_vms // 20)
    at = np.sort(rng.integers(0, len(events["kind"]) + 1, n_pad))
    for k in FAIL_EVENT_KEYS:
        fill = PAD if k == "kind" else (-1 if k == "dmn" else
                                        int(events[k][0]))
        events[k] = np.insert(events[k], at, fill).astype(np.int32)
    return events, n_slots
