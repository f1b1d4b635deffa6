"""Event streams that reach every branch of the sweep, for holding K1
against its plain version (``chip_smoke.py``) and the plain version
against the reference's scan (``tests/test_torch_event_sweep.py``).

A stream is compiled the way ``core/replay_engine.py::CompiledReplay``
compiles a trace — per VM (arrival, ARRIVE), (t_migrate, MIGRATE)?,
(departure, DEPART), then one stable sort by (time, kind) — with PAD,
FAIL and RECOVER events mixed in (they carry VM 0's slot and payloads,
as the reference's failure events do, and must change nothing).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.sweep_core import (ARRIVE, DEPART, FAIL, MIGRATE, PAD,
                                         RECOVER, assign_slots)

EVENT_KEYS = ("kind", "slot", "cores", "local", "pool", "mem")


def compile_stream(vms, noops=()):
    """``vms``: rows ``(arrival, departure, cores, local, pool, t_migrate
    or None)``, mem = local + pool (``t_migrate`` may also be a tuple of
    times: a VM migrated more than once, which the pod sweep's quirk
    tests); ``noops``: ``(time, kind)`` pairs.  Returns ``(events,
    n_slots)``: six int32 arrays keyed by :data:`EVENT_KEYS` and the slot
    count."""
    times, kinds, vmx = [], [], []
    for v, (arr, dep, _, _, _, t_mig) in enumerate(vms):
        times.append(arr), kinds.append(ARRIVE), vmx.append(v)
        for t in () if t_mig is None else np.atleast_1d(t_mig):
            times.append(t), kinds.append(MIGRATE), vmx.append(v)
        times.append(dep), kinds.append(DEPART), vmx.append(v)
    for t, k in noops:
        times.append(t), kinds.append(k), vmx.append(0)
    times, kinds, vmx = (np.asarray(times, float), np.asarray(kinds),
                         np.asarray(vmx))
    order = np.lexsort((kinds, times))
    kinds, vmx = kinds[order], vmx[order]
    slot, n_slots = assign_slots(kinds.tolist(), vmx.tolist(), len(vms))
    rows = np.asarray([r[2:5] for r in vms], np.int64)
    cols = rows[vmx]
    events = dict(kind=kinds, slot=slot, cores=cols[:, 0],
                  local=cols[:, 1], pool=cols[:, 2],
                  mem=cols[:, 1] + cols[:, 2])
    return {k: np.asarray(a, np.int32) for k, a in events.items()}, n_slots


def edge_stream():
    """Hand-built stream over 3 servers of 8 cores (groups 0, 0, 1): a tie
    in free cores, pool-backed and all-local placements, a MIGRATE on a
    pool-backed VM and one on a VM that may have been placed by the
    fallback, a VM too large to place whose DEPART finds an empty slot,
    and PAD/FAIL/RECOVER in between.  Which branch a lane takes depends on
    its (sgb, pgb): see :data:`EDGE_LANES`."""
    vms = [(0.0, 50.0, 2, 4, 4, 10.0),     # MIGRATE while placed
           (1.0, 40.0, 2, 4, 4, None),     # ties with VM 0's server
           (2.0, 30.0, 8, 6, 2, 5.0),      # a whole server; MIGRATE
           (3.0, 20.0, 16, 8, 0, None),    # larger than a server: reject
           (4.0, 60.0, 4, 2, 6, 45.0),     # MIGRATE after 0 and 1 left
           (60.0, 70.0, 2, 4, 4, None)]    # reuses a freed slot
    noops = [(0.5, PAD), (3.0, FAIL), (25.0, RECOVER), (60.0, PAD)]
    return compile_stream(vms, noops)


#: (sgb, pgb) lanes for :func:`edge_stream`: ample room; no pool (every
#: pooled VM falls back all-local, its MIGRATE drives used pool negative);
#: pool too small for some; local memory too small to take a MIGRATE;
#: nothing fits.
EDGE_LANES = ((64, 64), (16, 0), (12, 5), (10, 16), (0, 0))


def random_stream(rng, n_vms: int, mig_frac: float = 0.2,
                  noop_frac: float = 0.05, max_cores: int = 32):
    """``n_vms`` seeded VMs of 2..max_cores cores, 2/4/8 GB a core, a
    static-like random pool share, lifetimes that keep ~40 alive;
    ``mig_frac`` of them get ``t_migrate = arrival + 60`` (dropped when
    it falls outside their life, as ``CompiledReplay`` drops it), and
    no-op events are mixed in."""
    arr = np.sort(rng.uniform(0, n_vms * 30.0, n_vms))
    life = rng.uniform(50.0, 2400.0, n_vms)
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
    n_noop = int(noop_frac * 2 * n_vms)
    noops = list(zip(rng.uniform(0, arr[-1], n_noop),
                     rng.choice([PAD, FAIL, RECOVER], n_noop)))
    return compile_stream(vms, noops)


def lane_capacities(rng, n_lanes: int, n_servers: int, cores: int):
    """(sgb, pgb) int arrays for ``n_lanes`` candidates: from no memory to
    more than any VM needs, with zero-pool and tight-pool lanes among them
    (every value within the int16 packing rules)."""
    per = cores * 8
    sgb = rng.integers(0, per + 1, n_lanes)
    pgb = rng.integers(0, per * max(1, n_servers // 4) + 1, n_lanes)
    pgb[::4] = 0
    sgb[1::5] = per * 2
    return sgb.astype(np.int64), pgb.astype(np.int64)
