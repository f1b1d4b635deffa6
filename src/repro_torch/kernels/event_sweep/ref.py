"""Plain PyTorch version of the event sweep (the kernel's oracle, and what
the wrapper runs for CPU tensors).

A transcription of the reference's scan step
(``src/repro/core/sweep_core.py::build_sweep``, ``body``): a Python loop
over the events, each step tensor ops over (lanes, servers).  The event
kind is the same for every lane, so the loop branches on it on the host
(the event arrays are read to the host once); every other quantity stays
a tensor on the state's device.  ``torch.argmin`` returns the first
minimum, as ``jnp.argmin`` and the scalar oracle's best fit do.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.sweep_core import (ARRIVE, DEPART, I16_BIG, I32_BIG,
                                         MIGRATE)


def event_sweep_ref(kind, slot, cores, local, pool, mem, group_of, fc, um,
                    up, slots, sgb, pgb, rejects, trace_starts=None,
                    trace_counts=None):
    """The kernel's contract: events are six int32 (E,) tensors, group_of
    (S,) int32, state fc/um (C,S), up (C,G), slots (n_slots,C), capacities
    sgb/pgb (C,) in the state dtype (int16 or int32), rejects (C,) int32.
    Runs every event, writes the final state into fc, um, up, slots and
    rejects in place, and returns ``rejects``.

    The trace axis: with ``trace_starts``/``trace_counts`` (T ints each)
    the arrays hold T streams, trace t's events at rows ``[trace_starts[t],
    trace_starts[t] + trace_counts[t])``, and the C lanes are trace-major,
    C / T a trace; each trace's lanes replay its own stream (views of the
    state, written in place)."""
    if trace_starts is None:
        return _sweep_one(kind, slot, cores, local, pool, mem, group_of, fc,
                          um, up, slots, sgb, pgb, rejects)
    n = fc.shape[0] // len(trace_starts)
    for t, (e0, count) in enumerate(zip(trace_starts, trace_counts)):
        ev = (a[e0:e0 + count] for a in (kind, slot, cores, local, pool,
                                          mem))
        lanes = slice(t * n, (t + 1) * n)
        _sweep_one(*ev, group_of, fc[lanes], um[lanes], up[lanes],
                   slots[:, lanes], sgb[lanes], pgb[lanes], rejects[lanes])
    return rejects


def _sweep_one(kind, slot, cores, local, pool, mem, group_of, fc, um, up,
               slots, sgb, pgb, rejects):
    """One stream for every lane (the reference's scan step, event after
    event); the state arguments may be views, written through."""
    dt = fc.dtype
    np_dt = np.int16 if dt == torch.int16 else np.int32
    big = I16_BIG if dt == torch.int16 else I32_BIG
    # payloads cast to the state dtype, as the reference's c.astype(dt)
    kinds = kind.cpu().numpy().tolist()
    sls = slot.cpu().numpy().tolist()
    pay = [a.cpu().numpy().astype(np_dt).tolist()
           for a in (cores, local, pool, mem)]
    rows = torch.arange(fc.shape[0], device=fc.device)
    grp = group_of.long()
    sgb_c, pgb_c = sgb[:, None], pgb[:, None]
    for e, k in enumerate(kinds):
        if k not in (ARRIVE, DEPART, MIGRATE):      # PAD, FAIL, RECOVER
            continue
        sl = sls[e]
        c, l, p, m = (a[e] for a in pay)
        if k == ARRIVE:
            fits = fc >= c
            ok1 = fits & (um + l <= sgb_c) & (up[:, grp] + p <= pgb_c)
            score1 = torch.where(ok1, fc, big)
            s1 = torch.argmin(score1, 1)
            feas1 = score1[rows, s1] < big
            # pool short -> control-plane fallback: start the VM all-local
            score2 = torch.where(fits & (um + m <= sgb_c), fc, big)
            s2 = torch.argmin(score2, 1)
            feas2 = score2[rows, s2] < big
            sel = torch.where(feas1, s1, s2)
            place = feas1 | feas2
            fc[rows, sel] -= place.to(dt) * c
            um[rows, sel] += place.to(dt) * torch.where(feas1, l, m).to(dt)
            up[rows, grp[sel]] += (place & feas1).to(dt) * p
            slots[sl] = torch.where(place, sel * 2 + (~feas1).long(),
                                    -1).to(dt)
            rejects += (~place).to(torch.int32)
            continue
        val = slots[sl]
        has = val >= 0
        s_cur = torch.where(has, val >> 1, 0).long()
        if k == DEPART:
            mg = has & ((val & 1) == 1)
            fc[rows, s_cur] += has.to(dt) * c
            um[rows, s_cur] -= has.to(dt) * torch.where(mg, m, l).to(dt)
            up[rows, grp[s_cur]] -= (has & ~mg).to(dt) * p
            slots[sl] = -1
        else:                                       # MIGRATE: pool -> local
            act = has & (um[rows, s_cur] + p <= sgb)
            um[rows, s_cur] += act.to(dt) * p
            up[rows, grp[s_cur]] -= act.to(dt) * p
            slots[sl] = torch.where(act, val | 1, val)
    return rejects
