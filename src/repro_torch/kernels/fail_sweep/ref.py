"""Plain PyTorch version of the failure sweep (the kernel's oracle, and what
the wrapper runs for CPU tensors).

A transcription of the reference's scan step
(``src/repro/core/sweep_core.py::build_fail_sweep``, ``body``): K1's plain
version (``kernels/event_sweep/ref.py``) with the failure model — a
pool-bearing arrival skips the servers of a down domain; at ``FAIL(d)`` the
blast radius over the whole (slots, lanes) placement array, vectorised
over lanes and servers; ``RECOVER(d)`` brings the domain back.  The event
kind is the same for every lane, so the loop branches on it on the host.
Each slot's payload (cores, local, pool, departure minute) is the same in
every lane and is recorded at ARRIVE in host arrays, as the reference's
carry records it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.sweep_core import (ARRIVE, DEPART, FAIL, I16_BIG,
                                         I32_BIG, MIGRATE, RECOVER)

#: the rows of the (5, C) int32 counters
COUNTERS = ("rejects", "affected", "killed", "remigrated", "lost_minutes")


def fail_sweep_ref(kind, slot, cores, local, pool, mem, x, dmn, group_of, fc,
                   um, up, slots, down, sgb, pgb, out, dist=None, *,
                   remigrate: bool, trace_starts=None, trace_counts=None):
    """The kernel's contract: events are eight int32 (E,) tensors (``x``
    the departure minute at ARRIVE and the failure minute at FAIL, ``dmn``
    the domain at FAIL and RECOVER), group_of (S,) int32, state fc/um
    (C,S), up (C,G), slots (n_slots,C), capacities sgb/pgb (C,) in the
    state dtype (int16 or int32), ``down`` (C,G) int32 down flags, ``out``
    (5,C) int32 counters (:data:`COUNTERS`, added to) and ``dist`` None or
    (n_dist,C) int32, whose row f takes the affected count of the f-th
    FAIL.  The slots start empty.  Runs every event, writes the final state
    into fc, um, up, slots, down and the counters in place; returns
    ``out``.

    The trace axis (``trace_starts``/``trace_counts``) is K1's: T streams
    in the arrays, the C lanes trace-major; ``dist`` takes one trace."""
    if trace_starts is None:
        return _sweep_one(kind, slot, cores, local, pool, mem, x, dmn,
                          group_of, fc, um, up, slots, down, sgb, pgb, out,
                          dist, remigrate)
    n = fc.shape[0] // len(trace_starts)
    for t, (e0, count) in enumerate(zip(trace_starts, trace_counts)):
        ev = (a[e0:e0 + count] for a in (kind, slot, cores, local, pool,
                                          mem, x, dmn))
        lanes = slice(t * n, (t + 1) * n)
        _sweep_one(*ev, group_of, fc[lanes], um[lanes], up[lanes],
                   slots[:, lanes], down[lanes], sgb[lanes], pgb[lanes],
                   out[:, lanes], dist if len(trace_starts) == 1 else None,
                   remigrate)
    return out


def _scatter(shape, lanes, srv, vals):
    """(C, S) int32 sums of ``vals`` (n_slots, C) at (lane, server)."""
    acc = torch.zeros(shape, dtype=torch.int32, device=vals.device)
    return acc.index_put_((lanes, srv), vals, accumulate=True)


def _sweep_one(kind, slot, cores, local, pool, mem, x, dmn, group_of, fc, um,
               up, slots, down, sgb, pgb, out, dist, remigrate):
    """One stream for every lane (the reference's scan step, event after
    event); the state arguments may be views, written through."""
    dt = fc.dtype
    np_dt = np.int16 if dt == torch.int16 else np.int32
    big = I16_BIG if dt == torch.int16 else I32_BIG
    dev = fc.device
    kinds = kind.cpu().numpy().tolist()
    sls = slot.cpu().numpy().tolist()
    raw = [a.cpu().numpy() for a in (cores, local, pool, x, dmn)]
    xs, dmns = raw[3].tolist(), raw[4].tolist()
    # payloads cast to the state dtype, as the reference's c.astype(dt)
    pay = [a.cpu().numpy().astype(np_dt).tolist()
           for a in (cores, local, pool, mem)]
    pool_i = raw[2].tolist()
    # each slot's payload (int32, the same in every lane), set at ARRIVE
    n_slots, n_lanes = slots.shape
    slot_pay = np.zeros((4, n_slots), np.int32)    # cores, local, pool, dep
    rows = torch.arange(fc.shape[0], device=dev)
    grp = group_of.long()
    n_groups = up.shape[1]
    sgb_c, pgb_c = sgb[:, None], pgb[:, None]
    lanes2 = rows[None, :].expand(n_slots, n_lanes)
    n_fail = 0
    for e, k in enumerate(kinds):
        if k == FAIL:
            d = dmns[e]
            pay_t = torch.from_numpy(slot_pay).to(dev)
            live = slots >= 0
            srv = torch.where(live, slots.long() >> 1, 0)
            pooled = live & ((slots & 1) == 0) & (pay_t[2] > 0)[:, None]
            aff = pooled & (grp[srv] == d)
            if remigrate:
                demand = _scatter(fc.shape, lanes2, srv,
                                  torch.where(aff, pay_t[2][:, None], 0))
                fits = um.int() + demand <= sgb.int()[:, None]
                fits_s = fits[lanes2, srv]
                rem, kill = aff & fits_s, aff & ~fits_s
            else:
                rem, kill = torch.zeros_like(aff), aff
            dfc = _scatter(fc.shape, lanes2, srv,
                           torch.where(kill, pay_t[0][:, None], 0))
            dum = (_scatter(fc.shape, lanes2, srv,
                            torch.where(rem, pay_t[2][:, None], 0))
                   - _scatter(fc.shape, lanes2, srv,
                              torch.where(kill, pay_t[1][:, None], 0)))
            fc += dfc.to(dt)
            um += dum.to(dt)
            if 0 <= d < n_groups:
                up[:, d] = 0
                down[:, d] = 1
            slots.copy_(torch.where(kill, -1, torch.where(rem, slots | 1,
                                                          slots)).to(dt))
            n_aff = aff.sum(0, dtype=torch.int32)
            lost = torch.where(kill, torch.clamp(pay_t[3] - xs[e], min=0)
                               [:, None], 0).sum(0, dtype=torch.int32)
            out[1] += n_aff
            out[2] += kill.sum(0, dtype=torch.int32)
            out[3] += rem.sum(0, dtype=torch.int32)
            out[4] += lost
            if dist is not None and n_fail < dist.shape[0]:
                dist[n_fail] = n_aff
            n_fail += 1
            continue
        if k == RECOVER:
            d = dmns[e]
            if 0 <= d < n_groups:
                down[:, d] = 0
            continue
        if k not in (ARRIVE, DEPART, MIGRATE):      # PAD
            continue
        sl = sls[e]
        c, l, p, m = (a[e] for a in pay)
        if k == ARRIVE:
            slot_pay[:, sl] = (raw[0][e], raw[1][e], raw[2][e], xs[e])
            fits = fc >= c
            ok1 = fits & (um + l <= sgb_c) & (up[:, grp] + p <= pgb_c)
            if pool_i[e] != 0:                      # a down domain grants
                ok1 &= down[:, grp] == 0            # no pool slices
            score1 = torch.where(ok1, fc, big)
            s1 = torch.argmin(score1, 1)
            feas1 = score1[rows, s1] < big
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
            out[0] += (~place).to(torch.int32)
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
    return out
