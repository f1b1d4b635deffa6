"""Plain PyTorch version of the pod sweep (the kernel's oracle, and what the
wrapper runs for CPU tensors).

A transcription of the reference's scan step
(``src/repro/core/sweep_core.py::build_pod_sweep``, ``body``): K1's plain
version (``kernels/event_sweep/ref.py``) over a per-lane incidence ``(C, S,
F)`` and a per-pod used pool ``(C, P)``.  A pooled arrival admits a server
when some listed pod has room for the whole demand, and the granting pod is
the first listed one with room on the chosen server (``argmax`` of the
fits, the first True), recorded in the ``pods`` column beside the slot.
DEPART returns the pool to the recorded pod; MIGRATE keeps the scalar
oracle's quirk (to the recorded pod, else the server's first listed pod,
else nowhere).  The event kind is the same for every lane, so the loop
branches on it on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.sweep_core import (ARRIVE, DEPART, I16_BIG, I32_BIG,
                                         MIGRATE)


def pod_sweep_ref(kind, slot, cores, local, pool, mem, inc, fc, um, up,
                  slots, pods, sgb, pgb, rejects, trace_starts=None,
                  trace_counts=None):
    """The kernel's contract: events are six int32 (E,) tensors, ``inc``
    (C,S,F) int32 (-1 padded), state fc/um (C,S), up (C,P), slots and pods
    (n_slots,C), capacities sgb (C,) and pgb (C,P) in the state dtype
    (int16 or int32), rejects (C,) int32.  Runs every event, writes the
    final state into fc, um, up, slots, pods and rejects in place, and
    returns ``rejects``.

    The trace axis (``trace_starts``/``trace_counts``) is K1's: T streams
    in the arrays, the C lanes trace-major, each trace's lanes replaying
    its own stream."""
    if trace_starts is None:
        return _sweep_one(kind, slot, cores, local, pool, mem, inc, fc, um,
                          up, slots, pods, sgb, pgb, rejects)
    n = fc.shape[0] // len(trace_starts)
    for t, (e0, count) in enumerate(zip(trace_starts, trace_counts)):
        ev = (a[e0:e0 + count] for a in (kind, slot, cores, local, pool,
                                          mem))
        lanes = slice(t * n, (t + 1) * n)
        _sweep_one(*ev, inc[lanes], fc[lanes], um[lanes], up[lanes],
                   slots[:, lanes], pods[:, lanes], sgb[lanes], pgb[lanes],
                   rejects[lanes])
    return rejects


def _add_to_pods(up, rows, tgt, delta):
    """up[row, tgt[row]] += delta where tgt >= 0 (one pod a lane)."""
    hit = tgt >= 0
    up[rows[hit], tgt[hit]] += delta


def _sweep_one(kind, slot, cores, local, pool, mem, inc, fc, um, up, slots,
               pods, sgb, pgb, rejects):
    """One stream for every lane (the reference's scan step, event after
    event); the state arguments may be views, written through."""
    dt = fc.dtype
    np_dt = np.int16 if dt == torch.int16 else np.int32
    big = I16_BIG if dt == torch.int16 else I32_BIG
    kinds = kind.cpu().numpy().tolist()
    sls = slot.cpu().numpy().tolist()
    # payloads cast to the state dtype, as the reference's c.astype(dt);
    # the int32 pool decides the pool-free and the grant tests
    pay = [a.cpu().numpy().astype(np_dt).tolist()
           for a in (cores, local, pool, mem)]
    pool_i = pool.cpu().numpy().tolist()
    n_c, n_s, n_f = inc.shape
    rows = torch.arange(n_c, device=fc.device)
    valid = inc >= 0
    idx = inc.clamp(min=0).long().reshape(n_c, n_s * n_f)
    first_pod = inc[:, :, 0].long()
    inc_l = inc.long()
    sgb_c = sgb[:, None]
    for e, k in enumerate(kinds):
        if k not in (ARRIVE, DEPART, MIGRATE):      # PAD, FAIL, RECOVER
            continue
        sl = sls[e]
        c, l, p, m = (a[e] for a in pay)
        pi = pool_i[e]
        if k == ARRIVE:
            # per-(lane, server, fanout) pod fit; -1 entries never fit
            upr = torch.gather(up, 1, idx).reshape(n_c, n_s, n_f)
            pgr = torch.gather(pgb, 1, idx).reshape(n_c, n_s, n_f)
            fits = valid & (upr + p <= pgr)
            fits_c = fc >= c
            ok1 = fits_c & (um + l <= sgb_c)
            if pi != 0:
                ok1 &= fits.any(-1)
            score1 = torch.where(ok1, fc, big)
            s1 = torch.argmin(score1, 1)
            feas1 = score1[rows, s1] < big
            # pool short -> control-plane fallback: start the VM all-local
            score2 = torch.where(fits_c & (um + m <= sgb_c), fc, big)
            s2 = torch.argmin(score2, 1)
            feas2 = score2[rows, s2] < big
            sel = torch.where(feas1, s1, s2)
            place = feas1 | feas2
            fc[rows, sel] -= place.to(dt) * c
            um[rows, sel] += place.to(dt) * torch.where(feas1, l, m).to(dt)
            grant = torch.full_like(sel, -1)
            if pi > 0:
                # the first listed pod with room on the chosen server
                f_sel = torch.argmax(fits[rows, sel].to(torch.int8), -1)
                grant = torch.where(place & feas1, inc_l[rows, sel, f_sel],
                                    -1)
                _add_to_pods(up, rows, grant, p)
            slots[sl] = torch.where(place, sel * 2 + (~feas1).long(),
                                    -1).to(dt)
            pods[sl] = grant.to(dt)
            rejects += (~place).to(torch.int32)
            continue
        val = slots[sl]
        has = val >= 0
        s_cur = torch.where(has, val >> 1, 0).long()
        pod_v = pods[sl].long()
        if k == DEPART:
            mg = has & ((val & 1) == 1)
            fc[rows, s_cur] += has.to(dt) * c
            um[rows, s_cur] -= has.to(dt) * torch.where(mg, m, l).to(dt)
            _add_to_pods(up, rows, torch.where(has & ~mg, pod_v, -1), -p)
            slots[sl] = -1
            pods[sl] = -1
        else:                                       # MIGRATE: pool -> local
            act = has & (um[rows, s_cur] + p <= sgb)
            um[rows, s_cur] += act.to(dt) * p
            tgt = torch.where(pod_v >= 0, pod_v, first_pod[rows, s_cur])
            _add_to_pods(up, rows, torch.where(act, tgt, -1), -p)
            slots[sl] = torch.where(act, val | 1, val)
    return rejects
