"""Wrapper for the failure sweep (K5): checks, dispatch, launch count.

A CUDA tensor goes to the hand-written kernel or raises; a CPU tensor goes
to the plain version, and only because it lies on the CPU.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.sweep_core import MITIGATIONS
from repro_torch.kernels.event_sweep.ops import trace_layout
from repro_torch.kernels.fail_sweep import kernel as K
from repro_torch.kernels.fail_sweep import ref as R

# Number of kernel launches made by this process; callers that want to
# show a path went through the kernel set it to 0 and read it afterwards.
launches = 0
# The plan (kernel.Plan) of the last launch, so a caller can see what ran.
last_plan = None


def _check(events, group_of, fc, um, up, slots, down, sgb, pgb, out, dist):
    if len(events) != 8 or any(e.dim() != 1 for e in events):
        raise ValueError("fail_sweep: eight (E,) event arrays: kind, slot, "
                         "cores, local, pool, mem, x, dmn")
    n_ev = events[0].shape[0]
    if any(e.shape[0] != n_ev for e in events):
        raise ValueError("fail_sweep: event arrays differ in length: "
                         f"{[e.shape[0] for e in events]}")
    if fc.dim() != 2 or um.shape != fc.shape or up.dim() != 2 \
            or slots.dim() != 2:
        raise ValueError("fail_sweep: state fc, um (C,S), up (C,G), slots "
                         "(n_slots,C)")
    c, s = fc.shape
    if group_of.shape != (s,) or up.shape[0] != c or slots.shape[1] != c \
            or down.shape != up.shape or sgb.shape != (c,) \
            or pgb.shape != (c,) or out.shape != (5, c) \
            or (dist is not None and (dist.dim() != 2
                                      or dist.shape[1] != c)):
        raise ValueError(
            f"fail_sweep: shapes disagree: fc {tuple(fc.shape)}, group_of "
            f"{tuple(group_of.shape)}, up {tuple(up.shape)}, down "
            f"{tuple(down.shape)}, slots {tuple(slots.shape)}, sgb "
            f"{tuple(sgb.shape)}, pgb {tuple(pgb.shape)}, out "
            f"{tuple(out.shape)}, dist "
            f"{None if dist is None else tuple(dist.shape)}")
    if c == 0 or s == 0 or up.shape[1] == 0 or slots.shape[0] == 0:
        raise ValueError("fail_sweep: lanes, servers, groups and slots must "
                         "be at least 1")
    state = (fc, um, up, slots, sgb, pgb)
    if fc.dtype not in K.STATE_DTYPES or any(t.dtype != fc.dtype
                                             for t in state):
        raise TypeError("fail_sweep: fc, um, up, slots, sgb, pgb share one "
                        "state dtype, int16 or int32; got "
                        f"{[t.dtype for t in state]}")
    ints = (*events, group_of, down, out) + (() if dist is None else (dist,))
    if any(t.dtype != torch.int32 for t in ints):
        raise TypeError("fail_sweep: events, group_of, down, out and dist "
                        "are int32")
    tensors = (*ints, *state)
    if any(t.device != fc.device for t in tensors):
        raise ValueError("fail_sweep: tensors lie on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fail_sweep: tensors must be contiguous")


def fail_sweep(kind, slot, cores, local, pool, mem, x, dmn, group_of, fc, um,
               up, slots, down, sgb, pgb, out=None, *, mitigation: str,
               dist=None, trace_events=None, slot_column=None, warps=None):
    """Replay every event, failures included, for every candidate lane.

    Events: eight int32 (E,) arrays; ``group_of`` (S,) int32; state fc, um
    (C,S), up (C,G), slots (n_slots,C) and capacities sgb, pgb (C,) in one
    state dtype (int16 or int32), the slots empty (-1: every placement
    comes from this sweep's ARRIVEs); ``down`` (C,G) int32 down flags
    (``sweep_core.init_fail_state``).  ``out`` (5,C) int32 counters
    (``ref.COUNTERS``) are added to (zeros when None).  ``mitigation`` is
    "remigrate" or "kill".  ``dist`` (n_dist,C) int32 takes the f-th
    FAIL's affected count in row f (one trace only).  The final state is
    written into fc, um, up, slots and down in place; returns ``out``.
    ``trace_events`` is K1's trace axis.  For tests and measurements,
    ``slot_column`` forces where the kernel keeps a lane's slot and payload
    columns and ``warps`` the warps a lane.
    """
    global launches, last_plan
    events = (kind, slot, cores, local, pool, mem, x, dmn)
    if mitigation not in MITIGATIONS:
        raise ValueError(f"mitigation must be one of {MITIGATIONS}")
    if out is None:
        out = torch.zeros((5, fc.shape[0]), dtype=torch.int32,
                          device=fc.device)
    _check(events, group_of, fc, um, up, slots, down, sgb, pgb, out, dist)
    starts, counts = trace_layout(trace_events, kind.shape[0], fc.shape[0],
                                  "fail_sweep")
    if dist is not None and len(starts) > 1:
        raise ValueError("fail_sweep: per-failure rows take one trace")
    if slot_column is not None and slot_column not in K.SLOT_COLUMNS:
        raise ValueError(f"fail_sweep: slot_column {slot_column!r} is not "
                         f"one of {K.SLOT_COLUMNS}")
    if bool((slots >= 0).any()):
        raise ValueError("fail_sweep: the slots must start empty (-1): a "
                         "slot's payload is known only from its ARRIVE")
    remigrate = mitigation == "remigrate"
    if fc.device.type == "cpu":
        return R.fail_sweep_ref(*events, group_of, fc, um, up, slots, down,
                                sgb, pgb, out, dist, remigrate=remigrate,
                                trace_starts=starts, trace_counts=counts)
    if fc.device.type != "cuda":
        raise ValueError(f"fail_sweep: no kernel for {fc.device}")
    if any(e.data_ptr() % 16 for e in events):
        raise ValueError("fail_sweep: the event arrays must be 16-byte "
                         "aligned (the kernel stages them 16 bytes a copy)")
    c, s = fc.shape
    plan = K.plan(c // len(starts), s, slots.shape[0], fc.element_size(),
                  _sm_count(fc.device), len(starts), slot_column, warps)
    K.fail_sweep_kernel(events, group_of, fc, um, up, slots, down, sgb, pgb,
                        out, dist, remigrate=remigrate, plan=plan,
                        trace_starts=starts, trace_counts=counts)
    launches += 1
    last_plan = plan
    return out


@functools.cache
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count
