"""Wrapper for the event sweep (K1): checks, dispatch, launch count.

A CUDA tensor goes to the hand-written kernel or raises; a CPU tensor goes
to the plain version, and only because it lies on the CPU.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels.event_sweep import kernel as K
from repro_torch.kernels.event_sweep import ref as R

# Number of kernel launches made by this process; callers that want to
# show a path went through the kernel set it to 0 and read it afterwards.
launches = 0
# The plan (kernel.Plan: variant, servers a thread, lanes a block) of the
# last launch, so a caller can see which variant ran.
last_plan = None


def _check(events, group_of, fc, um, up, slots, sgb, pgb, rejects):
    if len(events) != 6 or any(e.dim() != 1 for e in events):
        raise ValueError("event_sweep: six (E,) event arrays: kind, slot, "
                         "cores, local, pool, mem")
    n_ev = events[0].shape[0]
    if any(e.shape[0] != n_ev for e in events):
        raise ValueError("event_sweep: event arrays differ in length: "
                         f"{[e.shape[0] for e in events]}")
    if fc.dim() != 2 or um.shape != fc.shape or up.dim() != 2 \
            or slots.dim() != 2:
        raise ValueError("event_sweep: state fc, um (C,S), up (C,G), "
                         "slots (n_slots,C)")
    c, s = fc.shape
    if group_of.shape != (s,) or up.shape[0] != c or slots.shape[1] != c \
            or sgb.shape != (c,) or pgb.shape != (c,) \
            or rejects.shape != (c,):
        raise ValueError(
            f"event_sweep: shapes disagree: fc {tuple(fc.shape)}, group_of "
            f"{tuple(group_of.shape)}, up {tuple(up.shape)}, slots "
            f"{tuple(slots.shape)}, sgb {tuple(sgb.shape)}, pgb "
            f"{tuple(pgb.shape)}, rejects {tuple(rejects.shape)}")
    if c == 0 or s == 0 or up.shape[1] == 0 or slots.shape[0] == 0:
        raise ValueError("event_sweep: lanes, servers, groups and slots "
                         "must be at least 1")
    state = (fc, um, up, slots, sgb, pgb)
    if fc.dtype not in K.STATE_DTYPES or any(t.dtype != fc.dtype
                                             for t in state):
        raise TypeError("event_sweep: fc, um, up, slots, sgb, pgb share "
                        "one state dtype, int16 or int32; got "
                        f"{[t.dtype for t in state]}")
    ints = (*events, group_of, rejects)
    if any(t.dtype != torch.int32 for t in ints):
        raise TypeError("event_sweep: events, group_of and rejects are "
                        "int32")
    tensors = (*ints, *state)
    if any(t.device != fc.device for t in tensors):
        raise ValueError("event_sweep: tensors lie on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("event_sweep: tensors must be contiguous")


def event_sweep(kind, slot, cores, local, pool, mem, group_of, fc, um, up,
                slots, sgb, pgb, rejects=None, *, variant=None):
    """Replay every event for every candidate lane.

    Events: six int32 (E,) arrays; ``group_of`` (S,) int32; state fc, um
    (C,S), up (C,G), slots (n_slots,C) and capacities sgb, pgb (C,) in one
    state dtype (int16 or int32).  ``rejects`` (C,) int32 is added to
    (zeros when None).  The final state is written into fc, um, up and
    slots in place (a later sweep can carry it on); returns the rejects.
    On the card ``variant`` forces one of ``kernel.VARIANTS`` (None: the
    registers variant up to ``kernel.MAX_REGISTER_SERVERS`` servers, the
    shared one beyond).
    """
    global launches, last_plan
    events = (kind, slot, cores, local, pool, mem)
    if rejects is None:
        rejects = torch.zeros(fc.shape[0], dtype=torch.int32,
                              device=fc.device)
    _check(events, group_of, fc, um, up, slots, sgb, pgb, rejects)
    if variant is not None and variant not in K.VARIANTS:
        raise ValueError(f"event_sweep: variant {variant!r} is not one of "
                         f"{sorted(K.VARIANTS)}")
    if fc.device.type == "cpu":
        return R.event_sweep_ref(*events, group_of, fc, um, up, slots, sgb,
                                 pgb, rejects)
    if fc.device.type != "cuda":
        raise ValueError(f"event_sweep: no kernel for {fc.device}")
    if any(e.data_ptr() % 16 for e in events):
        raise ValueError("event_sweep: the event arrays must be 16-byte "
                         "aligned (the kernel stages them 16 bytes a copy)")
    c, s = fc.shape
    plan = K.plan(c, s, up.shape[1], slots.shape[0], fc.element_size(),
                  _sm_count(fc.device), variant)
    K.event_sweep_kernel(events, group_of, fc, um, up, slots, sgb, pgb,
                         rejects, plan=plan)
    launches += 1
    last_plan = plan
    return rejects


@functools.cache
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count
