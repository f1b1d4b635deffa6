"""Wrapper for the event sweep (K1): checks, dispatch, launch count.

A CUDA tensor goes to the hand-written kernel or raises; a CPU tensor goes
to the plain version, and only because it lies on the CPU.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.sweep_core import PAD
from repro_torch.kernels.event_sweep import kernel as K
from repro_torch.kernels.event_sweep import ref as R

# Number of kernel launches made by this process; callers that want to
# show a path went through the kernel set it to 0 and read it afterwards.
launches = 0
# The plan (kernel.Plan: variant, servers a thread, lanes a block, where
# the slot column lives) of the last launch, so a caller can see what ran.
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


def trace_starts(trace_events) -> list[int]:
    """Where each trace's events start when the traces lie one after
    another in one set of event arrays, each padded to a multiple of 4
    events (16 bytes, the kernel's staging copy): the layout the trace axis
    of :func:`event_sweep` takes."""
    starts, at = [], 0
    for n in trace_events:
        starts.append(at)
        at += -(-int(n) // 4) * 4
    return starts


def pack_traces(streams, device=None):
    """Event streams (each six 1-D int arrays or tensors: kind, slot,
    cores, local, pool, mem) one after another as the trace axis of
    :func:`event_sweep` takes them: six int32 tensors on ``device`` (the
    CPU when None), each trace from its :func:`trace_starts` offset and PAD
    events (a no-op) in the gaps, and the streams' event counts."""
    counts = [len(ev[0]) for ev in streams]
    starts = trace_starts(counts + [0])
    cols = []
    for j in range(6):
        col = torch.full((starts[-1],), PAD if j == 0 else 0,
                         dtype=torch.int32, device=device)
        for ev, e0 in zip(streams, starts):
            col[e0:e0 + len(ev[j])] = torch.as_tensor(ev[j]).to(col.device)
        cols.append(col)
    return tuple(cols), counts


def _trace_layout(trace_events, n_events: int, n_lanes: int):
    """(starts, counts) of the trace axis, checked against the event
    arrays' length and the lanes."""
    if trace_events is None:
        return [0], [n_events]
    counts = [int(n) for n in trace_events]
    n_traces = len(counts)
    if not 1 <= n_traces <= K.MAX_TRACES or min(counts) < 0:
        raise ValueError(f"event_sweep: 1 to {K.MAX_TRACES} traces of >= 0 "
                         f"events, got {counts[:8]}")
    if n_lanes % n_traces:
        raise ValueError(f"event_sweep: {n_lanes} lanes do not split into "
                         f"{n_traces} traces")
    starts = trace_starts(counts)
    if starts[-1] + counts[-1] > n_events:
        raise ValueError(f"event_sweep: the traces need "
                         f"{starts[-1] + counts[-1]} events, the arrays "
                         f"hold {n_events}")
    return starts, counts


def event_sweep(kind, slot, cores, local, pool, mem, group_of, fc, um, up,
                slots, sgb, pgb, rejects=None, *, variant=None,
                slot_column=None, trace_events=None):
    """Replay every event for every candidate lane.

    Events: six int32 (E,) arrays; ``group_of`` (S,) int32; state fc, um
    (C,S), up (C,G), slots (n_slots,C) and capacities sgb, pgb (C,) in one
    state dtype (int16 or int32).  ``rejects`` (C,) int32 is added to
    (zeros when None).  The final state is written into fc, um, up and
    slots in place (a later sweep can carry it on); returns the rejects.
    On the card ``variant`` forces one of ``kernel.VARIANTS`` (None: the
    registers variant up to ``kernel.MAX_REGISTER_SERVERS`` servers, the
    shared one beyond) and ``slot_column`` one of ``kernel.SLOT_COLUMNS``
    (None: shared memory while a lane's slot column fits there, else
    global memory); both are for tests and measurements.

    The trace axis: ``trace_events`` (T event counts) says the arrays hold
    T traces laid out by :func:`trace_starts`, and the lanes are
    trace-major, C / T a trace, each replaying its own trace's events (the
    slot column is the largest trace's).  None: one trace of E events.
    """
    global launches, last_plan
    events = (kind, slot, cores, local, pool, mem)
    if rejects is None:
        rejects = torch.zeros(fc.shape[0], dtype=torch.int32,
                              device=fc.device)
    _check(events, group_of, fc, um, up, slots, sgb, pgb, rejects)
    starts, counts = _trace_layout(trace_events, kind.shape[0], fc.shape[0])
    if variant is not None and variant not in K.VARIANTS:
        raise ValueError(f"event_sweep: variant {variant!r} is not one of "
                         f"{sorted(K.VARIANTS)}")
    if slot_column is not None and slot_column not in K.SLOT_COLUMNS:
        raise ValueError(f"event_sweep: slot_column {slot_column!r} is not "
                         f"one of {K.SLOT_COLUMNS}")
    if fc.device.type == "cpu":
        return R.event_sweep_ref(*events, group_of, fc, um, up, slots, sgb,
                                 pgb, rejects, starts, counts)
    if fc.device.type != "cuda":
        raise ValueError(f"event_sweep: no kernel for {fc.device}")
    if any(e.data_ptr() % 16 for e in events):
        raise ValueError("event_sweep: the event arrays must be 16-byte "
                         "aligned (the kernel stages them 16 bytes a copy)")
    c, s = fc.shape
    plan = K.plan(c // len(starts), s, up.shape[1], slots.shape[0],
                  fc.element_size(), _sm_count(fc.device), variant,
                  len(starts), slot_column)
    K.event_sweep_kernel(events, group_of, fc, um, up, slots, sgb, pgb,
                         rejects, plan=plan, trace_starts=starts,
                         trace_counts=counts)
    launches += 1
    last_plan = plan
    return rejects


@functools.cache
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count
