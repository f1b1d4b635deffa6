"""Wrapper for the pod sweep (K4): checks, dispatch, launch count.

A CUDA tensor goes to the hand-written kernel or raises; a CPU tensor goes
to the plain version, and only because it lies on the CPU.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels.event_sweep.ops import trace_layout
from repro_torch.kernels.pod_sweep import kernel as K
from repro_torch.kernels.pod_sweep import ref as R

# Number of kernel launches made by this process; callers that want to
# show a path went through the kernel set it to 0 and read it afterwards.
launches = 0
# The plan (kernel.Plan) of the last launch, so a caller can see what ran.
last_plan = None


def _check(events, inc, fc, um, up, slots, pods, sgb, pgb, rejects):
    """Raises on shapes, types and devices the sweep does not take (no
    sync; the incidence's entries are :func:`check_incidence`'s)."""
    if len(events) != 6 or any(e.dim() != 1 for e in events):
        raise ValueError("pod_sweep: six (E,) event arrays: kind, slot, "
                         "cores, local, pool, mem")
    n_ev = events[0].shape[0]
    if any(e.shape[0] != n_ev for e in events):
        raise ValueError("pod_sweep: event arrays differ in length: "
                         f"{[e.shape[0] for e in events]}")
    if fc.dim() != 2 or um.shape != fc.shape or up.dim() != 2 \
            or slots.dim() != 2 or inc.dim() != 3:
        raise ValueError("pod_sweep: inc (C,S,F), state fc, um (C,S), up "
                         "(C,P), slots and pods (n_slots,C)")
    c, s = fc.shape
    if inc.shape[:2] != (c, s) or up.shape[0] != c or slots.shape[1] != c \
            or pods.shape != slots.shape or sgb.shape != (c,) \
            or pgb.shape != up.shape or rejects.shape != (c,):
        raise ValueError(
            f"pod_sweep: shapes disagree: inc {tuple(inc.shape)}, fc "
            f"{tuple(fc.shape)}, up {tuple(up.shape)}, slots "
            f"{tuple(slots.shape)}, pods {tuple(pods.shape)}, sgb "
            f"{tuple(sgb.shape)}, pgb {tuple(pgb.shape)}, rejects "
            f"{tuple(rejects.shape)}")
    if c == 0 or s == 0 or up.shape[1] == 0 or inc.shape[2] == 0 \
            or slots.shape[0] == 0:
        raise ValueError("pod_sweep: lanes, servers, pods, fanout and slots "
                         "must be at least 1")
    state = (fc, um, up, slots, pods, sgb, pgb)
    if fc.dtype not in K.STATE_DTYPES or any(t.dtype != fc.dtype
                                             for t in state):
        raise TypeError("pod_sweep: fc, um, up, slots, pods, sgb, pgb share "
                        "one state dtype, int16 or int32; got "
                        f"{[t.dtype for t in state]}")
    ints = (*events, inc, rejects)
    if any(t.dtype != torch.int32 for t in ints):
        raise TypeError("pod_sweep: events, inc and rejects are int32")
    tensors = (*ints, *state)
    if any(t.device != fc.device for t in tensors):
        raise ValueError("pod_sweep: tensors lie on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("pod_sweep: tensors must be contiguous")


def check_incidence(inc: torch.Tensor, n_pods: int, count: bool = True):
    """Raises unless every entry of ``inc`` (C, S, F) lies in [-1,
    ``n_pods``).  With ``count``, returns the widest thread's distinct pods
    (``K.widest_distinct`` at the plan's servers a thread), read in the
    same sync as the check, else None.  A caller that launches the sweep
    on one incidence again and again (a stream's shards) checks it once
    and passes the count as :func:`pod_sweep`'s ``widest``."""
    bad = ((inc < -1) | (inc >= n_pods)).any()
    widest = None
    if count:
        k = K.servers_per_thread(inc.shape[1])
        bad, widest = torch.stack([bad.long(), K.widest_distinct(inc, k)]) \
            .tolist()
    if bad:
        raise ValueError(f"pod_sweep: incidence entries must lie in [-1, "
                         f"{n_pods})")
    return widest


def pod_sweep(kind, slot, cores, local, pool, mem, inc, fc, um, up, slots,
              pods, sgb, pgb, rejects=None, *, trace_events=None,
              slot_column=None, distinct=None, widest=None):
    """Replay every event for every candidate lane of a fleet grid.

    Events: six int32 (E,) arrays; ``inc`` (C,S,F) int32, row (c, s) the
    pods server s reaches in lane c's topology in preference order, -1
    padded; state fc, um (C,S), up (C,P), slots and pods (n_slots,C) and
    capacities sgb (C,), pgb (C,P) in one state dtype (int16 or int32).
    ``rejects`` (C,) int32 is added to (zeros when None).  The final state
    is written into fc, um, up, slots and pods in place; returns the
    rejects.  ``trace_events`` is K1's trace axis (the lanes trace-major,
    each with its own incidence row); ``slot_column`` forces where the
    kernel keeps a lane's slot and pod columns, ``distinct`` a table build
    of at least that many entries a thread, no fewer than the widest
    thread's distinct pods (tests and measurements; checked on the CPU
    too).

    ``widest``: :func:`check_incidence`'s count for this ``inc``, already
    checked, so that a launch on the card makes no sync of its own (a
    stream's shards); on the CPU the incidence is checked all the same.
    """
    global launches, last_plan
    events = (kind, slot, cores, local, pool, mem)
    if rejects is None:
        rejects = torch.zeros(fc.shape[0], dtype=torch.int32,
                              device=fc.device)
    _check(events, inc, fc, um, up, slots, pods, sgb, pgb, rejects)
    on_card = fc.device.type == "cuda"
    if widest is None or not on_card:
        found = check_incidence(inc, up.shape[1],
                                on_card or distinct is not None)
        widest = found if widest is None else widest
    starts, counts = trace_layout(trace_events, kind.shape[0], fc.shape[0],
                                  "pod_sweep")
    if slot_column is not None and slot_column not in K.SLOT_COLUMNS:
        raise ValueError(f"pod_sweep: slot_column {slot_column!r} is not "
                         f"one of {K.SLOT_COLUMNS}")
    if distinct is not None and distinct < widest:
        raise ValueError(f"pod_sweep: a table of {distinct} entries a "
                         f"thread is smaller than the widest thread's "
                         f"{widest} distinct pods")
    if not on_card:
        if fc.device.type != "cpu":
            raise ValueError(f"pod_sweep: no kernel for {fc.device}")
        return R.pod_sweep_ref(*events, inc, fc, um, up, slots, pods, sgb,
                               pgb, rejects, starts, counts)
    if any(e.data_ptr() % 16 for e in events):
        raise ValueError("pod_sweep: the event arrays must be 16-byte "
                         "aligned (the kernel stages them 16 bytes a copy)")
    c, s = fc.shape
    plan = K.plan(c // len(starts), s, inc.shape[2], slots.shape[0],
                  fc.element_size(), _sm_count(fc.device), len(starts),
                  slot_column, widest if distinct is None else distinct)
    K.pod_sweep_kernel(events, inc, fc, um, up, slots, pods, sgb, pgb,
                       rejects, plan=plan, trace_starts=starts,
                       trace_counts=counts)
    launches += 1
    last_plan = plan
    return rejects


@functools.cache
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count
