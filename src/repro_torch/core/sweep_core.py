"""Host side of the event sweep: event kinds, state packing rules, the
all-free initial state and slot assignment.

``CompiledReplay`` prices ``(server_gb, pool_gb)`` candidates with one
integer event sweep (kernel K1, ``kernels/event_sweep``): per trace event
one step over a ``(candidates x servers)`` state.  This module holds what
surrounds the sweep on the host — numpy, copied from the reference's
``core/sweep_core.py``:

* event kinds (PAD, FAIL and RECOVER are no-ops in the plain sweep);
* the int16/int32 packing rules (:func:`pick_state_dtype`): the state
  packs to int16 exactly when no intermediate can overflow;
* :func:`quantize_capacities`, :func:`init_state`, :func:`assign_slots`;
* :func:`get_sweep`, which hands out K1's launcher for a state dtype,
  one trace or a batch of traces (K1's trace axis);
* the failure layer's :data:`MITIGATIONS` and :func:`init_fail_state`
  (the failure sweep itself is kernel K5, ``kernels/fail_sweep``).

The reference pads candidates to buckets, events to multiples of 256 and
servers, groups and slots to multiples of 16/16/32, so that XLA compiles
rarely.  K1 takes the true counts, so none of that is carried over.
"""
from __future__ import annotations

import numpy as np

ARRIVE, DEPART, MIGRATE = 0, 1, 2
PAD = 3               # no-op event kind (the reference pads with it)
FAIL, RECOVER = 4, 5  # failure-domain events: no-ops in the plain sweep
I32_BIG = 1 << 30     # "infinite" capacity in the int32 sweep
I16_BIG = 1 << 14     # best-fit score sentinel in the int16 sweep
I16_SAFE = 30000      # int16 headroom bound: capacity + payload must fit


def get_sweep(state_dtype: str = "int32", *, with_carry: bool = False,
              batched: bool = False, mesh=None):
    """K1's launcher for ``state_dtype``: a function of
    ``(events, group_of, fc, um, up, slots, sgb, pgb)`` returning the
    (C,) int32 reject counts and leaving the final state in its state
    arguments (``kernels/event_sweep/ops.py::event_sweep``).  With
    ``batched`` it takes one more argument, ``trace_events``: the event
    counts of the T traces the arrays hold (laid out by
    ``ops.trace_starts``), the lanes trace-major, C / T a trace — the
    reference's vmapped sweep over a trace batch, as one launch.

    The reference's other keys (a returned carry, a device mesh) are not
    ported yet: they raise.
    """
    if with_carry:
        raise NotImplementedError("carried-state sweeps come with the "
                                  "streaming engines (ROADMAP M5)")
    if mesh is not None:
        raise NotImplementedError("device meshes come with devices= "
                                  "(ROADMAP M13)")
    if state_dtype not in ("int16", "int32"):
        raise ValueError(f"state_dtype must be 'int16' or 'int32', got "
                         f"{state_dtype!r}")
    from repro_torch.kernels.event_sweep import ops

    if batched:
        def sweep_batch(events, group_of, fc, um, up, slots, sgb, pgb,
                        trace_events):
            return ops.event_sweep(*events, group_of, fc, um, up, slots, sgb,
                                   pgb, trace_events=trace_events)
        return sweep_batch

    def sweep(events, group_of, fc, um, up, slots, sgb, pgb):
        return ops.event_sweep(*events, group_of, fc, um, up, slots, sgb,
                               pgb)
    return sweep


# ------------------------------------------------------------ failure sweep --
MITIGATIONS = ("remigrate", "kill")


def init_fail_state(width: int, n_groups: int) -> np.ndarray:
    """The failure sweep's extra state, all up: the (width, n_groups) int32
    down flags, a row a lane.  (The reference's also holds each slot's
    payload, shared across lanes; K5 finds a slot's payload through the
    index of its ARRIVE, kept in a per-lane scratch column that the wrapper
    allocates, so the slots must start empty.)"""
    return np.zeros((width, n_groups), np.int32)


# ------------------------------------------------------------- state rules --
def state_np_dtype(state_dtype: str):
    """Host numpy dtype of the packed sweep state."""
    return np.int16 if state_dtype == "int16" else np.int32


def state_sentinel(state_dtype: str) -> int:
    """Best-fit score sentinel / "infinite" magnitude for the dtype."""
    return I16_BIG if state_dtype == "int16" else I32_BIG


def pick_state_dtype(cores_per_server: float, n_servers: int,
                     sgb_i: np.ndarray, pgb_i: np.ndarray,
                     pay_mem_max: float, pay_pool_max: float,
                     mig_pool_sum: float = 0.0) -> str:
    """``"int16"`` when every sweep intermediate provably fits int16.

    The admission tests compute at most ``capacity + one payload`` (used
    mem is invariantly <= server_gb, used pool <= pool_gb), so int16 is
    bit-equivalent to int32 whenever the candidate maxima plus the per-VM
    payload maxima stay within :data:`I16_SAFE`, the best-fit score
    sentinel exceeds every free-cores value, and the packed slot values
    (server * 2 + 1) fit.  MIGRATE-bearing traces need one more bound:
    the oracle's fallback-migrate quirk returns pool a fallback-placed VM
    never consumed, driving used pool NEGATIVE by at most the pool
    payload of each compiled MIGRATE event (``mig_pool_sum``).
    """
    if (cores_per_server < I16_BIG
            and n_servers * 2 + 1 < I16_BIG
            and len(sgb_i) and sgb_i.min() >= 0 and pgb_i.min() >= 0
            and sgb_i.max() + pay_mem_max <= I16_SAFE
            and pgb_i.max() + pay_pool_max <= I16_SAFE
            and mig_pool_sum + pay_pool_max <= I16_SAFE):
        return "int16"
    return "int32"


def quantize_capacities(server_gb, pool_gb):
    """Floor + clip candidate capacities to the int sweep's domain.

    Integral quantities: flooring keeps every admission test identical
    to the float64 oracle; ±2^30 stands in for "infinite" probes.
    """
    sgb_i = np.clip(np.floor(server_gb), -I32_BIG, I32_BIG)
    pgb_i = np.clip(np.floor(pool_gb), -I32_BIG, I32_BIG)
    return sgb_i, pgb_i


# ---------------------------------------------------- state pack / unpack --
def init_state(width: int, n_servers: int, cores_per_server: float,
               s_pad: int, g_pad: int, n_slots: int, np_dt) -> tuple:
    """Packed all-free initial sweep state, as host numpy arrays.

    Returns ``(fc0, um0, up0, slots0, rej0)``: free cores per (lane,
    server) — padded server columns pinned to the negative sentinel so
    they never win a best fit — used local GB, used pool GB per (lane,
    group), the slot array (-1 = empty) and the int32 reject counters.
    K1 takes the true counts (``s_pad = n_servers``, ``g_pad = n_groups``);
    a trace batch stacks its traces' lanes trace-major (``width`` = traces
    x candidates, the slot count the largest trace's).
    """
    neg = state_sentinel("int16" if np_dt == np.int16 else "int32")
    fc0 = np.full((width, s_pad), -neg, np_dt)
    fc0[:, :n_servers] = np_dt(cores_per_server)
    um0 = np.zeros((width, s_pad), np_dt)
    up0 = np.zeros((width, g_pad), np_dt)
    slots0 = np.full((n_slots, width), -1, np_dt)
    rej0 = np.zeros(width, np.int32)
    return fc0, um0, up0, slots0, rej0


def assign_slots(ev_kind, ev_vm, n_vms: int) -> tuple:
    """Map each event's VM to a reusable placement slot.

    Slots free on departure, so the per-candidate placement state is
    sized by PEAK CONCURRENCY rather than trace length.  Returns the
    per-event slot array and the slot count.
    """
    slot_of = np.zeros(n_vms, np.int64)
    ev_slot = np.zeros(len(ev_kind), np.int64)
    free_slots: list[int] = []
    next_slot = 0
    for e in range(len(ev_kind)):
        v = ev_vm[e]
        kind = ev_kind[e]
        if kind == ARRIVE:
            if free_slots:
                slot_of[v] = free_slots.pop()
            else:
                slot_of[v] = next_slot
                next_slot += 1
        ev_slot[e] = slot_of[v]
        if kind == DEPART:
            free_slots.append(int(slot_of[v]))
    return ev_slot, next_slot
