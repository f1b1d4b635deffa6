"""Binding of the hand-written CUDA failure sweep (K5).

The kernel is ``csrc/fail_sweep.cu``; it replaces the reference's
``src/repro/core/sweep_core.py::build_fail_sweep`` (a ``lax.scan``; the
design note is at the top of the source).  This module builds it at first
use, plans a launch (servers a thread, lanes a block, warps a lane, where a
lane's slot and payload columns live) and hands raw pointers and the traces' places in the event arrays to its C entry point;
shapes, dtypes and contiguity are the wrapper's business (``ops.py``).  The
launch plan is K1's (``kernels/event_sweep/kernel.py``) with K5's shared
memory: a lane's payload column (four int32 a slot) beside its slot
column, the FAIL pass's three int32 arrays of S and a few words.
"""
from __future__ import annotations

import ctypes
import dataclasses
import re

import torch

from repro_torch.kernels.build import bind, ptxas_entries
from repro_torch.kernels.event_sweep import kernel as K1

NAME = "fail_sweep"
SOURCE = "src/repro_torch/csrc/fail_sweep.cu"
STATE_DTYPES = K1.STATE_DTYPES
TILE = K1.TILE
STAGES = K1.STAGES
STAGED = 8                       # event arrays staged: all eight
MAX_TRACES = K1.MAX_TRACES
MAX_SHARED = K1.MAX_SHARED
# warps a block: its lanes times each lane's warps (one walks the events,
# the others help at a FAIL)
MAX_WARPS_PER_BLOCK = 8
MAX_LANES_PER_BLOCK = MAX_WARPS_PER_BLOCK
# slots a thread reads at a time in a FAIL's stride (kScan)
SCAN = 8
# a lane's words beside its arrays (kLaneWords)
LANE_WORDS = 64
# the registers design only: K = S / 32 servers a thread, at most 16
MAX_SERVERS = K1.MAX_REGISTER_SERVERS
# where a lane's slot and payload columns live: shared memory while they
# fit beside the stages, else global memory (the slot column in ``slots``,
# the payload in a scratch tensor)
SLOT_COLUMNS = K1.SLOT_COLUMNS
# a slot's payload: cores, local, pool, departure minute, int32 each
PAYLOAD_BYTES = 16

_fns = None


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one sweep launches: servers a thread, lanes a block, where a
    lane's slot and payload columns live (one of :data:`SLOT_COLUMNS`) and
    warps a lane (the first walks the events, the others share each FAIL's
    strides)."""
    servers_per_thread: int
    lanes_per_block: int
    slot_column: str = "shared"
    warps: int = 1


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def servers_per_thread(n_servers: int) -> int:
    """K: the least power of two with 32 K >= S.  Raises beyond
    :data:`MAX_SERVERS` (the shared-memory variant K1 has there is not
    written for K5: ROADMAP Queue 2, K5)."""
    if n_servers > MAX_SERVERS:
        raise ValueError(
            f"fail_sweep: at most {MAX_SERVERS} servers (a thread's servers "
            f"in registers), got {n_servers}; more servers are ROADMAP "
            "Queue 2, K5 (a shared-memory variant)")
    return K1.servers_per_thread(n_servers)


def shared_bytes(n_servers: int, n_slots: int, item: int, lanes: int,
                 slot_column: str = "shared") -> int:
    """A block's shared memory: two stages of the eight int32 event
    arrays, ``group_of``, and a region a lane: its slot column in the
    state's type (``item`` bytes) and its payload column
    (:data:`PAYLOAD_BYTES` a slot), neither where they lie in global
    memory, the FAIL pass's three int32 arrays of S and
    :data:`LANE_WORDS` words; the columns and the arrays rounded to 16
    bytes.  The C entry point computes the same."""
    cols = n_slots if slot_column == "shared" else 0
    per_lane = (_round16(cols * item) + _round16(cols * PAYLOAD_BYTES)
                + _round16(3 * n_servers * 4) + 4 * LANE_WORDS)
    return (STAGES * STAGED * TILE * 4 + _round16(n_servers * 4)
            + lanes * per_lane)


def choose_slot_column(n_servers: int, n_slots: int, item: int) -> str:
    """Shared memory while one lane's slot and payload columns fit there
    beside the stages and the FAIL pass's arrays, else global memory."""
    fits = shared_bytes(n_servers, n_slots, item, 1, "shared") <= MAX_SHARED
    return "shared" if fits else "global"


def lanes_per_block(n_lanes: int, n_servers: int, n_slots: int, item: int,
                    sm_count: int, n_traces: int = 1,
                    slot_column: str = "shared") -> int:
    """Lanes a block holds, by K1's rule (one a block while there are no
    more lanes in all than SMs, then as many as spread the lanes evenly,
    at most ``MAX_LANES_PER_BLOCK``, no more than a trace has), as many as
    K5's shared memory takes; raises when not even one fits."""
    need = shared_bytes(n_servers, n_slots, item, 1, slot_column)
    if need > MAX_SHARED:
        raise ValueError(
            f"fail_sweep: one lane ({n_servers} servers, {n_slots} slots at "
            f"{item} bytes, the columns in {slot_column} memory) and the "
            f"event stages need {need} bytes of shared memory; a block has "
            f"at most {MAX_SHARED}")
    want = min(MAX_LANES_PER_BLOCK, n_lanes,
               max(1, -(-(n_traces * n_lanes) // sm_count)))
    while want > 1 and shared_bytes(n_servers, n_slots, item, want,
                                    slot_column) > MAX_SHARED:
        want -= 1
    return want


def warps_per_lane(n_lanes: int, n_slots: int, sm_count: int,
                   n_traces: int = 1, lanes: int = 1) -> int:
    """Warps a lane: while every lane has a block of its own (no more lanes
    in all than SMs), enough that each of a FAIL's strides is one batch of
    :data:`SCAN` slots a thread, at most ``MAX_WARPS_PER_BLOCK``; else 1
    (the lanes fill the SMs)."""
    if lanes > 1 or n_traces * n_lanes > sm_count:
        return 1
    return max(1, min(MAX_WARPS_PER_BLOCK, -(-n_slots // (32 * SCAN))))


def plan(n_lanes: int, n_servers: int, n_slots: int, item: int,
         sm_count: int, n_traces: int = 1,
         slot_column: str | None = None, warps: int | None = None) -> Plan:
    """The launch plan of one sweep of ``n_traces`` traces, ``n_lanes``
    lanes a trace; ``slot_column`` forces one of :data:`SLOT_COLUMNS`
    (None: :func:`choose_slot_column`), ``warps`` the warps a lane (None:
    :func:`warps_per_lane`)."""
    k = servers_per_thread(n_servers)
    slot_column = slot_column or choose_slot_column(n_servers, n_slots,
                                                    item)
    if slot_column not in SLOT_COLUMNS:
        raise ValueError(f"fail_sweep: slot_column {slot_column!r} is not "
                         f"one of {SLOT_COLUMNS}")
    lanes = lanes_per_block(n_lanes, n_servers, n_slots, item, sm_count,
                            n_traces, slot_column)
    warps = warps or warps_per_lane(n_lanes, n_slots, sm_count, n_traces,
                                    lanes)
    if not 1 <= warps * lanes <= MAX_WARPS_PER_BLOCK:
        raise ValueError(f"fail_sweep: {warps} warps a lane x {lanes} lanes "
                         f"a block exceed {MAX_WARPS_PER_BLOCK} warps")
    return Plan(k, lanes, slot_column, warps)


def payload_scratch(plan: Plan, n_lanes: int, n_slots: int, device):
    """The lanes' payload columns in global memory where the plan puts the
    columns there ((C, n_slots, 4) int32), else None."""
    if plan.slot_column != "global":
        return None
    return torch.empty((n_lanes, n_slots, 4), dtype=torch.int32,
                       device=device)


_NAME = re.compile(r"fail_sweep_kernelI([si])Li(\d+)ELb([01])ELb([01])E")


def ptxas_report(log: str) -> list[dict]:
    """Registers, stack frame and spills of each instantiation, from the
    ``nvcc -Xptxas -v`` log (``build.ptxas_entries``), with the state
    type, servers a thread, the batched build and the columns'
    place read from the mangled name."""
    out = ptxas_entries(log)
    for cur in out:
        if n := _NAME.search(cur["function"]):
            cur.update(variant="registers",
                       state_dtype="int16" if n.group(1) == "s" else "int32",
                       servers_per_thread=int(n.group(2)),
                       batched=n.group(3) == "1",
                       slot_column="global" if n.group(4) == "1"
                       else "shared")
    return out


def _functions():
    """(launch, error_string) of the built library, bound once."""
    global _fns
    if _fns is None:
        ints = ctypes.POINTER(ctypes.c_int)
        _fns = bind(NAME, [ctypes.c_void_p] * 8 + [ints, ints, ctypes.c_int]
                    + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 12
                    + [ctypes.c_void_p])
    return _fns


def build() -> None:
    """Compile and load the kernel now (otherwise done at first launch)."""
    _functions()


def fail_sweep_kernel(events, group_of, fc, um, up, slots, down, sgb, pgb,
                      out, dist, *, remigrate: bool, plan: Plan,
                      trace_starts, trace_counts) -> None:
    """Enqueue one sweep of every trace's events on PyTorch's current
    stream of ``fc``'s device; updates fc, um, up, slots, down, out and
    dist in place (the payload columns in :func:`payload_scratch` where
    the plan puts them in global memory); does not synchronise.  Arguments
    are CUDA tensors the wrapper has already checked (``dist`` may be
    None), the trace layout host ints (starts multiples of 4); ``plan`` is
    :func:`plan`'s."""
    launch, err = _functions()
    n_lanes, n_servers = fc.shape
    payload = payload_scratch(plan, n_lanes, slots.shape[0], fc.device)
    n_traces = len(trace_starts)
    starts = (ctypes.c_int * n_traces)(*trace_starts)
    counts = (ctypes.c_int * n_traces)(*trace_counts)
    with torch.cuda.device(fc.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(*(e.data_ptr() for e in events), starts, counts,
                    n_traces, group_of.data_ptr(), fc.data_ptr(),
                    um.data_ptr(), up.data_ptr(), slots.data_ptr(),
                    down.data_ptr(), sgb.data_ptr(), pgb.data_ptr(),
                    None if payload is None else payload.data_ptr(),
                    out.data_ptr(),
                    None if dist is None else dist.data_ptr(),
                    0 if dist is None else dist.shape[0], int(remigrate),
                    events[0].shape[0], n_lanes, n_servers, up.shape[1],
                    slots.shape[0], fc.element_size(),
                    plan.servers_per_thread, plan.lanes_per_block,
                    plan.warps, int(plan.slot_column == "global"), stream)
    if rc != 0:
        raise RuntimeError(f"fail_sweep kernel launch failed ({rc}): "
                           f"{err(rc).decode()}")
