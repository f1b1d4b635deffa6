"""Binding of the hand-written CUDA failure sweep (K5).

The kernel is ``csrc/fail_sweep.cu``; it replaces the reference's
``src/repro/core/sweep_core.py::build_fail_sweep`` (a ``lax.scan``; the
design note is at the top of the source).  This module builds it at first
use, plans a launch (servers a thread, lanes a block, where the slot column
lives) and hands raw pointers and the traces' places in the event arrays to
its C entry point; shapes, dtypes and contiguity are the wrapper's business
(``ops.py``).  The launch plan is K1's (``kernels/event_sweep/kernel.py``)
with K5's shared memory: a lane's FAIL pass adds three int32 arrays of S.
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
MAX_LANES_PER_BLOCK = K1.MAX_LANES_PER_BLOCK
MAX_TRACES = K1.MAX_TRACES
MAX_SHARED = K1.MAX_SHARED
# the registers design only: K = S / 32 servers a thread, at most 16
MAX_SERVERS = K1.MAX_REGISTER_SERVERS
SLOT_COLUMNS = K1.SLOT_COLUMNS

_fns = None


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one sweep launches: servers a thread, lanes (warps) a block and
    where a lane's slot column lives (one of :data:`SLOT_COLUMNS`)."""
    servers_per_thread: int
    lanes_per_block: int
    slot_column: str = "shared"


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
    """A block's shared memory: two stages of six int32 event arrays,
    ``group_of``, and a region a lane: its slot column in the state's type
    (``item`` bytes; none where it lies in global memory) and the FAIL
    pass's three int32 arrays of S, each rounded to 16 bytes.  The C entry
    point computes the same."""
    per_lane = (_round16((n_slots if slot_column == "shared" else 0) * item)
                + _round16(3 * n_servers * 4))
    return STAGES * 6 * TILE * 4 + _round16(n_servers * 4) + lanes * per_lane


def choose_slot_column(n_servers: int, n_slots: int, item: int) -> str:
    """Shared memory while one lane's slot column fits there beside the
    stages and the FAIL pass's arrays, else global memory."""
    fits = shared_bytes(n_servers, n_slots, item, 1) <= MAX_SHARED
    return "shared" if fits else "global"


def lanes_per_block(n_lanes: int, n_servers: int, n_slots: int, item: int,
                    sm_count: int, n_traces: int = 1,
                    slot_column: str = "shared") -> int:
    """Lanes (warps) a block holds, by K1's rule (one a block while there
    are no more lanes in all than SMs, then as many as spread the lanes
    evenly, at most ``MAX_LANES_PER_BLOCK``, no more than a trace has),
    as many as K5's shared memory takes; raises when not even one fits."""
    need = shared_bytes(n_servers, n_slots, item, 1, slot_column)
    if need > MAX_SHARED:
        raise ValueError(
            f"fail_sweep: one lane ({n_servers} servers, {n_slots} slots at "
            f"{item} bytes, the slot column in {slot_column} memory) and the "
            f"event stages need {need} bytes of shared memory; a block has "
            f"at most {MAX_SHARED}")
    want = min(MAX_LANES_PER_BLOCK, n_lanes,
               max(1, -(-(n_traces * n_lanes) // sm_count)))
    while want > 1 and shared_bytes(n_servers, n_slots, item, want,
                                    slot_column) > MAX_SHARED:
        want -= 1
    return want


def plan(n_lanes: int, n_servers: int, n_slots: int, item: int,
         sm_count: int, n_traces: int = 1,
         slot_column: str | None = None) -> Plan:
    """The launch plan of one sweep of ``n_traces`` traces, ``n_lanes``
    lanes a trace; ``slot_column`` forces one of :data:`SLOT_COLUMNS`
    (None: :func:`choose_slot_column`)."""
    k = servers_per_thread(n_servers)
    slot_column = slot_column or choose_slot_column(n_servers, n_slots, item)
    if slot_column not in SLOT_COLUMNS:
        raise ValueError(f"fail_sweep: slot_column {slot_column!r} is not "
                         f"one of {SLOT_COLUMNS}")
    lanes = lanes_per_block(n_lanes, n_servers, n_slots, item, sm_count,
                            n_traces, slot_column)
    return Plan(k, lanes, slot_column)


_NAME = re.compile(r"fail_sweep_kernelI([si])Li(\d+)ELb([01])ELb([01])E")


def ptxas_report(log: str) -> list[dict]:
    """Registers, stack frame and spills of each instantiation, from the
    ``nvcc -Xptxas -v`` log (``build.ptxas_entries``), with the state type,
    servers a thread, the batched build and the slot column read from the
    mangled name."""
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
                    + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 11
                    + [ctypes.c_void_p])
    return _fns


def build() -> None:
    """Compile and load the kernel now (otherwise done at first launch)."""
    _functions()


def fail_sweep_kernel(events, group_of, fc, um, up, slots, down, sgb, pgb,
                      arrivals, out, dist, *, remigrate: bool, plan: Plan,
                      trace_starts, trace_counts) -> None:
    """Enqueue one sweep of every trace's events on PyTorch's current
    stream of ``fc``'s device; updates fc, um, up, slots, down, out and
    dist in place, ``arrivals`` is scratch; does not synchronise.
    Arguments are CUDA tensors the wrapper has already checked (``dist``
    may be None), the trace layout host ints (starts multiples of 4);
    ``plan`` is :func:`plan`'s."""
    launch, err = _functions()
    n_lanes, n_servers = fc.shape
    n_traces = len(trace_starts)
    starts = (ctypes.c_int * n_traces)(*trace_starts)
    counts = (ctypes.c_int * n_traces)(*trace_counts)
    with torch.cuda.device(fc.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(*(e.data_ptr() for e in events), starts, counts,
                    n_traces, group_of.data_ptr(), fc.data_ptr(),
                    um.data_ptr(), up.data_ptr(), slots.data_ptr(),
                    down.data_ptr(), sgb.data_ptr(), pgb.data_ptr(),
                    arrivals.data_ptr(), out.data_ptr(),
                    None if dist is None else dist.data_ptr(),
                    0 if dist is None else dist.shape[0], int(remigrate),
                    events[0].shape[0], n_lanes, n_servers, up.shape[1],
                    slots.shape[0], fc.element_size(),
                    plan.servers_per_thread, plan.lanes_per_block,
                    int(plan.slot_column == "global"), stream)
    if rc != 0:
        raise RuntimeError(f"fail_sweep kernel launch failed ({rc}): "
                           f"{err(rc).decode()}")
