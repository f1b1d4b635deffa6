"""Binding of the hand-written CUDA pod sweep (K4).

The kernel is ``csrc/pod_sweep.cu``; it replaces the reference's
``src/repro/core/sweep_core.py::build_pod_sweep`` (a ``lax.scan``; the
design note is at the top of the source).  This module builds it at first
use, plans a launch (servers a thread, the table build, lanes a block,
where the slot and pod columns live) and hands raw pointers and the traces'
places in the event arrays to its C entry point; shapes, dtypes and
contiguity are the wrapper's business (``ops.py``).  The launch plan is
K1's (``kernels/event_sweep/kernel.py``) with K4's shared memory (a lane's
slot column and pod column) and K4's table build: the entries a thread
keeps for the distinct pods its servers' rows list, the least build that
holds the launch's widest thread (:func:`widest_distinct`).
"""
from __future__ import annotations

import ctypes
import dataclasses
import re

import torch

from repro_torch.kernels.build import bind, ptxas_entries
from repro_torch.kernels.event_sweep import kernel as K1

NAME = "pod_sweep"
SOURCE = "src/repro_torch/csrc/pod_sweep.cu"
STATE_DTYPES = K1.STATE_DTYPES
TILE = K1.TILE
STAGES = K1.STAGES
MAX_LANES_PER_BLOCK = K1.MAX_LANES_PER_BLOCK
MAX_TRACES = K1.MAX_TRACES
MAX_SHARED = K1.MAX_SHARED
# the registers design only: K = S / 32 servers a thread, at most 16
MAX_SERVERS = K1.MAX_REGISTER_SERVERS
# pods a server's row lists, at most
MAX_FANOUT = 3
# the table builds (entries a thread) between one pod a thread and the
# catch-all MAX_FANOUT * K, which holds any thread
MID_DISTINCT = 8
SLOT_COLUMNS = K1.SLOT_COLUMNS

_fns = None


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one sweep launches: servers a thread, the widest row's pods,
    lanes (warps) a block, where a lane's slot and pod columns live (one of
    :data:`SLOT_COLUMNS`) and the table build (entries a thread, one of
    :func:`distinct_builds`)."""
    servers_per_thread: int
    fanout: int
    lanes_per_block: int
    slot_column: str
    distinct: int


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def servers_per_thread(n_servers: int) -> int:
    """K: the least power of two with 32 K >= S.  Raises beyond
    :data:`MAX_SERVERS` (the registers design; a shared-memory variant is
    not written for K4)."""
    if n_servers > MAX_SERVERS:
        raise ValueError(
            f"pod_sweep: at most {MAX_SERVERS} servers (a thread's servers "
            f"in registers), got {n_servers}")
    return K1.servers_per_thread(n_servers)


def distinct_builds(k: int) -> tuple[int, ...]:
    """The table builds at ``k`` servers a thread: 1, :data:`MID_DISTINCT`
    where it is below the catch-all, and the catch-all ``MAX_FANOUT * k``
    (a thread's servers list no more pods than that)."""
    top = MAX_FANOUT * k
    return tuple(d for d in (1, MID_DISTINCT) if d < top) + (top,)


def distinct_build(widest: int, k: int) -> int:
    """The least table build at ``k`` servers a thread that holds a thread
    whose servers list ``widest`` distinct pods; raises beyond the
    catch-all."""
    for d in distinct_builds(k):
        if d >= widest:
            return d
    raise ValueError(
        f"pod_sweep: a thread's servers list {widest} distinct pods; the "
        f"table holds at most {MAX_FANOUT * k} at {k} servers a thread")


def widest_distinct(inc: torch.Tensor, k: int) -> torch.Tensor:
    """The most distinct pods that the rows of one thread's ``k`` servers
    list, over every lane of ``inc`` (C, S, F) (thread t owns servers
    [t k, t k + k)): a 0-d int64 tensor on ``inc``'s device, so that the
    wrapper reads it in the sync it already makes."""
    c, s, f = inc.shape
    x = torch.nn.functional.pad(inc, (0, 0, 0, 32 * k - s), value=-1) \
        if 32 * k > s else inc
    x = x.reshape(c, 32, k * f).sort(-1).values
    new = x >= 0
    new[..., 1:] &= x[..., 1:] != x[..., :-1]
    return new.sum(-1, dtype=torch.int64).max()


def shared_bytes(n_slots: int, item: int, lanes: int,
                 slot_column: str = "shared") -> int:
    """A block's shared memory: two stages of six int32 event arrays and a
    region a lane: its slot column and its pod column in the state's type
    (``item`` bytes), each rounded to 16 bytes, none where they lie in
    global memory.  The C entry point computes the same."""
    per_lane = 2 * _round16(n_slots * item) if slot_column == "shared" else 0
    return STAGES * 6 * TILE * 4 + lanes * per_lane


def choose_slot_column(n_slots: int, item: int) -> str:
    """Shared memory while one lane's two columns fit there beside the
    stages, else global memory."""
    return "shared" if shared_bytes(n_slots, item, 1) <= MAX_SHARED \
        else "global"


def lanes_per_block(n_lanes: int, n_slots: int, item: int, sm_count: int,
                    n_traces: int = 1, slot_column: str = "shared") -> int:
    """Lanes (warps) a block holds, by K1's rule (one a block while there
    are no more lanes in all than SMs, then as many as spread the lanes
    evenly, at most ``MAX_LANES_PER_BLOCK``, no more than a trace has), as
    many as the shared memory takes; raises when not even one fits."""
    need = shared_bytes(n_slots, item, 1, slot_column)
    if need > MAX_SHARED:
        raise ValueError(
            f"pod_sweep: one lane ({n_slots} slots at {item} bytes, the "
            f"columns in {slot_column} memory) and the event stages need "
            f"{need} bytes of shared memory; a block has at most "
            f"{MAX_SHARED}")
    want = min(MAX_LANES_PER_BLOCK, n_lanes,
               max(1, -(-(n_traces * n_lanes) // sm_count)))
    while want > 1 and shared_bytes(n_slots, item, want,
                                    slot_column) > MAX_SHARED:
        want -= 1
    return want


def plan(n_lanes: int, n_servers: int, fanout: int, n_slots: int,
         item: int, sm_count: int, n_traces: int = 1,
         slot_column: str | None = None, distinct: int | None = None
         ) -> Plan:
    """The launch plan of one sweep of ``n_traces`` traces, ``n_lanes``
    lanes a trace, rows of ``fanout`` pods; ``slot_column`` forces one of
    :data:`SLOT_COLUMNS` (None: :func:`choose_slot_column`); ``distinct``
    is the widest thread's distinct pods (:func:`widest_distinct`; None:
    the catch-all build, which holds any thread)."""
    k = servers_per_thread(n_servers)
    if fanout > MAX_FANOUT:
        raise ValueError(f"pod_sweep: at most {MAX_FANOUT} pods a server's "
                         f"row, got {fanout}")
    d = distinct_build(MAX_FANOUT * k if distinct is None else distinct, k)
    slot_column = slot_column or choose_slot_column(n_slots, item)
    if slot_column not in SLOT_COLUMNS:
        raise ValueError(f"pod_sweep: slot_column {slot_column!r} is not "
                         f"one of {SLOT_COLUMNS}")
    lanes = lanes_per_block(n_lanes, n_slots, item, sm_count, n_traces,
                            slot_column)
    return Plan(k, fanout, lanes, slot_column, d)


_NAME = re.compile(
    r"pod_sweep_kernelI([si])Li(\d+)ELi(\d+)ELb([01])ELb([01])E")


def ptxas_report(log: str) -> list[dict]:
    """Registers, stack frame and spills of each instantiation, from the
    ``nvcc -Xptxas -v`` log (``build.ptxas_entries``), with the state type,
    servers a thread, the table build, the batched build and the columns'
    place read from the mangled name."""
    out = ptxas_entries(log)
    for cur in out:
        if n := _NAME.search(cur["function"]):
            cur.update(variant="registers",
                       state_dtype="int16" if n.group(1) == "s" else "int32",
                       servers_per_thread=int(n.group(2)),
                       distinct=int(n.group(3)),
                       batched=n.group(4) == "1",
                       slot_column="global" if n.group(5) == "1"
                       else "shared")
    return out


def _functions():
    """(launch, error_string) of the built library, bound once."""
    global _fns
    if _fns is None:
        ints = ctypes.POINTER(ctypes.c_int)
        _fns = bind(NAME, [ctypes.c_void_p] * 6 + [ints, ints, ctypes.c_int]
                    + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 11
                    + [ctypes.c_void_p])
    return _fns


def build() -> None:
    """Compile and load the kernel now (otherwise done at first launch)."""
    _functions()


def pod_sweep_kernel(events, inc, fc, um, up, slots, pods, sgb, pgb,
                     rejects, *, plan: Plan, trace_starts, trace_counts
                     ) -> None:
    """Enqueue one sweep of every trace's events on PyTorch's current
    stream of ``fc``'s device; updates fc, um, up, slots, pods and rejects
    in place; does not synchronise.  Arguments are CUDA tensors the
    wrapper has already checked, the trace layout host ints (starts
    multiples of 4); ``plan`` is :func:`plan`'s."""
    launch, err = _functions()
    n_lanes, n_servers = fc.shape
    n_traces = len(trace_starts)
    starts = (ctypes.c_int * n_traces)(*trace_starts)
    counts = (ctypes.c_int * n_traces)(*trace_counts)
    with torch.cuda.device(fc.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(*(e.data_ptr() for e in events), starts, counts,
                    n_traces, inc.data_ptr(), fc.data_ptr(), um.data_ptr(),
                    up.data_ptr(), slots.data_ptr(), pods.data_ptr(),
                    sgb.data_ptr(), pgb.data_ptr(), rejects.data_ptr(),
                    events[0].shape[0], n_lanes, n_servers, up.shape[1],
                    inc.shape[2], slots.shape[0], fc.element_size(),
                    plan.servers_per_thread, plan.distinct,
                    plan.lanes_per_block, int(plan.slot_column == "global"),
                    stream)
    if rc != 0:
        raise RuntimeError(f"pod_sweep kernel launch failed ({rc}): "
                           f"{err(rc).decode()}")
