"""Binding of the hand-written CUDA event-sweep kernel (K1).

The kernel is ``csrc/event_sweep.cu``; it replaces the reference's
``src/repro/core/sweep_core.py::build_sweep`` (a ``lax.scan``; the design
note is at the top of the source).  This module builds it at first use,
plans a launch (the variant, servers a thread, how many candidate lanes
share a block) and hands raw pointers and the traces' places in the event
arrays to its C entry point; shapes, dtypes and contiguity are the
wrapper's business (``ops.py``).
"""
from __future__ import annotations

import ctypes
import dataclasses
import re

import torch

from repro_torch.kernels.build import bind, ptxas_entries

NAME = "event_sweep"
SOURCE = "src/repro_torch/csrc/event_sweep.cu"
STATE_DTYPES = (torch.int16, torch.int32)
TILE = 1024                      # events a shared-memory stage
STAGES = 2
MAX_LANES_PER_BLOCK = 8          # warps (one a lane) of a block
MAX_TRACES = 256                 # traces a launch (the kernel's table)
MAX_SHARED = 232448              # bytes of shared memory a block may use
# the registers variant: servers a thread, a template parameter of the
# kernel; it covers S <= 32 * 16 servers, the shared variant any S whose
# lane fits a block's shared memory
SERVERS_PER_THREAD = (1, 2, 4, 8, 16)
MAX_REGISTER_SERVERS = 32 * SERVERS_PER_THREAD[-1]
# the variants and their codes at the C entry point; the registers variant
# takes its first minimum by one packed (f, server) key with int16 state,
# by two steps (least f, then least server) with int32
VARIANTS = {"shared": 0, "registers": 1}
# where a lane's slot column lives: shared memory while it fits beside the
# stages, else its column of the ``slots`` tensor in global memory
SLOT_COLUMNS = ("shared", "global")

_fns = None


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one sweep launches: the variant, servers a thread (0 for the
    shared variant), lanes (warps) a block and where a lane's slot column
    lives (one of :data:`SLOT_COLUMNS`)."""
    variant: str
    servers_per_thread: int
    lanes_per_block: int
    slot_column: str = "shared"


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def choose_variant(n_servers: int) -> str:
    """The registers variant up to MAX_REGISTER_SERVERS servers, the
    shared one beyond."""
    return "registers" if n_servers <= MAX_REGISTER_SERVERS else "shared"


def servers_per_thread(n_servers: int) -> int:
    """K of the registers variant: the least of SERVERS_PER_THREAD with
    32 K >= S.  Raises beyond MAX_REGISTER_SERVERS."""
    for k in SERVERS_PER_THREAD:
        if 32 * k >= n_servers:
            return k
    raise ValueError(f"event_sweep: the registers variant takes at most "
                     f"{MAX_REGISTER_SERVERS} servers, got {n_servers}")


def shared_bytes(n_servers: int, n_groups: int, n_slots: int, item: int,
                 lanes: int, variant: str = "registers",
                 slot_column: str = "shared") -> int:
    """A block's shared memory: two stages of six int32 event arrays,
    ``group_of``, and one region a lane in the state's type (``item``
    bytes): the slot column alone for the registers variants, fc, um, up
    and the slot column for the shared one, no slot column where it lies
    in global memory; each rounded to 16 bytes.  The C entry point
    computes the same."""
    per_lane = ((n_slots if slot_column == "shared" else 0)
                + (2 * n_servers + n_groups if variant == "shared" else 0))
    return (STAGES * 6 * TILE * 4 + _round16(n_servers * 4)
            + lanes * _round16(per_lane * item))


def choose_slot_column(n_servers: int, n_groups: int, n_slots: int,
                       item: int, variant: str = "registers") -> str:
    """Shared memory while one lane's slot column fits there beside the
    stages (and the shared variant's fc, um, up), else global memory."""
    fits = shared_bytes(n_servers, n_groups, n_slots, item, 1,
                        variant) <= MAX_SHARED
    return "shared" if fits else "global"


def lanes_per_block(n_lanes: int, n_servers: int, n_groups: int,
                    n_slots: int, item: int, sm_count: int,
                    variant: str = "registers", n_traces: int = 1,
                    slot_column: str = "shared") -> int:
    """Lanes (warps) a block holds, ``n_lanes`` being a trace's lanes and
    ``n_traces`` the traces of the launch: one a block while there are no
    more lanes in all than SMs (a lane is a sequential chain of events, so
    each wants an SM's issue slots to itself), then as many as spread all
    lanes evenly over the SMs, at most ``MAX_LANES_PER_BLOCK``, no more
    than a trace has (a block replays one trace) and no more than the
    shared memory holds.  Raises, with the limit, when not even one lane
    fits (a slot column kept in shared memory too large for it, or the
    shared variant's fc, um and up)."""
    need = shared_bytes(n_servers, n_groups, n_slots, item, 1, variant,
                        slot_column)
    if need > MAX_SHARED:
        raise ValueError(
            f"event_sweep: one lane of the {variant} variant ({n_servers} "
            f"servers, {n_groups} groups, {n_slots} slots at {item} bytes, "
            f"the slot column in {slot_column} memory) and the event "
            f"stages need {need} bytes of shared memory; a block has at "
            f"most {MAX_SHARED}")
    want = min(MAX_LANES_PER_BLOCK, n_lanes,
               max(1, -(-(n_traces * n_lanes) // sm_count)))
    while want > 1 and shared_bytes(n_servers, n_groups, n_slots, item,
                                    want, variant,
                                    slot_column) > MAX_SHARED:
        want -= 1
    return want


def plan(n_lanes: int, n_servers: int, n_groups: int, n_slots: int,
         item: int, sm_count: int, variant: str | None = None,
         n_traces: int = 1, slot_column: str | None = None) -> Plan:
    """The launch plan of one sweep of ``n_traces`` traces, ``n_lanes``
    lanes a trace; ``variant`` forces one of :data:`VARIANTS` (None:
    :func:`choose_variant`), ``slot_column`` one of :data:`SLOT_COLUMNS`
    (None: :func:`choose_slot_column`)."""
    variant = variant or choose_variant(n_servers)
    if variant not in VARIANTS:
        raise ValueError(f"event_sweep: variant {variant!r} is not one of "
                         f"{sorted(VARIANTS)}")
    slot_column = slot_column or choose_slot_column(
        n_servers, n_groups, n_slots, item, variant)
    if slot_column not in SLOT_COLUMNS:
        raise ValueError(f"event_sweep: slot_column {slot_column!r} is not "
                         f"one of {SLOT_COLUMNS}")
    shared = variant == "shared"
    k = 0 if shared else servers_per_thread(n_servers)
    lanes = lanes_per_block(n_lanes, n_servers, n_groups, n_slots, item,
                            sm_count, variant, n_traces, slot_column)
    return Plan(variant, k, lanes, slot_column)


_NAME = re.compile(
    r"sweep_(regs|shared)_kernelI([si])(?:Li(\d+)E)?(?:Lb([01])E)?"
    r"(?:Lb([01])E)?E")


def ptxas_report(log: str) -> list[dict]:
    """Registers, stack frame and spills of each kernel instantiation, from
    the ``nvcc -Xptxas -v`` log of the build (``build.ptxas_entries``); the
    variant, state type, servers a thread, whether it is the trace axis's
    batched build and where its slot column lives are read from the
    mangled name."""
    out = ptxas_entries(log)
    for cur in out:
        if n := _NAME.search(cur["function"]):
            regs = n.group(1) == "regs"
            cur.update(
                variant="registers" if regs else "shared",
                state_dtype="int16" if n.group(2) == "s" else "int32",
                servers_per_thread=int(n.group(3)) if regs else 0,
                batched=n.group(4) == "1",
                slot_column="global" if n.group(5) == "1" else "shared")
    return out


def _functions():
    """(launch, error_string) of the built library, bound once."""
    global _fns
    if _fns is None:
        ints = ctypes.POINTER(ctypes.c_int)
        _fns = bind(NAME, [ctypes.c_void_p] * 6 + [ints, ints, ctypes.c_int]
                    + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10
                    + [ctypes.c_void_p])
    return _fns


def build() -> None:
    """Compile and load the kernel now (otherwise done at first launch)."""
    _functions()


def event_sweep_kernel(events, group_of, fc, um, up, slots, sgb, pgb,
                       rejects, *, plan: Plan, trace_starts, trace_counts
                       ) -> None:
    """Enqueue one sweep of every trace's events on PyTorch's current
    stream of ``fc``'s device; updates fc, um, up, slots and rejects in
    place; does not synchronise.  Arguments are CUDA tensors the wrapper
    has already checked, the trace layout host ints (starts multiples of
    4); ``plan`` is :func:`plan`'s."""
    launch, err = _functions()
    n_lanes, n_servers = fc.shape
    n_traces = len(trace_starts)
    starts = (ctypes.c_int * n_traces)(*trace_starts)
    counts = (ctypes.c_int * n_traces)(*trace_counts)
    with torch.cuda.device(fc.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(*(e.data_ptr() for e in events), starts, counts,
                    n_traces, group_of.data_ptr(),
                    fc.data_ptr(), um.data_ptr(), up.data_ptr(),
                    slots.data_ptr(), sgb.data_ptr(), pgb.data_ptr(),
                    rejects.data_ptr(), events[0].shape[0], n_lanes,
                    n_servers, up.shape[1], slots.shape[0],
                    fc.element_size(), VARIANTS[plan.variant],
                    plan.servers_per_thread, plan.lanes_per_block,
                    int(plan.slot_column == "global"), stream)
    if rc != 0:
        raise RuntimeError(f"event_sweep kernel launch failed ({rc}): "
                           f"{err(rc).decode()}")
