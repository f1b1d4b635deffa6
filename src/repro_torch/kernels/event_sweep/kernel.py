"""Binding of the hand-written CUDA event-sweep kernel (K1).

The kernel is ``csrc/event_sweep.cu``; it replaces the reference's
``src/repro/core/sweep_core.py::build_sweep`` (a ``lax.scan``; the design
note is at the top of the source).  This module builds it at first use,
plans how many candidate lanes share a block and hands raw pointers to its
C entry point; shapes, dtypes and contiguity are the wrapper's business
(``ops.py``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import bind

NAME = "event_sweep"
SOURCE = "src/repro_torch/csrc/event_sweep.cu"
STATE_DTYPES = (torch.int16, torch.int32)
TILE = 1024                      # events a shared-memory stage
STAGES = 2
MAX_LANES_PER_BLOCK = 8          # warps (one a lane) of a block
MAX_SHARED = 232448              # bytes of shared memory a block may use

_fns = None


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def shared_bytes(n_servers: int, n_groups: int, n_slots: int, item: int,
                 lanes: int) -> int:
    """A block's shared memory: two stages of six int32 event arrays,
    ``group_of``, and one region a lane holding its fc, um, up and slot
    column in the state's type (``item`` bytes), each rounded to 16 bytes.
    The C entry point computes the same."""
    lane = _round16((2 * n_servers + n_groups + n_slots) * item)
    return STAGES * 6 * TILE * 4 + _round16(n_servers * 4) + lanes * lane


def lanes_per_block(n_lanes: int, n_servers: int, n_groups: int,
                    n_slots: int, item: int, sm_count: int) -> int:
    """Lanes (warps) a block holds: few enough that the blocks spread over
    every SM (a lane is a sequential chain of events, so each wants an
    SM's issue slots to itself), at most ``MAX_LANES_PER_BLOCK``, and no
    more than the shared memory holds.  Raises, with the limit, when not
    even one lane fits."""
    want = min(MAX_LANES_PER_BLOCK, max(1, -(-n_lanes // sm_count)))
    while want > 1 and shared_bytes(n_servers, n_groups, n_slots, item,
                                    want) > MAX_SHARED:
        want -= 1
    need = shared_bytes(n_servers, n_groups, n_slots, item, 1)
    if need > MAX_SHARED:
        raise ValueError(
            f"event_sweep: one lane's state ({n_servers} servers, "
            f"{n_groups} groups, {n_slots} slots at {item} bytes) and the "
            f"event stages need {need} bytes of shared memory; a block has "
            f"at most {MAX_SHARED}")
    return want


def _functions():
    """(launch, error_string) of the built library, bound once."""
    global _fns
    if _fns is None:
        _fns = bind(NAME, [ctypes.c_void_p] * 14 + [ctypes.c_int] * 7
                    + [ctypes.c_void_p])
    return _fns


def build() -> None:
    """Compile and load the kernel now (otherwise done at first launch)."""
    _functions()


def event_sweep_kernel(events, group_of, fc, um, up, slots, sgb, pgb,
                       rejects, *, lanes: int) -> None:
    """Enqueue one sweep over all events on PyTorch's current stream of
    ``fc``'s device; updates fc, um, up, slots and rejects in place; does
    not synchronise.  Arguments are CUDA tensors the wrapper has already
    checked; ``lanes`` is :func:`lanes_per_block`'s plan."""
    launch, err = _functions()
    n_lanes, n_servers = fc.shape
    with torch.cuda.device(fc.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(*(e.data_ptr() for e in events), group_of.data_ptr(),
                    fc.data_ptr(), um.data_ptr(), up.data_ptr(),
                    slots.data_ptr(), sgb.data_ptr(), pgb.data_ptr(),
                    rejects.data_ptr(), events[0].shape[0], n_lanes,
                    n_servers, up.shape[1], slots.shape[0],
                    fc.element_size(), lanes, stream)
    if rc != 0:
        raise RuntimeError(f"event_sweep kernel launch failed ({rc}): "
                           f"{err(rc).decode()}")
