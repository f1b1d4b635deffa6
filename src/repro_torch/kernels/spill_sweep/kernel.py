"""Binding of the hand-written CUDA zNUMA spill sweep (K6).

The kernel is ``csrc/spill_sweep.cu``; it replaces the reference's
``src/repro/core/latency_engine.py::_build_spill_sweep`` (a ``lax.scan``;
the design note is at the top of the source).  This module builds it at
first use, plans a launch (warps of 32 lanes a block, events a tile) and
hands raw pointers to its C entry points, the sweep (with the final
tier map) and the links pass, and the chain floor's probe (a measurement,
on no path); shapes, dtypes, contiguity, the keys' range and the links'
sort are the wrapper's business (``ops.py``).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels.build import load_library

NAME = "spill_sweep"
SOURCE = "src/repro_torch/csrc/spill_sweep.cu"
MAX_WARPS_PER_BLOCK = 8
MAX_STREAMS = 65535              # the grid's second extent
MAX_TILE = 2048                  # events a stage
STAGES = 2
AHEAD = 4                        # events the walk reads ahead
MAX_SHARED = 232448              # bytes of shared memory a block may use

_fns = None


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one sweep launches: warps (of 32 lanes) a block, blocks a
    stream and events a tile; the grid is (blocks a stream, streams)."""
    warps_per_block: int
    blocks_per_stream: int
    tile: int


def shared_bytes(tile: int, warps: int) -> int:
    """A block's shared memory: two stages of a tile's kinds and links
    (int32), each event's word slot (int32, ``AHEAD`` past the tile), and
    a buffer of two tiles of 8-byte words a warp.  The C entry point
    computes the same."""
    return STAGES * 2 * tile * 4 + (tile + AHEAD) * 4 + warps * 2 * tile * 8


def plan(n_lanes: int, n_streams: int, sm_count: int) -> Plan:
    """One warp a block while there are no more warps in all than SMs (a
    lane is a chain of dependent steps, so each warp wants an SM's issue
    slots to itself), then as many as spread all warps evenly over the
    SMs, at most ``MAX_WARPS_PER_BLOCK`` and no more than a stream's lanes
    fill (a block replays one stream); the tile is the largest power of
    two up to ``MAX_TILE`` whose stages and buffers fit a block's shared
    memory.  Neither depends on the stream's length or its keys."""
    if n_lanes < 1 or n_streams < 1:
        raise ValueError(f"spill_sweep: lanes and streams must be at least "
                         f"1, got {n_lanes} and {n_streams}")
    warps = -(-n_lanes // 32)
    w = min(MAX_WARPS_PER_BLOCK, warps,
            max(1, -(-(n_streams * warps) // sm_count)))
    tile = MAX_TILE
    while shared_bytes(tile, w) > MAX_SHARED:
        tile //= 2
    return Plan(w, -(-warps // w), tile)


@functools.cache
def sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _functions():
    """(sweep launch, links launch, error_string, chain launch) of the
    built library, bound once (every pointer and the stream as
    ``c_void_p``: ctypes would cut a bare Python int to 32 bits)."""
    global _fns
    if _fns is None:
        lib = load_library(NAME)
        sweep, links = lib.spill_sweep_launch, lib.spill_links_launch
        chain = lib.spill_chain_launch
        sweep.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                          + [ctypes.c_void_p])
        links.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                          + [ctypes.c_void_p])
        chain.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        sweep.restype = links.restype = chain.restype = ctypes.c_int
        err = lib.spill_sweep_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _fns = sweep, links, err, chain
    return _fns


def build() -> None:
    """Compile and load the kernel now (otherwise done at first launch)."""
    _functions()


def _raise(rc: int, what: str, err) -> None:
    if rc != 0:
        raise RuntimeError(f"spill_sweep {what} launch failed ({rc}): "
                           f"{err(rc).decode()}")


def spill_links_kernel(skey, order, prev, last) -> None:
    """Enqueue the links pass on PyTorch's current stream of ``skey``'s
    device: from the stable sort of each stream's keys (``skey`` (K, E)
    int32, no-ops as n_keys; ``order`` (K, E) int64), writes ``prev``
    (K, E) and ``last`` (K, n_keys) int32 (-1 on entry)."""
    _, links, err, _ = _functions()
    n_streams, n_events = skey.shape
    with torch.cuda.device(skey.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = links(skey.data_ptr(), order.data_ptr(), prev.data_ptr(),
                   last.data_ptr(), n_streams, n_events, last.shape[1],
                   stream)
    _raise(rc, "links", err)


def spill_sweep_kernel(kind, prev, last, num_local, num_pool, words, tier,
                       out, *, plan: Plan) -> None:
    """Enqueue one sweep and the final tier map on PyTorch's current
    stream of ``kind``'s device; writes ``words`` (scratch), ``tier`` and
    ``out`` (5, K, C); does not synchronise.  The arguments are CUDA
    tensors the wrapper has already checked and built (E a multiple of 4,
    the links of ``kind``'s streams)."""
    sweep, _, err, _ = _functions()
    n_streams, n_events = kind.shape
    with torch.cuda.device(kind.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = sweep(kind.data_ptr(), prev.data_ptr(), last.data_ptr(),
                   num_local.data_ptr(), num_pool.data_ptr(),
                   words.data_ptr(), tier.data_ptr(), out.data_ptr(),
                   n_streams, n_events, num_local.shape[0], tier.shape[1],
                   plan.warps_per_block, plan.tile, sm_count(kind.device),
                   stream)
    _raise(rc, "kernel", err)


def spill_chain_kernel(steps: int, out) -> None:
    """Enqueue the chain floor's probe on PyTorch's current stream of
    ``out``'s device: one warp replays ``steps`` (a positive multiple of
    8) steps of the walk's free counter chain alone; ``out`` (32,) int32
    takes each thread's counter.  A measurement, on no path of the port."""
    _, _, err, chain = _functions()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = chain(steps, out.data_ptr(), stream)
    _raise(rc, "chain probe", err)
