"""Binding of the hand-written CUDA zNUMA spill sweep (K6).

The kernel is ``csrc/spill_sweep.cu``; it replaces the reference's
``src/repro/core/latency_engine.py::_build_spill_sweep`` (a ``lax.scan``;
the design note is at the top of the source).  This module builds it at
first use, plans a launch (warps of lanes a block) and hands raw pointers
to its C entry point; shapes, dtypes, contiguity and the keys' range are
the wrapper's business (``ops.py``).
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels.build import bind

NAME = "spill_sweep"
SOURCE = "src/repro_torch/csrc/spill_sweep.cu"
MAX_WARPS_PER_BLOCK = 8
MAX_STREAMS = 65535              # the grid's second extent

_fns = None


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one sweep launches: warps (of 32 lanes) a block and blocks a
    stream; the grid is (blocks a stream, streams)."""
    warps_per_block: int
    blocks_per_stream: int


def plan(n_lanes: int, n_streams: int, sm_count: int) -> Plan:
    """One warp a block while there are no more warps in all than SMs (a
    lane is a chain of dependent steps, so each warp wants an SM's issue
    slots to itself), then as many as spread all warps evenly over the
    SMs, at most ``MAX_WARPS_PER_BLOCK`` and no more than a stream's lanes
    fill (a block replays one stream)."""
    if n_lanes < 1 or n_streams < 1:
        raise ValueError(f"spill_sweep: lanes and streams must be at least "
                         f"1, got {n_lanes} and {n_streams}")
    warps = -(-n_lanes // 32)
    w = min(MAX_WARPS_PER_BLOCK, warps,
            max(1, -(-(n_streams * warps) // sm_count)))
    return Plan(w, -(-warps // w))


def _functions():
    """(launch, error_string) of the built library, bound once."""
    global _fns
    if _fns is None:
        _fns = bind(NAME, [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                    + [ctypes.c_void_p])
    return _fns


def build() -> None:
    """Compile and load the kernel now (otherwise done at first launch)."""
    _functions()


def spill_sweep_kernel(kind, key, num_local, num_pool, tier, out, *,
                       plan: Plan) -> None:
    """Enqueue one sweep on PyTorch's current stream of ``kind``'s device;
    writes ``tier`` and ``out`` (5, K, C); does not synchronise.  The
    arguments are CUDA tensors the wrapper has already checked (E a
    multiple of 4, every key of an ALLOC or FREE below ``n_keys``)."""
    launch, err = _functions()
    n_streams, n_events = kind.shape
    with torch.cuda.device(kind.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(kind.data_ptr(), key.data_ptr(), num_local.data_ptr(),
                    num_pool.data_ptr(), tier.data_ptr(), out.data_ptr(),
                    n_streams, n_events, num_local.shape[0], tier.shape[1],
                    plan.warps_per_block, stream)
    if rc != 0:
        raise RuntimeError(f"spill_sweep kernel launch failed ({rc}): "
                           f"{err(rc).decode()}")
