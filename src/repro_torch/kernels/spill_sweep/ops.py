"""Wrapper for the zNUMA spill sweep (K6): checks, dispatch, launch count.

A CUDA tensor goes to the hand-written kernel or raises; a CPU tensor goes
to the plain version, and only because it lies on the CPU.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels.spill_sweep import kernel as K
from repro_torch.kernels.spill_sweep import ref as R

# Number of kernel launches made by this process; callers that want to
# show a path went through the kernel set it to 0 and read it afterwards.
launches = 0
# The plan (kernel.Plan) of the last launch.
last_plan = None


def _check(kind, key, num_local, num_pool, n_keys, tier):
    if kind.dim() != 2 or key.shape != kind.shape:
        raise ValueError("spill_sweep: kind and key are (K, E) of one shape, "
                         f"got {tuple(kind.shape)} and {tuple(key.shape)}")
    if num_local.dim() != 1 or num_pool.shape != num_local.shape:
        raise ValueError("spill_sweep: num_local and num_pool are (C,) of "
                         f"one shape, got {tuple(num_local.shape)} and "
                         f"{tuple(num_pool.shape)}")
    n_streams, c = kind.shape[0], num_local.shape[0]
    if not 1 <= n_streams <= K.MAX_STREAMS or c == 0 or n_keys < 1:
        raise ValueError(f"spill_sweep: 1 to {K.MAX_STREAMS} streams, at "
                         f"least one lane and one key, got {n_streams}, {c} "
                         f"and {n_keys}")
    ints = (kind, key, num_local, num_pool)
    if any(t.dtype != torch.int32 for t in ints):
        raise TypeError("spill_sweep: kind, key, num_local and num_pool are "
                        f"int32, got {[t.dtype for t in ints]}")
    if tier is not None and (tier.shape != (n_streams, n_keys, c)
                             or tier.dtype != torch.int8):
        raise ValueError(f"spill_sweep: tier is ({n_streams}, {n_keys}, {c}) "
                         f"int8, got {tuple(tier.shape)} {tier.dtype}")
    tensors = ints + ((tier,) if tier is not None else ())
    if any(t.device != kind.device for t in tensors):
        raise ValueError("spill_sweep: tensors lie on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("spill_sweep: tensors must be contiguous")
    live = (kind == R.ALLOC) | (kind == R.FREE)
    if bool(live.any()):
        lo, hi = int(key[live].min()), int(key[live].max())
        if lo < 0 or hi >= n_keys:
            bad = lo if lo < 0 else hi
            raise ValueError(f"spill_sweep: an ALLOC or FREE has key {bad}, "
                             f"outside [0, {n_keys}) (the tier map's keys)")


def spill_sweep(kind, key, num_local, num_pool, n_keys: int, tier=None):
    """Replay K alloc/free streams for every config lane.

    ``kind``, ``key``: (K, E) int32 (ALLOC 0, FREE 1, anything else a
    no-op); ``num_local``, ``num_pool``: (C,) int32 tier sizes; keys of
    ALLOC and FREE events in ``[0, n_keys)`` (others raise).  ``tier``:
    optional (K, n_keys, C) int8 scratch that holds each key's tier on
    exit (-1 unbound, 0 local, 1 pool); allocated when None.  Returns
    ``(allocs, pool_allocs, failed, local_in_use, pool_in_use)``, five
    (K, C) int32 tensors.
    """
    global launches, last_plan
    _check(kind, key, num_local, num_pool, n_keys, tier)
    n_streams, n_events = kind.shape
    c = num_local.shape[0]
    if tier is None:
        tier = torch.empty((n_streams, n_keys, c), dtype=torch.int8,
                           device=kind.device)
    if kind.device.type == "cpu":
        return R.spill_sweep_ref(kind, key, num_local, num_pool, tier)
    if kind.device.type != "cuda":
        raise ValueError(f"spill_sweep: no kernel for {kind.device}")
    # the kernel stages each stream's row 16 bytes a copy: rows of a
    # multiple of 4 events (PAD at the end) in fresh, aligned storage
    pad = -n_events % 4
    if pad:
        kind = torch.nn.functional.pad(kind, (0, pad), value=R.PAD)
        key = torch.nn.functional.pad(key, (0, pad), value=0)
    elif kind.data_ptr() % 16 or key.data_ptr() % 16:
        kind, key = kind.clone(), key.clone()
    out = torch.empty((5, n_streams, c), dtype=torch.int32,
                      device=kind.device)
    plan = K.plan(c, n_streams, _sm_count(kind.device))
    K.spill_sweep_kernel(kind, key, num_local, num_pool, tier, out,
                         plan=plan)
    launches += 1
    last_plan = plan
    return tuple(out)


@functools.cache
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count
