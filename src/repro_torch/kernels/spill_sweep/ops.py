"""Wrapper for the zNUMA spill sweep (K6): checks, dispatch, launch count.

A CUDA tensor goes to the hand-written kernel or raises; a CPU tensor goes
to the plain version, and only because it lies on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.spill_sweep import kernel as K
from repro_torch.kernels.spill_sweep import ref as R

# Number of kernel launches made by this process (a sweep with its final
# tier map), and of links passes; callers that want to show a path went
# through the kernels set them to 0 and read them afterwards.
launches = 0
link_launches = 0
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


def spill_links(kind, key, n_keys: int):
    """``prev`` (K, E) and ``last`` (K, n_keys) int32 of (K, E) int32
    event streams whose ALLOC and FREE keys lie in ``[0, n_keys)``: each
    event's previous ALLOC or FREE of its key in its stream and each key's
    last one, -1 for none (``ref.links_from_order``).  On the card: a
    stable device sort of each stream's keys (an index, no part of the
    sweep), then the hand-written links pass."""
    global link_launches
    if kind.device.type == "cpu":
        return R.spill_links(kind, key, n_keys)
    if kind.device.type != "cuda":
        raise ValueError(f"spill_sweep: no kernel for {kind.device}")
    live = (kind == R.ALLOC) | (kind == R.FREE)
    skey, order = torch.sort(torch.where(live, key, n_keys), dim=1,
                             stable=True)
    prev = torch.empty_like(kind)
    last = torch.full((kind.shape[0], n_keys), -1, dtype=torch.int32,
                      device=kind.device)
    K.spill_links_kernel(skey, order, prev, last)
    link_launches += 1
    return prev, last


def spill_sweep(kind, key, num_local, num_pool, n_keys: int, tier=None):
    """Replay K alloc/free streams for every config lane.

    ``kind``, ``key``: (K, E) int32 (ALLOC 0, FREE 1, anything else a
    no-op); ``num_local``, ``num_pool``: (C,) int32 tier sizes; keys of
    ALLOC and FREE events in ``[0, n_keys)`` (others raise).  ``tier``:
    optional (K, n_keys, C) int8 output that holds each key's tier on
    exit (-1 unbound, 0 local, 1 pool); allocated when None.  Returns
    ``(allocs, pool_allocs, failed, local_in_use, pool_in_use)``, five
    (K, C) int32 tensors.
    """
    _check(kind, key, num_local, num_pool, n_keys, tier)
    n_streams = kind.shape[0]
    c = num_local.shape[0]
    if tier is None:
        tier = torch.empty((n_streams, n_keys, c), dtype=torch.int8,
                           device=kind.device)
    if kind.device.type == "cpu":
        return R.spill_sweep_ref(kind, key, num_local, num_pool, tier)
    if kind.device.type != "cuda":
        raise ValueError(f"spill_sweep: no kernel for {kind.device}")
    return sweep_on_card(kind, key, num_local, num_pool, tier)


def sweep_on_card(kind, key, num_local, num_pool, tier):
    """The device work of one sweep on CUDA tensors that
    :func:`spill_sweep` has checked: the links pass, then the kernel and
    its final tier map.  Enqueued on the current stream, not
    synchronised."""
    global launches, last_plan
    n_streams, n_events = kind.shape
    c = num_local.shape[0]
    # the kernel stages each stream's kinds and links 16 bytes a copy: rows
    # of a multiple of 4 events (PAD at the end) in fresh, aligned storage
    pad = -n_events % 4
    if pad:
        kind = torch.nn.functional.pad(kind, (0, pad), value=R.PAD)
        key = torch.nn.functional.pad(key, (0, pad), value=0)
    elif kind.data_ptr() % 16:
        kind = kind.clone()
    prev, last = spill_links(kind, key, tier.shape[1])
    # the word array: (bound, pool) ballots of each group of 32 lanes
    # after each event
    words = torch.empty((n_streams, -(-c // 32), kind.shape[1], 2),
                        dtype=torch.int32, device=kind.device)
    out = torch.empty((5, n_streams, c), dtype=torch.int32,
                      device=kind.device)
    plan = K.plan(c, n_streams, K.sm_count(kind.device))
    K.spill_sweep_kernel(kind, prev, last, num_local, num_pool, words, tier,
                         out, plan=plan)
    launches += 1
    last_plan = plan
    return tuple(out)
