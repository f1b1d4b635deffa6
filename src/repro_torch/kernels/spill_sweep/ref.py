"""Plain PyTorch version of the zNUMA spill sweep (the kernel's oracle, and
what the wrapper runs for CPU tensors).

A transcription of the reference's scan step
(``src/repro/core/latency_engine.py::_build_spill_sweep``, ``body``) and
its numpy twin ``_numpy_spill_sweep``: one Python loop over the events,
each step tensor ops over (stream, lane).  Streams differ in their event
at a step, so the kind is a mask, not a branch.  An ALLOC takes local
memory while the lane has some, else the pool while it has some, else
fails and leaves the key's tier as it was; a FREE returns the key's tier
and unbinds it (a FREE of an unbound key changes nothing); any other kind
(PAD) is a no-op.
"""
from __future__ import annotations

import torch

ALLOC, FREE, PAD = 0, 1, 2


def spill_sweep_ref(kind, key, num_local, num_pool, tier):
    """The kernel's contract: ``kind``, ``key`` (K, E) int32 event streams;
    ``num_local``, ``num_pool`` (C,) int32 tier sizes of the config lanes;
    ``tier`` (K, n_keys, C) int8 scratch whose content on entry is ignored
    and which holds each key's tier on exit (-1 unbound, 0 local, 1 pool).
    Returns ``(allocs, pool_allocs, failed, local_in_use, pool_in_use)``,
    five (K, C) int32 tensors."""
    n_streams, n_events = kind.shape
    dev = num_local.device
    tier.fill_(-1)
    free_l = num_local[None, :].repeat(n_streams, 1)
    free_p = num_pool[None, :].repeat(n_streams, 1)
    allocs = torch.zeros_like(free_l)
    pool_allocs = torch.zeros_like(free_l)
    failed = torch.zeros_like(free_l)
    rows = torch.arange(n_streams, device=dev)
    live = (kind == ALLOC) | (kind == FREE)
    # a no-op's key may be anything: point it at key 0, read and written
    # back unchanged
    keys = torch.where(live, key, 0).long()
    for e in range(n_events):
        k_e = kind[:, e, None]
        is_alloc, is_free = k_e == ALLOC, k_e == FREE
        has_l = free_l > 0
        take_l = is_alloc & has_l
        take_p = is_alloc & ~has_l & (free_p > 0)
        fail = is_alloc & ~take_l & ~take_p
        row = tier[rows, keys[:, e]]
        freed_l = is_free & (row == 0)
        freed_p = is_free & (row == 1)
        free_l += freed_l.int() - take_l.int()
        free_p += freed_p.int() - take_p.int()
        new = torch.where(take_l, 0, torch.where(
            take_p, 1, torch.where(is_free, -1, row.int())))
        tier[rows, keys[:, e]] = new.to(torch.int8)
        allocs += (take_l | take_p).int()
        pool_allocs += take_p.int()
        failed += fail.int()
    return (allocs, pool_allocs, failed, num_local[None, :] - free_l,
            num_pool[None, :] - free_p)
