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

Beside it, the kernel's linked form, in plain torch: :func:`spill_links`
(each event's previous ALLOC or FREE of its key, each key's last one, from
the stream alone; the links pass of the wrapper, whose second step
:func:`links_from_order` is the links kernel's plain version) and
:func:`spill_sweep_linked`, a model of the kernel's tiled walk over those
links (for the tests; nothing on the main path runs it).
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


def links_from_order(skey, order, n_keys: int):
    """The links from a stable sort of each stream's keys: ``skey`` (K, E)
    the sorted keys (``n_keys`` standing for a no-op), ``order`` (K, E)
    the events' indices in that order.  Returns ``prev`` (K, E) int32, the
    index of the previous ALLOC or FREE of the event's key (-1 for none
    and for a no-op), and ``last`` (K, n_keys) int32, the index of each
    key's last ALLOC or FREE (-1 for none)."""
    n_streams, n_events = skey.shape
    dev = skey.device
    order = order.long()
    live = skey < n_keys
    same_before = torch.zeros_like(live)
    same_before[:, 1:] = skey[:, 1:] == skey[:, :-1]
    same_after = torch.zeros_like(live)
    same_after[:, :-1] = same_before[:, 1:]
    before = torch.full_like(order, -1)
    before[:, 1:] = order[:, :-1]
    prev = torch.full((n_streams, n_events), -1, dtype=torch.int32,
                      device=dev)
    prev.scatter_(1, order, torch.where(live & same_before, before, -1)
                  .int())
    is_last = live & ~same_after
    # a no-op, and a key's events but its last, go to the extra column
    last = torch.full((n_streams, n_keys + 1), -1, dtype=torch.int32,
                      device=dev)
    last.scatter_(1, torch.where(is_last, skey, n_keys).long(),
                  torch.where(is_last, order, -1).int())
    return prev, last[:, :n_keys].contiguous()


def spill_links(kind, key, n_keys: int):
    """``prev`` (K, E) and ``last`` (K, n_keys) int32 of (K, E) event
    streams (see :func:`links_from_order`): a stable sort of each stream's
    keys, no-ops sorted after every key."""
    live = (kind == ALLOC) | (kind == FREE)
    skey, order = torch.sort(torch.where(live, key, n_keys), dim=1,
                             stable=True)
    return links_from_order(skey, order, n_keys)


def spill_sweep_linked(kind, key, num_local, num_pool, tier, tile: int):
    """The kernel's walk, in plain torch: the same contract and results as
    :func:`spill_sweep_ref`, computed as the kernel computes them.

    A warp's 32 lanes keep the key's tier after each event ``i`` as two
    ballot words, ``(bound, pool)`` (tier -1: (0, 0), 0: (1, 0), 1:
    (1, 1)), in a word array ``words`` (K, lane groups, E, 2) in device
    memory.  An event's tier before it (``in``) is the word of its
    ``prev`` link, or unbound for none.  The events go in tiles of
    ``tile``: a tile first fetches the words of the links that lie before
    it from ``words``; the serial walk then reads each ``in`` from the
    tile's buffer (the fetched word, or the word an earlier event of the
    tile wrote there); at the tile's end its words go to ``words``.  The
    final tier map is each key's word at ``last``."""
    n_streams, n_events = kind.shape
    n_keys = tier.shape[1]
    c = num_local.shape[0]
    groups = -(-c // 32)
    dev = num_local.device
    prev, last = spill_links(kind, key, n_keys)
    prev = prev.long()
    # lanes past C have no memory: their ALLOCs fail and they vote 0
    nl = torch.zeros(groups * 32, dtype=torch.int32, device=dev)
    npl = torch.zeros_like(nl)
    nl[:c], npl[:c] = num_local, num_pool
    bit = (torch.ones(groups * 32, dtype=torch.int64, device=dev)
           << (torch.arange(groups * 32, device=dev) % 32))
    free_l = nl[None, :].repeat(n_streams, 1)
    free_p = npl[None, :].repeat(n_streams, 1)
    allocs = torch.zeros_like(free_l)
    pool_allocs = torch.zeros_like(free_l)
    failed = torch.zeros_like(free_l)
    words = torch.zeros((n_streams, groups, n_events, 2), dtype=torch.int64,
                        device=dev)
    rows = torch.arange(n_streams, device=dev)

    def lane_bits(w):           # (K, G) word -> (K, G * 32) bools
        return (w.repeat_interleave(32, dim=1) & bit) != 0

    def ballot(b):              # (K, G * 32) bools -> (K, G) word
        return (b.long() * bit).view(n_streams, groups, 32).sum(-1)

    for t0 in range(0, n_events, tile):
        n = min(tile, n_events - t0)
        # the tile's buffer: [0, tile) its own words, [tile, 2 tile) the
        # fetched words of links before the tile (0: no link)
        buf = torch.zeros((n_streams, groups, 2 * tile, 2),
                          dtype=torch.int64, device=dev)
        src = torch.empty((n_streams, n), dtype=torch.long, device=dev)
        for j in range(n):
            p = prev[:, t0 + j]
            before = (p >= 0) & (p < t0)
            fetched = words[rows, :, p.clamp(min=0)]
            buf[:, :, tile + j] = torch.where(before[:, None, None],
                                              fetched, 0)
            src[:, j] = torch.where(p >= t0, p - t0, tile + j)
        for j in range(n):
            w = buf[rows, :, src[:, j]]
            b, q = lane_bits(w[..., 0]), lane_bits(w[..., 1])
            k_e = kind[:, t0 + j, None]
            is_alloc, is_free = k_e == ALLOC, k_e == FREE
            take_l = is_alloc & (free_l > 0)
            take_p = is_alloc & ~take_l & (free_p > 0)
            free_l += (is_free & b & ~q).int() - take_l.int()
            free_p += (is_free & q).int() - take_p.int()
            allocs += (take_l | take_p).int()
            pool_allocs += take_p.int()
            failed += (is_alloc & ~take_l & ~take_p).int()
            nb = take_l | take_p | (~is_free & b)
            nq = take_p | (~is_free & ~take_l & q)
            buf[:, :, j, 0], buf[:, :, j, 1] = ballot(nb), ballot(nq)
        words[:, :, t0:t0 + n] = buf[:, :, :n]
    # the final map: each key's word after its last event, -1 for none
    at = last.long().clamp(min=0)                        # (K, n_keys)
    w = words[rows[:, None], :, at]                      # (K, n_keys, G, 2)
    b = lane_bits(w[..., 0].reshape(-1, groups)).view(n_streams, n_keys, -1)
    q = lane_bits(w[..., 1].reshape(-1, groups)).view(n_streams, n_keys, -1)
    t = torch.where(b, q.to(torch.int8), -1)[..., :c]
    tier.copy_(torch.where((last >= 0)[..., None], t, -1).to(torch.int8))
    return (allocs[:, :c], pool_allocs[:, :c], failed[:, :c],
            num_local[None, :] - free_l[:, :c],
            num_pool[None, :] - free_p[:, :c])
