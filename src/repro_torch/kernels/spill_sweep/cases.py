"""Event streams for the zNUMA spill sweep (K6): edge cases and seeded
streams for holding the kernel against its plain version
(``chip_smoke.py``) and the plain version against the reference's scan
(``tests/test_torch_spill_sweep.py``), and Fig 16's paged-KV stream.

A stream is two int32 arrays, kinds (ALLOC 0, FREE 1, PAD 2) and block
keys, as ``latency_engine.compile_block_events`` compiles them; a batch of
K streams of unequal length is padded with PAD events to one (K, E) pair.
"""
from __future__ import annotations

import numpy as np

from repro_torch.kernels.spill_sweep.kernel import MAX_TILE
from repro_torch.kernels.spill_sweep.ref import ALLOC, FREE, PAD


def random_events(rng, n_keys: int, n_events: int) -> list:
    """``[("alloc"|"free", key), ...]``: frees of held keys (40 %) between
    allocations of keys not held, so a key is freed and allocated again."""
    held = set()
    ev = []
    for _ in range(n_events):
        if held and rng.random() < 0.4:
            k = int(rng.choice(sorted(held)))
            held.discard(k)
            ev.append(("free", k))
        else:
            k = int(rng.integers(n_keys))
            if k not in held:
                held.add(k)
                ev.append(("alloc", k))
    return ev


def to_arrays(events) -> tuple[np.ndarray, np.ndarray]:
    """``[("alloc"|"free"|"pad", key), ...]`` -> int32 (kinds, keys)."""
    kind_of = {"alloc": ALLOC, "free": FREE, "pad": PAD}
    return (np.array([kind_of[k] for k, _ in events], np.int32).reshape(-1),
            np.array([b for _, b in events], np.int32).reshape(-1))


def pad_streams(streams) -> tuple[np.ndarray, np.ndarray]:
    """(kinds, keys) pairs of unequal length -> one (K, E) pair, each
    stream padded at its end with PAD events of key 0."""
    e = max(len(k) for k, _ in streams)
    pad = lambda a, v: np.concatenate(
        [a, np.full(e - len(a), v, np.int32)])
    return (np.stack([pad(k, PAD) for k, _ in streams]),
            np.stack([pad(b, 0) for _, b in streams]))


def lane_configs(n_lanes: int):
    """(num_local, num_pool) int32 arrays of ``n_lanes`` configs that reach
    every branch on the streams here: no local memory, no pool, neither,
    tight and ample tiers."""
    base = [(0, 4), (4, 0), (3, 5), (0, 0), (8, 64), (1, 1), (12, 2)]
    nl = np.array([base[i % len(base)][0] + i // len(base)
                   for i in range(n_lanes)], np.int32)
    npl = np.array([base[i % len(base)][1] for i in range(n_lanes)],
                   np.int32)
    return nl, npl


def tile_boundary_events(tile: int = MAX_TILE) -> list:
    """Random events over 16 keys, ``2 tile + 64`` of them, with links
    planted across the kernel's tiles of ``tile`` events: a FREE exactly
    one tile after its ALLOC; an ALLOC at a tile's last event freed at the
    first event two tiles on; a FREE at a tile's first event of the ALLOC
    two events back; an ALLOC of a key already bound across a boundary."""
    ev = random_events(np.random.default_rng(18), 16, 3 * tile)[:2 * tile
                                                                 + 64]
    ev += [("pad", 0)] * (2 * tile + 64 - len(ev))
    for at, e in ((3, ("alloc", 20)), (tile + 3, ("free", 20)),
                  (tile - 1, ("alloc", 21)), (2 * tile, ("free", 21)),
                  (tile - 2, ("alloc", 22)), (tile, ("free", 22)),
                  (2 * tile - 1, ("alloc", 23)), (2 * tile + 1, ("alloc", 23)),
                  (2 * tile + 2, ("free", 23))):
        ev[at] = e
    return ev


def edge_cases() -> list:
    """``(name, kinds (K, E), keys (K, E), num_local, num_pool)``: PAD only;
    a FREE of an unbound key; failed allocations and a FREE of the key
    that failed; num_local 0 and num_pool 0; a key freed and allocated
    again; an ALLOC of a key already bound, succeeding and failing (the
    old tier stays); a key freed twice; links across the kernel's tiles
    (:func:`tile_boundary_events`); 1, 33 and 130 lanes; K 1 and 3 with
    unequal lengths padded by PAD."""
    out = []
    one = lambda ev: tuple(a[None] for a in to_arrays(ev))
    nl3, np3 = (np.array([0, 1, 2], np.int32), np.array([0, 1, 0], np.int32))
    out.append(("pad_only", *one([("pad", 0)] * 8), nl3, np3))
    out.append(("free_unbound", *one([("free", 3), ("alloc", 0),
                                      ("free", 1), ("free", 0),
                                      ("free", 0)]), nl3, np3))
    out.append(("failed_allocs", *one([("alloc", k) for k in range(5)]
                                      + [("free", 4), ("free", 0),
                                         ("alloc", 5), ("alloc", 6)]),
                nl3, np3))
    out.append(("zero_tiers", *one([("alloc", 0), ("alloc", 1),
                                    ("free", 0), ("alloc", 2)]),
                np.zeros(2, np.int32), np.array([0, 2], np.int32)))
    out.append(("realloc", *one([("alloc", 2), ("free", 2), ("alloc", 2),
                                 ("alloc", 1), ("free", 2), ("alloc", 2),
                                 ("free", 1), ("free", 2)]), nl3, np3))
    out.append(("alloc_bound_succeeds", *one([("alloc", 0), ("alloc", 0),
                                              ("free", 0), ("free", 0)]),
                nl3, np3))
    out.append(("alloc_bound_fails", *one([("alloc", 0), ("alloc", 1),
                                           ("alloc", 0), ("free", 0),
                                           ("alloc", 2), ("free", 1),
                                           ("free", 2)]), nl3, np3))
    out.append(("free_twice", *one([("alloc", 0), ("free", 0), ("free", 0),
                                    ("alloc", 1), ("alloc", 0), ("free", 1),
                                    ("free", 1), ("free", 0)]), nl3, np3))
    out.append(("tile_boundaries", *one(tile_boundary_events()),
                *lane_configs(9)))
    rng = np.random.default_rng(6)
    for n_lanes in (1, 33, 130):
        k, b = to_arrays(random_events(rng, 24, 150))
        out.append((f"lanes{n_lanes}", k[None], b[None],
                    *lane_configs(n_lanes)))
    streams = [to_arrays(random_events(np.random.default_rng(s), 16,
                                       60 + 25 * s)) for s in range(3)]
    k, b = streams[0]
    out.append(("k1_padded",
                np.concatenate([k, np.full(5, PAD, np.int32)])[None],
                np.concatenate([b, np.zeros(5, np.int32)])[None],
                *lane_configs(9)))
    out.append(("k3_unequal", *pad_streams(streams), *lane_configs(9)))
    return out


def seeded_cases(seeds=(0, 1, 2), n_lanes=(1, 2, 3, 5, 17)) -> list:
    """``(name, kinds (1, E), keys (1, E), num_local, num_pool)`` for each
    seed and lane count: 120 random events over 24 keys."""
    out = []
    for seed in seeds:
        k, b = to_arrays(random_events(np.random.default_rng(seed), 24, 120))
        for c in n_lanes:
            out.append((f"seed{seed}_c{c}", k[None], b[None],
                        *lane_configs(c)))
    return out


def synthetic_kv_events(seed: int, n_requests: int = 24,
                        peak_pages: int = 16):
    """Fig 16's paged-KV alloc/free stream for a decode engine (the
    reference's ``benchmarks/fig16_spill.py::synthetic_kv_events``): each
    request allocates 3-6 pages, the oldest requests retire when concurrent
    demand passes ``peak_pages``, the rest free at the end.  Returns
    (events, peak concurrent demand)."""
    rng = np.random.default_rng(seed)
    events, active, key, live, peak = [], [], 0, 0, 0
    for _ in range(n_requests):
        pages = int(rng.integers(3, 7))
        keys = list(range(key, key + pages))
        key += pages
        for k in keys:
            events.append(("alloc", k))
        live += pages
        peak = max(peak, live)
        active.append(keys)
        while live > peak_pages:
            retired = active.pop(0)
            for k in retired:
                events.append(("free", k))
            live -= len(retired)
    for keys in active:
        for k in keys:
            events.append(("free", k))
    return events, peak


def kv_event_batch(seeds, n_requests: int, peak_pages: int):
    """Fig 16's streams of ``seeds`` as one PAD-padded (K, E) pair of kinds
    and keys, with each stream's own (kinds, keys) and peak demand."""
    streams, peaks = [], []
    for seed in seeds:
        ev, peak = synthetic_kv_events(seed, n_requests, peak_pages)
        streams.append(to_arrays(ev))
        peaks.append(peak)
    return (*pad_streams(streams), streams, peaks)
