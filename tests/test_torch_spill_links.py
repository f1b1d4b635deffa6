"""K6's linked form: the links pass and the kernel's tiled walk, in plain
torch, against a dict walk, the plain version and the reference.

``ref.spill_links`` (each event's previous ALLOC or FREE of its key, each
key's last one; on the card a stable sort of the keys and the links
kernel, whose plain version is ``ref.links_from_order``) is held to a
plain dict walk over the events, and ``ref.spill_sweep_linked`` (the
kernel's walk over those links: two ballot words a group of 32 lanes an
event, tiles that fetch the words of their earlier links, the final map
read at each key's last event) at tiles of 1, 3, 4, 7 and 2,048 events
with ``==`` to ``spill_sweep_ref`` (counters and final tier map) and to
the reference's ``spill_grid`` scan, on every edge and seeded case of
``kernels/spill_sweep/cases.py``.  The kernel itself is held to
``spill_sweep_ref`` on the card by ``chip_smoke.py``.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.kernels.spill_sweep import cases, ops, ref
from tests.test_torch_spill_sweep import _reference

TILES = (1, 3, 4, 7, 2048)
CASES = {c[0]: c[1:] for c in cases.edge_cases() + cases.seeded_cases()}


def _fig16_case():
    kinds, keys, _, _ = cases.kv_event_batch((3, 4), 200, 64)
    return kinds, keys, *cases.lane_configs(40)


def _case(name):
    return _fig16_case() if name == "fig16_small" else CASES[name]


def _walk(kinds, keys, n_keys):
    """prev and last of (K, E) streams by a plain dict walk."""
    prev = np.full(kinds.shape, -1, np.int64)
    last = np.full((kinds.shape[0], n_keys), -1, np.int64)
    for s in range(kinds.shape[0]):
        seen = {}
        for i, (k, b) in enumerate(zip(kinds[s].tolist(), keys[s].tolist())):
            if k in (ref.ALLOC, ref.FREE):
                prev[s, i] = seen.get(b, -1)
                seen[b] = i
        for b, i in seen.items():
            last[s, b] = i
    return prev, last


def _tensors(kinds, keys, nl, npl):
    return [torch.from_numpy(np.ascontiguousarray(a))
            for a in (kinds, keys, nl, npl)]


@functools.cache
def _plain(name):
    """spill_sweep_ref of a case: five (K, C) lists and the tier map."""
    kinds, keys, nl, npl = _case(name)
    n_keys = int(keys.max(initial=0)) + 1
    tier = torch.empty((kinds.shape[0], n_keys, len(nl)), dtype=torch.int8)
    out = ref.spill_sweep_ref(*_tensors(kinds, keys, nl, npl), tier)
    return [o.tolist() for o in out], tier.tolist()


@functools.cache
def _jax(name):
    """The reference's spill_grid scan of a case (backend "jax")."""
    return [w.tolist() for w in _reference(*_case(name), "jax")]


@pytest.mark.parametrize("name", [*CASES, "fig16_small"])
def test_links_equal_a_dict_walk(name):
    kinds, keys, _, _ = _case(name)
    n_keys = int(keys.max(initial=0)) + 1
    prev, last = ref.spill_links(torch.from_numpy(kinds),
                                 torch.from_numpy(keys), n_keys)
    assert prev.dtype == last.dtype == torch.int32
    want_prev, want_last = _walk(kinds, keys, n_keys)
    assert prev.tolist() == want_prev.tolist()
    assert last.tolist() == want_last.tolist()
    # the wrapper takes the same path for CPU tensors, and counts no launch
    before = ops.link_launches
    p2, l2 = ops.spill_links(torch.from_numpy(kinds), torch.from_numpy(keys),
                             n_keys)
    assert ops.link_launches == before
    assert torch.equal(p2, prev) and torch.equal(l2, last)


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("name", [*CASES, "fig16_small"])
def test_linked_walk_equals_plain_version_and_reference(name, tile):
    kinds, keys, nl, npl = _case(name)
    n_keys = int(keys.max(initial=0)) + 1
    tier = torch.full((kinds.shape[0], n_keys, len(nl)), 7, dtype=torch.int8)
    out = ref.spill_sweep_linked(*_tensors(kinds, keys, nl, npl), tier,
                                 tile=tile)
    assert all(o.dtype == torch.int32 for o in out)
    got = [o.tolist() for o in out]
    want, want_tier = _plain(name)
    assert got == want
    assert tier.tolist() == want_tier
    assert got == _jax(name)


def test_links_of_a_key_never_allocated_are_minus_one():
    # a no-op's key is never a link, whatever it holds; keys without an
    # ALLOC or FREE have no last event
    kinds, keys = cases.to_arrays([("pad", 2), ("alloc", 0), ("pad", 0),
                                   ("free", 0), ("pad", 0)])
    prev, last = ref.spill_links(torch.from_numpy(kinds[None]),
                                 torch.from_numpy(keys[None]), 3)
    assert prev.tolist() == [[-1, -1, -1, 1, -1]]
    assert last.tolist() == [[3, -1, -1]]


def test_tile_boundary_case_has_its_links():
    """The edge case built for the kernel's tile: links exactly one tile
    back, across two tile boundaries, and onto a tile's first event."""
    t = cases.MAX_TILE
    kinds, keys = cases.to_arrays(cases.tile_boundary_events())
    prev, _ = ref.spill_links(torch.from_numpy(kinds[None]),
                              torch.from_numpy(keys[None]), 24)
    prev = prev[0].tolist()
    assert prev[t + 3] == 3                 # one tile back
    assert prev[2 * t] == t - 1             # two boundaries
    assert prev[t] == t - 2                 # a tile's first event
    assert prev[2 * t + 1] == 2 * t - 1     # an ALLOC of a bound key
    assert len(kinds) == 2 * t + 64
