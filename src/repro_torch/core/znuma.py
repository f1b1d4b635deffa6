"""zNUMA: zero-core tier placement (Pond §4.2, Figure 10).

Pond exposes pool memory to the guest as a NUMA node with memory but no
cores; the guest allocator then *biases* all hot traffic to the local node
and only spills into the zNUMA node when local is exhausted.
``ZNumaAllocator`` reproduces that bias for block pools: allocate
local-first, spill to pool, and track the spill fraction — the quantity
Figure 16 sweeps.  Host-side Python, the same behaviour as the reference's
``repro/core/znuma.py::ZNumaAllocator``.

Every logical buffer group (parameters, gradients, optimizer state) also
carries a tier tag, ``local`` (the card's memory) or ``pool`` (host memory
behind it).  ``tier_place`` puts a state's groups where their tags say:
the pool tier in **pinned** host memory, which the card reads and writes
with DMA copies (the reference's ``memory_kind="pinned_host"``
shardings), the local tier on the card.  A placed state's leaf
(``sharding/spmd.py::Placed``, M18d) goes to the pool tier as
:class:`PoolBlocks`: one pinned buffer a distinct block, its replicas
not again (the placed two-phase step copies each update to them on the
cards).  ``TierAccount`` counts the bytes of each tier.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass
class PoolBlocks:
    """A placed leaf's pool tier: ``blocks[i]`` holds the block of rank
    ``ranks[i]``, the leaf's distinct blocks in order
    (``spmd.Placed.distinct``); ``sharding`` and ``shape`` are the placed
    leaf's."""
    blocks: list
    ranks: list
    sharding: object
    shape: tuple


def _map_tensors(fn, tree):
    """``fn`` over every tensor of a dict / list / tuple tree, a
    ``QTensor``'s codes and scales and every block of a ``PoolBlocks`` or
    a placed leaf included (a placed leaf gives its list of blocks); None
    stays None."""
    from repro_torch.optim.compress import QTensor
    from repro_torch.sharding.spmd import Placed

    if tree is None:
        return None
    if isinstance(tree, QTensor):
        return tree.map(fn)
    if isinstance(tree, PoolBlocks):
        return PoolBlocks([_map_tensors(fn, b) for b in tree.blocks],
                          tree.ranks, tree.sharding, tree.shape)
    if isinstance(tree, Placed):
        return [_map_tensors(fn, b) for b in tree.blocks]
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(fn, v) for v in tree)
    return fn(tree)


def tree_tensors(tree) -> list:
    """Every tensor of a tree, in order (a ``QTensor`` gives two)."""
    out: list = []
    _map_tensors(out.append, tree)
    return out


def _pinned(t: torch.Tensor) -> torch.Tensor:
    if t.device.type == "cpu" and t.is_pinned():
        return t
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    if not out.is_pinned():
        raise RuntimeError("the pool tier could not be pinned: pinned host "
                           "memory is what the card's copies need")
    return out


def tier_place(state: dict, tiers, device=None) -> dict:
    """``state`` (a dict of groups) with each group where its tier tag
    says: ``"pool"`` in pinned host memory when ``device`` is the card
    (ordinary host memory on the CPU), ``"local"`` on ``device``.
    ``tiers`` is one tag for every group or a dict of tags by group name
    (``optim.adamw.state_tier``).  ``device=None`` is the card, and raises
    where there is none.  A pool tier that cannot be pinned raises;
    nothing is left pageable.  A placed leaf stays placed in the local
    tier and becomes a :class:`PoolBlocks` in the pool tier, its distinct
    blocks copied a block at a time."""
    from repro_torch.sharding.spmd import Placed
    device = resolve_device(device)

    def where(group):
        tag = tiers if isinstance(tiers, str) else tiers.get(group, "local")
        if tag not in ("local", "pool"):
            raise ValueError(f"tier {tag!r} of {group!r}; local or pool")
        if tag == "local":
            fn = lambda t: t.to(device)                 # noqa: E731
        elif device.type == "cuda":
            fn = _pinned
        else:
            fn = lambda t: t.to("cpu")                  # noqa: E731

        def leaf(x):
            if not isinstance(x, Placed):
                return _map_tensors(fn, x)
            if tag == "local":          # already on its coordinates' cards
                return x
            ranks = x.distinct()
            return PoolBlocks([_map_tensors(fn, x.blocks[r]) for r in ranks],
                              ranks, x.sharding, x.shape)
        return leaf
    return {g: _walk(where(g), sub) for g, sub in state.items()}


def _walk(fn, tree):
    """``fn`` of every leaf of a dict / list / tuple tree (a tensor, a
    ``QTensor``, a placed leaf or None)."""
    if isinstance(tree, dict):
        return {k: _walk(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(fn, v) for v in tree)
    return fn(tree)


@dataclasses.dataclass
class TierAccount:
    """Byte accounting per tier."""
    local_bytes: int = 0
    pool_bytes: int = 0

    def add(self, tree, tier: str):
        n = sum(t.numel() * t.element_size() for t in tree_tensors(tree))
        if tier == "pool":
            self.pool_bytes += n
        else:
            self.local_bytes += n
        return self

    @property
    def pool_fraction(self) -> float:
        tot = self.local_bytes + self.pool_bytes
        return self.pool_bytes / tot if tot else 0.0


class ZNumaAllocator:
    """Local-first block allocator over a two-tier pool (guest-OS bias).

    Used by serving/kv_cache.py: ``num_local`` blocks of device memory plus
    ``num_pool`` blocks on the slice pool.  Pool blocks are touched only
    after local is exhausted, so a correctly-sized local tier (= predicted
    hot footprint) never spills.
    """

    def __init__(self, num_local: int, num_pool: int):
        self.num_local = num_local
        self.num_pool = num_pool
        self.free_local = list(range(num_local - 1, -1, -1))
        self.free_pool = list(range(num_local + num_pool - 1,
                                    num_local - 1, -1))
        self.allocs = 0
        self.pool_allocs = 0

    def alloc(self) -> int:
        """Returns a global block id; local ids < num_local.

        Only SUCCESSFUL allocations count toward ``allocs``, so a failed
        (MemoryError) allocation does not deflate ``spill_fraction``.
        """
        if self.free_local:
            self.allocs += 1
            return self.free_local.pop()
        if self.free_pool:
            self.allocs += 1
            self.pool_allocs += 1
            return self.free_pool.pop()
        raise MemoryError("zNUMA: both tiers exhausted")

    def free(self, block_id: int):
        if block_id < self.num_local:
            self.free_local.append(block_id)
        else:
            self.free_pool.append(block_id)

    def is_pool(self, block_id: int) -> bool:
        return block_id >= self.num_local

    @property
    def spill_fraction(self) -> float:
        return self.pool_allocs / self.allocs if self.allocs else 0.0

    @property
    def local_in_use(self) -> int:
        return self.num_local - len(self.free_local)

    @property
    def pool_in_use(self) -> int:
        return self.num_pool - len(self.free_pool)
