"""zNUMA: zero-core tier placement (Pond §4.2, Figure 10).

Pond exposes pool memory to the guest as a NUMA node with memory but no
cores; the guest allocator then *biases* all hot traffic to the local node
and only spills into the zNUMA node when local is exhausted.
``ZNumaAllocator`` reproduces that bias for block pools: allocate
local-first, spill to pool, and track the spill fraction — the quantity
Figure 16 sweeps.  Host-side Python, the same behaviour as the reference's
``repro/core/znuma.py::ZNumaAllocator``.
"""
from __future__ import annotations


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
