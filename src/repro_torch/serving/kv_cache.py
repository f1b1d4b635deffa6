"""Two-tier paged KV cache on the Pond slice pool.

The KV pool is one logical array of fixed-size pages; page ids below
``num_local`` are the "local" tier, the rest the pool tier.  In the port
both tiers are one device tensor: the tier of a page is an accounting
fact that drives the zNUMA statistics, the virtual step time and QoS
migration, as in the reference.  Allocation uses the zNUMA bias
(core/znuma.py): a sequence's pages are local until local is exhausted,
then spill to the pool; a correctly-predicted "hot footprint" therefore
never touches the pool — Pond §6.2 Finding 1 at KV granularity.

Pool-tier pages are backed by 1GB-analogue slices owned via the EMC
permission table (core/slices.py): the engine owns its slices, releases
them asynchronously when sequences complete, and a second engine on the
same group can pick them up — memory pooling across decode replicas.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.slices import SlicePool
from repro_torch.core.telemetry import AccessBitScanner
from repro_torch.core.znuma import ZNumaAllocator
from repro_torch.device import resolve_device, resolve_dtype


@dataclasses.dataclass
class KVConfig:
    num_layers: int
    num_kv_heads: int
    head_dim: int
    page_size: int = 16
    num_local_pages: int = 256
    num_pool_pages: int = 256
    dtype: str = "float32"        # "float32" | "bfloat16"

    @property
    def total_pages(self) -> int:
        return self.num_local_pages + self.num_pool_pages

    def page_bytes(self) -> int:
        return (2 * self.num_layers * self.num_kv_heads * self.page_size
                * self.head_dim * resolve_dtype(self.dtype).itemsize)


class TieredPagedKV:
    def __init__(self, cfg: KVConfig, slice_pool: SlicePool | None = None,
                 owner: int = 0, *, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        shape = (cfg.num_layers, cfg.num_kv_heads, cfg.total_pages,
                 cfg.page_size, cfg.head_dim)
        dtype = resolve_dtype(cfg.dtype)
        self.k = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v = torch.zeros(shape, dtype=dtype, device=self.device)
        self.alloc = ZNumaAllocator(cfg.num_local_pages, cfg.num_pool_pages)
        self.tables: dict[int, list[int]] = {}     # seq -> page ids
        self.lens: dict[int, int] = {}
        self.scanner = AccessBitScanner(cfg.total_pages)
        self.slice_pool = slice_pool
        self.owner = owner
        self._slice_ids: list[int] = []
        if slice_pool is not None:
            n_slices = math.ceil(cfg.num_pool_pages * cfg.page_bytes()
                                 / (slice_pool.slice_gb * 2 ** 30))
            self._slice_ids = list(
                slice_pool.assign(owner, n_slices * slice_pool.slice_gb))

    # ------------------------------------------------------------- alloc --
    def pages_for(self, tokens: int) -> int:
        return math.ceil(tokens / self.cfg.page_size)

    def can_admit(self, prompt_len: int, max_new: int) -> bool:
        need = self.pages_for(prompt_len + max_new)
        free = (len(self.alloc.free_local) + len(self.alloc.free_pool))
        return need <= free

    def admit(self, seq_id: int, prompt_len: int) -> list[int]:
        pages = [self.alloc.alloc() for _ in range(
            self.pages_for(max(prompt_len, 1)))]
        self.tables[seq_id] = pages
        self.lens[seq_id] = prompt_len
        return pages

    def extend(self, seq_id: int) -> None:
        """Account one new token; grows the page list when needed."""
        self.lens[seq_id] += 1
        if self.lens[seq_id] > len(self.tables[seq_id]) * self.cfg.page_size:
            self.tables[seq_id].append(self.alloc.alloc())

    def release(self, seq_id: int):
        for p in self.tables.pop(seq_id, []):
            self.alloc.free(p)
        self.lens.pop(seq_id, None)

    def release_slices(self, now: float = 0.0):
        """Engine shutdown: pool slices drain back asynchronously."""
        if self.slice_pool is not None and self._slice_ids:
            self.slice_pool.release(self.owner, self._slice_ids, now)
            self._slice_ids = []

    # ---------------------------------------------------------- batching --
    def batch_tables(self, seq_ids, pad_to: int | None = None):
        """(B, max_pages) table + (B,) lens, int32 tensors on the device,
        for the kernel.  Rows are padded with page 0."""
        maxp = max(len(self.tables[s]) for s in seq_ids)
        if pad_to is not None:
            maxp = max(maxp, pad_to)
        tbl = np.zeros((len(seq_ids), maxp), np.int32)
        lens = np.zeros((len(seq_ids),), np.int32)
        for i, s in enumerate(seq_ids):
            pages = self.tables[s]
            tbl[i, : len(pages)] = pages
            lens[i] = self.lens[s]
        return (torch.from_numpy(tbl).to(self.device),
                torch.from_numpy(lens).to(self.device))

    # --------------------------------------------------------- telemetry --
    def record_touches(self, seq_ids):
        for s in seq_ids:
            used = self.pages_for(self.lens[s])
            self.scanner.touch(self.tables[s][:used])
        self.scanner.step()

    def spill_stats(self, seq_ids) -> dict:
        """Per-batch zNUMA stats: fraction of attention reads on the pool
        tier (the Fig 15 'traffic to zNUMA' analogue)."""
        pool_pages = local_pages = 0
        for s in seq_ids:
            used = self.pages_for(self.lens[s])
            for p in self.tables[s][:used]:
                if self.alloc.is_pool(p):
                    pool_pages += 1
                else:
                    local_pages += 1
        tot = pool_pages + local_pages
        return {"pool_pages": pool_pages, "local_pages": local_pages,
                "pool_traffic_frac": pool_pages / tot if tot else 0.0}

    # --------------------------------------------------------- migration --
    def migrate_seq_to_local(self, seq_id: int) -> int:
        """QoS mitigation: copy a sequence's pool pages into local pages
        (50ms/GB model applies at the engine).  Returns pages moved.

        Free local pages are popped directly, not through ``alloc()``, so
        a migration leaves the allocator's spill fraction unchanged.  The
        page contents are copied in place on the device, in one indexed
        copy per pool for all the pages moved."""
        pages = self.tables.get(seq_id, [])
        src, dst = [], []
        for i, p in enumerate(pages):
            if not self.alloc.is_pool(p):
                continue
            if not self.alloc.free_local:
                break
            q = self.alloc.free_local.pop()
            src.append(p)
            dst.append(q)
            self.alloc.free(p)
            pages[i] = q
        if src:
            # src are pool ids and dst local ids, so the two never overlap
            si = torch.tensor(src, device=self.device)
            di = torch.tensor(dst, device=self.device)
            self.k[:, :, di] = self.k[:, :, si]
            self.v[:, :, di] = self.v[:, :, si]
        return len(src)
