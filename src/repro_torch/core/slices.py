"""EMC slice pool: Pond §4.1–4.2.

The external memory controller (EMC) exposes its capacity as 1GB *slices*,
each owned by AT MOST ONE host at a time (multi-headed device, CXL 3.0
MHD).  The EMC checks every access against the permission table; accesses
to a slice you don't own are fatal memory errors.  Offlining a slice takes
10–100 ms/GB (measured, §4.2); onlining is microseconds — hence Pond's
*asynchronous release* strategy (§4.3, Figure 9): released slices enter a
draining queue and only re-join the free pool once the offline completes,
while VM starts are served from a pre-replenished buffer.

This module is the shared substrate for BOTH the cluster simulator
(DRAM-pool semantics, Figures 2/3/21) and the serving engine's tiered KV
cache (slices hold KV blocks; hosts = decode replicas).
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np

FREE = -1
DRAINING = -2

# §4.2: offline 10-100 ms/GB, online ~microseconds
OFFLINE_S_PER_GB = (0.010, 0.100)
ONLINE_S_PER_GB = 2e-6


class PermissionError_(Exception):
    """Fatal memory error: requestor != owner of the slice (Pond §4.1)."""


@dataclasses.dataclass
class ReleaseEvent:
    ready_at: float
    slice_ids: list

    def __lt__(self, other):
        return self.ready_at < other.ready_at


class SlicePool:
    """Permission table + async release queue for one EMC group."""

    def __init__(self, num_slices: int, slice_gb: float = 1.0,
                 seed: int = 0):
        self.num_slices = num_slices
        self.slice_gb = slice_gb
        self.owner = np.full(num_slices, FREE, np.int32)
        self._drain: list[ReleaseEvent] = []
        self._rng = np.random.default_rng(seed)
        self.offline_seconds_total = 0.0
        self.offline_events: list[tuple[float, int]] = []  # (sec/GB, n)

    # ------------------------------------------------------------ queries -
    def free_slices(self) -> np.ndarray:
        return np.flatnonzero(self.owner == FREE)

    def free_gb(self) -> float:
        return len(self.free_slices()) * self.slice_gb

    def owned_by(self, host: int) -> np.ndarray:
        return np.flatnonzero(self.owner == host)

    def owned_gb(self, host: int) -> float:
        return len(self.owned_by(host)) * self.slice_gb

    def check_access(self, host: int, slice_id: int) -> None:
        if self.owner[slice_id] != host:
            raise PermissionError_(
                f"host {host} accessed slice {slice_id} owned by "
                f"{self.owner[slice_id]}")

    # -------------------------------------------------------- assignment --
    def assign(self, host: int, gb: float, now: float = 0.0) -> np.ndarray:
        """Online `gb` of pool memory to `host`.  Near-instant (§4.2).
        Returns assigned slice ids; raises if the buffer is short."""
        self.tick(now)
        n = int(np.ceil(gb / self.slice_gb))
        free = self.free_slices()
        if len(free) < n:
            raise MemoryError(f"pool exhausted: need {n} slices, "
                              f"{len(free)} free")
        ids = free[:n]
        self.owner[ids] = host
        return ids

    def release(self, host: int, slice_ids=None, now: float = 0.0) -> float:
        """Asynchronously release slices (all of the host's by default).
        They drain (offline) and become free at the returned time."""
        ids = self.owned_by(host) if slice_ids is None \
            else np.asarray(slice_ids)
        for s in ids:
            self.check_access(host, int(s))
        self.owner[ids] = DRAINING
        per_gb = float(self._rng.uniform(*OFFLINE_S_PER_GB))
        dur = per_gb * len(ids) * self.slice_gb
        self.offline_seconds_total += dur
        self.offline_events.append((per_gb, len(ids)))
        ready = now + dur
        heapq.heappush(self._drain, ReleaseEvent(ready, list(map(int, ids))))
        return ready

    def tick(self, now: float) -> int:
        """Complete drains whose offline finished. Returns #slices freed."""
        freed = 0
        while self._drain and self._drain[0].ready_at <= now:
            ev = heapq.heappop(self._drain)
            for s in ev.slice_ids:
                if self.owner[s] == DRAINING:
                    self.owner[s] = FREE
                    freed += 1
        return freed

    def draining_gb(self) -> float:
        return float(np.sum(self.owner == DRAINING)) * self.slice_gb

    # ---------------------------------------------------------- invariants
    def check_invariants(self) -> None:
        owners = self.owner
        assert owners.min() >= DRAINING
        assert owners.max() < 10 ** 6
        # single ownership is structural (one entry per slice); verify the
        # drain queue never references an owned slice
        drain_ids = {s for ev in self._drain for s in ev.slice_ids}
        for s in drain_ids:
            assert owners[s] in (DRAINING, FREE), (s, owners[s])

    def offline_gbps_distribution(self) -> np.ndarray:
        """GB/s of each offline event (paper Finding 10)."""
        return np.array([1.0 / per_gb for per_gb, _ in self.offline_events])
