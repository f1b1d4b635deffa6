"""CXL pool latency model (Pond §4.1, Figures 7 & 8) and the tier models.

Latency budget per §2/§4.1:
  * NUMA-local DRAM read           ~78 ns
  * CXL port round trip            ~25 ns   per direction-pair
  * controller-side overhead       ~20 ns
  * retimer                        ~10 ns   each direction (>500mm traces)
  * CXL switch                     ~70-100 ns (ports/arbitration/NOC)

Pool-size mapping (Figure 7): <=8 sockets connect directly to one EMC;
16 sockets need retimers on some lanes; 32-64 sockets add a switch +
retimers.  Figure 8: the multi-headed EMC saves the switch for small
pools.  These are the scalar functions the latency engine's grids
(``core/latency_engine.py``) are held to, bit for bit: a copy of the
reference's ``core/latency_model.py``.  Every number here is a parameter
of Pond's model, not a measurement of any device.
"""
from __future__ import annotations

import dataclasses
import math

NUMA_LOCAL_NS = 78.0
CXL_PORT_NS = 25.0
EMC_CTRL_NS = 20.0
RETIMER_NS = 10.0          # per direction
SWITCH_NS = 85.0           # midpoint of 70-100


def pond_latency_ns(pool_sockets: int) -> float:
    """End-to-end read latency (ns) for Pond's EMC-first design (Fig 7)."""
    lat = NUMA_LOCAL_NS + 2 * CXL_PORT_NS + EMC_CTRL_NS
    if pool_sockets > 8:
        lat += 2 * RETIMER_NS            # longer traces need retimers
    if pool_sockets > 16:
        lat += SWITCH_NS + 2 * RETIMER_NS  # switch hop + its traces
    if pool_sockets > 32:
        lat += 2 * RETIMER_NS            # second-level fan-out
    return lat


def switch_only_latency_ns(pool_sockets: int) -> float:
    """Strawman without the multi-headed EMC (Fig 8): every pool needs a
    switch hop."""
    lat = NUMA_LOCAL_NS + 2 * CXL_PORT_NS + EMC_CTRL_NS + SWITCH_NS
    if pool_sockets > 8:
        lat += 2 * RETIMER_NS
    if pool_sockets > 16:
        lat += 2 * RETIMER_NS
    if pool_sockets > 32:
        lat += 2 * RETIMER_NS
    return lat


def added_latency_ns(pool_sockets: int) -> float:
    return pond_latency_ns(pool_sockets) - NUMA_LOCAL_NS


def latency_increase_pct(pool_sockets: int) -> float:
    """Relative to NUMA-local."""
    return 100.0 * pond_latency_ns(pool_sockets) / NUMA_LOCAL_NS


# ------------------------------------------------------------ tier models --
@dataclasses.dataclass(frozen=True)
class MemoryTier:
    """One level of a memory hierarchy: latency, bandwidth, capacity."""
    name: str
    latency_us: float
    gbps: float = 13.0
    capacity_gb: float = math.inf


@dataclasses.dataclass(frozen=True)
class TierHierarchy:
    """Parameterized tier hierarchy.

    ``tiers[0]`` is the local tier; every further tier is a pool level
    (CXL pool, far CXL+RDMA, ...) ordered near to far.  A workload sending
    traffic fraction ``f_t`` to tier ``t`` sees

        slowdown = 1 + sum_t f_t * (r_eff_t - 1)

    with ``r_eff_t = h + (1 - h) * latency_t / latency_local``, ``h`` the
    hit rate of a DRAM cache fronting the pool tiers (``h = 0`` is the raw
    latency ratio).  For two tiers and ``h = 0`` this is bit-identical to
    :meth:`TierModel.slowdown_factor`.
    """
    tiers: tuple[MemoryTier, ...]
    cache_hit_rate: float = 0.0

    def __post_init__(self):
        if len(self.tiers) < 2:
            raise ValueError("TierHierarchy needs a local + >=1 pool tier")

    @classmethod
    def from_tier_model(cls, tm: "TierModel | None" = None,
                        cache_hit_rate: float = 0.0) -> "TierHierarchy":
        tm = tm if tm is not None else TierModel()
        return cls((MemoryTier("local", tm.hbm_latency_us, tm.hbm_gbps),
                    MemoryTier("cxl_pool", tm.pool_latency_us,
                               tm.pool_gbps)),
                   cache_hit_rate)

    @classmethod
    def three_tier(cls, far_latency_us: float = 5.0,
                   far_gbps: float = 6.0,
                   cxl_capacity_gb: float = math.inf,
                   far_capacity_gb: float = math.inf,
                   cache_hit_rate: float = 0.0) -> "TierHierarchy":
        """local / CXL pool / far (CXL+RDMA)."""
        tm = TierModel()
        return cls((MemoryTier("local", tm.hbm_latency_us, tm.hbm_gbps),
                    MemoryTier("cxl_pool", tm.pool_latency_us,
                               tm.pool_gbps, cxl_capacity_gb),
                    MemoryTier("far_pool", far_latency_us, far_gbps,
                               far_capacity_gb)),
                   cache_hit_rate)

    @property
    def n_pool_tiers(self) -> int:
        return len(self.tiers) - 1

    def latency_ratio(self, i: int) -> float:
        return self.tiers[i].latency_us / self.tiers[0].latency_us

    def effective_ratio(self, i: int) -> float:
        """Latency ratio of tier ``i`` behind the DRAM cache front."""
        if i == 0:
            return 1.0
        h = self.cache_hit_rate
        return h + (1.0 - h) * self.latency_ratio(i)

    def slowdown_factor(self, pool_traffic_fracs) -> float:
        """``pool_traffic_fracs[t]`` = traffic fraction to tier ``t+1``.

        Accepts a scalar for 2-tier hierarchies.  Terms accumulate in tier
        order — the exact fold the grid engine replicates elementwise.
        """
        if not hasattr(pool_traffic_fracs, "__len__"):
            pool_traffic_fracs = (pool_traffic_fracs,)
        if len(pool_traffic_fracs) != self.n_pool_tiers:
            raise ValueError(
                f"expected {self.n_pool_tiers} pool-traffic fractions, "
                f"got {len(pool_traffic_fracs)}")
        s = 1.0
        for i, f in enumerate(pool_traffic_fracs, start=1):
            s += f * (self.effective_ratio(i) - 1.0)
        return s

    def spill_fractions(self, demand_gb: float):
        """Waterfall fill near-to-far: GB landing on each tier plus any
        unplaceable remainder (local fills first — the zNUMA bias)."""
        fills, rem = [], float(demand_gb)
        for t in self.tiers:
            take = min(rem, t.capacity_gb)
            fills.append(take)
            rem -= take
        return fills, rem

    def transfer_s(self, nbytes: float, i: int) -> float:
        t = self.tiers[i]
        return t.latency_us * 1e-6 + nbytes / (t.gbps * 1e9)


@dataclasses.dataclass(frozen=True)
class TierModel:
    """Local tier vs pool tier: latencies and rates of Pond's model."""
    hbm_gbps: float = 819.0
    pool_gbps: float = 13.0
    hbm_latency_us: float = 0.5
    pool_latency_us: float = 2.0

    def transfer_s(self, nbytes: float, tier: str) -> float:
        bw = self.hbm_gbps if tier == "local" else self.pool_gbps
        lat = self.hbm_latency_us if tier == "local" else self.pool_latency_us
        return lat * 1e-6 + nbytes / (bw * 1e9)

    def slowdown_factor(self, pool_fraction_of_traffic: float) -> float:
        """Latency-ratio model for a workload sending a fraction of its
        memory traffic to the pool tier (Fig 16)."""
        r = self.pool_latency_us / self.hbm_latency_us
        return 1.0 + pool_fraction_of_traffic * (r - 1.0)


def migration_seconds(gb: float) -> float:
    """One-time mitigation copy: ~50 ms per GB of pool memory (§4.2)."""
    return 0.050 * gb
