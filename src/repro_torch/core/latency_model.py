"""Tier cost model of the serving path (Pond §4.2, Fig 16 analogue).

Only what the decode engine reads: the latency ratio of the two tiers,
which scales a step's *virtual* time by the share of its attention reads
that land on the pool tier, and the one-time cost of a mitigation copy.
Both are parameters of Pond's model, not measurements of any device; the
reference's transfer rates stay out of the port until a slice uses them.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TierModel:
    """Device memory (local tier) vs pool tier, as a latency ratio."""
    hbm_latency_us: float = 0.5
    pool_latency_us: float = 2.0

    def slowdown_factor(self, pool_fraction_of_traffic: float) -> float:
        """Latency-ratio model for a workload sending a fraction of its
        memory traffic to the pool tier."""
        r = self.pool_latency_us / self.hbm_latency_us
        return 1.0 + pool_fraction_of_traffic * (r - 1.0)


def migration_seconds(gb: float) -> float:
    """One-time mitigation copy: ~50 ms per GB of pool memory (§4.2)."""
    return 0.050 * gb
