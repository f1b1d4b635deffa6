"""Telemetry for opaque jobs (Pond §4.2, Figure 12).

Pond's two telemetry sources and their port analogues:

  * core-PMU / TMA counters  ->  roofline counters of a step, counted by
    ``launch/op_analysis.py`` (FLOPs, bytes and collective wire bytes of
    the dispatched ops): memory-bound / collective-bound fractions are the
    direct analogue of TMA "memory bound" pipeline-slot fractions.
    Sampled once per step (paper: once per second, 1ms cost, no
    event-based sampling).
  * hypervisor page-table access-bit scans -> KV-block touch tracking with
    periodic reset (paper: every 30 min, 10 s cost; here: every
    ``scan_every`` engine steps).  Only *untouched* detection is needed, so
    infrequent resets are fine (§4.2).
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

import numpy as np

from repro_torch.launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16

TMA_METRICS = (
    "memory_bound", "dram_bound", "l1_bound", "l2_bound", "l3_bound",
    "store_bound", "core_bound", "frontend_bound", "bad_speculation",
    "retiring", "ipc", "mlp", "llc_miss_per_kilo", "tlb_miss_per_kilo",
    "bw_util", "latency_sensitivity_raw",
)


@dataclasses.dataclass
class StepCounters:
    """One step's roofline counters (the PMU sample)."""
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    step_time_s: float = 0.0
    tokens: int = 0

    def tma_vector(self, peak_flops=PEAK_FLOPS_BF16, hbm_bw=HBM_BW,
                   ici_bw=NVLINK_BW):
        """TMA-style boundedness fractions (features for the LI model).
        The defaults are the H100's (``launch/mesh.py``); ``ici_bw`` is
        the link the collectives cross, NVLink on the card."""
        ct = self.flops / peak_flops
        mt = self.bytes / hbm_bw
        xt = self.collective_bytes / ici_bw
        tot = max(ct + mt + xt, 1e-12)
        return {"compute_bound": ct / tot, "memory_bound": mt / tot,
                "collective_bound": xt / tot}


class CounterLog:
    """Per-job rolling PMU log (the distributed counter database)."""

    def __init__(self):
        self._log: dict[str, list] = defaultdict(list)

    def record(self, job: str, counters: StepCounters):
        self._log[job].append(counters)

    def features(self, job: str) -> dict:
        rows = self._log.get(job, [])
        if not rows:
            return {}
        tma = [c.tma_vector() for c in rows]
        return {k: float(np.mean([t[k] for t in tma])) for k in tma[0]}


class AccessBitScanner:
    """Untouched-memory telemetry: access bits with periodic reset."""

    def __init__(self, num_blocks: int, scan_every: int = 64):
        self.bits = np.zeros(num_blocks, bool)
        self.ever = np.zeros(num_blocks, bool)
        self.scan_every = scan_every
        self._step = 0
        self.scans: list[float] = []      # touched fraction per scan

    def touch(self, block_ids):
        self.bits[np.asarray(block_ids, int)] = True
        self.ever[np.asarray(block_ids, int)] = True

    def step(self):
        self._step += 1
        if self._step % self.scan_every == 0:
            self.scans.append(float(self.bits.mean()))
            self.bits[:] = False          # reset access bits (cheap: §5)

    def untouched_fraction(self) -> float:
        return 1.0 - float(self.ever.mean())
