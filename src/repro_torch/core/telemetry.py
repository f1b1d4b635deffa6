"""Telemetry for opaque jobs (Pond §4.2, Figure 12).

Of Pond's two telemetry sources the serving path uses the second:
hypervisor page-table access-bit scans -> KV-block touch tracking with
periodic reset (paper: every 30 min, 10 s cost; here: every
``scan_every`` engine steps).  Only *untouched* detection is needed, so
infrequent resets are fine (§4.2).  The counter side of the reference's
``repro/core/telemetry.py`` arrives with the slice that reads it.
"""
from __future__ import annotations

import numpy as np


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
