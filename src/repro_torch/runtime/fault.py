"""Straggler detection for replica routing (the scheduler's share of the
reference's ``repro/runtime/fault.py``; heartbeats, elastic meshes and
failure schedules arrive with the training and failure slices)."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class StragglerTracker:
    alpha: float = 0.3           # EWMA weight
    factor: float = 1.5          # flag hosts slower than factor x median

    def __post_init__(self):
        self.ewma: dict[str, float] = {}

    def record(self, host: str, step_time: float):
        prev = self.ewma.get(host)
        self.ewma[host] = (step_time if prev is None
                           else self.alpha * step_time
                           + (1 - self.alpha) * prev)

    def stragglers(self) -> list[str]:
        if len(self.ewma) < 2:
            return []
        med = float(np.median(list(self.ewma.values())))
        return [h for h, t in self.ewma.items() if t > self.factor * med]
