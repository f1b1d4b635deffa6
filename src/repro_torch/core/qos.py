"""QoS monitor + mitigation manager of Pond's control plane (§4.3 B,
Figure 11).

The monitor inspects every running VM once per sampling interval:
  B1: query hypervisor + PMU counters,
  B2: the sensitivity model decides whether the VM exceeds the PDM,
  B3: the mitigation manager triggers a one-time memory reconfiguration —
      the hypervisor copies the VM's pool memory to local (50 ms/GB).
      After that the VM is all-local and never re-pooled (§4.2).
A copy of the reference's ``core/qos.py``; its grids over many VMs and
thresholds are ``core/latency_engine.py``'s.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch.core.latency_model import migration_seconds


def exceeds_pdm(slowdown, pdm: float):
    """Canonical PDM-violation predicate: slowdown AT the margin counts.

    The paper's tail-latency predicate is inclusive (a VM whose slowdown
    reaches the performance degradation margin has exhausted it), matching
    the monitor's ``p >= threshold`` mitigation trigger below.  Works
    elementwise on arrays.
    """
    return slowdown >= pdm


@dataclasses.dataclass
class Mitigation:
    vm_id: int
    at: float
    pool_gb: float
    copy_seconds: float


class MitigationManager:
    def __init__(self):
        self.log: list[Mitigation] = []
        self.migrated: set[int] = set()

    def migrate(self, vm_id: int, pool_gb: float, now: float) -> Mitigation:
        m = Mitigation(vm_id, now, pool_gb, migration_seconds(pool_gb))
        self.log.append(m)
        self.migrated.add(vm_id)
        return m


class QoSMonitor:
    """Checks zNUMA spill + model-predicted sensitivity against the PDM."""

    def __init__(self, pdm: float, p_sensitive: Callable[[np.ndarray],
                                                         np.ndarray],
                 threshold: float, mitigation: MitigationManager):
        self.pdm = pdm
        self.p_sensitive = p_sensitive
        self.threshold = threshold
        self.mitigation = mitigation
        self.checks = 0

    def check(self, vm_id: int, pmu: np.ndarray, spilled: bool,
              pool_gb: float, now: float) -> Mitigation | None:
        """spilled: the VM touched pool memory beyond its zNUMA sizing
        (access-bit telemetry).  Pool-backed VMs always count as spilled."""
        self.checks += 1
        if vm_id in self.mitigation.migrated or not spilled or pool_gb <= 0:
            return None
        p = float(self.p_sensitive(pmu[None])[0])
        if p >= self.threshold:          # predicted to exceed the PDM
            return self.mitigation.migrate(vm_id, pool_gb, now)
        return None
