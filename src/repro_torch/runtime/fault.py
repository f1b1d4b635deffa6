"""Failure handling: the EMC failure schedule priced by the failure layer,
and straggler detection for replica routing (the port's share of the
reference's ``repro/runtime/fault.py``; heartbeats and elastic meshes
arrive with the training slice).

* ``FailureSchedule`` — a seeded sequence of ``FAIL(domain)`` /
  ``RECOVER(domain)`` events over the pool's failure domains (Pond §4.2:
  one domain per EMC group).  ``replay_engine.CompiledReplay`` merges it
  into a trace's event stream and ``availability()`` prices its blast
  radius; ``cluster_sim.replay_with_failures`` is the scalar oracle.
* ``StragglerTracker`` — EWMA per-host step times; hosts slower than
  ``factor`` x the median are flagged.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class FailureSchedule:
    """Trace-level EMC failure schedule (Pond §4.2 blast radius).

    ``times`` are seconds on the trace clock, non-decreasing;
    ``recovers[i]`` marks event ``i`` as a RECOVER (else a FAIL) of
    ``domains[i]``.  Between a domain's FAIL and its RECOVER its pool
    capacity is offline: arrivals needing pool slices there fall back
    all-local or are rejected (§4.3).
    """

    times: np.ndarray            # (n,) float seconds, non-decreasing
    domains: np.ndarray          # (n,) int domain (EMC group) index
    recovers: np.ndarray         # (n,) bool: True = RECOVER, False = FAIL

    def __post_init__(self):
        t = np.asarray(self.times, float)
        d = np.asarray(self.domains, np.int64)
        r = np.asarray(self.recovers, bool)
        if not (len(t) == len(d) == len(r)):
            raise ValueError("times/domains/recovers must align")
        if len(t) and (np.diff(t) < 0).any():
            raise ValueError("FailureSchedule times must be non-decreasing")
        if len(d) and d.min() < 0:
            raise ValueError("negative failure domain")
        object.__setattr__(self, "times", t)
        object.__setattr__(self, "domains", d)
        object.__setattr__(self, "recovers", r)

    def __len__(self) -> int:
        return len(self.times)

    @property
    def n_failures(self) -> int:
        return int((~self.recovers).sum())

    def max_domain(self) -> int:
        return int(self.domains.max(initial=-1))

    @classmethod
    def generate(cls, horizon_s: float, n_domains: int, mtbf_s: float,
                 repair_s: float, seed: int = 0) -> "FailureSchedule":
        """Seeded schedule: per-domain exponential inter-failure times
        (mean ``mtbf_s``) with a fixed ``repair_s`` outage each, domains
        drawn in turn from one generator, the whole sequence sorted by
        (time, FAIL before RECOVER).  Deterministic in ``seed``."""
        rng = np.random.default_rng(seed)
        times, domains, recovers = [], [], []
        for d in range(n_domains):
            t = 0.0
            while True:
                t += float(rng.exponential(mtbf_s))
                if t >= horizon_s:
                    break
                times.append(t)
                domains.append(d)
                recovers.append(False)
                t += repair_s
                if t < horizon_s:
                    times.append(t)
                    domains.append(d)
                    recovers.append(True)
        times = np.asarray(times, float)
        domains = np.asarray(domains, np.int64)
        recovers = np.asarray(recovers, bool)
        order = np.lexsort((recovers, times))   # FAIL sorts before RECOVER
        return cls(times[order], domains[order], recovers[order])


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
