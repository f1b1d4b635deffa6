"""Fault tolerance: failure detection, the elastic re-mesh, the EMC
failure schedule priced by the failure layer, stragglers and failure
injection (the reference's ``repro/runtime/fault.py``).

* ``HeartbeatMonitor`` — declares a host dead after ``timeout`` without a
  beat (Pond's EMC blast-radius isolation: only what lives on the failed
  EMC is affected).
* ``largest_mesh_shape`` — the largest (pod, data, model) grid a surviving
  device count holds, the model axis kept whole (arithmetic only).
* ``elastic_mesh`` — that grid as a ``launch.mesh.Mesh`` over the first
  surviving devices; training resumes from the last checkpoint restored
  onto it (checkpoints do not depend on the mesh).
* ``FailureSchedule`` — a seeded sequence of ``FAIL(domain)`` /
  ``RECOVER(domain)`` events over the pool's failure domains (Pond §4.2:
  one domain per EMC group).  ``replay_engine.CompiledReplay`` merges it
  into a trace's event stream and ``availability()`` prices its blast
  radius; ``cluster_sim.replay_with_failures`` is the scalar oracle.
* ``StragglerTracker`` — EWMA per-host step times; hosts slower than
  ``factor`` x the median are flagged.
* ``FailureInjector`` — a deterministic step-indexed failure schedule for
  the training drills.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable

import numpy as np


class HeartbeatMonitor:
    def __init__(self, hosts: list[str], timeout: float = 3.0,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout = timeout
        self.clock = clock
        self.last = {h: clock() for h in hosts}

    def beat(self, host: str):
        self.last[host] = self.clock()

    def dead_hosts(self) -> list[str]:
        now = self.clock()
        return [h for h, t in self.last.items()
                if now - t > self.timeout]

    def alive_hosts(self) -> list[str]:
        dead = set(self.dead_hosts())
        return [h for h in self.last if h not in dead]


def largest_mesh_shape(n_devices: int, model_parallel: int,
                       multi_pod: bool = False) -> tuple[int, ...]:
    """Largest (pod, data, model) grid that fits in n_devices, keeping the
    model axis intact (TP degree is fixed by the arch's weight shards)."""
    if n_devices < model_parallel:
        raise ValueError(f"{n_devices} devices cannot host "
                         f"model_parallel={model_parallel}")
    rows = n_devices // model_parallel
    if not multi_pod:
        return (rows, model_parallel)
    pods = 2 if rows >= 2 else 1
    return (pods, rows // pods, model_parallel)


def elastic_mesh(devices, model_parallel: int, multi_pod: bool = False):
    """Build the largest healthy mesh from surviving devices."""
    from repro_torch.launch.mesh import make_mesh

    shape = largest_mesh_shape(len(devices), model_parallel, multi_pod)
    n = math.prod(shape)
    names = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    return make_mesh(shape, names, devices=list(devices[:n]))


class FailureInjector:
    """Deterministic failure schedule for tests and drills."""

    def __init__(self, fail_at: dict[int, list[str]]):
        self.fail_at = fail_at   # step -> hosts that die at that step

    def failed_by(self, step: int) -> set[str]:
        out: set[str] = set()
        for s, hosts in self.fail_at.items():
            if step >= s:
                out.update(hosts)
        return out


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
