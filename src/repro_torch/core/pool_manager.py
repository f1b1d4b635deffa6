"""Pool Manager: Pond §4.2–4.3 control flows.

Sits on the EMC blade, connected to EMCs + hosts via a low-power
management bus.  Responsibilities:
  * Add_capacity(host, gb)  — online slices to a host before a VM starts
    (fast path; never blocks on offlining thanks to the free buffer).
  * Release_capacity(host)  — asynchronous drain when a VM departs.
  * Buffer replenishment    — keeps >= buffer_gb free so VM starts never
    wait on the 10–100 ms/GB offline path.
  * Failure management      — EMC failure affects only VMs with slices on
    that EMC; PM failure blocks reassignment but never the datapath.

A copy of the reference's ``core/pool_manager.py`` over the port's
``slices.SlicePool``, with ``FleetPoolManager``, one Pool Manager a pod of
a ``core/topology.py`` incidence (the fleet engines' control-plane twin).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.slices import SlicePool


@dataclasses.dataclass
class PMStats:
    assigns: int = 0
    releases: int = 0            # voluntary + forced (EMC-failure) drains
    blocked_starts: int = 0      # VM starts that found the buffer short
    peak_assigned_gb: float = 0.0
    revoked_gb: float = 0.0      # GB force-released by EMC failures

    def outstanding(self) -> int:
        """Release operations still owed: ``assigns - releases``.

        ``fail_emc`` counts one forced release per affected host (the
        same unit ``release_capacity``/``fail_host`` use), so failures
        keep the drain ledger moving — it used to leak: failed grants
        vanished from ``grants`` with no matching release recorded
        (regression pinned in ``tests/test_failures.py``)."""
        return self.assigns - self.releases


class PoolManager:
    def __init__(self, pool_gb: int, num_emcs: int = 1, slice_gb: float = 1.0,
                 buffer_gb: float = 16.0, seed: int = 0):
        per_emc = int(pool_gb / num_emcs / slice_gb)
        self.emcs = [SlicePool(per_emc, slice_gb, seed=seed + i)
                     for i in range(num_emcs)]
        self.slice_gb = slice_gb
        self.buffer_gb = buffer_gb
        self.stats = PMStats()
        self.alive = True
        # (host, emc) -> slice ids
        self.grants: dict[tuple[int, int], list] = {}

    # ------------------------------------------------------------- flows --
    def total_free_gb(self, now: float = 0.0) -> float:
        return sum(e.free_gb() for e in self._tick(now))

    def _tick(self, now: float):
        for e in self.emcs:
            e.tick(now)
        return self.emcs

    def add_capacity(self, host: int, gb: float, now: float = 0.0) -> bool:
        """Online `gb` to `host` across EMCs. Returns False if short."""
        if not self.alive:
            return False           # PM down: no reassignment (datapath ok)
        self._tick(now)
        need = gb
        plan = []
        for ei, emc in enumerate(self.emcs):
            take = min(need, emc.free_gb())
            if take > 0:
                plan.append((ei, take))
                need -= take
            if need <= 1e-9:
                break
        if need > 1e-9:
            self.stats.blocked_starts += 1
            return False
        for ei, take in plan:
            ids = self.emcs[ei].assign(host, take, now)
            self.grants.setdefault((host, ei), []).extend(map(int, ids))
        self.stats.assigns += 1
        self.stats.peak_assigned_gb = max(
            self.stats.peak_assigned_gb, self.assigned_gb())
        return True

    def release_capacity(self, host: int, now: float = 0.0,
                         gb: float | None = None) -> None:
        """Async release (Figure 9): slices drain, buffer replenishes."""
        if not self.alive:
            return
        remaining = gb
        for (h, ei), ids in list(self.grants.items()):
            if h != host or not ids:
                continue
            if remaining is None:
                take = ids
            else:
                n = int(np.ceil(remaining / self.slice_gb))
                take, self.grants[(h, ei)] = ids[:n], ids[n:]
                remaining -= len(take) * self.slice_gb
            if take:
                self.emcs[ei].release(host, take, now)
                if remaining is None:
                    self.grants[(h, ei)] = []
        self.stats.releases += 1

    def assigned_gb(self) -> float:
        return sum(len(ids) for ids in self.grants.values()) * self.slice_gb

    def host_pool_gb(self, host: int) -> float:
        return sum(len(ids) for (h, _), ids in self.grants.items()
                   if h == host) * self.slice_gb

    # ---------------------------------------------------------- failures --
    def fail_emc(self, emc_idx: int) -> list[int]:
        """EMC failure: blast radius = hosts with slices on THAT EMC only.

        Reconciles ``PMStats``: every affected host's wiped grant counts
        as one FORCED release (the unit ``release_capacity`` uses) and
        the wiped capacity lands in ``revoked_gb`` — previously the
        grants just vanished, leaving ``assigns - releases`` leaking one
        release per affected host per failure.
        """
        affected = sorted({h for (h, ei), ids in self.grants.items()
                           if ei == emc_idx and ids})
        revoked = 0
        for (h, ei) in list(self.grants):
            if ei == emc_idx:
                revoked += len(self.grants[(h, ei)])
                del self.grants[(h, ei)]
        self.emcs[emc_idx].owner[:] = -1
        self.stats.releases += len(affected)
        self.stats.revoked_gb += revoked * self.slice_gb
        return affected

    def fail_host(self, host: int, now: float = 0.0) -> None:
        """Host failure: its pool memory returns to the pool (async)."""
        self.release_capacity(host, now)

    def fail_pool_manager(self) -> None:
        self.alive = False

    def recover_pool_manager(self) -> None:
        """PM restart: reassignment resumes.  Nothing to rebuild —
        grants live on the EMCs and the datapath never stopped serving
        them while the PM was down (Pond §4.2)."""
        self.alive = True


class FleetPoolManager:
    """One Pool Manager per pod over a ``core/topology.py`` incidence.

    The control-plane twin of the fleet replay engines: each pod is an
    independent :class:`PoolManager` (its own EMCs, buffer, stats, and
    failure domain), and a host draws capacity from the pods its
    topology row lists — the WHOLE demand from the FIRST reachable pod
    that can grant it, mirroring the engines' admission rule.  Pods a
    host cannot reach never see its grants, so a pod failure's blast
    radius is bounded by that pod's members (asserted in
    ``tests/test_failures.py``: failing one pod must not touch sibling
    pods' grants).
    """

    def __init__(self, topology, pod_gb, num_emcs: int = 1,
                 slice_gb: float = 1.0, buffer_gb: float = 16.0,
                 seed: int = 0):
        caps = np.atleast_1d(np.asarray(pod_gb, float))
        if len(caps) == 1:
            caps = np.repeat(caps, topology.n_pods)
        if len(caps) != topology.n_pods:
            raise ValueError(
                f"{len(caps)} pod capacities for {topology.n_pods} pods")
        self.topology = topology
        self.pods = [PoolManager(int(caps[q]), num_emcs=num_emcs,
                                 slice_gb=slice_gb, buffer_gb=buffer_gb,
                                 seed=seed + 1000 * q)
                     for q in range(topology.n_pods)]

    # ------------------------------------------------------------- flows --
    def add_capacity(self, host: int, gb: float,
                     now: float = 0.0) -> Optional[int]:
        """Online ``gb`` to ``host`` from its first reachable pod with
        room.  Returns the granting pod index, or None when every
        reachable pod is short (the caller's all-local fallback)."""
        for q in self.topology.pods_of(host):
            if self.pods[q].add_capacity(host, gb, now):
                return q
        return None

    def release_capacity(self, host: int, now: float = 0.0) -> None:
        """Drain every reachable pod's grants for ``host``."""
        for q in self.topology.pods_of(host):
            if self.pods[q].host_pool_gb(host) > 0:
                self.pods[q].release_capacity(host, now)

    def host_pool_gb(self, host: int) -> float:
        return sum(self.pods[q].host_pool_gb(host)
                   for q in self.topology.pods_of(host))

    def pod_free_gb(self, now: float = 0.0) -> np.ndarray:
        return np.array([pm.total_free_gb(now) for pm in self.pods])

    def assigned_gb(self) -> float:
        return sum(pm.assigned_gb() for pm in self.pods)

    # ---------------------------------------------------------- failures --
    def fail_pod(self, pod: int) -> list[int]:
        """Whole-pod failure: every EMC of ``pod`` fails; sibling pods'
        grants and stats are untouched (per-pod blast radius).  Returns
        the affected hosts (members of ``pod`` holding slices on it)."""
        pm = self.pods[pod]
        affected: set[int] = set()
        for ei in range(len(pm.emcs)):
            affected.update(pm.fail_emc(ei))
        return sorted(affected)
