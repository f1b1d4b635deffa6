"""Pond distributed control plane (Figure 11 / §4.3).

A) VM scheduling with predictions:
   A1 request -> A2 query the ML serving system (LI + UM models) ->
   A3 inform the Pool Manager of the target host's pool need ->
   A4 PM onlines slices (fast path) and the VM starts on a zNUMA topology.
B) QoS monitoring loop: see qos.py.

A copy of the reference's ``core/control_plane.py``: the compiled policy
engine (``policy_engine.policy_decisions_compiled``, ``pond``) advances
this class's state to the scalar walk's end state.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import traces
from repro_torch.core.pool_manager import PoolManager
from repro_torch.core.qos import MitigationManager, QoSMonitor


@dataclasses.dataclass
class Placement:
    vm_id: int
    host: int
    local_gb: float
    pool_gb: float
    fully_pooled: bool          # latency-insensitive -> all pool
    predicted_untouched: float


@dataclasses.dataclass
class ControlPlaneConfig:
    pdm: float = 0.05
    tp: float = 0.98                 # target fraction of VMs within PDM
    li_threshold: float = 0.5        # from eqn1.combine
    um_quantile: float = 0.05
    min_history_vms: int = 3


class ControlPlane:
    def __init__(self, cfg: ControlPlaneConfig, li_model, um_model,
                 pool_manager: PoolManager, history: dict | None = None):
        self.cfg = cfg
        self.li_model = li_model
        self.um_model = um_model
        self.pm = pool_manager
        self.history = history or {}
        self._owned_hist: set = set()   # customers whose history list
        # is private to this plane (see record_untouched)
        self.mitigation = MitigationManager()
        self.monitor = QoSMonitor(
            cfg.pdm,
            lambda f: li_model.p_sensitive(f) if li_model else
            np.ones(len(f)),
            cfg.li_threshold, self.mitigation)
        self.placements: dict[int, Placement] = {}

    # ------------------------------------------------------------- A flow -
    def decide(self, vm: traces.VM) -> tuple[float, float, bool, float]:
        """(local_gb, pool_gb, fully_pooled, predicted_untouched_frac)."""
        hist = self.history.get(vm.customer)
        has_history = hist is not None and len(hist) >= \
            self.cfg.min_history_vms
        if has_history and self.li_model is not None:
            p = float(self.li_model.p_sensitive(vm.pmu[None])[0])
            if p < self.cfg.li_threshold:
                return 0.0, vm.mem_gb, True, 1.0
        if self.um_model is not None:
            feat = traces.metadata_features([vm], self.history)
            um = float(self.um_model.predict(feat)[0])
        else:
            um = 0.0
        pool_gb = float(np.floor(um * vm.mem_gb))     # GB-aligned, rounded
        return vm.mem_gb - pool_gb, pool_gb, False, um  # DOWN, never up

    def on_request(self, vm: traces.VM, host: int,
                   now: float) -> Placement | None:
        local_gb, pool_gb, fully, um = self.decide(vm)
        if pool_gb > 0 and not self.pm.add_capacity(host, pool_gb, now):
            # pool buffer short: fall back to all-local (never block starts)
            local_gb, pool_gb, fully = vm.mem_gb, 0.0, False
        pl = Placement(vm.vm_id, host, local_gb, pool_gb, fully, um)
        self.placements[vm.vm_id] = pl
        return pl

    def record_untouched(self, customer: int, untouched: float) -> None:
        """Append one untouched-memory observation to a customer's
        history, in place (amortized O(1) per VM).

        Seeded histories (``traces.build_history`` arrays, or plain
        lists) may be SHARED across control planes via shallow
        ``dict(hist)`` copies, so this plane's FIRST write per customer
        copies the stored sequence to a private list — siblings keep
        seeing the seed data only, whatever type it was.  Callers that
        want to rewind observations use :meth:`reset_history`.
        """
        self._owned_list(customer).append(untouched)

    def _owned_list(self, customer: int) -> list:
        """The customer's history as a list PRIVATE to this plane —
        the copy-on-first-write rule both append paths share."""
        h = self.history.get(customer)
        if customer not in self._owned_hist:
            h = [] if h is None else list(h)
            self.history[customer] = h
            self._owned_hist.add(customer)
        return h

    def extend_untouched(self, customer: int, values) -> None:
        """Bulk :meth:`record_untouched`: append a whole sequence of
        observations for one customer at once (the compiled policy
        engine records a trace's history per customer instead of per
        VM).  Shares the copy-on-first-write ownership rules, and the
        final history state equals ``record_untouched`` called once per
        value in order."""
        self._owned_list(customer).extend(values)

    def reset_history(self, history: dict | None = None) -> None:
        """Reset hook for :meth:`record_untouched`'s in-place appends:
        drop every recorded observation and (optionally) re-seed from a
        fresh per-customer mapping, e.g. ``traces.build_history`` output.
        The mapping is shallow-copied, matching the constructor (the
        next write per customer makes a private copy)."""
        self.history = dict(history) if history is not None else {}
        self._owned_hist = set()

    def on_departure(self, vm: traces.VM, now: float):
        pl = self.placements.pop(vm.vm_id, None)
        if pl is not None and pl.pool_gb > 0:
            self.pm.release_capacity(pl.host, now, gb=pl.pool_gb)
        if pl is not None:
            self.record_untouched(vm.customer, vm.untouched)

    # ------------------------------------------------------------- B flow -
    def monitor_step(self, vm: traces.VM, now: float):
        """Returns a Mitigation if the QoS monitor reconfigured the VM."""
        pl = self.placements.get(vm.vm_id)
        if pl is None or pl.pool_gb <= 0:
            return None
        actual_untouched_gb = vm.untouched * vm.mem_gb
        spilled = pl.fully_pooled or pl.pool_gb > actual_untouched_gb + 1e-9
        mit = self.monitor.check(vm.vm_id, vm.pmu, spilled, pl.pool_gb, now)
        if mit is not None:
            # memory copied to local: release the pool slices
            self.pm.release_capacity(pl.host, now, gb=pl.pool_gb)
            self.placements[vm.vm_id] = dataclasses.replace(
                pl, local_gb=vm.mem_gb, pool_gb=0.0, fully_pooled=False)
        return mit
