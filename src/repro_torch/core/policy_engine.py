"""Compiled policy decisions: per-VM memory splits as struct-of-arrays.

The provisioning loop prices a *decision set* — for every VM its local
GB, pool GB, whether it is fully pooled and when (if ever) a QoS
mitigation migrates its pool memory to local.  :class:`PolicyDecisions`
holds these as arrays; ``core/replay_engine.py::CompiledReplay`` compiles
them natively.  :func:`policy_decisions_compiled` computes them for the
``local`` and ``static`` policies, vectorised, bit-exact against the
reference's scalar walk (decisions and the misprediction rate, summed in
the scalar loop's float order).  The ``pond`` policy needs the predictors
and the control plane (ROADMAP M8); until then its decisions are carried
in as arrays (``PolicyDecisions`` built from numpy), MIGRATE events
included.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core import qos, traces


# ------------------------------------------------------------- decisions ---
@dataclasses.dataclass
class PolicyDecisions:
    """Struct-of-arrays pendant of ``list[cluster_sim.VMDecision]``.

    ``t_migrate`` uses NaN for "no QoS migration".  :meth:`as_vmdecisions`
    materialises the object list for the scalar oracle.
    """
    local_gb: np.ndarray      # (N,) float64
    pool_gb: np.ndarray       # (N,) float64
    fully_pooled: np.ndarray  # (N,) bool
    t_migrate: np.ndarray     # (N,) float64, NaN = none
    mispredictions: float = 0.0
    n_mitigations: int = 0

    def __len__(self) -> int:
        return len(self.local_gb)

    @property
    def n_migrations(self) -> int:
        """Number of compiled MIGRATE events this decision set emits."""
        return int(np.isfinite(self.t_migrate).sum())

    def slice(self, lo: int, hi: int) -> "PolicyDecisions":
        """Rows ``[lo, hi)`` as a new SoA (zero-copy numpy views).
        Aggregate fields (``mispredictions``, ``n_mitigations``) are
        trace-level, not per-row, so the slice resets them to zero."""
        return PolicyDecisions(self.local_gb[lo:hi],
                               self.pool_gb[lo:hi],
                               self.fully_pooled[lo:hi],
                               self.t_migrate[lo:hi])

    def as_vmdecisions(self) -> list:
        """Materialise ``cluster_sim.VMDecision`` objects (off the hot
        path: the scalar oracle indexes them)."""
        from repro_torch.core.cluster_sim import VMDecision
        return [VMDecision(float(l), float(p), bool(f),
                           None if math.isnan(t) else float(t))
                for l, p, f, t in zip(self.local_gb, self.pool_gb,
                                      self.fully_pooled, self.t_migrate)]


def decisions_from_list(decisions) -> PolicyDecisions:
    """Pack a ``VMDecision`` sequence into :class:`PolicyDecisions`."""
    n = len(decisions)
    return PolicyDecisions(
        np.fromiter((d.local_gb for d in decisions), float, n),
        np.fromiter((d.pool_gb for d in decisions), float, n),
        np.fromiter((d.fully_pooled for d in decisions), bool, n),
        np.fromiter((np.nan if d.t_migrate is None else d.t_migrate
                     for d in decisions), float, n))


# ----------------------------------------------------- compiled pipeline ---
def _sequential_mispred(full: np.ndarray, spill: np.ndarray,
                        harm: np.ndarray, spill_harm_prob: float,
                        n: int) -> float:
    """Misprediction rate accumulated in the scalar loop's float order:
    the few nonzero contributions (``1.0`` for a fully-pooled miss,
    ``spill_harm_prob`` for an overprediction) are re-added one by one in
    trace order, so the sum matches the scalar walk to the last ulp."""
    mis = 0.0
    c_full = full & harm
    c_spill = ~full & spill & harm
    for i in np.flatnonzero(c_full | c_spill):
        mis += 1.0 if c_full[i] else spill_harm_prob
    return mis / max(n, 1)


def policy_decisions_compiled(vms, policy: str, control_plane=None,
                              static_pool_frac: float = 0.15,
                              latency: int = 182, pdm: float = 0.05,
                              spill_harm_prob: float = 0.25,
                              table: traces.VMTable | None = None
                              ) -> PolicyDecisions:
    """Vectorised per-VM memory split for ``local`` and ``static``.

    ``local`` keeps every VM's memory local; ``static`` puts
    ``floor(mem_gb * static_pool_frac)`` GB of each VM in the pool.
    ``pond`` raises (ROADMAP M8: it needs the predictors).

    Usage::

        dec = policy_decisions_compiled(vms, "static",
                                        static_pool_frac=0.25)
        eng = replay_engine.CompiledReplay(vms, dec, cfg)
    """
    table = table if table is not None else traces.vm_table(vms)
    n = len(table)
    mem = table.mem_gb
    slows = table.slow182 if latency == 182 else table.slow222
    fully = np.zeros(n, bool)
    if policy == "local":
        local, pool = mem.copy(), np.zeros(n)
    elif policy == "static":
        pool = np.floor(mem * static_pool_frac)
        local = mem - pool
    elif policy == "pond":
        raise NotImplementedError(
            "the pond policy needs the predictors and the control plane, "
            "which are not ported yet (ROADMAP M8); carry its decisions "
            "in as a PolicyDecisions built from numpy arrays")
    else:
        raise ValueError(policy)
    spill = pool > table.untouched * mem + 1e-9
    mispred = _sequential_mispred(fully, spill,
                                  qos.exceeds_pdm(slows, pdm),
                                  spill_harm_prob, n)
    return PolicyDecisions(local, pool, fully, np.full(n, np.nan), mispred,
                           0)
