"""Compiled policy decisions: per-VM memory splits as struct-of-arrays.

The provisioning loop prices a *decision set* — for every VM its local
GB, pool GB, whether it is fully pooled and when (if ever) a QoS
mitigation migrates its pool memory to local.  :class:`PolicyDecisions`
holds these as arrays; ``core/replay_engine.py::CompiledReplay`` compiles
them natively.  :func:`policy_decisions_compiled` computes them for the
``local``, ``static`` and ``pond`` policies, vectorised, bit-exact
against the reference's scalar control-plane walk: decisions, the
misprediction rate (summed in the scalar loop's float order) and, for
``pond``, the control plane's end state (histories, monitor checks, the
mitigation log).  ``pond`` runs Pond's whole decide -> place -> monitor
-> mitigate pipeline on the host, as the reference does:

* history percentiles as sorted segment ops (:func:`_prefix_percentiles`,
  every prefix of every customer's untouched history, bitwise
  ``np.percentile``, numpy's ``gamma >= 0.5`` lerp branch included);
* one forest call scores every VM's sensitivity and one GBM call prices
  every VM's untouched quantile (row-bitwise, ``core/predictors``);
* spill detection, sensitivity sampling and the migration times
  (``arrival + 60``) as array ops.

On top of the single-policy pipeline, the **grid axis** prices many
policy settings at once (Fig 17): :func:`grid_decisions` evaluates a list
of :class:`PolicySetting` (tau, pdm, li-threshold / fp-target) against a
trace batch with the features and forest probabilities computed once and
the tau axis priced as one numpy ensemble walk a tau (bitwise a fresh
control plane a setting) or in one torch pass over the stacked tau models
(``gbm.predict_gbms_torch``); its decision grid feeds
``cluster_sim.savings_analysis_batched(decisions=...)``.

With tracing on (``core/obs.py``), ``policy_decisions_compiled`` runs in a
``policy.decisions`` span and pond's stages in ``policy.decide``,
``policy.place``, ``policy.monitor`` and ``policy.mitigate``, as the
reference's do.
"""
from __future__ import annotations

import dataclasses
import itertools
import math

import numpy as np

from repro_torch.core import obs, qos, traces

#: quantiles of the customer history used as UM-model features
#: (``traces.metadata_features``)
_QS = (80.0, 90.0, 95.0, 99.0)
_PRIOR = 0.5          # no-history feature prior
_MIN_HIST_FEAT = 3    # metadata_features' hardcoded history floor
_MONITOR_DELAY = 60.0  # the scalar loop samples QoS at arrival + 60s
#: column budget (elements) for one prefix-membership block
_PREFIX_BLOCK_ELEMS = 4_000_000


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


# --------------------------------------------------- history percentiles ---
def _np_lerp(a: np.ndarray, b: np.ndarray, t: np.ndarray) -> np.ndarray:
    """numpy's percentile lerp, branch for branch: ``a + (b-a)*t`` but
    ``b - (b-a)*(1-t)`` when ``t >= 0.5`` (the rewrite numpy applies for
    monotonicity).  Replicating the branch keeps the vectorized
    percentiles bit-identical to ``np.percentile``."""
    d = b - a
    out = a + d * t
    hi = t >= 0.5
    if hi.any():
        out = np.where(hi, b - d * (1.0 - t), out)
    return out


def _prefix_percentiles(customers: np.ndarray, untouched: np.ndarray,
                        history: dict | None,
                        qs=_QS) -> tuple[np.ndarray, np.ndarray]:
    """History length and feature percentiles for every VM of a trace.

    For VM ``i`` (trace order), the customer's history at decision time
    is its seeded sequence from ``history`` plus the ``untouched``
    observations of the customer's EARLIER VMs (the scalar loop appends
    via ``record_untouched`` after each decision).  Returns

    * ``n_hist``  — (N,) history length at decision time, and
    * ``percs``   — (N, len(qs)) float64, ``np.percentile(h, qs)``
      bit-for-bit where ``n_hist >= 3``, the 0.5 prior row elsewhere.

    Instead of re-sorting each prefix (the per-VM history walk), each
    customer's seed+append values are sorted ONCE; a cumulative count
    of prefix membership over the sorted order answers every prefix's
    order statistics at the ranks the linear-interpolation formula
    needs, in column blocks that bound the membership matrix to
    ``_PREFIX_BLOCK_ELEMS`` elements.
    """
    cust = np.asarray(customers, np.int64)
    ut = np.asarray(untouched, float)
    n = len(cust)
    qf = np.asarray(qs, float) / 100.0
    percs = np.full((n, len(qf)), _PRIOR)
    n_hist = np.zeros(n, np.int64)
    if not n:
        return n_hist, percs
    hist = history or {}
    order = np.argsort(cust, kind="stable")
    bounds = np.flatnonzero(np.diff(cust[order])) + 1
    for g in np.split(order, bounds):           # one group per customer
        c = int(cust[g[0]])
        seed = hist.get(c)
        seed = (np.asarray(seed, float) if seed is not None
                else np.empty(0))
        ns = len(seed)
        k = len(g)
        n_hist[g] = ns + np.arange(k)
        j0 = max(0, _MIN_HIST_FEAT - ns)        # first prefix with n >= 3
        if j0 >= k:
            continue
        vals = np.concatenate([seed, ut[g]])
        birth = np.concatenate([np.full(ns, -1, np.int64),
                                np.arange(k, dtype=np.int64)])
        o = np.argsort(vals, kind="stable")
        vs, bs = vals[o], birth[o]
        m = len(vals)
        cols = np.arange(j0, k)
        nj = ns + cols
        vi = qf[None, :] * (nj[:, None] - 1)    # same op as np.percentile
        lo = np.floor(vi)
        gamma = vi - lo
        lo_i = lo.astype(np.int64)
        blk = max(1, _PREFIX_BLOCK_ELEMS // m)
        out = np.empty((len(cols), len(qf)))
        for b0 in range(0, len(cols), blk):
            cb = cols[b0:b0 + blk]
            # membership of each sorted value in each prefix, counted
            # cumulatively: the rank-r member of prefix j sits at the
            # first sorted position whose count reaches r + 1
            count = np.cumsum(bs[:, None] < cb[None, :], axis=0,
                              dtype=np.int32)
            for qi in range(len(qf)):
                rlo = lo_i[b0:b0 + blk, qi]
                ilo = (count < (rlo + 1)[None, :].astype(np.int32)).sum(0)
                ihi = (count < (rlo + 2)[None, :].astype(np.int32)).sum(0)
                out[b0:b0 + blk, qi] = _np_lerp(
                    vs[ilo], vs[ihi], gamma[b0:b0 + blk, qi])
        percs[g[j0:]] = out
    return n_hist, percs


def metadata_features_compiled(table: traces.VMTable,
                               percs: np.ndarray) -> np.ndarray:
    """UM feature matrix from a :class:`~repro_torch.core.traces.VMTable` and
    precomputed history percentiles — bit-identical to
    ``traces.metadata_features`` row by row (float64 columns cast to
    float32 exactly like ``np.asarray(rows, np.float32)``)."""
    cols = np.column_stack([
        percs,
        table.vm_type.astype(float), table.cores.astype(float),
        table.mem_gb, table.location.astype(float),
        table.guest_os.astype(float)])
    return cols.astype(np.float32)


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


@obs.traced("policy.decisions")
def policy_decisions_compiled(vms, policy: str, control_plane=None,
                              static_pool_frac: float = 0.15,
                              latency: int = 182, pdm: float = 0.05,
                              spill_harm_prob: float = 0.25,
                              table: traces.VMTable | None = None
                              ) -> PolicyDecisions:
    """Vectorised per-VM memory split, bit-exact against the scalar walk.

    ``local`` keeps every VM's memory local; ``static`` puts
    ``floor(mem_gb * static_pool_frac)`` GB of each VM in the pool;
    ``pond`` asks ``control_plane``'s models (history percentiles, one
    forest call for every VM's sensitivity, one GBM call for every
    untouched quantile) and runs its QoS monitor, and advances the control
    plane to the scalar loop's end state: per-customer histories extend
    in place (copy-on-first-write kept), ``monitor.checks`` counts every
    pool-backed VM, and ``mitigation.log``/``.migrated`` gain the same
    entries in trace order.  Requires unique ``vm_id``s.

    Usage::

        cp = ControlPlane(ControlPlaneConfig(li_threshold=0.05), li, um,
                          PoolManager(4096), history=dict(hist))
        dec = policy_decisions_compiled(vms, "pond", control_plane=cp)
        eng = replay_engine.CompiledReplay(vms, dec, cfg)
        assert dec.n_mitigations == len(cp.mitigation.log)
    """
    table = table if table is not None else traces.vm_table(vms)
    n = len(table)
    mem = table.mem_gb
    slows = table.slow182 if latency == 182 else table.slow222
    t_mig = np.full(n, np.nan)
    fully = np.zeros(n, bool)
    n_mitig = 0
    if policy == "local":
        local, pool = mem.copy(), np.zeros(n)
    elif policy == "static":
        pool = np.floor(mem * static_pool_frac)
        local = mem - pool
    elif policy == "pond":
        cp = control_plane
        if cp is None:
            raise ValueError("the pond policy needs a control_plane")
        cfg = cp.cfg
        rec = obs.get_recorder()
        # decide: history percentiles + LI sensitivity + UM quantile
        # predictions -> local/pool split per VM
        with rec.span("policy.decide"):
            n_hist, percs = _prefix_percentiles(table.customer,
                                                table.untouched, cp.history)
            if cp.li_model is not None:
                p = np.asarray(cp.li_model.p_sensitive_batch(table.pmu))
            else:
                p = np.ones(n)
            has_hist = (n_hist >= cfg.min_history_vms) \
                & (cp.li_model is not None)
            fully = has_hist & (p < cfg.li_threshold)
            if cp.um_model is not None:
                feat = metadata_features_compiled(table, percs)
                um = cp.um_model.predict(feat).astype(np.float64)
            else:
                um = np.zeros(n)
            pool = np.floor(um * mem)
            local = mem - pool
            pool[fully] = mem[fully]
            local[fully] = 0.0
        # place: every VM's untouched observation appends, per customer in
        # trace order (the same end state as record_untouched)
        with rec.span("policy.place"):
            order = np.argsort(table.customer, kind="stable")
            bounds = np.flatnonzero(np.diff(table.customer[order])) + 1
            for g in np.split(order, bounds):
                cp.extend_untouched(int(table.customer[g[0]]),
                                    table.untouched[g].tolist())
        # monitor: every pool-backed VM is checked once at arrival + 60s;
        # spilled + predicted-sensitive ones migrate
        with rec.span("policy.monitor"):
            pool_pos = pool > 0
            spilled = fully | (pool > table.untouched * mem + 1e-9)
            prev = cp.mitigation.migrated
            not_prev = (~np.isin(table.vm_id,
                                 np.fromiter(prev, np.int64, len(prev)))
                        if prev else np.ones(n, bool))
            mitigate = pool_pos & spilled & not_prev \
                & (p >= cp.monitor.threshold)
            cp.monitor.checks += int(pool_pos.sum())
        with rec.span("policy.mitigate"):
            mi = np.flatnonzero(mitigate)
            t_mig[mi] = table.arrival[mi] + _MONITOR_DELAY
            for i in mi:
                cp.mitigation.migrate(int(table.vm_id[i]), float(pool[i]),
                                      float(t_mig[i]))
            n_mitig = len(mi)
    else:
        raise ValueError(policy)
    spill = pool > table.untouched * mem + 1e-9
    mispred = _sequential_mispred(fully, spill,
                                  qos.exceeds_pdm(slows, pdm),
                                  spill_harm_prob, n)
    return PolicyDecisions(local, pool, fully, t_mig, mispred, n_mitig)


# -------------------------------------------------------------- grid axis --
@dataclasses.dataclass
class PolicySetting:
    """One point of the (tau, pdm, li-threshold) policy grid.

    ``tau`` selects the untouched-memory quantile model (one fitted
    ``UntouchedMemoryModel`` per tau, see :func:`fit_um_grid`);
    ``li_threshold`` is the sensitivity-probability cut (derive one from
    an FP-rate budget with :func:`thresholds_for_fp`, the paper's FP
    knob); ``pdm`` is the slowdown margin the misprediction accounting
    charges against.
    """
    tau: float
    pdm: float = 0.05
    li_threshold: float = 0.05
    fp_target: float | None = None      # provenance when derived from FP

    @property
    def label(self) -> str:
        fp = "" if self.fp_target is None else f",fp={self.fp_target:g}"
        return (f"tau={self.tau:g},pdm={self.pdm:g},"
                f"li={self.li_threshold:g}{fp}")


def make_grid(taus=(0.05,), pdms=(0.05,), li_thresholds=(0.05,),
              fp_targets=None, li_model=None, pmu=None, slowdowns=None
              ) -> list[PolicySetting]:
    """Cartesian grid of :class:`PolicySetting`.

    With ``fp_targets`` given (instead of raw thresholds), each target
    resolves to the largest-LI threshold within the FP budget via
    ``li_model.threshold_for_fp`` on the supplied calibration set.
    """
    if fp_targets is not None:
        if li_model is None or pmu is None or slowdowns is None:
            raise ValueError("fp_targets need li_model + pmu + slowdowns "
                             "to calibrate thresholds")
        th = thresholds_for_fp(li_model, pmu, slowdowns, fp_targets)
        axis = list(zip(th, fp_targets))
    else:
        axis = [(float(t), None) for t in li_thresholds]
    return [PolicySetting(float(tau), float(pdm), float(th), fp)
            for tau, pdm, (th, fp)
            in itertools.product(taus, pdms, axis)]


def thresholds_for_fp(li_model, pmu: np.ndarray, slowdowns: np.ndarray,
                      fp_targets) -> list[float]:
    """Probability thresholds realizing each FP-rate budget (Fig 17's
    knob): the largest-LI operating point with FP <= target."""
    return [float(li_model.threshold_for_fp(pmu, slowdowns, fp).threshold)
            for fp in fp_targets]


def fit_um_grid(meta_features: np.ndarray, untouched: np.ndarray, taus,
                seed: int = 0) -> dict:
    """One fitted ``UntouchedMemoryModel`` per unique tau."""
    from repro_torch.core.predictors.models import UntouchedMemoryModel
    return {float(tau): UntouchedMemoryModel(float(tau)).fit(
        meta_features, untouched, seed=seed) for tau in set(taus)}


def grid_decisions(vms_list, settings, li_model, um_models: dict,
                   history: dict | None, min_history_vms: int = 3,
                   latency: int = 182, spill_harm_prob: float = 0.25,
                   backend: str = "numpy", device=None) -> list:
    """Price a whole policy grid against a trace batch in one pass.

    Returns ``out[s][k]`` — the :class:`PolicyDecisions` of setting
    ``settings[s]`` on trace ``vms_list[k]`` — with the shared work
    hoisted out of the grid: history percentiles and UM features are
    computed once per trace, the forest probabilities once over ALL
    traces' VMs, and the tau axis priced either as one numpy ensemble walk
    per unique tau (``backend="numpy"``, bit-exact vs a fresh
    ``ControlPlane`` configured with the same setting) or as ONE torch
    pass over the stacked tau models on ``device`` (``backend="torch"``,
    or ``"auto"``; the card when ``device`` is None; float32, so a
    prediction can differ from numpy's in its last bits and, rarely, a
    floored pool GB with it).  With a single unique tau there is nothing
    to stack, and every backend takes the numpy walk on the host, as the
    reference's jax backend does: the card is not used and the decisions
    are the numpy ones.  Nothing shared is mutated: each grid point
    sees the same seeded ``history``, like pricing each setting on a fresh
    control plane.

    Usage (3 taus x 2 thresholds against 4 seeds, one call)::

        settings = make_grid(taus=(0.05, 0.1, 0.2), pdms=(0.05,),
                             li_thresholds=(0.05, 0.5))
        grid = grid_decisions(vms_list, settings, li, um_models, hist)
        flat_dec = [grid[s][k] for s in range(len(settings))
                    for k in range(len(vms_list))]
    """
    if backend not in ("auto", "torch", "numpy"):
        raise ValueError(f"backend {backend!r} is not auto, torch or numpy")
    if not vms_list:
        return [[] for _ in settings]
    tables = [traces.vm_table(v) for v in vms_list]
    sizes = [len(t) for t in tables]
    splits = np.cumsum(sizes)[:-1]
    # per-trace history percentiles (each trace starts from the seed)
    per_trace = [_prefix_percentiles(t.customer, t.untouched, history)
                 for t in tables]
    n_hist = np.concatenate([nh for nh, _ in per_trace])
    feats = np.concatenate(
        [metadata_features_compiled(t, pc)
         for t, (_, pc) in zip(tables, per_trace)])
    pmu = np.concatenate([t.pmu for t in tables])
    if li_model is not None:
        p = np.asarray(li_model.p_sensitive_batch(pmu))
    else:
        p = np.ones(len(pmu))

    # tau axis: one prediction vector per unique tau over ALL VMs
    uniq_taus = sorted({s.tau for s in settings})
    if backend != "numpy" and len(uniq_taus) > 1:
        from repro_torch.core.predictors import gbm as G
        packed = G.pack_gbms([um_models[t].gbm for t in uniq_taus])
        raw = G.predict_gbms_torch(packed, feats, device).cpu().numpy()
        um_by_tau = {t: np.clip(raw[i], 0.0, 1.0).astype(np.float64)
                     for i, t in enumerate(uniq_taus)}
    else:
        um_by_tau = {t: um_models[t].predict(feats).astype(np.float64)
                     for t in uniq_taus}

    mem = np.concatenate([t.mem_gb for t in tables])
    untouched = np.concatenate([t.untouched for t in tables])
    arrival = np.concatenate([t.arrival for t in tables])
    slows = np.concatenate([(t.slow182 if latency == 182 else t.slow222)
                            for t in tables])
    has_hist_base = (n_hist >= min_history_vms) & (li_model is not None)

    out = []
    for s in settings:
        um = um_by_tau[s.tau]
        fully = has_hist_base & (p < s.li_threshold)
        pool = np.floor(um * mem)
        local = mem - pool
        pool[fully] = mem[fully]
        local[fully] = 0.0
        spill = pool > untouched * mem + 1e-9
        spilled = fully | spill
        mitigate = (pool > 0) & spilled & (p >= s.li_threshold)
        t_mig = np.where(mitigate, arrival + _MONITOR_DELAY, np.nan)
        harm = qos.exceeds_pdm(slows, s.pdm)
        row = []
        lo = 0
        for k, hi in enumerate([*splits, len(mem)]):
            sl = slice(lo, hi)
            mispred = _sequential_mispred(
                fully[sl], spill[sl], harm[sl], spill_harm_prob,
                sizes[k])
            row.append(PolicyDecisions(
                local[sl].copy(), pool[sl].copy(), fully[sl].copy(),
                t_mig[sl].copy(), mispred,
                int(np.isfinite(t_mig[sl]).sum())))
            lo = hi
        out.append(row)
    return out
