"""Cluster pooling simulator: Pond's provisioning loop (§6.5; Figs 3, 21).

``savings_analysis`` finds the least uniform (server_gb, pool_gb) that
schedules a trace with at most ``reject_tol`` more rejections than the
cores alone cause, for a memory policy — all-local (the baseline), a
static x % pool for every VM, or Pond's own (``pond``: the predictors and
the control plane decide each VM's split, the QoS monitor migrates
mispredicted VMs) — and reports the DRAM it saves against the all-local
baseline.  ``savings_analysis_batched`` does the same for a batch of
traces in lockstep (Fig 21's seed batches), one sweep a round for all of
them; ``summarize_savings`` gives a batch's mean ± spread.  Required
DRAM = servers x per-server local DRAM + pool groups x per-group pool
DRAM.  Pool groups span ``pool_sockets`` sockets (2 sockets per server).
``tiered_pricing`` prices a decision set's QoS on a local/CXL/far tier
hierarchy (``savings_analysis(tier_hierarchy=...)`` attaches it).

The searches run on ``replay_engine.CompiledReplay``: the trace is
compiled once per decision set and uploaded to the device, the
server-size searches replicate the scalar bisection bit for bit while
pricing whole dyadic probe trees per sweep (one launch of kernel K1 a
sweep), and the 7 per-server-size pool searches run as one lockstep
bracketing search.  The batched entry point prices every trace of a
batch in one launch of K1's trace axis a round
(``replay_engine.CompiledReplayBatch``).  ``replay_reject_rate`` is the
port's own copy of the scalar per-event oracle the engine is held to.

Not ported yet (ROADMAP): the scalar-oracle search (``use_engine=False``,
M3b) and the streaming engines past a shard budget (M5).
"""
from __future__ import annotations

import dataclasses
import math
import time

import numpy as np

from repro_torch.core import (latency_engine, latency_model, policy_engine,
                              replay_engine)


@dataclasses.dataclass
class ClusterConfig:
    n_servers: int = 32
    cores_per_server: int = 64          # 2 sockets
    gb_per_core: float = 6.0            # provisioned DRAM/core (stranding)
    pool_sockets: int = 16              # sockets per pool group
    min_vm_cores: int = 2

    @property
    def servers_per_group(self) -> int:
        return max(1, self.pool_sockets // 2)

    @property
    def n_groups(self) -> int:
        return math.ceil(self.n_servers / self.servers_per_group)


def arrivals_for_util(cfg: ClusterConfig, target_util: float,
                      horizon_s: float, mean_cores: float = 9.3,
                      mean_life_s: float = 1.9e4) -> int:
    """VM count that drives the cluster to ~target core utilization."""
    total_cores = cfg.n_servers * cfg.cores_per_server
    return int(target_util * total_cores * horizon_s
               / (mean_cores * mean_life_s))


# -------------------------------------------------------------- savings ----
@dataclasses.dataclass
class PolicyResult:
    """Provisioning found by feasibility search: servers ship UNIFORM
    DRAM; the scheduler is memory-aware (a VM that does not fit on its
    best-fit server is moved to another); required DRAM is the least
    uniform (server_gb, pool_gb) that schedules the trace with <=
    reject_tol rejections."""
    name: str
    server_gb: float           # uniform per-server local DRAM
    pool_group_gb: float       # pool DRAM per group
    baseline_server_gb: float
    n_servers: int
    n_groups: int
    mispredictions: float
    mitigations: int
    reject_rate: float
    # attached by savings_analysis(tier_hierarchy=...): QoS price of the
    # pool split on a 3-tier hierarchy (list[TierPricing], one per
    # far_frac grid point); None when priced on the flat 2-tier model
    tier_pricing: "list[TierPricing] | None" = None

    @property
    def total_gb(self) -> float:
        return self.n_servers * self.server_gb + \
            self.n_groups * self.pool_group_gb

    @property
    def baseline_gb(self) -> float:
        return self.n_servers * self.baseline_server_gb

    @property
    def savings(self) -> float:
        return 1.0 - self.total_gb / self.baseline_gb


@dataclasses.dataclass
class TierPricing:
    """QoS price of one pool split on a tier hierarchy (one grid row)."""
    far_frac: float            # share of each VM's pool GB on the far tier
    cache_hit_rate: float
    mean_slowdown: float       # mean slowdown factor across pooled VMs
    max_slowdown: float
    violation_frac: float      # fraction of VMs with slowdown-1 >= pdm


def tiered_pricing(decisions, hierarchy=None, far_fracs=(0.0, 0.25, 0.5),
                   pdm: float = 0.05, backend: str = "auto",
                   device=None) -> list:
    """Price a decision set's QoS on a parameterized tier hierarchy.

    Each VM's pool share (``pool_gb / mem_gb`` — the traffic fraction
    under the uniform-touch model) splits between the CXL pool and the
    far tier by ``far_frac``; one ``latency_engine`` grid pass (on
    ``device`` with the torch backend, the card by default) returns the
    slowdown factors and the inclusive PDM-violation fraction per config.
    The split leaves the DRAM totals (and ``PolicyResult.savings``)
    unchanged: the hierarchy prices *where* the pool GB live and what that
    costs in slowdown.

    ``decisions``: ``policy_engine.PolicyDecisions`` (or anything with
    ``local_gb``/``pool_gb`` arrays).  ``hierarchy``: a 3-tier
    ``latency_model.TierHierarchy`` (default ``three_tier()``).
    """
    hierarchy = hierarchy if hierarchy is not None \
        else latency_model.TierHierarchy.three_tier()
    if hierarchy.n_pool_tiers != 2:
        raise ValueError("tiered_pricing prices local/CXL/far hierarchies")
    mem = np.asarray(decisions.local_gb) + np.asarray(decisions.pool_gb)
    traffic = np.where(mem > 0,
                       np.asarray(decisions.pool_gb)
                       / np.where(mem > 0, mem, 1.0), 0.0)
    ratios, hits = latency_engine.hierarchy_params([hierarchy])
    far_fracs = np.atleast_1d(np.asarray(far_fracs, float))
    # (F, N, 2) traffic splits -> one grid pass -> (F, N, 1) slowdowns
    fracs = np.stack([np.stack([traffic * (1.0 - f), traffic * f], -1)
                      for f in far_fracs])
    slow = latency_engine.hierarchy_slowdown_grid(
        fracs, ratios, hits, backend=backend, device=device)[..., 0]
    viol = latency_engine.pdm_violation_grid(
        slow - 1.0, [pdm], backend=backend, device=device)[..., 0]
    return [TierPricing(float(f), hierarchy.cache_hit_rate,
                        float(slow[fi].mean()), float(slow[fi].max()),
                        float(viol[fi]))
            for fi, f in enumerate(far_fracs)]


@dataclasses.dataclass
class VMDecision:
    local_gb: float
    pool_gb: float
    fully_pooled: bool
    t_migrate: float | None    # QoS mitigation moves pool->local at this t


def _all_local_decisions(vms) -> policy_engine.PolicyDecisions:
    """Baseline all-local decision arrays (no per-VM objects)."""
    n = len(vms)
    mem = np.fromiter((vm.mem_gb for vm in vms), float, n)
    return policy_engine.PolicyDecisions(
        mem, np.zeros(n), np.zeros(n, bool), np.full(n, np.nan))


def policy_decisions(vms, policy: str, control_plane=None,
                     static_pool_frac: float = 0.15,
                     latency: int = 182, pdm: float = 0.05,
                     spill_harm_prob: float = 0.25,
                     engine: str = "auto", as_arrays: bool = False):
    """Per-VM memory split + misprediction accounting (placement-free),
    by the compiled pipeline (``policy_engine.policy_decisions_compiled``)
    for ``local``, ``static`` and ``pond`` (which needs ``control_plane``
    and advances its state).  Returns ``(decisions, mispredictions)``: a
    ``VMDecision`` list, or the struct-of-arrays ``PolicyDecisions`` with
    ``as_arrays=True``.  The reference's scalar walk (``engine="scalar"``)
    is the equivalence reference there and is not ported."""
    if engine != "auto":
        raise NotImplementedError("the scalar policy walk is the "
                                  "reference's; the port has the compiled "
                                  "pipeline only")
    t0 = time.perf_counter()
    dec = policy_engine.policy_decisions_compiled(
        vms, policy, control_plane, static_pool_frac, latency, pdm,
        spill_harm_prob)
    replay_engine.add_decisions_time(time.perf_counter() - t0)
    return (dec if as_arrays else dec.as_vmdecisions()), dec.mispredictions


def replay_reject_rate(vms, decisions, cfg: ClusterConfig,
                       server_gb: float, pool_gb: float) -> float:
    """The scalar oracle.  Memory-aware replay: best fit by cores among
    servers whose free local memory fits; pool checked per group; when
    the pool is short the VM starts all-local.  Returns the reject
    fraction."""
    events = []
    for vm, dec in zip(vms, decisions):
        events.append((vm.arrival, 0, vm, dec))
        if dec.t_migrate is not None:
            events.append((dec.t_migrate, 2, vm, dec))
        events.append((vm.departure, 1, vm, dec))
    events.sort(key=lambda e: (e[0], e[1]))
    free_cores = np.full(cfg.n_servers, float(cfg.cores_per_server))
    free_mem = np.full(cfg.n_servers, float(server_gb))
    free_pool = np.full(cfg.n_groups, float(pool_gb))
    group_of = np.arange(cfg.n_servers) // cfg.servers_per_group
    placed: dict[int, int] = {}
    migrated: set[int] = set()
    rejects = 0
    for t, kind, vm, dec in events:
        if kind == 1:                                  # departure
            s = placed.pop(vm.vm_id, None)
            if s is None:
                continue
            free_cores[s] += vm.cores
            if vm.vm_id in migrated:
                free_mem[s] += vm.mem_gb
                migrated.discard(vm.vm_id)
            else:
                free_mem[s] += dec.local_gb
                free_pool[group_of[s]] += dec.pool_gb
            continue
        if kind == 2:                                  # QoS migration
            s = placed.get(vm.vm_id)
            if s is None:
                continue
            if free_mem[s] >= dec.pool_gb:             # host has local room
                free_mem[s] -= dec.pool_gb
                free_pool[group_of[s]] += dec.pool_gb
                migrated.add(vm.vm_id)
            continue
        ok = (free_cores >= vm.cores) & (free_mem >= dec.local_gb) & \
            (free_pool[group_of] >= dec.pool_gb)
        cand = np.flatnonzero(ok)
        if len(cand):
            s = int(cand[np.argmin(free_cores[cand])])
            free_cores[s] -= vm.cores
            free_mem[s] -= dec.local_gb
            free_pool[group_of[s]] -= dec.pool_gb
            placed[vm.vm_id] = s
            continue
        # pool short -> control-plane fallback: start the VM all-local
        # (§4.3: VM starts never block on the pool)
        ok = (free_cores >= vm.cores) & (free_mem >= vm.mem_gb)
        cand = np.flatnonzero(ok)
        if len(cand):
            s = int(cand[np.argmin(free_cores[cand])])
            free_cores[s] -= vm.cores
            free_mem[s] -= vm.mem_gb
            placed[vm.vm_id] = s
            migrated.add(vm.vm_id)       # departs as all-local
            continue
        rejects += 1
    return rejects / max(len(vms), 1)


@dataclasses.dataclass
class FailureReplayResult:
    """Scalar-oracle availability outcome for one candidate point."""

    n_vms: int
    rejects: int
    n_failures: int
    affected_per_failure: list      # VMs affected, one entry per FAIL
    killed: int
    remigrated: int
    lost_vm_minutes: int

    @property
    def reject_rate(self) -> float:
        return self.rejects / max(self.n_vms, 1)

    @property
    def affected(self) -> int:
        return int(sum(self.affected_per_failure))

    @property
    def remigration_success_rate(self) -> float:
        return self.remigrated / self.affected if self.affected else 1.0


def replay_with_failures(vms, decisions, cfg: ClusterConfig,
                         server_gb: float, pool_gb: float,
                         schedule, mitigation: str = "remigrate"
                         ) -> FailureReplayResult:
    """Scalar blast-radius oracle: :func:`replay_reject_rate` plus the
    Pond §4.2 failure model over a ``runtime.fault.FailureSchedule``.

    The semantics the failure sweep (kernel K5, ``kernels/fail_sweep``)
    reproduces bit for bit on integral-GB traces:

    * FAIL/RECOVER events merge into the replay's event order sorted by
      (time, kind) — failures sort AFTER same-time VM events.
    * While a domain (EMC group) is down, arrivals that need pool slices
      there skip its servers in the pooled admission test (the all-local
      fallback still applies, §4.3).
    * ``FAIL(d)`` affects every live VM holding pool slices in domain
      ``d``.  ``mitigation="kill"`` terminates them;
      ``mitigation="remigrate"`` moves each server's affected pool into
      host-local DRAM iff the server's free local memory covers its TOTAL
      affected demand (all-or-nothing per server, demand snapshot taken
      before any mutation), killing the rest.  A remigrated VM thereafter
      departs as all-local (same bookkeeping as a QoS migration).  The
      domain's slices are lost either way: its pool comes back EMPTY
      (free capacity resets to ``pool_gb``).
    * VM-minutes lost counts ``floor(departure/60) - floor(t_fail/60)``
      per killed VM.
    """
    if mitigation not in ("remigrate", "kill"):
        raise ValueError(f"unknown mitigation {mitigation!r}")
    events = []
    for vm, dec in zip(vms, decisions):
        events.append((vm.arrival, 0, vm, dec))
        if dec.t_migrate is not None:
            events.append((dec.t_migrate, 2, vm, dec))
        events.append((vm.departure, 1, vm, dec))
    for t, d, rec in zip(schedule.times, schedule.domains,
                         schedule.recovers):
        events.append((float(t), 5 if rec else 4, int(d), None))
    events.sort(key=lambda e: (e[0], e[1]))
    free_cores = np.full(cfg.n_servers, float(cfg.cores_per_server))
    free_mem = np.full(cfg.n_servers, float(server_gb))
    free_pool = np.full(cfg.n_groups, float(pool_gb))
    dom_down = np.zeros(cfg.n_groups, bool)
    group_of = np.arange(cfg.n_servers) // cfg.servers_per_group
    placed: dict[int, int] = {}
    live: dict[int, tuple] = {}          # vm_id -> (vm, dec)
    migrated: set[int] = set()
    rejects = killed = remigrated = lost_min = 0
    affected_per_failure: list[int] = []
    for t, kind, vm, dec in events:
        if kind == 4:                                # FAIL(domain)
            d = vm
            fail_min = math.floor(t / 60.0)
            affected = [(vid, s) for vid, s in placed.items()
                        if vid not in migrated
                        and live[vid][1].pool_gb > 0
                        and group_of[s] == d]
            demand = np.zeros(cfg.n_servers)
            for vid, s in affected:
                demand[s] += live[vid][1].pool_gb
            fits = free_mem >= demand                # pre-event snapshot
            for vid, s in affected:
                avm, adec = live[vid]
                if mitigation == "remigrate" and fits[s]:
                    free_mem[s] -= adec.pool_gb
                    migrated.add(vid)
                    remigrated += 1
                else:
                    free_cores[s] += avm.cores
                    free_mem[s] += adec.local_gb
                    placed.pop(vid)
                    live.pop(vid)
                    killed += 1
                    lost_min += max(
                        math.floor(avm.departure / 60.0) - fail_min, 0)
            free_pool[d] = pool_gb                   # slices lost; pool
            dom_down[d] = True                       # returns EMPTY
            affected_per_failure.append(len(affected))
            continue
        if kind == 5:                                # RECOVER(domain)
            dom_down[vm] = False
            continue
        if kind == 1:                                # departure
            s = placed.pop(vm.vm_id, None)
            live.pop(vm.vm_id, None)
            if s is None:
                continue
            free_cores[s] += vm.cores
            if vm.vm_id in migrated:
                free_mem[s] += vm.mem_gb
                migrated.discard(vm.vm_id)
            else:
                free_mem[s] += dec.local_gb
                free_pool[group_of[s]] += dec.pool_gb
            continue
        if kind == 2:                                # QoS migration
            s = placed.get(vm.vm_id)
            if s is None:
                continue
            if free_mem[s] >= dec.pool_gb:           # host has local room
                free_mem[s] -= dec.pool_gb
                free_pool[group_of[s]] += dec.pool_gb
                migrated.add(vm.vm_id)
            continue
        ok = (free_cores >= vm.cores) & (free_mem >= dec.local_gb) & \
            (free_pool[group_of] >= dec.pool_gb)
        if dec.pool_gb > 0:
            ok &= ~dom_down[group_of]
        cand = np.flatnonzero(ok)
        if len(cand):
            s = int(cand[np.argmin(free_cores[cand])])
            free_cores[s] -= vm.cores
            free_mem[s] -= dec.local_gb
            free_pool[group_of[s]] -= dec.pool_gb
            placed[vm.vm_id] = s
            live[vm.vm_id] = (vm, dec)
            continue
        ok = (free_cores >= vm.cores) & (free_mem >= vm.mem_gb)
        cand = np.flatnonzero(ok)
        if len(cand):
            s = int(cand[np.argmin(free_cores[cand])])
            free_cores[s] -= vm.cores
            free_mem[s] -= vm.mem_gb
            placed[vm.vm_id] = s
            live[vm.vm_id] = (vm, dec)
            migrated.add(vm.vm_id)       # departs as all-local
            continue
        rejects += 1
    return FailureReplayResult(
        n_vms=len(vms), rejects=rejects,
        n_failures=int(np.count_nonzero(~schedule.recovers)),
        affected_per_failure=affected_per_failure, killed=killed,
        remigrated=remigrated, lost_vm_minutes=lost_min)


def _n_events(vms, dec) -> int:
    """Compiled event count: 2 per VM + 1 per QoS migration."""
    return 2 * len(vms) + (
        dec.n_migrations if hasattr(dec, "n_migrations")
        else sum(1 for d in dec if d.t_migrate is not None))


def _refuse_past_shard_budget(vms, dec, max_events_per_shard) -> None:
    n_events = _n_events(vms, dec)
    if max_events_per_shard is not None and \
            n_events > max_events_per_shard:
        raise NotImplementedError(
            f"{n_events} events exceed max_events_per_shard="
            f"{max_events_per_shard}: streaming engines come with "
            "ROADMAP M5")


def _search_min(f, lo: float, hi: float, tol_frac: float = 0.02) -> float:
    """Least x in [lo, hi] with f(x) True (f monotone)."""
    if not f(hi):
        return hi
    while (hi - lo) > tol_frac * max(hi, 1.0):
        mid = 0.5 * (lo + hi)
        if f(mid):
            hi = mid
        else:
            lo = mid
    return hi


def savings_analysis(vms, cfg: ClusterConfig, policy: str,
                     control_plane=None,
                     static_pool_frac: float = 0.15,
                     latency: int = 182, pdm: float = 0.05,
                     spill_harm_prob: float = 0.25,
                     reject_tol: float = 0.005,
                     use_engine: bool = True,
                     cache: dict | None = None,
                     max_events_per_shard: int | None = None,
                     decisions: "policy_engine.PolicyDecisions | None"
                     = None,
                     tier_hierarchy=None,
                     far_fracs=(0.0, 0.25, 0.5),
                     device=None) -> PolicyResult:
    """Minimum uniform (server_gb, pool_gb) that schedules the trace.

    The server-size searches replicate the scalar bisection bit for bit
    while pricing whole dyadic probe trees per sweep, and the 7
    per-server-size pool searches run as one lockstep bracketing search
    with neighbour warm starts, bracketed for free by each size's
    infinite-pool trajectory.  Every sweep is one K1 launch on ``device``
    (default: the CUDA card; ``"cpu"`` runs its plain version).

    ``cache``: optional dict shared across calls on the SAME trace and
    server shape (callers pricing several policies over one trace).  It
    memoizes the all-local engine and the baseline provisioning search,
    which do not depend on the policy.

    ``control_plane``: the ``pond`` policy's ``ControlPlane`` (its models,
    pool manager and history; the decisions advance its state).

    ``decisions``: precomputed ``policy_engine.PolicyDecisions``; skips
    the policy walk and prices the given split directly (``policy`` is
    then just the result label; misprediction/mitigation counts come from
    the object).

    ``tier_hierarchy``: a 3-tier ``latency_model.TierHierarchy``; the
    result's ``tier_pricing`` is then :func:`tiered_pricing` of the priced
    decisions over ``far_fracs`` (on ``device``); DRAM totals and savings
    are unchanged.

    Usage::

        cache = {}
        local = savings_analysis(vms, cfg, "local", cache=cache)
        static = savings_analysis(vms, cfg, "static", cache=cache,
                                  static_pool_frac=0.30)
        print(static.savings)
    """
    if not use_engine:
        raise NotImplementedError("the scalar-oracle search is the "
                                  "reference's (ROADMAP M3b)")
    if decisions is not None:
        dec_in, mispred = decisions, decisions.mispredictions
        mitig = decisions.n_mitigations
    else:
        dec_in, mispred = policy_decisions(
            vms, policy, control_plane, static_pool_frac, latency, pdm,
            spill_harm_prob, as_arrays=True)
        mitig = len(control_plane.mitigation.log) if control_plane else 0
    hi_server = cfg.cores_per_server * 12.0
    big_pool = hi_server * cfg.n_servers
    n_pts = 7

    def _finish(res: PolicyResult) -> PolicyResult:
        # price the pool split's QoS on the 3-tier hierarchy over the
        # far_fracs grid, one latency_engine pass
        if tier_hierarchy is not None:
            res.tier_pricing = tiered_pricing(dec_in, tier_hierarchy,
                                              far_fracs, pdm, device=device)
        return res

    def _compile(vms_, dec_):
        _refuse_past_shard_budget(vms_, dec_, max_events_per_shard)
        return replay_engine.CompiledReplay(vms_, dec_, cfg, device=device)

    eng = _compile(vms, dec_in)
    # cores-bound reject floor: memory tolerance is measured on top of it
    r0 = float(eng.reject_rates(hi_server, big_pool)[0])
    tol = r0 + reject_tol

    if policy == "local":                   # decisions ARE all-local
        base_gb = replay_engine.search_min_batched(
            lambda g: eng.reject_rates(g, 0.0) <= tol,
            0.0, hi_server)
        if cache is not None:
            cache["local_engine"] = eng
            cache[("base_gb", tol)] = base_gb
        return _finish(PolicyResult(policy, base_gb, 0.0, base_gb,
                                    cfg.n_servers, cfg.n_groups, mispred, 0,
                                    r0))
    min_server = replay_engine.search_min_batched(
        lambda g: eng.reject_rates(g, big_pool) <= tol,
        0.0, hi_server)
    # the all-local baseline ignores the pool entirely: share its engine
    # and search result across policies of one trace
    if cache is not None and "local_engine" in cache:
        eng_local = cache["local_engine"]
    else:
        eng_local = _compile(vms, _all_local_decisions(vms))
        if cache is not None:
            cache["local_engine"] = eng_local
    base_gb = cache.get(("base_gb", tol)) if cache is not None else None
    if base_gb is None:
        base_gb = replay_engine.search_min_batched(
            lambda g: eng_local.reject_rates(g, 0.0) <= tol,
            0.0, hi_server)
        if cache is not None:
            cache[("base_gb", tol)] = base_gb
    # joint provisioning: pool bursts overflow to local (fallback), so the
    # optimum is NOT the (min server, then min pool) corner — sweep server
    # sizes and pick the least total DRAM (one lockstep bracketing search)
    server_grid = np.linspace(min_server, base_gb, n_pts)
    pool_grid = replay_engine.pool_search_batched(
        eng, server_grid, big_pool, tol)
    totals = cfg.n_servers * server_grid + cfg.n_groups * pool_grid
    rates = eng.reject_rates(server_grid, pool_grid)
    b = int(np.argmin(totals))
    return _finish(PolicyResult(policy, float(server_grid[b]),
                                float(pool_grid[b]), base_gb, cfg.n_servers,
                                cfg.n_groups, mispred, mitig,
                                float(rates[b])))


def savings_analysis_batched(vms_list, cfg: ClusterConfig, policy: str,
                             control_planes=None,
                             static_pool_frac: float = 0.15,
                             latency: int = 182, pdm: float = 0.05,
                             spill_harm_prob: float = 0.25,
                             reject_tol: float = 0.005,
                             cache: dict | None = None,
                             max_events_per_shard: int | None = None,
                             decisions=None,
                             device=None) -> list[PolicyResult]:
    """``savings_analysis`` for K traces at once — one sweep instead of K.

    Pond's headline savings (§4, Figs 3/21) are statistical claims over
    many workload mixes.  This prices a whole batch of traces in lockstep
    on a ``replay_engine.CompiledReplayBatch``: every search round is ONE
    launch of K1 covering all K traces' probes, and the pool frontier
    search needs no per-trace trajectory replays (it brackets with each
    trace's ``peak_pool_demand``).  Returns one :class:`PolicyResult` per
    trace, equal to the reference's (summarise with
    :func:`summarize_savings`); every sweep runs on ``device`` (default:
    the CUDA card; ``"cpu"`` runs K1's plain version).

    ``control_planes``: one (fresh) ControlPlane per trace for the
    ``pond`` policy — decisions mutate per-customer history, so traces
    must not share one.  ``cache``: share the all-local baseline batch
    across policies of the SAME trace list (like ``savings_analysis``).
    ``decisions``: precomputed per-trace ``policy_engine.PolicyDecisions``
    aligned with ``vms_list``; ``policy`` is then just the result label.
    ``max_events_per_shard``: a trace past the budget raises (the
    streaming batch is ROADMAP M5).

    Usage (Fig 21's rows over three seeds)::

        cache = {}
        static = savings_analysis_batched(vms_list, cfg, "static",
                                          cache=cache)
        pond = savings_analysis_batched(
            vms_list, cfg, "pond", cache=cache,
            control_planes=[make_plane() for _ in vms_list])
        print(summarize_savings(static), summarize_savings(pond))
    """
    k = len(vms_list)
    if not k:
        return []
    cps = list(control_planes) if control_planes is not None \
        else [None] * k
    if decisions is not None and len(decisions) != k:
        raise ValueError(f"decisions must align with the {k} traces")
    if decisions is not None:
        dec_list = list(decisions)
        mispred = [d.mispredictions for d in dec_list]
        mitig = [d.n_mitigations for d in dec_list]
    else:
        per = [policy_decisions(vms, policy, cp, static_pool_frac,
                                latency, pdm, spill_harm_prob,
                                as_arrays=True)
               for vms, cp in zip(vms_list, cps)]
        dec_list = [d for d, _ in per]
        mispred = [m for _, m in per]
        mitig = [len(cp.mitigation.log) if cp else 0 for cp in cps]
    hi_server = cfg.cores_per_server * 12.0
    big_pool = hi_server * cfg.n_servers
    hi_vec = np.full(k, hi_server)

    def _compile_engine(vms_, dec_):
        _refuse_past_shard_budget(vms_, dec_, max_events_per_shard)
        return replay_engine.CompiledReplay(vms_, dec_, cfg, device=device)

    batch = replay_engine.CompiledReplayBatch(
        [_compile_engine(v, d) for v, d in zip(vms_list, dec_list)])
    # cores-bound reject floor per trace; tolerance is on top of it
    r0 = batch.reject_rates(hi_server, big_pool)[:, 0]
    tol = r0 + reject_tol

    def results(server_gb, pool_gb, base_gb, rates):
        return [PolicyResult(policy, float(server_gb[i]),
                             float(pool_gb[i]), float(base_gb[i]),
                             cfg.n_servers, cfg.n_groups, mispred[i],
                             mitig[i], float(rates[i]))
                for i in range(k)]

    if policy == "local":
        base_gb = replay_engine.search_min_multi(
            lambda g: batch.reject_rates(g, np.zeros_like(g))
            <= tol[:, None], np.zeros(k), hi_vec)
        if cache is not None:
            cache["local_batch"] = batch
            cache[("base_gb_multi", tuple(tol))] = base_gb
        return results(base_gb, np.zeros(k), base_gb, r0)

    min_server = replay_engine.search_min_multi(
        lambda g: batch.reject_rates(g, np.full_like(g, big_pool))
        <= tol[:, None], np.zeros(k), hi_vec)
    # the all-local baseline ignores the pool: share its batch + search
    # across policies of one trace list, and compile each UNIQUE trace
    # once (decision grids repeat traces across rows)
    if cache is not None and "local_batch" in cache:
        local_batch = cache["local_batch"]
    else:
        uniq_local: dict = {}
        engines = []
        for vms in vms_list:
            e = uniq_local.get(id(vms))
            if e is None:
                e = _compile_engine(vms, _all_local_decisions(vms))
                uniq_local[id(vms)] = e
            engines.append(e)
        local_batch = replay_engine.CompiledReplayBatch(engines)
        if cache is not None:
            cache["local_batch"] = local_batch
    base_gb = cache.get(("base_gb_multi", tuple(tol))) \
        if cache is not None else None
    if base_gb is None:
        base_gb = replay_engine.search_min_multi(
            lambda g: local_batch.reject_rates(g, np.zeros_like(g))
            <= tol[:, None], np.zeros(k), hi_vec)
        if cache is not None:
            cache[("base_gb_multi", tuple(tol))] = base_gb
    # joint provisioning sweep, one lockstep bracketing search for all
    # (trace, server-size) points (see savings_analysis for why the
    # optimum is not the (min server, min pool) corner)
    n_pts = 7
    server_grids = np.linspace(min_server, base_gb, n_pts, axis=1)
    pool_grids = replay_engine.pool_search_multi(
        batch, server_grids, big_pool, tol)
    totals = cfg.n_servers * server_grids + cfg.n_groups * pool_grids
    b = totals.argmin(axis=1)
    rows = np.arange(k)
    sgb = server_grids[rows, b]
    pgb = pool_grids[rows, b]
    rates = batch.reject_rates(sgb[:, None], pgb[:, None])[:, 0]
    return results(sgb, pgb, base_gb, rates)


def summarize_savings(results) -> dict:
    """Mean ± spread of a seed batch's PolicyResults (Fig 3/21 rows)."""
    sv = np.array([r.savings for r in results])
    return {"n_seeds": len(results),
            "savings_mean": float(sv.mean()),
            "savings_std": float(sv.std()),
            "savings_min": float(sv.min()),
            "savings_max": float(sv.max()),
            "server_gb_mean": float(np.mean([r.server_gb
                                             for r in results])),
            "pool_group_gb_mean": float(np.mean([r.pool_group_gb
                                                 for r in results])),
            "reject_rate_mean": float(np.mean([r.reject_rate
                                               for r in results])),
            "mispred_mean": float(np.mean([r.mispredictions
                                           for r in results]))}
