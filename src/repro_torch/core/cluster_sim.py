"""Cluster pooling simulator: Pond's provisioning loop (§6.5; Figs 3, 21).

``savings_analysis`` finds the least uniform (server_gb, pool_gb) that
schedules a trace with at most ``reject_tol`` more rejections than the
cores alone cause, for a memory policy — all-local (the baseline) or a
static x % pool for every VM — and reports the DRAM it saves against the
all-local baseline.  Required DRAM = servers x per-server local DRAM +
pool groups x per-group pool DRAM.  Pool groups span ``pool_sockets``
sockets (2 sockets per server).

The searches run on ``replay_engine.CompiledReplay``: the trace is
compiled once per decision set and uploaded to the device, the
server-size searches replicate the scalar bisection bit for bit while
pricing whole dyadic probe trees per sweep (one launch of kernel K1 a
sweep), and the 7 per-server-size pool searches run as one lockstep
bracketing search.  ``replay_reject_rate`` is the port's own copy of the
scalar per-event oracle the engine is held to.

Not ported yet (ROADMAP): the scalar-oracle search (``use_engine=False``,
M3), the streaming engines past a shard budget (M5), the tier-hierarchy
pricing (M11) and the ``pond`` policy's control-plane walk (M8; its
decisions can be passed in as ``decisions=``).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core import policy_engine, replay_engine


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
    by the compiled pipeline (``policy_engine.policy_decisions_compiled``).
    Returns ``(decisions, mispredictions)``: a ``VMDecision`` list, or the
    struct-of-arrays ``PolicyDecisions`` with ``as_arrays=True``.  The
    reference's scalar walk (``engine="scalar"``) is the equivalence
    reference there and is not ported."""
    if engine != "auto":
        raise NotImplementedError("the scalar policy walk is the "
                                  "reference's; the port has the compiled "
                                  "pipeline only")
    dec = policy_engine.policy_decisions_compiled(
        vms, policy, control_plane, static_pool_frac, latency, pdm,
        spill_harm_prob)
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

    ``decisions``: precomputed ``policy_engine.PolicyDecisions`` (the way
    the ``pond`` policy's decisions are carried in until ROADMAP M8);
    skips the policy walk and prices the given split directly
    (``policy`` is then just the result label; misprediction/mitigation
    counts come from the object).

    Usage::

        cache = {}
        local = savings_analysis(vms, cfg, "local", cache=cache)
        static = savings_analysis(vms, cfg, "static", cache=cache,
                                  static_pool_frac=0.30)
        print(static.savings)
    """
    if not use_engine:
        raise NotImplementedError("the scalar-oracle search is the "
                                  "reference's (ROADMAP M3)")
    if tier_hierarchy is not None:
        raise NotImplementedError("tier-hierarchy pricing comes with the "
                                  "latency engine (ROADMAP M11)")
    if decisions is not None:
        dec_in, mispred = decisions, decisions.mispredictions
        mitig = decisions.n_mitigations
    else:
        dec_in, mispred = policy_decisions(
            vms, policy, control_plane, static_pool_frac, latency, pdm,
            spill_harm_prob, as_arrays=True)
        mitig = 0
    hi_server = cfg.cores_per_server * 12.0
    big_pool = hi_server * cfg.n_servers
    n_pts = 7

    def _compile(vms_, dec_):
        # 2 events per VM + 1 per QoS migration
        n_events = 2 * len(vms_) + (
            dec_.n_migrations if hasattr(dec_, "n_migrations")
            else sum(1 for d in dec_ if d.t_migrate is not None))
        if max_events_per_shard is not None and \
                n_events > max_events_per_shard:
            raise NotImplementedError(
                f"{n_events} events exceed max_events_per_shard="
                f"{max_events_per_shard}: streaming engines come with "
                "ROADMAP M5")
        return replay_engine.CompiledReplay(vms_, dec_, cfg, device=device)

    eng = _compile(vms, dec_in)
    # cores-bound reject floor: memory tolerance is measured on top of it
    r0 = float(eng.reject_rates(hi_server, big_pool)[0])
    tol = r0 + reject_tol
    cap = int(math.floor(tol * len(vms)))   # early-exit reject budget

    if policy == "local":                   # decisions ARE all-local
        base_gb = replay_engine.search_min_batched(
            lambda g: eng.reject_rates(g, 0.0, cap) <= tol,
            0.0, hi_server)
        if cache is not None:
            cache["local_engine"] = eng
            cache[("base_gb", tol)] = base_gb
        return PolicyResult(policy, base_gb, 0.0, base_gb, cfg.n_servers,
                            cfg.n_groups, mispred, 0, r0)
    min_server = replay_engine.search_min_batched(
        lambda g: eng.reject_rates(g, big_pool, cap) <= tol,
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
            lambda g: eng_local.reject_rates(g, 0.0, cap) <= tol,
            0.0, hi_server)
        if cache is not None:
            cache[("base_gb", tol)] = base_gb
    # joint provisioning: pool bursts overflow to local (fallback), so the
    # optimum is NOT the (min server, then min pool) corner — sweep server
    # sizes and pick the least total DRAM (one lockstep bracketing search)
    server_grid = np.linspace(min_server, base_gb, n_pts)
    pool_grid = replay_engine.pool_search_batched(
        eng, server_grid, big_pool, tol, reject_cap=cap)
    totals = cfg.n_servers * server_grid + cfg.n_groups * pool_grid
    rates = eng.reject_rates(server_grid, pool_grid)
    b = int(np.argmin(totals))
    return PolicyResult(policy, float(server_grid[b]), float(pool_grid[b]),
                        base_gb, cfg.n_servers, cfg.n_groups, mispred,
                        mitig, float(rates[b]))
