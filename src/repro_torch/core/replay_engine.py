"""Event-compiled trace replay on the device (Pond Figs 3 & 21 hot path).

The feasibility searches behind ``savings_analysis`` ask the same question
hundreds of times: "does the trace schedule with <= tol rejections at
uniform (server_gb, pool_gb)?".  ``CompiledReplay`` compiles a ``(vms,
decisions)`` pair ONCE into flat event arrays (time, kind, vm index),
sorted stably by ``(time, kind)`` exactly like the scalar oracle
(``cluster_sim.replay_reject_rate``), uploads them to the device once, and
prices a whole batch of candidates with one launch of the event sweep
(kernel K1, ``kernels/event_sweep``): one candidate per lane, every event
in order.  Because every VM memory quantity is an integral GB, admission
tests like ``free_mem >= local_gb`` are exactly ``used_mem + local_gb <=
floor(server_gb)`` over integers, so the sweep matches the float64 oracle
bit for bit; the state packs to int16 when the capacities permit.

``search_min_batched`` replicates the scalar bisection bit for bit by
pricing whole dyadic probe trees per sweep; ``pool_search_batched`` runs
all server-size points' pool searches in lockstep, bracketed by each
size's infinite-pool trajectory (a Python replay on the host, as in the
reference) and warm-started from its neighbours.

``CompiledReplayBatch`` prices K traces side by side: their event streams
lie one after another in one set of device arrays and one launch of K1
(its trace axis) sweeps every (trace, candidate) lane.
``search_min_multi`` and ``pool_search_multi`` are the lockstep searches
over such a batch (the pool search bracketed by each trace's
``peak_pool_demand``, no trajectories).

Not ported yet (ROADMAP): the numpy divergence-window backend (M1b) and
with it non-integral decisions, failure schedules (M10), streaming engines
(M5), ``devices=`` (M13), fleets (M9) and the ``obs`` spans (M12).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import sweep_core
from repro_torch.device import resolve_device
from repro_torch.kernels.event_sweep import kernel as K1
from repro_torch.kernels.event_sweep.ops import pack_traces, trace_starts

ARRIVE, DEPART, MIGRATE = (sweep_core.ARRIVE, sweep_core.DEPART,
                           sweep_core.MIGRATE)
SNAP = 64             # snapshot stride (events) in trajectories
_INF = np.inf


# ----------------------------------------------------- decision ingest -----
def _decision_arrays(decisions, n: int):
    """``(local_gb, pool_gb, t_migrate)`` float64 arrays from either a
    ``VMDecision`` sequence or a struct-of-arrays object
    (``policy_engine.PolicyDecisions``).  ``t_migrate`` uses NaN for
    "none"."""
    if hasattr(decisions, "local_gb") \
            and not isinstance(decisions, (list, tuple)):
        local = np.asarray(decisions.local_gb, float)
        pool = np.asarray(decisions.pool_gb, float)
        t_mig = np.asarray(decisions.t_migrate, float)
        if not (len(local) == len(pool) == len(t_mig) == n):
            raise ValueError(
                f"decision arrays must align with the {n} VMs; got "
                f"lengths {(len(local), len(pool), len(t_mig))}")
        return local, pool, t_mig
    if len(decisions) != n:
        raise ValueError("decisions must align with vms")
    local = np.fromiter((float(d.local_gb) for d in decisions), float, n)
    pool = np.fromiter((float(d.pool_gb) for d in decisions), float, n)
    t_mig = np.fromiter(
        (np.nan if d.t_migrate is None else float(d.t_migrate)
         for d in decisions), float, n)
    return local, pool, t_mig


# ------------------------------------------------------------ statistics ---
@dataclasses.dataclass
class EngineStats:
    """Aggregate replay throughput across all engines since last reset."""
    sweeps: int = 0
    events: int = 0               # compiled trace length per sweep
    candidate_events: int = 0     # events x batch width (work done)
    wall_s: float = 0.0

    @property
    def events_per_sec(self) -> float:
        return self.candidate_events / self.wall_s if self.wall_s else 0.0

    def as_dict(self) -> dict:
        return {"sweeps": self.sweeps, "events": self.events,
                "candidate_events": self.candidate_events,
                "wall_s": round(self.wall_s, 4),
                "events_per_sec": round(self.events_per_sec, 1)}


@dataclasses.dataclass
class StageTimes:
    """Host seconds by stage since the last reset, and the lanes and state
    type of every sweep: what the provisioning loop spends where (the
    reference's ``obs`` spans are ROADMAP M12)."""
    decisions_s: float = 0.0      # cluster_sim.policy_decisions
    compile_s: float = 0.0        # CompiledReplay construction + upload
    trajectory_s: float = 0.0     # Python reference trajectories
    sweep_s: float = 0.0          # reject_rates: K1 launch + read-back
    sweeps: list = dataclasses.field(default_factory=list)  # (lanes, dt)


_STATS = EngineStats()
_TIMES = StageTimes()


def stats_reset() -> None:
    global _STATS, _TIMES
    _STATS = EngineStats()
    _TIMES = StageTimes()


def stats_snapshot() -> dict:
    return _STATS.as_dict()


def add_decisions_time(seconds: float) -> None:
    """Charge host seconds of a policy walk to :class:`StageTimes`."""
    _TIMES.decisions_s += seconds


def stage_times() -> StageTimes:
    """A copy of the stage times since the last reset."""
    return dataclasses.replace(_TIMES, sweeps=list(_TIMES.sweeps))


# --------------------------------------------------------------- compile ---
def compiled_arrive_depart(vms):
    """Arrival/departure events as sorted arrays ``(time, kind, vm_index)``.

    Build order and the stable ``(time, kind)`` sort replicate the scalar
    tuple-list construction, so downstream replays see the same sequence.
    """
    n = len(vms)
    times = np.empty(2 * n)
    times[0::2] = np.fromiter((vm.arrival for vm in vms), float, n)
    times[1::2] = np.fromiter((vm.departure for vm in vms), float, n)
    kinds = np.tile(np.array([ARRIVE, DEPART], np.int64), n)
    vmidx = np.repeat(np.arange(n, dtype=np.int64), 2)
    order = np.lexsort((kinds, times))          # stable, like list.sort
    return times[order], kinds[order], vmidx[order]


@dataclasses.dataclass
class _Trajectory:
    """One reference replay of the compiled trace.

    ``server_gb is None``: cores-only replay (memory/pool unbounded) —
    ``need_srv[e]``/``need_pool[e]`` are the least server/pool capacity
    keeping event ``e`` admissible on this path.  ``server_gb`` set: the
    oracle replay at (server_gb, infinite pool) — only ``need_pool`` is
    meaningful; candidates must share this exact server_gb.  Snapshots
    record state BEFORE events 0, SNAP, 2*SNAP, ...
    """
    server_gb: float | None
    need_srv: np.ndarray          # (E,)
    need_pool: np.ndarray         # (E,)
    total_rejects: int
    snap_rejects: np.ndarray      # (n_snap,) rejects before snapshot event
    snap_cores: np.ndarray        # (n_snap, S) free cores
    snap_mem: np.ndarray          # (n_snap, S) local GB in use
    snap_pool: np.ndarray         # (n_snap, G) pool GB in use
    srv: np.ndarray               # (V,) placement (-1 rejected/never)
    arr_idx: np.ndarray           # (V,) arrival event index
    dep_idx: np.ndarray           # (V,) departure event index
    mig: np.ndarray               # (V,) departs-as-all-local flag
    mig_idx: np.ndarray           # (V,) event index the flag was set


class CompiledReplay:
    """One ``(vms, decisions)`` pair compiled for batched replay sweeps on
    ``device`` (default: the CUDA card; ``"cpu"`` runs the sweep's plain
    version on the CPU)."""

    def __init__(self, vms, decisions, cfg, failure_schedule=None,
                 device=None):
        if failure_schedule is not None:
            raise NotImplementedError("failure schedules come with the "
                                      "failure layer (ROADMAP M10)")
        t0 = time.perf_counter()
        self.device = resolve_device(device)
        self.cfg = cfg
        self._vms = vms
        self._decisions_src = decisions
        self.n_vms = n = len(vms)
        self.n_servers = n_srv = cfg.n_servers
        self.n_groups = cfg.n_groups
        self.group_of = np.arange(n_srv) // cfg.servers_per_group
        self.cores_per_server = float(cfg.cores_per_server)

        cores_a = np.fromiter((vm.cores for vm in vms), float, n)
        mem_a = np.fromiter((vm.mem_gb for vm in vms), float, n)
        local_a, pool_a, t_mig = _decision_arrays(decisions, n)
        self._cores = cores_a.tolist()
        self._mem = mem_a.tolist()
        self._local = local_a.tolist()
        self._pool = pool_a.tolist()
        self._exact = bool(
            (cores_a == np.floor(cores_a)).all()
            and (mem_a == np.floor(mem_a)).all()
            and (local_a == np.floor(local_a)).all()
            and (pool_a == np.floor(pool_a)).all())
        # per-VM payload maxima: the int16 state-packing overflow check
        # bounds every admission intermediate by capacity + payload
        self._pay_mem_max = float(max(mem_a.max(initial=0.0),
                                      local_a.max(initial=0.0)))
        self._pay_pool_max = float(pool_a.max(initial=0.0))

        # events in the oracle's insertion order: per VM —
        # (arrival, ARRIVE), (t_migrate, MIGRATE)?, (departure, DEPART) —
        # then one stable lexsort by (time, kind).  MIGRATE events outside
        # [arrival, departure) are guaranteed no-ops in the scalar oracle
        # (the VM is not placed) and are dropped here: the sweep
        # addresses VMs by reusable slot, so a stale MIGRATE after
        # departure would otherwise hit whichever VM reused the slot.
        times = np.empty(3 * n)
        times[0::3] = np.fromiter((vm.arrival for vm in vms), float, n)
        t_mig = t_mig.copy()
        t_mig[(t_mig < times[0::3])
              | (t_mig >= np.fromiter((vm.departure for vm in vms),
                                      float, n))] = np.nan
        times[1::3] = t_mig
        mig_keep = ~np.isnan(t_mig)
        self._has_migrate = bool(mig_keep.any())
        # worst-case used-pool deficit of the oracle's fallback-migrate
        # quirk: bounds the negative side of the int16 pool state
        self._mig_pool_sum = float(pool_a[mig_keep].sum())
        dep_a = np.fromiter((vm.departure for vm in vms), float, n)
        times[2::3] = dep_a
        kinds = np.tile(np.array([ARRIVE, MIGRATE, DEPART], np.int64), n)
        vmidx = np.repeat(np.arange(n, dtype=np.int64), 3)
        keep = ~np.isnan(times)
        times, kinds, vmidx = times[keep], kinds[keep], vmidx[keep]
        order = np.lexsort((kinds, times))
        self.ev_time = times[order]
        self._ev_kind = kinds[order].tolist()
        self._ev_vm = vmidx[order].tolist()
        self.n_events = len(self._ev_kind)
        self._trajs: dict[float | None, _Trajectory] = {}
        self._dev_ev = None
        self._peak_pool = None
        _TIMES.compile_s += time.perf_counter() - t0

    def peak_pool_demand(self) -> float:
        """Cheap upper bound on the pool any candidate can ever need: the
        peak of the prefix sum of +pool_gb at arrival / -pool_gb at
        departure over the compiled event order."""
        if self._peak_pool is None:
            kind = np.asarray(self._ev_kind)
            p = np.asarray(self._pool)[np.asarray(self._ev_vm)]
            delta = np.where(kind == ARRIVE, p,
                             np.where(kind == DEPART, -p, 0.0))
            self._peak_pool = float(np.cumsum(delta).max(initial=0.0))
        return self._peak_pool

    # --------------------------------------------------- device compile --
    def _host_events(self):
        """``(events, n_slots)``: the slot-mapped int32 event arrays
        ``(kind, slot, cores, local, pool, mem)`` as host numpy.  VMs are
        assigned reusable slots (freed on departure), so the per-candidate
        placement state is sized by PEAK CONCURRENCY."""
        ev_slot, n_slots = sweep_core.assign_slots(
            self._ev_kind, self._ev_vm, self.n_vms)
        vmx = np.asarray(self._ev_vm, np.int64)
        host = (np.asarray(self._ev_kind, np.int32),
                ev_slot.astype(np.int32),
                np.asarray(self._cores, np.int32)[vmx],
                np.asarray(self._local, np.int32)[vmx],
                np.asarray(self._pool, np.int32)[vmx],
                np.asarray(self._mem, np.int32)[vmx])
        return host, n_slots

    def _device_events(self):
        """``(events, group_of, n_slots)``: :meth:`_host_events` and
        ``group_of`` on the engine's device, uploaded once and cached.
        Nothing is padded: K1 takes the true event, server, group and slot
        counts."""
        if self._dev_ev is not None:
            return self._dev_ev
        t0 = time.perf_counter()
        host, n_slots = self._host_events()
        evs = tuple(torch.from_numpy(a).to(self.device) for a in host)
        group = torch.from_numpy(self.group_of.astype(np.int32)).to(
            self.device)
        self._dev_ev = (evs, group, n_slots)
        _TIMES.compile_s += time.perf_counter() - t0
        return self._dev_ev

    def _pick_state_dtype(self, sgb_i: np.ndarray,
                          pgb_i: np.ndarray) -> str:
        """``"int16"`` when every sweep intermediate provably fits int16
        (``sweep_core.pick_state_dtype`` fed this engine's cluster shape,
        payload maxima and compiled migrate-event pool total)."""
        return sweep_core.pick_state_dtype(
            self.cores_per_server, self.n_servers, sgb_i, pgb_i,
            self._pay_mem_max, self._pay_pool_max, self._mig_pool_sum)

    def _reject_rates_device(self, server_gb, pool_gb,
                             state_dtype: str | None = None) -> np.ndarray:
        """One K1 launch over the whole batch, every candidate a lane.

        The state packs to int16 when the capacities permit and falls back
        to int32 otherwise; ``state_dtype`` forces one packing (testing
        hook)."""
        evs, group_of, n_slots = self._device_events()
        n0 = len(server_gb)
        sgb_i, pgb_i = sweep_core.quantize_capacities(server_gb, pool_gb)
        dt_name = state_dtype or self._pick_state_dtype(sgb_i, pgb_i)
        np_dt = sweep_core.state_np_dtype(dt_name)
        sweep = sweep_core.get_sweep(dt_name)
        state = sweep_core.init_state(
            n0, self.n_servers, self.cores_per_server, self.n_servers,
            self.n_groups, n_slots, np_dt)[:4]
        fc, um, up, slots = (torch.from_numpy(a).to(self.device)
                             for a in state)
        sgb, pgb = (torch.from_numpy(a.astype(np_dt)).to(self.device)
                    for a in (sgb_i, pgb_i))
        rejects = sweep(evs, group_of, fc, um, up, slots, sgb, pgb)
        _TIMES.sweeps.append((n0, dt_name))
        return rejects.cpu().numpy().astype(np.int64) / max(self.n_vms, 1)

    # --------------------------------------------- reference trajectories --
    def _trajectory(self, server_gb: float | None) -> _Trajectory:
        """Replay once at (server_gb or infinity, infinite pool), recording
        admission thresholds + strided state snapshots (lean Python loop;
        cached, so each trajectory is built one time per engine)."""
        key = None if server_gb is None else float(server_gb)
        cached = self._trajs.get(key)
        if cached is not None:
            return cached
        t0 = time.perf_counter()
        bound = key is not None
        n_srv, n_vms, n_ev = self.n_servers, self.n_vms, self.n_events
        group_of = self.group_of.tolist()
        cores_of, mem_of = self._cores, self._mem
        local_of, pool_of = self._local, self._pool
        ev_kind, ev_vm = self._ev_kind, self._ev_vm

        fc = [self.cores_per_server] * n_srv
        um = [0.0] * n_srv
        up = [0.0] * self.n_groups
        n_snap = n_ev // SNAP + 1
        need_srv = np.zeros(n_ev)
        need_pool = np.zeros(n_ev)
        snap_rejects = np.zeros(n_snap, np.int64)
        snap_cores = np.empty((n_snap, n_srv))
        snap_mem = np.empty((n_snap, n_srv))
        snap_pool = np.empty((n_snap, self.n_groups))
        srv = np.full(n_vms, -1, np.int64)
        arr_idx = np.full(n_vms, n_ev, np.int64)
        dep_idx = np.full(n_vms, n_ev, np.int64)
        mig = np.zeros(n_vms, bool)
        mig_idx = np.full(n_vms, n_ev, np.int64)
        live = [False] * n_vms
        rejects = 0

        for e in range(n_ev):
            if e % SNAP == 0:
                i = e // SNAP
                snap_cores[i] = fc
                snap_mem[i] = um
                snap_pool[i] = up
                snap_rejects[i] = rejects
            v = ev_vm[e]
            kind = ev_kind[e]
            if kind == ARRIVE:
                arr_idx[v] = e
                c, l = cores_of[v], local_of[v]
                best, bv = -1, _INF
                if bound:
                    sgb = key
                    for s in range(n_srv):      # best fit, first min
                        f = fc[s]
                        if f >= c and sgb - um[s] >= l and f < bv:
                            best, bv = s, f
                else:
                    for s in range(n_srv):
                        f = fc[s]
                        if f >= c and f < bv:
                            best, bv = s, f
                if best >= 0:
                    g = group_of[best]
                    p = pool_of[v]
                    fc[best] -= c
                    um[best] += l
                    up[g] += p
                    srv[v] = best
                    live[v] = True
                    need_srv[e] = um[best]
                    need_pool[e] = up[g]
                    continue
                if bound:
                    # pool can't help here (it is infinite on this path):
                    # the oracle's all-local fallback
                    m = mem_of[v]
                    for s in range(n_srv):
                        f = fc[s]
                        if f >= c and sgb - um[s] >= m and f < bv:
                            best, bv = s, f
                    if best >= 0:
                        fc[best] -= c
                        um[best] += m
                        srv[v] = best
                        live[v] = True
                        mig[v] = True           # departs as all-local
                        mig_idx[v] = e
                        need_srv[e] = um[best]
                        continue
                rejects += 1                    # binds for every candidate
            elif kind == DEPART:
                dep_idx[v] = e
                if not live[v]:
                    continue
                live[v] = False
                s = int(srv[v])
                fc[s] += cores_of[v]
                if mig[v]:
                    um[s] -= mem_of[v]          # pool already returned
                else:
                    um[s] -= local_of[v]
                    up[group_of[s]] -= pool_of[v]
            elif kind == MIGRATE:               # MIGRATE: pool -> local if
                if not live[v] or mig[v]:       # the host has local room
                    if live[v] and mig[v]:
                        # oracle quirk: a fallback-placed VM can still be
                        # "migrated" — it moves pool_gb mem->pool
                        s = int(srv[v])
                        p = pool_of[v]
                        if not bound or key - um[s] >= p:
                            um[s] += p
                            up[group_of[s]] -= p
                            need_srv[e] = um[s]
                    continue
                s = int(srv[v])
                p = pool_of[v]
                if not bound or key - um[s] >= p:
                    um[s] += p
                    up[group_of[s]] -= p
                    mig[v] = True
                    mig_idx[v] = e
                    need_srv[e] = um[s]
        traj = _Trajectory(key, need_srv, need_pool, rejects, snap_rejects,
                           snap_cores, snap_mem, snap_pool, srv, arr_idx,
                           dep_idx, mig, mig_idx)
        self._trajs[key] = traj
        _TIMES.trajectory_s += time.perf_counter() - t0
        return traj

    # ------------------------------------------------------------- sweep --
    def reject_rates(self, server_gb, pool_gb,
                     reject_cap: int | None = None,
                     state_dtype: str | None = None) -> np.ndarray:
        """Reject fraction for each (server_gb, pool_gb) candidate.

        Accepts scalars or broadcastable 1-D arrays; one event sweep (one
        K1 launch) prices the whole batch.  The state packs to int16 when
        the candidate capacities (plus payload headroom) permit and falls
        back to int32 automatically; ``state_dtype`` ("int16"/"int32")
        forces one packing for tests.  ``reject_cap`` is accepted and
        ignored: the sweep always returns exact rates, which satisfy the
        searches' feasibility contract.  Non-integral decisions raise
        (their backend, the numpy divergence-window sweep, is ROADMAP M1b).

        Usage (price a 9-point frontier in one sweep)::

            eng = CompiledReplay(vms, decisions, cfg)
            rates = eng.reject_rates(np.linspace(200., 400., 9),
                                     np.linspace(0., 800., 9))
        """
        server_gb = np.atleast_1d(np.asarray(server_gb, float))
        pool_gb = np.atleast_1d(np.asarray(pool_gb, float))
        server_gb, pool_gb = np.broadcast_arrays(server_gb, pool_gb)
        n0 = len(server_gb)
        if not self.n_events:
            return np.zeros(n0)
        if not self._exact:
            raise NotImplementedError(
                "non-integral decisions need the numpy divergence-window "
                "backend, which is not ported yet (ROADMAP M1b)")
        self._device_events()       # compile + upload: its own stage
        t0 = time.perf_counter()
        rates = self._reject_rates_device(server_gb, pool_gb,
                                          state_dtype=state_dtype)
        _STATS.sweeps += 1
        _STATS.events += self.n_events
        _STATS.candidate_events += self.n_events * n0
        _STATS.wall_s += time.perf_counter() - t0
        _TIMES.sweep_s += time.perf_counter() - t0
        return rates


# ----------------------------------------------------------- trace batch ---
def _validate_cluster_shape(engines, what: str):
    """One batch requires one cluster shape (the batched sweep shares the
    group map and the state's extents across rows) and one device."""
    if not engines:
        raise ValueError(f"{what} needs >= 1 engine")
    e0 = engines[0]
    shape = (e0.n_servers, e0.n_groups, e0.cores_per_server)
    for e in engines[1:]:
        if (e.n_servers, e.n_groups, e.cores_per_server) != shape:
            raise ValueError(
                "all traces in a batch must share one cluster shape; "
                f"got {(e.n_servers, e.n_groups, e.cores_per_server)} "
                f"vs {shape}")
        if e.device != e0.device:
            raise ValueError(f"all traces in a batch must lie on one "
                             f"device; got {e.device} vs {e0.device}")


def _batch_pick_state_dtype(engines, sgb_i: np.ndarray,
                            pgb_i: np.ndarray) -> str:
    """int16 only when EVERY trace row packs safely: one launch shares one
    state dtype across the batch, so any row that needs int32 (payload
    headroom, migrate-pool deficit) forces the whole batch to int32.
    Bit-exactness is unaffected either way — int16 is only ever picked
    where it is provably equivalent."""
    if all(e._pick_state_dtype(sgb_i[i], pgb_i[i]) == "int16"
           for i, e in enumerate(engines)):
        return "int16"
    return "int32"


def _broadcast_candidates(k: int, server_gb, pool_gb):
    """Normalise candidates to float ``(K, n_cand)`` arrays: 1-D inputs
    are shared across traces, 2-D inputs give per-trace grids (the shape
    the lockstep searches need)."""
    s = np.atleast_1d(np.asarray(server_gb, float))
    p = np.atleast_1d(np.asarray(pool_gb, float))
    s, p = np.broadcast_arrays(s, p)
    if s.ndim == 1:
        s = np.broadcast_to(s, (k,) + s.shape)
        p = np.broadcast_to(p, (k,) + p.shape)
    if s.ndim != 2 or s.shape[0] != k:
        raise ValueError(
            f"candidates must be 1-D (shared) or ({k}, n_cand) "
            f"per-trace; got shape {s.shape}")
    return np.ascontiguousarray(s), np.ascontiguousarray(p)


class CompiledReplayBatch:
    """K compiled traces priced side by side, one K1 launch a sweep.

    The slot-mapped event streams of K :class:`CompiledReplay` engines
    (one cluster shape, one device) lie one after another in one set of
    device arrays, each from a multiple of 4 events
    (``ops.trace_starts``), uploaded once; one launch of K1's trace axis
    sweeps every (trace, candidate) lane, each trace's lanes over its own
    events (no padding to the longest trace).  Candidate capacities may be
    shared across traces (1-D) or per trace (``(K, n_cand)``, the shape
    lockstep searches need).

    Bit-exactness contract: row ``k`` of :meth:`reject_rates` equals
    ``engines[k].reject_rates(...)`` bit for bit — each lane's integer
    replay is independent of its neighbours.

    Usage::

        engines = [CompiledReplay(vms_k, dec_k, cfg) for ...]
        batch = CompiledReplayBatch(engines)
        rates = batch.reject_rates([200., 300.], [100., 100.])  # (K, 2)
    """

    def __init__(self, engines):
        _validate_cluster_shape(engines, "CompiledReplayBatch")
        e0 = engines[0]
        self.engines = list(engines)
        self.k = len(engines)
        self.device = e0.device
        self.n_servers = e0.n_servers
        self.n_groups = e0.n_groups
        self.cores_per_server = e0.cores_per_server
        self.n_vms = np.array([e.n_vms for e in engines], np.int64)
        self.n_events = np.array([e.n_events for e in engines], np.int64)
        self._exact = all(e._exact for e in engines)
        self._dev_ev = None

    def _device_events(self):
        """``(events, group_of, n_slots, trace_events)``: every trace's
        slot-mapped event arrays one after another (PAD events fill the
        gaps up to each multiple of 4), ``group_of``, the largest trace's
        slot count and the traces' event counts; uploaded once."""
        if self._dev_ev is not None:
            return self._dev_ev
        t0 = time.perf_counter()
        per = [e._host_events() for e in self.engines]
        cols, counts = pack_traces([host for host, _ in per], self.device)
        group = torch.from_numpy(
            self.engines[0].group_of.astype(np.int32)).to(self.device)
        self._dev_ev = (cols, group, max(n for _, n in per), counts)
        _TIMES.compile_s += time.perf_counter() - t0
        return self._dev_ev

    def _pick_state_dtype(self, sgb_i: np.ndarray,
                          pgb_i: np.ndarray) -> str:
        return _batch_pick_state_dtype(self.engines, sgb_i, pgb_i)

    def reject_rates(self, server_gb, pool_gb,
                     reject_cap: int | None = None,
                     state_dtype: str | None = None,
                     devices=None) -> np.ndarray:
        """Reject fraction per (trace, candidate): shape ``(K, n_cand)``.

        ``server_gb``/``pool_gb`` broadcast like the single-trace API and
        also take ``(K, n_cand)`` per-trace candidate grids.  One launch
        of K1 prices every trace's candidates (one a ``kernel.MAX_TRACES``
        traces); the state packs to int16 when every trace's capacities
        permit, and ``state_dtype`` forces one packing (testing hook).
        ``reject_cap`` is accepted and ignored: the sweep returns exact
        rates.  ``devices`` (a device mesh) is ROADMAP M13; non-integral
        decisions raise as in :class:`CompiledReplay` (M1b).
        """
        if devices is not None:
            raise NotImplementedError("device meshes come with devices= "
                                      "(ROADMAP M13)")
        server_gb, pool_gb = _broadcast_candidates(self.k, server_gb,
                                                   pool_gb)
        n0 = server_gb.shape[1]
        if not self.n_events.any():
            return np.zeros((self.k, n0))
        if not self._exact:
            raise NotImplementedError(
                "non-integral decisions need the numpy divergence-window "
                "backend, which is not ported yet (ROADMAP M1b)")
        # compile + upload (its own stage), then the sweep
        evs, group_of, n_slots, counts = self._device_events()
        t0 = time.perf_counter()
        starts = trace_starts(counts)
        sgb_i, pgb_i = sweep_core.quantize_capacities(server_gb, pool_gb)
        dt_name = state_dtype or self._pick_state_dtype(sgb_i, pgb_i)
        np_dt = sweep_core.state_np_dtype(dt_name)
        sweep = sweep_core.get_sweep(dt_name, batched=True)
        rejects = np.empty((self.k, n0), np.int64)
        for lo in range(0, self.k, K1.MAX_TRACES):
            hi = min(self.k, lo + K1.MAX_TRACES)
            width = (hi - lo) * n0
            state = sweep_core.init_state(
                width, self.n_servers, self.cores_per_server,
                self.n_servers, self.n_groups, n_slots, np_dt)[:4]
            fc, um, up, slots = (torch.from_numpy(a).to(self.device)
                                 for a in state)
            sgb, pgb = (torch.from_numpy(a[lo:hi].reshape(-1).astype(np_dt))
                        .to(self.device) for a in (sgb_i, pgb_i))
            out = sweep(tuple(e[starts[lo]:] for e in evs), group_of, fc,
                        um, up, slots, sgb, pgb, counts[lo:hi])
            rejects[lo:hi] = out.cpu().numpy().reshape(hi - lo, n0)
            _TIMES.sweeps.append((width, dt_name))
        rates = rejects / np.maximum(self.n_vms, 1)[:, None]
        _STATS.sweeps += 1
        _STATS.events += int(self.n_events.max(initial=0))
        _STATS.candidate_events += int(self.n_events.sum()) * n0
        _STATS.wall_s += time.perf_counter() - t0
        _TIMES.sweep_s += time.perf_counter() - t0
        return rates


# ---------------------------------------------------------------- search ---
def _dyadic_nodes(lo: float, hi: float, depth: int, nodes: list) -> None:
    """Append the depth-k tree of bisection midpoints of ``[lo, hi]``,
    computed with the same ``0.5 * (lo + hi)`` float arithmetic the
    scalar search uses (pre-order, so replays walk it bit-for-bit)."""
    m = 0.5 * (lo + hi)
    nodes.append(m)
    if depth > 1:
        _dyadic_nodes(lo, m, depth - 1, nodes)
        _dyadic_nodes(m, hi, depth - 1, nodes)


def search_min_batched(feasible, lo: float, hi: float,
                       tol_frac: float = 0.02, depth: int = 4) -> float:
    """Batched replica of the scalar ``cluster_sim._search_min`` bisection.

    Reject rates near the feasibility boundary are NOT perfectly monotone
    (placement cascades), so a different probe sequence can legitimately
    land on a different feasible point.  To keep results bit-identical to
    the scalar search, each round evaluates the full depth-k tree of
    dyadic bisection midpoints in ONE batched sweep — round 1 also prices
    ``hi`` itself — then walks the k bisection decisions locally.

    Usage (least feasible uniform server DRAM)::

        eng = CompiledReplay(vms, decisions, cfg)
        gb = search_min_batched(
            lambda g: eng.reject_rates(g, big_pool) <= tol, 0.0, 768.0)
    """
    nodes: list[float] = []
    first = True
    while (hi - lo) > tol_frac * max(hi, 1.0) or first:
        nodes.clear()
        _dyadic_nodes(lo, hi, depth, nodes)
        probes = nodes + [hi] if first else list(nodes)
        feas = np.asarray(feasible(np.array(probes)))
        if first:
            if not feas[-1]:
                return hi
            first = False
        fmap = dict(zip(probes, feas.tolist()))
        for _ in range(depth):
            if (hi - lo) <= tol_frac * max(hi, 1.0):
                break
            mid = 0.5 * (lo + hi)
            if fmap[mid]:
                hi = mid
            else:
                lo = mid
    return hi


def pool_search_batched(engine, server_grid: np.ndarray,
                        big_pool: float, tol: float, tol_frac: float = 0.02,
                        width: int = 12,
                        reject_cap: int | None = None) -> np.ndarray:
    """Minimum feasible pool_gb for EVERY server-size point, in lockstep.

    The infinite-pool trajectory at each server size supplies the starting
    bracket for free: its peak pool demand is always feasible, and its
    reject count decides outright whether the point is feasible at any
    pool size.  Each round then evaluates ``width`` interior points for
    every unconverged point in ONE sweep.  The required pool is monotone
    (non-increasing) in server_gb, so every round warm-starts each point's
    bracket from its neighbours.  Points infeasible even at ``big_pool``
    return ``big_pool``.  ``engine`` is a :class:`CompiledReplay` (the
    streaming engine's branch comes with ROADMAP M5).

    Usage (pool frontier over a server-size grid)::

        grid = np.linspace(min_server, base_gb, 7)
        pool = pool_search_batched(eng, grid, big_pool=12288.0, tol=0.01)
    """
    if not isinstance(engine, CompiledReplay):
        raise NotImplementedError("pool searches on a streaming engine "
                                  "come with ROADMAP M5")
    server_grid = np.asarray(server_grid, float)
    n_pts = len(server_grid)
    denom = max(engine.n_vms, 1)
    lo = np.zeros(n_pts)
    hi = np.empty(n_pts)
    infeasible = np.zeros(n_pts, bool)
    for i, sgb in enumerate(server_grid):
        traj = engine._trajectory(float(sgb))
        hi[i] = min(float(big_pool),
                    float(traj.need_pool.max(initial=0.0)))
        infeasible[i] = traj.total_rejects / denom > tol
    fracs = np.arange(1, width + 1) / (width + 1.0)
    while True:
        # neighbour warm start between FEASIBLE points only: an infeasible
        # point's (meaningless) brackets must not clamp its neighbours'
        prop_hi = np.minimum.accumulate(np.where(infeasible, _INF, hi))
        hi = np.where(infeasible, hi, np.minimum(hi, prop_hi))
        prop_lo = np.maximum.accumulate(
            np.where(infeasible, -_INF, lo)[::-1])[::-1]
        lo = np.where(infeasible, lo, np.maximum(lo, prop_lo))
        active = ~infeasible & ((hi - lo) > tol_frac * np.maximum(hi, 1.0))
        if not active.any():
            break
        ai = np.flatnonzero(active)
        grids = lo[ai, None] + (hi - lo)[ai, None] * fracs[None, :]
        r = engine.reject_rates(
            np.repeat(server_grid[ai], width), grids.ravel(),
            reject_cap=reject_cap).reshape(len(ai), width)
        f = r <= tol
        for j, i in enumerate(ai):
            row = f[j]
            if row.any():
                k = int(np.argmax(row))
                if k > 0:
                    lo[i] = grids[j, k - 1]
                hi[i] = grids[j, k]
            else:
                lo[i] = grids[j, -1]
    hi[infeasible] = big_pool
    return hi


# ------------------------------------------------- multi-trace searches ---
def search_min_multi(feasible, lo, hi, tol_frac: float = 0.02,
                     depth: int = 4) -> np.ndarray:
    """K independent ``_search_min`` bisections advanced in lockstep.

    Per-trace replica of :func:`search_min_batched`: each round builds
    every unconverged trace's depth-k dyadic probe tree (round 1 also
    prices each trace's ``hi``) and evaluates ALL trees in one call to
    ``feasible`` — with a :class:`CompiledReplayBatch` behind it, that is
    one K1 launch per round instead of K.  Each trace's probe
    sequence (and thus its result) is bit-identical to running the
    scalar bisection on that trace alone.  Traces infeasible at ``hi``
    return ``hi``.

    ``feasible`` maps a ``(K, n_probes)`` capacity array to ``(K,
    n_probes)`` bools, e.g.::

        base_gb = search_min_multi(
            lambda g: batch.reject_rates(g, 0.0) <= tol[:, None],
            np.zeros(batch.k), np.full(batch.k, 768.0))
    """
    lo = np.array(lo, float)
    hi = np.array(hi, float)
    k = len(lo)
    n_nodes = 2 ** depth - 1
    done = np.zeros(k, bool)
    first = True
    while True:
        active = ~done & ((hi - lo) > tol_frac * np.maximum(hi, 1.0))
        if first:
            active = ~done
        if not active.any():
            break
        nodes = np.empty((k, n_nodes))
        for i in range(k):
            # converged rows re-price their frozen tree (uniform probe
            # width keeps the sweep one rectangular batch); their
            # brackets are no longer updated
            row: list[float] = []
            _dyadic_nodes(float(lo[i]), float(hi[i]), depth, row)
            nodes[i] = row
        probes = np.concatenate([nodes, hi[:, None]], 1) if first else nodes
        feas = np.asarray(feasible(probes))
        if first:
            done |= ~feas[:, -1]          # infeasible even at hi
            first = False
        for i in np.flatnonzero(active & ~done):
            fmap = dict(zip(probes[i].tolist(), feas[i].tolist()))
            for _ in range(depth):
                if (hi[i] - lo[i]) <= tol_frac * max(hi[i], 1.0):
                    break
                mid = 0.5 * (float(lo[i]) + float(hi[i]))
                if fmap[mid]:
                    hi[i] = mid
                else:
                    lo[i] = mid
    return hi


def pool_search_multi(batch, server_grids,
                      big_pool: float, tol, tol_frac: float = 0.02,
                      width: int = 4,
                      reject_cap: int | None = None) -> np.ndarray:
    """Minimum feasible pool_gb per (trace, server-size) point, lockstep.

    Multi-trace analogue of :func:`pool_search_batched`: one bracketing
    search over a ``(K, n_pts)`` server grid, evaluating ``width``
    interior points for every point of every trace in ONE sweep per
    round.  Brackets start at ``[0, peak_pool_demand]`` per trace —
    a vectorized prefix-sum bound that replaces the per-trace trajectory
    replays of the single-trace search — and warm-start from neighbors
    within each trace (required pool is monotone non-increasing in
    server_gb).  Points infeasible even at the upper bracket return
    ``big_pool``.

    ``batch`` is a :class:`CompiledReplayBatch` (the search needs only
    ``reject_rates`` and each engine's ``peak_pool_demand``; the streaming
    batch is ROADMAP M5).  ``reject_cap`` is passed on and ignored: the
    batch returns exact rates, so the probe sequence — and the result —
    is the reference's.
    """
    sg = np.asarray(server_grids, float)
    if sg.ndim != 2 or sg.shape[0] != batch.k:
        raise ValueError(f"server_grids must be (K={batch.k}, n_pts); "
                         f"got {sg.shape}")
    k, n_pts = sg.shape
    tol = np.asarray(tol, float).reshape(k, 1)
    lo = np.zeros((k, n_pts))
    peaks = np.array([min(float(big_pool), e.peak_pool_demand())
                      for e in batch.engines])
    hi = np.broadcast_to(peaks[:, None], (k, n_pts)).copy()
    infeasible = batch.reject_rates(sg, hi, reject_cap=reject_cap) > tol
    fracs = np.arange(1, width + 1) / (width + 1.0)
    while True:
        prop_hi = np.minimum.accumulate(
            np.where(infeasible, _INF, hi), axis=1)
        hi = np.where(infeasible, hi, np.minimum(hi, prop_hi))
        prop_lo = np.maximum.accumulate(
            np.where(infeasible, -_INF, lo)[:, ::-1], axis=1)[:, ::-1]
        lo = np.where(infeasible, lo, np.maximum(lo, prop_lo))
        active = ~infeasible & ((hi - lo) > tol_frac * np.maximum(hi, 1.0))
        if not active.any():
            break
        # converged points re-price their frozen bracket: the sweep needs
        # one rectangular (K, n_pts * width) candidate block per round
        grids = lo[..., None] + (hi - lo)[..., None] * fracs
        r = batch.reject_rates(
            np.repeat(sg, width, axis=1),
            grids.reshape(k, n_pts * width),
            reject_cap=reject_cap).reshape(k, n_pts, width)
        f = r <= tol[:, :, None]
        for i in range(k):
            for j in np.flatnonzero(active[i]):
                row = f[i, j]
                if row.any():
                    q = int(np.argmax(row))
                    if q > 0:
                        lo[i, j] = grids[i, j, q - 1]
                    hi[i, j] = grids[i, j, q]
                else:
                    lo[i, j] = grids[i, j, -1]
    hi[infeasible] = big_pool
    return hi
