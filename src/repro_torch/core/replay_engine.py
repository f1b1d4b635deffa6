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

The failure layer (Pond §4.2): an engine built with a
``runtime.fault.FailureSchedule`` merges its FAIL/RECOVER events into the
stream (no-ops for ``reject_rates``), and ``availability()`` prices the
blast radius with one launch of the failure sweep (kernel K5,
``kernels/fail_sweep``), on one trace or, for a batch, on K1's trace axis.

Fleet topologies (Pond §3 with Octopus-style layouts): ``reject_rates_fleet``
prices ``(server_gb, per-pod pool_gb, topology)`` lanes over
``core/topology.py`` incidence structures with one launch of the pod sweep
(kernel K4, ``kernels/pod_sweep``), on one trace or, for a batch, on K1's
trace axis; its ``"numpy"`` backend (a float64 host sweep, exact for
non-integral decisions too) is the reference's, copied.

Streaming (traces past one event tensor): ``CompiledReplayStream`` cuts
the compiled events into time-windowed shards of at most
``max_events_per_shard`` (the reference's cuts, event for event) and keeps
the state on the device from shard to shard, one K1 (for
``reject_rates_fleet``, K4) launch a shard, shard i + 1 uploading through
pinned host buffers on a side CUDA stream while shard i computes; it skips
leading shards inside the candidates' divergence window, stops early under
``reject_cap`` and checkpoints (``CheckpointSpec``).  Its ``"numpy"``
backend carries float64 host state, exact for non-integral decisions too.
``CompiledReplayStreamBatch`` streams K traces through K1's trace axis.

Non-integral decisions (fractional GB, e.g. a trace file's ``mem_gb``):
the integer sweeps cannot price them, so ``reject_rates(backend="auto")``
takes the numpy divergence-window sweep (the reference's, copied: float64
host state, candidates entering in waves from the Python trajectories'
snapshots) and ``availability`` the scalar blast-radius oracle, as the
reference does.  The choice is made from the decisions alone.

Tracing (``core/obs.py``, the reference's span and counter names): every
public entry point runs in a span (``replay.reject_rates``,
``stream.fleet``, ...); a stream's shard loop times each shard's upload,
its wait and its launch (CUDA events on the card, only while a recorder
is live) and counts skipped shards, early exits and the shard cuts'
padding; the launcher caches count their hits and misses, the host-to-card
copies their bytes.  With tracing off none of it synchronises or
allocates.

``devices=`` (every engine's ``reject_rates`` and ``reject_rates_fleet``,
the reference's semantics, :func:`sweep_core.resolve_devices`): below two
devices it is the single-device path; otherwise the candidate lanes (or,
for a batch with at least as many traces as devices, the trace rows) are
split over the devices, one launch a device, and gathered in order —
``==`` the single-device result, since lanes and traces replay
independently.  A stream's pieces each carry their own state from shard
to shard and take turns a shard at a time (:func:`_run_pieces`), so the
devices sweep side by side.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import os
import time

import numpy as np
import torch

from repro_torch.core import obs, sweep_core
from repro_torch.core import topology as topology_mod
from repro_torch.device import resolve_device
from repro_torch.kernels.event_sweep import kernel as K1
from repro_torch.kernels.event_sweep.ops import pack_traces, trace_starts
from repro_torch.kernels.pod_sweep import ops as pod_ops

ARRIVE, DEPART, MIGRATE = (sweep_core.ARRIVE, sweep_core.DEPART,
                           sweep_core.MIGRATE)
FAIL, RECOVER, PAD = sweep_core.FAIL, sweep_core.RECOVER, sweep_core.PAD
MAX_WAVES = 12        # state-rebuild budget per sweep (numpy backend)
MAX_TRAJS = 16        # per-server-size trajectories per sweep
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
    type of every sweep: what the provisioning loop spends where.  The
    compile and trajectory stages have no span among the reference's
    (``core/obs.py``), so these stay beside the spans."""
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


def _choose_backend(backend: str, exact: bool) -> str:
    """``"torch"`` or ``"numpy"`` for a sweep: ``"auto"`` takes the device
    sweep if and only if the decisions are integral (``exact``), never by
    whether a card is present; the device sweeps refuse non-integral
    decisions."""
    if backend == "auto":
        return "torch" if exact else "numpy"
    if backend == "torch" and not exact:
        raise NotImplementedError(
            "the device sweeps take integral decisions; "
            "backend='numpy' prices non-integral ones")
    if backend not in ("torch", "numpy"):
        raise ValueError(f"backend must be 'auto', 'torch' or 'numpy', "
                         f"got {backend!r}")
    return backend


# --------------------------------------------------------------- compile ---
def _group_columns(group_of: np.ndarray, n_srv: int) -> np.ndarray:
    """``(n_srv, spg_max)`` member servers of each server's pool group,
    padded with the dummy column ``n_srv`` when the last group is short
    (ragged ``n_servers``): the numpy sweeps' per-group pool updates."""
    spg_max = int(np.bincount(group_of).max())
    gcols = np.full((n_srv, spg_max), n_srv, np.int64)
    for s in range(n_srv):
        members = np.flatnonzero(group_of == group_of[s])
        gcols[s, :len(members)] = members
    return gcols


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


@dataclasses.dataclass
class AvailabilityResult:
    """Failure-priced sweep outcome, per candidate (and per trace for the
    batched engine: every array gains a leading K axis).

    ``reject_rate`` includes the failure model (down domains grant no pool
    slices); the counters are totals over the schedule's FAIL events.
    ``affected_per_failure`` is the per-failure distribution ``(n_failures,
    n_cand)``, None when not requested (and for batches).
    """

    reject_rate: np.ndarray
    affected: np.ndarray
    killed: np.ndarray
    remigrated: np.ndarray
    lost_vm_minutes: np.ndarray
    n_failures: "int | np.ndarray"
    affected_per_failure: "np.ndarray | None"
    mitigation: str

    @property
    def remigration_success_rate(self) -> np.ndarray:
        """remigrated / affected, defined as 1.0 where nothing was affected
        (no failure touched a pooled VM)."""
        aff = np.asarray(self.affected, float)
        rem = np.asarray(self.remigrated, float)
        return np.where(aff > 0, rem / np.maximum(aff, 1), 1.0)


#: the per-candidate arrays of an :class:`AvailabilityResult`
AVAILABILITY_FIELDS = ("reject_rate", "affected", "killed", "remigrated",
                       "lost_vm_minutes")


def _counters_result(counts: np.ndarray, n_vms, n_failures, dist,
                     mitigation: str) -> AvailabilityResult:
    """An :class:`AvailabilityResult` from K5's int32 counters ``(5, ...)``
    (rejects, affected, killed, remigrated, lost minutes)."""
    c = counts.astype(np.int64)
    n_vms = np.maximum(n_vms, 1)
    if c.ndim == 3:                       # (5, K, n_cand)
        n_vms = n_vms[:, None]
    return AvailabilityResult(
        reject_rate=c[0] / n_vms, affected=c[1], killed=c[2],
        remigrated=c[3], lost_vm_minutes=c[4], n_failures=n_failures,
        affected_per_failure=dist, mitigation=mitigation)


def _check_mitigation(mitigation: str) -> None:
    if mitigation not in sweep_core.MITIGATIONS:
        raise ValueError(f"mitigation must be one of "
                         f"{sweep_core.MITIGATIONS}")


class CompiledReplay:
    """One ``(vms, decisions)`` pair compiled for batched replay sweeps on
    ``device`` (default: the CUDA card; ``"cpu"`` runs the sweep's plain
    version on the CPU).  With ``failure_schedule`` (a
    ``runtime.fault.FailureSchedule``) its FAIL/RECOVER events join the
    stream, for :meth:`availability`."""

    def __init__(self, vms, decisions, cfg, failure_schedule=None,
                 device=None):
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
        # failure-domain events (Pond §4.2) merge into the same sorted
        # stream: FAIL/RECOVER sort AFTER same-time VM events, carry VM 0
        # and are no-ops in the plain sweep (reject_rates stays happy-path);
        # the failure sweep (availability()) resolves the blast radius
        doms = np.full(len(times), -1, np.int64)
        self.failure_schedule = failure_schedule
        if failure_schedule is not None and len(failure_schedule):
            if failure_schedule.max_domain() >= self.n_groups:
                raise ValueError(
                    f"failure domain {failure_schedule.max_domain()} out "
                    f"of range for {self.n_groups} pool groups")
            fk = np.where(failure_schedule.recovers, RECOVER, FAIL)
            times = np.concatenate([times, failure_schedule.times])
            kinds = np.concatenate([kinds, fk])
            vmidx = np.concatenate(
                [vmidx, np.zeros(len(failure_schedule), np.int64)])
            doms = np.concatenate([doms, failure_schedule.domains])
        order = np.lexsort((kinds, times))
        self.ev_time = times[order]
        self._ev_kind = kinds[order].tolist()
        self._ev_vm = vmidx[order].tolist()
        self._ev_dom = doms[order]
        #: per-VM departure minute (int32): the VM-minutes-lost clock,
        #: quantised exactly like the oracle's
        self._dep_min = np.floor(dep_a / 60.0).astype(np.int32)
        self.n_events = len(self._ev_kind)
        self._trajs: dict[float | None, _Trajectory] = {}
        self._slot_map = None
        self._dev_ev = {}             # device -> uploaded events
        self._dev_ev_fail = None
        self._fleet_ev_np = None
        self._np_pay = None
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
        placement state is sized by PEAK CONCURRENCY.  The assignment (a
        Python loop over the events) runs once an engine."""
        ev_slot, n_slots = self._slots()
        vmx = np.asarray(self._ev_vm, np.int64)
        host = (np.asarray(self._ev_kind, np.int32), ev_slot.astype(np.int32),
                np.asarray(self._cores, np.int32)[vmx],
                np.asarray(self._local, np.int32)[vmx],
                np.asarray(self._pool, np.int32)[vmx],
                np.asarray(self._mem, np.int32)[vmx])
        return host, n_slots

    def _slots(self):
        """``(per-event slot, slot count)``, assigned once an engine."""
        if self._slot_map is None:
            self._slot_map = sweep_core.assign_slots(
                self._ev_kind, self._ev_vm, self.n_vms)
        return self._slot_map

    def _fail_streams(self):
        """The failure sweep's two extra int32 streams as host numpy:
        ``x`` (the VM's departure minute at ARRIVE, the failure minute at
        FAIL: the VM-minutes-lost clock) and ``dmn`` (the domain at
        FAIL/RECOVER, -1 otherwise).  Neither depends on the slots."""
        kind = np.asarray(self._ev_kind, np.int32)
        x = np.zeros(len(kind), np.int32)
        arr, fail = kind == ARRIVE, kind == FAIL
        x[arr] = self._dep_min[np.asarray(self._ev_vm, np.int64)[arr]]
        x[fail] = np.floor(self.ev_time[fail] / 60.0)
        return x, self._ev_dom.astype(np.int32)

    def _device_events(self, device=None):
        """``(events, group_of, n_slots)``: :meth:`_host_events` and
        ``group_of`` on the engine's device (or on ``device``, a piece of a
        split launch), uploaded once a device and cached.  Nothing is
        padded: K1 takes the true event, server, group and slot counts."""
        device = self.device if device is None else device
        if device in self._dev_ev:
            return self._dev_ev[device]
        t0 = time.perf_counter()
        host, n_slots = self._host_events()
        evs = tuple(sweep_core.device_put(a, device) for a in host)
        group = sweep_core.device_put(self.group_of.astype(np.int32),
                                      device)
        self._dev_ev[device] = (evs, group, n_slots)
        _TIMES.compile_s += time.perf_counter() - t0
        return self._dev_ev[device]

    def _device_events_fail(self):
        """``(events, group_of, n_slots)`` for the failure sweep: the six
        arrays of :meth:`_device_events` (shared with it), then ``x`` and
        ``dmn``; uploaded once and cached."""
        if self._dev_ev_fail is not None:
            return self._dev_ev_fail
        evs, group, n_slots = self._device_events()
        t0 = time.perf_counter()
        extra = tuple(sweep_core.device_put(a, self.device)
                      for a in self._fail_streams())
        self._dev_ev_fail = (evs + extra, group, n_slots)
        _TIMES.compile_s += time.perf_counter() - t0
        return self._dev_ev_fail

    def _pick_state_dtype(self, sgb_i: np.ndarray,
                          pgb_i: np.ndarray) -> str:
        """``"int16"`` when every sweep intermediate provably fits int16
        (``sweep_core.pick_state_dtype`` fed this engine's cluster shape,
        payload maxima and compiled migrate-event pool total)."""
        return sweep_core.pick_state_dtype(
            self.cores_per_server, self.n_servers, sgb_i, pgb_i,
            self._pay_mem_max, self._pay_pool_max, self._mig_pool_sum)

    def _rejects_device(self, server_gb, pool_gb,
                        state_dtype: str | None = None, device=None):
        """One K1 launch over the whole batch, every candidate a lane, on
        the engine's device (or on ``device``, a piece of a split launch);
        returns the reject counters there, without a sync.

        The state packs to int16 when the capacities permit and falls back
        to int32 otherwise; ``state_dtype`` forces one packing (testing
        hook)."""
        evs, group_of, n_slots = self._device_events(device)
        dev = self.device if device is None else device
        n0 = len(server_gb)
        sgb_i, pgb_i = sweep_core.quantize_capacities(server_gb, pool_gb)
        dt_name = state_dtype or self._pick_state_dtype(sgb_i, pgb_i)
        np_dt = sweep_core.state_np_dtype(dt_name)
        sweep = sweep_core.get_sweep(dt_name, device=device)
        state = sweep_core.init_state(
            n0, self.n_servers, self.cores_per_server, self.n_servers,
            self.n_groups, n_slots, np_dt)[:4]
        fc, um, up, slots = (sweep_core.device_put(a, dev) for a in state)
        sgb, pgb = (sweep_core.device_put(a.astype(np_dt), dev)
                    for a in (sgb_i, pgb_i))
        rejects = sweep(evs, group_of, fc, um, up, slots, sgb, pgb)
        _TIMES.sweeps.append((n0, dt_name))
        return rejects

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
    @obs.traced("replay.reject_rates")
    def reject_rates(self, server_gb, pool_gb,
                     reject_cap: int | None = None,
                     backend: str = "auto",
                     state_dtype: str | None = None,
                     devices=None) -> np.ndarray:
        """Reject fraction for each (server_gb, pool_gb) candidate.

        Accepts scalars or broadcastable 1-D arrays; one event sweep prices
        the whole batch.  ``backend="torch"`` is one K1 launch on the
        engine's device (its plain version on a CPU engine): the state
        packs to int16 when the candidate capacities (plus payload
        headroom) permit and falls back to int32 automatically;
        ``state_dtype`` ("int16"/"int32") forces one packing for tests.
        It takes integral decisions only (bit-exact against the float64
        oracle) and always returns exact rates, so ``reject_cap`` is
        ignored there.  ``backend="numpy"`` is the divergence-window sweep
        on the host (float64 state, exact for non-integral decisions too):
        with ``reject_cap`` set it drops candidates past the cap mid-sweep
        and reports the lower bound ``(reject_cap + 1) / n_vms``, valid
        for feasibility tests against a tolerance below it.  ``"auto"``
        takes ``"torch"`` if and only if the decisions are integral.
        ``devices`` (``"all"``, a count or a device list,
        :func:`sweep_core.resolve_devices`) splits the torch backend's
        candidate lanes over the devices, one launch each, ``==`` the
        single launch; the numpy backend ignores it.

        Usage (price a 9-point frontier in one sweep)::

            eng = CompiledReplay(vms, decisions, cfg)
            rates = eng.reject_rates(np.linspace(200., 400., 9),
                                     np.linspace(0., 800., 9))
        """
        t0 = time.perf_counter()
        server_gb = np.atleast_1d(np.asarray(server_gb, float))
        pool_gb = np.atleast_1d(np.asarray(pool_gb, float))
        server_gb, pool_gb = np.broadcast_arrays(server_gb, pool_gb)
        n0 = len(server_gb)
        if not self.n_events:
            return np.zeros(n0)
        if _choose_backend(backend, self._exact) == "numpy":
            return self._reject_rates_numpy(server_gb, pool_gb, reject_cap,
                                            t0)
        plan = _lanes(devices, self.device, n0)
        for dev, _, _ in plan:
            self._device_events(dev)    # compile + upload: its own stage
        t0 = time.perf_counter()
        dt_name = state_dtype or self._pick_state_dtype(
            *sweep_core.quantize_capacities(server_gb, pool_gb))
        rates = _gather([self._rejects_device(server_gb[lo:hi],
                                              pool_gb[lo:hi], dt_name, dev)
                         for dev, lo, hi in plan]) / max(self.n_vms, 1)
        _STATS.sweeps += 1
        _STATS.events += self.n_events
        _STATS.candidate_events += self.n_events * n0
        _STATS.wall_s += time.perf_counter() - t0
        _TIMES.sweep_s += time.perf_counter() - t0
        return rates

    def _np_payloads(self):
        """``(gcols, vec3s, vec2s)`` for the numpy sweep, built once an
        engine: the group columns (:func:`_group_columns`) and each VM's
        ``(cores, local, pool)`` vector and its ``(cores, local)`` view."""
        if self._np_pay is None:
            vec3 = [np.array([c, l, p]) for c, l, p in
                    zip(self._cores, self._local, self._pool)]
            self._np_pay = (_group_columns(self.group_of, self.n_servers),
                            vec3, [v[:2] for v in vec3])
        return self._np_pay

    def _reject_rates_numpy(self, server_gb, pool_gb, reject_cap, t0):
        """The divergence-window sweep (the reference's numpy backend).

        Candidates that never leave a reference trajectory's path are
        priced by it for free; the others enter the float64 sweep in at
        most ``MAX_WAVES`` waves, each from the trajectory's snapshot just
        before its earliest divergence.  Non-integral decisions skip the
        shortcut (the snapshots reproduce the oracle's floats exactly only
        for integral GB) and every candidate runs from event 0.  Host
        seconds go to ``StageTimes.sweep_s`` (the trajectories' own to
        ``trajectory_s``)."""
        traj_s0 = _TIMES.trajectory_s
        n0 = len(server_gb)
        n_srv, n_vms, n_ev = self.n_servers, self.n_vms, self.n_events
        denom = max(n_vms, 1)
        rates = np.empty(n0)

        def charge():
            elapsed = time.perf_counter() - t0
            _TIMES.sweep_s += elapsed - (_TIMES.trajectory_s - traj_s0)
            _STATS.sweeps += 1
            _STATS.events += n_ev
            _STATS.wall_s += elapsed

        # pick reference trajectories + first-divergence event per
        # candidate; never-diverging candidates are priced for free
        entries: list[tuple[int, _Trajectory | None, np.ndarray]] = []
        if not self._exact:
            entries.append((0, None, np.arange(n0)))
            todo = np.arange(n0)
        else:
            uniq = np.unique(server_gb)
            # per-size trajectories pay off only for pool-varying batches
            # (fewer sizes than candidates) or when every size's
            # trajectory is already cached; a server-varying batch uses
            # the single cores-only reference instead
            per_sgb = len(uniq) <= MAX_TRAJS and (
                len(uniq) < n0
                or all(float(s) in self._trajs for s in uniq))
            divs = np.empty(n0, np.int64)
            diverges = np.empty(n0, bool)
            trajs: list[tuple[_Trajectory, np.ndarray]] = []
            if per_sgb:       # pool-varying batch at few server sizes
                for sgb in uniq:
                    idx = np.flatnonzero(server_gb == sgb)
                    traj = self._trajectory(float(sgb))
                    viol = traj.need_pool[:, None] > pool_gb[idx][None, :]
                    dv = viol.any(axis=0)
                    divs[idx] = np.where(dv, viol.argmax(axis=0), n_ev)
                    diverges[idx] = dv
                    trajs.append((traj, idx))
            else:             # server-varying batch: cores-only reference
                traj = self._trajectory(None)
                viol = (traj.need_srv[:, None] > server_gb[None, :]) | \
                       (traj.need_pool[:, None] > pool_gb[None, :])
                diverges = viol.any(axis=0)
                divs = np.where(diverges, viol.argmax(axis=0), n_ev)
                trajs.append((traj, np.arange(n0)))
            for traj, idx in trajs:
                rates[idx[~diverges[idx]]] = traj.total_rejects / denom
            todo = np.flatnonzero(diverges)
            if todo.size:
                # entry waves, earliest divergence first; entry events are
                # snapshot-aligned (entering early is exact)
                order = todo[np.argsort(divs[todo], kind="stable")]
                traj_of = np.empty(n0, np.int64)
                for ti, (_, idx) in enumerate(trajs):
                    traj_of[idx] = ti
                for chunk in np.array_split(
                        order, min(MAX_WAVES, len(order))):
                    if not len(chunk):
                        continue
                    ev = int(divs[chunk[0]]) // SNAP * SNAP
                    for ti in np.unique(traj_of[chunk]):
                        g = chunk[traj_of[chunk] == ti]
                        entries.append((ev, trajs[ti][0], g))
                entries.sort(key=lambda w: w[0])
                merged: list[tuple[int, _Trajectory | None, np.ndarray]] = []
                for ev, traj, g in entries:   # merge same (event, traj)
                    if merged and merged[-1][0] == ev \
                            and merged[-1][1] is traj:
                        merged[-1] = (ev, traj,
                                      np.concatenate([merged[-1][2], g]))
                    else:
                        merged.append((ev, traj, g))
                entries = merged

        if not todo.size:
            charge()
            return rates
        if reject_cap is not None:      # default for dropped candidates
            rates[todo] = (reject_cap + 1) / denom

        free = np.empty((0, n_srv + 1, 3))
        placed = np.empty((0, n_vms), np.int32)
        migrated = np.empty((0, n_vms), bool)
        rejects = np.empty(0, np.int64)
        alive = np.empty(0, np.int64)
        cidx = np.empty(0, np.int64)
        clean: set = set()              # vms fast-pathed on every live row
        gcols, vec3s, vec2s = self._np_payloads()
        cores_of, mem_of = self._cores, self._mem
        local_of, pool_of = self._local, self._pool
        ev_kind, ev_vm = self._ev_kind, self._ev_vm
        cand_events = 0
        wi = 0
        e = entries[0][0]

        while e < n_ev:
            while wi < len(entries) and entries[wi][0] == e:
                ev, traj, g = entries[wi]
                wi += 1
                k = len(g)
                base = np.empty((k, n_srv + 1, 3))
                if traj is None:                # virgin start at event 0
                    base[:, :n_srv, 0] = self.cores_per_server
                    base[:, :n_srv, 1] = server_gb[g][:, None]
                    base[:, :n_srv, 2] = pool_gb[g][:, None]
                    pl_t = np.full(n_vms, -1, np.int32)
                    mg_t = np.zeros(n_vms, bool)
                    rej0 = 0
                else:
                    i = ev // SNAP
                    base[:, :n_srv, 0] = traj.snap_cores[i]
                    base[:, :n_srv, 1] = \
                        server_gb[g][:, None] - traj.snap_mem[i]
                    base[:, :n_srv, 2] = \
                        pool_gb[g][:, None] - traj.snap_pool[i][self.group_of]
                    pl_t = np.where((traj.arr_idx < ev)
                                    & (traj.dep_idx >= ev)
                                    & (traj.srv >= 0), traj.srv,
                                    -1).astype(np.int32)
                    mg_t = (pl_t >= 0) & traj.mig & (traj.mig_idx < ev)
                    rej0 = int(traj.snap_rejects[i])
                base[:, n_srv, :] = -_INF
                # the fast departure path assumes uniform placement state
                clean -= {v for v in clean if pl_t[v] < 0 or mg_t[v]}
                free = np.concatenate([free, base])
                placed = np.concatenate([placed, np.tile(pl_t, (k, 1))])
                migrated = np.concatenate([migrated, np.tile(mg_t, (k, 1))])
                rejects = np.concatenate(
                    [rejects, np.full(k, rej0, np.int64)])
                alive = np.concatenate([alive, g])
                cidx = np.arange(len(alive))
            cand_events += len(alive)
            v = ev_vm[e]
            kind = ev_kind[e]
            if kind > MIGRATE:      # FAIL/RECOVER: happy-path no-ops
                e += 1              # (availability() prices them)
                continue
            if kind == DEPART:
                if v in clean:                   # all rows placed, none
                    s = placed[:, v]             # migrated
                    free[cidx, s, :2] += vec2s[v]
                    p = pool_of[v]
                    if p > 0.0:
                        free[cidx[:, None], gcols[s], 2] += p
                    placed[:, v] = -1
                    clean.discard(v)
                    e += 1
                    continue
                s = placed[:, v]
                rows = cidx[s >= 0]
                if rows.size:
                    sv = s[rows]
                    mg = migrated[rows, v]
                    free[rows, sv, 0] += cores_of[v]
                    free[rows, sv, 1] += np.where(mg, mem_of[v],
                                                  local_of[v])
                    free[rows[:, None], gcols[sv], 2] += \
                        np.where(mg, 0.0, pool_of[v])[:, None]
                    migrated[rows, v] = False
                placed[:, v] = -1
                e += 1
                continue
            if kind == MIGRATE:
                # QoS mitigation: copy the pooled GBs back to local if the
                # host has room (§4.3); the VM then departs as all-local.
                p = pool_of[v]
                s = placed[:, v]
                rows = cidx[s >= 0]
                if rows.size:
                    sv = s[rows]
                    room = free[rows, sv, 1] >= p
                    rows, sv = rows[room], sv[room]
                    if rows.size:
                        free[rows, sv, 1] -= p
                        free[rows[:, None], gcols[sv], 2] += p
                        migrated[rows, v] = True
                        clean.discard(v)
                e += 1
                continue
            # ---- ARRIVE: best fit by cores among servers whose free local
            # memory fits; pool checked per group (same mask as the oracle,
            # fused into one packed compare).
            vec3 = vec3s[v]
            ok = (free >= vec3).all(-1)                  # (C, S+1)
            score = np.where(ok, free[:, :, 0], _INF)
            s = score.argmin(1)
            best = score[cidx, s]
            p = pool_of[v]
            if not np.isinf(best.max(initial=-_INF)):
                free[cidx, s, :2] -= vec2s[v]
                if p > 0.0:
                    free[cidx[:, None], gcols[s], 2] -= p
                placed[:, v] = s
                clean.add(v)
                e += 1
                continue
            infeas = np.isinf(best)
            rows = cidx[~infeas]
            if rows.size:
                sv = s[rows]
                free[rows, sv, :2] -= vec2s[v]
                if p > 0.0:
                    free[rows[:, None], gcols[sv], 2] -= p
                placed[rows, v] = sv
            # pool short -> control-plane fallback: start the VM all-local
            # (§4.3: VM starts never block on the pool)
            bad = cidx[infeas]
            c, m = cores_of[v], mem_of[v]
            sub = free[bad]                              # (B, S+1, 3)
            ok2 = (sub[:, :, 0] >= c) & (sub[:, :, 1] >= m)
            score2 = np.where(ok2, sub[:, :, 0], _INF)
            s2 = score2.argmin(1)
            inf2 = np.isinf(score2[np.arange(len(bad)), s2])
            rows2 = bad[~inf2]
            if rows2.size:
                sv2 = s2[~inf2]
                free[rows2, sv2, 0] -= c
                free[rows2, sv2, 1] -= m
                placed[rows2, v] = sv2
                migrated[rows2, v] = True    # departs as all-local
            rej = bad[inf2]
            if rej.size:
                rejects[rej] += 1
                if reject_cap is not None:
                    over = rejects > reject_cap
                    if over.any():           # compact decided candidates
                        keep = ~over
                        alive = alive[keep]
                        free = free[keep]
                        placed = placed[keep]
                        migrated = migrated[keep]
                        rejects = rejects[keep]
                        cidx = np.arange(len(alive))
                        if not len(alive):
                            if wi < len(entries):  # skip to next wave
                                e = entries[wi][0]
                                continue
                            break
            e += 1

        rates[alive] = rejects / denom
        _STATS.candidate_events += cand_events
        charge()
        return rates

    # ------------------------------------------------------- availability --
    @obs.traced("replay.availability")
    def availability(self, server_gb, pool_gb, mitigation: str = "remigrate",
                     backend: str = "auto", state_dtype: str | None = None,
                     per_failure: bool = True) -> AvailabilityResult:
        """Price the merged failure schedule: reject rates WITH the §4.2
        failure model, plus availability metrics, per candidate.

        Requires the engine to have been built with ``failure_schedule=``.
        Broadcasting matches :meth:`reject_rates`.  ``mitigation`` picks
        the blast-radius policy (``"remigrate"`` pulls affected pool into
        host-local DRAM where the server's free memory allows, all or
        nothing per server; ``"kill"`` terminates every affected VM).
        ``backend="auto"`` runs one launch of the failure sweep (K5) on
        the engine's device (its plain version on a CPU engine) for
        integral decisions, and for non-integral ones, which the integer
        sweep cannot price, loops the scalar blast-radius oracle
        ``cluster_sim.replay_with_failures``, as ``backend="oracle"``
        does; bit for bit the same either way.

        Returns an :class:`AvailabilityResult`; with ``per_failure=True``
        it includes the ``(n_failures, n_cand)`` VMs-affected-per-failure
        distribution.
        """
        if self.failure_schedule is None:
            raise ValueError(
                "availability() needs a failure_schedule= at compile time "
                "(see runtime.fault.FailureSchedule)")
        _check_mitigation(mitigation)
        server_gb = np.atleast_1d(np.asarray(server_gb, float))
        pool_gb = np.atleast_1d(np.asarray(pool_gb, float))
        server_gb, pool_gb = np.broadcast_arrays(server_gb, pool_gb)
        if backend not in ("auto", "oracle"):
            raise ValueError(f"backend must be 'auto' or 'oracle', got "
                             f"{backend!r}")
        if backend == "auto" and not self._exact:
            backend = "oracle"
        if backend == "auto":
            self._device_events_fail()  # compile + upload: its own stage
        t0 = time.perf_counter()
        if backend == "auto":
            res = self._availability_device(server_gb, pool_gb, mitigation,
                                            state_dtype, per_failure)
        else:
            res = self._availability_oracle(server_gb, pool_gb, mitigation,
                                            per_failure)
        _STATS.sweeps += 1
        _STATS.events += self.n_events
        _STATS.candidate_events += self.n_events * len(server_gb)
        _STATS.wall_s += time.perf_counter() - t0
        _TIMES.sweep_s += time.perf_counter() - t0
        return res

    def _availability_device(self, server_gb, pool_gb, mitigation,
                             state_dtype, per_failure):
        """One K5 launch over the whole batch, every candidate a lane."""
        evs, group_of, n_slots = self._device_events_fail()
        n0 = len(server_gb)
        n_fail = self.failure_schedule.n_failures
        sgb_i, pgb_i = sweep_core.quantize_capacities(server_gb, pool_gb)
        dt_name = state_dtype or self._pick_state_dtype(sgb_i, pgb_i)
        np_dt = sweep_core.state_np_dtype(dt_name)
        state = sweep_core.init_state(
            n0, self.n_servers, self.cores_per_server, self.n_servers,
            self.n_groups, max(n_slots, 1), np_dt)[:4]
        state += (sweep_core.init_fail_state(n0, self.n_groups),)
        fc, um, up, slots, down = (sweep_core.device_put(a, self.device)
                                   for a in state)
        sgb, pgb = (sweep_core.device_put(a.astype(np_dt), self.device)
                    for a in (sgb_i, pgb_i))
        dist = (torch.zeros((n_fail, n0), dtype=torch.int32,
                            device=self.device)
                if per_failure and n_fail else None)
        sweep = sweep_core.get_fail_sweep(dt_name, mitigation,
                                          with_dist=per_failure)
        out = sweep(evs, group_of, fc, um, up, slots, down, sgb, pgb,
                    *((dist,) if per_failure else ()))
        if per_failure:
            dist = (dist.cpu().numpy().astype(np.int64) if n_fail
                    else np.zeros((0, n0), np.int64))
        _TIMES.sweeps.append((n0, dt_name))
        return _counters_result(out.cpu().numpy(), self.n_vms, n_fail, dist,
                                mitigation)

    def _availability_oracle(self, server_gb, pool_gb, mitigation,
                             per_failure):
        """One ``cluster_sim.replay_with_failures`` call per candidate."""
        from repro_torch.core import cluster_sim  # cyclic at import time
        decisions = (self._decisions_src.as_vmdecisions()
                     if hasattr(self._decisions_src, "as_vmdecisions")
                     else self._decisions_src)
        n0 = len(server_gb)
        n_fail = self.failure_schedule.n_failures
        counts = np.zeros((5, n0), np.int64)
        dist = np.empty((n_fail, n0), np.int64) if per_failure else None
        for i in range(n0):
            r = cluster_sim.replay_with_failures(
                self._vms, decisions, self.cfg, float(server_gb[i]),
                float(pool_gb[i]), self.failure_schedule, mitigation)
            counts[:, i] = (r.rejects, r.affected, r.killed, r.remigrated,
                            r.lost_vm_minutes)
            if per_failure:
                dist[:, i] = r.affected_per_failure
        return _counters_result(counts, self.n_vms, n_fail, dist,
                                mitigation)

    # ------------------------------------------------------------- fleet --
    def _fleet_events_np(self):
        """Slot-mapped numpy event arrays for the fleet sweep (cached):
        one shard dict shaped like a streaming shard, spanning the whole
        trace, float payloads (the numpy fleet backend carries float64
        state, so non-integral decisions replay exactly too)."""
        if self._fleet_ev_np is None:
            ev_slot, next_slot = self._slots()
            vmx = np.asarray(self._ev_vm)
            self._fleet_ev_np = {
                "kind": np.asarray(self._ev_kind, np.int32),
                "slot": np.asarray(ev_slot, np.int32),
                "c": np.asarray(self._cores)[vmx],
                "l": np.asarray(self._local)[vmx],
                "p": np.asarray(self._pool)[vmx],
                "m": np.asarray(self._mem)[vmx],
                "n_slots": int(next_slot),
            }
        return self._fleet_ev_np

    @obs.traced("replay.fleet")
    def reject_rates_fleet(self, server_gb, pod_gb, topology,
                           backend: str = "auto",
                           state_dtype: str | None = None,
                           devices=None) -> np.ndarray:
        """Reject fraction per ``(server_gb, pod capacities, topology)``
        fleet candidate — the multi-pod analog of :meth:`reject_rates`.

        ``topology`` is one ``core/topology.py`` Topology (shared) or a
        sequence of per-lane topologies (all at this engine's
        ``n_servers``); ``pod_gb`` broadcasts per
        :func:`_fleet_candidates` (scalar, shared per-pod array, or
        per-lane entries).  ``backend="torch"`` prices the whole grid with
        one launch of the pod sweep (K4) on the engine's device (its plain
        version on a CPU engine), ``"numpy"`` with the float64 host sweep;
        ``"auto"`` takes ``"torch"`` for integral decisions and
        ``"numpy"`` otherwise.  Both are bit-exact against the scalar
        oracle ``cluster_sim.replay_multi_pool`` (the torch path on
        integral-GB traces, the numpy path unconditionally).
        ``state_dtype`` ("int16"/"int32") forces the torch path's packing
        (testing hook).  ``devices`` splits the torch path's lanes over
        the devices as :meth:`reject_rates` does.

        Usage (price a topology frontier at equal hardware)::

            caps = [topology.split_pool(960.0, t.n_pods) for t in topos]
            rates = eng.reject_rates_fleet(320.0, caps, topos)
        """
        sgb, caps, topos = _fleet_candidates(server_gb, pod_gb, topology)
        if topos[0].n_servers != self.n_servers:
            raise ValueError(
                f"topology covers {topos[0].n_servers} servers; engine "
                f"has {self.n_servers}")
        n0 = len(sgb)
        if not self.n_events:
            return np.zeros(n0)
        backend = _choose_backend(backend, self._exact)
        if backend == "torch":
            plan = _lanes(devices, self.device, n0)
            for dev, _, _ in plan:
                self._device_events(dev)   # compile + upload: a stage
        t0 = time.perf_counter()
        if backend == "torch":
            p_max = _fleet_incidence(topos, self.n_servers)[1]
            dt_name = state_dtype or self._pick_pod_state_dtype(
                *_fleet_capacities(sgb, caps), p_max)
            rates = _gather([self._fleet_rejects_device(
                sgb[lo:hi], caps[lo:hi], topos[lo:hi], dt_name, dev, p_max)
                for dev, lo, hi in plan]) / max(self.n_vms, 1)
        else:
            ev = self._fleet_events_np()
            state = _np_fleet_state(n0, self.n_servers,
                                    self.cores_per_server, sgb, caps,
                                    ev["n_slots"])
            inc, _ = _fleet_incidence(topos, self.n_servers)
            _np_fleet_sweep(ev, inc, *state)
            rates = state[-1] / max(self.n_vms, 1)
        _STATS.sweeps += 1
        _STATS.events += self.n_events
        _STATS.candidate_events += self.n_events * n0
        _STATS.wall_s += time.perf_counter() - t0
        _TIMES.sweep_s += time.perf_counter() - t0
        return rates

    def _pick_pod_state_dtype(self, sgb_i, caps_i, n_pods: int) -> str:
        return sweep_core.pick_pod_state_dtype(
            self.cores_per_server, self.n_servers, sgb_i, caps_i,
            self._pay_mem_max, self._pay_pool_max, self._mig_pool_sum,
            n_pods)

    def _fleet_rejects_device(self, sgb, caps, topos,
                              state_dtype: str | None = None, device=None,
                              p_max: int | None = None):
        """One K4 launch over the whole fleet grid, every candidate a
        lane (the reference's 96-lane chunks do not carry over), on the
        engine's device or on ``device``; returns the reject counters
        there, without a sync.  A piece of a split launch passes the whole
        grid's ``p_max`` (and its capacity columns), so that every piece
        has the single launch's extents."""
        evs, _group_of, n_slots = self._device_events(device)
        dev = self.device if device is None else device
        n0 = len(sgb)
        inc, p_own = _fleet_incidence(topos, self.n_servers)
        p_max = p_own if p_max is None else p_max
        sgb_i, caps_i = _fleet_capacities(sgb, caps)
        dt_name = state_dtype or self._pick_pod_state_dtype(sgb_i, caps_i,
                                                            p_max)
        np_dt = sweep_core.state_np_dtype(dt_name)
        state = sweep_core.init_pod_state(
            n0, self.n_servers, self.cores_per_server, self.n_servers,
            p_max, max(n_slots, 1), np_dt)[:5]
        fc, um, up, slots, pods = (sweep_core.device_put(a, dev)
                                   for a in state)
        sgb_t, pgb_t = (sweep_core.device_put(a.astype(np_dt), dev)
                        for a in (sgb_i, caps_i))
        sweep = sweep_core.get_pod_sweep(dt_name, device=device)
        rejects = sweep(evs, sweep_core.device_put(inc, dev), fc, um,
                        up, slots, pods, sgb_t, pgb_t)
        _TIMES.sweeps.append((n0, dt_name))
        return rejects


# ----------------------------------------------------------- fleet sweeps --
def _fleet_candidates(server_gb, pod_gb, topology):
    """Normalize a fleet candidate grid to per-lane arrays.

    A fleet candidate is a ``(server_gb, per-pod pool_gb, topology)``
    triple; all three broadcast to one lane axis:

    * ``server_gb`` — scalar or ``(n_cand,)``.
    * ``topology`` — one ``core/topology.py`` Topology (shared) or a
      sequence of ``n_cand`` (the topology-frontier axis).
    * ``pod_gb`` — a scalar (every pod of every lane), a 1-D array of
      SHARED per-pod capacities (length must equal every lane
      topology's pod count), or a sequence/2-D array of ``n_cand``
      per-lane entries (each a scalar or a per-pod array).

    Returns ``(sgb (n_cand,), pod_caps (n_cand, P_max), topos)``;
    capacity columns past a lane's pod count are 0 and inert (no
    incidence row points at them).
    """
    topos = list(topology) if isinstance(topology, (list, tuple)) \
        else [topology]
    sgb = np.atleast_1d(np.asarray(server_gb, float))
    if isinstance(pod_gb, np.ndarray) and pod_gb.ndim == 2:
        pod_gb = list(pod_gb)
    rows = len(pod_gb) if isinstance(pod_gb, (list, tuple)) else 1
    n0 = max(len(sgb), len(topos), rows)
    if len(sgb) == 1:
        sgb = np.repeat(sgb, n0)
    if len(topos) == 1:
        topos = topos * n0
    if isinstance(pod_gb, np.ndarray) and pod_gb.ndim == 1:
        for t in topos:
            if t.n_pods != len(pod_gb):
                raise ValueError(
                    "1-D pod_gb gives SHARED per-pod capacities; lane "
                    f"topology {t.describe()} has {t.n_pods} pods for "
                    f"{len(pod_gb)} capacities (pass a per-lane "
                    "sequence instead)")
        pod_gb = [pod_gb] * n0
    elif not isinstance(pod_gb, (list, tuple)):
        pod_gb = float(pod_gb)
    elif rows == 1 and n0 > 1:
        pod_gb = list(pod_gb) * n0
    if len(sgb) != n0 or len(topos) != n0 or (
            isinstance(pod_gb, list) and len(pod_gb) != n0):
        raise ValueError(
            "fleet candidates must broadcast to one lane count; got "
            f"{len(sgb)} server sizes, {len(topos)} topologies, "
            f"{rows} pod-capacity rows")
    n_srv = topos[0].n_servers
    for t in topos:
        if t.n_servers != n_srv:
            raise ValueError(
                "all lane topologies must share n_servers; got "
                f"{t.n_servers} vs {n_srv}")
    caps = topology_mod.pod_caps_matrix(pod_gb, topos)
    return sgb.astype(float), caps, topos


def _fleet_incidence(topos, n_servers: int):
    """Stack per-lane incidence rows to one ``(n_cand, n_servers, F_max)``
    int32 array, ``-1`` filled (narrower lanes reach no further pod).
    Returns ``(inc, p_max)``.  (The reference pads the server axis for
    XLA; K4 takes the true count.)"""
    f_max = max((t.inc.shape[1] for t in topos), default=1)
    p_max = max((t.n_pods for t in topos), default=1)
    inc = np.full((len(topos), n_servers, f_max), -1, np.int32)
    for i, t in enumerate(topos):
        inc[i, :, :t.inc.shape[1]] = t.inc
    return inc, p_max


def _fleet_capacities(sgb, caps):
    """Floor + clip the fleet grid's server and per-pod capacities to the
    integer sweep's domain (``sweep_core.quantize_capacities``)."""
    sgb_i, _ = sweep_core.quantize_capacities(sgb, np.zeros(len(sgb)))
    caps_i = np.clip(np.floor(caps), -sweep_core.I32_BIG,
                     sweep_core.I32_BIG)
    return sgb_i, caps_i


def _np_fleet_sweep(shard, inc, free, pool_free, placed, pod_of,
                    migrated, rejects):
    """Numpy fleet shard sweep over carried state (float64,
    oracle-ordered ops) — the reference's, copied.

    ``inc`` is the ``(C, S, F)`` per-lane incidence (``-1`` padded),
    ``free`` the ``(C, S, 2)`` free cores / free local GB, ``pool_free``
    the ``(C, P)`` per-pod free pool, ``placed``/``pod_of``/``migrated``
    the ``(C, n_slots)`` placement, granting-pod and migrated state —
    all mutated in place so consecutive shards continue one replay.
    Tracking FREE capacities keeps every float add/subtract in the
    scalar ``cluster_sim.replay_multi_pool`` order, so non-integral
    decisions stay bit-exact too.
    """
    kind, slot = shard["kind"], shard["slot"]
    cs, ls, ps, ms = shard["c"], shard["l"], shard["p"], shard["m"]
    cidx = np.arange(free.shape[0])
    valid = inc >= 0
    gidx = np.maximum(inc, 0)
    first_pod = inc[:, :, 0]                          # (C, S)
    for e in range(len(kind)):
        k = kind[e]
        if k >= PAD:                 # PAD and FAIL/RECOVER: no-ops here
            continue
        sl = slot[e]
        if k == DEPART:
            s = placed[:, sl]
            rows = cidx[s >= 0]
            if rows.size:
                sv = s[rows]
                mg = migrated[rows, sl]
                free[rows, sv, 0] += cs[e]
                free[rows, sv, 1] += np.where(mg, ms[e], ls[e])
                q = pod_of[rows, sl]
                back = ~mg & (q >= 0)
                if back.any():
                    pool_free[rows[back], q[back]] += ps[e]
                migrated[rows, sl] = False
            placed[:, sl] = -1
            pod_of[:, sl] = -1
            continue
        if k == MIGRATE:
            p = ps[e]
            s = placed[:, sl]
            rows = cidx[s >= 0]
            if rows.size:
                sv = s[rows]
                room = free[rows, sv, 1] >= p
                rows, sv = rows[room], sv[room]
                if rows.size:
                    free[rows, sv, 1] -= p
                    # pool returns to the granting pod; fallback VMs
                    # (no grant) pay their server's first listed pod,
                    # or skip the pool update on a pod-less server
                    q = pod_of[rows, sl]
                    tgt = np.where(q >= 0, q, first_pod[rows, sv])
                    back = tgt >= 0
                    if back.any():
                        pool_free[rows[back], tgt[back]] += p
                    migrated[rows, sl] = True
            continue
        # ARRIVE: best fit by cores among servers whose free local
        # memory fits and SOME reachable pod fits the whole pool demand
        c, l, p, m = cs[e], ls[e], ps[e], ms[e]
        okcm = (free[:, :, 0] >= c) & (free[:, :, 1] >= l)
        if p > 0.0:
            pf = pool_free[cidx[:, None, None], gidx]
            fits = valid & (pf >= p)
            ok = okcm & fits.any(-1)
        else:
            fits = None
            ok = okcm
        score = np.where(ok, free[:, :, 0], _INF)
        s = score.argmin(1)
        feas = ~np.isinf(score[cidx, s])
        rows = cidx[feas]
        if rows.size:
            sv = s[rows]
            free[rows, sv, 0] -= c
            free[rows, sv, 1] -= l
            if p > 0.0:
                f = fits[rows, sv].argmax(-1)   # first listed fitting pod
                q = inc[rows, sv, f]
                pool_free[rows, q] -= p
                pod_of[rows, sl] = q
            placed[rows, sl] = sv
        bad = cidx[~feas]
        if bad.size:
            # pool short -> control-plane fallback: start the VM all-local
            sub = free[bad]
            ok2 = (sub[:, :, 0] >= c) & (sub[:, :, 1] >= m)
            score2 = np.where(ok2, sub[:, :, 0], _INF)
            s2 = score2.argmin(1)
            inf2 = np.isinf(score2[np.arange(len(bad)), s2])
            rows2 = bad[~inf2]
            if rows2.size:
                sv2 = s2[~inf2]
                free[rows2, sv2, 0] -= c
                free[rows2, sv2, 1] -= m
                placed[rows2, sl] = sv2
                migrated[rows2, sl] = True       # departs as all-local
            rejects[bad[inf2]] += 1


def _np_fleet_state(n_cand: int, n_servers: int, cores_per_server,
                    sgb: np.ndarray, pod_caps: np.ndarray,
                    n_slots: int) -> tuple:
    """All-free numpy fleet carry: ``(free, pool_free, placed, pod_of,
    migrated, rejects)`` for :func:`_np_fleet_sweep`."""
    free = np.empty((n_cand, n_servers, 2))
    free[:, :, 0] = cores_per_server
    free[:, :, 1] = sgb[:, None]
    pool_free = pod_caps.astype(float).copy()
    placed = np.full((n_cand, n_slots), -1, np.int64)
    pod_of = np.full((n_cand, n_slots), -1, np.int64)
    migrated = np.zeros((n_cand, n_slots), bool)
    rejects = np.zeros(n_cand, np.int64)
    return free, pool_free, placed, pod_of, migrated, rejects


# ------------------------------------------------------------- streaming ---
_EVENT_KEYS = ("kind", "slot", "c", "l", "p", "m")


def _np_stream_sweep(shard, gcols, free, placed, migrated, rejects):
    """Numpy shard sweep over carried state (float64, oracle-ordered ops) —
    the reference's, copied.

    Vectorized over candidates, slot-indexed and carry-threaded: ``free``
    is the packed ``(C, n_servers + 1, 3)`` free-capacity array (cores /
    local GB / mirrored group pool GB; the +1 dummy column absorbs ragged
    pool groups), ``placed``/``migrated`` are ``(C, n_slots)`` placement
    state, ``rejects`` the per-candidate counters — all mutated in place so
    consecutive shards continue one replay.  Tracking FREE capacities (not
    usage) keeps the float adds/subtracts in the scalar oracle's exact
    order, so non-integral decisions stay bit-exact too.
    """
    kind, slot = shard["kind"], shard["slot"]
    cs, ls, ps, ms = shard["c"], shard["l"], shard["p"], shard["m"]
    cidx = np.arange(free.shape[0])
    for e in range(len(kind)):
        k = kind[e]
        if k >= PAD:                 # PAD and FAIL/RECOVER: no-ops here
            continue
        sl = slot[e]
        if k == DEPART:
            s = placed[:, sl]
            rows = cidx[s >= 0]
            if rows.size:
                sv = s[rows]
                mg = migrated[rows, sl]
                free[rows, sv, 0] += cs[e]
                free[rows, sv, 1] += np.where(mg, ms[e], ls[e])
                free[rows[:, None], gcols[sv], 2] += \
                    np.where(mg, 0.0, ps[e])[:, None]
                migrated[rows, sl] = False
            placed[:, sl] = -1
            continue
        if k == MIGRATE:
            p = ps[e]
            s = placed[:, sl]
            rows = cidx[s >= 0]
            if rows.size:
                sv = s[rows]
                room = free[rows, sv, 1] >= p
                rows, sv = rows[room], sv[room]
                if rows.size:
                    free[rows, sv, 1] -= p
                    free[rows[:, None], gcols[sv], 2] += p
                    migrated[rows, sl] = True
            continue
        # ARRIVE: best fit by cores among servers whose free local memory
        # and group pool fit
        vec3 = np.array([cs[e], ls[e], ps[e]])
        ok = (free >= vec3).all(-1)
        score = np.where(ok, free[:, :, 0], _INF)
        s = score.argmin(1)
        best = score[cidx, s]
        p = ps[e]
        feas = ~np.isinf(best)
        rows = cidx[feas]
        if rows.size:
            sv = s[rows]
            free[rows, sv, 0] -= cs[e]
            free[rows, sv, 1] -= ls[e]
            if p > 0.0:
                free[rows[:, None], gcols[sv], 2] -= p
            placed[rows, sl] = sv
        bad = cidx[~feas]
        if bad.size:
            # pool short -> control-plane fallback: start the VM all-local
            c, m = cs[e], ms[e]
            sub = free[bad]
            ok2 = (sub[:, :, 0] >= c) & (sub[:, :, 1] >= m)
            score2 = np.where(ok2, sub[:, :, 0], _INF)
            s2 = score2.argmin(1)
            inf2 = np.isinf(score2[np.arange(len(bad)), s2])
            rows2 = bad[~inf2]
            if rows2.size:
                sv2 = s2[~inf2]
                free[rows2, sv2, 0] -= c
                free[rows2, sv2, 1] -= m
                placed[rows2, sl] = sv2
                migrated[rows2, sl] = True       # departs as all-local
            rejects[bad[inf2]] += 1


# ------------------------------------------------- checkpoint / resume ----
class SweepInterrupted(RuntimeError):
    """A streaming sweep was killed by the chaos hook
    (``CheckpointSpec.kill_after_shards``) after writing its checkpoint.
    Carries the checkpoint path and the number of shard sweeps completed
    before the kill."""

    def __init__(self, path: str, shards_done: int):
        self.path, self.shards_done = path, shards_done
        super().__init__(
            f"sweep interrupted after {shards_done} shard sweeps "
            f"(checkpoint at {path})")


@dataclasses.dataclass(frozen=True)
class CheckpointSpec:
    """Checkpoint/resume policy for the streaming sweeps.

    Passed as ``checkpoint=`` to :meth:`CompiledReplayStream.reject_rates`
    and :meth:`CompiledReplayStreamBatch.reject_rates`: every
    ``every_shards`` shard sweeps the engine writes the state and the shard
    cursor to ``path`` (one ``.npz``, written atomically: a tmp file and
    ``os.replace``, so a kill mid-write never corrupts the previous
    snapshot).  With ``resume=True`` an existing checkpoint whose
    fingerprint matches the sweep (backend, state dtype, event and shard
    counts, candidate grid bytes, reject cap) is loaded first and the sweep
    goes on from its shard with its state.  Resumed results are identical
    to an uninterrupted sweep; a fingerprint mismatch raises
    ``ValueError``.  The file is the port's own (every candidate is one
    launch, so there is no candidate-chunk cursor in it).

    ``kill_after_shards`` is the chaos hook: after that many shard sweeps
    the engine writes a snapshot and raises :class:`SweepInterrupted`.
    """

    path: str
    every_shards: int = 8
    resume: bool = False
    kill_after_shards: int | None = None


def _sweep_fingerprint(backend: str, dt_name: str, n_events, n_shards,
                       n_vms, reject_cap, server_gb, pool_gb) -> str:
    """Identity of one streaming sweep: resuming under any other
    configuration would silently produce wrong counts, so the checkpoint
    refuses to load when this differs."""
    h = hashlib.sha256()
    h.update(repr((backend, dt_name, np.asarray(n_events).tolist(),
                   np.asarray(n_shards).tolist(),
                   np.asarray(n_vms).tolist(), reject_cap)).encode())
    h.update(np.ascontiguousarray(np.asarray(server_gb, float)).tobytes())
    h.update(np.ascontiguousarray(np.asarray(pool_gb, float)).tobytes())
    return h.hexdigest()


class _CheckpointIO:
    """Snapshot cadence, atomic npz IO and the chaos kill hook for one
    streaming sweep (shared by the device and numpy shard loops)."""

    def __init__(self, spec: CheckpointSpec, fingerprint: str):
        self.spec = spec
        self.fp = fingerprint
        self.shards_done = 0

    def load(self) -> dict | None:
        if not (self.spec.resume and os.path.exists(self.spec.path)):
            return None
        with obs.get_recorder().span("checkpoint.load"):
            with np.load(self.spec.path, allow_pickle=False) as z:
                state = {key: z[key] for key in z.files}
        got = str(state.pop("fingerprint"))
        if got != self.fp:
            raise ValueError(
                f"checkpoint {self.spec.path} belongs to a different "
                "sweep (backend/state dtype/trace/candidates/reject cap "
                "changed); delete it or rerun the original sweep")
        return state

    def save(self, state: dict) -> None:
        with obs.get_recorder().span("checkpoint.save"):
            tmp = self.spec.path + ".tmp.npz"
            np.savez(tmp, fingerprint=self.fp, **state)
            os.replace(tmp, self.spec.path)

    def tick(self, state_fn) -> None:
        """After each shard sweep: snapshot on cadence; then, if the chaos
        hook fires, force a snapshot and raise."""
        self.shards_done += 1
        kill = (self.spec.kill_after_shards is not None
                and self.shards_done >= self.spec.kill_after_shards)
        due = (self.spec.every_shards > 0
               and self.shards_done % self.spec.every_shards == 0)
        if due or kill:
            self.save(state_fn())
        if kill:
            raise SweepInterrupted(self.spec.path, self.shards_done)

    def done(self) -> None:
        """Completed sweeps delete their checkpoint: a later resume of a
        finished run recomputes from scratch instead of loading a stale
        cursor."""
        if os.path.exists(self.spec.path):
            os.remove(self.spec.path)


def _checkpoint_io(spec, fingerprint):
    """``(io, loaded state)`` for a sweep: ``(None, None)`` without a
    spec."""
    if spec is None:
        return None, None
    io = _CheckpointIO(spec, fingerprint)
    return io, io.load()


# ------------------------------------------- double-buffered uploads --
class _ShardFeed:
    """Double-buffered upload of a stream's shards to the sweep's device.

    Two host buffers of six int32 rows (kind, slot, cores, local, pool,
    mem) of ``rows`` events each, pinned when the device is the card, and
    two device buffers of the same shape.  :meth:`stage` packs shard ``si``
    into host buffer ``si % 2`` (``pack(si, buffer)`` returns the events
    the launch takes and the trace axis's counts) and,
    on the card, copies the buffer into device buffer ``si % 2`` with a
    ``non_blocking`` copy on a side CUDA stream, ordered after the launch
    that last read that buffer (shard ``si - 2``).  :meth:`take` orders the
    current stream after that copy and returns the six rows (each 16-byte
    aligned: ``rows`` is a multiple of 4); :meth:`release` marks the launch
    that read them.  The caller stages shard ``si + 1`` after launching
    shard ``si``, so the copy runs while the kernel sweeps shard ``si``:
    at most two shards' event tensors are on the card.  Refilling a host
    buffer waits for its previous copy.  On the CPU the host buffers are
    the sweep's own.

    Tracing (``timed``: a recorder was live when the feed was made): the
    copy is a ``non_blocking`` copy on the side stream and :meth:`take`
    makes the compute stream wait for it on the card, not on the host, so
    a host clock around either reads ~0 and says nothing.  (The reference
    blocks instead: it waits for its upload worker and for the sweep's
    result.)  So the copy events take timing, and :func:`_traced_shards`
    places them on the recorder's clock through a CUDA event recorded at
    a known host time after one synchronisation: ``stream.upload`` lasts
    the host's packing plus the copy on the card (from an event pair
    around it: not the copy's wait for its buffer to be read) and ends
    where the copy ends; ``stream.compute`` is a CUDA event pair around the
    launch; ``stream.upload_wait`` is how long shard i's copy outlasts
    shard i - 1's launch (for the first shard swept, its whole upload),
    which is what the compute stream waited.  Shard i's events are
    resolved (one host wait on the end of its launch) only after shard
    i + 1 is launched and shard i + 2 staged, so tracing never makes an
    upload or a launch wait behind the compute, and
    ``stream.overlap_ratio`` (1 - wait / upload) is the reference's
    quantity: the share of upload time hidden behind the sweep.  Every stage counts ``device_put.calls`` (one copy of the
    buffer) and ``device_put.bytes`` (the whole buffer, which is what is
    copied).
    """

    def __init__(self, pack, rows: int, device: torch.device):
        self.pack = pack
        self.card = device.type == "cuda"
        self.timed = obs.enabled()
        self.host = [torch.empty((6, rows), dtype=torch.int32,
                                 pin_memory=self.card) for _ in range(2)]
        self.dev = self.host
        if self.card:
            self.dev = [torch.empty((6, rows), dtype=torch.int32,
                                    device=device) for _ in range(2)]
            self.side = torch.cuda.Stream(device)
            # the device buffers may be blocks that launches queued before
            # this feed still read (an earlier feed's, freed without a
            # sync: a split sweep's pieces): the copies wait for them
            self.side.wait_stream(torch.cuda.current_stream(device))
            self.copied = [None, None]    # the copy into buffer b
            self.read = [None, None]      # the launch that read buffer b
            self.started = [None, None]   # the copy's start (timed)
        self.staged = {}

    def stage(self, si: int) -> None:
        b = si % 2
        if self.card and self.copied[b] is not None:
            self.copied[b].synchronize()  # host buffer b is free again
        length, counts = self.pack(si, self.host[b].numpy())
        if self.timed:
            self.packed_at = time.perf_counter_ns()
        if self.card:
            with torch.cuda.stream(self.side):
                if self.read[b] is not None:
                    self.side.wait_event(self.read[b])
                if self.timed:
                    self.started[b] = torch.cuda.Event(enable_timing=True)
                    self.started[b].record(self.side)
                # one copy of the whole buffer (a shorter shard's tail is
                # stale and never read): one call instead of six
                self.dev[b].copy_(self.host[b], non_blocking=True)
                self.copied[b] = torch.cuda.Event(enable_timing=self.timed)
                self.copied[b].record(self.side)
        if self.timed:
            rec = obs.get_recorder()
            rec.count("device_put.calls")
            rec.count("device_put.bytes", self.host[b].nbytes)
        self.staged[si] = (length, counts)

    def take(self, si: int):
        """``(six event rows, trace counts)`` of a staged shard."""
        length, counts = self.staged.pop(si)
        buf = self.dev[si % 2]
        if self.card:
            torch.cuda.current_stream(buf.device).wait_event(
                self.copied[si % 2])
        return tuple(buf[j, :length] for j in range(6)), counts

    def release(self, si: int) -> None:
        if self.card:
            self.read[si % 2] = torch.cuda.Event()
            self.read[si % 2].record()

    def close(self) -> None:
        """Orders the current stream after every copy (one staged ahead
        may be left unread by an early exit), so the buffers may be
        freed."""
        if self.card:
            torch.cuda.current_stream(self.dev[0].device).wait_stream(
                self.side)


def _pack_rows(buf, at: int, shard: dict, n: int) -> int:
    """Shard ``shard``'s first ``n`` events into ``buf`` (6, rows) from
    row ``at``, PAD events (a no-op) up to the next multiple of 4; returns
    the row after them."""
    end = at + sweep_core.pad_up(n, 4)
    for j, key in enumerate(_EVENT_KEYS):
        buf[j, at:at + n] = shard[key][:n]
    buf[0, at + n:end] = PAD
    buf[1:, at + n:end] = 0
    return end


def _stream_shards(feed, shard_from: int, n_shards: int, launch, rejects,
                   reject_cap, after=None, span: str = "stream.shard"):
    """The device sweeps' shard loop: stage the first shard, then for each
    shard launch it, stage the next (its copy overlaps the launch), run
    ``after(si)`` (invariants, checkpoints) and, with ``reject_cap``, read
    the reject counters (the loop's only sync) and stop once every lane
    exceeds the cap.  A generator: it yields after each shard, so that
    :func:`_run_pieces` can take a split sweep's pieces in turn, and
    returns the shards swept.  A feed made while tracing is on is
    ``timed``: :func:`_traced_shards` runs the loop instead, each shard in
    a ``span`` span."""
    if feed.timed:
        return (yield from _traced_shards(feed, shard_from, n_shards, launch,
                                          rejects, reject_cap, after, span))
    swept = 0
    try:
        if shard_from < n_shards:
            feed.stage(shard_from)
        for si in range(shard_from, n_shards):
            evs, counts = feed.take(si)
            launch(evs, counts)
            feed.release(si)
            swept += 1
            if si + 1 < n_shards:
                feed.stage(si + 1)
            if after is not None:
                after(si)
            if reject_cap is not None and bool(
                    (rejects > reject_cap).all()):
                break                    # every lane decided
            yield
    finally:
        feed.close()
    return swept


def _run_pieces(pieces) -> list:
    """Runs the shard loops of a stream sweep's pieces, ``[(device,
    loop), ...]`` (generators over :func:`_stream_shards`), a shard at a
    time in turn, each step with its device current (:func:`_on`).  A
    step queues the piece's launch of shard i and stages shard i + 1,
    where the host waits only for that piece's copy of shard i - 1; so,
    without ``reject_cap``, a checkpoint or the invariant guard (which
    read the state), no piece waits for another's launches and the
    devices of a split stream sweep run side by side.  Returns each
    loop's result, in order.  A sweep of one piece runs its loop
    through."""
    out = [None] * len(pieces)
    live = dict(enumerate(pieces))
    try:
        while live:
            for j, (dev, loop) in list(live.items()):
                with _on(dev):
                    try:
                        next(loop)
                    except StopIteration as stop:
                        out[j] = stop.value
                        del live[j]
    finally:
        for dev, loop in live.values():  # another piece raised
            with _on(dev):
                loop.close()
    return out


def _traced_shards(feed, shard_from: int, n_shards: int, launch, rejects,
                   reject_cap, after, span: str):
    """:func:`_stream_shards` under a live recorder: the same shards in the
    same order, each in a ``span`` span, with ``stream.upload``,
    ``stream.upload_wait`` and ``stream.compute`` spans a shard, timed as
    :class:`_ShardFeed` describes (CUDA events on the card, the host clock
    on the CPU, where the launch is synchronous); an early exit counts
    ``stream.reject_cap_exits``.  Shard i's events are resolved in shard
    i + 1's span, after its launch and the next stage are queued, so the
    card is never idle for the tracing's sake; the last shard, and every
    shard under ``reject_cap`` (whose check reads the counters anyway), in
    its own span (a shard left by an exception out of ``after``, such as
    the checkpoint's kill hook, on the way out)."""
    rec = obs.get_recorder()
    now = time.perf_counter_ns
    if feed.card:
        # one sync: the anchor event then completes at its host time
        torch.cuda.synchronize(feed.dev[0].device)
        anchor = torch.cuda.Event(enable_timing=True)
        t_anchor = now()
        anchor.record()

        def mark():
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev

        def on_clock(ev):
            return t_anchor + int(anchor.elapsed_time(ev) * 1e6)
    else:
        mark = now
    staged = {}      # shard -> (stage start, packed, copy start, copy end)
    pending = []     # launched shards not resolved yet: (shard, k0, k1)
    prev_end = None  # the previous launch's end, recorder clock

    def stage(si):
        t0 = now()
        feed.stage(si)
        b = si % 2
        staged[si] = ((t0, feed.packed_at, feed.started[b], feed.copied[b])
                      if feed.card else (t0, now(), None, None))

    def resolve(si, k0, k1):
        nonlocal prev_end
        up0, up1, started, copied = staged.pop(si)
        if feed.card:
            k1.synchronize()
            work = up1 - up0 + int(started.elapsed_time(copied) * 1e6)
            up1 = on_clock(copied)
            up0, k0, k1 = up1 - work, on_clock(k0), on_clock(k1)
        w0 = up0 if prev_end is None else prev_end
        rec.add_span("stream.upload", up0, up1, shard=si)
        rec.add_span("stream.upload_wait", w0, max(w0, up1), shard=si)
        rec.add_span("stream.compute", k0, k1, shard=si)
        prev_end = k1

    swept = 0
    try:
        if shard_from < n_shards:
            stage(shard_from)
        for si in range(shard_from, n_shards):
            with rec.span(span, shard=si):
                evs, counts = feed.take(si)
                k0 = mark()
                launch(evs, counts)
                pending.append((si, k0, mark()))
                feed.release(si)
                swept += 1
                if si + 1 < n_shards:
                    stage(si + 1)
                keep = 0 if si + 1 == n_shards or reject_cap is not None \
                    else 1
                while len(pending) > keep:
                    resolve(*pending.pop(0))
            if after is not None:
                after(si)
            if reject_cap is not None and bool(
                    (rejects > reject_cap).all()):
                rec.count("stream.reject_cap_exits")
                break                    # every lane decided
            yield
    finally:
        while pending:                   # an exception out of after()
            resolve(*pending.pop(0))
        feed.close()
    return swept


# --------------------------------------------- divergence windows --
def _stream_reference(stream):
    """Infinite-capacity reference replay over a stream's shards — the
    reference's, copied.

    Replays the shards once with unbounded server/pool capacities —
    exactly the sweep's semantics at ``sgb = pgb = inf`` (best fit by free
    cores, first index on ties; cores-only rejects).  Produces, per shard,
    the maximum server/pool demand any admission or migration test could
    require (``max_srv`` / ``max_pool``) plus the full state at every shard
    boundary.

    A candidate lane whose capacities dominate a prefix of these maxima
    provably takes the identical action at every event of that prefix, so
    the sweep may start from the boundary snapshot instead — the
    divergence-window skip.  Cached on the stream; returns ``None`` when
    the stream cannot support exact skipping (non-integral decisions or
    cores).
    """
    ref = getattr(stream, "_ref", None)
    if ref is not None:
        return ref if ref != "unusable" else None
    cps = float(stream.cores_per_server)
    if not (stream._exact and cps.is_integer()):
        stream._ref = "unusable"
        return None
    big = 1 << 60
    n_srv = stream.n_servers
    group_of = np.asarray(stream.group_of, np.int64)
    fc = np.full(n_srv, int(cps), np.int64)
    um = np.zeros(n_srv, np.int64)
    up = np.zeros(stream.n_groups, np.int64)
    slots = np.full(stream._n_slots, -1, np.int64)
    rej = 0
    n = stream.n_shards
    max_srv = np.empty(n, np.int64)
    max_pool = np.empty(n, np.int64)
    snaps = [(fc.copy(), um.copy(), up.copy(), slots.copy(), rej)]
    for si, shard in enumerate(stream._shards):
        kinds = shard["kind"].tolist()
        sls = shard["slot"].tolist()
        cs = shard["c"].tolist()
        ls = shard["l"].tolist()
        ps = shard["p"].tolist()
        ms_ = shard["m"].tolist()
        ms = mp = -big                # event-free shards always skip
        for e, kind in enumerate(kinds):
            if kind == ARRIVE:
                c = int(cs[e])
                feas = fc >= c
                if feas.any():
                    b = int(np.argmin(np.where(feas, fc, big)))
                    g = group_of[b]
                    fc[b] -= c
                    um[b] += int(ls[e])
                    up[g] += int(ps[e])
                    slots[sls[e]] = b * 2
                    if um[b] > ms:
                        ms = int(um[b])
                    if up[g] > mp:
                        mp = int(up[g])
                else:
                    rej += 1
            elif kind == DEPART:
                val = int(slots[sls[e]])
                if val >= 0:
                    b = val >> 1
                    fc[b] += int(cs[e])
                    if val & 1:
                        um[b] -= int(ms_[e])
                    else:
                        um[b] -= int(ls[e])
                        up[group_of[b]] -= int(ps[e])
                    slots[sls[e]] = -1
            elif kind == MIGRATE:
                val = int(slots[sls[e]])
                if val >= 0:
                    b = val >> 1
                    p = int(ps[e])
                    um[b] += p
                    up[group_of[b]] -= p
                    slots[sls[e]] = val | 1
                    if um[b] > ms:
                        ms = int(um[b])
            # PAD (and FAIL/RECOVER, which the plain sweep ignores) leave
            # the state untouched
        max_srv[si] = ms
        max_pool[si] = mp
        snaps.append((fc.copy(), um.copy(), up.copy(), slots.copy(), rej))
    stream._ref = {"max_srv": max_srv, "max_pool": max_pool,
                   "snaps": snaps}
    return stream._ref


def _skip_count(ref, min_sgb, min_pgb, n_shards):
    """Leading shards a sweep may skip: the longest prefix whose reference
    demand maxima every lane capacity covers.  A stream whose entire trace
    is skippable extends to ``n_shards`` (a batch's trailing shards of a
    shorter stream hold no events)."""
    viol = (ref["max_srv"] > min_sgb) | (ref["max_pool"] > min_pgb)
    nz = np.flatnonzero(viol)
    return int(nz[0]) if nz.size else n_shards


def _carry_from_snap(snap, width, n_servers, n_groups, n_slots, np_dt):
    """State seeded from a reference boundary snapshot, broadcast across
    ``width`` candidate lanes (every non-diverged lane holds exactly the
    reference state): ``(fc, um, up, slots, rejects)`` as
    ``sweep_core.init_state`` lays them out (the reference's server and
    group padding is not carried over; slots past the snapshot's are
    empty)."""
    fc_r, um_r, up_r, slots_r, rej = snap
    fc0 = np.empty((width, n_servers), np_dt)
    fc0[:] = fc_r
    um0 = np.empty((width, n_servers), np_dt)
    um0[:] = um_r
    up0 = np.empty((width, n_groups), np_dt)
    up0[:] = up_r
    slots0 = np.full((n_slots, width), -1, np_dt)
    slots0[:len(slots_r), :] = slots_r[:, None]
    rej0 = np.full(width, rej, np.int32)
    return fc0, um0, up0, slots0, rej0


def _gather(rejects, axis: int = -1) -> np.ndarray:
    """The reject counters of one launch, or of a split launch's pieces in
    order, as one int64 host array.  Every piece is queued before the
    first is read, so the devices of a split launch run side by side."""
    return np.concatenate([r.cpu().numpy().astype(np.int64)
                           for r in rejects], axis=axis)


def _on(device: torch.device):
    """``device`` made current for a piece's shard loop (its launches, its
    feed's side stream and events), a no-op on the CPU."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def _lanes(devices, device, width: int) -> list:
    """The pieces of a lane split, ``[(device, lo, hi), ...]``
    (:func:`sweep_core.lane_plan`), or the single-device path's one
    piece, ``[(None, 0, width)]``: None keeps the engine's own device and
    the launchers' single-device keys."""
    return sweep_core.lane_plan(
        width, sweep_core.resolve_devices(devices, device)) or \
        [(None, 0, width)]


def _piece_checkpoint(spec, j: int, n: int):
    """Piece ``j`` of a split stream sweep of ``n`` pieces keeps its own
    checkpoint file (``<path>.d<j>``): each piece carries its own state.
    A sweep of one piece keeps ``spec``."""
    if spec is None or n == 1:
        return spec
    return dataclasses.replace(spec, path=f"{spec.path}.d{j}")


def _to_device(arrays, device):
    """Host numpy arrays as contiguous tensors on ``device``; to the card
    through pinned memory without a host wait (a pageable copy would wait
    for the work queued before it)."""
    return tuple(sweep_core.device_put(a, device, non_blocking=True)
                 for a in arrays)


class CompiledReplayStream:
    """Out-of-core replay: time-windowed event shards, carried state.

    Prices arbitrarily long traces with the event memory on ``device``
    (default: the CUDA card; ``"cpu"`` runs the sweeps' plain versions) set
    by ``max_events_per_shard``: events compile into shards of at most that
    many events (floored to a multiple of 256; the reference's cuts, event
    for event) and the state — free cores, used local/pool GB, the slot
    array, the reject counters — stays on the device from shard to shard,
    one launch of the event sweep (K1) a shard for the whole candidate
    batch, so N shards replay EXACTLY like one monolithic sweep: reject
    rates are bit-exact against :class:`CompiledReplay`.  The state packs
    to int16 when the capacities permit (same rules as the monolithic
    sweep); with non-integral GB decisions (or ``backend="numpy"``) a
    numpy shard sweep carries the same state in float64.

    Two construction modes:

    * **in-memory** — drop-in for :class:`CompiledReplay` when only the
      event tensor (not the VM list) outgrows memory::

          stream = CompiledReplayStream(vms, decisions, cfg,
                                        max_events_per_shard=100_000)
          rates = stream.reject_rates([300.0, 350.0], [512.0, 256.0])

    * **chunked** — bounded-memory ingestion from an iterator of VM
      chunks; chunk arrivals must be non-decreasing across chunk
      boundaries, and ``decide`` maps each chunk to its per-VM decisions
      (default: all-local; a ``PolicyDecisions.slice`` works)::

          stream = CompiledReplayStream(
              iter(chunks), None, cfg, max_events_per_shard=250_000,
              decide=lambda chunk: cluster_sim.policy_decisions(
                  chunk, "static", static_pool_frac=0.15)[0])

    Chunk ingestion keeps compact per-event arrays, per-VM payload scalars
    and the pending-departure buffer; a sweep has at most TWO shards'
    event tensors on the device (the one computing and the one uploading:
    ``2 * peak_shard_bytes``), which is what ``max_events_per_shard``
    bounds.
    """

    def __init__(self, vms, decisions=None, cfg=None, *,
                 max_events_per_shard: int = 262_144, decide=None,
                 device=None):
        if cfg is None:
            raise TypeError("CompiledReplayStream(vms, decisions, cfg): "
                            "cfg is required")
        if max_events_per_shard < sweep_core.EVENT_PAD:
            raise ValueError("max_events_per_shard must be >= 256")
        t0 = time.perf_counter()
        self.device = resolve_device(device)
        self.cfg = cfg
        # floored to a multiple of 256 (the shard length granularity) so
        # that a shard NEVER exceeds the stated budget
        self.max_events_per_shard = (int(max_events_per_shard)
                                     // sweep_core.EVENT_PAD
                                     * sweep_core.EVENT_PAD)
        self.n_servers = n_srv = cfg.n_servers
        self.n_groups = cfg.n_groups
        self.group_of = np.arange(n_srv) // cfg.servers_per_group
        self.cores_per_server = float(cfg.cores_per_server)
        self._gcols = _group_columns(self.group_of, n_srv)

        # ingest state
        self.n_vms = 0
        self._cores: list[float] = []
        self._local: list[float] = []
        self._pool: list[float] = []
        self._mem: list[float] = []
        self._exact = True
        self._pend_t: list[float] = []
        self._pend_k: list[int] = []
        self._pend_v: list[int] = []
        self._t_seen = -_INF          # latest arrival ingested
        self._t_flushed = -_INF       # events < this are already compiled
        self._slot_of: list[int] = []
        self._free_slots: list[int] = []
        self._next_slot = 0
        self._buf: dict[str, list] = {k: [] for k in _EVENT_KEYS}
        self._shards: list[dict] = []
        self.n_events = 0
        self._pool_cum = 0.0
        self._peak_pool = 0.0
        self._pay_mem_max = 0.0
        self._pay_pool_max = 0.0
        self._has_migrate = False
        self._mig_pool_sum = 0.0      # compiled MIGRATE-event pool total
        self._ref = None              # _stream_reference's cache

        it = iter(vms)
        first = next(it, None)
        if first is None:
            pass                                    # empty trace
        elif hasattr(first, "arrival"):             # flat VM list
            allvms = [first, *it]
            if decisions is not None and len(decisions) != len(allvms):
                raise ValueError("decisions must align with vms")
            self._ingest_chunk(allvms, decisions)
        else:                                       # iterator of chunks
            if decisions is not None:
                raise ValueError(
                    "pass decisions=None with a chunk iterator; supply a "
                    "decide(chunk) callback instead")
            for chunk in ([first] if first else []):
                self._ingest_chunk(chunk,
                                   decide(chunk) if decide else None)
            for chunk in it:
                if chunk:
                    self._ingest_chunk(chunk,
                                       decide(chunk) if decide else None)
        self._finish()
        _TIMES.compile_s += time.perf_counter() - t0

    # ------------------------------------------------------------ ingest --
    def _ingest_chunk(self, chunk, decisions) -> None:
        if decisions is not None:
            # list of VMDecision or a PolicyDecisions SoA, normalized to
            # arrays either way (NaN t_migrate = none)
            local_a, pool_a, tmig_a = _decision_arrays(decisions,
                                                       len(chunk))
        t_min = _INF
        for i, vm in enumerate(chunk):
            v = self.n_vms
            self.n_vms += 1
            c = float(vm.cores)
            m = float(vm.mem_gb)
            l = m if decisions is None else float(local_a[i])
            p = 0.0 if decisions is None else float(pool_a[i])
            t_mig = None
            if decisions is not None and not np.isnan(tmig_a[i]):
                t_mig = float(tmig_a[i])
            arrival = float(vm.arrival)
            dep = arrival + float(vm.lifetime)
            self._cores.append(c)
            self._local.append(l)
            self._pool.append(p)
            self._mem.append(m)
            self._slot_of.append(-1)
            self._exact = self._exact and c.is_integer() \
                and m.is_integer() and l.is_integer() and p.is_integer()
            self._pay_mem_max = max(self._pay_mem_max, m, l)
            self._pay_pool_max = max(self._pay_pool_max, p)
            t_min = min(t_min, arrival)
            self._t_seen = max(self._t_seen, arrival)
            self._pend_t.append(arrival)
            self._pend_k.append(ARRIVE)
            self._pend_v.append(v)
            # MIGRATE events outside [arrival, departure) are no-ops in
            # the oracle and are dropped, like the monolithic compile
            if t_mig is not None and arrival <= t_mig < dep:
                self._has_migrate = True
                self._pend_t.append(float(t_mig))
                self._pend_k.append(MIGRATE)
                self._pend_v.append(v)
            self._pend_t.append(dep)
            self._pend_k.append(DEPART)
            self._pend_v.append(v)
        if t_min < self._t_flushed:
            raise ValueError(
                f"chunk arrivals must be non-decreasing across chunks: "
                f"got {t_min:g} after events were compiled up to "
                f"{self._t_flushed:g} (sort the trace by arrival)")
        self._flush(self._t_seen)

    def _flush(self, t_max: float, final: bool = False) -> None:
        """Compile every pending event strictly before ``t_max`` (all of
        them when ``final``) in the monolithic (time, kind, vm) order."""
        if not self._pend_t:
            return
        t = np.asarray(self._pend_t)
        k = np.asarray(self._pend_k, np.int64)
        v = np.asarray(self._pend_v, np.int64)
        if final:
            take = np.ones(len(t), bool)
        else:
            take = t < t_max
            self._t_flushed = max(self._t_flushed, t_max)
        if not take.any():
            return
        ts, ks, vs = t[take], k[take], v[take]
        order = np.lexsort((vs, ks, ts))
        self._emit(ks[order].tolist(), vs[order].tolist())
        keep = ~take
        self._pend_t = t[keep].tolist()
        self._pend_k = k[keep].tolist()
        self._pend_v = v[keep].tolist()

    def _emit(self, kinds, vidx) -> None:
        buf = self._buf
        budget = self.max_events_per_shard
        for k, v in zip(kinds, vidx):
            if k == ARRIVE:
                if self._free_slots:
                    sl = self._free_slots.pop()
                else:
                    sl = self._next_slot
                    self._next_slot += 1
                self._slot_of[v] = sl
                self._pool_cum += self._pool[v]
                self._peak_pool = max(self._peak_pool, self._pool_cum)
            else:
                sl = self._slot_of[v]
                if k == DEPART:
                    self._free_slots.append(sl)
                    self._pool_cum -= self._pool[v]
                else:                         # MIGRATE (int16 pool bound)
                    self._mig_pool_sum += self._pool[v]
            buf["kind"].append(k)
            buf["slot"].append(sl)
            buf["c"].append(self._cores[v])
            buf["l"].append(self._local[v])
            buf["p"].append(self._pool[v])
            buf["m"].append(self._mem[v])
            self.n_events += 1
            if len(buf["kind"]) == budget:
                self._close_shard()

    def _close_shard(self) -> None:
        b = self._buf
        if not b["kind"]:
            return
        self._shards.append({
            "kind": np.asarray(b["kind"], np.int32),
            "slot": np.asarray(b["slot"], np.int32),
            "c": np.asarray(b["c"]), "l": np.asarray(b["l"]),
            "p": np.asarray(b["p"]), "m": np.asarray(b["m"])})
        for key in b:        # reset in place: _emit holds a reference
            b[key] = []

    def _finish(self) -> None:
        self._flush(_INF, final=True)
        self._close_shard()
        self.n_shards = len(self._shards)
        self._n_slots = sweep_core.pad_up(self._next_slot,
                                          sweep_core.SLOT_PAD)
        #: each shard's true event count: the launches take these, not
        #: ``shard_pad_events``
        self._shard_events = [len(s["kind"]) for s in self._shards]
        longest = max(self._shard_events, default=0)
        self.shard_pad_events = sweep_core.pad_up(longest,
                                                  sweep_core.EVENT_PAD)
        #: the reference's per-sweep footprint of one shard's event tensor
        #: (6 int32 streams of ``shard_pad_events``) — THE quantity
        #: max_events_per_shard bounds; a device sweep holds two shards of
        #: at most that
        self.peak_shard_bytes = 6 * 4 * self.shard_pad_events
        rec = obs.get_recorder()
        if rec.enabled and self.n_shards:
            used = sum(self._shard_events)
            rec.count("pad.events_used", used)
            rec.count("pad.events_padded",
                      self.n_shards * self.shard_pad_events - used)
        for s in self._shards:           # pad in place, once, as the
            n = len(s["kind"])           # reference does
            pad = self.shard_pad_events - n
            if pad:
                s["kind"] = np.concatenate(
                    [s["kind"], np.full(pad, PAD, np.int32)])
                s["slot"] = np.concatenate(
                    [s["slot"], np.zeros(pad, np.int32)])
                for key in ("c", "l", "p", "m"):
                    s[key] = np.concatenate([s[key], np.zeros(pad)])
            if self._exact:
                # integral payloads: int32 once, as the device takes them
                # (the numpy backend computes the same float64 results)
                for key in ("c", "l", "p", "m"):
                    s[key] = s[key].astype(np.int32)

    # -------------------------------------------------------------- query --
    def peak_pool_demand(self) -> float:
        """Naive concurrent pool demand peak over the compiled event order
        (same bound as ``CompiledReplay.peak_pool_demand``): a feasible
        upper bracket for any pool search."""
        return float(self._peak_pool)

    # the int16 packing rules are the monolithic engine's (they read only
    # the cluster shape and payload maxima, which this class mirrors)
    _pick_state_dtype = CompiledReplay._pick_state_dtype
    _pick_pod_state_dtype = CompiledReplay._pick_pod_state_dtype

    @obs.traced("stream.reject_rates")
    def reject_rates(self, server_gb, pool_gb,
                     reject_cap: int | None = None,
                     backend: str = "auto",
                     state_dtype: str | None = None,
                     checkpoint: "CheckpointSpec | None" = None,
                     devices=None,
                     skip_windows: bool = True) -> np.ndarray:
        """Reject fraction per candidate, streamed shard by shard.

        Same contract and broadcasting as
        :meth:`CompiledReplay.reject_rates`.  ``backend="torch"`` (``"auto"``
        for integral decisions) keeps the state on the engine's device and
        prices every candidate with one K1 launch a shard, shard i + 1
        uploading (pinned host buffers, a side CUDA stream) while shard i
        computes; ``"numpy"`` (``"auto"`` otherwise) runs the float64 host
        shard sweep.  With ``reject_cap`` set the stream stops early once
        EVERY candidate exceeds the cap (each reported rate is then its
        exact count so far — a lower bound at or above ``(reject_cap + 1)
        / n_vms``, the same feasibility-test contract as the other
        engines); it is the only read-back a shard makes.
        ``skip_windows`` (default on) starts the sweep at the first shard
        where some lane's capacity can bind, from the reference
        replay's boundary snapshot (:func:`_stream_reference`): bit-exact
        against the unskipped sweep without ``reject_cap``.

        ``checkpoint`` (a :class:`CheckpointSpec`) snapshots the state and
        the shard cursor every N shard sweeps and, with ``resume=True``,
        goes on from an interrupted sweep: resumed results are identical
        to an uninterrupted run, both backends.  Under
        ``POND_DEBUG_INVARIANTS=1`` the state is verified after every
        shard (``sweep_core.check_invariants``).  ``devices`` splits the
        torch backend's candidate lanes over the devices
        (:func:`sweep_core.lane_plan`), each piece streaming every shard
        with its own state (and its own checkpoint file, ``<path>.d<j>``),
        the pieces taking turns a shard at a time (:func:`_run_pieces`):
        ``==`` the single-device sweep without ``reject_cap``; under a cap
        each piece stops once its own lanes pass it (the same feasibility
        contract).

        Usage::

            stream = CompiledReplayStream(vms, decisions, cfg,
                                          max_events_per_shard=65_536)
            rates = stream.reject_rates(
                np.linspace(200., 400., 9), np.linspace(0., 800., 9))
        """
        t0 = time.perf_counter()
        server_gb = np.atleast_1d(np.asarray(server_gb, float))
        pool_gb = np.atleast_1d(np.asarray(pool_gb, float))
        server_gb, pool_gb = np.broadcast_arrays(server_gb, pool_gb)
        n0 = len(server_gb)
        if not self.n_events:
            return np.zeros(n0)
        if _choose_backend(backend, self._exact) == "torch":
            plan = _lanes(devices, self.device, n0)
            dt_name = state_dtype or self._pick_state_dtype(
                *sweep_core.quantize_capacities(server_gb, pool_gb))
            pieces = _run_pieces([
                (self._on_device(dev), self._sweep_steps(
                    server_gb[lo:hi], pool_gb[lo:hi], reject_cap, dt_name,
                    _piece_checkpoint(checkpoint, j, len(plan)),
                    skip_windows, dev))
                for j, (dev, lo, hi) in enumerate(plan)])
            rejects = _gather([rej for rej, _ in pieces])
            cand_events = sum(n for _, n in pieces)
        else:
            rejects, cand_events = self._sweep_numpy(
                server_gb, pool_gb, reject_cap, checkpoint)
        _STATS.sweeps += 1
        _STATS.events += self.n_events
        _STATS.candidate_events += cand_events
        _STATS.wall_s += time.perf_counter() - t0
        _TIMES.sweep_s += time.perf_counter() - t0
        return rejects / max(self.n_vms, 1)

    def _fingerprint(self, backend, dt_name, reject_cap, server_gb,
                     pool_gb) -> str:
        return _sweep_fingerprint(backend, dt_name, self.n_events,
                                  self.n_shards, self.n_vms, reject_cap,
                                  server_gb, pool_gb)

    def _debug_check_events(self) -> None:
        for si, shard in enumerate(self._shards):
            sweep_core.check_event_tensors(shard, si, self._n_slots)

    def _debug_check_carry(self, fc, um, up, si: int) -> None:
        sweep_core.check_invariants(
            np.asarray(fc), np.asarray(um), np.asarray(up),
            n_servers=self.n_servers,
            cores_per_server=self.cores_per_server, shard=si,
            up_slack=self._mig_pool_sum)

    def _pack(self, si: int, buf):
        """:class:`_ShardFeed`'s packer: shard ``si``'s true events."""
        n = self._shard_events[si]
        _pack_rows(buf, 0, self._shards[si], n)
        return n, None

    def _feed(self, device: torch.device | None = None) -> _ShardFeed:
        return _ShardFeed(self._pack, sweep_core.pad_up(
            max(self._shard_events, default=0), 4), device or self.device)

    def _sweep_device(self, server_gb, pool_gb, reject_cap, state_dtype,
                      ckpt=None, skip_windows=True, device=None):
        """K1 a shard over the whole candidate batch, the state on the
        engine's device (or on ``device``, a piece of a split sweep) from
        the first shard to the last.  Returns ``(the reject counters on
        the device, candidate events)`` without a sync of its own (unless
        ``reject_cap``, a checkpoint or the invariant guard reads the
        state); the candidate events count the true lanes of each swept
        shard (the reference counts its padded bucket)."""
        return _run_pieces([(self._on_device(device), self._sweep_steps(
            server_gb, pool_gb, reject_cap, state_dtype, ckpt, skip_windows,
            device))])[0]

    def _on_device(self, device):
        """The device a piece runs on: ``device``, or the stream's own."""
        return self.device if device is None else device

    def _sweep_steps(self, server_gb, pool_gb, reject_cap, state_dtype,
                     ckpt, skip_windows, device):
        """:meth:`_sweep_device`'s shard loop, a generator for
        :func:`_run_pieces`."""
        dev = self._on_device(device)
        n0 = len(server_gb)
        sgb_i, pgb_i = sweep_core.quantize_capacities(server_gb, pool_gb)
        dt_name = state_dtype or self._pick_state_dtype(sgb_i, pgb_i)
        np_dt = sweep_core.state_np_dtype(dt_name)
        ref = _stream_reference(self) if skip_windows else None
        io, st = _checkpoint_io(ckpt, self._fingerprint(
            "torch", dt_name, reject_cap, server_gb, pool_gb))
        if st is not None:
            shard_from = int(st["shard_idx"])
            carry0 = tuple(st[f"carry{j}"] for j in range(5))
            io.shards_done = int(st["shards_done"])
        elif ref is not None:
            # divergence window: every lane provably replays the
            # reference through these leading shards — start from the
            # boundary snapshot instead of sweeping them
            shard_from = _skip_count(ref, sgb_i.min(), pgb_i.min(),
                                     self.n_shards)
            carry0 = _carry_from_snap(ref["snaps"][shard_from], n0,
                                      self.n_servers, self.n_groups,
                                      self._n_slots, np_dt)
            _count_skipped(shard_from, self.shard_pad_events * n0)
        else:
            shard_from = 0
            carry0 = sweep_core.init_state(
                n0, self.n_servers, self.cores_per_server, self.n_servers,
                self.n_groups, self._n_slots, np_dt)
        fc, um, up, slots, rej = _to_device(carry0, dev)
        sgb, pgb = _to_device((sgb_i.astype(np_dt), pgb_i.astype(np_dt)),
                              dev)
        group = _to_device((self.group_of.astype(np.int32),), dev)[0]
        sweep = sweep_core.get_sweep(dt_name, with_carry=True,
                                     device=device)
        debug = sweep_core.invariants_enabled()
        if debug:
            self._debug_check_events()

        def after(si):
            if debug:
                self._debug_check_carry(fc.cpu(), um.cpu(), up.cpu(), si)
            if io is not None:
                io.tick(lambda: {
                    "shard_idx": si + 1, "shards_done": io.shards_done,
                    **{f"carry{j}": t.cpu().numpy() for j, t in
                       enumerate((fc, um, up, slots, rej))}})

        swept = yield from _stream_shards(
            self._feed(dev), shard_from, self.n_shards,
            lambda evs, _: sweep(evs, group, fc, um, up, slots, rej, sgb,
                                 pgb), rej, reject_cap, after)
        _TIMES.sweeps.append((n0, dt_name))
        if io is not None:
            io.done()
        return rej, swept * self.shard_pad_events * n0

    def _sweep_numpy(self, server_gb, pool_gb, reject_cap, ckpt=None):
        """The reference's float64 host shard sweep, copied."""
        n0 = len(server_gb)
        n_srv = self.n_servers
        free = np.empty((n0, n_srv + 1, 3))
        free[:, :n_srv, 0] = self.cores_per_server
        free[:, :n_srv, 1] = server_gb[:, None]
        free[:, :n_srv, 2] = pool_gb[:, None]
        free[:, n_srv, :] = -_INF
        placed = np.full((n0, self._n_slots), -1, np.int32)
        migrated = np.zeros((n0, self._n_slots), bool)
        rejects = np.zeros(n0, np.int64)
        cand_events = 0
        io, st = _checkpoint_io(ckpt, self._fingerprint(
            "numpy", "float64", reject_cap, server_gb, pool_gb))
        start_shard = 0
        if st is not None:
            free, placed, migrated = (st["free"], st["placed"],
                                      st["migrated"])
            rejects = st["rejects"]
            start_shard = int(st["shard_idx"])
            io.shards_done = int(st["shards_done"])
        debug = sweep_core.invariants_enabled()
        if debug:
            self._debug_check_events()
            # representative server per group: every member mirrors the
            # group's free pool, so column 2 of the first member IS it
            firsts = np.unique(self.group_of, return_index=True)[1]
        rec = obs.get_recorder()
        for si in range(start_shard, self.n_shards):
            shard = self._shards[si]
            with rec.span("stream.shard", shard=si, backend="numpy"):
                _np_stream_sweep(shard, self._gcols, free, placed,
                                 migrated, rejects)
            cand_events += len(shard["kind"]) * n0
            if debug:
                self._debug_check_carry(
                    free[:, :n_srv, 0],
                    server_gb[:, None] - free[:, :n_srv, 1],
                    pool_gb[:, None] - free[:, firsts, 2], si)
            if io is not None:
                io.tick(lambda: {
                    "shard_idx": si + 1, "free": free, "placed": placed,
                    "migrated": migrated, "rejects": rejects,
                    "shards_done": io.shards_done})
            if reject_cap is not None and (rejects > reject_cap).all():
                rec.count("stream.reject_cap_exits")
                break
        if io is not None:
            io.done()
        return rejects, cand_events

    # ------------------------------------------------------------- fleet --
    @obs.traced("stream.fleet")
    def reject_rates_fleet(self, server_gb, pod_gb, topology,
                           reject_cap: int | None = None,
                           backend: str = "auto",
                           state_dtype: str | None = None,
                           devices=None) -> np.ndarray:
        """Fleet reject rates, streamed shard by shard.

        Same candidate contract as :meth:`CompiledReplay.reject_rates_fleet`;
        the pod state (the per-pod used pool and the granting-pod slot
        column included) stays on the device from shard to shard, one
        launch of the pod sweep (K4) a shard for the whole grid, its
        incidence checked and its widest thread counted once a call.
        ``backend="numpy"`` (``"auto"`` for non-integral decisions) carries
        the float64 host state instead.  With ``reject_cap`` set the stream
        stops early once EVERY lane exceeds the cap (exact counts so far —
        the usual feasibility-test lower bound).  ``devices`` splits the
        torch backend's lanes as :meth:`reject_rates` does.
        """
        t0 = time.perf_counter()
        sgb, caps, topos = _fleet_candidates(server_gb, pod_gb, topology)
        if topos[0].n_servers != self.n_servers:
            raise ValueError(
                f"topology covers {topos[0].n_servers} servers; stream "
                f"has {self.n_servers}")
        n0 = len(sgb)
        if not self.n_events:
            return np.zeros(n0)
        if _choose_backend(backend, self._exact) == "torch":
            p_max = _fleet_incidence(topos, self.n_servers)[1]
            dt_name = state_dtype or self._pick_pod_state_dtype(
                *_fleet_capacities(sgb, caps), p_max)
            pieces = _run_pieces([
                (self._on_device(dev), self._fleet_sweep_steps(
                    sgb[lo:hi], caps[lo:hi], topos[lo:hi], reject_cap,
                    dt_name, dev, p_max))
                for dev, lo, hi in _lanes(devices, self.device, n0)])
            rejects = _gather([rej for rej, _ in pieces])
            cand_events = sum(n for _, n in pieces)
        else:
            rejects, cand_events = self._fleet_sweep_numpy(
                sgb, caps, topos, reject_cap)
        _STATS.sweeps += 1
        _STATS.events += self.n_events
        _STATS.candidate_events += cand_events
        _STATS.wall_s += time.perf_counter() - t0
        _TIMES.sweep_s += time.perf_counter() - t0
        return rejects / max(self.n_vms, 1)

    def _fleet_sweep_device(self, sgb, caps, topos, reject_cap,
                            state_dtype, device=None, p_max=None):
        """K4 a shard over the whole fleet grid; returns ``(the reject
        counters on the device, candidate events)`` as
        :meth:`_sweep_device` does (a piece of a split sweep passes its
        ``device`` and the whole grid's ``p_max``)."""
        return _run_pieces([(self._on_device(device), self._fleet_sweep_steps(
            sgb, caps, topos, reject_cap, state_dtype, device, p_max))])[0]

    def _fleet_sweep_steps(self, sgb, caps, topos, reject_cap, state_dtype,
                           device, p_max):
        """:meth:`_fleet_sweep_device`'s shard loop, a generator for
        :func:`_run_pieces`."""
        dev = self._on_device(device)
        n0 = len(sgb)
        inc, p_own = _fleet_incidence(topos, self.n_servers)
        p_max = p_own if p_max is None else p_max
        sgb_i, caps_i = _fleet_capacities(sgb, caps)
        dt_name = state_dtype or self._pick_pod_state_dtype(sgb_i, caps_i,
                                                            p_max)
        np_dt = sweep_core.state_np_dtype(dt_name)
        fc, um, up, slots, pods, rej = _to_device(
            sweep_core.init_pod_state(n0, self.n_servers,
                                      self.cores_per_server, self.n_servers,
                                      p_max, self._n_slots, np_dt),
            dev)
        sgb_t, pgb_t, inc_t = _to_device(
            (sgb_i.astype(np_dt), caps_i.astype(np_dt), inc), dev)
        widest = _widest(inc, p_max, dev)
        sweep = sweep_core.get_pod_sweep(dt_name, with_carry=True,
                                         device=device)
        swept = yield from _stream_shards(
            self._feed(dev), 0, self.n_shards,
            lambda evs, _: sweep(evs, inc_t, fc, um, up, slots, pods, rej,
                                 sgb_t, pgb_t, widest=widest),
            rej, reject_cap, span="stream.fleet.shard")
        _TIMES.sweeps.append((n0, dt_name))
        return rej, swept * self.shard_pad_events * n0

    def _fleet_sweep_numpy(self, sgb, caps, topos, reject_cap):
        n0 = len(sgb)
        inc, _ = _fleet_incidence(topos, self.n_servers)
        state = _np_fleet_state(n0, self.n_servers, self.cores_per_server,
                                sgb, caps, self._n_slots)
        cand_events = 0
        rec = obs.get_recorder()
        for si in range(self.n_shards):
            shard = self._shards[si]
            with rec.span("stream.fleet.shard", shard=si, backend="numpy"):
                _np_fleet_sweep(shard, inc, *state)
            cand_events += len(shard["kind"]) * n0
            if reject_cap is not None and (state[-1] > reject_cap).all():
                rec.count("stream.reject_cap_exits")
                break
        return state[-1], cand_events


def _widest(inc: np.ndarray, n_pods: int, device: torch.device):
    """A fleet stream's incidence grid checked and its widest thread
    counted once a call, on the host (``pod_ops.check_incidence``: no sync
    and no memory on the card), for every shard's K4 launch on ``device``;
    None on the CPU, where the wrapper checks each launch.  A batch's
    tiled copies of the grid have the same widest thread."""
    if device.type != "cuda":
        return None
    return pod_ops.check_incidence(torch.from_numpy(inc), n_pods)


def _count_skipped(shards: int, events_a_shard: int) -> None:
    """The divergence-window skip's counters: ``stream.shards_skipped``
    and ``stream.events_skipped`` (shards x padded shard length x the
    launch's lanes; the reference counts its padded candidate bucket)."""
    rec = obs.get_recorder()
    if shards and rec.enabled:
        rec.count("stream.shards_skipped", shards)
        rec.count("stream.events_skipped", shards * events_a_shard)


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

    def __init__(self, engines, device=None):
        """``device``: where the batch's sweeps run (default: its
        engines'); a split launch's rows (``devices=``) are batches of
        their own on their devices."""
        _validate_cluster_shape(engines, "CompiledReplayBatch")
        e0 = engines[0]
        self.engines = list(engines)
        self.k = len(engines)
        self.device = e0.device if device is None else device
        self.n_servers = e0.n_servers
        self.n_groups = e0.n_groups
        self.cores_per_server = e0.cores_per_server
        self.n_vms = np.array([e.n_vms for e in engines], np.int64)
        self.n_events = np.array([e.n_events for e in engines], np.int64)
        self._exact = all(e._exact for e in engines)
        self._dev_ev = {}             # device -> uploaded events
        self._dev_ev_fail = None
        self._rows = {}               # (lo, hi, device) -> row batch

    def _device_events(self, device=None):
        """``(events, group_of, n_slots, trace_events)``: every trace's
        slot-mapped event arrays one after another (PAD events fill the
        gaps up to each multiple of 4), ``group_of``, the largest trace's
        slot count and the traces' event counts; uploaded once a device
        (the batch's, or ``device``: a piece of a lane split)."""
        device = self.device if device is None else device
        if device in self._dev_ev:
            return self._dev_ev[device]
        t0 = time.perf_counter()
        per = [e._host_events() for e in self.engines]
        cols, counts = pack_traces([host for host, _ in per])
        cols = tuple(sweep_core.device_put(c.numpy(), device)
                     for c in cols)
        group = sweep_core.device_put(
            self.engines[0].group_of.astype(np.int32), device)
        self._dev_ev[device] = (cols, group, max(n for _, n in per), counts)
        _TIMES.compile_s += time.perf_counter() - t0
        return self._dev_ev[device]

    def _split(self, devices, n0: int):
        """A launch's pieces: ``("rows", [(row batch, lo, hi), ...])`` when
        ``devices`` resolves to at least two devices and no more than the
        traces (each piece a batch of its own over traces ``lo:hi`` on its
        device, built once), else ``("lanes", [(device, lo, hi), ...])``
        (:func:`_lanes`: the single-device path is one piece)."""
        devs = sweep_core.resolve_devices(devices, self.device)
        if devs is not None and self.k >= len(devs):
            return "rows", [(self._row_batch(lo, hi, dev), lo, hi)
                            for dev, lo, hi in sweep_core.row_plan(self.k,
                                                                   devs)]
        return "lanes", _lanes(devs, self.device, n0)

    def _upload(self, split) -> None:
        """Every piece's events on its device (the compile-and-upload
        stage, timed apart from the sweep)."""
        for piece, _, _ in split[1]:
            if split[0] == "rows":
                piece._device_events()
            else:
                self._device_events(piece)

    def _row_batch(self, lo: int, hi: int, device):
        key = (lo, hi, device)
        if key not in self._rows:
            self._rows[key] = type(self)(self.engines[lo:hi],
                                         device=device)
        return self._rows[key]

    def _rejects_device(self, server_gb, pool_gb, dt_name: str,
                        device=None) -> list:
        """K1's trace axis over every (trace, candidate) lane, one launch a
        ``kernel.MAX_TRACES`` traces, on the batch's device (or on
        ``device``, a piece of a split launch, which keys the launcher);
        returns each launch's reject counters there as a ``(traces,
        n_cand)`` tensor, without a sync."""
        evs, group_of, n_slots, counts = self._device_events(device)
        dev = self.device if device is None else device
        n0 = server_gb.shape[1]
        starts = trace_starts(counts)
        sgb_i, pgb_i = sweep_core.quantize_capacities(server_gb, pool_gb)
        np_dt = sweep_core.state_np_dtype(dt_name)
        sweep = sweep_core.get_sweep(dt_name, batched=True, device=device)
        out = []
        for lo in range(0, self.k, K1.MAX_TRACES):
            hi = min(self.k, lo + K1.MAX_TRACES)
            width = (hi - lo) * n0
            state = sweep_core.init_state(
                width, self.n_servers, self.cores_per_server,
                self.n_servers, self.n_groups, n_slots, np_dt)[:4]
            fc, um, up, slots = (sweep_core.device_put(a, dev)
                                 for a in state)
            sgb, pgb = (sweep_core.device_put(
                a[lo:hi].reshape(-1).astype(np_dt), dev)
                for a in (sgb_i, pgb_i))
            rej = sweep(tuple(e[starts[lo]:] for e in evs), group_of, fc,
                        um, up, slots, sgb, pgb, counts[lo:hi])
            out.append(rej.reshape(hi - lo, n0))
            _TIMES.sweeps.append((width, dt_name))
        return out

    def _pick_state_dtype(self, sgb_i: np.ndarray,
                          pgb_i: np.ndarray) -> str:
        return _batch_pick_state_dtype(self.engines, sgb_i, pgb_i)

    @obs.traced("batch.reject_rates")
    def reject_rates(self, server_gb, pool_gb,
                     reject_cap: int | None = None,
                     backend: str = "auto",
                     state_dtype: str | None = None,
                     devices=None) -> np.ndarray:
        """Reject fraction per (trace, candidate): shape ``(K, n_cand)``.

        ``server_gb``/``pool_gb`` broadcast like the single-trace API and
        also take ``(K, n_cand)`` per-trace candidate grids.
        ``backend="torch"`` is one launch of K1 for every trace's
        candidates (one a ``kernel.MAX_TRACES`` traces); the state packs
        to int16 when every trace's capacities permit, and ``state_dtype``
        forces one packing (testing hook); it returns exact rates, so
        ``reject_cap`` is ignored there.  ``"auto"`` takes it when every
        trace's decisions are integral, and otherwise asks each engine in
        turn (its own ``"auto"``: the numpy divergence-window sweep for a
        non-integral trace, which honours ``reject_cap``); ``"numpy"``
        loops the engines' numpy sweep.  ``devices`` splits the torch
        backend's sweep (:meth:`_split`): the trace rows over the devices
        when there are at least as many traces, else the candidate lanes;
        ``==`` the single-device launch.
        """
        server_gb, pool_gb = _broadcast_candidates(self.k, server_gb,
                                                   pool_gb)
        n0 = server_gb.shape[1]
        if backend != "auto" or self._exact:
            backend = _choose_backend(backend, self._exact)
        if backend != "torch":
            # each engine in turn: "auto" lets an integral trace of a mixed
            # batch take its own K1 launch, as the reference's does
            return np.stack([
                eng.reject_rates(server_gb[i], pool_gb[i],
                                 reject_cap=reject_cap, backend=backend)
                for i, eng in enumerate(self.engines)])
        if not self.n_events.any():
            return np.zeros((self.k, n0))
        split = self._split(devices, n0)
        self._upload(split)         # compile + upload: its own stage
        t0 = time.perf_counter()
        dt_name = state_dtype or self._pick_state_dtype(
            *sweep_core.quantize_capacities(server_gb, pool_gb))
        if split[0] == "rows":
            rejects = _gather([r for rows, lo, hi in split[1]
                               for r in rows._rejects_device(
                                   server_gb[lo:hi], pool_gb[lo:hi],
                                   dt_name, rows.device)], axis=0)
        else:
            pieces = [self._rejects_device(server_gb[:, lo:hi],
                                           pool_gb[:, lo:hi], dt_name, dev)
                      for dev, lo, hi in split[1]]
            rejects = np.concatenate([_gather(p, axis=0) for p in pieces],
                                     axis=1)
        rates = rejects / np.maximum(self.n_vms, 1)[:, None]
        _STATS.sweeps += 1
        _STATS.events += int(self.n_events.max(initial=0))
        _STATS.candidate_events += int(self.n_events.sum()) * n0
        _STATS.wall_s += time.perf_counter() - t0
        _TIMES.sweep_s += time.perf_counter() - t0
        return rates

    def _device_events_fail(self):
        """``(events, group_of, n_slots, trace_events)`` for the failure
        sweep: every trace's eight arrays (its own merged schedule) one
        after another, the gaps PAD events with domain -1; uploaded once."""
        if self._dev_ev_fail is not None:
            return self._dev_ev_fail
        t0 = time.perf_counter()
        per = [e._host_events() for e in self.engines]
        cols, counts = pack_traces([host + e._fail_streams() for e, (host, _)
                                    in zip(self.engines, per)],
                                   fills=(PAD, 0, 0, 0, 0, 0, 0, -1))
        cols = tuple(sweep_core.device_put(c.numpy(), self.device)
                     for c in cols)
        group = sweep_core.device_put(
            self.engines[0].group_of.astype(np.int32), self.device)
        self._dev_ev_fail = (cols, group, max(n for _, n in per), counts)
        _TIMES.compile_s += time.perf_counter() - t0
        return self._dev_ev_fail

    @obs.traced("batch.availability")
    def availability(self, server_gb, pool_gb, mitigation: str = "remigrate",
                     backend: str = "auto",
                     state_dtype: str | None = None) -> AvailabilityResult:
        """Failure-priced sweep over all K (trace, schedule) rows at once:
        one launch of K5's trace axis (one a ``kernel.MAX_TRACES`` traces),
        each trace's lanes over its own events and schedule.

        Every engine must carry its own ``failure_schedule`` (rows may
        differ, e.g. one failure rate per row, the
        ``benchmarks/fig_availability.py`` frontier axis).  Returns an
        :class:`AvailabilityResult` whose arrays are ``(K, n_cand)``;
        ``n_failures`` is the per-trace ``(K,)`` count and the per-failure
        distribution is not materialised (use the single-trace
        :meth:`CompiledReplay.availability` for it).  Row ``k`` is bit for
        bit ``engines[k].availability(...)``.  ``backend="oracle"`` loops
        the engines' scalar oracle, and so does ``"auto"`` when a trace's
        decisions are non-integral.
        """
        for i, e in enumerate(self.engines):
            if e.failure_schedule is None:
                raise ValueError(
                    f"engine {i} has no failure_schedule; the batched "
                    "availability sweep needs one per trace")
        _check_mitigation(mitigation)
        server_gb, pool_gb = _broadcast_candidates(self.k, server_gb,
                                                   pool_gb)
        n0 = server_gb.shape[1]
        n_fail = np.array([e.failure_schedule.n_failures
                           for e in self.engines])
        if backend not in ("auto", "oracle"):
            raise ValueError(f"backend must be 'auto' or 'oracle', got "
                             f"{backend!r}")
        if backend == "auto" and not self._exact:
            backend = "oracle"
        if backend == "oracle":
            per = [eng.availability(server_gb[i], pool_gb[i], mitigation,
                                    backend=backend, per_failure=False)
                   for i, eng in enumerate(self.engines)]
            return AvailabilityResult(
                **{f: np.stack([getattr(r, f) for r in per])
                   for f in AVAILABILITY_FIELDS},
                n_failures=n_fail, affected_per_failure=None,
                mitigation=mitigation)
        # compile + upload (its own stage), then the sweep
        evs, group_of, n_slots, counts = self._device_events_fail()
        t0 = time.perf_counter()
        starts = trace_starts(counts)
        sgb_i, pgb_i = sweep_core.quantize_capacities(server_gb, pool_gb)
        dt_name = state_dtype or self._pick_state_dtype(sgb_i, pgb_i)
        np_dt = sweep_core.state_np_dtype(dt_name)
        out = np.empty((5, self.k, n0), np.int64)
        sweep = sweep_core.get_fail_sweep(dt_name, mitigation, batched=True,
                                          with_dist=False)
        for lo in range(0, self.k, K1.MAX_TRACES):
            hi = min(self.k, lo + K1.MAX_TRACES)
            width = (hi - lo) * n0
            state = sweep_core.init_state(
                width, self.n_servers, self.cores_per_server,
                self.n_servers, self.n_groups, max(n_slots, 1), np_dt)[:4]
            state += (sweep_core.init_fail_state(width, self.n_groups),)
            fc, um, up, slots, down = (sweep_core.device_put(a, self.device)
                                       for a in state)
            sgb, pgb = (sweep_core.device_put(
                a[lo:hi].reshape(-1).astype(np_dt), self.device)
                for a in (sgb_i, pgb_i))
            res = sweep(tuple(e[starts[lo]:] for e in evs), group_of, fc, um,
                        up, slots, down, sgb, pgb, counts[lo:hi])
            out[:, lo:hi] = res.cpu().numpy().reshape(5, hi - lo, n0)
            _TIMES.sweeps.append((width, dt_name))
        _STATS.sweeps += 1
        _STATS.events += int(self.n_events.max(initial=0))
        _STATS.candidate_events += int(self.n_events.sum()) * n0
        _STATS.wall_s += time.perf_counter() - t0
        _TIMES.sweep_s += time.perf_counter() - t0
        return _counters_result(out, self.n_vms, n_fail, None, mitigation)

    # ------------------------------------------------------------- fleet --
    @obs.traced("batch.fleet")
    def reject_rates_fleet(self, server_gb, pod_gb, topology,
                           backend: str = "auto",
                           state_dtype: str | None = None,
                           devices=None) -> np.ndarray:
        """Fleet reject rates per (trace, candidate): ``(K, n_cand)``.

        The candidate grid — ``(server_gb, pod capacities, topology)``
        lanes per :func:`_fleet_candidates` — is SHARED across traces
        (one topology frontier, K traces).  ``backend="torch"`` prices
        every (trace, candidate) lane with one launch of K4's trace axis
        (one a ``kernel.MAX_TRACES`` traces; each trace's lanes carry the
        grid's incidence rows); ``"auto"`` takes it when every trace's
        decisions are integral, and otherwise, like ``"numpy"``, asks each
        engine in turn.  The state packs to int16 only when every trace
        allows it; ``state_dtype`` forces one packing (testing hook).  Row
        ``k`` equals ``engines[k].reject_rates_fleet(...)`` bit for bit.
        ``devices`` splits the torch sweep as :meth:`reject_rates` does.
        """
        sgb, caps, topos = _fleet_candidates(server_gb, pod_gb, topology)
        if topos[0].n_servers != self.n_servers:
            raise ValueError(
                f"topology covers {topos[0].n_servers} servers; batch "
                f"has {self.n_servers}")
        n0 = len(sgb)
        if backend == "auto" and self._exact:
            backend = "torch"
        if backend != "torch":
            # trim the dense capacity rows back to each lane's pod count
            per_lane = [caps[i, :t.n_pods] for i, t in enumerate(topos)]
            return np.stack([
                eng.reject_rates_fleet(sgb, per_lane, topos,
                                       backend=backend)
                for eng in self.engines])
        if not self._exact:
            raise NotImplementedError(
                "the pod sweep takes integral decisions; backend='numpy' "
                "prices non-integral ones")
        if not self.n_events.any():
            return np.zeros((self.k, n0))
        split = self._split(devices, n0)
        self._upload(split)         # compile + upload: its own stage
        t0 = time.perf_counter()
        p_max = _fleet_incidence(topos, self.n_servers)[1]
        sgb_i, caps_i = _fleet_capacities(sgb, caps)
        if state_dtype is not None:
            dt_name = state_dtype
        elif all(e._pick_pod_state_dtype(sgb_i, caps_i, p_max) == "int16"
                 for e in self.engines):
            dt_name = "int16"
        else:
            dt_name = "int32"
        if split[0] == "rows":
            rejects = _gather([r for rows, _, _ in split[1]
                               for r in rows._fleet_rejects_device(
                                   sgb, caps, topos, dt_name, p_max,
                                   rows.device)], axis=0)
        else:
            pieces = [self._fleet_rejects_device(
                sgb[lo:hi], caps[lo:hi], topos[lo:hi], dt_name, p_max, dev)
                for dev, lo, hi in split[1]]
            rejects = np.concatenate([_gather(p, axis=0) for p in pieces],
                                     axis=1)
        rates = rejects / np.maximum(self.n_vms, 1)[:, None]
        _STATS.sweeps += 1
        _STATS.events += int(self.n_events.max(initial=0))
        _STATS.candidate_events += int(self.n_events.sum()) * n0
        _STATS.wall_s += time.perf_counter() - t0
        _TIMES.sweep_s += time.perf_counter() - t0
        return rates


    def _fleet_rejects_device(self, sgb, caps, topos, dt_name: str,
                              p_max: int, device=None) -> list:
        """K4's trace axis over every (trace, fleet candidate) lane, one
        launch a ``kernel.MAX_TRACES`` traces, on the batch's device (or on
        ``device``); returns each launch's reject counters there as a
        ``(traces, n_cand)`` tensor, without a sync."""
        evs, _group_of, n_slots, counts = self._device_events(device)
        dev = self.device if device is None else device
        n0 = len(sgb)
        starts = trace_starts(counts)
        inc = _fleet_incidence(topos, self.n_servers)[0]
        sgb_i, caps_i = _fleet_capacities(sgb, caps)
        np_dt = sweep_core.state_np_dtype(dt_name)
        sweep = sweep_core.get_pod_sweep(dt_name, batched=True,
                                         device=device)
        out = []
        for lo in range(0, self.k, K1.MAX_TRACES):
            hi = min(self.k, lo + K1.MAX_TRACES)
            width = (hi - lo) * n0
            state = sweep_core.init_pod_state(
                width, self.n_servers, self.cores_per_server,
                self.n_servers, p_max, max(n_slots, 1), np_dt)[:5]
            fc, um, up, slots, pods = (sweep_core.device_put(a, dev)
                                       for a in state)
            # the shared grid, a copy a trace (trace-major lanes)
            inc_t = sweep_core.device_put(np.tile(inc, (hi - lo, 1, 1)), dev)
            sgb_t = sweep_core.device_put(
                np.tile(sgb_i, hi - lo).astype(np_dt), dev)
            pgb_t = sweep_core.device_put(
                np.tile(caps_i, (hi - lo, 1)).astype(np_dt), dev)
            rej = sweep(tuple(e[starts[lo]:] for e in evs), inc_t, fc, um,
                        up, slots, pods, sgb_t, pgb_t, counts[lo:hi])
            out.append(rej.reshape(hi - lo, n0))
            _TIMES.sweeps.append((width, dt_name))
        return out


class CompiledReplayStreamBatch:
    """K streaming replays priced side by side, one launch a shard.

    Composes the trace axis of :class:`CompiledReplayBatch` with the
    bounded memory of :class:`CompiledReplayStream`: shard ``i`` of every
    stream lies in one set of event arrays, each trace from its
    ``ops.trace_starts`` offset with its own event count (a stream with
    fewer shards contributes no events), and one launch of K1's trace axis
    sweeps every (trace, candidate) lane, the lanes trace-major, the state
    on the device from the first shard to the last.  Streams built with one
    ``max_events_per_shard`` shard on the same event grid, so aligned
    shards cover comparable windows.  At most two shard indices' event
    arrays are on the device (one computing, one uploading): within ``2 *
    peak_shard_bytes``, ``peak_shard_bytes = K * 6 * 4 *
    shard_pad_events`` as the reference's.

    Bit-exactness contract: row ``k`` of :meth:`reject_rates` equals
    ``streams[k].reject_rates(...)`` — and hence the monolithic
    :class:`CompiledReplay` — bit for bit.

    Usage::

        streams = [CompiledReplayStream(vms_k, dec_k, cfg,
                                        max_events_per_shard=250_000)
                   for ...]
        batch = CompiledReplayStreamBatch(streams)
        rates = batch.reject_rates([300., 350.], [512., 256.])  # (K, 2)

    ``cluster_sim.savings_analysis_batched`` builds this once any trace of
    a batch runs past its ``max_events_per_shard`` budget, and the
    lockstep searches (``search_min_multi``/``pool_search_multi``) take it
    unchanged.  A batch holds at most ``K1.MAX_TRACES`` streams (one
    launch a shard).
    """

    def __init__(self, streams, device=None):
        """``device``: where the batch's sweeps run (default: its
        streams'); a split sweep's rows (``devices=``) are batches of their
        own on their devices."""
        _validate_cluster_shape(streams, "CompiledReplayStreamBatch")
        if len(streams) > K1.MAX_TRACES:
            raise ValueError(f"a stream batch holds at most "
                             f"{K1.MAX_TRACES} streams (one launch a "
                             f"shard); got {len(streams)}")
        s0 = streams[0]
        self.engines = list(streams)           # searches read .engines
        self.k = len(streams)
        self.device = s0.device if device is None else device
        self.n_servers = s0.n_servers
        self.n_groups = s0.n_groups
        self.group_of = s0.group_of
        self.cores_per_server = s0.cores_per_server
        self.n_vms = np.array([s.n_vms for s in streams], np.int64)
        self.n_events = np.array([s.n_events for s in streams], np.int64)
        self._exact = all(s._exact for s in streams)
        self.n_shards = max((s.n_shards for s in streams), default=0)
        self.shard_pad_events = max(
            (s.shard_pad_events for s in streams if s.n_shards), default=0)
        #: the reference's footprint of ONE stacked shard batch (6 int32
        #: streams x K traces) — THE quantity the batch bounds
        self.peak_shard_bytes = self.k * 6 * 4 * self.shard_pad_events
        self._n_slots = max(s._n_slots for s in streams)
        self._rows = {}               # (lo, hi, device) -> row batch

    _split = CompiledReplayBatch._split
    _row_batch = CompiledReplayBatch._row_batch

    def peak_pool_demand(self) -> np.ndarray:
        """Per-trace naive concurrent pool-demand peak (feasible upper
        bracket for the lockstep pool searches)."""
        return np.array([s.peak_pool_demand() for s in self.engines])

    def _pick_state_dtype(self, sgb_i: np.ndarray,
                          pgb_i: np.ndarray) -> str:
        return _batch_pick_state_dtype(self.engines, sgb_i, pgb_i)

    def _counts(self, si: int) -> list[int]:
        """Each trace's true events in shard ``si`` (0 past its last)."""
        return [s._shard_events[si] if si < s.n_shards else 0
                for s in self.engines]

    def _pack(self, si: int, buf):
        """:class:`_ShardFeed`'s packer: shard ``si`` of every stream, one
        after another (``ops.trace_starts``)."""
        counts = self._counts(si)
        at = 0
        for s, n in zip(self.engines, counts):
            if n:
                at = _pack_rows(buf, at, s._shards[si], n)
        return at, counts

    def _feed(self, device: torch.device | None = None) -> _ShardFeed:
        rows = max((trace_starts(self._counts(si) + [0])[-1]
                    for si in range(self.n_shards)), default=0)
        return _ShardFeed(self._pack, rows, device or self.device)

    def _carry_from_snaps(self, refs, boundary, width, np_dt):
        """Per-trace state at a shard boundary, the lanes trace-major: each
        trace's lanes hold its stream's reference snapshot (clamped to the
        stream's own shard count — a shorter stream's trailing shards hold
        no events)."""
        rows = [_carry_from_snap(
            refs[i]["snaps"][min(boundary, s.n_shards)], width,
            self.n_servers, self.n_groups, self._n_slots, np_dt)
            for i, s in enumerate(self.engines)]
        return tuple(np.concatenate([r[j] for r in rows],
                                    axis=1 if j == 3 else 0)
                     for j in range(5))

    @obs.traced("stream_batch.reject_rates")
    def reject_rates(self, server_gb, pool_gb,
                     reject_cap: int | None = None,
                     backend: str = "auto",
                     state_dtype: str | None = None,
                     checkpoint: "CheckpointSpec | None" = None,
                     devices=None,
                     skip_windows: bool = True) -> np.ndarray:
        """Reject fraction per (trace, candidate): shape ``(K, n_cand)``.

        Candidates broadcast like :meth:`CompiledReplayBatch.reject_rates`
        (1-D shared or ``(K, n_cand)`` per-trace grids).  One launch a
        shard prices every trace's candidates.  With ``reject_cap`` set the
        stream stops early once EVERY (trace, candidate) lane exceeds the
        cap — each reported rate is then its exact count so far, a lower
        bound satisfying the usual feasibility-test contract (callers pass
        a cap covering every trace's tolerance, ``max_i floor(tol_i *
        n_vms_i)``).  ``backend="numpy"`` (or non-integral decisions) asks
        each stream's float64 host sweep in turn: the same rates.
        ``skip_windows`` skips leading shards on which no (trace,
        candidate) lane can diverge from its stream's reference replay.
        ``checkpoint`` snapshots the batched state and cursor like the
        single stream (the numpy backend derives one spec a row,
        ``<path>.k<i>``); ``POND_DEBUG_INVARIANTS=1`` verifies the
        per-trace state after every shard.  ``devices`` splits the torch
        sweep as :meth:`CompiledReplayBatch.reject_rates` does, each piece
        streaming every shard with its own state (and its own checkpoint
        file, ``<path>.d<j>``), the pieces taking turns a shard at a time:
        ``==`` the single-device sweep without
        ``reject_cap``; under a cap each piece stops once its own lanes
        pass it (the same feasibility contract).
        """
        t0 = time.perf_counter()
        server_gb, pool_gb = _broadcast_candidates(self.k, server_gb,
                                                   pool_gb)
        n0 = server_gb.shape[1]
        if not self.n_shards:
            return np.zeros((self.k, n0))
        if backend == "auto":
            backend = "torch" if self._exact else "numpy"
        if backend != "torch":
            return np.stack([
                s.reject_rates(server_gb[i], pool_gb[i],
                               reject_cap=reject_cap, backend=backend,
                               checkpoint=None if checkpoint is None
                               else dataclasses.replace(
                                   checkpoint,
                                   path=f"{checkpoint.path}.k{i}"))
                for i, s in enumerate(self.engines)])
        if not self._exact:
            raise NotImplementedError(
                "the device sweeps take integral decisions; "
                "backend='numpy' prices non-integral ones")
        split = self._split(devices, n0)
        dt_name = state_dtype or self._pick_state_dtype(
            *sweep_core.quantize_capacities(server_gb, pool_gb))
        if split[0] == "rows":
            pieces = _run_pieces([
                (rows.device, rows._sweep_steps(
                    server_gb[lo:hi], pool_gb[lo:hi], reject_cap, dt_name,
                    _piece_checkpoint(checkpoint, j, len(split[1])),
                    skip_windows, rows.device))
                for j, (rows, lo, hi) in enumerate(split[1])])
            rejects = _gather([rej.reshape(-1, n0) for rej, _ in pieces],
                              axis=0)
        else:
            pieces = _run_pieces([
                (self._on_device(dev), self._sweep_steps(
                    server_gb[:, lo:hi], pool_gb[:, lo:hi], reject_cap,
                    dt_name, _piece_checkpoint(checkpoint, j, len(split[1])),
                    skip_windows, dev))
                for j, (dev, lo, hi) in enumerate(split[1])])
            rejects = _gather([rej.reshape(self.k, -1) for rej, _ in pieces],
                              axis=1)
        cand_events = sum(n for _, n in pieces)
        rates = rejects / np.maximum(self.n_vms, 1)[:, None]
        _STATS.sweeps += 1
        _STATS.events += int(self.n_events.max(initial=0))
        _STATS.candidate_events += cand_events
        _STATS.wall_s += time.perf_counter() - t0
        _TIMES.sweep_s += time.perf_counter() - t0
        return rates

    def _sweep_device(self, server_gb, pool_gb, reject_cap, state_dtype,
                      checkpoint=None, skip_windows=True, device=None):
        """One launch of K1's trace axis a shard over every (trace,
        candidate) lane, on the batch's device (or on ``device``, a piece
        of a split sweep); returns ``(the reject counters on the device,
        trace-major, candidate events)`` as the single stream's does."""
        return _run_pieces([(self._on_device(device), self._sweep_steps(
            server_gb, pool_gb, reject_cap, state_dtype, checkpoint,
            skip_windows, device))])[0]

    def _on_device(self, device):
        """The device a piece runs on: ``device``, or the batch's own."""
        return self.device if device is None else device

    def _sweep_steps(self, server_gb, pool_gb, reject_cap, state_dtype,
                     checkpoint, skip_windows, device):
        """:meth:`_sweep_device`'s shard loop, a generator for
        :func:`_run_pieces`."""
        dev = self._on_device(device)
        n0 = server_gb.shape[1]
        sgb_i, pgb_i = sweep_core.quantize_capacities(server_gb, pool_gb)
        dt_name = state_dtype or self._pick_state_dtype(sgb_i, pgb_i)
        np_dt = sweep_core.state_np_dtype(dt_name)
        refs = None
        if skip_windows:
            refs = [_stream_reference(s) for s in self.engines]
            if not all(r is not None for r in refs):
                refs = None
        width = self.k * n0
        io, st = _checkpoint_io(checkpoint, _sweep_fingerprint(
            "torch-batch", dt_name, self.n_events, self.n_shards,
            self.n_vms, reject_cap, server_gb, pool_gb))
        if st is not None:
            shard_from = int(st["shard_idx"])
            carry0 = tuple(st[f"carry{j}"] for j in range(5))
            io.shards_done = int(st["shards_done"])
        elif refs is not None:
            shard_from = min(
                _skip_count(r, sgb_i[i].min(), pgb_i[i].min(),
                            self.n_shards)
                for i, r in enumerate(refs))
            carry0 = self._carry_from_snaps(refs, shard_from, n0, np_dt)
            _count_skipped(shard_from, self.shard_pad_events * width)
        else:
            shard_from = 0
            carry0 = sweep_core.init_state(
                width, self.n_servers, self.cores_per_server,
                self.n_servers, self.n_groups, self._n_slots, np_dt)
        fc, um, up, slots, rej = _to_device(carry0, dev)
        sgb, pgb = _to_device((sgb_i.reshape(-1).astype(np_dt),
                               pgb_i.reshape(-1).astype(np_dt)), dev)
        group = _to_device((self.group_of.astype(np.int32),), dev)[0]
        sweep = sweep_core.get_sweep(dt_name, with_carry=True, batched=True,
                                     device=device)
        debug = sweep_core.invariants_enabled()
        if debug:
            for s in self.engines:
                s._debug_check_events()

        def after(si):
            if debug:
                sweep_core.check_invariants(
                    *(t.cpu().numpy().reshape(self.k, n0, -1)
                      for t in (fc, um, up)),
                    n_servers=self.n_servers,
                    cores_per_server=self.cores_per_server, shard=si,
                    up_slack=max(s._mig_pool_sum for s in self.engines))
            if io is not None:
                io.tick(lambda: {
                    "shard_idx": si + 1, "shards_done": io.shards_done,
                    **{f"carry{j}": t.cpu().numpy() for j, t in
                       enumerate((fc, um, up, slots, rej))}})

        swept = yield from _stream_shards(
            self._feed(dev), shard_from, self.n_shards,
            lambda evs, counts: sweep(evs, group, fc, um, up, slots, rej,
                                      sgb, pgb, counts),
            rej, reject_cap, after, span="stream_batch.shard")
        _TIMES.sweeps.append((width, dt_name))
        if io is not None:
            io.done()
        return rej, swept * self.shard_pad_events * width

    # ------------------------------------------------------------- fleet --
    @obs.traced("stream_batch.fleet")
    def reject_rates_fleet(self, server_gb, pod_gb, topology,
                           reject_cap: int | None = None,
                           backend: str = "auto",
                           state_dtype: str | None = None,
                           devices=None) -> np.ndarray:
        """Fleet reject rates per (trace, candidate): ``(K, n_cand)``, one
        launch of K4's trace axis a shard.

        The fleet candidate grid is SHARED across traces (like
        :meth:`CompiledReplayBatch.reject_rates_fleet`; each trace's lanes
        carry the grid's incidence rows, checked once a call); the
        per-trace pod state stays on the device from shard to shard.  Row
        ``k`` equals ``streams[k].reject_rates_fleet(...)`` bit for bit;
        with ``reject_cap`` the stream stops once every (trace, candidate)
        lane exceeds the cap.  ``backend="numpy"`` (or non-integral
        decisions) asks each stream in turn.  ``devices`` splits the torch
        sweep as :meth:`reject_rates` does.
        """
        t0 = time.perf_counter()
        sgb, caps, topos = _fleet_candidates(server_gb, pod_gb, topology)
        if topos[0].n_servers != self.n_servers:
            raise ValueError(
                f"topology covers {topos[0].n_servers} servers; batch "
                f"has {self.n_servers}")
        n0 = len(sgb)
        if not self.n_shards:
            return np.zeros((self.k, n0))
        if backend == "auto":
            backend = "torch" if self._exact else "numpy"
        if backend != "torch":
            # trim the dense capacity rows back to each lane's pod count
            per_lane = [caps[i, :t.n_pods] for i, t in enumerate(topos)]
            return np.stack([
                s.reject_rates_fleet(sgb, per_lane, topos,
                                     reject_cap=reject_cap,
                                     backend=backend)
                for s in self.engines])
        if not self._exact:
            raise NotImplementedError(
                "the pod sweep takes integral decisions; backend='numpy' "
                "prices non-integral ones")
        p_max = _fleet_incidence(topos, self.n_servers)[1]
        sgb_i, caps_i = _fleet_capacities(sgb, caps)
        if state_dtype is not None:
            dt_name = state_dtype
        elif all(s._pick_pod_state_dtype(sgb_i, caps_i, p_max) == "int16"
                 for s in self.engines):
            dt_name = "int16"
        else:
            dt_name = "int32"
        split = self._split(devices, n0)
        if split[0] == "rows":
            pieces = _run_pieces([
                (rows.device, rows._fleet_sweep_steps(
                    sgb, caps, topos, reject_cap, dt_name, p_max,
                    rows.device))
                for rows, _, _ in split[1]])
            rejects = _gather([rej.reshape(-1, n0) for rej, _ in pieces],
                              axis=0)
        else:
            pieces = _run_pieces([
                (self._on_device(dev), self._fleet_sweep_steps(
                    sgb[lo:hi], caps[lo:hi], topos[lo:hi], reject_cap,
                    dt_name, p_max, dev))
                for dev, lo, hi in split[1]])
            rejects = _gather([rej.reshape(self.k, -1) for rej, _ in pieces],
                              axis=1)
        cand_events = sum(n for _, n in pieces)
        rates = rejects / np.maximum(self.n_vms, 1)[:, None]
        _STATS.sweeps += 1
        _STATS.events += int(self.n_events.max(initial=0))
        _STATS.candidate_events += cand_events
        _STATS.wall_s += time.perf_counter() - t0
        _TIMES.sweep_s += time.perf_counter() - t0
        return rates


    def _fleet_sweep_device(self, sgb, caps, topos, reject_cap,
                            dt_name: str, p_max: int, device=None):
        """One launch of K4's trace axis a shard over every (trace, fleet
        candidate) lane, on the batch's device (or on ``device``); returns
        ``(the reject counters on the device, trace-major, candidate
        events)``."""
        return _run_pieces([(self._on_device(device), self._fleet_sweep_steps(
            sgb, caps, topos, reject_cap, dt_name, p_max, device))])[0]

    def _fleet_sweep_steps(self, sgb, caps, topos, reject_cap, dt_name: str,
                           p_max: int, device):
        """:meth:`_fleet_sweep_device`'s shard loop, a generator for
        :func:`_run_pieces`."""
        dev = self._on_device(device)
        n0 = len(sgb)
        inc = _fleet_incidence(topos, self.n_servers)[0]
        sgb_i, caps_i = _fleet_capacities(sgb, caps)
        np_dt = sweep_core.state_np_dtype(dt_name)
        width = self.k * n0
        fc, um, up, slots, pods, rej = _to_device(
            sweep_core.init_pod_state(width, self.n_servers,
                                      self.cores_per_server,
                                      self.n_servers, p_max,
                                      self._n_slots, np_dt), dev)
        # the shared grid, a copy a trace (trace-major lanes)
        sgb_t, pgb_t, inc_t = _to_device(
            (np.tile(sgb_i, self.k).astype(np_dt),
             np.tile(caps_i, (self.k, 1)).astype(np_dt),
             np.tile(inc, (self.k, 1, 1))), dev)
        widest = _widest(inc, p_max, dev)
        sweep = sweep_core.get_pod_sweep(dt_name, with_carry=True,
                                         batched=True, device=device)
        swept = yield from _stream_shards(
            self._feed(dev), 0, self.n_shards,
            lambda evs, counts: sweep(evs, inc_t, fc, um, up, slots,
                                      pods, rej, sgb_t, pgb_t, counts,
                                      widest=widest),
            rej, reject_cap, span="stream_batch.fleet.shard")
        _TIMES.sweeps.append((width, dt_name))
        return rej, swept * self.shard_pad_events * width


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
    return ``big_pool``.

    ``engine`` may also be a :class:`CompiledReplayStream` (the path
    ``savings_analysis`` takes past the shard budget): streams keep no
    trajectories, so the upper bracket is ``peak_pool_demand`` and one
    extra sweep decides which grid points are infeasible outright, like
    the multi-trace search.

    Usage (pool frontier over a server-size grid)::

        grid = np.linspace(min_server, base_gb, 7)
        pool = pool_search_batched(eng, grid, big_pool=12288.0, tol=0.01)
    """
    server_grid = np.asarray(server_grid, float)
    n_pts = len(server_grid)
    denom = max(engine.n_vms, 1)
    lo = np.zeros(n_pts)
    hi = np.empty(n_pts)
    if isinstance(engine, CompiledReplayStream):
        hi[:] = min(float(big_pool), engine.peak_pool_demand())
        infeasible = engine.reject_rates(
            server_grid, hi, reject_cap=reject_cap) > tol
    else:
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

    ``batch`` may be a :class:`CompiledReplayBatch` or a
    :class:`CompiledReplayStreamBatch` — the search only needs
    ``reject_rates`` and each engine's ``peak_pool_demand``.
    ``reject_cap`` (cover every trace's tolerance: ``max_i floor(tol_i *
    n_i)``) lets the streaming batch stop a round's sweep early once every
    lane is decided; the monolithic batch returns exact rates regardless,
    so the probe sequence — and the result — is the same either way.
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
