"""Host side of the event sweep: event kinds, state packing rules, the
all-free initial state and slot assignment.

``CompiledReplay`` prices ``(server_gb, pool_gb)`` candidates with one
integer event sweep (kernel K1, ``kernels/event_sweep``): per trace event
one step over a ``(candidates x servers)`` state.  This module holds what
surrounds the sweep on the host — numpy, copied from the reference's
``core/sweep_core.py``:

* event kinds (PAD, FAIL and RECOVER are no-ops in the plain sweep);
* the int16/int32 packing rules (:func:`pick_state_dtype`): the state
  packs to int16 exactly when no intermediate can overflow;
* :func:`quantize_capacities`, :func:`init_state`, :func:`assign_slots`;
* :func:`get_sweep`, which hands out K1's launcher for a state dtype,
  one trace or a batch of traces (K1's trace axis), with or without the
  reject counters as carried state (the streaming engines' shards), from
  a keyed cache that counts its hits and misses (``core/obs.py``);
* the failure layer's :data:`MITIGATIONS`, :func:`init_fail_state` and
  :func:`get_fail_sweep` (the failure sweep itself is kernel K5,
  ``kernels/fail_sweep``);
* the fleet topologies' :func:`get_pod_sweep`, :func:`pick_pod_state_dtype`
  and :func:`init_pod_state` (the pod sweep is kernel K4,
  ``kernels/pod_sweep``);
* :func:`device_put`, the engines' host-to-card copy, which counts the
  bytes it moves while tracing is on;
* the debug invariant guard (:func:`invariants_enabled`,
  :func:`check_invariants`, :func:`check_event_tensors`) that the
  streaming engines run after every shard under
  ``POND_DEBUG_INVARIANTS=1``.

The reference pads candidates to buckets, events to multiples of 256 and
servers, groups, pods and slots to multiples of 16/16/16/32, so that XLA
compiles rarely.  K1, K4 and K5 take the true counts, so none of that is
carried over (nor the reference's ``candidate_chunks`` and
``pod_lane_arrays``), except where a streaming engine's bookkeeping must
be the reference's (its shard cuts and slot count: :func:`pad_up`,
:data:`EVENT_PAD`, :data:`SLOT_PAD`).
"""
from __future__ import annotations

import os

import numpy as np

from repro_torch.core import obs

ARRIVE, DEPART, MIGRATE = 0, 1, 2
PAD = 3               # no-op event kind (the reference pads with it)
FAIL, RECOVER = 4, 5  # failure-domain events: no-ops in the plain sweep
I32_BIG = 1 << 30     # "infinite" capacity in the int32 sweep
I16_BIG = 1 << 14     # best-fit score sentinel in the int16 sweep
I16_SAFE = 30000      # int16 headroom bound: capacity + payload must fit
EVENT_PAD = 256       # a stream's shard budget and shard length granularity
SLOT_PAD = 32         # a stream's slot count granularity


def pad_up(n: int, m: int) -> int:
    """``n`` rounded up to a multiple of ``m``."""
    return -(-int(n) // m) * m


# ---------------------------------------------------------- launcher caches --
_SWEEPS: dict = {}       # (state_dtype, with_carry, batched) -> K1 launcher
_POD_SWEEPS: dict = {}   # (state_dtype, with_carry, batched) -> K4 launcher
_FAIL_SWEEPS: dict = {}  # (state_dtype, mitigation, batched, with_dist) -> K5


def _jit_key_name(family: str, state_dtype: str, **flags) -> str:
    """Counter-name stem for one launcher-cache key, e.g.
    ``jit.sweep.int32.carry1.batched0`` — the cache accessors append
    ``.hit``/``.miss``; the keyed build/lower spans share the stem (the
    reference's names, so that a port run and a reference run read
    alike)."""
    bits = [f"{k}{int(v)}" if isinstance(v, bool) else str(v)
            for k, v in flags.items()]
    return ".".join(["jit", family, state_dtype] + bits)


class _FirstCallTimer:
    """Times the FIRST invocation of a freshly built launcher as a
    ``jit.<family>.<key>.lower`` span, then delegates with one attribute
    hop.  On the card that first call builds the kernel's library from
    its source, or loads it (``kernels/build.py``: ``build_libraries``,
    ``bind``), and binds its entry point; on the CPU it runs the plain
    version.  Installed only while a recorder is live (cache misses with
    tracing disabled store the bare launcher, so there is no steady-state
    overhead)."""
    __slots__ = ("fn", "name", "_first")

    def __init__(self, fn, name):
        self.fn = fn
        self.name = name
        self._first = True

    def __call__(self, *args, **kwargs):
        if self._first:
            self._first = False
            with obs.get_recorder().span(self.name):
                return self.fn(*args, **kwargs)
        return self.fn(*args, **kwargs)


def _cached(cache: dict, key: tuple, family: str, state_dtype: str,
            flags: dict, build):
    """``cache[key]``, built by ``build()`` on a miss: the reference's
    keyed-cache accessor, with its ``.miss``/``.hit`` counters, ``.build``
    span and first-call ``.lower`` span."""
    fn = cache.get(key)
    rec = obs.get_recorder()
    stem = _jit_key_name(family, state_dtype, **flags)
    if fn is None:
        if rec.enabled:
            rec.count(stem + ".miss")
        with rec.span(stem + ".build"):
            fn = build()
        if rec.enabled:
            fn = _FirstCallTimer(fn, stem + ".lower")
        cache[key] = fn
    elif rec.enabled:
        rec.count(stem + ".hit")
    return fn


def _check_state_dtype(state_dtype: str) -> None:
    if state_dtype not in ("int16", "int32"):
        raise ValueError(f"state_dtype must be 'int16' or 'int32', got "
                         f"{state_dtype!r}")


def _on_device(fn, device):
    """``fn`` run with ``device`` current: a launch reads the current CUDA
    stream and device, so a launch for another card must make that card
    current first.  The CPU needs nothing."""
    if device is None or device.type != "cuda":
        return fn
    import torch

    def on_device(*args, **kwargs):
        with torch.cuda.device(device):
            return fn(*args, **kwargs)
    return on_device


def _cache_key(key: tuple, flags: dict, device):
    """A launcher-cache key and its counter flags, with the device of a
    split launch (:func:`device_plan`) appended: the single-device path
    keeps the reference's keys and names."""
    if device is None:
        return key, flags
    return key + (str(device),), {**flags, "dev": str(device)}


def get_sweep(state_dtype: str = "int32", *, with_carry: bool = False,
              batched: bool = False, device=None):
    """K1's launcher for ``state_dtype``, from the keyed cache: a function
    of ``(events, group_of, fc, um, up, slots, sgb, pgb)`` returning the
    (C,) int32 reject counts and leaving the final state in its state
    arguments (``kernels/event_sweep/ops.py::event_sweep``).  With
    ``batched`` it takes one more argument, ``trace_events``: the event
    counts of the T traces the arrays hold (laid out by
    ``ops.trace_starts``), the lanes trace-major, C / T a trace — the
    reference's vmapped sweep over a trace batch, as one launch.

    With ``with_carry`` the reject counters are carried state too, in the
    reference's carry position: ``(events, group_of, fc, um, up, slots,
    rejects, sgb, pgb)``; the launch adds its rejects into ``rejects`` and
    returns it, so consecutive shards continue one replay (the same
    kernel: K1 always leaves its state in its arguments).

    One cache keyed ``(state_dtype, with_carry, batched)`` serves every
    engine, as the reference's jit cache does.  A split launch
    (``devices=``, :func:`device_plan`) passes its ``device``: the key
    gains it (the reference's mesh part), and the launcher makes that
    device current around each launch.
    With tracing on, a lookup counts ``jit.sweep.<dtype>.carry<0|1>.
    batched<0|1>.miss`` or ``.hit``; a miss builds the launcher in a
    ``.build`` span and times its first call in a ``.lower`` span — on
    the card, the call that builds or loads K1's library
    (``kernels/build.py``).
    """
    _check_state_dtype(state_dtype)
    key, flags = _cache_key((state_dtype, with_carry, batched),
                            dict(carry=with_carry, batched=batched), device)
    return _cached(_SWEEPS, key, "sweep", state_dtype, flags,
                   lambda: _on_device(_build_sweep(with_carry, batched),
                                      device))


def _build_sweep(with_carry: bool, batched: bool):
    from repro_torch.kernels.event_sweep import ops

    if with_carry and batched:
        def sweep_carry_batch(events, group_of, fc, um, up, slots, rejects,
                              sgb, pgb, trace_events):
            return ops.event_sweep(*events, group_of, fc, um, up, slots, sgb,
                                   pgb, rejects, trace_events=trace_events)
        return sweep_carry_batch
    if with_carry:
        def sweep_carry(events, group_of, fc, um, up, slots, rejects, sgb,
                        pgb):
            return ops.event_sweep(*events, group_of, fc, um, up, slots, sgb,
                                   pgb, rejects)
        return sweep_carry
    if batched:
        def sweep_batch(events, group_of, fc, um, up, slots, sgb, pgb,
                        trace_events):
            return ops.event_sweep(*events, group_of, fc, um, up, slots, sgb,
                                   pgb, trace_events=trace_events)
        return sweep_batch

    def sweep(events, group_of, fc, um, up, slots, sgb, pgb):
        return ops.event_sweep(*events, group_of, fc, um, up, slots, sgb,
                               pgb)
    return sweep


def jit_cache_keys() -> list:
    """K1 launcher keys built so far (introspection for tests)."""
    return sorted(_SWEEPS, key=repr)


def get_pod_sweep(state_dtype: str = "int32", *, with_carry: bool = False,
                  batched: bool = False, device=None):
    """K4's launcher for ``state_dtype``, from the keyed cache: a function
    of ``(events, inc, fc, um, up, slots, pods, sgb, pgb)`` returning the
    (C,) int32 reject counts and leaving the final state in its state
    arguments (``kernels/pod_sweep/ops.py::pod_sweep``: K4 for CUDA
    tensors, its plain version for CPU ones).  With ``batched`` it takes
    one more argument, ``trace_events``: K1's trace axis, the lanes
    trace-major, each with its own incidence row (a shared grid is tiled
    by the caller).

    With ``with_carry`` the reject counters are carried state too, in the
    reference's carry position: ``(events, inc, fc, um, up, slots, pods,
    rejects, sgb, pgb)``; the launch adds into ``rejects`` and returns it.
    The carry launchers take the keyword ``widest``: the widest thread's
    distinct pods of an incidence already checked
    (``ops.check_incidence``), so that a stream checks its incidence once a
    call and not once a shard.

    Keyed ``(state_dtype, with_carry, batched)`` (and ``device`` for a
    split launch) with the counters and spans of :func:`get_sweep` under
    ``jit.pod``.
    """
    _check_state_dtype(state_dtype)
    key, flags = _cache_key((state_dtype, with_carry, batched),
                            dict(carry=with_carry, batched=batched), device)
    return _cached(_POD_SWEEPS, key, "pod", state_dtype, flags,
                   lambda: _on_device(_build_pod_sweep(with_carry, batched),
                                      device))


def _build_pod_sweep(with_carry: bool, batched: bool):
    from repro_torch.kernels.pod_sweep import ops

    if with_carry and batched:
        def sweep_carry_batch(events, inc, fc, um, up, slots, pods, rejects,
                              sgb, pgb, trace_events, *, widest=None):
            return ops.pod_sweep(*events, inc, fc, um, up, slots, pods, sgb,
                                 pgb, rejects, trace_events=trace_events,
                                 widest=widest)
        return sweep_carry_batch
    if with_carry:
        def sweep_carry(events, inc, fc, um, up, slots, pods, rejects, sgb,
                        pgb, *, widest=None):
            return ops.pod_sweep(*events, inc, fc, um, up, slots, pods, sgb,
                                 pgb, rejects, widest=widest)
        return sweep_carry
    if batched:
        def sweep_batch(events, inc, fc, um, up, slots, pods, sgb, pgb,
                        trace_events):
            return ops.pod_sweep(*events, inc, fc, um, up, slots, pods, sgb,
                                 pgb, trace_events=trace_events)
        return sweep_batch

    def sweep(events, inc, fc, um, up, slots, pods, sgb, pgb):
        return ops.pod_sweep(*events, inc, fc, um, up, slots, pods, sgb, pgb)
    return sweep


def pod_jit_cache_keys() -> list:
    """K4 launcher keys built so far (introspection for tests)."""
    return sorted(_POD_SWEEPS, key=repr)


def pick_pod_state_dtype(cores_per_server: float, n_servers: int,
                         sgb_i: np.ndarray, pod_caps_i: np.ndarray,
                         pay_mem_max: float, pay_pool_max: float,
                         mig_pool_sum: float, n_pods: int) -> str:
    """int16/int32 packing rule for the pod sweep.

    The single-pool rules (:func:`pick_state_dtype`) applied with the
    per-pod capacity maxima standing in for the pool column — the
    fallback-migrate deficit bound holds per pod since every deficit
    subtraction lands on exactly one pod — plus one pod-axis bound:
    the granting-pod slot array stores pod ids, so ``n_pods`` must
    stay below the int16 sentinel.
    """
    if n_pods >= I16_BIG:
        return "int32"
    return pick_state_dtype(cores_per_server, n_servers, sgb_i,
                            np.asarray(pod_caps_i).ravel(),
                            pay_mem_max, pay_pool_max, mig_pool_sum)


def init_pod_state(width: int, n_servers: int, cores_per_server: float,
                   s_pad: int, p_pad: int, n_slots: int, np_dt) -> tuple:
    """Packed all-free initial pod-sweep state: the plain
    :func:`init_state` arrays with the used-pool row widened to the pod
    axis plus the granting-pod slot array (``-1`` = no grant).  Returns
    ``(fc0, um0, up0, slots0, pods0, rej0)``.  K4 takes the true counts
    (``s_pad = n_servers``, ``p_pad`` the lanes' largest pod count); a
    trace batch stacks its traces' lanes trace-major (``width`` = traces x
    candidates), where the reference adds a leading trace axis."""
    fc0, um0, _, slots0, rej0 = init_state(
        width, n_servers, cores_per_server, s_pad, 1, n_slots, np_dt)
    up0 = np.zeros((width, p_pad), np_dt)
    pods0 = np.full((n_slots, width), -1, np_dt)
    return fc0, um0, up0, slots0, pods0, rej0


# ------------------------------------------------------------ failure sweep --
MITIGATIONS = ("remigrate", "kill")


def init_fail_state(width: int, n_groups: int) -> np.ndarray:
    """The failure sweep's extra state, all up: the (width, n_groups) int32
    down flags, a row a lane.  (The reference's also holds each slot's
    payload, shared across lanes; K5 finds a slot's payload through the
    index of its ARRIVE, kept in a per-lane scratch column that the wrapper
    allocates, so the slots must start empty.)"""
    return np.zeros((width, n_groups), np.int32)


def get_fail_sweep(state_dtype: str = "int32",
                   mitigation: str = "remigrate", *,
                   batched: bool = False, with_dist: bool = True):
    """K5's launcher, from the keyed cache: a function of ``(events,
    group_of, fc, um, up, slots, down, sgb, pgb)`` — the eight event
    arrays, the state with the down flags (:func:`init_fail_state`) and
    the capacities — returning the (5, C) int32 counters
    (``kernels/fail_sweep/ops.py::fail_sweep``: K5 for CUDA tensors, its
    plain version for CPU ones) and leaving the final state in its
    arguments.  With ``with_dist`` it takes one more argument, ``dist``:
    the (n_failures, C) int32 per-failure rows (one trace only; None
    takes none).  With ``batched`` it takes ``trace_events`` instead: K1's
    trace axis, one (trace, schedule) row a trace.

    Keyed ``(state_dtype, mitigation, batched, with_dist)`` as the
    reference's, with the counters and spans of :func:`get_sweep` under
    ``jit.fail.<dtype>.<mitigation>.batched<0|1>.dist<0|1>``.
    """
    _check_state_dtype(state_dtype)
    if mitigation not in MITIGATIONS:
        raise ValueError(f"mitigation must be one of {MITIGATIONS}")
    return _cached(_FAIL_SWEEPS, (state_dtype, mitigation, batched,
                                  with_dist), "fail", state_dtype,
                   dict(mitigation=mitigation, batched=batched,
                        dist=with_dist),
                   lambda: _build_fail_sweep(mitigation, batched,
                                             with_dist))


def _build_fail_sweep(mitigation: str, batched: bool, with_dist: bool):
    from repro_torch.kernels.fail_sweep import ops

    if batched:
        def fail_sweep_batch(events, group_of, fc, um, up, slots, down, sgb,
                             pgb, trace_events):
            return ops.fail_sweep(*events, group_of, fc, um, up, slots, down,
                                  sgb, pgb, mitigation=mitigation,
                                  trace_events=trace_events)
        return fail_sweep_batch
    if with_dist:
        def fail_sweep_dist(events, group_of, fc, um, up, slots, down, sgb,
                            pgb, dist):
            return ops.fail_sweep(*events, group_of, fc, um, up, slots, down,
                                  sgb, pgb, mitigation=mitigation, dist=dist)
        return fail_sweep_dist

    def fail_sweep(events, group_of, fc, um, up, slots, down, sgb, pgb):
        return ops.fail_sweep(*events, group_of, fc, um, up, slots, down,
                              sgb, pgb, mitigation=mitigation)
    return fail_sweep


# ----------------------------------------------------------- device split --
def resolve_devices(devices, like=None):
    """Normalise an engine's ``devices=`` argument to a device list, or
    None for the single-device path (the reference's semantics).

    ``None`` -> None; ``"all"`` -> every visible device of ``like``'s kind
    (``like`` is the engine's device: every CUDA card, or the one CPU);
    an int ``n`` -> the first ``n`` of those; a sequence of devices passes
    through, so a list that repeats the CPU, ``[torch.device("cpu")] *
    4``, counts as four devices (the CPU tests' stand-in for the
    reference's forced host devices).  Fewer than two resolved devices
    -> None: ``devices="all"`` on one card is the single-device path.
    Any other string raises ``ValueError``; ``"all"`` or a count on a CUDA
    engine, or with no ``like``, raises where no card is visible.
    """
    import torch

    if devices is None:
        return None
    if isinstance(devices, str) or isinstance(devices, int):
        if isinstance(devices, str) and devices != "all":
            raise ValueError(
                f"devices={devices!r}: expected 'all', an int, a device "
                "sequence, or None")
        if like is not None and torch.device(like).type == "cpu":
            visible = [torch.device("cpu")]
        else:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"devices={devices!r} asks for the CUDA cards and none "
                    "is visible; pass CPU devices to split on the CPU on "
                    "purpose")
            visible = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        devs = visible if devices == "all" else visible[:devices]
    else:
        devs = [torch.device(d) for d in devices]
    return devs if len(devs) >= 2 else None


def lane_shard_count(width: int, n_devices: int) -> int:
    """Largest device count <= ``n_devices`` evenly dividing a lane
    bucket — the lane axis splits evenly across the devices."""
    n = max(1, min(n_devices, width))
    while width % n:
        n -= 1
    return n


def lane_plan(width: int, devs) -> list | None:
    """A split launch's pieces of a ``width``-lane axis: ``[(device, lo,
    hi), ...]``, :func:`lane_shard_count` equal pieces on the first
    devices of ``devs``; None (the single-device path) without
    ``devs`` or where fewer than two pieces divide the lanes.  Lanes
    replay independently, so each piece is one launch on its own device
    and the results, gathered in order, equal the single launch's."""
    if devs is None:
        return None
    n = lane_shard_count(width, len(devs))
    if n < 2:
        return None
    per = width // n
    return [(devs[j], j * per, (j + 1) * per) for j in range(n)]


def row_plan(k: int, devs) -> list | None:
    """A batch's trace rows split over ``devs``: ``[(device, lo, hi),
    ...]`` of ``ceil(k / n)`` rows a device (the reference's row split:
    it pads K up to a multiple of the mesh with no-op traces, because one
    ``shard_map`` splits evenly; here each device launches on its own
    rows, so the last device takes the remainder and no row is padded).
    None below two pieces."""
    if devs is None:
        return None
    n_use = min(len(devs), k)
    per = -(-k // max(n_use, 1))
    plan = [(devs[j], j * per, min(k, (j + 1) * per))
            for j in range(n_use) if j * per < k]
    return plan if len(plan) >= 2 else None


# -------------------------------------------------------------- placement --
def device_put(a: np.ndarray, device, *, non_blocking: bool = False):
    """Host array ``a`` as a tensor on ``device``: the one way the engines
    copy host arrays to the card (compiled events, state, capacities,
    incidence).  ``non_blocking`` copies through pinned memory without a
    host wait (a pageable copy would wait for the work queued before it).

    With tracing on, the copy counts ``device_put.calls`` and
    ``device_put.bytes`` (the bytes copied: the port takes true extents,
    so these are not the reference's padded bytes).  A CPU engine's
    tensors wrap the host arrays without a copy; the counts are the same,
    so the CPU tests read them.
    """
    import torch

    rec = obs.get_recorder()
    if rec.enabled:
        rec.count("device_put.calls")
        rec.count("device_put.bytes", int(a.nbytes))
    t = torch.from_numpy(np.ascontiguousarray(a))
    if non_blocking and device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


# --------------------------------------------------------- invariant guard --
class SweepInvariantError(RuntimeError):
    """A sweep invariant failed under ``POND_DEBUG_INVARIANTS=1``.

    Structured: ``what`` names the violated invariant, ``shard``/
    ``lane`` (and ``trace`` for batched sweeps) locate the first
    offending state entry.
    """

    def __init__(self, what: str, *, shard: int, lane: int,
                 trace: int | None = None, detail: str = ""):
        self.what, self.shard, self.lane, self.trace = \
            what, shard, lane, trace
        loc = f"shard {shard}, lane {lane}"
        if trace is not None:
            loc = f"shard {shard}, trace {trace}, lane {lane}"
        msg = f"sweep invariant violated: {what} at {loc}"
        super().__init__(msg + (f" ({detail})" if detail else ""))


def invariants_enabled() -> bool:
    """Opt-in debug mode: ``POND_DEBUG_INVARIANTS=1`` in the environment
    makes the streaming engines verify the state and the event tensors
    after every shard (a read-back a shard: a debug cost, never on by
    default)."""
    return os.environ.get("POND_DEBUG_INVARIANTS", "") == "1"


def check_invariants(fc, um, up, *, n_servers: int,
                     cores_per_server: float, shard: int,
                     up_slack: float = 0.0) -> None:
    """Verify the state after a shard: ``(C, S)``/``(C, G)`` arrays, or
    ``(K, C, S)``/``(K, C, G)`` for a batch of K traces.

    Checks, on the real server columns: free cores within ``[0,
    cores_per_server]``, used local memory non-negative, used pool above
    ``-up_slack`` (the fallback-migrate deficit bound) and every entry
    finite.  Raises :class:`SweepInvariantError` naming the shard and the
    first offending (trace,) lane.
    """
    fc = np.asarray(fc, np.float64)[..., :n_servers]
    um = np.asarray(um, np.float64)[..., :n_servers]
    up = np.asarray(up, np.float64)

    def _raise(what, lane_mask, detail=""):
        first = np.argwhere(lane_mask)[0]
        trace = int(first[0]) if lane_mask.ndim == 2 else None
        lane = int(first[-1])
        raise SweepInvariantError(what, shard=shard, lane=lane,
                                  trace=trace, detail=detail)

    for name, a in (("free-cores", fc), ("used-local-GB", um),
                    ("used-pool-GB", up)):
        bad = ~np.isfinite(a)
        if bad.any():
            _raise(f"non-finite {name}", bad.any(-1))
    bad = (fc < 0) | (fc > cores_per_server)
    if bad.any():
        _raise("free cores outside [0, cores_per_server]", bad.any(-1),
               f"range [{fc.min()}, {fc.max()}]")
    if (um < 0).any():
        _raise("negative used local memory", (um < 0).any(-1),
               f"min {um.min()}")
    if (up < -up_slack - 1e-9).any():
        _raise("used pool below the migrate-deficit bound",
               (up < -up_slack - 1e-9).any(-1),
               f"min {up.min()} < -{up_slack}")


def check_event_tensors(shard: dict, shard_idx: int,
                        n_slots: int) -> None:
    """Verify one shard's event arrays (finite, kinds/slots/payloads in
    domain) under the invariant guard; ``lane`` in the raised error is the
    offending EVENT index within the shard."""
    def _raise(what, mask):
        raise SweepInvariantError(what, shard=shard_idx,
                                  lane=int(np.argwhere(mask)[0][-1]))

    kind = np.asarray(shard["kind"])
    bad = (kind < ARRIVE) | (kind > RECOVER)
    if bad.any():
        _raise("event kind out of range", bad)
    slot = np.asarray(shard["slot"])
    bad = (slot < 0) | (slot >= n_slots)
    if bad.any():
        _raise("event slot out of range", bad)
    for key in ("c", "l", "p", "m"):
        if key not in shard:
            continue
        a = np.asarray(shard[key], np.float64)
        if not np.isfinite(a).all():
            _raise(f"non-finite event payload {key!r}", ~np.isfinite(a))
        vm_ev = (kind == ARRIVE) | (kind == DEPART) | (kind == MIGRATE)
        if (vm_ev & (a < 0)).any():
            _raise(f"negative event payload {key!r}", vm_ev & (a < 0))


# ------------------------------------------------------------- state rules --
def state_np_dtype(state_dtype: str):
    """Host numpy dtype of the packed sweep state."""
    return np.int16 if state_dtype == "int16" else np.int32


def state_sentinel(state_dtype: str) -> int:
    """Best-fit score sentinel / "infinite" magnitude for the dtype."""
    return I16_BIG if state_dtype == "int16" else I32_BIG


def pick_state_dtype(cores_per_server: float, n_servers: int,
                     sgb_i: np.ndarray, pgb_i: np.ndarray,
                     pay_mem_max: float, pay_pool_max: float,
                     mig_pool_sum: float = 0.0) -> str:
    """``"int16"`` when every sweep intermediate provably fits int16.

    The admission tests compute at most ``capacity + one payload`` (used
    mem is invariantly <= server_gb, used pool <= pool_gb), so int16 is
    bit-equivalent to int32 whenever the candidate maxima plus the per-VM
    payload maxima stay within :data:`I16_SAFE`, the best-fit score
    sentinel exceeds every free-cores value, and the packed slot values
    (server * 2 + 1) fit.  MIGRATE-bearing traces need one more bound:
    the oracle's fallback-migrate quirk returns pool a fallback-placed VM
    never consumed, driving used pool NEGATIVE by at most the pool
    payload of each compiled MIGRATE event (``mig_pool_sum``).
    """
    if (cores_per_server < I16_BIG
            and n_servers * 2 + 1 < I16_BIG
            and len(sgb_i) and sgb_i.min() >= 0 and pgb_i.min() >= 0
            and sgb_i.max() + pay_mem_max <= I16_SAFE
            and pgb_i.max() + pay_pool_max <= I16_SAFE
            and mig_pool_sum + pay_pool_max <= I16_SAFE):
        return "int16"
    return "int32"


def quantize_capacities(server_gb, pool_gb):
    """Floor + clip candidate capacities to the int sweep's domain.

    Integral quantities: flooring keeps every admission test identical
    to the float64 oracle; ±2^30 stands in for "infinite" probes.
    """
    sgb_i = np.clip(np.floor(server_gb), -I32_BIG, I32_BIG)
    pgb_i = np.clip(np.floor(pool_gb), -I32_BIG, I32_BIG)
    return sgb_i, pgb_i


# ---------------------------------------------------- state pack / unpack --
def init_state(width: int, n_servers: int, cores_per_server: float,
               s_pad: int, g_pad: int, n_slots: int, np_dt) -> tuple:
    """Packed all-free initial sweep state, as host numpy arrays.

    Returns ``(fc0, um0, up0, slots0, rej0)``: free cores per (lane,
    server) — padded server columns pinned to the negative sentinel so
    they never win a best fit — used local GB, used pool GB per (lane,
    group), the slot array (-1 = empty) and the int32 reject counters.
    K1 takes the true counts (``s_pad = n_servers``, ``g_pad = n_groups``);
    a trace batch stacks its traces' lanes trace-major (``width`` = traces
    x candidates, the slot count the largest trace's).
    """
    neg = state_sentinel("int16" if np_dt == np.int16 else "int32")
    fc0 = np.full((width, s_pad), -neg, np_dt)
    fc0[:, :n_servers] = np_dt(cores_per_server)
    um0 = np.zeros((width, s_pad), np_dt)
    up0 = np.zeros((width, g_pad), np_dt)
    slots0 = np.full((n_slots, width), -1, np_dt)
    rej0 = np.zeros(width, np.int32)
    return fc0, um0, up0, slots0, rej0


def assign_slots(ev_kind, ev_vm, n_vms: int) -> tuple:
    """Map each event's VM to a reusable placement slot.

    Slots free on departure, so the per-candidate placement state is
    sized by PEAK CONCURRENCY rather than trace length.  Returns the
    per-event slot array and the slot count.
    """
    slot_of = np.zeros(n_vms, np.int64)
    ev_slot = np.zeros(len(ev_kind), np.int64)
    free_slots: list[int] = []
    next_slot = 0
    for e in range(len(ev_kind)):
        v = ev_vm[e]
        kind = ev_kind[e]
        if kind == ARRIVE:
            if free_slots:
                slot_of[v] = free_slots.pop()
            else:
                slot_of[v] = next_slot
                next_slot += 1
        ev_slot[e] = slot_of[v]
        if kind == DEPART:
            free_slots.append(int(slot_of[v]))
    return ev_slot, next_slot
