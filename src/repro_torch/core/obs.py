"""Engine-wide tracing and metrics: spans, counters, Chrome-trace export.

Pond's control plane is built on cheap always-on telemetry (§4.2's core
PMU/TMA counters and access-bit scans); ``core/telemetry.py`` models the
*workload* side of that story.  This module is the *system* side: a
near-zero-overhead instrumentation layer for the port's engines — launcher
cache hits and misses (``sweep_core.get_sweep`` and its siblings), padding
waste of the streams' shard cuts, per-shard timings of the streaming
sweeps (upload, wait, compute), host-to-card transfer bytes, checkpoint
I/O, pond's policy stages and trace-ingest rates.  The span and counter
names are the JAX package's, so a port run and a reference run read alike.

Design:

* A :class:`Recorder` collects **nested monotonic-clock spans**
  (``with rec.span("stream.shard", shard=3): ...``) and **named
  counters** (``rec.count("device_put.bytes", nbytes)``).  Spans nest via
  a depth stack; per-name aggregates (count, total seconds) are folded at
  span exit, so :meth:`Recorder.metrics` is O(names) regardless of event
  count.  Work timed off the host clock (the streaming sweeps' uploads
  and launches, timed by CUDA events on the card) enters through
  :meth:`Recorder.add_span` with endpoints already on the recorder's
  clock.
* Instrumented code asks :func:`get_recorder` for the active recorder.
  When tracing is off this returns the module :data:`_NULL` singleton —
  ``span()`` hands back one pre-allocated no-op context manager and
  ``count()`` does nothing — so the disabled-mode overhead on the hot
  paths is a few attribute lookups (bounded by
  ``tests/test_torch_obs.py::test_disabled_overhead_bound``).  The
  engines take their traced branches (CUDA events, host waits) only when
  the recorder is live; with tracing off they add no synchronisation and
  no allocation.
* Opt in with ``POND_TRACE=1`` (a process-wide recorder is created on
  first use, like ``POND_DEBUG_INVARIANTS``) or explicitly with
  :func:`set_recorder` / the :func:`use_recorder` context manager.
* Exports: :meth:`Recorder.metrics` (a flat dict),
  :meth:`Recorder.to_chrome_trace` (Chrome trace-event-format JSON: open
  the file in https://ui.perfetto.dev to see the span waterfall) and
  :func:`run_manifest` (git sha, torch and CUDA versions, the card's
  name, the wall clock) so every run carries its provenance.

The module imports neither torch nor any other array library at import
time; :func:`run_manifest` imports torch when it is called.

Instrumentation never changes results: recorders observe clocks and
counts only, and ``tests/test_torch_obs.py`` holds every engine entry
point's results ``==`` with tracing on and off.

Usage::

    from repro_torch.core import obs
    rec = obs.Recorder()
    with obs.use_recorder(rec):
        engine.reject_rates(server_grid, pool_grid)
    print(rec.metrics())            # {"jit.sweep....hit": 3, ...}
    rec.to_chrome_trace("trace.json")
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
import subprocess
import sys
import time


# ------------------------------------------------------------ null objects --
class _NullSpan:
    """Pre-allocated no-op context manager handed out when disabled."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL_SPAN = _NullSpan()


class _NullRecorder:
    """No-op recorder: the disabled-mode singleton.

    Hot paths call ``rec.span(...)`` / ``rec.count(...)`` unguarded (or
    guard attribute-building work behind ``rec.enabled``); with this
    recorder active every call is a constant-time no-op.
    """
    __slots__ = ()
    enabled = False

    def span(self, name, **attrs):
        return _NULL_SPAN

    def count(self, name, value=1):
        return None

    def add_span(self, name, t0_ns, t1_ns, **attrs):
        return None

    def metrics(self):
        return {}

    def spans(self):
        return []


_NULL = _NullRecorder()


# ------------------------------------------------------------------ spans --
class _Span:
    """One nested wall-clock span (context manager)."""
    __slots__ = ("_rec", "name", "args", "_t0")

    def __init__(self, rec, name, args):
        self._rec = rec
        self.name = name
        self.args = args

    def __enter__(self):
        self._rec._depth += 1
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter_ns()
        rec = self._rec
        rec._depth -= 1
        rec._emit(self.name, self._t0, t1, rec._depth, self.args)
        return False


class Recorder:
    """Collects nested spans + named counters; exports metrics/traces.

    Single-threaded by design (the engines are): span nesting is tracked
    with one integer depth.  The raw event list is capped at
    ``max_events`` (aggregates keep folding past the cap; the drop count
    is reported as ``obs.dropped_events``) so a long sweep can stay
    instrumented without unbounded memory.
    """
    enabled = True

    def __init__(self, max_events: int = 1_000_000):
        self.max_events = max_events
        self.clear()

    def clear(self):
        self._epoch_ns = time.perf_counter_ns()
        self._events: list = []      # (name, t0_ns, t1_ns, depth, args)
        self._counters: dict = {}
        self._aggr: dict = {}        # name -> [count, total_ns]
        self._depth = 0
        self._dropped = 0

    # ------------------------------------------------------- collection --
    def span(self, name: str, **attrs):
        """A nested wall-clock span: ``with rec.span("x", k=v): ...``."""
        return _Span(self, name, attrs or None)

    def count(self, name: str, value=1):
        """Add ``value`` to the named counter."""
        self._counters[name] = self._counters.get(name, 0) + value

    def add_span(self, name: str, t0_ns: int, t1_ns: int, **attrs):
        """Record an externally timed span (``perf_counter_ns`` endpoints)
        without touching the nesting stack.

        For work measured off the host clock: the streaming sweeps' shard
        uploads and launches, timed by CUDA events on the card and placed
        on this clock by the engine once the events have completed.  The
        recorder stays single-threaded: only the engine thread calls this.
        """
        self._emit(name, t0_ns, t1_ns, self._depth, attrs or None)

    def _emit(self, name, t0, t1, depth, args):
        agg = self._aggr.get(name)
        if agg is None:
            self._aggr[name] = [1, t1 - t0]
        else:
            agg[0] += 1
            agg[1] += t1 - t0
        if len(self._events) < self.max_events:
            self._events.append((name, t0, t1, depth, args))
        else:
            self._dropped += 1

    # ---------------------------------------------------------- exports --
    def spans(self) -> list:
        """Finished spans as dicts (ns-resolution, recorder-relative)."""
        return [{"name": n, "ts_ns": t0 - self._epoch_ns,
                 "dur_ns": t1 - t0, "depth": depth, "args": args}
                for n, t0, t1, depth, args in self._events]

    def metrics(self) -> dict:
        """Flat metrics dict: counters + per-span-name aggregates.

        Span aggregates appear as ``span.<name>.count`` /
        ``span.<name>.total_s``; padding-waste ratios are derived from
        their used/padded counter pairs when present.
        """
        out = {k: self._counters[k] for k in sorted(self._counters)}
        for name in sorted(self._aggr):
            n, tot_ns = self._aggr[name]
            out[f"span.{name}.count"] = n
            out[f"span.{name}.total_s"] = round(tot_ns / 1e9, 6)
        for used, padded, ratio in (
                ("pad.cand_lanes_used", "pad.cand_lanes_padded",
                 "pad.cand_waste_ratio"),
                ("pad.events_used", "pad.events_padded",
                 "pad.event_waste_ratio")):
            u, p = out.get(used), out.get(padded)
            if u is not None and p is not None and (u + p) > 0:
                out[ratio] = round(p / (u + p), 4)
        # double-buffer pipeline efficiency: fraction of shard-upload
        # time hidden behind device compute (1.0 = fully overlapped)
        up_s = out.get("span.stream.upload.total_s")
        wait_s = out.get("span.stream.upload_wait.total_s")
        if up_s and wait_s is not None and up_s > 0:
            out["stream.overlap_ratio"] = round(
                max(0.0, 1.0 - wait_s / up_s), 4)
        if self._dropped:
            out["obs.dropped_events"] = self._dropped
        return out

    def to_chrome_trace(self, path: str, manifest: dict | None = None
                        ) -> str:
        """Write Chrome trace-event-format JSON (Perfetto-viewable).

        Complete ``"X"`` events with microsecond ``ts`` (relative to
        recorder creation, so non-negative) and ``dur``, sorted by start
        time; counters and the optional run manifest ride along under the
        top-level ``metadata`` key.
        """
        evs = sorted(self._events,
                     key=lambda e: (e[1], -(e[2] - e[1]), e[3]))
        pid = os.getpid()
        trace = []
        for name, t0, t1, depth, args in evs:
            ev = {"name": name, "ph": "X", "pid": pid, "tid": 0,
                  "ts": (t0 - self._epoch_ns) / 1e3,
                  "dur": max(t1 - t0, 0) / 1e3}
            if args:
                ev["args"] = args
            trace.append(ev)
        doc = {"traceEvents": trace, "displayTimeUnit": "ms",
               "metadata": {"counters": self.metrics()}}
        if manifest:
            doc["metadata"]["manifest"] = manifest
        with open(path, "w") as f:
            json.dump(doc, f, default=_json_default)
        return path


def _json_default(o):
    """Coerce numpy scalars / exotica that leak into span args."""
    try:
        return float(o)
    except Exception:
        return str(o)


# ------------------------------------------------------- active recorder ---
_ACTIVE: Recorder | None = None
_ENV_CHECKED = False


def get_recorder():
    """The active :class:`Recorder`, or the no-op singleton.

    ``POND_TRACE=1`` (any value but ``0``/empty) creates a process-wide
    recorder on first use; :func:`set_recorder`/:func:`use_recorder` take
    precedence.  The disabled path is two global reads and a comparison —
    cheap enough for per-shard call sites.
    """
    global _ACTIVE, _ENV_CHECKED
    if _ACTIVE is not None:
        return _ACTIVE
    if not _ENV_CHECKED:
        _ENV_CHECKED = True
        if os.environ.get("POND_TRACE", "") not in ("", "0"):
            _ACTIVE = Recorder()
            return _ACTIVE
    return _NULL


def set_recorder(rec: Recorder | None):
    """Install ``rec`` as the active recorder (None disables tracing)."""
    global _ACTIVE
    _ACTIVE = rec


@contextlib.contextmanager
def use_recorder(rec: Recorder | None):
    """Scoped :func:`set_recorder`: restores the previous recorder."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = rec
    try:
        yield rec
    finally:
        _ACTIVE = prev


def enabled() -> bool:
    """True when a live recorder is active (env or explicit)."""
    return get_recorder().enabled


def traced(name: str):
    """Decorator: wrap a function in a named span when tracing is on.

    The disabled path is one extra function call + the
    :func:`get_recorder` check — used on coarse engine entry points (one
    call per sweep), not inner loops.
    """
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            rec = get_recorder()
            if not rec.enabled:
                return fn(*args, **kwargs)
            with rec.span(name):
                return fn(*args, **kwargs)
        return wrapper
    return deco


# ------------------------------------------------------------- manifest ----
def git_sha() -> str:
    """HEAD sha of the repo containing this file, or ``"unknown"``."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True,
            text=True, timeout=10,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        sha = out.stdout.strip()
        return sha if out.returncode == 0 and sha else "unknown"
    except Exception:                                # pragma: no cover
        return "unknown"


def run_manifest(**extra) -> dict:
    """Provenance stamp for a run.

    Git sha, the torch and CUDA versions, the backend (``"cuda"`` where a
    card is visible, else ``"cpu"``), the card's name and the number of
    cards, numpy/python versions and the wall clock; keyword args (e.g.
    observed state dtypes) are merged in.  Where torch cannot be imported
    its fields are ``None`` (``n_devices`` 0).
    """
    man = {
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "unix_time": round(time.time(), 3),
        "git_sha": git_sha(),
        "python_version": sys.version.split()[0],
    }
    try:
        import numpy
        man["numpy_version"] = numpy.__version__
    except Exception:                                # pragma: no cover
        man["numpy_version"] = None
    try:
        import torch
        man["torch_version"] = torch.__version__
        man["cuda_version"] = torch.version.cuda
        card = torch.cuda.is_available()
        man["backend"] = "cuda" if card else "cpu"
        man["device_kind"] = torch.cuda.get_device_name(0) if card else None
        man["n_devices"] = torch.cuda.device_count() if card else 0
    except Exception:                                # pragma: no cover
        man["torch_version"] = None
        man["cuda_version"] = None
        man["backend"] = None
        man["device_kind"] = None
        man["n_devices"] = 0
    man.update(extra)
    return man
