"""The port's observability layer (``repro_torch/core/obs.py``) against the
reference's, case by case as ``tests/test_obs.py`` holds the reference's:
the recorder (nesting, counters, the event cap, scoping, ``traced``, the
disabled-mode overhead bound, the Chrome trace, ``run_manifest`` with its
torch keys); the launcher caches' ``jit.*`` counters and ``.lower`` span;
the ingestion counters; every engine entry point's results ``==`` with
tracing on and off on the 8-server world; and the same calls through both
packages, each under its own recorder, giving ``==`` span counts and
counters wherever both emit a name.  Names that differ by design are
listed below with their reasons.  Times are never compared across
packages.  Everything runs on the CPU (the sweeps' plain versions)."""
import ast
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from repro.core import cluster_sim as jax_cs
from repro.core import obs as jax_obs
from repro.core import policy_engine as jax_pe
from repro.core import replay_engine as jax_re
from repro.core import sweep_core as jax_sc
from repro.core import topology as jax_top
from repro.core import traces as jax_traces
from repro.core.control_plane import ControlPlane as JaxControlPlane
from repro.core.control_plane import ControlPlaneConfig as JaxCPConfig
from repro.core.pool_manager import PoolManager as JaxPoolManager
from repro.core.predictors.models import (
    LatencySensitivityModel as JaxLatencySensitivityModel,
    UntouchedMemoryModel as JaxUntouchedMemoryModel)
from repro.runtime.fault import FailureSchedule as JaxSchedule
from repro_torch.core import cluster_sim as cs
from repro_torch.core import obs
from repro_torch.core import policy_engine as pe
from repro_torch.core import replay_engine as re
from repro_torch.core import sweep_core
from repro_torch.core import traces
from repro_torch.core.control_plane import ControlPlane, ControlPlaneConfig
from repro_torch.core.pool_manager import PoolManager
from repro_torch.core.predictors.models import (LatencySensitivityModel,
                                                UntouchedMemoryModel)
from repro_torch.runtime.fault import FailureSchedule
from tests._torch_port_util import port_decisions, port_topology, port_vms

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(n_servers=8, pool_sockets=8, gb_per_core=4.75)
JAX_CFG = jax_cs.ClusterConfig(**KW)
CFG = cs.ClusterConfig(**KW)
HORIZON = 3 * 86400
BUDGET = 256
#: 16 lanes (a reference candidate bucket, so its padded lane counts are
#: the port's true ones): generous enough that the divergence window
#: skips the first of the 5 shards, and tight ones that skip nothing
WIDE = (np.linspace(350.0, 768.0, 16), np.linspace(300.0, 6144.0, 16))
TIGHT = (np.linspace(60.0, 300.0, 16), np.linspace(0.0, 400.0, 16))
#: 2 hopeless lanes (a bucket of 2): every lane exceeds a cap of 0
HOPELESS = (np.array([30.0, 20.0]), np.array([0.0, 0.0]))

#: names only the reference emits, with the reason
REFERENCE_ONLY = {
    "pad.cand_lanes_used": "the port takes every candidate in one launch: "
                           "no candidate buckets (candidate_chunks)",
    "pad.cand_lanes_padded": "as pad.cand_lanes_used",
    "pad.cand_waste_ratio": "derived from pad.cand_lanes_*",
}
#: names both emit whose values differ by design, with the reason
DIFFER_BY_DESIGN = {
    "device_put.calls": "the port copies true extents, one copy of a "
                        "shard's six rows, the reference six padded arrays",
    "device_put.bytes": "as device_put.calls: the bytes actually copied",
    "pad.events_used": "the reference's CompiledReplay pads its events to "
                       "a multiple of 256 and counts them; the port's takes "
                       "true extents and counts nothing (streams keep the "
                       "reference's shard cuts, so on streams these are ==)",
    "pad.events_padded": "as pad.events_used",
    "pad.event_waste_ratio": "derived from pad.events_*",
    "stream.overlap_ratio": "a ratio of times",
}
#: prefixes whose counts depend on what the process built before (the
#: launcher caches): compared only in test_jit_counters_equal_reference
PROCESS_STATE = ("jit.", "span.jit.")


@pytest.fixture(autouse=True)
def _no_ambient_recorder():
    """Tests control each package's active recorder; never leak one."""
    prev, jprev = obs._ACTIVE, jax_obs._ACTIVE
    obs.set_recorder(None)
    jax_obs.set_recorder(None)
    yield
    obs.set_recorder(prev)
    jax_obs.set_recorder(jprev)


# ------------------------------------------------------------- recorder ----
def test_span_nesting_and_ordering():
    rec = obs.Recorder()
    with rec.span("outer"):
        with rec.span("inner", k=1):
            pass
        with rec.span("inner", k=2):
            pass
    spans = rec.spans()
    assert [s["name"] for s in spans] == ["inner", "inner", "outer"]
    inner1, inner2, outer = spans
    assert inner1["depth"] == inner2["depth"] == 1
    assert outer["depth"] == 0
    assert outer["ts_ns"] <= inner1["ts_ns"]
    assert (inner2["ts_ns"] + inner2["dur_ns"]
            <= outer["ts_ns"] + outer["dur_ns"])
    assert inner1["ts_ns"] + inner1["dur_ns"] <= inner2["ts_ns"]
    assert all(s["dur_ns"] >= 0 and s["ts_ns"] >= 0 for s in spans)
    assert inner1["args"] == {"k": 1} and inner2["args"] == {"k": 2}


def test_counters_and_metrics():
    rec = obs.Recorder()
    rec.count("x")
    rec.count("x", 4)
    rec.count("pad.events_used", 75)
    rec.count("pad.events_padded", 25)
    with rec.span("s"):
        pass
    rec.add_span("stream.upload", 0, 4_000)
    rec.add_span("stream.upload_wait", 0, 1_000)
    m = rec.metrics()
    assert m["x"] == 5
    assert m["span.s.count"] == 1
    assert m["span.s.total_s"] >= 0.0
    assert m["pad.event_waste_ratio"] == 0.25
    assert m["stream.overlap_ratio"] == 0.75


def test_event_cap_keeps_aggregates():
    rec = obs.Recorder(max_events=3)
    for _ in range(10):
        with rec.span("s"):
            pass
    assert len(rec.spans()) == 3
    m = rec.metrics()
    assert m["span.s.count"] == 10
    assert m["obs.dropped_events"] == 7


def test_use_recorder_scoping():
    rec = obs.Recorder()
    assert not obs.enabled()
    with obs.use_recorder(rec):
        assert obs.get_recorder() is rec
        assert obs.enabled()
    assert not obs.enabled()
    assert obs.get_recorder().span("x") is obs._NULL_SPAN


def test_pond_trace_env_creates_a_process_recorder(monkeypatch):
    monkeypatch.setattr(obs, "_ENV_CHECKED", False)
    monkeypatch.setenv("POND_TRACE", "1")
    rec = obs.get_recorder()
    assert isinstance(rec, obs.Recorder) and obs.get_recorder() is rec
    obs.set_recorder(None)
    monkeypatch.setattr(obs, "_ENV_CHECKED", False)
    monkeypatch.setenv("POND_TRACE", "0")
    assert obs.get_recorder() is obs._NULL


def test_traced_decorator():
    calls = []

    @obs.traced("f.span")
    def f(a, b=1):
        calls.append((a, b))
        return a + b

    assert f(2, b=3) == 5
    rec = obs.Recorder()
    with obs.use_recorder(rec):
        assert f(4) == 5
    assert calls == [(2, 3), (4, 1)]
    assert rec.metrics()["span.f.span.count"] == 1


def test_disabled_overhead_bound():
    """Null-recorder primitives on a 10k-event sweep's worth of call sites
    stay near-free: bounded against the same loop doing the work alone (a
    generous 10x, to catch an allocation or formatting on the disabled
    path, not to benchmark)."""
    n = 10_000
    assert obs.get_recorder() is obs._NULL

    def instrumented():
        t0 = time.perf_counter()
        acc = 0
        for i in range(n):
            r = obs.get_recorder()
            with r.span("shard"):
                acc += i
            if r.enabled:
                r.count("pad.events_used", i)
        return time.perf_counter() - t0, acc

    def baseline():
        t0 = time.perf_counter()
        acc = 0
        for i in range(n):
            acc += i
        return time.perf_counter() - t0, acc

    instrumented()
    baseline()
    t_i = min(instrumented()[0] for _ in range(3))
    t_b = min(baseline()[0] for _ in range(3))
    assert instrumented()[1] == baseline()[1]
    assert t_i < max(10 * t_b, 0.05), (t_i, t_b)


def test_chrome_trace_round_trip(tmp_path):
    rec = obs.Recorder()
    with rec.span("a"):
        with rec.span("b", shard=np.int64(3)):
            pass
    rec.count("jit.sweep.int32.carry0.batched0.hit", 2)
    out = tmp_path / "trace.json"
    rec.to_chrome_trace(str(out), manifest=obs.run_manifest())
    doc = json.loads(out.read_text())
    evs = doc["traceEvents"]
    assert [e["name"] for e in evs] == ["a", "b"]
    for e in evs:
        assert e["ph"] == "X"
        assert e["ts"] >= 0 and e["dur"] >= 0
    assert evs[0]["ts"] <= evs[1]["ts"]
    assert evs[1]["args"] == {"shard": 3.0}
    assert (doc["metadata"]["counters"]
            ["jit.sweep.int32.carry0.batched0.hit"] == 2)
    man = doc["metadata"]["manifest"]
    assert man["git_sha"] and man["timestamp"]


def test_run_manifest_fields():
    import torch
    man = obs.run_manifest(extra_key="v")
    for k in ("timestamp", "unix_time", "git_sha", "python_version",
              "numpy_version", "torch_version", "cuda_version", "backend",
              "device_kind", "n_devices"):
        assert k in man, k
    assert "jax_version" not in man
    assert man["extra_key"] == "v"
    assert man["torch_version"] == torch.__version__
    assert man["cuda_version"] == torch.version.cuda
    card = torch.cuda.is_available()
    assert man["backend"] == ("cuda" if card else "cpu")
    assert man["n_devices"] == (torch.cuda.device_count() if card else 0)
    assert man["device_kind"] == (torch.cuda.get_device_name(0) if card
                                  else None)
    assert len(man["git_sha"]) in (7, 40) or man["git_sha"] == "unknown"


def test_obs_imports_torch_only_inside_run_manifest():
    path = os.path.join(REPO, "src", "repro_torch", "core", "obs.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    top = set()
    for node in tree.body:
        if isinstance(node, ast.Import):
            top |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            top.add(node.module.split(".")[0])
    assert not top & {"torch", "jax", "jaxlib", "repro", "repro_torch",
                      "numpy"}, top
    code = ("import sys, repro_torch.core.obs as o\n"
            "r = o.Recorder()\n"
            "with o.use_recorder(r):\n"
            "    with o.get_recorder().span('x'):\n"
            "        pass\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'repro', 'numpy')))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ,
                                   PYTHONPATH=os.path.join(REPO, "src")),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


# ------------------------------------------------- launcher-cache counters --
JIT_CASES = [
    ("sweep", dict(state_dtype="int32"), ("int32", False, False),
     "jit.sweep.int32.carry0.batched0"),
    ("sweep", dict(state_dtype="int32", batched=True),
     ("int32", False, True), "jit.sweep.int32.carry0.batched1"),
    ("sweep", dict(state_dtype="int16"), ("int16", False, False),
     "jit.sweep.int16.carry0.batched0"),
    ("sweep", dict(state_dtype="int16", with_carry=True, batched=True),
     ("int16", True, True), "jit.sweep.int16.carry1.batched1"),
    ("fail", dict(state_dtype="int32", mitigation="kill"),
     ("int32", "kill", False, True), "jit.fail.int32.kill.batched0.dist1"),
    ("fail", dict(state_dtype="int16", mitigation="remigrate",
                  batched=True, with_dist=False),
     ("int16", "remigrate", True, False),
     "jit.fail.int16.remigrate.batched1.dist0"),
    ("pod", dict(state_dtype="int32"), ("int32", False, False),
     "jit.pod.int32.carry0.batched0"),
    ("pod", dict(state_dtype="int16", with_carry=True),
     ("int16", True, False), "jit.pod.int16.carry1.batched0"),
]


def _getter(mod, family):
    return {"sweep": mod.get_sweep, "fail": mod.get_fail_sweep,
            "pod": mod.get_pod_sweep}[family]


def _cache(mod, family):
    return {"sweep": mod._SWEEPS, "fail": mod._FAIL_SWEEPS,
            "pod": mod._POD_SWEEPS}[family]


@pytest.mark.parametrize("family,kw,key,stem", JIT_CASES,
                         ids=[c[3] for c in JIT_CASES])
def test_jit_cache_counters_match_cache(family, kw, key, stem):
    _cache(sweep_core, family).pop(key, None)
    rec = obs.Recorder()
    with obs.use_recorder(rec):
        first = _getter(sweep_core, family)(**kw)
        again = _getter(sweep_core, family)(**kw)
    assert first is again is _cache(sweep_core, family)[key]
    m = rec.metrics()
    assert m[stem + ".miss"] == 1
    assert m[stem + ".hit"] == 1
    assert m[f"span.{stem}.build.count"] == 1
    keys = {"sweep": sweep_core.jit_cache_keys,
            "pod": sweep_core.pod_jit_cache_keys}.get(family)
    if keys is not None:
        assert key in keys()


def test_jit_counters_equal_reference():
    """The same sequence of ``get_*`` calls through both packages, each
    cache emptied of the keys first: ``==`` miss and hit counts."""
    for family, kw, key, _ in JIT_CASES:
        _cache(sweep_core, family).pop(key, None)
        _cache(jax_sc, family).pop(key, None)
    calls = [(f, kw) for f, kw, _, _ in JIT_CASES] * 2
    calls += [("sweep", dict(state_dtype="int32"))] * 3
    rec, jrec = obs.Recorder(), jax_obs.Recorder()
    with obs.use_recorder(rec):
        for family, kw in calls:
            _getter(sweep_core, family)(**kw)
    with jax_obs.use_recorder(jrec):
        for family, kw in calls:
            _getter(jax_sc, family)(**kw)

    def counts(m):
        return {k: v for k, v in m.items() if k.startswith("jit.")
                or (k.startswith("span.jit.") and k.endswith(".count"))}
    got, want = counts(rec.metrics()), counts(jrec.metrics())
    assert got == want
    assert sum(v for k, v in got.items() if k.endswith(".miss")) == 8
    assert sum(v for k, v in got.items() if k.endswith(".hit")) == 11


def test_get_fail_sweep_refuses_unknown_keys():
    with pytest.raises(ValueError):
        sweep_core.get_fail_sweep("int8")
    with pytest.raises(ValueError):
        sweep_core.get_fail_sweep("int32", "reboot")


def test_lowering_span_recorded_on_first_call():
    """The ``.lower`` span fires on a cache-missed launcher's first call,
    not on later ones."""
    sweep_core._SWEEPS.clear()
    eng = re.CompiledReplay(*_world()[2:], CFG, device="cpu")
    rec = obs.Recorder()
    with obs.use_recorder(rec):
        eng.reject_rates(np.array([220.0]), np.array([96.0]))
        eng.reject_rates(np.array([220.0]), np.array([96.0]))
    m = rec.metrics()
    lowers = {k: v for k, v in m.items()
              if k.startswith("span.jit.sweep.") and k.endswith(
                  ".lower.count")}
    assert lowers and all(v == 1 for v in lowers.values()), m
    misses = [v for k, v in m.items()
              if k.startswith("jit.sweep.") and k.endswith(".miss")]
    assert sum(misses) >= len(lowers)


# ------------------------------------------------------- ingest counters --
def test_ingest_counters(tmp_path):
    p = traces.fixture_trace_path()
    rec = obs.Recorder()
    with obs.use_recorder(rec):
        n = sum(len(v) for v in traces.iter_trace_chunks(p, chunk_vms=16))
    m = rec.metrics()
    assert m["ingest.vms"] == n
    assert m["ingest.rows"] == n
    assert m["ingest.chunks"] == (n + 15) // 16
    assert m["span.ingest.chunk.count"] >= m["ingest.chunks"]


def test_ingest_counters_identity():
    """Instrumented ingestion yields the identical VM stream."""
    p = traces.fixture_trace_path()
    plain = [v for c in traces.iter_trace_chunks(p, chunk_vms=16)
             for v in c]
    with obs.use_recorder(obs.Recorder()):
        traced = [v for c in traces.iter_trace_chunks(p, chunk_vms=16)
                  for v in c]
    def rows(vms):
        return [(v.vm_id, v.arrival, v.lifetime, v.cores, v.mem_gb,
                 v.untouched, v.slow182, v.pmu.tobytes()) for v in vms]
    assert rows(plain) == rows(traced)


DIRTY = ("vmid,arrival,lifetime,cores,mem_gb\n1,0,100,2,4\n2,5,abc,2,4\n"
         "3,6,100,-2,4\n4,7,100,2,4\n5,8,100,2,nan\n6,9,100,4,8\n")


@pytest.mark.parametrize("case", ["fixture", "quarantine"])
def test_ingest_counters_equal_reference(tmp_path, case):
    """``ingest.*`` and the chunk span's count ``==`` the reference's on
    the same file: the fixture, and a dirty file under quarantine."""
    if case == "fixture":
        path, kw = traces.fixture_trace_path(), dict(chunk_vms=16)
    else:
        path = str(tmp_path / "dirty.csv")
        with open(path, "w") as f:
            f.write(DIRTY)
        kw = dict(chunk_vms=2, max_bad_rows=10)
    rec, jrec = obs.Recorder(), jax_obs.Recorder()
    with obs.use_recorder(rec):
        got = [len(c) for c in traces.iter_trace_chunks(path, **kw)]
    with jax_obs.use_recorder(jrec):
        want = [len(c) for c in jax_traces.iter_trace_chunks(path, **kw)]
    assert got == want
    _assert_shared_equal(rec.metrics(), jrec.metrics())
    m = rec.metrics()
    assert m["ingest.vms"] == sum(got)
    assert m["ingest.chunks"] == len(got)
    if case == "quarantine":
        assert m["ingest.quarantined"] == 3 and m["ingest.io_retries"] == 0
        assert m["ingest.rows"] == 6


# ------------------------------------------------------ the engines, world --
_WORLDS = {}


def _world(seed=3, horizon=HORIZON, frac=0.25):
    """(reference vms, reference decisions, port vms, port decisions) of
    the 8-server world (static share ``frac``)."""
    key = (seed, horizon, frac)
    if key not in _WORLDS:
        n = jax_cs.arrivals_for_util(JAX_CFG, 0.8, horizon)
        vms = jax_traces.Population(seed=0).sample_vms(
            n, horizon, seed=seed, start_id=10 ** 6)
        dec, _ = jax_cs.policy_decisions(vms, "static",
                                         static_pool_frac=frac,
                                         as_arrays=True)
        _WORLDS[key] = (vms, dec, port_vms(vms), port_decisions(dec))
    return _WORLDS[key]


def _schedules(seed, horizon=HORIZON):
    args = (horizon, JAX_CFG.n_groups, 4 * 3600.0, 1800.0)
    return (JaxSchedule.generate(*args, seed=seed),
            FailureSchedule.generate(*args, seed=seed))


def _fleet_lanes():
    """16 fleet lanes (a reference bucket): 4 server sizes x 4 topologies
    at 8 servers, as reference and port topologies."""
    topos = [jax_top.partitioned(8, 4), jax_top.overlapping(8, 4, 2),
             jax_top.sparse(8, 4, 2, seed=1),
             jax_top.sparse(8, 3, 2, seed=2, allow_orphans=True)]
    sgb, caps, lanes = [], [], []
    for server, total in ((200.0, 150.0), (200.0, 40.0), (140.0, 300.0),
                          (60.0, 6144.0)):
        for t in topos:
            sgb.append(server)
            caps.append(jax_top.split_pool(total, t.n_pods))
            lanes.append(t)
    return np.asarray(sgb), caps, lanes, [port_topology(t) for t in lanes]


_MODELS = {}


def _planes():
    """(reference control plane, port control plane), fresh, each over
    its own package's models fitted on the same 400 training VMs."""
    if not _MODELS:
        train = jax_traces.Population(seed=0).sample_vms(400, HORIZON,
                                                         seed=1)
        ptrain = port_vms(train)
        ut = np.array([v.untouched for v in train])
        jhist = jax_traces.build_history(train)
        jli = JaxLatencySensitivityModel(pdm=0.05).fit(
            jax_traces.pmu_matrix(train), jax_traces.slowdowns(train, 182))
        jum = JaxUntouchedMemoryModel(0.05).fit(
            jax_traces.metadata_features(train, jhist), ut)
        phist = traces.build_history(ptrain)
        pli = LatencySensitivityModel(pdm=0.05).fit(
            traces.pmu_matrix(ptrain), traces.slowdowns(ptrain, 182))
        pum = UntouchedMemoryModel(0.05).fit(
            traces.metadata_features(ptrain, phist), ut)
        _MODELS.update(ref=(jli, jum, jhist), port=(pli, pum, phist))
    jli, jum, jhist = _MODELS["ref"]
    pli, pum, phist = _MODELS["port"]
    return (JaxControlPlane(JaxCPConfig(li_threshold=0.05), jli, jum,
                            JaxPoolManager(pool_gb=4096, buffer_gb=64),
                            history=dict(jhist)),
            ControlPlane(ControlPlaneConfig(li_threshold=0.05), pli, pum,
                         PoolManager(pool_gb=4096, buffer_gb=64),
                         history=dict(phist)))


def _stream(seed=3, pkg="port"):
    vms, dec, pvms, pdec = _world(seed)
    if pkg == "port":
        return re.CompiledReplayStream(pvms, pdec, CFG, device="cpu",
                                       max_events_per_shard=BUDGET)
    return jax_re.CompiledReplayStream(vms, dec, JAX_CFG,
                                       max_events_per_shard=BUDGET)


def _engine(seed=3, pkg="port", failures=False):
    vms, dec, pvms, pdec = _world(seed)
    jsched, psched = _schedules(seed) if failures else (None, None)
    if pkg == "port":
        return re.CompiledReplay(pvms, pdec, CFG, device="cpu",
                                 failure_schedule=psched)
    return jax_re.CompiledReplay(vms, dec, JAX_CFG,
                                 failure_schedule=jsched)


def _pkg(pkg):
    """(replay engine module, topology lanes index, backend name of the
    device path) of a package."""
    return ((re, 3, "torch") if pkg == "port" else (jax_re, 2, "jax"))


def _avail_fields(res):
    return [np.asarray(getattr(res, f)).tolist() for f in
            ("reject_rate", "affected", "killed", "remigrated",
             "lost_vm_minutes")]


def _call(name, pkg="port"):
    """One engine entry point of ``pkg`` on the 8-server world; returns
    ``(span name, result as lists)``."""
    mod, ti, dev = _pkg(pkg)
    fleet = _fleet_lanes()
    sgb, caps, topos = fleet[0], fleet[1], fleet[ti]
    if name == "replay.reject_rates":
        return _engine(pkg=pkg).reject_rates(*WIDE).tolist()
    if name == "replay.availability":
        res = _engine(pkg=pkg, failures=True).availability(
            *TIGHT, "kill", per_failure=True)
        return _avail_fields(res) + [
            np.asarray(res.affected_per_failure).tolist()]
    if name == "replay.fleet":
        return _engine(pkg=pkg).reject_rates_fleet(sgb, caps,
                                                   topos).tolist()
    if name.startswith("batch."):
        batch = mod.CompiledReplayBatch(
            [_engine(s, pkg, failures=name == "batch.availability")
             for s in (3, 4)])
        if name == "batch.reject_rates":
            return batch.reject_rates(*TIGHT).tolist()
        if name == "batch.availability":
            return _avail_fields(batch.availability(*TIGHT, "remigrate"))
        return batch.reject_rates_fleet(sgb, caps, topos).tolist()
    if name.startswith("stream_batch."):
        batch = mod.CompiledReplayStreamBatch([_stream(s, pkg)
                                               for s in (3, 4)])
        if name == "stream_batch.reject_rates":
            return batch.reject_rates(*WIDE).tolist()
        return batch.reject_rates_fleet(sgb, caps, topos).tolist()
    if name == "stream.reject_rates":
        return _stream(pkg=pkg).reject_rates(*WIDE).tolist()
    if name == "stream.fleet":
        return _stream(pkg=pkg).reject_rates_fleet(sgb, caps,
                                                   topos).tolist()
    if name == "policy.decisions":
        vms, _, pvms, _ = _world()
        ref_cp, port_cp = _planes()
        if pkg == "port":
            d = pe.policy_decisions_compiled(pvms, "pond",
                                             control_plane=port_cp)
        else:
            d = jax_pe.policy_decisions_compiled(vms, "pond",
                                                 control_plane=ref_cp)
        return [np.asarray(getattr(d, f)).tolist() for f in
                ("local_gb", "pool_gb", "fully_pooled")] + [
            np.nan_to_num(np.asarray(d.t_migrate), nan=-1.0).tolist(),
            d.mispredictions, d.n_mitigations]
    raise KeyError(name)


ENTRY_POINTS = ["replay.reject_rates", "replay.availability",
                "replay.fleet", "stream.reject_rates", "stream.fleet",
                "batch.reject_rates", "batch.fleet", "batch.availability",
                "stream_batch.reject_rates", "stream_batch.fleet",
                "policy.decisions"]


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_tracing_identity_of_results(name):
    """Results ``==`` with tracing on and off; the entry point's span is
    recorded once; the same call through the reference under its own
    recorder gives the same results and the same counts of every span
    and counter both emit."""
    off = _call(name)
    rec = obs.Recorder()
    with obs.use_recorder(rec):
        on = _call(name)
    assert on == off
    m = rec.metrics()
    assert m[f"span.{name}.count"] == 1
    jrec = jax_obs.Recorder()
    with jax_obs.use_recorder(jrec):
        want = _call(name, "reference")
    assert on == want
    _assert_shared_equal(m, jrec.metrics())
    if name == "policy.decisions":
        for stage in ("decide", "place", "monitor", "mitigate"):
            assert m[f"span.policy.{stage}.count"] == 1


def _assert_shared_equal(got, want):
    """Every span count and counter both packages emit is ``==``, but for
    :data:`DIFFER_BY_DESIGN` and the launcher caches' names; names only
    one package emits are :data:`REFERENCE_ONLY`'s."""
    skip = set(DIFFER_BY_DESIGN)
    for k in set(got) | set(want):
        if k.endswith(".total_s") or k.startswith(PROCESS_STATE):
            continue
        if k in skip or k in REFERENCE_ONLY:
            assert k not in got or k in DIFFER_BY_DESIGN, k
            continue
        assert got.get(k) == want.get(k), (k, got.get(k), want.get(k))


# ------------------------------------------------------------- streams ----
def _traced_pair(fn):
    """``fn(pkg)`` under each package's own recorder: (port metrics,
    reference metrics, port result, reference result)."""
    rec, jrec = obs.Recorder(), jax_obs.Recorder()
    with obs.use_recorder(rec):
        got = fn("port")
    with jax_obs.use_recorder(jrec):
        want = fn("reference")
    return rec.metrics(), jrec.metrics(), got, want


def _stream_case(case, pkg):
    mod, ti, dev = _pkg(pkg)
    stream = _stream(pkg=pkg)             # its cuts count pad.events_*
    if case == "skip":
        return stream.reject_rates(*WIDE).tolist()
    if case == "no skip":
        return stream.reject_rates(*TIGHT).tolist()
    if case == "cap":
        return stream.reject_rates(*HOPELESS, reject_cap=0).tolist()
    if case == "numpy":
        return stream.reject_rates(*WIDE, backend="numpy").tolist()
    if case == "numpy cap":
        return stream.reject_rates(*HOPELESS, reject_cap=0,
                                   backend="numpy").tolist()
    fleet = _fleet_lanes()
    if case in ("fleet", "fleet numpy"):
        return stream.reject_rates_fleet(
            fleet[0], fleet[1], fleet[ti],
            backend=dev if case == "fleet" else "numpy").tolist()
    batch = mod.CompiledReplayStreamBatch([stream, _stream(4, pkg)])
    if case == "batch skip":
        return batch.reject_rates(*WIDE).tolist()
    if case == "batch cap":
        return batch.reject_rates(*HOPELESS, reject_cap=0).tolist()
    if case == "batch fleet":
        return batch.reject_rates_fleet(fleet[0], fleet[1],
                                        fleet[ti]).tolist()
    raise KeyError(case)


STREAM_CASES = {
    # case: (shard span, shards swept, skipped, cap exits)
    "skip": ("stream.shard", 4, 1, 0),
    "no skip": ("stream.shard", 5, 0, 0),
    "cap": ("stream.shard", 1, 0, 1),
    "numpy": ("stream.shard", 5, 0, 0),
    "numpy cap": ("stream.shard", 1, 0, 1),
    "fleet": ("stream.fleet.shard", 5, 0, 0),
    "fleet numpy": ("stream.fleet.shard", 5, 0, 0),
    "batch skip": ("stream_batch.shard", None, None, 0),
    "batch cap": ("stream_batch.shard", 1, 0, 1),
    "batch fleet": ("stream_batch.fleet.shard", None, 0, 0),
}


@pytest.mark.parametrize("case", list(STREAM_CASES))
def test_stream_spans_and_counters_equal_reference(case):
    """A stream's shard spans, its upload/wait/compute spans, the skip's
    and the cap's counters and its cuts' ``pad.events_*`` ``==`` the
    reference's on the same stream (16 or 2 lanes: one reference bucket
    of exactly those lanes, so its padded lane counts are the port's
    true ones; at most 96, one reference chunk, F10)."""
    m, jm, got, want = _traced_pair(lambda pkg: _stream_case(case, pkg))
    assert got == want
    _assert_shared_equal(m, jm)
    span, swept, skipped, exits = STREAM_CASES[case]
    if swept is not None:
        assert m[f"span.{span}.count"] == swept
    assert m.get("stream.shards_skipped", 0) == jm.get(
        "stream.shards_skipped", 0)
    if skipped is not None:
        assert m.get("stream.shards_skipped", 0) == skipped
    assert m.get("stream.reject_cap_exits", 0) == exits
    for k in ("pad.events_used", "pad.events_padded",
              "stream.events_skipped"):
        assert m.get(k) == jm.get(k), k
    if "numpy" not in case:
        n = m[f"span.{span}.count"]
        for s in ("stream.upload", "stream.upload_wait", "stream.compute"):
            assert m[f"span.{s}.count"] == n, s
        assert 0.0 <= m["stream.overlap_ratio"] <= 1.0


def test_stream_device_put_counts_the_bytes_copied():
    """A device sweep counts every host-to-device copy it makes: the
    state, the capacities, the group map and one whole feed buffer a
    shard staged."""
    stream = _stream()
    n0 = len(TIGHT[0])
    rec = obs.Recorder()
    with obs.use_recorder(rec):
        stream.reject_rates(*TIGHT)
    m = rec.metrics()
    stages = m["span.stream.upload.count"]
    assert stages == stream.n_shards
    item = 2                                          # int16 state
    rows = sweep_core.pad_up(max(stream._shard_events), 4)
    state = (2 * n0 * stream.n_servers + n0 * stream.n_groups
             + stream._n_slots * n0) * item + 4 * n0
    fixed = state + 2 * n0 * item + 4 * stream.n_servers
    assert m["device_put.bytes"] == fixed + stages * 6 * 4 * rows
    assert m["device_put.calls"] == 8 + stages


def test_tracing_off_takes_the_plain_shard_loop():
    """With tracing off the feed is untimed and the loop never reaches the
    traced branch (no event, no host wait, no span)."""
    stream = _stream()
    assert not stream._feed().timed
    called = []
    orig = re._traced_shards
    try:
        re._traced_shards = lambda *a, **k: called.append(1) or orig(*a, **k)
        off = stream.reject_rates(*TIGHT)
        with obs.use_recorder(obs.Recorder()):
            on = stream.reject_rates(*TIGHT)
    finally:
        re._traced_shards = orig
    assert called == [1]
    assert off.tolist() == on.tolist()


def test_checkpoint_spans_equal_reference(tmp_path):
    """``checkpoint.save`` a snapshot and ``checkpoint.load`` a resume,
    ``==`` the reference's through a kill and a resume."""
    def run(pkg):
        stream = _stream(pkg=pkg)
        mod = re if pkg == "port" else jax_re
        path = str(tmp_path / f"{pkg}.ckpt.npz")
        with pytest.raises(mod.SweepInterrupted):
            stream.reject_rates(*TIGHT, checkpoint=mod.CheckpointSpec(
                path, every_shards=1, kill_after_shards=2))
        return stream.reject_rates(*TIGHT, checkpoint=mod.CheckpointSpec(
            path, every_shards=1, resume=True)).tolist()

    m, jm, got, want = _traced_pair(run)
    assert got == want
    assert m["span.checkpoint.load.count"] == 1
    assert m["span.checkpoint.save.count"] == 2 + 3
    _assert_shared_equal(m, jm)
