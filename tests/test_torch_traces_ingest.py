"""Real-trace ingestion of the port (``core/traces.py``) against the
reference's: every case of ``tests/test_traces_ingest.py`` run through
both packages on the same file, the ``VM`` records compared field for
field (the synthesised customers, untouched fractions, slowdowns and PMU
rows included) and every exception compared by class name and message."""
import gzip
import os

import numpy as np
import pytest

from repro.core import cluster_sim as jax_cs
from repro.core import replay_engine as jax_re
from repro.core import traces as jax_traces
from repro_torch.core import cluster_sim as cs
from repro_torch.core import replay_engine as re
from repro_torch.core import traces


def _write(tmp_path, name, text):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


def _record(vm):
    """Every field of a VM, the PMU row as its float32 values."""
    return (vm.vm_id, vm.customer, vm.vm_type, vm.location, vm.guest_os,
            vm.cores, vm.mem_gb, vm.arrival, vm.lifetime, vm.untouched,
            vm.slow182, vm.slow222, vm.pmu.dtype.str, vm.pmu.tolist())


def _outcome(call):
    """``("ok", value)`` or ``("raise", class name, message)``."""
    try:
        return ("ok", call())
    except Exception as e:              # noqa: BLE001 (compared below)
        return ("raise", type(e).__name__, str(e))


def _load(mod, path, **kw):
    return _outcome(lambda: [_record(v)
                             for v in mod.load_trace_file(path, **kw)])


def _chunks(mod, path, **kw):
    """The chunk boundaries and every record, or the exception."""
    return _outcome(lambda: [[_record(v) for v in ch]
                             for ch in mod.iter_trace_chunks(path, **kw)])


def _same_load(path, **kw):
    got, want = _load(traces, path, **kw), _load(jax_traces, path, **kw)
    assert got == want
    return got


def _same_chunks(path, **kw):
    got, want = _chunks(traces, path, **kw), _chunks(jax_traces, path, **kw)
    assert got == want
    return got


def test_missing_columns_raise_named_error(tmp_path):
    p = _write(tmp_path, "bad.csv", "arrival,cores\n1,2\n")
    out = _same_load(p)
    assert out[:2] == ("raise", "TraceSchemaError")
    assert "mem_gb" in out[2] and "lifetime" in out[2]
    with pytest.raises(traces.TraceSchemaError):
        traces.load_trace_file(p)


def test_non_numeric_cell_names_row_and_column(tmp_path):
    p = _write(tmp_path, "nonnum.csv",
               "arrival,lifetime,cores,mem_gb\n0,10,2,4\n1,abc,2,4\n")
    out = _same_load(p)
    assert out[0] == "raise" and "row 2" in out[2] and "lifetime" in out[2]


def test_value_range_validation(tmp_path):
    for name, text in (("neg.csv", "arrival,lifetime,cores,mem_gb\n"
                                   "0,-5,2,4\n"),
                       ("zmem.csv", "arrival,lifetime,cores,mem_gb\n"
                                    "0,5,2,0\n"),
                       ("inf.csv", "arrival,lifetime,cores,mem_gb\n"
                                   "0,5,inf,4\n")):
        out = _same_load(_write(tmp_path, name, text))
        assert out[:2] == ("raise", "TraceSchemaError"), name


def test_empty_and_unsupported_files(tmp_path):
    out = _same_load(_write(tmp_path, "hdr.csv",
                            "arrival,lifetime,cores,mem_gb\n"))
    assert out[0] == "raise" and "no rows" in out[2]
    out = _same_load(_write(tmp_path, "x.tsv", "arrival\n1\n"))
    assert out[0] == "raise" and "unsupported" in out[2]
    out = _same_load(_write(tmp_path, "empty.csv", ""))
    assert out[0] == "raise" and "no header" in out[2]
    assert issubclass(traces.TraceSchemaError, ValueError)
    assert traces.TRACE_COLUMNS == jax_traces.TRACE_COLUMNS
    assert traces._COLUMN_ALIASES == jax_traces._COLUMN_ALIASES


def test_azure_aliases_and_departure_column(tmp_path):
    p = _write(tmp_path, "azure.csv",
               "vmcreated,vmdeleted,vmcorecount,vmmemory\n"
               "0,100,2,4\n10,50,4,8\n")
    out = _same_load(p)
    assert [r[5:9] for r in out[1]] == [(2, 4.0, 0.0, 100.0),
                                        (4, 8.0, 10.0, 40.0)]


def test_loader_is_deterministic_and_sorted(tmp_path):
    p = _write(tmp_path, "t.csv",
               "arrival,lifetime,cores,mem_gb\n"
               "50,10,2,4\n0,20,4,8\n25,30,8,16\n")
    for kw in (dict(seed=3), dict(seed=0), dict(max_vms=2),
               dict(start_id=7, seed=5)):
        out = _same_load(p, **kw)
        assert out[0] == "ok"
        assert out == _load(traces, p, **kw)            # deterministic
    assert [r[7] for r in _same_load(p)[1]] == [0.0, 25.0, 50.0]
    # an explicit prior draws the same fields in both packages
    got = _load(traces, p, population=traces.Population(12, seed=9))
    want = _load(jax_traces, p, population=jax_traces.Population(12, seed=9))
    assert got == want


def test_string_vm_ids_remap_and_duplicates_raise(tmp_path):
    p = _write(tmp_path, "ids.csv",
               "vmid,arrival,lifetime,cores,mem_gb\n"
               "a9f3,0,10,2,4\nb771,5,10,2,4\n")
    assert [r[0] for r in _same_load(p, start_id=100)[1]] == [100, 101]
    p = _write(tmp_path, "dup.csv",
               "vmid,arrival,lifetime,cores,mem_gb\n"
               "a9f3,0,10,2,4\nb771,5,10,2,4\na9f3,8,10,2,4\n")
    assert "duplicate vm_id" in _same_load(p)[2]
    p = _write(tmp_path, "dupnum.csv",
               "vmid,arrival,lifetime,cores,mem_gb\n"
               "7,0,10,2,4\n7,5,10,2,4\n")
    assert "duplicate vm_id" in _same_load(p)[2]


def test_parquet_round_trip_or_named_error(tmp_path):
    """With pyarrow the parquet file loads as the reference loads it;
    without it both packages raise the same error naming pyarrow."""
    p = str(tmp_path / "t.parquet")
    try:
        import pyarrow as pa
        import pyarrow.parquet as pq
    except ImportError:
        open(p, "wb").close()
        out = _same_load(p)
        assert out[:2] == ("raise", "TraceSchemaError")
        assert "pyarrow" in out[2]
        return
    pq.write_table(pa.table({"arrival": [0.0, 5.0],
                             "lifetime": [10.0, 20.0],
                             "cores": [2, 4], "mem_gb": [4.0, 8.0]}), p)
    out = _same_load(p)
    assert [(r[7], r[5]) for r in out[1]] == [(0.0, 2), (5.0, 4)]
    assert _same_chunks(p, chunk_vms=1)[0] == "ok"


def test_save_trace_csv_round_trips(tmp_path):
    pop = traces.Population(n_customers=8, seed=5)
    orig = pop.sample_vms(20, 86400, seed=5)
    p, q = str(tmp_path / "rt.csv"), str(tmp_path / "ref.csv")
    traces.save_trace_csv(orig, p)
    jax_traces.save_trace_csv(orig, q)
    with open(p, "rb") as f, open(q, "rb") as g:
        assert f.read() == g.read()            # byte for byte
    back = _same_load(p)[1]
    key = sorted(orig, key=lambda v: v.arrival)
    for a, b in zip(key, back):
        assert (round(a.arrival, 3), round(a.lifetime, 3), a.cores,
                a.mem_gb) == (b[7], b[8], b[5], b[6])
        assert abs(a.untouched - b[9]) < 1e-3
    # gzipped, the same text
    gz = str(tmp_path / "rt.csv.gz")
    traces.save_trace_csv(orig, gz)
    with gzip.open(gz, "rb") as f, open(q, "rb") as g:
        assert f.read() == g.read()


def test_chunked_reader_matches_monolithic_loader(tmp_path):
    """Concatenated chunks of an arrival-sorted file reproduce
    load_trace_file's schema columns (and ids/customers) exactly, for
    CSV, CSV.gz and parquet; every chunk equals the reference's."""
    path = traces.fixture_trace_path()
    mono = traces.load_trace_file(path)
    paths = [path]
    gz = str(tmp_path / "fx.csv.gz")
    traces.save_trace_csv(mono, gz)
    paths.append(gz)
    try:
        import pyarrow as pa
        import pyarrow.parquet as pq
        pqp = str(tmp_path / "fx.parquet")
        pq.write_table(pa.table({
            "arrival": [v.arrival for v in mono],
            "lifetime": [v.lifetime for v in mono],
            "cores": [v.cores for v in mono],
            "mem_gb": [v.mem_gb for v in mono],
            "vm_id": [v.vm_id for v in mono],
            "customer": [v.customer for v in mono]}), pqp)
        paths.append(pqp)
    except ImportError:
        pass
    key = [(v.vm_id, v.customer, round(v.arrival, 3),
            round(v.lifetime, 3), v.cores, v.mem_gb) for v in mono]
    for p in paths:
        out = _same_chunks(p, chunk_vms=7)
        got = [(r[0], r[1], round(r[7], 3), round(r[8], 3), r[5], r[6])
               for ch in out[1] for r in ch]
        assert got == key, p
    first = _same_chunks(path, chunk_vms=7, max_vms=10)[1]
    assert [r[0] for ch in first for r in ch] == \
        [v.vm_id for v in mono[:10]]
    _same_chunks(path, chunk_vms=5, seed=4, start_id=3)


def test_chunked_reader_reports_global_rows_csv_gz(tmp_path):
    rows = ["arrival,lifetime,cores,mem_gb"] + \
        [f"{10 * i},100,2,4" for i in range(9)] + ["95,-3,2,4"]
    p = str(tmp_path / "bad.csv.gz")
    with gzip.open(p, "wt") as f:
        f.write("\n".join(rows) + "\n")
    out = _same_chunks(p, chunk_vms=3)
    assert out[0] == "raise" and "row 10" in out[2] and "lifetime" in out[2]


def test_chunked_reader_reports_global_rows_parquet(tmp_path):
    pa = pytest.importorskip("pyarrow")
    pq = pytest.importorskip("pyarrow.parquet")
    p = str(tmp_path / "bad.parquet")
    pq.write_table(pa.table({"arrival": [float(10 * i) for i in range(10)],
                             "lifetime": [100.0] * 10,
                             "cores": [2] * 10,
                             "mem_gb": [4.0] * 9 + [0.0]}), p,
                   row_group_size=3)
    out = _same_chunks(p, chunk_vms=3)
    assert out[0] == "raise" and "row 10" in out[2] and "mem_gb" in out[2]


def test_chunked_reader_rejects_unsorted_chunk_boundaries(tmp_path):
    p = _write(tmp_path, "unsorted.csv",
               "arrival,lifetime,cores,mem_gb\n" +
               "".join(f"{t},50,2,4\n" for t in (0, 10, 20, 5, 30)))
    out = _same_chunks(p, chunk_vms=3)
    assert out[0] == "raise" and "non-decreasing" in out[2] \
        and "row 4" in out[2]
    assert len(_same_load(p)[1]) == 5
    ok = _same_chunks(p, chunk_vms=5)[1]
    assert [r[7] for ch in ok for r in ch] == [0.0, 5.0, 10.0, 20.0, 30.0]


def test_chunked_reader_alias_collision_last_header_wins(tmp_path):
    p = _write(tmp_path, "collide.csv",
               "arrival,lifetime,vmcorecount,vmcorecountbucket,mem_gb\n"
               "0,10,2,4,8\n5,10,2,4,8\n")
    mono = _same_load(p)[1]
    cat = [r for ch in _same_chunks(p, chunk_vms=1)[1] for r in ch]
    assert [r[5] for r in mono] == [4, 4]
    assert [(r[5], r[6]) for r in cat] == [(r[5], r[6]) for r in mono]


def test_chunked_reader_empty_and_duplicate_ids(tmp_path):
    p = _write(tmp_path, "hdr.csv", "arrival,lifetime,cores,mem_gb\n")
    assert "no rows" in _same_chunks(p)[2]
    p = _write(tmp_path, "dup.csv",
               "vmid,arrival,lifetime,cores,mem_gb\n"
               "7,0,10,2,4\n8,5,10,2,4\n7,8,10,2,4\n")
    assert "duplicate vm_id" in _same_chunks(p, chunk_vms=2)[2]
    p = _write(tmp_path, "mixed.csv",
               "vmid,arrival,lifetime,cores,mem_gb\n"
               "7,0,10,2,4\nab,5,10,2,4\n")
    assert "non-numeric vm_id" in _same_chunks(p, chunk_vms=1)[2]


def test_fixture_exists_and_replays_through_engine():
    path = traces.fixture_trace_path()
    assert os.path.isfile(path)
    assert os.path.dirname(path) != os.path.dirname(
        jax_traces.fixture_trace_path())
    with open(path, "rb") as f, \
            open(jax_traces.fixture_trace_path(), "rb") as g:
        assert f.read() == g.read()
    recs = _same_load(path)[1]
    assert len(recs) >= 20
    vms, jvms = traces.load_trace_file(path), jax_traces.load_trace_file(path)
    cfg = cs.ClusterConfig(n_servers=4, pool_sockets=4, gb_per_core=4.0)
    jcfg = jax_cs.ClusterConfig(n_servers=4, pool_sockets=4, gb_per_core=4.0)
    dec, _ = cs.policy_decisions(vms, "static", static_pool_frac=0.25)
    jdec, _ = jax_cs.policy_decisions(jvms, "static", static_pool_frac=0.25)
    eng = re.CompiledReplay(vms, dec, cfg, device="cpu")
    server = np.array([768.0, 120.0, 60.0, 30.0])
    pool = np.array([512.0, 64.0, 0.0, 512.0])
    got = eng.reject_rates(server, pool)
    want = [jax_cs.replay_reject_rate(jvms, jdec, jcfg, s, p)
            for s, p in zip(server, pool)]
    assert got.tolist() == want
    assert got.tolist() == jax_re.CompiledReplay(jvms, jdec, jcfg) \
        .reject_rates(server, pool, backend="numpy").tolist()
    assert got[0] == 0.0


# ---------------------------------------------------------------------------
# Fault-hardened ingestion: malformed-row quarantine + transient-IO retry.

_DIRTY = ("vmid,arrival,lifetime,cores,mem_gb\n"
          "1,0,100,2,4\n"
          "2,5,abc,2,4\n"        # row 2: non-numeric lifetime
          "3,10,100,2,4\n"
          "4,12,100,0,4\n"       # row 4: cores < 1
          "5,15,100,2,4\n"
          "6,20,100,2,-8\n"      # row 6: mem_gb <= 0
          "7,25,100,2,4\n")
_CLEAN = ("vmid,arrival,lifetime,cores,mem_gb\n"
          "1,0,100,2,4\n3,10,100,2,4\n5,15,100,2,4\n7,25,100,2,4\n")


def _schema(records):
    return [(r[0], r[7], r[8], r[5], r[6]) for r in records]


def _quarantined(mod, path, budget, **kw):
    report = mod.IngestReport(max_bad_rows=budget)
    out = _chunks(mod, path, report=report, **kw)
    return out, report.summary()


@pytest.mark.chaos
def test_quarantine_keeps_good_rows_and_records_bad(tmp_path):
    dirty = _write(tmp_path, "dirty.csv", _DIRTY)
    clean = _write(tmp_path, "clean.csv", _CLEAN)
    assert "row 2" in _same_chunks(dirty, chunk_vms=2)[2]
    got = _quarantined(traces, dirty, 3, chunk_vms=2)
    assert got == _quarantined(jax_traces, dirty, 3, chunk_vms=2)
    (status, chunks), summary = got
    kept = [r for ch in chunks for r in ch]
    assert _schema(kept) == _schema(_same_load(clean)[1])
    assert summary["n_quarantined"] == 3 and summary["io_retries"] == 0
    assert [r["row"] for r in summary["bad_rows"]] == [2, 4, 6]
    assert [r["column"] for r in summary["bad_rows"]] == \
        ["lifetime", "cores", "mem_gb"]
    assert "finite" in summary["bad_rows"][0]["reason"]
    alt = _same_chunks(dirty, chunk_vms=2, max_bad_rows=3)[1]
    assert _schema([r for ch in alt for r in ch]) == _schema(kept)


def test_quarantine_budget_exceeded_raises(tmp_path):
    dirty = _write(tmp_path, "dirty.csv", _DIRTY)
    out = _same_chunks(dirty, chunk_vms=2, max_bad_rows=1)
    assert out[:2] == ("raise", "TraceSchemaError")
    assert "max_bad_rows=1" in out[2] and "row 4" in out[2] \
        and "cores" in out[2]


def test_quarantine_drops_whole_chunk_and_keeps_order_check(tmp_path):
    p = _write(tmp_path, "allbad.csv",
               "arrival,lifetime,cores,mem_gb\n"
               "0,100,2,4\n5,100,2,4\n"
               "x,100,2,4\n9,nan,2,4\n"
               "12,100,2,4\n")
    kept = _same_chunks(p, chunk_vms=2, max_bad_rows=2)[1]
    assert [r[7] for ch in kept for r in ch] == [0.0, 5.0, 12.0]
    p2 = _write(tmp_path, "unsorted.csv",
                "arrival,lifetime,cores,mem_gb\n"
                "0,100,2,4\n20,100,2,4\n"
                "x,100,2,4\n5,100,2,4\n")
    assert "non-decreasing" in _same_chunks(p2, chunk_vms=2,
                                            max_bad_rows=5)[2]
    p3 = _write(tmp_path, "dup.csv",
                "vmid,arrival,lifetime,cores,mem_gb\n"
                "7,0,100,2,4\n7,5,100,2,4\n")
    assert "duplicate" in _same_chunks(p3, chunk_vms=1, max_bad_rows=5)[2]
    # departure-aliased lifetimes quarantine under the departure column
    p4 = _write(tmp_path, "dep.csv",
                "arrival,departure,cores,mem_gb\n"
                "0,100,2,4\n5,3,2,4\n8,x,2,4\n9,20,2,4\n")
    got = _quarantined(traces, p4, 5, chunk_vms=3)
    assert got == _quarantined(jax_traces, p4, 5, chunk_vms=3)
    assert [r["column"] for r in got[1]["bad_rows"]] == ["lifetime"] * 2


def _flaky(monkeypatch, mod, fail_after):
    """Patch ``mod._iter_raw_chunks`` so call k raises OSError after
    yielding fail_after[k] chunks (absent k => clean), and capture the
    backoffs."""
    real = mod._iter_raw_chunks
    calls = []

    def wrapper(path, chunk_vms):
        k = len(calls)
        calls.append(k)
        limit = fail_after.get(k)
        for i, cols in enumerate(real(path, chunk_vms)):
            if limit is not None and i >= limit:
                raise OSError("transient read failure")
            yield cols

    monkeypatch.setattr(mod, "_iter_raw_chunks", wrapper)
    sleeps = []
    monkeypatch.setattr(mod, "_sleep", sleeps.append)
    return sleeps


@pytest.mark.chaos
def test_io_retry_resumes_after_transient_errors(monkeypatch):
    path = traces.fixture_trace_path()
    baseline = _same_chunks(path, chunk_vms=7)
    outs = []
    for mod in (traces, jax_traces):
        sleeps = _flaky(monkeypatch, mod, {0: 1, 1: 2})
        report = mod.IngestReport()
        out = _chunks(mod, path, chunk_vms=7, io_retries=1,
                      io_backoff_s=0.125, report=report)
        outs.append((out, report.summary(), sleeps))
    assert outs[0] == outs[1]
    out, summary, sleeps = outs[0]
    assert out == baseline
    assert summary["io_retries"] == 2
    assert sleeps == [0.125, 0.125]


def test_io_retry_budget_exhausted_reraises(monkeypatch):
    path = traces.fixture_trace_path()
    outs = []
    for mod in (traces, jax_traces):
        sleeps = _flaky(monkeypatch, mod, {k: 0 for k in range(10)})
        outs.append((_chunks(mod, path, chunk_vms=7, io_retries=2,
                             io_backoff_s=0.125), sleeps))
    assert outs[0] == outs[1]
    (status, name, msg), sleeps = outs[0]
    assert (status, name) == ("raise", "OSError") and "transient" in msg
    assert sleeps == [0.125, 0.25]


def test_schema_errors_are_never_retried(tmp_path, monkeypatch):
    dirty = _write(tmp_path, "dirty.csv", _DIRTY)
    outs = []
    for mod in (traces, jax_traces):
        sleeps = _flaky(monkeypatch, mod, {})
        outs.append((_chunks(mod, dirty, chunk_vms=2, io_retries=3),
                     sleeps))
    assert outs[0] == outs[1]
    (status, name, msg), sleeps = outs[0]
    assert name == "TraceSchemaError" and "max_bad_rows=0" in msg
    assert sleeps == []


# ---------------------------------------------------------------------------
# The file-fed path of examples/torch_azure_e2e.py against the reference's
# benchmarks/azure_e2e.py, at a small size on the CPU.

def _example(name):
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_azure_example_streams_the_dump_like_the_reference(tmp_path):
    """The stand-in dump is the benchmark's byte for byte; the example's
    file-fed stream (decisions sliced by ``decide=``) prices its probes
    as the reference's stream and as the port's monolithic engine of
    ``load_trace_file``, and a sweep killed after two shards resumes from
    its checkpoint to the same rates."""
    from benchmarks import azure_e2e
    ex = _example("torch_azure_e2e")
    p, q = str(tmp_path / "port.csv.gz"), str(tmp_path / "ref.csv.gz")
    ex.synth_dump(p, n_vms=1500)
    azure_e2e.synth_dump(q, n_vms=1500)
    with gzip.open(p, "rb") as f, gzip.open(q, "rb") as g:
        assert f.read() == g.read()
    cfg = cs.ClusterConfig(n_servers=2, pool_sockets=4, gb_per_core=4.75)
    jcfg = jax_cs.ClusterConfig(n_servers=2, pool_sockets=4,
                                gb_per_core=4.75)
    out = ex.e2e_dump_bench(p, cfg, budget=512, chunk_vms=256,
                            max_bad_rows=2, device="cpu")
    jvms = jax_traces.load_trace_file(q)
    jdec, _ = jax_cs.policy_decisions(jvms, "static", static_pool_frac=0.30,
                                      as_arrays=True)
    off = [0]

    def decide(chunk):
        off[0] += len(chunk)
        return jdec.slice(off[0] - len(chunk), off[0])

    ref = jax_re.CompiledReplayStream(
        jax_traces.iter_trace_chunks(q, chunk_vms=256), None, jcfg,
        max_events_per_shard=512, decide=decide)
    server, pool = ex.probes(cfg)
    want = ref.reject_rates(server, pool)
    assert out["rates"] == want.tolist()
    assert len(set(out["rates"])) > 1               # memory binds
    assert (out["n_vms"], out["n_events"], out["n_shards"],
            out["peak_shard_bytes"]) == (ref.n_vms, ref.n_events,
                                          ref.n_shards, ref.peak_shard_bytes)
    assert out["ingest_report"] == {"n_quarantined": 0, "io_retries": 0,
                                    "bad_rows": []}
    pvms = traces.load_trace_file(p)
    pdec, _ = cs.policy_decisions(pvms, "static", static_pool_frac=0.30,
                                  as_arrays=True)
    mono = re.CompiledReplay(pvms, pdec, cfg, device="cpu")
    assert mono.reject_rates(server, pool).tolist() == out["rates"]
    ck = str(tmp_path / "sweep.npz")
    with pytest.raises(re.SweepInterrupted):
        ex.e2e_dump_bench(p, cfg, budget=512, chunk_vms=256, device="cpu",
                          checkpoint=re.CheckpointSpec(
                              ck, every_shards=1, kill_after_shards=2))
    resumed = ex.e2e_dump_bench(p, cfg, budget=512, chunk_vms=256,
                                device="cpu",
                                checkpoint=re.CheckpointSpec(
                                    ck, every_shards=1, resume=True))
    assert resumed["checkpoint"]["rates"] == out["rates"]
