"""Synthetic Azure-like VM traces, calibrated to Pond's published stats.

The provisioning loop's input: :class:`Population` samples VMs from
per-customer profiles, and the same seeds give bit-identical VMs to the
reference's sampler (the same numpy generator calls in the same order).
Calibration targets (held by the reference's benchmarks and tests):

  * untouched memory: ~50% of VMs touch less than 50% of their DRAM
    (§3.2 — p50 untouched = 50%), customer-correlated (Resource Central).
  * slowdown @182% latency (Fig 5): 26% of workloads <1%, 43% <5%,
    21% >25%;  @222%: 23% <1%, 37% <5%, 37% >25%; monotone between the two.
  * PMU/TMA counters correlated with slowdown but with deliberate
    counterexamples (Finding 4: >20% slowdown at 2% DRAM-bound).
  * VM shapes: 2-48 cores, 2-8 GB/core, lognormal lifetimes.

Real-trace ingestion (``load_trace_file``, ``iter_trace_chunks``): external
VM traces, e.g. the Azure public VM traces, load into the same :class:`VM`
records the sampler emits, so the replay engine, the cluster simulator and
the control plane run on them unchanged.  The replay needs only the
``(arrival, lifetime, cores, mem_gb)`` columns; workload fields a file does
not carry (untouched memory, slowdowns, PMU counters) are synthesised from
a :class:`Population` prior with the reference's generator draws in the
reference's order, so every field equals the reference loader's.  A
miniature fixture trace ships with the package (``fixture_trace_path()``).

Host numpy only.  With tracing on (``core/obs.py``) ingestion records the
reference's ``ingest.chunk`` span and ``ingest.*`` counters.
"""
from __future__ import annotations

import csv
import dataclasses
import gzip
import os
import time

import numpy as np

from repro_torch.core import obs

N_PMU_FEATURES = 32

# piecewise slowdown bands: (cum_prob, lo, hi)
_BANDS_182 = [(0.26, 0.0, 0.01), (0.43, 0.01, 0.05),
              (0.79, 0.05, 0.25), (1.0, 0.25, 0.50)]
_BANDS_222 = [(0.23, 0.0, 0.01), (0.37, 0.01, 0.05),
              (0.63, 0.05, 0.25), (1.0, 0.25, 0.60)]


def _piecewise(u: np.ndarray, bands) -> np.ndarray:
    out = np.zeros_like(u)
    prev = 0.0
    for cum, lo, hi in bands:
        m = (u >= prev) & (u < cum)
        out[m] = lo + (u[m] - prev) / max(cum - prev, 1e-9) * (hi - lo)
        prev = cum
    return out


@dataclasses.dataclass
class VM:
    vm_id: int
    customer: int
    vm_type: int
    location: int
    guest_os: int
    cores: int
    mem_gb: float
    arrival: float          # seconds
    lifetime: float         # seconds
    untouched: float        # fraction of mem_gb never touched
    slow182: float
    slow222: float
    pmu: np.ndarray         # (N_PMU_FEATURES,)

    @property
    def departure(self) -> float:
        return self.arrival + self.lifetime


class Population:
    """Customer/workload priors; VMs sample from their customer's profile."""

    def __init__(self, n_customers: int = 200, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.n_customers = n_customers
        # zipf-ish popularity (computed first: the latent intensity u is
        # stratified so the VM-weighted u distribution stays ~uniform and
        # the Fig-4/5 slowdown bands hold regardless of popularity skew)
        w = 1.0 / np.arange(1, n_customers + 1) ** 0.7
        self.cust_popularity = w / w.sum()
        perm = rng.permutation(n_customers)
        p_perm = self.cust_popularity[perm]
        bands = np.cumsum(p_perm) - p_perm / 2
        u = np.empty(n_customers)
        u[perm] = bands                     # band width == popularity
        self.cust_u = u
        self.cust_untouched = rng.beta(2.0, 2.0, n_customers)
        self.cust_type = rng.integers(0, 12, n_customers)
        self.cust_loc = rng.integers(0, 6, n_customers)
        self.cust_os = rng.integers(0, 4, n_customers)
        # staggered demand waves: each customer bursts at its own daily
        # phase (per-server peaks do not coincide — the variance pooling
        # absorbs)
        self.cust_phase = rng.uniform(0, 86400, n_customers)
        self.cust_burstiness = rng.uniform(0.2, 0.9, n_customers)

    def _pmu(self, u: float, rng) -> np.ndarray:
        f = np.zeros(N_PMU_FEATURES, np.float32)
        # Finding 4: ~6% of workloads break the dram_bound correlation
        confuse = rng.random() < 0.06
        eff_u = rng.random() * 0.15 if confuse else u
        f[0] = np.clip(0.02 + 0.55 * eff_u ** 1.4
                       + rng.normal(0, 0.015), 0, 1)      # dram_bound
        # TMA "memory bound" also counts L1/store stalls that say nothing
        # about pool-latency sensitivity -> a noisier counter (Finding 5)
        f[1] = np.clip(f[0] + 0.06 + 0.25 * rng.random()
                       + abs(rng.normal(0, 0.05)), 0, 1)
        f[2] = np.clip(0.3 * eff_u + rng.normal(0, 0.05), 0, 1)   # l3
        f[3] = np.clip(2.6 - 2.0 * eff_u + rng.normal(0, 0.2), 0.1, 4)  # ipc
        f[4] = np.clip(0.5 * eff_u + rng.normal(0, 0.1), 0, 1)    # bw util
        f[5] = np.clip(rng.normal(0.2, 0.1), 0, 1)        # frontend bound
        f[6] = np.clip(rng.normal(0.1, 0.05), 0, 1)       # bad spec
        f[7:] = rng.random(N_PMU_FEATURES - 7)            # uninformative
        return f

    def sample_vms(self, n: int, horizon_s: float, seed: int = 1,
                   start_id: int = 0) -> list[VM]:
        rng = np.random.default_rng(seed)
        custs = rng.choice(self.n_customers, n, p=self.cust_popularity)
        base = rng.uniform(0, horizon_s, n)
        # concentrate each customer's arrivals near its daily phase
        tod = np.where(
            rng.random(n) < self.cust_burstiness[custs],
            (self.cust_phase[custs]
             + rng.normal(0, 3 * 3600, n)) % 86400,
            rng.uniform(0, 86400, n))
        arrivals = np.minimum(
            np.floor(base / 86400) * 86400 + tod, horizon_s - 1)
        order = np.argsort(arrivals)
        custs, arrivals = custs[order], arrivals[order]
        vms = []
        for i in range(n):
            c = int(custs[i])
            u = float(np.clip(self.cust_u[c]
                              + rng.normal(0, 0.02), 0, 0.999999))
            cores = int(rng.choice([2, 4, 8, 16, 32, 48],
                                   p=[.30, .25, .20, .15, .07, .03]))
            ratio = float(rng.choice([2.0, 4.0, 8.0], p=[.35, .45, .20]))
            untouched = float(np.clip(self.cust_untouched[c]
                                      + rng.normal(0, 0.10), 0, 1))
            life = float(np.clip(rng.lognormal(np.log(2 * 3600), 1.4),
                                 300, 30 * 86400))
            vms.append(VM(
                vm_id=start_id + i, customer=c,
                vm_type=int(self.cust_type[c]),
                location=int(self.cust_loc[c]),
                guest_os=int(self.cust_os[c]),
                cores=cores, mem_gb=cores * ratio,
                arrival=float(arrivals[i]), lifetime=life,
                untouched=untouched,
                slow182=float(_piecewise(np.array([u]), _BANDS_182)[0]),
                slow222=float(_piecewise(np.array([u]), _BANDS_222)[0]),
                pmu=self._pmu(u, rng)))
        return vms


# ------------------------------------------------- struct-of-arrays view ---
@dataclasses.dataclass
class VMTable:
    """Struct-of-arrays view of a VM list (one array per field); column
    ``i`` of every array corresponds to ``vms[i]``."""
    vm_id: np.ndarray       # (N,) int64
    customer: np.ndarray    # (N,) int64
    vm_type: np.ndarray     # (N,) int64
    location: np.ndarray    # (N,) int64
    guest_os: np.ndarray    # (N,) int64
    cores: np.ndarray       # (N,) int64
    mem_gb: np.ndarray      # (N,) float64
    arrival: np.ndarray     # (N,) float64
    lifetime: np.ndarray    # (N,) float64
    untouched: np.ndarray   # (N,) float64
    slow182: np.ndarray     # (N,) float64
    slow222: np.ndarray     # (N,) float64
    pmu: np.ndarray         # (N, N_PMU_FEATURES) float32

    def __len__(self) -> int:
        return len(self.vm_id)


_INT_FIELDS = ("vm_id", "customer", "vm_type", "location", "guest_os",
               "cores")
_FLOAT_FIELDS = ("mem_gb", "arrival", "lifetime", "untouched", "slow182",
                 "slow222")


def vm_table(vms) -> VMTable:
    """Compile a VM list into a :class:`VMTable` (one pass)."""
    n = len(vms)
    cols = {a: np.fromiter((getattr(vm, a) for vm in vms), np.int64, n)
            for a in _INT_FIELDS}
    cols |= {a: np.fromiter((getattr(vm, a) for vm in vms), float, n)
             for a in _FLOAT_FIELDS}
    cols["pmu"] = (np.stack([vm.pmu for vm in vms]) if n
                   else np.empty((0, N_PMU_FEATURES), np.float32))
    return VMTable(**cols)


def vms_from_table(columns: dict) -> list[VM]:
    """The inverse of :func:`vm_table`: ``VM`` records from numpy columns
    keyed by field name (a ``dataclasses.asdict`` of a ``VMTable``, from
    either package).  Integer fields become Python ints, float fields
    Python floats and ``pmu`` rows float32 arrays, as the sampler makes
    them, so the records replay exactly like the originals."""
    n = len(columns["vm_id"])
    ints = {a: np.asarray(columns[a], np.int64).tolist()
            for a in _INT_FIELDS}
    floats = {a: np.asarray(columns[a], float).tolist()
              for a in _FLOAT_FIELDS}
    pmu = np.asarray(columns["pmu"], np.float32)
    return [VM(**{a: ints[a][i] for a in _INT_FIELDS},
               **{a: floats[a][i] for a in _FLOAT_FIELDS},
               pmu=pmu[i].copy()) for i in range(n)]


def pmu_matrix(vms) -> np.ndarray:
    return np.stack([vm.pmu for vm in vms])


def slowdowns(vms, latency: int = 182) -> np.ndarray:
    return np.array([vm.slow182 if latency == 182 else vm.slow222
                     for vm in vms])


# -------------------------------------------------- UM-model features ------
def metadata_features(vms, history: dict | None = None) -> np.ndarray:
    """UM-model features: customer history percentiles (the paper's
    strongest feature) + VM metadata."""
    hist = history or {}
    rows = []
    for vm in vms:
        h = hist.get(vm.customer)
        if h is None or len(h) < 3:
            percs = [0.5, 0.5, 0.5, 0.5]        # no-history prior
        else:
            percs = list(np.percentile(h, [80, 90, 95, 99]))
        rows.append(percs + [vm.vm_type, vm.cores, vm.mem_gb,
                             vm.location, vm.guest_os])
    return np.asarray(rows, np.float32)


def build_history(vms) -> dict:
    """Past untouched-memory observations per customer (rolling week)."""
    hist: dict[int, list] = {}
    for vm in vms:
        hist.setdefault(vm.customer, []).append(vm.untouched)
    return {c: np.asarray(v) for c, v in hist.items()}


# ------------------------------------------------- real-trace ingestion ----
class TraceSchemaError(ValueError):
    """A trace file failed schema validation (missing/bad columns, bad
    values).  Subclasses ValueError so callers can catch either."""


#: canonical columns the replay engine needs; a ``departure`` column may
#: substitute for ``lifetime`` (lifetime = departure - arrival)
TRACE_COLUMNS = ("arrival", "lifetime", "cores", "mem_gb")

#: lowercase header aliases -> canonical names (Azure public-trace
#: spellings included: vmcreated/vmdeleted timestamps, core/memory counts)
_COLUMN_ALIASES = {
    "arrival": "arrival", "start": "arrival", "starttime": "arrival",
    "created": "arrival", "vmcreated": "arrival", "start_time": "arrival",
    "lifetime": "lifetime", "duration": "lifetime", "life": "lifetime",
    "departure": "departure", "end": "departure", "endtime": "departure",
    "deleted": "departure", "vmdeleted": "departure",
    "end_time": "departure",
    "cores": "cores", "core_count": "cores", "vmcorecount": "cores",
    "vcpus": "cores", "vmcorecountbucket": "cores",
    "mem_gb": "mem_gb", "mem": "mem_gb", "memory": "mem_gb",
    "memory_gb": "mem_gb", "vmmemory": "mem_gb",
    "vmmemorybucket": "mem_gb",
    "customer": "customer", "customer_id": "customer",
    "subscriptionid": "customer", "tenant": "customer",
    "vm_id": "vm_id", "vmid": "vm_id",
    "untouched": "untouched", "untouched_frac": "untouched",
}


def fixture_trace_path() -> str:
    """Path of the bundled miniature trace (CSV, ~50 VMs over two days).

    Useful for tests and quickstarts::

        vms = traces.load_trace_file(traces.fixture_trace_path())
    """
    return os.path.join(os.path.dirname(__file__), "data",
                        "azure_mini.csv")


def _read_table(path: str) -> dict[str, list]:
    """Read a CSV (optionally .gz) or parquet file into {column: values}.

    Column names are lowercased/stripped and mapped through the alias
    table; unknown columns are kept under their lowercase name.
    """
    lower = path.lower()
    if lower.endswith((".parquet", ".pq")):
        try:
            import pyarrow.parquet as pq
        except Exception as e:                       # pragma: no cover
            raise TraceSchemaError(
                f"{path}: reading parquet traces requires pyarrow, which "
                f"is not installed ({e}); convert the trace to CSV or "
                f"install pyarrow") from e
        table = pq.read_table(path)
        raw = {name: col.to_pylist()
               for name, col in zip(table.column_names, table.columns)}
    elif lower.endswith((".csv", ".csv.gz")):
        opener = gzip.open if lower.endswith(".gz") else open
        with opener(path, "rt", newline="") as f:
            reader = csv.DictReader(f)
            if reader.fieldnames is None:
                raise TraceSchemaError(f"{path}: empty file (no header)")
            raw = {name: [] for name in reader.fieldnames}
            for row in reader:
                for name in raw:
                    raw[name].append(row[name])
    else:
        raise TraceSchemaError(
            f"{path}: unsupported trace format (expected .csv, .csv.gz, "
            f".parquet or .pq)")
    out: dict[str, list] = {}
    for name, vals in raw.items():
        key = name.strip().lower()
        out[_COLUMN_ALIASES.get(key, key)] = vals
    return out


def _numeric(cols: dict, name: str, path: str,
             row_offset: int = 0) -> np.ndarray:
    vals = cols[name]
    out = np.empty(len(vals))
    for i, v in enumerate(vals):
        try:
            out[i] = float(v)
        except (TypeError, ValueError):
            raise TraceSchemaError(
                f"{path}: row {row_offset + i + 1}: column {name!r}: "
                f"{v!r} is not numeric") from None
    if not np.isfinite(out).all():
        i = int(np.flatnonzero(~np.isfinite(out))[0])
        raise TraceSchemaError(
            f"{path}: row {row_offset + i + 1}: column {name!r}: "
            f"non-finite value")
    return out


def _require_schema(cols: dict, path: str) -> None:
    """Raise on missing required columns (shared by both readers)."""
    missing = [c for c in ("arrival", "cores", "mem_gb") if c not in cols]
    if "lifetime" not in cols and "departure" not in cols:
        missing.append("lifetime (or departure)")
    if missing:
        raise TraceSchemaError(
            f"{path}: missing required column(s) {missing}; found "
            f"{sorted(cols)} (accepted aliases: "
            f"{sorted(set(_COLUMN_ALIASES))})")


def _schema_arrays(cols: dict, path: str, row_offset: int = 0):
    """Validated (arrival, lifetime, cores, mem_gb) float arrays for a
    raw column dict, with the offending GLOBAL row in every error."""
    arrival = _numeric(cols, "arrival", path, row_offset)
    if "lifetime" in cols:
        lifetime = _numeric(cols, "lifetime", path, row_offset)
    else:
        lifetime = _numeric(cols, "departure", path, row_offset) - arrival
    cores = _numeric(cols, "cores", path, row_offset)
    mem = _numeric(cols, "mem_gb", path, row_offset)
    for name, arr, ok, req in (
            ("arrival", arrival, arrival >= 0.0, ">= 0"),
            ("lifetime", lifetime, lifetime > 0.0, "> 0"),
            ("cores", cores, cores >= 1.0, ">= 1"),
            ("mem_gb", mem, mem > 0.0, "> 0")):
        if not ok.all():
            i = int(np.flatnonzero(~ok)[0])
            raise TraceSchemaError(
                f"{path}: row {row_offset + i + 1}: column {name!r}: "
                f"{arr[i]:g} must be {req}")
    return arrival, lifetime, cores, mem


#: injectable sleep for the IO-retry backoff (tests monkeypatch this so
#: retry schedules are asserted without real waiting)
_sleep = time.sleep


@dataclasses.dataclass
class IngestReport:
    """Fault ledger of one chunked ingestion pass.

    Pass ``report=IngestReport(max_bad_rows=...)`` to
    :func:`iter_trace_chunks`: malformed rows (non-numeric/non-finite
    cells or domain violations in the four schema columns) are
    QUARANTINED — dropped with a record here — instead of aborting the
    stream, until the budget is exceeded, at which point ingestion
    raises :class:`TraceSchemaError` citing the budget.  Transient IO
    errors retried by the resilient reader increment ``io_retries``.
    ``examples/torch_azure_e2e.py`` prints :meth:`summary` in its run
    report.
    """

    max_bad_rows: int = 0
    bad_rows: list = dataclasses.field(default_factory=list)
    io_retries: int = 0

    @property
    def n_quarantined(self) -> int:
        return len(self.bad_rows)

    def add(self, path: str, row: int, column: str, value,
            reason: str) -> None:
        self.bad_rows.append({"row": row, "column": column,
                              "value": str(value)[:80],
                              "reason": reason})
        if self.n_quarantined > self.max_bad_rows:
            raise TraceSchemaError(
                f"{path}: too many malformed rows "
                f"({self.n_quarantined} > max_bad_rows="
                f"{self.max_bad_rows}); last: row {row} column "
                f"{column!r}: {value!r} {reason}")

    def summary(self) -> dict:
        """JSON-able digest (first 20 quarantine records)."""
        return {"n_quarantined": self.n_quarantined,
                "io_retries": self.io_retries,
                "bad_rows": self.bad_rows[:20]}


def _lenient_numeric(vals) -> tuple[np.ndarray, np.ndarray]:
    """Float array + bad mask (non-numeric/non-finite), never raising."""
    out = np.empty(len(vals))
    bad = np.zeros(len(vals), bool)
    for i, v in enumerate(vals):
        try:
            out[i] = float(v)
        except (TypeError, ValueError):
            out[i], bad[i] = np.nan, True
    bad |= ~np.isfinite(out)
    return out, bad


def _schema_arrays_quarantine(cols: dict, path: str, row_offset: int,
                              report: IngestReport):
    """Per-row masked pendant of :func:`_schema_arrays`: instead of
    aborting on the first malformed row, every offending row is
    recorded in ``report`` (which enforces its ``max_bad_rows`` budget)
    and masked out.  Returns the validated arrays pre-filtered to the
    kept rows plus the keep mask (for filtering the non-schema
    columns).  Each quarantined row records its FIRST offending column
    in schema order.
    """
    arrival, bad_arr = _lenient_numeric(cols["arrival"])
    if "lifetime" in cols:
        lifetime, bad_life = _lenient_numeric(cols["lifetime"])
        life_src = "lifetime"
    else:
        dep, bad_life = _lenient_numeric(cols["departure"])
        lifetime = dep - arrival
        bad_life |= bad_arr
        life_src = "departure"
    cores, bad_cores = _lenient_numeric(cols["cores"])
    mem, bad_mem = _lenient_numeric(cols["mem_gb"])
    rules = (("arrival", "arrival", bad_arr, arrival < 0, ">= 0"),
             ("lifetime", life_src, bad_life, ~(lifetime > 0), "> 0"),
             ("cores", "cores", bad_cores, ~(cores >= 1), ">= 1"),
             ("mem_gb", "mem_gb", bad_mem, ~(mem > 0), "> 0"))
    keep = np.ones(len(arrival), bool)
    for name, src, bad_num, bad_dom, req in rules:
        bad = (bad_num | bad_dom) & keep
        keep &= ~bad
        for i in np.flatnonzero(bad):
            i = int(i)
            report.add(path, row_offset + i + 1, name,
                       cols[src][i],
                       "is not a finite number" if bad_num[i]
                       else f"must be {req}")
    idx = np.flatnonzero(keep)
    return arrival[idx], lifetime[idx], cores[idx], mem[idx], keep


def _resilient_raw_chunks(path: str, chunk_vms: int, io_retries: int,
                          io_backoff_s: float,
                          report: IngestReport | None):
    """Retry wrapper over :func:`_iter_raw_chunks` for transient IO.

    On an ``OSError`` mid-stream the file is reopened, already-delivered
    chunks are skipped (chunk boundaries are deterministic in
    ``chunk_vms``), and reading resumes — with exponential backoff
    (``io_backoff_s * 2**attempt`` via the injectable :data:`_sleep`).
    ``io_retries`` bounds CONSECUTIVE failed attempts; any successfully
    delivered chunk resets the budget.  Schema errors are never
    retried — they are deterministic, not transient.
    """
    delivered = 0
    attempt = 0
    while True:
        try:
            to_skip = delivered      # frozen: delivered grows mid-loop
            skipped = 0
            for cols in _iter_raw_chunks(path, chunk_vms):
                if skipped < to_skip:
                    skipped += 1
                    continue
                yield cols
                delivered += 1
                attempt = 0
            return
        except TraceSchemaError:
            raise
        except OSError:
            attempt += 1
            if attempt > io_retries:
                raise
            if report is not None:
                report.io_retries += 1
            _sleep(io_backoff_s * 2 ** (attempt - 1))


def load_trace_file(path: str, max_vms: int | None = None,
                    start_id: int = 0, seed: int = 0,
                    population: "Population | None" = None) -> list[VM]:
    """Load an external VM trace file into ``sample_vms``-format records.

    Accepts CSV (optionally gzipped) or parquet with columns ``(arrival,
    lifetime, cores, mem_gb)`` — common spellings are aliased, e.g. the
    Azure public traces' ``vmcreated``/``vmdeleted`` (``lifetime`` is
    then ``departure - arrival``), ``vmcorecount`` and ``vmmemory``.
    Optional ``customer``, ``vm_id`` and ``untouched`` columns are used
    when present.  Workload fields a trace cannot carry (untouched
    memory without an ``untouched`` column, slowdowns, PMU counters) are
    synthesized deterministically (``seed``) from a
    :class:`Population` prior so the Pond control plane and predictors
    run on real traces unchanged; replay-engine results depend only on
    the four schema columns.

    Raises :class:`TraceSchemaError` (a ``ValueError``) on missing
    columns, non-numeric/non-finite cells, non-positive lifetimes,
    cores < 1, or mem_gb <= 0 — with the offending row in the message.

    Usage::

        vms = traces.load_trace_file("azure_2019.csv.gz", max_vms=50_000)
        eng = replay_engine.CompiledReplay(vms, decisions, cfg)
    """
    cols = _read_table(path)
    _require_schema(cols, path)
    n = len(cols["arrival"])
    if n == 0:
        raise TraceSchemaError(f"{path}: trace has no rows")

    arrival, lifetime, cores, mem = _schema_arrays(cols, path)

    pop = population or Population(n_customers=64, seed=seed)
    rng = np.random.default_rng(seed)
    if "customer" in cols:
        cust_raw = cols["customer"]
        cust_map: dict = {}
        custs = np.array([cust_map.setdefault(c, len(cust_map))
                          for c in cust_raw]) % pop.n_customers
    else:
        custs = rng.choice(pop.n_customers, n, p=pop.cust_popularity)
    untouched_col = (_numeric(cols, "untouched", path)
                     if "untouched" in cols else None)
    if "vm_id" in cols:
        try:
            vm_ids = [start_id + int(float(v)) for v in cols["vm_id"]]
        except (TypeError, ValueError):
            # opaque string ids (e.g. Azure vmid hashes): stable remap
            id_map: dict = {}
            vm_ids = [start_id + id_map.setdefault(v, len(id_map))
                      for v in cols["vm_id"]]
        seen: set = set()
        for i, v in enumerate(vm_ids):
            if v in seen:
                raise TraceSchemaError(
                    f"{path}: row {i + 1}: duplicate vm_id "
                    f"{cols['vm_id'][i]!r} — the replay keys placement "
                    f"by vm_id, so each VM needs one record")
            seen.add(v)
    else:
        vm_ids = [start_id + i for i in range(n)]

    # synthesized workload fields, vectorized over the whole trace
    u_all = np.clip(pop.cust_u[custs] + rng.normal(0, 0.02, n),
                    0, 0.999999)
    if untouched_col is not None:
        untouched_all = np.clip(untouched_col, 0.0, 1.0)
    else:
        untouched_all = np.clip(
            pop.cust_untouched[custs] + rng.normal(0, 0.10, n), 0, 1)
    slow182_all = _piecewise(u_all, _BANDS_182)
    slow222_all = _piecewise(u_all, _BANDS_222)

    order = np.argsort(arrival, kind="stable")
    if max_vms is not None:
        order = order[:max_vms]
    vms = []
    for i in order.tolist():
        c = int(custs[i])
        vms.append(VM(
            vm_id=vm_ids[i], customer=c,
            vm_type=int(pop.cust_type[c]),
            location=int(pop.cust_loc[c]),
            guest_os=int(pop.cust_os[c]),
            cores=int(round(cores[i])), mem_gb=float(mem[i]),
            arrival=float(arrival[i]), lifetime=float(lifetime[i]),
            untouched=float(untouched_all[i]),
            slow182=float(slow182_all[i]),
            slow222=float(slow222_all[i]),
            pmu=pop._pmu(float(u_all[i]), rng)))
    return vms


def _iter_raw_chunks(path: str, chunk_vms: int):
    """Yield raw alias-mapped column dicts of <= ``chunk_vms`` rows.

    Bounded-memory pendant of :func:`_read_table`: CSV (optionally .gz)
    rows stream through ``csv.DictReader``; parquet files read via
    ``pyarrow.ParquetFile.iter_batches`` so only one row-group batch is
    materialized at a time.
    """
    lower = path.lower()
    if lower.endswith((".parquet", ".pq")):
        try:
            import pyarrow.parquet as pq
        except Exception as e:                       # pragma: no cover
            raise TraceSchemaError(
                f"{path}: reading parquet traces requires pyarrow, which "
                f"is not installed ({e}); convert the trace to CSV or "
                f"install pyarrow") from e
        pf = pq.ParquetFile(path)
        for batch in pf.iter_batches(batch_size=chunk_vms):
            raw = {name: col.to_pylist()
                   for name, col in zip(batch.schema.names,
                                        batch.columns)}
            yield {_COLUMN_ALIASES.get(k.strip().lower(),
                                       k.strip().lower()): v
                   for k, v in raw.items()}
        return
    if not lower.endswith((".csv", ".csv.gz")):
        raise TraceSchemaError(
            f"{path}: unsupported trace format (expected .csv, .csv.gz, "
            f".parquet or .pq)")
    opener = gzip.open if lower.endswith(".gz") else open
    with opener(path, "rt", newline="") as f:
        reader = csv.DictReader(f)
        if reader.fieldnames is None:
            raise TraceSchemaError(f"{path}: empty file (no header)")
        # when two headers alias to one canonical column (e.g. the Azure
        # vmtable's vmcorecount + vmcorecountbucket) the LAST header
        # wins, exactly like _read_table's dict overwrite
        canon_src: dict[str, str] = {}
        for n in reader.fieldnames:
            canon_src[_COLUMN_ALIASES.get(n.strip().lower(),
                                          n.strip().lower())] = n
        names = [(orig, canon) for canon, orig in canon_src.items()]
        chunk = {canon: [] for _, canon in names}
        count = 0
        for row in reader:
            for name, canon in names:
                chunk[canon].append(row[name])
            count += 1
            if count == chunk_vms:
                yield chunk
                chunk = {canon: [] for _, canon in names}
                count = 0
        if count:
            yield chunk


def iter_trace_chunks(path: str, chunk_vms: int = 65536,
                      max_vms: int | None = None, start_id: int = 0,
                      seed: int = 0,
                      population: "Population | None" = None,
                      max_bad_rows: int = 0, io_retries: int = 0,
                      io_backoff_s: float = 0.5,
                      report: "IngestReport | None" = None):
    """Stream a trace file as bounded-memory chunks of ``VM`` records.

    Out-of-core pendant of :func:`load_trace_file` for traces that do
    not fit one in-memory table (e.g. the full Azure public packing
    trace, see ``scripts/fetch_azure_trace.py``): the file is read
    ``chunk_vms`` rows at a time through the same column-alias and
    schema-validation machinery, so errors still name the offending
    GLOBAL row.  Each yielded chunk is a ``load_trace_file``-format VM
    list sorted by arrival; customer and string-vm-id remaps are shared
    across chunks, so concatenating every chunk of an arrival-sorted
    file reproduces ``load_trace_file``'s ``(vm_id, arrival, lifetime,
    cores, mem_gb)`` columns exactly.  Synthesized workload fields
    (untouched/slowdowns/PMU without the optional columns) are
    deterministic in ``(seed, chunk_vms)`` but drawn from a different
    RNG stream than the monolithic loader — replay reject rates depend
    only on the four schema columns, so schema-only policies (local /
    static) price identically either way.

    Chunked ingestion requires arrivals to be non-decreasing ACROSS
    chunk boundaries (rows within a chunk may be unsorted); a violation
    raises :class:`TraceSchemaError` naming the row — sort the file or
    fall back to :func:`load_trace_file`.

    **Fault hardening** (all off by default — defaults are strict and
    bit-identical to the old behavior):

    * ``max_bad_rows > 0`` — malformed rows (non-numeric/non-finite
      cells, domain violations in the four schema columns) are
      QUARANTINED: dropped with a record in the :class:`IngestReport`
      instead of aborting a multi-hour ingest, until the budget is
      exceeded (then :class:`TraceSchemaError` cites the budget).
      Cross-chunk ordering violations and duplicate ``vm_id`` remain
      strict errors — they poison the replay, not just one row.  Under
      quarantine, row numbers in later per-chunk errors count kept
      rows.
    * ``io_retries > 0`` — transient ``OSError`` mid-stream (network
      filesystems, flaky disks) reopens the file and resumes after the
      already-delivered chunks, with exponential backoff
      (``io_backoff_s * 2**attempt``); the budget bounds consecutive
      failures and resets on every delivered chunk.
    * ``report=IngestReport(...)`` — pass your own ledger to read
      ``n_quarantined`` / ``io_retries`` / ``bad_rows`` afterwards
      (its ``max_bad_rows`` field then carries the budget); with
      ``max_bad_rows``/``io_retries`` args alone one is created
      internally.  ``examples/torch_azure_e2e.py`` prints the summary
      in its run report.

    When a recorder is live (``POND_TRACE=1`` or
    :func:`repro_torch.core.obs.use_recorder`) each produced chunk is
    timed as an ``ingest.chunk`` span (the consumer's time between chunks
    is not in it) with ``ingest.rows`` / ``ingest.vms`` / ``ingest.chunks``
    counters, and the ledger's quarantine / IO-retry totals are folded into
    ``ingest.quarantined`` / ``ingest.io_retries`` when the stream closes.

    Usage (bounded-memory replay of an arbitrarily long trace)::

        report = traces.IngestReport(max_bad_rows=100)
        stream = replay_engine.CompiledReplayStream(
            traces.iter_trace_chunks("azure_packing.csv.gz",
                                     chunk_vms=100_000, io_retries=3,
                                     report=report),
            None, cfg, max_events_per_shard=250_000)
        rates = stream.reject_rates([300.0], [512.0])
        print(report.summary())
    """
    if report is None and (max_bad_rows > 0 or io_retries > 0):
        report = IngestReport(max_bad_rows=max_bad_rows)
    inner = _iter_trace_chunks_impl(path, chunk_vms, max_vms, start_id,
                                    seed, population, io_retries,
                                    io_backoff_s, report)
    rec = obs.get_recorder()
    if not rec.enabled:
        yield from inner
        return
    try:
        while True:
            with rec.span("ingest.chunk"):
                try:
                    vms = next(inner)
                except StopIteration:
                    break
            rec.count("ingest.chunks")
            rec.count("ingest.vms", len(vms))
            yield vms
    finally:
        if report is not None:
            rec.count("ingest.quarantined", report.n_quarantined)
            rec.count("ingest.io_retries", report.io_retries)


def _iter_trace_chunks_impl(path, chunk_vms, max_vms, start_id, seed,
                            population, io_retries, io_backoff_s,
                            report):
    """Chunk pipeline behind :func:`iter_trace_chunks` (``report``
    already resolved; the public wrapper adds the ingest spans and
    counters so the consumer's time is never charged to ingestion)."""
    rec = obs.get_recorder()
    pop = population or Population(n_customers=64, seed=seed)
    rng = np.random.default_rng(seed)
    cust_map: dict = {}
    id_map: dict = {}
    id_numeric: bool | None = None       # decided on first vm_id chunk
    seen_ids: set = set()
    prev_max = -np.inf
    row_offset = 0
    emitted = 0
    any_rows = False
    chunks = (_resilient_raw_chunks(path, chunk_vms, io_retries,
                                    io_backoff_s, report)
              if io_retries > 0 else _iter_raw_chunks(path, chunk_vms))
    for cols in chunks:
        _require_schema(cols, path)
        n_raw = n = len(cols["arrival"])
        if n == 0:
            continue
        any_rows = True
        if rec.enabled:
            rec.count("ingest.rows", n_raw)
        if report is not None:
            arrival, lifetime, cores, mem, keep = \
                _schema_arrays_quarantine(cols, path, row_offset,
                                          report)
            if not keep.all():
                idx = np.flatnonzero(keep).tolist()
                for key in ("customer", "vm_id", "untouched"):
                    if key in cols:
                        cols[key] = [cols[key][i] for i in idx]
                n = len(arrival)
                if n == 0:
                    row_offset += n_raw
                    continue
        else:
            arrival, lifetime, cores, mem = _schema_arrays(
                cols, path, row_offset)
        bad = arrival < prev_max
        if bad.any():
            i = int(np.flatnonzero(bad)[0])
            raise TraceSchemaError(
                f"{path}: row {row_offset + i + 1}: column 'arrival': "
                f"{arrival[i]:g} is earlier than a previous chunk's "
                f"latest arrival ({prev_max:g}); chunked ingestion needs "
                f"arrivals non-decreasing across chunk boundaries — sort "
                f"the trace by arrival (scripts/fetch_azure_trace.py "
                f"emits sorted files) or use load_trace_file")
        prev_max = max(prev_max, float(arrival.max()))

        if "customer" in cols:
            custs = np.array([cust_map.setdefault(c, len(cust_map))
                              for c in cols["customer"]]) % pop.n_customers
        else:
            custs = rng.choice(pop.n_customers, n, p=pop.cust_popularity)
        untouched_col = (np.clip(_numeric(cols, "untouched", path,
                                          row_offset), 0.0, 1.0)
                         if "untouched" in cols else None)
        if "vm_id" in cols:
            raw_ids = cols["vm_id"]
            if id_numeric is None:
                try:
                    [float(v) for v in raw_ids]
                    id_numeric = True
                except (TypeError, ValueError):
                    id_numeric = False
            if id_numeric:
                try:
                    vm_ids = [start_id + int(float(v)) for v in raw_ids]
                except (TypeError, ValueError) as e:
                    raise TraceSchemaError(
                        f"{path}: non-numeric vm_id after a numeric "
                        f"first chunk ({e}); chunked ingestion cannot "
                        f"remap ids retroactively — use load_trace_file") \
                        from None
            else:
                vm_ids = [start_id + id_map.setdefault(v, len(id_map))
                          for v in raw_ids]
            for i, v in enumerate(vm_ids):
                if v in seen_ids:
                    raise TraceSchemaError(
                        f"{path}: row {row_offset + i + 1}: duplicate "
                        f"vm_id {raw_ids[i]!r} — the replay keys "
                        f"placement by vm_id, so each VM needs one "
                        f"record")
                seen_ids.add(v)
        else:
            vm_ids = [start_id + row_offset + i for i in range(n)]

        u_all = np.clip(pop.cust_u[custs] + rng.normal(0, 0.02, n),
                        0, 0.999999)
        if untouched_col is not None:
            untouched_all = untouched_col
        else:
            untouched_all = np.clip(
                pop.cust_untouched[custs] + rng.normal(0, 0.10, n), 0, 1)
        slow182_all = _piecewise(u_all, _BANDS_182)
        slow222_all = _piecewise(u_all, _BANDS_222)

        order = np.argsort(arrival, kind="stable")
        if max_vms is not None:
            order = order[:max_vms - emitted]
        vms = []
        for i in order.tolist():
            c = int(custs[i])
            vms.append(VM(
                vm_id=vm_ids[i], customer=c,
                vm_type=int(pop.cust_type[c]),
                location=int(pop.cust_loc[c]),
                guest_os=int(pop.cust_os[c]),
                cores=int(round(cores[i])), mem_gb=float(mem[i]),
                arrival=float(arrival[i]), lifetime=float(lifetime[i]),
                untouched=float(untouched_all[i]),
                slow182=float(slow182_all[i]),
                slow222=float(slow222_all[i]),
                pmu=pop._pmu(float(u_all[i]), rng)))
        row_offset += n_raw
        emitted += len(vms)
        if vms:
            yield vms
        if max_vms is not None and emitted >= max_vms:
            return
    if not any_rows:
        raise TraceSchemaError(f"{path}: trace has no rows")


def save_trace_csv(vms, path: str) -> None:
    """Write VMs as a CSV (gzipped when ``path`` ends in .gz) the
    :func:`load_trace_file` schema round-trips (arrival, lifetime,
    cores, mem_gb + customer/vm_id/untouched)."""
    opener = gzip.open if path.lower().endswith(".gz") else open
    with opener(path, "wt", newline="") as f:
        w = csv.writer(f)
        w.writerow(["vm_id", "customer", "arrival", "lifetime", "cores",
                    "mem_gb", "untouched"])
        for vm in vms:
            w.writerow([vm.vm_id, vm.customer, f"{vm.arrival:.3f}",
                        f"{vm.lifetime:.3f}", vm.cores,
                        f"{vm.mem_gb:g}", f"{vm.untouched:.4f}"])
