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

Host numpy only.  File ingestion (real VM traces) waits for ROADMAP M3b.
"""
from __future__ import annotations

import dataclasses

import numpy as np

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
