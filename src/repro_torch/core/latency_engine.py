"""Batched latency / QoS / zNUMA grid engine (Pond §4-§6 figure family).

Slowdown sensitivity (Fig 4), the CXL latency model (Fig 7/8), zNUMA
spill (Fig 15/16), the UM calibration curve (Fig 18) and the Eq.(1)
combined frontier (Fig 20), each evaluated over a (workload x config)
grid in one batched pass, **bit-exact** against the scalar functions kept
as oracles (``latency_model``, ``znuma``, ``qos``, ``eqn1``):

* :func:`pond_latency_ns_grid` (+ switch-only / added / pct variants)
  == ``latency_model.pond_latency_ns`` looped: the same float-add order
  per element.
* :func:`slowdown_band_grid`, :func:`pdm_violation_grid`,
  :func:`li_curve_grid` count in integers and divide once on the host in
  float64 (numpy's bool mean is exactly count/size in float64).
* :func:`spill_grid` == replaying each ``(num_local, num_pool)`` config on
  ``znuma.ZNumaAllocator`` (:func:`scalar_spill_replay`), one launch of
  the spill sweep (kernel K6, ``kernels/spill_sweep``) for every stream
  and config lane; config lanes are true extents, no bucket padding.
* :func:`hierarchy_slowdown_grid` == ``TierHierarchy.slowdown_factor``
  looped (terms fold in tier order).
* :func:`combine_grid` == ``eqn1.combine``: the candidates flatten
  li-major so the first-occurrence argmax reproduces the nested loop's
  first strict maximum.
* :func:`qos_mitigation_grid` == walking ``qos.QoSMonitor.check``.

Every grid with a device side takes ``backend="auto"|"torch"|"numpy"`` and
``device``: ``"torch"`` (and ``"auto"``) runs float64 (integer for the
spill sweep) tensors on ``device`` — the CUDA card by default, raising
without one; ``device="cpu"`` runs them on the CPU —, ``"numpy"`` runs
the host numpy branch.  Both are bitwise equal: each float op is one
separately rounded IEEE op in either.  Results come back as numpy arrays.
:func:`um_curve_grid`, :func:`interp_tradeoff` and the ``eqn1`` walk are
host numpy, as in the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import eqn1, qos
from repro_torch.core.latency_model import (CXL_PORT_NS, EMC_CTRL_NS,
                                            NUMA_LOCAL_NS, RETIMER_NS,
                                            SWITCH_NS)
from repro_torch.core.znuma import ZNumaAllocator
from repro_torch.device import resolve_device
# spill-event kinds (pad events are no-ops on every lane), defined by K6
from repro_torch.kernels.spill_sweep.ref import ALLOC, FREE, PAD


BACKENDS = ("auto", "torch", "numpy")


def _torch_device(backend: str, device) -> torch.device | None:
    """The device of the torch backend, or None for the numpy one."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
    return None if backend == "numpy" else resolve_device(device)


def _f64(a, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float64), device=dev)


# ------------------------------------------------- Fig 7/8 latency model --
def pond_latency_ns_grid(pool_sockets) -> np.ndarray:
    """Vectorized ``pond_latency_ns`` — identical add order per element."""
    s = np.asarray(pool_sockets)
    lat = np.full(s.shape, NUMA_LOCAL_NS + 2 * CXL_PORT_NS + EMC_CTRL_NS)
    lat = np.where(s > 8, lat + 2 * RETIMER_NS, lat)
    lat = np.where(s > 16, lat + (SWITCH_NS + 2 * RETIMER_NS), lat)
    lat = np.where(s > 32, lat + 2 * RETIMER_NS, lat)
    return lat


def switch_only_latency_ns_grid(pool_sockets) -> np.ndarray:
    s = np.asarray(pool_sockets)
    lat = np.full(s.shape, NUMA_LOCAL_NS + 2 * CXL_PORT_NS + EMC_CTRL_NS
                  + SWITCH_NS)
    for edge in (8, 16, 32):
        lat = np.where(s > edge, lat + 2 * RETIMER_NS, lat)
    return lat


def added_latency_ns_grid(pool_sockets) -> np.ndarray:
    return pond_latency_ns_grid(pool_sockets) - NUMA_LOCAL_NS


def latency_increase_pct_grid(pool_sockets) -> np.ndarray:
    return 100.0 * pond_latency_ns_grid(pool_sockets) / NUMA_LOCAL_NS


# -------------------------------------------------- Fig 4 slowdown bands --
def slowdown_band_grid(slow, lt=(0.01, 0.05), gt=(0.25,),
                       backend: str = "auto", device=None) -> np.ndarray:
    """Band fractions over a slowdown grid.

    ``slow``: (..., N) per-workload slowdowns (any number of leading batch
    axes).  Returns (..., len(lt)+len(gt)) float64 fractions —
    ``out[..., i] = (slow < lt[i]).mean(-1)`` then ``(slow > gt[j])
    .mean(-1)``, bit-exact vs the scalar means because the counts are
    integers and the division is a single float64 op.
    """
    slow = np.asarray(slow, np.float64)
    n = slow.shape[-1]
    lt_a = np.asarray(lt, np.float64)
    gt_a = np.asarray(gt, np.float64)
    dev = _torch_device(backend, device)
    if dev is not None:
        s = _f64(slow, dev)[..., None, :]
        lo = (s < _f64(lt_a, dev)[:, None]).sum(-1)
        hi = (s > _f64(gt_a, dev)[:, None]).sum(-1)
        counts = torch.cat([lo, hi], dim=-1).cpu().numpy()
    else:
        lo = (slow[..., None, :] < lt_a[:, None]).sum(-1)
        hi = (slow[..., None, :] > gt_a[:, None]).sum(-1)
        counts = np.concatenate([lo, hi], axis=-1)
    return counts.astype(np.float64) / n


# --------------------------------------------- tier-hierarchy slowdowns --
def hierarchy_params(hierarchies) -> tuple[np.ndarray, np.ndarray]:
    """Stack (C,) hierarchies (equal depth) into ``(ratios, hits)``
    arrays for :func:`hierarchy_slowdown_grid`."""
    depths = {h.n_pool_tiers for h in hierarchies}
    if len(depths) != 1:
        raise ValueError(f"mixed hierarchy depths {sorted(depths)}")
    ratios = np.array([[h.latency_ratio(i + 1)
                        for i in range(h.n_pool_tiers)]
                       for h in hierarchies], np.float64)
    hits = np.array([h.cache_hit_rate for h in hierarchies], np.float64)
    return ratios, hits


def hierarchy_slowdown_grid(fracs, ratios, hits, backend: str = "auto",
                            device=None) -> np.ndarray:
    """Slowdown factors over a (workload x hierarchy-config) grid.

    ``fracs``: (..., T) per-pool-tier traffic fractions; ``ratios``:
    (C, T) tier latency ratios; ``hits``: (C,) DRAM-cache hit rates.
    Returns (..., C) slowdown factors.  The per-tier terms accumulate in
    tier order starting from 1.0 — the exact fold of the scalar
    ``TierHierarchy.slowdown_factor`` — so every element is bitwise the
    scalar result.
    """
    fracs = np.asarray(fracs, np.float64)
    ratios = np.asarray(ratios, np.float64)
    hits = np.asarray(hits, np.float64)
    dev = _torch_device(backend, device)
    if dev is not None:
        h = _f64(hits, dev)[:, None]
        eff = h + (1.0 - h) * _f64(ratios, dev)
        terms = _f64(fracs, dev)[..., None, :] * (eff - 1.0)
        out = torch.ones(terms.shape[:-1], dtype=torch.float64, device=dev)
        for t in range(terms.shape[-1]):
            out = out + terms[..., t]
        return out.cpu().numpy()
    eff = hits[:, None] + (1.0 - hits[:, None]) * ratios
    terms = fracs[..., None, :] * (eff - 1.0)
    out = np.ones(terms.shape[:-1])
    for t in range(terms.shape[-1]):
        out = out + terms[..., t]
    return out


def pdm_violation_grid(slowdown_frac, pdm_grid, backend: str = "auto",
                       device=None) -> np.ndarray:
    """Fraction of workloads at-or-beyond each PDM (inclusive predicate
    ``qos.exceeds_pdm``).  ``slowdown_frac``: (..., N) relative
    slowdowns; ``pdm_grid``: (P,).  Returns (..., P) float64."""
    s = np.asarray(slowdown_frac, np.float64)
    p = np.asarray(pdm_grid, np.float64)
    n = s.shape[-1]
    dev = _torch_device(backend, device)
    if dev is not None:
        counts = qos.exceeds_pdm(_f64(s, dev)[..., None, :],
                                 _f64(p, dev)[:, None]).sum(-1).cpu().numpy()
    else:
        counts = qos.exceeds_pdm(s[..., None, :], p[:, None]).sum(-1)
    return counts.astype(np.float64) / n


# ------------------------------------------------------ Fig 15/16 spill --
@dataclasses.dataclass
class SpillGrid:
    """Per-config zNUMA accounting (trailing axis = config lane)."""
    allocs: np.ndarray          # successful allocations
    pool_allocs: np.ndarray
    failed: np.ndarray          # MemoryError allocations (both tiers full)
    local_in_use: np.ndarray
    pool_in_use: np.ndarray

    @property
    def spill_fraction(self) -> np.ndarray:
        a = self.allocs.astype(np.float64)
        return np.where(self.allocs > 0,
                        self.pool_allocs.astype(np.float64)
                        / np.where(self.allocs > 0, a, 1.0), 0.0)


def compile_block_events(events) -> tuple[np.ndarray, np.ndarray]:
    """Compile ``[("alloc"|"free", block_key), ...]`` into int32 event
    arrays (kinds, keys).  Block keys are dense logical ids."""
    kind_of = {"alloc": ALLOC, "free": FREE}
    kinds = np.fromiter((kind_of[k] for k, _ in events), np.int32,
                        len(events))
    keys = np.fromiter((b for _, b in events), np.int32, len(events))
    return kinds, keys


def scalar_spill_replay(ev_kind, ev_key, num_local: int,
                        num_pool: int) -> SpillGrid:
    """Oracle: replay one config on ``znuma.ZNumaAllocator``.

    Failed allocations leave the key unbound; freeing an unbound key is
    a no-op (mirrors the engine's tier map)."""
    alloc = ZNumaAllocator(int(num_local), int(num_pool))
    held: dict[int, int] = {}
    failed = 0
    for kind, key in zip(ev_kind, ev_key):
        if kind == ALLOC:
            try:
                held[int(key)] = alloc.alloc()
            except MemoryError:
                failed += 1
        elif kind == FREE:
            blk = held.pop(int(key), None)
            if blk is not None:
                alloc.free(blk)
    mk = lambda v: np.asarray(v, np.int64)
    return SpillGrid(mk(alloc.allocs), mk(alloc.pool_allocs), mk(failed),
                     mk(alloc.local_in_use), mk(alloc.pool_in_use))


def _numpy_spill_sweep(ev, num_local, num_pool, n_keys: int):
    free_l = num_local.copy()
    free_p = num_pool.copy()
    tier = np.full((n_keys, len(num_local)), -1, np.int32)
    allocs = np.zeros_like(free_l)
    pool_allocs = np.zeros_like(free_l)
    failed = np.zeros_like(free_l)
    for kind, key in ev:
        if kind == ALLOC:
            take_l = free_l > 0
            take_p = ~take_l & (free_p > 0)
            fail = ~take_l & ~take_p
            free_l -= take_l
            free_p -= take_p
            tier[key] = np.where(take_l, 0, np.where(take_p, 1, tier[key]))
            allocs += take_l | take_p
            pool_allocs += take_p
            failed += fail
        elif kind == FREE:
            row = tier[key]
            free_l += row == 0
            free_p += row == 1
            tier[key] = -1
    return allocs, pool_allocs, failed, num_local - free_l, \
        num_pool - free_p


def spill_grid(ev_kind, ev_key, num_local, num_pool, backend: str = "auto",
               device=None) -> SpillGrid:
    """zNUMA spill accounting over a config grid, one sweep.

    ``ev_kind``/``ev_key``: (E,) or (K, E) int event streams (kind
    :data:`PAD` is a no-op — the padding value for ragged batches);
    ``num_local``/``num_pool``: (C,) per-config tier sizes.  Returns a
    :class:`SpillGrid` with (C,) — or (K, C) — int64 counters, bitwise
    equal to :func:`scalar_spill_replay` per (stream, lane).

    The torch backend is one launch of the spill sweep (K6) on ``device``
    for all K streams and C lanes (``"cpu"`` runs its plain version); the
    lanes are true extents, any number of them, and an ALLOC or FREE with
    a negative key raises there.  The numpy backend loops the streams on
    the host.
    """
    ev_kind = np.asarray(ev_kind, np.int32)
    ev_key = np.asarray(ev_key, np.int32)
    num_local = np.atleast_1d(np.asarray(num_local, np.int32))
    num_pool = np.atleast_1d(np.asarray(num_pool, np.int32))
    if num_local.shape != num_pool.shape:
        raise ValueError("num_local / num_pool shape mismatch")
    batched = ev_kind.ndim == 2
    n_keys = int(ev_key.max(initial=0)) + 1
    dev = _torch_device(backend, device)
    if dev is not None:
        from repro_torch.kernels.spill_sweep import ops
        kinds, keys = (ev_kind, ev_key) if batched else (ev_kind[None],
                                                         ev_key[None])
        out = ops.spill_sweep(*(torch.from_numpy(np.ascontiguousarray(a))
                                .to(dev) for a in (kinds, keys, num_local,
                                                   num_pool)), n_keys)
        arrs = [o.cpu().numpy().astype(np.int64) for o in out]
        if not batched:
            arrs = [a[0] for a in arrs]
        return SpillGrid(*arrs)
    ev = np.stack([ev_kind, ev_key], axis=-1)
    if batched:
        rows = [_numpy_spill_sweep(e, num_local, num_pool, n_keys)
                for e in ev]
        arrs = [np.stack([r[i] for r in rows]).astype(np.int64)
                for i in range(5)]
    else:
        out = _numpy_spill_sweep(ev, num_local, num_pool, n_keys)
        arrs = [a.astype(np.int64) for a in out]
    return SpillGrid(*arrs)


# --------------------------------------------------- Fig 17/18 LI + UM --
def default_li_thresholds() -> np.ndarray:
    return np.unique(np.round(np.linspace(0.0, 1.0, 101), 3))


def li_curve_grid(p, sens, thresholds=None, backend: str = "auto",
                  device=None) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(LI, FP) fractions over a threshold grid in one pass.

    ``p``: (N,) sensitivity probabilities; ``sens``: (N,) bool truth
    (``qos.exceeds_pdm(slowdowns, pdm)``).  Returns ``(thresholds,
    li_frac, fp_frac)`` float64 — bit-exact vs
    ``LatencySensitivityModel.curve`` because ``li.mean()`` of a bool
    array is exactly count/size in float64.  Counts are #{p < t} and
    #{p < t, sensitive}, by binary search in the sorted probabilities.
    """
    p = np.asarray(p, np.float64)
    sens = np.asarray(sens, bool)
    ths = np.asarray(default_li_thresholds() if thresholds is None
                     else thresholds, np.float64)
    n = len(p)
    dev = _torch_device(backend, device)
    if dev is not None:
        pt, th = _f64(p, dev), _f64(ths, dev)
        st = torch.as_tensor(sens, device=dev)
        li_c = torch.searchsorted(torch.sort(pt).values, th).cpu().numpy()
        fp_c = torch.searchsorted(torch.sort(pt[st]).values,
                                  th).cpu().numpy()
    else:
        li_c = np.searchsorted(np.sort(p), ths, side="left")
        fp_c = np.searchsorted(np.sort(p[sens]), ths, side="left")
    return ths, li_c.astype(np.float64) / n, fp_c.astype(np.float64) / n


def um_curve_grid(preds, actual) -> tuple[np.ndarray, np.ndarray]:
    """(UM, OP) per prediction row (host numpy).  ``preds``: (T, N)
    per-tau predictions; ``actual``: (N,).  UM uses the same per-row
    float64 ``mean`` reduction as the scalar loop; OP counts
    ``actual < pred`` in integers."""
    preds = np.asarray(preds, np.float64)
    actual = np.asarray(actual, np.float64)
    um = np.array([row.mean() for row in preds])
    op = (actual[None, :] < preds).sum(1).astype(np.float64) \
        / preds.shape[1]
    return um, op


# ------------------------------------------------- Fig 20 combine grid --
def combine_grid(li_curve, um_curve, budgets, spill_harm_prob: float = 0.25,
                 backend: str = "auto", device=None) -> list:
    """Vectorized ``eqn1.combine`` over a budget grid.

    The (L, U) candidate matrices flatten li-major so the first-
    occurrence argmax reproduces the nested loop's strict-``>`` first-max
    tie-break; invalid cells mask to -inf.  Returns one
    ``eqn1.CombinedOperatingPoint`` per budget, each bitwise equal to the
    scalar ``eqn1.combine``.
    """
    li = np.asarray([c[0] for c in li_curve], np.float64)
    fp = np.asarray([c[1] for c in li_curve], np.float64)
    um = np.asarray([c[0] for c in um_curve], np.float64)
    op = np.asarray([c[1] for c in um_curve], np.float64)
    pf = li[:, None] + (1.0 - li[:, None]) * um[None, :]
    mis = fp[:, None] + op[None, :] * spill_harm_prob
    budgets = np.atleast_1d(np.asarray(budgets, np.float64))
    dev = _torch_device(backend, device)
    if dev is not None:
        b = _f64(budgets, dev)[:, None, None]
        ok = (_f64(fp, dev)[None, :, None] <= b) & (_f64(mis, dev)[None]
                                                    <= b)
        cand = torch.where(ok, _f64(pf, dev)[None], -torch.inf)
        best_t, idx_t = cand.reshape(len(budgets), -1).max(dim=1)
        # torch's max over a dim gives the first maximal index, as argmax
        best, idx = best_t.cpu().numpy(), idx_t.cpu().numpy()
    else:
        ok = (fp[None, :, None] <= budgets[:, None, None]) \
            & (mis[None] <= budgets[:, None, None])
        cand = np.where(ok, pf[None], -np.inf)
        flat = cand.reshape(len(budgets), -1)
        idx = np.argmax(flat, axis=1)
        best = flat[np.arange(len(budgets)), idx]
    out = []
    n_um = len(um)
    for b in range(len(budgets)):
        if not best[b] > 0.0:               # no candidate beat the zero pt
            out.append(eqn1.CombinedOperatingPoint(0, 0, 0, 0, 0, 0))
            continue
        i, j = divmod(int(idx[b]), n_um)
        out.append(eqn1.CombinedOperatingPoint(
            float(fp[i]), float(op[j]), float(li[i]), float(um[j]),
            float(pf[i, j]), float(mis[i, j])))
    return out


# ----------------------------------------------------------- QoS grids --
def qos_mitigation_grid(p, spilled, pool_gb, thresholds, migrated=None,
                        backend: str = "auto", device=None
                        ) -> tuple[np.ndarray, np.ndarray]:
    """The QoS monitor's mitigation predicate over a threshold grid.

    ``p``: (N,) predicted sensitivity; ``spilled``: (N,) bool;
    ``pool_gb``: (N,); ``thresholds``: (C,); ``migrated``: optional (N,)
    bool of already-migrated VMs.  Returns ``(mitigate (C, N) bool,
    n_mitigations (C,))`` — row c bitwise equals walking
    ``qos.QoSMonitor.check`` over the N VMs at threshold c.
    """
    p = np.asarray(p, np.float64)
    spilled = np.asarray(spilled, bool)
    pool_gb = np.asarray(pool_gb, np.float64)
    ths = np.atleast_1d(np.asarray(thresholds, np.float64))
    prev = np.zeros(len(p), bool) if migrated is None \
        else np.asarray(migrated, bool)
    dev = _torch_device(backend, device)
    if dev is not None:
        b = lambda a: torch.as_tensor(a, device=dev)
        mit = ((~b(prev) & b(spilled) & (_f64(pool_gb, dev) > 0))[None, :]
               & (_f64(p, dev)[None, :] >= _f64(ths, dev)[:, None]))
        mit = mit.cpu().numpy()
    else:
        mit = (~prev & spilled & (pool_gb > 0))[None, :] \
            & (p[None, :] >= ths[:, None])
    return mit, mit.sum(1).astype(np.int64)


# -------------------------------------------------- tradeoff-curve interp --
def interp_tradeoff(x, xp, fp) -> np.ndarray:
    """``np.interp`` with its monotone-``xp`` precondition enforced.

    ``np.interp``'s result is silently garbage when the curve is not
    sorted by ``xp`` — model curves need not be monotone in the swept
    parameter.  Sorts (stable) by ``xp`` first; for already-sorted inputs
    this is bitwise ``np.interp``.
    """
    xp = np.asarray(xp, np.float64)
    fp = np.asarray(fp, np.float64)
    order = np.argsort(xp, kind="stable")
    return np.interp(x, xp[order], fp[order])
