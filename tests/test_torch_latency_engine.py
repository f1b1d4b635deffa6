"""The port's latency engine against the reference's (ROADMAP M11).

Every numpy-backend case of ``tests/test_latency_engine.py``, with the
port's two backends — ``torch`` (float64 tensors, here on the CPU) and
``numpy`` — held bitwise (``==``) against the reference's
``backend="numpy"`` grids and its scalar oracles (``latency_model``,
``qos``, ``eqn1``, ``znuma``), across seeds and the same grid shapes; the
port's own scalar copies against the reference's; tier pricing
(``cluster_sim.tiered_pricing``, ``savings_analysis(tier_hierarchy=)``)
against the reference's numpy-backend pricing of the same decisions.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import cluster_sim as jax_cs
from repro.core import eqn1 as jax_eqn1
from repro.core import latency_engine as jax_le
from repro.core import latency_model as jax_lm
from repro.core import policy_engine as jax_pe
from repro.core import qos as jax_qos
from repro.core import traces as jax_traces
from repro_torch.core import cluster_sim, eqn1
from repro_torch.core import latency_engine as le
from repro_torch.core import latency_model as lm
from repro_torch.core import policy_engine, qos
from repro_torch.core.znuma import ZNumaAllocator
from repro_torch.kernels.spill_sweep import cases
from tests._torch_port_util import port_vms

BACKENDS = ("numpy", "torch")
SEEDS = (0, 1, 2)


def _kw(backend):
    """The port's backend arguments: the torch backend on the CPU."""
    return dict(backend=backend, device="cpu")


def _spill_tuple(g, idx=()):
    return tuple(int(np.asarray(a)[idx]) for a in
                 (g.allocs, g.pool_allocs, g.failed, g.local_in_use,
                  g.pool_in_use))


# ------------------------------------------------------- Fig 7/8 grids --
def test_latency_ns_grids_match_scalar():
    sockets = np.arange(1, 81)
    got = [f(sockets) for f in (le.pond_latency_ns_grid,
                                le.switch_only_latency_ns_grid,
                                le.added_latency_ns_grid,
                                le.latency_increase_pct_grid)]
    want = [f(sockets) for f in (jax_le.pond_latency_ns_grid,
                                 jax_le.switch_only_latency_ns_grid,
                                 jax_le.added_latency_ns_grid,
                                 jax_le.latency_increase_pct_grid)]
    assert [g.tolist() for g in got] == [w.tolist() for w in want]
    for i, s in enumerate(sockets.tolist()):
        for grid, port_f, ref_f in zip(
                got, (lm.pond_latency_ns, lm.switch_only_latency_ns,
                      lm.added_latency_ns, lm.latency_increase_pct),
                (jax_lm.pond_latency_ns, jax_lm.switch_only_latency_ns,
                 jax_lm.added_latency_ns, jax_lm.latency_increase_pct)):
            assert grid[i] == port_f(s) == ref_f(s)


# ------------------------------------------------------ slowdown bands --
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(40,), (1,), (1, 40), (3, 2, 25)])
def test_slowdown_band_grid_parity(backend, seed, shape):
    slow = np.random.default_rng(seed).lognormal(-3, 1.2, size=shape)
    bands = le.slowdown_band_grid(slow, **_kw(backend))
    want = jax_le.slowdown_band_grid(slow, backend="numpy")
    flat = slow.reshape(-1, shape[-1])
    ref = np.array([[(s < .01).mean(), (s < .05).mean(),
                     (s > .25).mean()] for s in flat])
    assert bands.shape == shape[:-1] + (3,) and bands.dtype == np.float64
    assert bands.tolist() == want.tolist()
    assert bands.reshape(-1, 3).tolist() == ref.tolist()


# -------------------------------------------------- hierarchy slowdowns --
def _random_hierarchies(rng, depth: int, c: int):
    """(port's, reference's) hierarchies of the same seeded tiers."""
    port, ref = [], []
    for _ in range(c):
        lats = np.sort(rng.uniform(0.2, 6.0, size=depth + 1))
        hit = float(rng.uniform(0, 0.9))
        port.append(lm.TierHierarchy(tuple(
            lm.MemoryTier(f"t{i}", float(l)) for i, l in enumerate(lats)),
            cache_hit_rate=hit))
        ref.append(jax_lm.TierHierarchy(tuple(
            jax_lm.MemoryTier(f"t{i}", float(l))
            for i, l in enumerate(lats)), cache_hit_rate=hit))
    return port, ref


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("depth,c", [(1, 1), (1, 4), (2, 3)])
def test_hierarchy_slowdown_grid_parity(backend, seed, depth, c):
    rng = np.random.default_rng(seed)
    hs, ref_hs = _random_hierarchies(rng, depth, c)
    fracs = rng.uniform(0, 0.5, size=(7, depth))
    ratios, hits = le.hierarchy_params(hs)
    r_ratios, r_hits = jax_le.hierarchy_params(ref_hs)
    assert ratios.tolist() == r_ratios.tolist()
    assert hits.tolist() == r_hits.tolist()
    grid = le.hierarchy_slowdown_grid(fracs, ratios, hits, **_kw(backend))
    want = jax_le.hierarchy_slowdown_grid(fracs, r_ratios, r_hits,
                                          backend="numpy")
    assert grid.shape == (7, c)
    assert grid.tolist() == want.tolist()
    for i in range(7):
        for j, (h, rh) in enumerate(zip(hs, ref_hs)):
            assert grid[i, j] == h.slowdown_factor(fracs[i]) \
                == rh.slowdown_factor(fracs[i])


@pytest.mark.parametrize("backend", BACKENDS)
def test_hierarchy_grid_matches_tier_model(backend):
    """2-tier, no cache: bit-identical to TierModel, the reference's too."""
    tm = lm.TierModel()
    h = lm.TierHierarchy.from_tier_model(tm)
    assert h == lm.TierHierarchy.from_tier_model()
    fracs = np.linspace(0, 1, 11)[:, None]
    ratios, hits = le.hierarchy_params([h])
    grid = le.hierarchy_slowdown_grid(fracs, ratios, hits,
                                      **_kw(backend))[:, 0]
    ref_tm = jax_lm.TierModel()
    for i, f in enumerate(fracs[:, 0].tolist()):
        assert grid[i] == tm.slowdown_factor(f) == h.slowdown_factor(f) \
            == ref_tm.slowdown_factor(f)


def test_hierarchy_params_rejects_mixed_depths():
    with pytest.raises(ValueError, match="mixed hierarchy depths"):
        le.hierarchy_params([lm.TierHierarchy.from_tier_model(),
                             lm.TierHierarchy.three_tier()])


@pytest.mark.parametrize("kw", [{}, dict(cache_hit_rate=0.25),
                                dict(far_latency_us=7.5, far_gbps=3.0,
                                     cxl_capacity_gb=10.0,
                                     far_capacity_gb=5.0)])
def test_tier_models_equal_the_reference(kw):
    """The port's scalar tier models: every method, bitwise the
    reference's."""
    h, rh = lm.TierHierarchy.three_tier(**kw), \
        jax_lm.TierHierarchy.three_tier(**kw)
    assert [dataclasses.astuple(t) for t in h.tiers] == \
        [dataclasses.astuple(t) for t in rh.tiers]
    assert h.n_pool_tiers == rh.n_pool_tiers == 2
    for i in range(3):
        assert h.effective_ratio(i) == rh.effective_ratio(i)
        assert h.transfer_s(3.5e6, i) == rh.transfer_s(3.5e6, i)
    for d in (0.0, 12.5, 40.0):
        assert h.spill_fractions(d) == rh.spill_fractions(d)
    assert h.slowdown_factor([0.2, 0.1]) == rh.slowdown_factor([0.2, 0.1])
    tm, rtm = lm.TierModel(), jax_lm.TierModel()
    for tier in ("local", "pool"):
        assert tm.transfer_s(1e6, tier) == rtm.transfer_s(1e6, tier)
    assert lm.migration_seconds(3.0) == jax_lm.migration_seconds(3.0)


# ------------------------------------------------------- PDM violations --
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("seed", SEEDS)
def test_pdm_violation_grid_parity(backend, seed):
    rng = np.random.default_rng(seed)
    s = rng.lognormal(-3, 1.0, size=(4, 30))
    pdms = np.array([0.01, 0.05, 0.25])
    grid = le.pdm_violation_grid(s, pdms, **_kw(backend))
    assert grid.tolist() == jax_le.pdm_violation_grid(
        s, pdms, backend="numpy").tolist()
    for i in range(4):
        for j, pdm in enumerate(pdms):
            assert grid[i, j] == jax_qos.exceeds_pdm(s[i], pdm).mean()


@pytest.mark.parametrize("backend", BACKENDS)
def test_pdm_boundary_is_inclusive(backend):
    s = np.array([0.04, 0.05, 0.06])
    grid = le.pdm_violation_grid(s, [0.05], **_kw(backend))
    assert grid[0] == 2.0 / 3.0
    assert bool(qos.exceeds_pdm(0.05, 0.05))
    assert not qos.exceeds_pdm(0.049999, 0.05)


# --------------------------------------------------------- spill grids --
def _events(seed, n_keys, n_events):
    return le.compile_block_events(cases.random_events(
        np.random.default_rng(seed), n_keys, n_events))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("c", [1, 2, 3, 5, 17])
def test_spill_grid_parity(backend, seed, c):
    """Configs include exhaustion (0 local / 0 pool) so failures exercise
    both tiers; the port's grid == the reference's numpy grid and
    scalar oracle per lane."""
    kinds, keys = _events(seed, 24, 120)
    base = [(0, 4), (4, 0), (3, 5), (0, 0), (8, 64)]
    nl = np.array([base[i % len(base)][0] + i for i in range(c)])
    np_ = np.array([base[i % len(base)][1] for i in range(c)])
    grid = le.spill_grid(kinds, keys, nl, np_, **_kw(backend))
    want = jax_le.spill_grid(kinds, keys, nl, np_, backend="numpy")
    assert grid.allocs.shape == (c,) and grid.allocs.dtype == np.int64
    for i in range(c):
        ref = jax_le.scalar_spill_replay(kinds, keys, nl[i], np_[i])
        own = le.scalar_spill_replay(kinds, keys, nl[i], np_[i])
        assert _spill_tuple(grid, (i,)) == _spill_tuple(want, (i,)) \
            == _spill_tuple(ref) == _spill_tuple(own)
    assert grid.spill_fraction.tolist() == want.spill_fraction.tolist()


@pytest.mark.parametrize("backend", BACKENDS)
def test_spill_grid_batched_with_padding(backend):
    """(K, E) ragged streams padded with PAD events stay per-stream
    bit-exact (PAD is a no-op on every lane)."""
    streams = [_events(s, 16, 60 + 10 * s) for s in range(3)]
    kinds, keys = cases.pad_streams(streams)
    nl, np_ = np.array([2, 6, 0]), np.array([4, 2, 8])
    grid = le.spill_grid(kinds, keys, nl, np_, **_kw(backend))
    assert grid.allocs.shape == (3, 3)
    for s, (k, b) in enumerate(streams):
        for i in range(3):
            ref = jax_le.scalar_spill_replay(k, b, nl[i], np_[i])
            assert _spill_tuple(grid, (s, i)) == _spill_tuple(ref)


@pytest.mark.parametrize("backend", BACKENDS)
def test_spill_fraction_guards_zero_allocs(backend):
    g = le.spill_grid(np.array([], np.int32), np.array([], np.int32),
                      [4], [4], **_kw(backend))
    assert g.spill_fraction[0] == 0.0
    assert _spill_tuple(g, (0,)) == (0, 0, 0, 0, 0)


def test_znuma_failed_allocs_not_counted():
    a = ZNumaAllocator(num_local=1, num_pool=1)
    a.alloc()
    a.alloc()
    with pytest.raises(MemoryError):
        a.alloc()
    assert a.allocs == 2
    assert a.pool_allocs == 1
    assert a.spill_fraction == 0.5


# ----------------------------------------------------- LI/UM/combine --
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 137])
def test_li_curve_grid_parity(backend, seed, n):
    rng = np.random.default_rng(seed)
    p = np.round(rng.random(n), 2)       # exercises threshold ties
    sens = rng.random(n) < 0.3
    ths, li, fp = le.li_curve_grid(p, sens, **_kw(backend))
    want = jax_le.li_curve_grid(p, sens, backend="numpy")
    assert [a.tolist() for a in (ths, li, fp)] == \
        [a.tolist() for a in want]
    for i, t in enumerate(ths):
        li_ref = p < t
        assert li[i] == li_ref.mean()
        assert fp[i] == (li_ref & sens).mean()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("t", [1, 5])
def test_um_curve_grid_parity(seed, t):
    rng = np.random.default_rng(seed)
    preds = rng.random((t, 61))
    actual = rng.random(61)
    um, op = le.um_curve_grid(preds, actual)
    r_um, r_op = jax_le.um_curve_grid(preds, actual)
    assert um.tolist() == r_um.tolist() and op.tolist() == r_op.tolist()
    for i in range(t):
        assert um[i] == preds[i].mean()
        assert op[i] == (actual < preds[i]).mean()


def _point(pt):
    return dataclasses.astuple(pt)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("seed", SEEDS)
def test_combine_grid_parity(backend, seed):
    rng = np.random.default_rng(seed)
    li_curve = [(float(u), float(f)) for u, f in
                zip(np.sort(rng.random(21)), np.sort(rng.random(21) / 8))]
    um_curve = [(float(u), float(f)) for u, f in
                zip(np.sort(rng.random(9)), np.sort(rng.random(9) / 10))]
    budgets = [0.0, 0.01, 0.02, 0.1, 1.0]
    pts = le.combine_grid(li_curve, um_curve, budgets, **_kw(backend))
    want = jax_le.combine_grid(li_curve, um_curve, budgets,
                               backend="numpy")
    for b, pt, w in zip(budgets, pts, want):
        assert _point(pt) == _point(w) \
            == _point(jax_eqn1.combine(li_curve, um_curve, float(b))) \
            == _point(eqn1.combine(li_curve, um_curve, float(b)))
    assert [(b, _point(p)) for b, p in
            eqn1.frontier(li_curve, um_curve, budgets)] == \
        [(b, _point(p)) for b, p in
         jax_eqn1.frontier(li_curve, um_curve, budgets)]


@pytest.mark.parametrize("backend", BACKENDS)
def test_combine_grid_tie_break(backend):
    """Equal-value candidates: the nested loop keeps the FIRST strict max
    (li-major order) — the flattened argmax must agree."""
    li_curve = [(0.5, 0.0), (0.5, 0.0)]
    um_curve = [(0.2, 0.0), (0.2, 0.0)]
    pt = le.combine_grid(li_curve, um_curve, [0.05], **_kw(backend))[0]
    assert _point(pt) == _point(jax_eqn1.combine(li_curve, um_curve, 0.05))


@pytest.mark.parametrize("backend", BACKENDS)
def test_combine_grid_empty_budget(backend):
    li_curve = [(0.4, 0.5)]              # fp way over budget
    um_curve = [(0.3, 0.5)]
    pt = le.combine_grid(li_curve, um_curve, [0.001], **_kw(backend))[0]
    assert _point(pt) == _point(jax_eqn1.combine(li_curve, um_curve, 0.001))
    assert pt.pool_dram_frac == 0


# ---------------------------------------------------- QoS mitigations --
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("seed", SEEDS)
def test_qos_mitigation_grid_parity(backend, seed):
    rng = np.random.default_rng(seed)
    n = 60
    p = np.round(rng.random(n), 2)
    spilled = rng.random(n) < 0.6
    pool_gb = np.where(rng.random(n) < 0.8, rng.uniform(1, 8, n), 0.0)
    migrated = rng.random(n) < 0.1
    ths = np.array([0.0, 0.35, 0.5, 1.0])
    mit, n_mit = le.qos_mitigation_grid(p, spilled, pool_gb, ths,
                                        migrated=migrated, **_kw(backend))
    r_mit, r_n = jax_le.qos_mitigation_grid(p, spilled, pool_gb, ths,
                                            migrated=migrated,
                                            backend="numpy")
    assert mit.tolist() == r_mit.tolist() and n_mit.tolist() == r_n.tolist()
    for c, t in enumerate(ths):
        mgr = qos.MitigationManager()
        mgr.migrated = {i for i in range(n) if migrated[i]}
        mon = qos.QoSMonitor(0.05, lambda pmu: np.array([p[int(pmu[0, 0])]]),
                             float(t), mgr)
        for i in range(n):
            got = mon.check(i, np.array([float(i)]), bool(spilled[i]),
                            float(pool_gb[i]), now=0.0)
            assert mit[c, i] == (got is not None)
        assert int(n_mit[c]) == len(mgr.log) == int(mit[c].sum())


def test_interp_tradeoff_unsorted_curve():
    xp, fp = [0.3, 0.1, 0.2], [3.0, 1.0, 2.0]
    assert le.interp_tradeoff(0.15, xp, fp) == 1.5 \
        == jax_le.interp_tradeoff(0.15, xp, fp)
    xs = np.linspace(0, 1, 9)
    assert np.array_equal(le.interp_tradeoff(xs, [0.0, 1.0], [0.0, 2.0]),
                          np.interp(xs, [0.0, 1.0], [0.0, 2.0]))


def test_backend_is_checked_and_the_card_is_the_default():
    with pytest.raises(ValueError, match="backend"):
        le.pdm_violation_grid([0.1], [0.05], backend="jax")
    # no device given and no card here: the torch backend raises
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            le.pdm_violation_grid([0.1], [0.05])


# ----------------------------------------------- 3-tier model + pricing --
def test_tier_hierarchy_waterfall_spill():
    h = lm.TierHierarchy.three_tier(cxl_capacity_gb=10.0,
                                    far_capacity_gb=5.0)
    h = lm.TierHierarchy((lm.MemoryTier("local", 0.1, capacity_gb=20.0),)
                         + h.tiers[1:], cache_hit_rate=0.0)
    fills, rem = h.spill_fractions(35.0)
    assert [float(f) for f in fills] == [20.0, 10.0, 5.0]
    assert rem == 0.0
    fills, rem = h.spill_fractions(40.0)
    assert rem == 5.0


def test_tier_hierarchy_requires_two_tiers():
    with pytest.raises(ValueError):
        lm.TierHierarchy((lm.MemoryTier("only", 0.1),))


def _decisions(seed):
    """(port's, reference's) PolicyDecisions of 40 seeded VMs, some all
    local, some with no memory."""
    rng = np.random.default_rng(seed)
    local = rng.integers(0, 16, 40).astype(float)
    pool = np.where(rng.random(40) < 0.7, rng.integers(0, 12, 40), 0.0)
    pool[:2] = 0.0
    local[0] = 0.0
    args = (local, pool, np.zeros(40, bool), np.full(40, np.nan))
    return policy_engine.PolicyDecisions(*args), \
        jax_pe.PolicyDecisions(*(a.copy() for a in args))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("seed", SEEDS)
def test_tiered_pricing_equals_the_references_numpy_pricing(backend, seed):
    dec, ref_dec = _decisions(seed)
    for kw in (dict(cache_hit_rate=0.25), dict(far_latency_us=8.0)):
        got = cluster_sim.tiered_pricing(
            dec, lm.TierHierarchy.three_tier(**kw), far_fracs=(0.0, 0.3, 1.0),
            pdm=0.05, **_kw(backend))
        want = jax_cs.tiered_pricing(
            ref_dec, jax_lm.TierHierarchy.three_tier(**kw),
            far_fracs=(0.0, 0.3, 1.0), pdm=0.05, backend="numpy")
        assert [dataclasses.astuple(r) for r in got] == \
            [dataclasses.astuple(r) for r in want]


@pytest.mark.parametrize("backend", BACKENDS)
def test_tiered_pricing_matches_hierarchy_model(backend):
    dec = policy_engine.PolicyDecisions(
        local_gb=np.array([6.0, 4.0, 8.0, 0.0]),
        pool_gb=np.array([2.0, 4.0, 0.0, 0.0]),
        fully_pooled=np.zeros(4, bool), t_migrate=np.full(4, np.nan))
    h = lm.TierHierarchy.three_tier(cache_hit_rate=0.25)
    rows = cluster_sim.tiered_pricing(dec, h, far_fracs=(0.0, 0.5),
                                      pdm=0.05, **_kw(backend))
    assert [r.far_frac for r in rows] == [0.0, 0.5]
    traffic = np.array([0.25, 0.5, 0.0, 0.0])
    for row, f in zip(rows, (0.0, 0.5)):
        slows = np.array([h.slowdown_factor([t * (1 - f), t * f])
                          for t in traffic])
        assert row.mean_slowdown == slows.mean()
        assert row.max_slowdown == slows.max()
        assert row.violation_frac == \
            qos.exceeds_pdm(slows - 1.0, 0.05).mean()
    assert rows[0].mean_slowdown <= rows[1].mean_slowdown


def test_tiered_pricing_rejects_two_tier_hierarchy():
    dec = policy_engine.PolicyDecisions(
        local_gb=np.array([1.0]), pool_gb=np.array([1.0]),
        fully_pooled=np.zeros(1, bool), t_migrate=np.full(1, np.nan))
    with pytest.raises(ValueError, match="local/CXL/far"):
        cluster_sim.tiered_pricing(dec, lm.TierHierarchy.from_tier_model(),
                                   device="cpu")


def test_savings_analysis_attaches_tier_pricing():
    """The reference test's 4-server world: the port's PolicyResult ==
    the reference's, and its ``tier_pricing`` == the reference's
    ``tiered_pricing(backend="numpy")`` of the same decisions (the
    reference's own ``savings_analysis(tier_hierarchy=)`` needs its jax
    float64 branch, ROADMAP F1)."""
    vms = jax_traces.Population(seed=0).sample_vms(120, 86400, seed=5,
                                                   start_id=10 ** 6)
    kw = dict(n_servers=4, pool_sockets=8, gb_per_core=4.75)
    far = (0.0, 0.5)
    res = cluster_sim.savings_analysis(
        port_vms(vms), cluster_sim.ClusterConfig(**kw), "static",
        static_pool_frac=0.15,
        tier_hierarchy=lm.TierHierarchy.three_tier(cache_hit_rate=0.3),
        far_fracs=far, device="cpu")
    ref = jax_cs.savings_analysis(vms, jax_cs.ClusterConfig(**kw), "static",
                                  static_pool_frac=0.15)
    ref_dec, _ = jax_cs.policy_decisions(vms, "static",
                                         static_pool_frac=0.15,
                                         as_arrays=True)
    want = jax_cs.tiered_pricing(
        ref_dec, jax_lm.TierHierarchy.three_tier(cache_hit_rate=0.3), far,
        0.05, backend="numpy")
    assert [dataclasses.astuple(p) for p in res.tier_pricing] == \
        [dataclasses.astuple(p) for p in want]
    assert [p.far_frac for p in res.tier_pricing] == [0.0, 0.5]
    assert res.tier_pricing[0].mean_slowdown <= \
        res.tier_pricing[1].mean_slowdown
    fields = [f.name for f in dataclasses.fields(jax_cs.PolicyResult)
              if f.name != "tier_pricing"]
    assert [getattr(res, f) for f in fields] == \
        [getattr(ref, f) for f in fields]
    # without a hierarchy nothing is attached; the local policy is priced
    # too (its pool split is empty)
    res2 = cluster_sim.savings_analysis(
        port_vms(vms), cluster_sim.ClusterConfig(**kw), "static",
        static_pool_frac=0.15, device="cpu")
    assert res2.tier_pricing is None
    loc = cluster_sim.savings_analysis(
        port_vms(vms), cluster_sim.ClusterConfig(**kw), "local",
        tier_hierarchy=lm.TierHierarchy.three_tier(), far_fracs=far,
        device="cpu")
    assert [p.mean_slowdown for p in loc.tier_pricing] == [1.0, 1.0]
