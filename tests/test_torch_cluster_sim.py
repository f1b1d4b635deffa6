"""The port's cluster simulator against the reference's: Fig 2's
``place_by_cores``, ``stranding_analysis`` and ``stranding_by_bucket``
(``==``, the reference's arithmetic in its order), the scalar policy walk
``policy_decisions(engine="scalar")`` (``==`` the reference's walk and the
port's compiled pipeline, the control planes' post-run state included) and
the scalar-oracle search ``savings_analysis(use_engine=False)`` (``==`` the
reference's, and within search tolerance of the engine path)."""
import dataclasses

import numpy as np
import pytest

from repro.core import cluster_sim as jax_cs
from repro.core import traces as jax_traces
from repro_torch.core import cluster_sim as cs
from tests._torch_port_util import (PORT_WORLD_CFG, WORLD_CFG, port_vms,
                                    port_world)
from tests.test_torch_policy import (_assert_decisions_equal,
                                     _assert_planes_equal, _planes, _world)

HORIZON = 6 * 86400
#: tests/test_cluster_sim.py's world: 16 servers, one 16-socket pool
KW16 = dict(n_servers=16, pool_sockets=16, gb_per_core=4.75)


def _stranding_world(n_servers, util, seed):
    cfg = jax_cs.ClusterConfig(**dict(KW16, n_servers=n_servers))
    n = jax_cs.arrivals_for_util(cfg, util, HORIZON)
    vms = jax_traces.Population(seed=0).sample_vms(n, HORIZON, seed=seed,
                                                   start_id=10 ** 6)
    return (cfg, vms, cs.ClusterConfig(**dict(KW16, n_servers=n_servers)),
            port_vms(vms))


WORLDS = [(16, 0.8, 2), (8, 1.3, 3), (5, 0.85, 4)]


@pytest.mark.parametrize("n_servers,util,seed", WORLDS)
def test_place_by_cores_equals_reference(n_servers, util, seed):
    cfg, vms, pcfg, pvms = _stranding_world(n_servers, util, seed)
    got = cs.place_by_cores(pvms, pcfg)
    want = jax_cs.place_by_cores(vms, cfg)
    assert got == want
    if util > 1.0:
        assert got[1]                    # an over-full row rejects VMs


@pytest.mark.parametrize("n_servers,util,seed", WORLDS)
def test_stranding_analysis_and_buckets_equal_reference(n_servers, util,
                                                        seed):
    cfg, vms, pcfg, pvms = _stranding_world(n_servers, util, seed)
    got = cs.stranding_analysis(pvms, pcfg)
    want = jax_cs.stranding_analysis(vms, cfg)
    assert got.dtype == want.dtype and got.shape == want.shape == (200, 2)
    assert got.tolist() == want.tolist()
    rows = cs.stranding_by_bucket(got)
    assert rows == jax_cs.stranding_by_bucket(want)
    edges = np.array([0.0, 0.3, 0.7, 0.9, 1.01])
    assert cs.stranding_by_bucket(got, edges) == \
        jax_cs.stranding_by_bucket(want, edges)
    few = cs.stranding_analysis(pvms, pcfg, n_snapshots=7)
    assert few.tolist() == jax_cs.stranding_analysis(
        vms, cfg, n_snapshots=7).tolist()
    if (n_servers, seed) == (16, 2):     # tests/test_cluster_sim.py's claim
        assert rows[-1][1] > rows[0][1] and rows[-1][1] > 0.05


def _scalar_pair(policy, vms, frac=0.25, **kw):
    """The reference's and the port's scalar walks on the same VMs, with
    fresh planes for ``pond``; (ref planes, port planes, ref out, port
    out)."""
    ref_cp, port_cp = _planes() if policy == "pond" else (None, None)
    want = jax_cs.policy_decisions(vms, policy, ref_cp, static_pool_frac=frac,
                                   engine="scalar", **kw)
    got = cs.policy_decisions(port_vms(vms), policy, port_cp,
                              static_pool_frac=frac, engine="scalar", **kw)
    return ref_cp, port_cp, want, got


@pytest.mark.parametrize("policy", ["local", "static", "pond"])
def test_scalar_policy_walk_equals_reference_and_compiled(policy):
    pop, *_ = _world()
    vms = pop.sample_vms(300, 5 * 86400, seed=7, start_id=10 ** 6)
    ref_cp, port_cp, (want, w_mis), (got, g_mis) = _scalar_pair(policy, vms)
    assert [dataclasses.astuple(d) for d in got] == \
        [dataclasses.astuple(d) for d in want]
    assert g_mis == w_mis
    if policy == "pond":
        _assert_planes_equal(port_cp, ref_cp)
        assert any(d.t_migrate is not None for d in got)
    # the port's compiled pipeline, on fresh planes, == its scalar walk
    _, comp_cp = _planes() if policy == "pond" else (None, None)
    comp, c_mis = cs.policy_decisions(port_vms(vms), policy, comp_cp,
                                      static_pool_frac=0.25)
    assert [dataclasses.astuple(d) for d in comp] == \
        [dataclasses.astuple(d) for d in got]
    assert c_mis == g_mis
    if policy == "pond":
        _assert_planes_equal(comp_cp, port_cp)
    # as_arrays: the struct-of-arrays form of the same walk
    _, _, (w_arr, _), (g_arr, _) = _scalar_pair(policy, vms,
                                                as_arrays=True)
    _assert_decisions_equal(g_arr, w_arr)
    assert g_arr.n_mitigations == g_arr.n_migrations


def test_scalar_policy_walk_on_fractional_sizes_and_errors():
    """The fixture with a quarter GB added to every VM: the static floor
    and the local split stay the reference's; an unknown policy raises the
    reference's ValueError."""
    vms = jax_traces.load_trace_file(jax_traces.fixture_trace_path())
    for v in vms:
        v.mem_gb += 0.25
    for policy in ("local", "static"):
        _, _, (want, _), (got, _) = _scalar_pair(policy, vms, frac=0.3)
        assert [dataclasses.astuple(d) for d in got] == \
            [dataclasses.astuple(d) for d in want]
        assert any(d.local_gb != int(d.local_gb) for d in got)
    with pytest.raises(ValueError, match="bogus"):
        cs.policy_decisions(port_vms(vms), "bogus", engine="scalar")


def _fields(r):
    return dataclasses.astuple(r)


@pytest.mark.parametrize("policy", ["local", "static"])
def test_savings_analysis_scalar_search_equals_reference(policy):
    """``use_engine=False`` == the reference's scalar search, and the
    engine path (on the CPU) agrees with it as the reference's own test
    holds its engine to its scalar search
    (tests/test_replay_engine.py::test_savings_analysis_matches_scalar_search)."""
    vms, _, pvms, _ = port_world(3, "static")
    r_sc = cs.savings_analysis(pvms, PORT_WORLD_CFG, policy,
                               static_pool_frac=0.25, use_engine=False,
                               device="cpu")
    want = jax_cs.savings_analysis(vms, WORLD_CFG, policy,
                                   static_pool_frac=0.25, use_engine=False)
    assert _fields(r_sc) == _fields(want)
    r_eng = cs.savings_analysis(pvms, PORT_WORLD_CFG, policy,
                                static_pool_frac=0.25, device="cpu")
    assert r_eng.baseline_server_gb == r_sc.baseline_server_gb
    assert r_eng.server_gb == r_sc.server_gb
    assert abs(r_eng.pool_group_gb - r_sc.pool_group_gb) <= \
        0.15 * max(r_sc.pool_group_gb, 1.0) + 32.0
    assert abs(r_eng.savings - r_sc.savings) <= 0.02
    if policy == "local":
        assert r_eng.reject_rate == r_sc.reject_rate
    else:
        decisions, _ = cs.policy_decisions(pvms, policy,
                                           static_pool_frac=0.25)
        rr = cs.replay_reject_rate(pvms, decisions, PORT_WORLD_CFG,
                                   r_eng.server_gb, r_eng.pool_group_gb)
        assert rr == r_eng.reject_rate


def test_savings_analysis_scalar_search_pond_and_tier_pricing():
    """``pond`` through the scalar search: the result and the planes'
    post-run state == the reference's; a tier hierarchy prices the walk's
    decision list as the reference's does."""
    from repro.core.latency_model import TierHierarchy as JaxTiers
    from repro_torch.core.latency_model import TierHierarchy
    pop, *_ = _world()
    vms = pop.sample_vms(200, 2 * 86400, seed=9, start_id=10 ** 6)
    cfg = cs.ClusterConfig(n_servers=4, pool_sockets=8, gb_per_core=4.75)
    jcfg = jax_cs.ClusterConfig(n_servers=4, pool_sockets=8,
                                gb_per_core=4.75)
    ref_cp, port_cp = _planes()
    got = cs.savings_analysis(port_vms(vms), cfg, "pond",
                              control_plane=port_cp, use_engine=False,
                              tier_hierarchy=TierHierarchy.three_tier(),
                              device="cpu")
    want = jax_cs.savings_analysis(vms, jcfg, "pond", control_plane=ref_cp,
                                   use_engine=False)
    want.tier_pricing = jax_cs.tiered_pricing(
        jax_cs.policy_engine.decisions_from_list(
            jax_cs.policy_decisions(vms, "pond", _planes()[0],
                                    engine="scalar")[0]),
        JaxTiers.three_tier(), backend="numpy")
    assert _fields(dataclasses.replace(got, tier_pricing=None)) == \
        _fields(dataclasses.replace(want, tier_pricing=None))
    assert [dataclasses.astuple(p) for p in got.tier_pricing] == \
        [dataclasses.astuple(p) for p in want.tier_pricing]
    _assert_planes_equal(port_cp, ref_cp)
    assert got.mitigations == len(port_cp.mitigation.log)


def test_fig2_example_equals_the_reference_benchmark():
    """examples/torch_fig2_stranding.py at the benchmark's quick size: its
    rows and claims == benchmarks/fig2_stranding.py's."""
    import importlib.util
    import os
    from benchmarks import fig2_stranding
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "torch_fig2_stranding.py")
    spec = importlib.util.spec_from_file_location("torch_fig2", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    got = example.run(device="cpu")
    want = fig2_stranding.run(quick=True)
    assert got["rows"] == want["rows"]
    assert got["claims"] == [c["ok"] for c in want["claims"]]
    assert all(got["claims"])
