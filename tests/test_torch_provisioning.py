"""The provisioning loop as a whole, port against reference: traces,
policy decisions, the batched searches and ``savings_analysis`` return
``==`` results on the same inputs.  The port's sweeps run their plain
version here (CPU tensors)."""
import dataclasses

import numpy as np
import pytest

from repro.core import cluster_sim as jax_cs
from repro.core import replay_engine as jax_re
from repro.core import traces as jax_traces
from repro_torch.core import cluster_sim as cs
from repro_torch.core import policy_engine
from repro_torch.core import replay_engine as re
from repro_torch.core import traces
from tests._torch_port_util import (PORT_WORLD_CFG, WORLD_CFG, WORLD_HORIZON,
                                    port_world)


def _fields(result):
    """A PolicyResult's fields, from either package (the reference's extra
    ``tier_pricing`` is None on these paths)."""
    out = {f.name: getattr(result, f.name)
           for f in dataclasses.fields(cs.PolicyResult)}
    return out | {"savings": result.savings, "total_gb": result.total_gb,
                  "baseline_gb": result.baseline_gb}


@pytest.mark.parametrize("seed", [1, 7])
def test_sample_vms_equal_reference_field_by_field(seed):
    want = jax_traces.Population(seed=0).sample_vms(300, WORLD_HORIZON,
                                                    seed=seed, start_id=5)
    got = traces.Population(seed=0).sample_vms(300, WORLD_HORIZON,
                                               seed=seed, start_id=5)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for f in dataclasses.fields(traces.VM):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if f.name == "pmu":
                assert x.dtype == y.dtype and x.tolist() == y.tolist()
            else:
                assert type(x) is type(y) and x == y, f.name
        assert a.departure == b.departure


def test_vms_from_table_inverts_vm_table():
    vms, _, pvms, _ = port_world(3, "static")
    want = dataclasses.asdict(jax_traces.vm_table(vms))
    got = dataclasses.asdict(traces.vm_table(pvms))
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert got[key].tolist() == want[key].tolist(), key
    assert traces.pmu_matrix(pvms).tolist() == \
        jax_traces.pmu_matrix(vms).tolist()
    for lat in (182, 222):
        assert traces.slowdowns(pvms, lat).tolist() == \
            jax_traces.slowdowns(vms, lat).tolist()


@pytest.mark.parametrize("policy", ["local", "static"])
@pytest.mark.parametrize("seed", [3, 4])
def test_policy_decisions_equal_reference(policy, seed):
    vms, _, pvms, _ = port_world(seed, "static")
    want, w_mis = jax_cs.policy_decisions(vms, policy, static_pool_frac=0.25,
                                          as_arrays=True)
    got, g_mis = cs.policy_decisions(pvms, policy, static_pool_frac=0.25,
                                     as_arrays=True)
    assert g_mis == w_mis and got.mispredictions == want.mispredictions
    assert got.n_mitigations == want.n_mitigations == 0
    for f in ("local_gb", "pool_gb", "fully_pooled", "t_migrate"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    as_list, _ = cs.policy_decisions(pvms, policy, static_pool_frac=0.25)
    assert [dataclasses.astuple(d) for d in as_list] == \
        [dataclasses.astuple(d) for d in want.as_vmdecisions()]
    assert got.n_migrations == want.n_migrations
    packed = policy_engine.decisions_from_list(as_list)
    np.testing.assert_array_equal(packed.pool_gb, want.pool_gb)
    with pytest.raises(ValueError, match="control_plane"):
        cs.policy_decisions(pvms, "pond")


def test_arrivals_for_util_and_config_equal_reference():
    for kw in (dict(n_servers=8, pool_sockets=8), dict(n_servers=256),
               dict(n_servers=7, pool_sockets=8, cores_per_server=48)):
        a, b = cs.ClusterConfig(**kw), jax_cs.ClusterConfig(**kw)
        assert (a.n_groups, a.servers_per_group) == (b.n_groups,
                                                     b.servers_per_group)
        for util, days in ((0.8, 4), (0.8, 7), (0.55, 1.5)):
            assert cs.arrivals_for_util(a, util, days * 86400) == \
                jax_cs.arrivals_for_util(b, util, days * 86400)


def _engine_pair(seed, policy):
    vms, dec, pvms, pdec = port_world(seed, policy)
    return (jax_re.CompiledReplay(vms, dec, WORLD_CFG),
            re.CompiledReplay(pvms, pdec, PORT_WORLD_CFG, device="cpu"))


def test_search_min_batched_equals_reference_and_scalar_bisection():
    ref, eng = _engine_pair(5, "static")
    _, _, pvms, pdec = port_world(5, "static")
    big_pool = 768.0 * 8
    tol = float(ref.reject_rates(768.0, big_pool)[0]) + 0.005
    assert float(eng.reject_rates(768.0, big_pool)[0]) + 0.005 == tol
    want = jax_re.search_min_batched(
        lambda g: ref.reject_rates(g, big_pool) <= tol, 0.0, 768.0)
    got = re.search_min_batched(
        lambda g: eng.reject_rates(g, big_pool) <= tol, 0.0, 768.0)
    dec = pdec.as_vmdecisions()
    scalar = cs._search_min(
        lambda g: cs.replay_reject_rate(pvms, dec, PORT_WORLD_CFG, g,
                                        big_pool) <= tol, 0.0, 768.0)
    assert got == want == scalar


@pytest.mark.parametrize("policy", ["static", "pond"])
def test_pool_search_batched_equals_reference(policy):
    ref, eng = _engine_pair(3, policy)
    big_pool = 768.0 * 8
    tol = float(ref.reject_rates(768.0, big_pool)[0]) + 0.005
    cap = int(np.floor(tol * ref.n_vms))
    grid = np.linspace(250.0, 400.0, 7)
    want = jax_re.pool_search_batched(ref, grid, big_pool, tol,
                                      reject_cap=cap)
    got = re.pool_search_batched(eng, grid, big_pool, tol, reject_cap=cap)
    assert got.tolist() == want.tolist()
    assert (got < big_pool).any()
    # a streaming engine takes the search's other branch (no
    # trajectories): the reference's streamed search, probe for probe
    vms, dec, pvms, pdec = port_world(3, policy)
    stream = re.CompiledReplayStream(pvms, pdec, PORT_WORLD_CFG,
                                     device="cpu", max_events_per_shard=1024)
    want = jax_re.pool_search_batched(
        jax_re.CompiledReplayStream(vms, dec, WORLD_CFG,
                                    max_events_per_shard=1024),
        grid, big_pool, tol, reject_cap=cap)
    assert re.pool_search_batched(stream, grid, big_pool, tol,
                                  reject_cap=cap).tolist() == want.tolist()


@pytest.mark.parametrize("policy", ["local", "static", "pond"])
def test_savings_analysis_equals_reference_in_every_field(policy):
    """local and static through the policy walk; pond with the reference's
    decisions carried across (``decisions=``), its MIGRATE events
    included."""
    if policy == "pond":
        vms, dec, pvms, pdec = port_world(3, "pond")
        kw, pkw = dict(decisions=dec), dict(decisions=pdec)
    else:
        vms, _, pvms, _ = port_world(3, "static")
        kw = pkw = dict(static_pool_frac=0.25)
    want = jax_cs.savings_analysis(vms, WORLD_CFG, policy, **kw)
    got = cs.savings_analysis(pvms, PORT_WORLD_CFG, policy, device="cpu",
                              **pkw)
    assert _fields(got) == _fields(want)
    if policy != "local":
        assert got.pool_group_gb > 0 and got.savings > 0


def test_savings_analysis_shares_the_all_local_search_through_its_cache():
    vms, _, pvms, _ = port_world(4, "static")
    cache, pcache = {}, {}
    want = [jax_cs.savings_analysis(vms, WORLD_CFG, p, cache=cache,
                                    static_pool_frac=0.3)
            for p in ("local", "static")]
    re.stats_reset()
    got = [cs.savings_analysis(pvms, PORT_WORLD_CFG, p, cache=pcache,
                               static_pool_frac=0.3, device="cpu")
           for p in ("local", "static")]
    assert [_fields(r) for r in got] == [_fields(r) for r in want]
    assert pcache["local_engine"].device.type == "cpu"
    assert sorted(k for k in pcache if k != "local_engine") == \
        sorted(k for k in cache if k != "local_engine")
    # every sweep was one call of the plain version: none reached a kernel
    times = re.stage_times()
    assert len(times.sweeps) == re.stats_snapshot()["sweeps"] > 0
    assert times.trajectory_s > 0 and times.compile_s > 0


def test_savings_analysis_refuses_what_is_not_ported():
    _, _, pvms, _ = port_world(3, "static")
    # the scalar paths are ported (M3b): an unknown policy is refused by
    # the scalar walk as the reference's refuses it
    with pytest.raises(ValueError, match="bogus"):
        cs.savings_analysis(pvms, PORT_WORLD_CFG, "bogus", device="cpu",
                            use_engine=False)
    # streaming is ported (M5): a shard budget below 256 events is refused
    # as the reference's stream refuses it
    with pytest.raises(ValueError, match=">= 256"):
        cs.savings_analysis(pvms, PORT_WORLD_CFG, "static", device="cpu",
                            max_events_per_shard=100)
    # tier pricing is ported (M11): a hierarchy that is not local/CXL/far
    # is refused, as the reference's tiered_pricing refuses it
    from repro_torch.core.latency_model import TierHierarchy
    with pytest.raises(ValueError, match="local/CXL/far"):
        cs.savings_analysis(pvms, PORT_WORLD_CFG, "local", device="cpu",
                            tier_hierarchy=TierHierarchy.from_tier_model())
    # pond is ported: without its control plane it raises as the
    # reference does
    with pytest.raises(ValueError, match="control_plane"):
        cs.savings_analysis(pvms, PORT_WORLD_CFG, "pond", device="cpu")


def test_example_runs_on_the_cpu(capsys):
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "torch_cluster_savings.py")
    spec = importlib.util.spec_from_file_location("torch_cluster_savings",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    local, static = mod.main(["--device", "cpu", "--servers", "8",
                              "--days", "1", "--static-pool-frac", "0.25"])
    assert local.name == "local" and static.name == "static"
    assert static.server_gb <= local.server_gb
    assert "one sweep priced 9" in capsys.readouterr().out
