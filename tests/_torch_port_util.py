"""Shared set-up of the port's parity tests: the reference's smoke model
with fp32 weights, and the same weights loaded into the port; the
reference's 8-server provisioning world, and its VMs and decisions
carried into the port."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs.registry import get_smoke as jax_get_smoke
from repro.core import cluster_sim as jax_cluster_sim
from repro.core import traces as jax_traces
from repro.core.control_plane import ControlPlane, ControlPlaneConfig
from repro.core.pool_manager import PoolManager
from repro.core.predictors.models import (LatencySensitivityModel,
                                          UntouchedMemoryModel)
from repro.models.model_zoo import build_model as jax_build_model
from repro_torch.configs.registry import get_smoke
from repro_torch.core import cluster_sim as port_cluster_sim
from repro_torch.core import policy_engine as port_policy_engine
from repro_torch.core import traces as port_traces
from repro_torch.models.convert import params_from_numpy


def reference_model(seed: int = 0, arch: str = "qwen2-1.5b"):
    """(cfg, model, fp32 params) of the reference's smoke config of
    ``arch``, as its own serving tests make them."""
    cfg = jax_get_smoke(arch)
    model = jax_build_model(cfg)
    # jitted: the same draws as the eager call, made several times faster
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          jax.jit(model.init_params)(jax.random.key(seed)))
    return cfg, model, params


def numpy_tree(params):
    return jax.tree.map(np.asarray, params)


def port_model(params, arch: str = "qwen2-1.5b"):
    """The port's LM on the CPU, holding the reference's weights."""
    return params_from_numpy(numpy_tree(params), get_smoke(arch),
                             device="cpu")


# ------------------------------------------------ the provisioning world ---
WORLD_HORIZON = 4 * 86400
#: the 8-server world of tests/test_replay_engine.py, in both packages
WORLD_KW = dict(n_servers=8, pool_sockets=8, gb_per_core=4.75)
WORLD_CFG = jax_cluster_sim.ClusterConfig(**WORLD_KW)
PORT_WORLD_CFG = port_cluster_sim.ClusterConfig(**WORLD_KW)
#: its candidate frontier: hi-capacity, mid, tight-local, zero pool (the
#: all-local fallback for every pooled VM), tight pool, infeasible
SERVER = np.array([768.0, 200.0, 140.0, 250.0, 180.0, 60.0, 219.7, 0.0])
POOL = np.array([6144.0, 300.0, 150.0, 0.0, 40.0, 6144.0, 83.3, 100.0])


@functools.cache
def _pond_models():
    pop = jax_traces.Population(seed=0)
    train = pop.sample_vms(500, WORLD_HORIZON, seed=11)
    li = LatencySensitivityModel(pdm=0.05).fit(
        jax_traces.pmu_matrix(train), jax_traces.slowdowns(train, 182))
    hist = jax_traces.build_history(train)
    um = UntouchedMemoryModel(0.05).fit(
        jax_traces.metadata_features(train, hist),
        np.array([v.untouched for v in train]))
    return li, um, hist


@functools.cache
def reference_world(seed: int, policy: str):
    """(vms, PolicyDecisions) of the reference, built as
    ``tests/test_replay_engine.py::_world`` builds them (static share
    0.25; pond through a fresh control plane)."""
    n = jax_cluster_sim.arrivals_for_util(WORLD_CFG, 0.8, WORLD_HORIZON)
    vms = jax_traces.Population(seed=0).sample_vms(
        n, WORLD_HORIZON, seed=seed, start_id=10 ** 6)
    cp = None
    if policy == "pond":
        li, um, hist = _pond_models()
        cp = ControlPlane(
            ControlPlaneConfig(li_threshold=0.05, um_quantile=0.05),
            li, um, PoolManager(pool_gb=4096, buffer_gb=64),
            history=dict(hist))
    dec, _ = jax_cluster_sim.policy_decisions(
        vms, policy, cp, static_pool_frac=0.25, as_arrays=True)
    return vms, dec


def port_vms(vms):
    """The reference's VMs carried into the port as numpy columns."""
    return port_traces.vms_from_table(
        dataclasses.asdict(jax_traces.vm_table(vms)))


def port_decisions(dec):
    """The reference's PolicyDecisions carried into the port."""
    return port_policy_engine.PolicyDecisions(
        np.array(dec.local_gb), np.array(dec.pool_gb),
        np.array(dec.fully_pooled), np.array(dec.t_migrate),
        dec.mispredictions, dec.n_mitigations)


@functools.cache
def port_world(seed: int, policy: str):
    """(reference vms, reference decisions, port vms, port decisions)."""
    vms, dec = reference_world(seed, policy)
    return vms, dec, port_vms(vms), port_decisions(dec)


def port_topology(t):
    """A reference ``core/topology.py`` Topology carried into the port's
    (the same kind, extents and incidence), so both packages price the
    same layout."""
    from repro_torch.core import topology as port_topology_mod
    return port_topology_mod.Topology(t.kind, int(t.n_servers),
                                      int(t.n_pods), int(t.fanout),
                                      np.array(t.inc, np.int32))
