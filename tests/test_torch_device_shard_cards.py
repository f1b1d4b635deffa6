"""``devices=`` split over two or more CUDA cards ``==`` one card: the one
test of the port that needs cards (it skips below two).  Run on a machine
with cards: ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_device_shard_cards.py``.  No JAX here: the reference is
the single-card result, which ``tests/test_torch_device_shard.py`` holds
to the reference on the CPU."""
import numpy as np
import pytest
import torch

from repro_torch.core import cluster_sim, replay_engine, topology, traces

SGB = np.linspace(120.0, 400.0, 5)
PGB = np.linspace(0.0, 900.0, 5)


@pytest.mark.cuda
def test_split_over_cards_equals_one_card():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA cards")
    cfg = cluster_sim.ClusterConfig(n_servers=8, cores_per_server=16,
                                    pool_sockets=8, gb_per_core=4.75)

    def world(seed):
        vms = traces.Population(seed=0).sample_vms(
            250, 2 * 86400, seed=seed, start_id=10 ** 6)
        return vms, cluster_sim.policy_decisions(
            vms, "static", static_pool_frac=0.3, as_arrays=True)[0]

    eng = replay_engine.CompiledReplay(*world(40), cfg)
    assert eng.reject_rates(SGB, PGB, devices="all").tolist() == \
        eng.reject_rates(SGB, PGB).tolist()
    sb = replay_engine.CompiledReplayStreamBatch([
        replay_engine.CompiledReplayStream(*world(20 + i), cfg,
                                           max_events_per_shard=256)
        for i in range(3)])
    assert sb.reject_rates(SGB, PGB, devices="all").tolist() == \
        sb.reject_rates(SGB, PGB).tolist()
    topo = topology.partitioned(cfg.n_servers, 4)
    pods = [topology.split_pool(p, 2) for p in np.linspace(0.0, 600.0, 5)]
    assert sb.reject_rates_fleet(SGB, pods, topo, devices="all").tolist() \
        == sb.reject_rates_fleet(SGB, pods, topo).tolist()
