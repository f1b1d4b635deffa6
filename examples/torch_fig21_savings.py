"""Pond's end-to-end DRAM savings (paper Fig 21) on the PyTorch/CUDA port:
all-local, a static 15 % pool and Pond's own policy (the latency and
untouched-memory models, the control plane and its QoS monitor), each
priced over a batch of trace seeds in lockstep — every search round one
launch of the event-sweep kernel (K1) over all seeds' candidates.  Rows
are mean ± std of the savings across seeds, and Pond's mispredictions;
then the QoS price of Pond's pool split (first seed) on a local/CXL/far
hierarchy behind a DRAM cache, as the far tier takes 0, 25 and 50 % of
each VM's pool memory (``cluster_sim.tiered_pricing``).

  PYTHONPATH=src python examples/torch_fig21_savings.py               # on the card
  PYTHONPATH=src python examples/torch_fig21_savings.py --device cpu \\
      --servers 8 --days 1 --seeds 2 --train-vms 300                  # plain version
  PYTHONPATH=src python examples/torch_fig21_savings.py \\
      --servers 256 --days 7                              # a full cluster row
"""
import argparse
import time

import numpy as np

from repro_torch.core import (cluster_sim, policy_engine, replay_engine,
                              traces)
from repro_torch.core.control_plane import ControlPlane, ControlPlaneConfig
from repro_torch.core.latency_model import TierHierarchy
from repro_torch.core.pool_manager import PoolManager
from repro_torch.core.predictors.models import (LatencySensitivityModel,
                                                UntouchedMemoryModel)


def fit_models(pop, n_train: int, days: float = 10.0, seed: int = 1,
               pdm: float = 0.05, tau: float = 0.05):
    """Pond's two models and the customers' history from a training trace
    (the reference benchmarks' ``common.li_model``/``um_model``)."""
    train = pop.sample_vms(n_train, days * 86400, seed=seed)
    li = LatencySensitivityModel(pdm=pdm).fit(
        traces.pmu_matrix(train), traces.slowdowns(train, 182))
    hist = traces.build_history(train)
    um = UntouchedMemoryModel(tau).fit(
        traces.metadata_features(train, hist),
        np.array([v.untouched for v in train]))
    return li, um, hist


def control_plane(li, um, hist):
    """One fresh plane a trace (decisions extend its history): Fig 21's
    settings, PDM 5 %, LI threshold 0.05, UM quantile 0.05."""
    return ControlPlane(ControlPlaneConfig(li_threshold=0.05,
                                           um_quantile=0.05), li, um,
                        PoolManager(pool_gb=4096, buffer_gb=64),
                        history=dict(hist))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' to run on the CPU")
    ap.add_argument("--servers", type=int, default=16)
    ap.add_argument("--pool-sockets", type=int, default=16)
    ap.add_argument("--days", type=float, default=6.0,
                    help="trace length (the cluster runs at ~0.8 of its "
                         "cores)")
    ap.add_argument("--seeds", type=int, default=3,
                    help="trace seeds 2, 3, ... priced as one batch")
    ap.add_argument("--train-vms", type=int, default=2000)
    ap.add_argument("--static-pool-frac", type=float, default=0.15)
    args = ap.parse_args(argv)

    pop = traces.Population(seed=0)
    t0 = time.perf_counter()
    li, um, hist = fit_models(pop, args.train_vms)
    fit_s = time.perf_counter() - t0
    cfg = cluster_sim.ClusterConfig(n_servers=args.servers,
                                    pool_sockets=args.pool_sockets,
                                    gb_per_core=4.75)
    horizon = args.days * 86400
    n = cluster_sim.arrivals_for_util(cfg, 0.8, horizon)
    vms_list = [pop.sample_vms(n, horizon, seed=2 + i, start_id=10 ** 6)
                for i in range(args.seeds)]
    print(f"{args.servers} servers, {args.pool_sockets}-socket pools, "
          f"{args.seeds} seeds x {n} VMs; models fitted in {fit_s:.1f}s")

    replay_engine.stats_reset()
    cache: dict = {}
    rows = {}
    t0 = time.perf_counter()
    for policy in ("local", "static", "pond"):
        planes = ([control_plane(li, um, hist) for _ in vms_list]
                  if policy == "pond" else None)
        res = cluster_sim.savings_analysis_batched(
            vms_list, cfg, policy, control_planes=planes,
            static_pool_frac=args.static_pool_frac, cache=cache,
            device=args.device)
        rows[policy] = cluster_sim.summarize_savings(res)
    wall = time.perf_counter() - t0
    stats = replay_engine.stats_snapshot()
    for policy, s in rows.items():
        print(f"  {policy:6s}: savings {s['savings_mean']:+.3f} "
              f"± {s['savings_std']:.3f}  server={s['server_gb_mean']:6.1f}GB"
              f" pool/group={s['pool_group_gb_mean']:6.1f}GB"
              f" mispred={s['mispred_mean']:.4f}")
    print(f"three policies in {wall:.2f}s ({stats['sweeps']} sweeps, "
          f"{stats['events_per_sec']:.0f} candidate-events/s)")
    dec = policy_engine.policy_decisions_compiled(
        vms_list[0], "pond", control_plane(li, um, hist))
    for p in cluster_sim.tiered_pricing(
            dec, TierHierarchy.three_tier(cache_hit_rate=0.3),
            far_fracs=(0.0, 0.25, 0.5), device=args.device):
        print(f"  3-tier far_frac={p.far_frac:.2f}: mean slowdown="
              f"{p.mean_slowdown:.4f} PDM violations="
              f"{p.violation_frac:.3f}")
    return rows


if __name__ == "__main__":
    main()
