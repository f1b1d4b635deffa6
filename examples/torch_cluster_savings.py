"""Pond's DRAM savings (paper Figs 3 and 21 in miniature) on the PyTorch/CUDA
port: the static-pool policy against all-local provisioning, every
replay sweep one launch of the event-sweep kernel (K1) on the card.

The demo prices one candidate frontier in a single sweep, then runs the
provisioning searches (``savings_analysis``) for the ``local`` and
``static`` policies on one synthetic trace.

  PYTHONPATH=src python examples/torch_cluster_savings.py               # on the card
  PYTHONPATH=src python examples/torch_cluster_savings.py --device cpu  # plain version
  PYTHONPATH=src python examples/torch_cluster_savings.py \\
      --servers 256 --days 7 --static-pool-frac 0.30      # a full cluster row
"""
import argparse
import time

import numpy as np

from repro_torch.core import cluster_sim, replay_engine, traces


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' to run on the CPU")
    ap.add_argument("--servers", type=int, default=16)
    ap.add_argument("--days", type=float, default=5.0,
                    help="trace length (the cluster runs at ~0.8 of its "
                         "cores)")
    ap.add_argument("--seed", type=int, default=2, help="trace seed")
    ap.add_argument("--static-pool-frac", type=float, default=0.15,
                    help="share of each VM's memory in the pool (static)")
    args = ap.parse_args(argv)

    horizon = args.days * 86400
    cfg = cluster_sim.ClusterConfig(n_servers=args.servers, pool_sockets=16,
                                    gb_per_core=4.75)
    n = cluster_sim.arrivals_for_util(cfg, 0.8, horizon)
    vms = traces.Population(seed=0).sample_vms(n, horizon, seed=args.seed,
                                               start_id=10 ** 6)
    label = f"{args.servers} servers, {len(vms)} VMs"

    # --- 1. price one candidate frontier in a single sweep -------------
    decisions, _ = cluster_sim.policy_decisions(
        vms, "static", static_pool_frac=args.static_pool_frac,
        as_arrays=True)
    eng = replay_engine.CompiledReplay(vms, decisions, cfg,
                                       device=args.device)
    hi = cfg.cores_per_server * 6.0      # per-server DRAM probe ceiling
    server_gb = np.linspace(hi * 0.5, hi, 9)
    pool_gb = np.linspace(0.0, 2.0 * hi, 9)
    eng.reject_rates(server_gb, pool_gb)        # builds the kernel once
    t0 = time.perf_counter()
    rates = eng.reject_rates(server_gb, pool_gb)
    dt = time.perf_counter() - t0
    print(f"[{label} on {eng.device}] one sweep priced {len(rates)} "
          f"(server_gb, pool_gb) candidates in {dt * 1e3:.0f}ms over "
          f"{eng.n_events} events:")
    for s, p, r in zip(server_gb, pool_gb, rates):
        print(f"  server={s:5.0f}GB pool={p:5.0f}GB -> reject {r:.4f}")

    # --- 2. full provisioning searches ---------------------------------
    replay_engine.stats_reset()
    cache: dict = {}
    t0 = time.perf_counter()
    results = [cluster_sim.savings_analysis(vms, cfg, "local", cache=cache,
                                            device=args.device),
               cluster_sim.savings_analysis(
                   vms, cfg, "static", cache=cache, device=args.device,
                   static_pool_frac=args.static_pool_frac)]
    dt = time.perf_counter() - t0
    stats = replay_engine.stats_snapshot()
    print(f"\ntwo policy searches in {dt:.2f}s ({stats['sweeps']} sweeps, "
          f"{stats['events_per_sec']:.0f} candidate-events/s):")
    for r in results:
        print(f"  {r.name:6s}: server={r.server_gb:6.1f}GB "
              f"pool/group={r.pool_group_gb:6.1f}GB "
              f"savings={r.savings:+.3f} reject={r.reject_rate:.4f}")
    return results


if __name__ == "__main__":
    main()
