"""Savings against pod topology on the PyTorch/CUDA port:
``benchmarks/fig_topology.py``'s frontier.

At equal pool hardware, how much does the way a cluster row's servers
reach their CXL pods move the reject rate?  Every candidate lane is a
``(server_gb, per-pod capacities, topology)`` triple — partitioned pods,
Octopus-style overlapping pods, sparse random reach — with one total pool
budget split integrally over each topology's pods
(``topology.split_pool``), and one launch of the pod sweep (K4), through
``CompiledReplay.reject_rates_fleet``, prices the whole (DRAM size x pool
budget x topology) grid.  The grid is held to the port's scalar oracle
(``cluster_sim.replay_multi_pool``), which is also timed as the speed
yardstick, the 1-pod lanes to the single-pool engine (K1), and the
benchmark's four claims are printed.  The default is the benchmark's
quick sizes (16 servers, 2 days, 3 DRAM sizes, 2 pool budgets, 5
topologies).

  PYTHONPATH=src python examples/torch_fig_topology.py          # card
  PYTHONPATH=src python examples/torch_fig_topology.py --device cpu
"""
import argparse
import time

import numpy as np

from repro_torch.core import cluster_sim, replay_engine, topology, traces

HORIZON = 2 * 86400


def topologies(n_servers: int, quick: bool) -> list:
    """The benchmark's topology set: partitioned pods of 4 and 8 servers,
    one pool, overlapping and sparse rows of 2 pods; with ``quick`` off
    also rows of 3 pods and a sparse layout with orphan servers."""
    topos = [
        topology.partitioned(n_servers, 4),
        topology.partitioned(n_servers, 8),
        topology.single_pool(n_servers),
        topology.overlapping(n_servers, 4, 2),
        topology.sparse(n_servers, 4, 2, seed=7),
    ]
    if not quick:
        topos += [
            topology.overlapping(n_servers, 4, 3),
            topology.sparse(n_servers, 6, 2, seed=8),
            topology.sparse(n_servers, 4, 3, seed=9, allow_orphans=True),
        ]
    return topos


def grid(topos, dram_fracs, pool_totals, full_gb):
    """(DRAM fraction x pool total x topology) flattened to fleet lanes:
    (server_gb, per-lane pod capacities, per-lane topologies, meta)."""
    sgb, caps, lane_topos, meta = [], [], [], []
    for frac in dram_fracs:
        for total in pool_totals:
            for t in topos:
                sgb.append(round(full_gb * frac))
                caps.append(topology.split_pool(total, t.n_pods))
                lane_topos.append(t)
                meta.append((frac, total, t.describe()))
    return np.asarray(sgb, float), caps, lane_topos, meta


def axes(peak_pool: float, quick: bool):
    """(DRAM fractions, pool totals): the benchmark's, the pool totals as
    fractions of the trace's peak pool demand."""
    dram_fracs = [1.0, 0.8, 0.65] if quick else \
        [1.0, 0.9, 0.8, 0.7, 0.6, 0.5]
    pool_totals = [np.ceil(0.25 * peak_pool), peak_pool] if quick else \
        [np.ceil(f * peak_pool) for f in (0.125, 0.25, 0.5, 1.0)]
    return dram_fracs, pool_totals


def oracle_rates(vms, decisions, cfg, sgb, caps, lane_topos, lanes):
    """The scalar oracle's rates at ``lanes`` (indices into the grid) and
    the host seconds they took."""
    t0 = time.perf_counter()
    rates = np.array([cluster_sim.replay_multi_pool(
        vms, decisions, cfg, float(sgb[i]), lane_topos[i], caps[i])
        for i in lanes])
    return rates, time.perf_counter() - t0


def claims(rates, meta, dram_fracs, pool_totals, *, oracle, oracle_lanes,
           oracle_s, compiled_s, base, one, n_events):
    """The benchmark's four claims as (name, ok, detail): the grid's rates
    ``==`` the oracle's at ``oracle_lanes``; the compiled grid >= 5x the
    oracle loop over every lane (its time a lane from the lanes it ran);
    topology choice moves rejects at the tight pool budget and the deepest
    DRAM savings; the 1-pod lanes ``one`` == the single-pool engine's
    ``base``."""
    n_lanes = len(rates)
    loop_s = oracle_s / max(len(oracle_lanes), 1) * n_lanes
    speedup = loop_s / max(compiled_s, 1e-9)
    tight = [r for (f, t, _), r in zip(meta, rates)
             if f == dram_fracs[-1] and t == float(pool_totals[0])]
    spread = max(tight) - min(tight)
    return [
        ("fleet sweep bit-exact vs scalar multi-pod oracle",
         bool((rates[list(oracle_lanes)] == oracle).all()),
         f"{len(oracle_lanes)} of {n_lanes} lanes, integer-count exact"),
        ("compiled topology grid >= 5x the oracle loop",
         bool(speedup >= 5.0),
         f"{speedup:.1f}x ({n_lanes} lanes x {n_events} events: "
         f"{compiled_s:.3f}s vs {loop_s:.3f}s, the oracle's "
         f"{oracle_s / max(len(oracle_lanes), 1):.3f}s a lane)"),
        ("topology choice moves rejects at equal hardware",
         bool(spread > 0.0),
         f"reject-rate spread {spread:.4f} across {len(tight)} topologies "
         f"(tight pool, {100 * (1 - dram_fracs[-1]):.0f}% DRAM savings)"),
        ("1-pod fleet lane == single-pool engine bitwise",
         bool((np.asarray(base) == np.asarray(one)).all()),
         f"{len(base)} lanes"),
    ]


def run(quick: bool = True, device=None) -> dict:
    """The benchmark's study on its own world (16 servers of 64 cores,
    8-socket pools, 4 GB a core, 2 days at 0.8 utilisation, static 0.25
    decisions), priced on ``device`` (default: the card).  Returns the
    grid, its integer reject counts, the timings and the claims."""
    cfg = cluster_sim.ClusterConfig(n_servers=16, pool_sockets=8,
                                    gb_per_core=4.0)
    n = cluster_sim.arrivals_for_util(cfg, 0.8, HORIZON)
    vms = traces.Population(seed=0).sample_vms(n, HORIZON, seed=13,
                                               start_id=8 * 10 ** 6)
    dec, _ = cluster_sim.policy_decisions(vms, "static",
                                          static_pool_frac=0.25)
    eng = replay_engine.CompiledReplay(vms, dec, cfg, device=device)
    full_gb = cfg.gb_per_core * cfg.cores_per_server
    peak = float(np.ceil(eng.peak_pool_demand()))
    dram_fracs, pool_totals = axes(peak, quick)
    topos = topologies(cfg.n_servers, quick)
    sgb, caps, lane_topos, meta = grid(topos, dram_fracs, pool_totals,
                                       full_gb)
    # a first call compiles and uploads the trace; the second is the
    # steady-state cost a provisioning search pays a probe batch
    eng.reject_rates_fleet(sgb, caps, lane_topos)
    t0 = time.perf_counter()
    rates = eng.reject_rates_fleet(sgb, caps, lane_topos)
    compiled_s = time.perf_counter() - t0
    lanes = range(len(sgb))
    oracle, oracle_s = oracle_rates(vms, dec, cfg, sgb, caps, lane_topos,
                                    lanes)
    # 1-pod degenerate: the single-pool engine needs an n_groups == 1 row
    cfg1 = cluster_sim.ClusterConfig(n_servers=cfg.n_servers,
                                     pool_sockets=2 * cfg.n_servers,
                                     gb_per_core=cfg.gb_per_core)
    eng1 = replay_engine.CompiledReplay(vms, dec, cfg1, device=device)
    base = eng1.reject_rates(sgb[:len(topos)], float(pool_totals[0]))
    one = eng1.reject_rates_fleet(sgb[:len(topos)], float(pool_totals[0]),
                                  topology.single_pool(cfg.n_servers))
    out = claims(rates, meta, dram_fracs, pool_totals, oracle=oracle,
                 oracle_lanes=list(lanes), oracle_s=oracle_s,
                 compiled_s=compiled_s, base=base, one=one,
                 n_events=eng.n_events)
    return dict(n_servers=cfg.n_servers, n_vms=eng.n_vms,
                n_events=eng.n_events, peak_pool_gb=peak,
                dram_fracs=dram_fracs,
                pool_totals_gb=[float(t) for t in pool_totals],
                topologies=[t.describe() for t in topos], meta=meta,
                rates=rates,
                reject_counts=np.rint(rates * eng.n_vms).astype(int).tolist(),
                compiled_s=compiled_s, oracle_s=oracle_s, claims=out,
                device=str(eng.device))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' to run on the CPU")
    ap.add_argument("--full", action="store_true",
                    help="the benchmark's full sizes (6 DRAM sizes, 4 pool "
                         "budgets, 8 topologies)")
    args = ap.parse_args(argv)
    res = run(quick=not args.full, device=args.device)
    print(f"{res['n_servers']} servers, {res['n_vms']} VMs, "
          f"{res['n_events']} events, peak pool {res['peak_pool_gb']:.0f} "
          f"GB, {len(res['meta'])} lanes on {res['device']}:")
    for (frac, total, desc), count in zip(res["meta"],
                                          res["reject_counts"]):
        print(f"  DRAM {frac:4.2f} pool {total:6.0f} GB {desc}: "
              f"{count} rejects")
    for name, ok, detail in res["claims"]:
        print(f"  [{'PASS' if ok else 'FAIL'}] {name}: {detail}")
    return res


if __name__ == "__main__":
    main()
