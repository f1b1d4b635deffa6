"""Savings against availability under Pond's failure model (§4.2) on the
PyTorch/CUDA port: ``benchmarks/fig_availability.py``'s frontier.

Pooling saves DRAM and widens the blast radius of an EMC failure: every VM
holding pool slices on a failed EMC is affected at once.  For each domain
size (servers per EMC group) the failure-rate axis (one
``FailureSchedule`` per MTBF) rides the trace axis of
``CompiledReplayBatch.availability`` — one launch of the failure sweep
(K5) per mitigation prices every (schedule, DRAM size) cell — and both
mitigations (remigrate to local DRAM, kill) are priced on the same
schedules.  The tightest cell is held to the port's scalar oracle, and the
benchmark's claims are printed.  The default is the benchmark's quick
sizes (16 servers, 2 days, MTBF 4 and 24 h, 8- and 32-socket domains).

  PYTHONPATH=src python examples/torch_fig_availability.py          # card
  PYTHONPATH=src python examples/torch_fig_availability.py --device cpu
"""
import argparse
import time

import numpy as np

from repro_torch.core import cluster_sim, replay_engine, traces
from repro_torch.runtime.fault import FailureSchedule

REPAIR_S = 1800.0                      # 30 min EMC repair outage


def _world(sockets, servers, horizon):
    cfg = cluster_sim.ClusterConfig(n_servers=servers, pool_sockets=sockets,
                                    gb_per_core=4.0)
    n = cluster_sim.arrivals_for_util(cfg, 0.8, horizon)
    vms = traces.Population(seed=0).sample_vms(n, horizon, seed=11,
                                               start_id=7 * 10 ** 6)
    dec, _ = cluster_sim.policy_decisions(vms, "static",
                                          static_pool_frac=0.25,
                                          as_arrays=True)
    return cfg, vms, dec


def frontier(cfg, vms, dec, mtbfs, horizon, dram_fracs, device=None):
    """The (failure rate x DRAM size x mitigation) grid of one domain size:
    ({mitigation: AvailabilityResult (K, n_cand)}, schedules, server_gb,
    pool_gb)."""
    scheds = [FailureSchedule.generate(horizon, cfg.n_groups, m, REPAIR_S,
                                       seed=i)
              for i, m in enumerate(mtbfs)]
    engines = [replay_engine.CompiledReplay(vms, dec, cfg,
                                            failure_schedule=s,
                                            device=device)
               for s in scheds]
    batch = replay_engine.CompiledReplayBatch(engines)
    full_gb = cfg.gb_per_core * cfg.cores_per_server
    server = np.round(full_gb * np.asarray(dram_fracs))
    pool = np.full_like(server, np.ceil(engines[0].peak_pool_demand()))
    out = {mit: batch.availability(server, pool, mitigation=mit)
           for mit in ("remigrate", "kill")}
    return out, scheds, server, pool


def claim(name, ok, detail):
    print(f"  [{'PASS' if ok else 'FAIL'}] {name}: {detail}")
    return bool(ok)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' to run on the CPU")
    ap.add_argument("--full", action="store_true",
                    help="the benchmark's full sizes (6 days, 4 rates, 6 "
                         "DRAM sizes, 4 domain sizes)")
    ap.add_argument("--servers", type=int, default=16)
    args = ap.parse_args(argv)
    quick = not args.full
    horizon = 2 * 86400 if quick else 6 * 86400
    mtbfs = [4 * 3600.0, 24 * 3600.0] if quick else \
        [2 * 3600.0, 8 * 3600.0, 24 * 3600.0, 96 * 3600.0]
    dram_fracs = [1.0, 0.85, 0.7, 0.55] if quick else \
        [1.0, 0.9, 0.8, 0.7, 0.6, 0.5]
    domain_sockets = [8, 32] if quick else [8, 16, 32, 64]
    t0 = time.perf_counter()
    res, per_fail = {}, {}
    for sockets in domain_sockets:
        cfg, vms, dec = _world(sockets, args.servers, horizon)
        out, scheds, server, pool = frontier(cfg, vms, dec, mtbfs, horizon,
                                             dram_fracs, args.device)
        n_fail = np.array([s.n_failures for s in scheds])
        res[sockets] = out
        # mean blast radius: VMs affected a failure, kill, full DRAM
        per_fail[sockets] = float((out["kill"].affected[:, 0]
                                   / np.maximum(n_fail, 1)).mean())
        print(f"{cfg.servers_per_group} servers/EMC group, {len(vms)} VMs, "
              f"{n_fail.tolist()} failures, pool {pool[0]:.0f} GB:")
        for mit, r in out.items():
            for i, m in enumerate(mtbfs):
                print(f"  {mit:9s} MTBF {m / 3600:4.0f} h: affected "
                      f"{r.affected[i].tolist()} killed "
                      f"{r.killed[i].tolist()} lost VM-min "
                      f"{r.lost_vm_minutes[i].tolist()}")
        print(f"  {per_fail[sockets]:.1f} VMs affected per failure (kill, "
              "full DRAM)")
    wall = time.perf_counter() - t0
    print(f"frontier priced in {wall:.2f} s")

    # the tightest cell against the scalar oracle
    cfg, vms, dec = _world(domain_sockets[0], args.servers, horizon)
    sched = FailureSchedule.generate(horizon, cfg.n_groups, mtbfs[0],
                                     REPAIR_S, seed=0)
    eng = replay_engine.CompiledReplay(vms, dec, cfg, failure_schedule=sched,
                                       device=args.device)
    sgb = [cfg.gb_per_core * cfg.cores_per_server * dram_fracs[-1]]
    pgb = [np.ceil(eng.peak_pool_demand())]
    dev = eng.availability(sgb, pgb, per_failure=False)
    orc = eng.availability(sgb, pgb, backend="oracle", per_failure=False)
    ok = [claim("failure sweep bit-exact vs scalar oracle",
                all(np.array_equal(getattr(dev, f), getattr(orc, f))
                    for f in replay_engine.AVAILABILITY_FIELDS),
                f"tightest cell, on {eng.device}")]
    hi_rate, lo_rate = 0, len(mtbfs) - 1
    ok.append(claim(
        "more frequent failures affect more VMs (kill)",
        all(r["kill"].affected[hi_rate, 0] >= r["kill"].affected[lo_rate, 0]
            for r in res.values()),
        f"affected at MTBF {mtbfs[0] / 3600:.0f} h vs "
        f"{mtbfs[-1] / 3600:.0f} h, full DRAM"))
    ok.append(claim(
        "remigration recovers VM-minutes vs kill at full DRAM",
        all((r["remigrate"].lost_vm_minutes[:, 0]
             <= r["kill"].lost_vm_minutes[:, 0]).all()
            for r in res.values()),
        f"lost minutes, every rate row, {len(res)} domains"))
    ok.append(claim(
        "DRAM savings erode remigration headroom",
        all((r["remigrate"].remigration_success_rate[:, -1]
             <= r["remigrate"].remigration_success_rate[:, 0] + 1e-9).all()
            for r in res.values()),
        f"remigration success at {100 * (1 - dram_fracs[-1]):.0f}% savings "
        "<= full DRAM, every rate row"))
    small, large = domain_sockets[0], domain_sockets[-1]
    ok.append(claim(
        "larger failure domains widen the blast radius",
        per_fail[large] >= per_fail[small],
        f"{per_fail[small]:.1f} VMs/failure at {small // 2} servers/group "
        f"vs {per_fail[large]:.1f} at {large // 2}"))
    return res, ok


if __name__ == "__main__":
    main()
