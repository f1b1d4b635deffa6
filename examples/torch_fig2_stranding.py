"""Fig 2a on the PyTorch/CUDA port: stranded memory against the share of
cores scheduled, the twin of ``benchmarks/fig2_stranding.py``.

A cluster row with fixed per-server DRAM replays a trace with a cores-only
best-fit placement (``cluster_sim.place_by_cores``); stranded memory is
the free DRAM on servers whose cores are exhausted, sampled at 200
instants (``cluster_sim.stranding_analysis``: per-server clamped
cumulative sums, no per-event Python loop) and bucketed by scheduled-core
fraction (``stranding_by_bucket``).  The replay is host numpy, as in the
reference; ``--device`` is checked as every entry point of the port checks
it.  The benchmark's three claims are printed.

  PYTHONPATH=src python examples/torch_fig2_stranding.py              # card
  PYTHONPATH=src python examples/torch_fig2_stranding.py --device cpu
  PYTHONPATH=src python examples/torch_fig2_stranding.py --device cpu --full
"""
import argparse
import time

from repro_torch.core import cluster_sim, traces
from repro_torch.device import resolve_device


def claim(name, ok, detail):
    print(f"  [{'PASS' if ok else 'FAIL'}] {name}: {detail}")
    return bool(ok)


def run(quick: bool = True, n_servers: int = 16, device=None) -> dict:
    resolve_device(device)
    print("== Fig 2: memory stranding vs core allocation ==")
    cfg = cluster_sim.ClusterConfig(n_servers=n_servers, pool_sockets=16,
                                    gb_per_core=4.75)
    horizon = (6 if quick else 15) * 86400
    n = cluster_sim.arrivals_for_util(cfg, 0.85, horizon)
    vms = traces.Population(seed=0).sample_vms(n, horizon, seed=2,
                                               start_id=10 ** 6)
    t0 = time.perf_counter()
    rows = cluster_sim.stranding_by_bucket(
        cluster_sim.stranding_analysis(vms, cfg))
    wall = time.perf_counter() - t0
    print(f"  compiled-event stranding replay: {wall * 1e3:.0f} ms "
          f"({len(vms)} VMs)")
    for mid, mean, p95 in rows:
        print(f"  core-util {mid:4.2f}: stranded mean={mean:6.3f} "
              f"p95={p95:6.3f}")
    highs = [r for r in rows if r[0] >= 0.75]
    res = {"rows": rows, "wall_s": wall}
    res["claims"] = [
        claim("stranding grows with core allocation",
              rows[-1][1] > rows[0][1],
              f"{rows[0][1]:.3f} -> {rows[-1][1]:.3f}"),
        claim("~6-10%+ mean stranding when cores >75% scheduled "
              "(paper Fig 2a)",
              bool(highs) and max(r[1] for r in highs) >= 0.06,
              f"max mean at high util = "
              f"{max((r[1] for r in highs), default=0):.3f}"),
        claim("p95 outliers reach >=20% (paper: 25%)",
              max(r[2] for r in rows) >= 0.20,
              f"max p95 = {max(r[2] for r in rows):.3f}")]
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' to run on the CPU")
    ap.add_argument("--full", action="store_true",
                    help="the benchmark's full size (15 days)")
    ap.add_argument("--servers", type=int, default=16)
    args = ap.parse_args(argv)
    return run(quick=not args.full, n_servers=args.servers,
               device=args.device)


if __name__ == "__main__":
    main()
