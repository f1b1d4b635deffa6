"""zNUMA spill and its slowdown (paper Figs 15/16) on the PyTorch/CUDA port.

Paged-KV alloc/free streams of a decode server (each request takes 3-6
pages, the oldest requests retire when live demand passes the peak) are
replayed against a grid of local-tier sizes in ONE launch of the spill
sweep kernel (K6) for every stream and size; the measured spill
fractions (pool allocations over allocations) are then priced by the
2-tier model and by two 3-tier hierarchies (a far tier taking a quarter
of the spill; with and without a DRAM-cache front).  The default is the
full width of the qwen2-1.5b paged pool: a 1,280-page peak, 16,384
requests a stream, 4 streams, local tiers of 16..1,280 pages, a 1,024-page
pool.

  PYTHONPATH=src python examples/torch_fig16_spill.py              # on the card
  PYTHONPATH=src python examples/torch_fig16_spill.py --device cpu \\
      --requests 200 --peak-pages 32 --local-step 4     # plain version
"""
import argparse
import time

import numpy as np

from repro_torch.core import latency_engine as le
from repro_torch.core.latency_model import TierHierarchy, TierModel
from repro_torch.kernels.spill_sweep import cases


def price(fracs, far: float = 0.25):
    """Per-lane slowdowns (fractions over 1) of a spill fraction on the
    2-tier model, the 3-tier hierarchy and the 3-tier hierarchy behind a
    DRAM cache (hit rate 0.5), ``far`` of the spill on the far tier."""
    tier, h3 = TierModel(), TierHierarchy.three_tier()
    hc = TierHierarchy.three_tier(cache_hit_rate=0.5)
    rows = []
    for f in fracs.tolist():
        split = [f * (1 - far), f * far]
        rows.append((tier.slowdown_factor(f) - 1.0,
                     h3.slowdown_factor(split) - 1.0,
                     hc.slowdown_factor(split) - 1.0))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' to run on the CPU")
    ap.add_argument("--seeds", type=int, nargs="+", default=[3, 4, 5, 6])
    ap.add_argument("--requests", type=int, default=16384)
    ap.add_argument("--peak-pages", type=int, default=1280)
    ap.add_argument("--local-step", type=int, default=16,
                    help="local tiers of step, 2 step, ..., peak pages")
    ap.add_argument("--pool-pages", type=int, default=1024)
    ap.add_argument("--print-every", type=int, default=8)
    args = ap.parse_args(argv)
    kinds, keys, _, peaks = cases.kv_event_batch(args.seeds, args.requests,
                                                 args.peak_pages)
    num_local = np.arange(args.local_step, args.peak_pages + 1,
                          args.local_step, dtype=np.int32)
    num_pool = np.full_like(num_local, args.pool_pages)
    t0 = time.perf_counter()
    grid = le.spill_grid(kinds, keys, num_local, num_pool, backend="torch",
                         device=args.device)
    grid_s = time.perf_counter() - t0
    fracs = grid.spill_fraction                       # (K, C)
    mean, std = fracs.mean(0), fracs.std(0)
    print(f"spill grid: {len(args.seeds)} streams x {kinds.shape[1]} events "
          f"x {len(num_local)} local tiers in {grid_s:.3f} s "
          f"(peak demand {max(peaks)} pages, failed allocations "
          f"{int(grid.failed.sum())})")
    for c, (slow2, slow3, slowc) in enumerate(price(mean)):
        if c % args.print_every and c != len(num_local) - 1:
            continue
        print(f"  local={num_local[c]:5d} pages: spilled={mean[c]:6.4f}"
              f"±{std[c]:6.4f} slowdown 2-tier={slow2 * 100:5.1f}% "
              f"3-tier={slow3 * 100:5.1f}% +cache={slowc * 100:5.1f}%")
    return grid


if __name__ == "__main__":
    main()
