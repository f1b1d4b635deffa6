"""Fig 3 on the PyTorch/CUDA port: DRAM savings from static pooling
against pool size, the twin of ``benchmarks/fig3_poolsize.py``.

Every cell (a pooled fraction x a pool size in sockets) is priced over a
batch of trace seeds in lockstep (``cluster_sim.savings_analysis_batched``
over ``replay_engine.CompiledReplayBatch``: each search round is one launch
of the event sweep K1 over every seed's candidates) and reports the mean ±
std savings across the seeds.  Then the K = 8 batched sweep is timed
against looping the engine a seed (a 16-point frontier and a 2-probe
batch), the streaming sweep against the monolithic one, and the engine
against the scalar oracle on the same probes; the benchmark's seven claims
are printed.

  PYTHONPATH=src python examples/torch_fig3_poolsize.py               # card
  PYTHONPATH=src python examples/torch_fig3_poolsize.py --device cpu --seeds 2
  PYTHONPATH=src python examples/torch_fig3_poolsize.py --full        # 15 days, 4 sizes, 8 seeds
"""
import argparse
import time

import numpy as np

from repro_torch.core import cluster_sim, replay_engine, traces
from repro_torch.device import resolve_device

BENCH_K = 8          # seed count of the timed batched sweep


def seed_traces(pop, cfg, horizon, k):
    n = cluster_sim.arrivals_for_util(cfg, 0.8, horizon)
    return [pop.sample_vms(n, horizon, seed=2 + i, start_id=10 ** 6)
            for i in range(k)]


def batched_sweep_bench(vms_list, cfg, static_pool_frac=0.30, device=None):
    """The K-seed batched sweep (one launch for every seed) against looping
    the engine a seed, at a 16-point frontier and a 2-probe batch; the
    batched rows held to the per-seed sweeps bit for bit."""
    decs = [cluster_sim.policy_decisions(v, "static",
                                         static_pool_frac=static_pool_frac)[0]
            for v in vms_list]
    engines = [replay_engine.CompiledReplay(v, d, cfg, device=device)
               for v, d in zip(vms_list, decs)]
    batch = replay_engine.CompiledReplayBatch(engines)
    out = {"k": len(engines)}
    for name, n_cand in (("frontier16", 16), ("narrow2", 2)):
        probe_s = np.linspace(150.0, 700.0, n_cand)
        probe_p = np.linspace(0.0, 2000.0, n_cand)
        batch.reject_rates(probe_s, probe_p)            # warm the paths
        for e in engines:
            e.reject_rates(probe_s, probe_p)
        t_b, t_l = [], []
        for _ in range(5):
            t0 = time.perf_counter()
            rb = batch.reject_rates(probe_s, probe_p)
            t_b.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            rl = np.stack([e.reject_rates(probe_s, probe_p)
                           for e in engines])
            t_l.append(time.perf_counter() - t0)
        out[name] = {
            "batched_ms": min(t_b) * 1e3,
            "seed_loop_ms": min(t_l) * 1e3,
            "speedup": min(t_l) / min(t_b),
            "bit_exact": rb.tolist() == rl.tolist(),
            "events_per_sec": sum(e.n_events for e in engines) * n_cand
            / min(t_b),
        }
    return out


def streaming_sweep_bench(vms, cfg, max_events_per_shard=1024,
                          static_pool_frac=0.30, n_cand=8, device=None):
    """The streamed sweep (one launch a shard, the state carried) against
    the monolithic engine: its rates bit for bit, its time and its peak
    shard bytes."""
    dec = cluster_sim.policy_decisions(vms, "static",
                                       static_pool_frac=static_pool_frac)[0]
    eng = replay_engine.CompiledReplay(vms, dec, cfg, device=device)
    stream = replay_engine.CompiledReplayStream(
        vms, dec, cfg, max_events_per_shard=max_events_per_shard,
        device=device)
    probe_s = np.linspace(150.0, 700.0, n_cand)
    probe_p = np.linspace(0.0, 2000.0, n_cand)
    eng.reject_rates(probe_s, probe_p)              # warm the paths
    stream.reject_rates(probe_s, probe_p)
    t_m, t_s = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        rm = eng.reject_rates(probe_s, probe_p)
        t_m.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        rs = stream.reject_rates(probe_s, probe_p)
        t_s.append(time.perf_counter() - t0)
    return {
        "n_events": int(stream.n_events),
        "n_shards": int(stream.n_shards),
        "max_events_per_shard": int(max_events_per_shard),
        "peak_shard_bytes": int(stream.peak_shard_bytes),
        "monolithic_ms": min(t_m) * 1e3,
        "stream_ms": min(t_s) * 1e3,
        "overhead_vs_monolithic": min(t_s) / min(t_m),
        "events_per_sec": stream.n_events * n_cand / min(t_s),
        "bit_exact": rs.tolist() == rm.tolist(),
    }


def claim(name, ok, detail):
    print(f"  [{'PASS' if ok else 'FAIL'}] {name}: {detail}")
    return bool(ok)


def run(quick: bool = True, seeds: int | None = None, device=None) -> dict:
    resolve_device(device)
    print("== Fig 3: pool size vs DRAM savings (static pooling, "
          "seed-batched) ==")
    horizon = (5 if quick else 15) * 86400
    sizes = (8, 16, 32) if quick else (8, 16, 32, 64)
    fracs = (0.10, 0.30, 0.50)
    k = seeds or (4 if quick else 8)
    pop = traces.Population(seed=0)
    # the traces depend only on the server count and horizon: sample the
    # seed batch once for every cell
    cfg0 = cluster_sim.ClusterConfig(n_servers=16, pool_sockets=sizes[0],
                                     gb_per_core=4.75)
    vms_all = seed_traces(pop, cfg0, horizon, max(k, BENCH_K))
    vms_list = vms_all[:k]

    replay_engine.stats_reset()
    cache: dict = {}        # shares the all-local baseline across cells
    t0 = time.perf_counter()
    table, spread = {}, {}
    for frac in fracs:
        row, row_std = [], []
        for ps in sizes:
            cfg = cluster_sim.ClusterConfig(n_servers=16, pool_sockets=ps,
                                            gb_per_core=4.75)
            results = cluster_sim.savings_analysis_batched(
                vms_list, cfg, "static", static_pool_frac=frac, cache=cache,
                device=device)
            s = cluster_sim.summarize_savings(results)
            row.append(s["savings_mean"])
            row_std.append(s["savings_std"])
        table[frac], spread[frac] = row, row_std
        print(f"  pool frac {frac:4.2f}: " + "  ".join(
            f"{sz}skt={v:+.3f}±{sd:.3f}"
            for sz, v, sd in zip(sizes, row, row_std)))
    wall = time.perf_counter() - t0
    stats = replay_engine.stats_snapshot()
    print(f"  engine: {wall:.2f} s for {len(fracs) * len(sizes)} policy "
          f"cells x {k} seeds, {stats['events_per_sec']:.0f} "
          "candidate-events/s")

    bench_traces = vms_all[:BENCH_K]
    cfg16 = cluster_sim.ClusterConfig(n_servers=16, pool_sockets=16,
                                      gb_per_core=4.75)
    batched = batched_sweep_bench(bench_traces, cfg16, device=device)
    for shape in ("frontier16", "narrow2"):
        b = batched[shape]
        print(f"  batched K={batched['k']} {shape}: {b['batched_ms']:.2f} ms "
              f"vs seed loop {b['seed_loop_ms']:.2f} ms -> "
              f"{b['speedup']:.2f}x")
    streaming = streaming_sweep_bench(bench_traces[0], cfg16, device=device)
    print(f"  streaming {streaming['n_shards']} shards of <= "
          f"{streaming['max_events_per_shard']} events "
          f"({streaming['peak_shard_bytes'] / 2 ** 10:.0f} KiB a shard): "
          f"{streaming['stream_ms']:.2f} ms vs monolithic "
          f"{streaming['monolithic_ms']:.2f} ms")

    # the engine against the scalar oracle on the same probe frontier
    decisions, _ = cluster_sim.policy_decisions(vms_list[0], "static",
                                                static_pool_frac=0.30)
    eng = replay_engine.CompiledReplay(vms_list[0], decisions, cfg16,
                                       device=device)
    probe_s = np.linspace(150.0, 700.0, 16)
    probe_p = np.linspace(0.0, 2000.0, 16)
    eng.reject_rates(probe_s, probe_p)                  # warm the path
    t1 = time.perf_counter()
    batched_rates = eng.reject_rates(probe_s, probe_p)
    t_batch = time.perf_counter() - t1
    t1 = time.perf_counter()
    scalar = [cluster_sim.replay_reject_rate(vms_list[0], decisions, cfg16,
                                             s, p)
              for s, p in zip(probe_s[:4], probe_p[:4])]
    t_scalar = (time.perf_counter() - t1) * len(probe_s) / 4
    speedup = t_scalar / max(t_batch, 1e-9)
    exact = batched_rates[:4].tolist() == scalar
    print(f"  replay speedup vs scalar oracle: {speedup:.1f}x "
          f"({len(probe_s)} candidates in {t_batch * 1e3:.1f} ms)")

    res = {"sizes": sizes, "n_seeds": k, "table": table, "spread": spread,
           "wall_s": wall, "engine": stats, "replay_speedup": speedup,
           "batched": batched, "streaming": streaming}
    res["claims"] = [
        claim("savings grow with pool size (diminishing)",
              all(table[f][-1] >= table[f][0] - 0.01 for f in fracs),
              str({f: [round(v, 4) for v in r] for f, r in table.items()})),
        claim("larger pooled fraction saves more at >=16 sockets",
              table[0.50][1] >= table[0.10][1],
              f"50%:{table[0.50][1]:.4f} vs 10%:{table[0.10][1]:.4f}"),
        claim("batched engine matches scalar oracle on probes", exact,
              f"{batched_rates[:4].tolist()} vs {scalar}"),
        claim("batched replay >=5x faster than scalar oracle",
              speedup >= 5.0, f"{speedup:.1f}x"),
        claim("K-seed batched sweep bit-exact vs per-seed sweeps",
              batched["frontier16"]["bit_exact"]
              and batched["narrow2"]["bit_exact"], "both shapes"),
        claim("K-seed batched sweep >=3x faster than seed loop",
              batched["narrow2"]["speedup"] >= 3.0,
              f"narrow2 {batched['narrow2']['speedup']:.2f}x, frontier16 "
              f"{batched['frontier16']['speedup']:.2f}x"),
        claim("sharded streaming replay bit-exact vs monolithic",
              streaming["bit_exact"] and streaming["n_shards"] > 1,
              f"{streaming['n_shards']} shards")]
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' to run on the CPU")
    ap.add_argument("--full", action="store_true",
                    help="the benchmark's full sizes (15 days, 4 pool "
                         "sizes, 8 seeds)")
    ap.add_argument("--seeds", type=int, default=None,
                    help="trace seeds a cell (default 4; --full 8)")
    args = ap.parse_args(argv)
    return run(quick=not args.full, seeds=args.seeds, device=args.device)


if __name__ == "__main__":
    main()
