"""End-to-end replay of an Azure-format VM dump on the PyTorch/CUDA port:
chunked ingestion, compiled decisions and the file-fed streaming sweep.

  PYTHONPATH=src python examples/torch_azure_e2e.py                # card
  PYTHONPATH=src python examples/torch_azure_e2e.py --full         # 250,000 VMs, 256 servers
  PYTHONPATH=src python examples/torch_azure_e2e.py --device cpu --vms 4000
  PYTHONPATH=src python examples/torch_azure_e2e.py --trace-file azure.csv.gz

The stages of ``benchmarks/azure_e2e.py``, timed end to end:

1. **Chunked ingestion**: ``traces.iter_trace_chunks`` streams the dump in
   bounded-memory chunks (VMs/s of trace materialisation on the host;
   ``--max-bad-rows`` quarantines malformed rows, ``--io-retries`` retries
   transient read errors, and the ``IngestReport`` summary is printed).
2. **Compiled decisions**: one ``cluster_sim.policy_decisions`` pass (a
   static 30 % pool) emits the ``PolicyDecisions`` arrays; the stream's
   ``decide`` callback slices them a chunk (``PolicyDecisions.slice``).
3. **The file-fed stream**: a second chunked pass feeds
   ``replay_engine.CompiledReplayStream``, whose sweep prices 8 probes with
   one launch of the event sweep (K1) a shard on the device, the state
   carried from shard to shard.  ``--checkpoint PATH`` runs one resumable
   sweep first (``--kill-after N`` stops it after N shards, ``--resume``
   finishes it from the snapshot, bit for bit).
4. **The K-seed stream batch**: ``CompiledReplayStreamBatch`` prices 8
   trace seeds in one launch of K1's trace axis a shard, against looping
   the stream a seed at the same shard budget (bit for bit, and timed).

5. **The device split**: the same K-seed stream batch with
   ``reject_rates(devices="all")``: its trace rows split over every
   visible card, each card streaming its rows with their own state,
   ``==`` the one-card sweep and timed beside it.  On one card ``"all"``
   resolves to the single-device path, and the stage says so.

Without ``--trace-file`` a stand-in dump in the fetch script's schema
(``scripts/fetch_azure_trace.py``: integral cores and GB, arrival-sorted
CSV.gz) is written to a temporary directory by ``traces.save_trace_csv``.
The default is the benchmark's quick size (40,000 VMs, 16 servers, 4,096
events a shard); ``--full`` is the stand-in of its ``--full`` run (250,000
VMs over 30 days, 65,536 events a shard) on a cluster row of 256 servers
(16-socket pools), where the benchmark's 16 servers would reject nearly
every VM.
"""
import argparse
import os
import shutil
import tempfile
import time

import numpy as np

from repro_torch.core import cluster_sim, replay_engine, sweep_core, traces
from repro_torch.device import resolve_device

BENCH_K = 8          # seed count of the stream-batch stage
DUMP_VMS = 40_000    # stand-in dump size (quick)
FULL_VMS = 250_000   # stand-in dump size (--full)
BUDGET = 1024        # events a shard in the stream-batch stage


def synth_dump(path: str, n_vms: int = DUMP_VMS,
               horizon_days: int = 30, seed: int = 7) -> None:
    """Write an arrival-sorted CSV.gz stand-in for a fetch-script dump
    (the same canonical schema: integral cores/GBs, arrival-sorted, what
    ``iter_trace_chunks`` requires); the same generator draws as
    ``benchmarks/azure_e2e.py::synth_dump``, so the same file."""
    rng = np.random.default_rng(seed)
    arrival = np.sort(rng.uniform(0, horizon_days * 86400,
                                  n_vms)).round(3)
    life = rng.integers(1800, 86400, n_vms).astype(float)
    cores = rng.choice([2, 4, 8], n_vms, p=[.5, .3, .2])
    mem = cores * rng.choice([2, 4], n_vms)
    pmu = np.zeros(traces.N_PMU_FEATURES, np.float32)
    vms = [traces.VM(i, int(i % 199), 0, 0, 0, int(cores[i]),
                     float(mem[i]), float(arrival[i]), float(life[i]),
                     0.5, 0.0, 0.0, pmu) for i in range(n_vms)]
    traces.save_trace_csv(vms, path)


def probes(cfg, n_cand: int = 8):
    """The benchmark's probe lanes: server sizes 0.4 ... 1 of 6 GB a core,
    pools 0 ... 2x that."""
    hi = cfg.cores_per_server * 6.0
    return (np.linspace(hi * 0.4, hi, n_cand),
            np.linspace(0.0, 2.0 * hi, n_cand))


def e2e_dump_bench(path: str, cfg, budget: int, chunk_vms: int = 8192,
                   max_bad_rows: int = 0, io_retries: int = 0,
                   checkpoint=None, device=None) -> dict:
    """Dump -> chunked ingest -> decisions -> file-fed stream -> sweep."""
    hardened = max_bad_rows > 0 or io_retries > 0
    report = (traces.IngestReport(max_bad_rows=max_bad_rows)
              if hardened else None)
    t0 = time.perf_counter()
    vms = [v for chunk in traces.iter_trace_chunks(
        path, chunk_vms=chunk_vms, io_retries=io_retries, report=report)
        for v in chunk]
    t_ingest = time.perf_counter() - t0
    t1 = time.perf_counter()
    dec, _ = cluster_sim.policy_decisions(vms, "static",
                                          static_pool_frac=0.30,
                                          as_arrays=True)
    t_dec = time.perf_counter() - t1
    del vms
    # the second chunked pass feeds the stream; decide slices the
    # precomputed arrays at the running row offset
    off = [0]

    def decide(chunk):
        lo = off[0]
        off[0] += len(chunk)
        return dec.slice(lo, off[0])

    t2 = time.perf_counter()
    replay_report = (traces.IngestReport(max_bad_rows=max_bad_rows)
                     if hardened else None)
    stream = replay_engine.CompiledReplayStream(
        traces.iter_trace_chunks(path, chunk_vms=chunk_vms,
                                 io_retries=io_retries,
                                 report=replay_report),
        None, cfg, max_events_per_shard=budget, decide=decide,
        device=device)
    t_compile = time.perf_counter() - t2
    probe_s, probe_p = probes(cfg)
    ckpt_info = None
    if checkpoint is not None:
        rates = stream.reject_rates(probe_s, probe_p, checkpoint=checkpoint)
        ckpt_info = {"path": checkpoint.path,
                     "resumed": bool(checkpoint.resume),
                     "every_shards": int(checkpoint.every_shards),
                     "rates": rates.tolist()}
    stream.reject_rates(probe_s, probe_p)            # warm the path
    t3 = time.perf_counter()
    rates = stream.reject_rates(probe_s, probe_p)
    t_sweep = time.perf_counter() - t3
    wall = time.perf_counter() - t0
    if report is not None:
        # one ledger a pass (both passes see the same rows): the ingest
        # pass's, with both passes' IO retries
        report.io_retries += replay_report.io_retries
    return {
        "ingest_report": report.summary() if report is not None else None,
        "checkpoint": ckpt_info,
        "n_vms": int(stream.n_vms),
        "n_events": int(stream.n_events),
        "n_shards": int(stream.n_shards),
        "max_events_per_shard": int(budget),
        "peak_shard_bytes": int(stream.peak_shard_bytes),
        "ingest_s": t_ingest,
        "ingest_vms_per_sec": stream.n_vms / max(t_ingest, 1e-9),
        "decisions_s": t_dec,
        "compile_s": t_compile,
        "sweep_ms": t_sweep * 1e3,
        "events_per_sec": stream.n_events * len(probe_s)
        / max(t_sweep, 1e-9),
        "e2e_wall_s": wall,
        "vms_per_sec": stream.n_vms / max(wall, 1e-9),
        "rates": rates.tolist(),
    }


def stream_batch_bench(vms_list, cfg, budget: int = BUDGET,
                       static_pool_frac: float = 0.30, n_cand: int = 2,
                       device=None) -> dict:
    """K streams priced as one batch (one launch a shard for all K) against
    looping the streams a seed, at the same shard budget; the narrow probe
    batch the searches spend their rounds on."""
    streams = [replay_engine.CompiledReplayStream(
        v, cluster_sim.policy_decisions(
            v, "static", static_pool_frac=static_pool_frac)[0],
        cfg, max_events_per_shard=budget, device=device) for v in vms_list]
    batch = replay_engine.CompiledReplayStreamBatch(streams)
    probe_s = np.linspace(150.0, 700.0, n_cand)
    probe_p = np.linspace(0.0, 2000.0, n_cand)
    batch.reject_rates(probe_s, probe_p)             # warm the paths
    for s in streams:
        s.reject_rates(probe_s, probe_p)
    t_b, t_l = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        rb = batch.reject_rates(probe_s, probe_p)
        t_b.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        rl = np.stack([s.reject_rates(probe_s, probe_p) for s in streams])
        t_l.append(time.perf_counter() - t0)
    return {
        "k": batch.k,
        "n_shards": int(batch.n_shards),
        "max_events_per_shard": int(budget),
        "peak_shard_bytes": int(batch.peak_shard_bytes),
        "n_cand": n_cand,
        "batched_ms": min(t_b) * 1e3,
        "stream_loop_ms": min(t_l) * 1e3,
        "speedup": min(t_l) / min(t_b),
        "bit_exact": rb.tolist() == rl.tolist(),
        "events_per_sec": int(batch.n_events.sum()) * n_cand / min(t_b),
    }


def device_shard_bench(vms_list, cfg, budget: int = BUDGET,
                       static_pool_frac: float = 0.30, n_cand: int = 2,
                       device=None) -> dict:
    """The K-seed stream batch split over every visible device
    (``devices="all"``) against the same sweep on one device: ``==`` the
    one-device rates, both timed (best of 5, host clock around the sweep
    and its read-back).  Where ``"all"`` resolves to one device (one card,
    or a CPU batch) the split is the single-device path: both are still
    run and compared, and ``n_devices`` is 1."""
    streams = [replay_engine.CompiledReplayStream(
        v, cluster_sim.policy_decisions(
            v, "static", static_pool_frac=static_pool_frac)[0],
        cfg, max_events_per_shard=budget, device=device) for v in vms_list]
    batch = replay_engine.CompiledReplayStreamBatch(streams)
    devs = sweep_core.resolve_devices("all", batch.device)
    probe_s = np.linspace(150.0, 700.0, n_cand)
    probe_p = np.linspace(0.0, 2000.0, n_cand)
    kw = dict(skip_windows=False)       # time the full scan, not skips
    r_one = batch.reject_rates(probe_s, probe_p, **kw)     # warm both
    r_dev = batch.reject_rates(probe_s, probe_p, devices="all", **kw)
    t_one, t_dev = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        batch.reject_rates(probe_s, probe_p, **kw)
        t_one.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        batch.reject_rates(probe_s, probe_p, devices="all", **kw)
        t_dev.append(time.perf_counter() - t0)
    return {
        "n_devices": 1 if devs is None else len(devs),
        "k": batch.k,
        "n_shards": int(batch.n_shards),
        "single_ms": min(t_one) * 1e3,
        "device_ms": min(t_dev) * 1e3,
        "speedup_vs_single": min(t_one) / min(t_dev),
        "bit_exact": r_dev.tolist() == r_one.tolist(),
    }


def claim(name, ok, detail):
    print(f"  [{'PASS' if ok else 'FAIL'}] {name}: {detail}")
    return bool(ok)


def run(full: bool = False, trace_file: str | None = None,
        n_vms: int | None = None, max_bad_rows: int = 0,
        io_retries: int = 0, checkpoint=None, device=None) -> dict:
    resolve_device(device)
    print("== Azure e2e on the port: chunked ingest + streaming replay ==")
    cfg = cluster_sim.ClusterConfig(n_servers=256 if full else 16,
                                    pool_sockets=16, gb_per_core=4.75)
    n_dump = n_vms or (FULL_VMS if full else DUMP_VMS)
    budget = 65_536 if full else 4096
    tmp = None
    try:
        if trace_file is None:
            tmp = tempfile.mkdtemp(prefix="torch_azure_e2e_")
            path = os.path.join(tmp, "azure_standin.csv.gz")
            synth_dump(path, n_vms=n_dump)
            label = f"stand-in dump ({n_dump} VMs)"
        else:
            path, label = trace_file, trace_file
        try:
            e2e = e2e_dump_bench(path, cfg, budget,
                                 max_bad_rows=max_bad_rows,
                                 io_retries=io_retries,
                                 checkpoint=checkpoint, device=device)
        except replay_engine.SweepInterrupted as e:
            print(f"  sweep interrupted after {e.shards_done} shard sweeps; "
                  f"checkpoint at {e.path}: rerun with --resume to finish "
                  "bit for bit")
            raise
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    if e2e["ingest_report"] is not None:
        r = e2e["ingest_report"]
        print(f"  hardened ingest: {r['n_quarantined']} rows quarantined, "
              f"{r['io_retries']} IO retries")
    if e2e["checkpoint"] is not None:
        c = e2e["checkpoint"]
        print(f"  checkpointed sweep "
              f"({'resumed' if c['resumed'] else 'fresh'}) -> "
              f"{len(c['rates'])} candidate rates via {c['path']}")
    print(f"  [{label}] {cfg.n_servers} servers: ingest {e2e['n_vms']} VMs "
          f"in {e2e['ingest_s']:.3f} s ({e2e['ingest_vms_per_sec']:.0f} "
          f"VMs/s), {e2e['n_events']} events -> {e2e['n_shards']} shards "
          f"({e2e['peak_shard_bytes'] / 2 ** 10:.0f} KiB a shard), sweep "
          f"{e2e['sweep_ms']:.2f} ms ({e2e['events_per_sec']:.0f} "
          f"candidate-events/s), e2e {e2e['vms_per_sec']:.0f} VMs/s")
    print(f"  rates: {e2e['rates']}")

    horizon = 5 * 86400
    pop = traces.Population(seed=0)
    cfg16 = cluster_sim.ClusterConfig(n_servers=16, pool_sockets=16,
                                      gb_per_core=4.75)
    n = cluster_sim.arrivals_for_util(cfg16, 0.8, horizon)
    vms_list = [pop.sample_vms(n, horizon, seed=2 + i, start_id=10 ** 6)
                for i in range(BENCH_K)]
    sb = stream_batch_bench(vms_list, cfg16, device=device)
    print(f"  stream batch K={sb['k']}: {sb['batched_ms']:.2f} ms vs stream "
          f"loop {sb['stream_loop_ms']:.2f} ms -> {sb['speedup']:.2f}x over "
          f"{sb['n_shards']} shards at the same "
          f"{sb['max_events_per_shard']}-event budget "
          f"({sb['events_per_sec']:.0f} candidate-events/s)")
    ds = device_shard_bench(vms_list, cfg16, device=device)
    where = (f"split over {ds['n_devices']} devices" if ds["n_devices"] > 1
             else 'devices="all" resolved to the single-device path '
                  "(one device visible)")
    print(f"  device split K={ds['k']} ({where}): {ds['device_ms']:.2f} ms "
          f"vs one device {ds['single_ms']:.2f} ms -> "
          f"{ds['speedup_vs_single']:.2f}x over {ds['n_shards']} shards, "
          f"{'==' if ds['bit_exact'] else '!='} the one-device rates")
    res = {"trace": label, "e2e": e2e, "stream_batch": sb,
           "device_shard": ds}
    res["claims"] = [
        claim("chunked e2e replay stays within the shard budget",
              e2e["peak_shard_bytes"] <= 6 * 4 * e2e["max_events_per_shard"],
              f"{e2e['peak_shard_bytes']} B at a "
              f"{e2e['max_events_per_shard']}-event budget"),
        claim("K-seed batched streaming bit-exact vs stream loop",
              sb["bit_exact"] and sb["n_shards"] > 1,
              f"{sb['k']} seeds x {sb['n_shards']} shards"),
        claim("K-seed batched streaming >=2x vs stream loop",
              sb["speedup"] >= 2.0, f"{sb['speedup']:.2f}x"),
        claim("device-split stream batch bit-exact vs one device",
              ds["bit_exact"], f"{ds['n_devices']} device(s)")]
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' to run on the CPU")
    ap.add_argument("--trace-file", default=None,
                    help="a fetch_azure_trace.py dump (CSV/CSV.gz); "
                         "default: write a stand-in")
    ap.add_argument("--full", action="store_true",
                    help="250,000 VMs on 256 servers, 65,536 events a shard")
    ap.add_argument("--vms", type=int, default=None,
                    help="stand-in dump size (default 40,000; --full "
                         "250,000)")
    ap.add_argument("--max-bad-rows", type=int, default=0,
                    help="quarantine up to N malformed rows an ingest pass "
                         "instead of aborting (default strict)")
    ap.add_argument("--io-retries", type=int, default=0,
                    help="retry transient IO errors up to N consecutive "
                         "times with exponential backoff")
    ap.add_argument("--checkpoint", default=None, metavar="PATH",
                    help="snapshot the probe sweep to PATH every "
                         "--checkpoint-every shard sweeps")
    ap.add_argument("--checkpoint-every", type=int, default=8)
    ap.add_argument("--resume", action="store_true",
                    help="resume the probe sweep from --checkpoint (bit for "
                         "bit an uninterrupted run)")
    ap.add_argument("--kill-after", type=int, default=None, metavar="SHARDS",
                    help="stop the checkpointed sweep after N shard sweeps "
                         "(exercises --resume)")
    args = ap.parse_args(argv)
    ckpt = None
    if args.checkpoint is not None:
        ckpt = replay_engine.CheckpointSpec(
            args.checkpoint, every_shards=args.checkpoint_every,
            resume=args.resume, kill_after_shards=args.kill_after)
    elif args.resume or args.kill_after is not None:
        ap.error("--resume/--kill-after need --checkpoint PATH")
    return run(full=args.full, trace_file=args.trace_file, n_vms=args.vms,
               max_bad_rows=args.max_bad_rows, io_retries=args.io_retries,
               checkpoint=ckpt, device=args.device)


if __name__ == "__main__":
    main()
