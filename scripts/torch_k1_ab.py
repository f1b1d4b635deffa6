#!/usr/bin/env python3
"""K1 (the event sweep) or K6 (the zNUMA spill sweep) of checkouts of
this repo, timed on one card in turns.

    python3 scripts/torch_k1_ab.py --other DIR [DIR ...] [--kernel k1|k6]
                                   [--lanes 16] [--reps 5]

Makes the kernel's inputs once with this checkout's port and saves them
under ``build/k1_ab/``.  Then each checkout, in a process of its own and
with its own build of the kernel's source, times the kernel over those
inputs, ``--reps`` runs by CUDA events, in the order DIR..., this, this,
...DIR (the others reversed).  Prints one JSON line a run, then the
card's name and power limit and a summary line (each timing's runs and
best a checkout, and whether every run's results agree).

``--kernel k1`` (the default): the full-width provisioning trace (256
servers x 64 cores, 16-socket pools, 7 days at 0.8 core utilisation,
trace seed 2: the trace of ``chip_smoke.py``'s ``provision_full``),
its static-0.30 decision set compiled to K1's event arrays; K1 over those
events at ``--lanes`` lanes (the 16-lane frontier of ``chip_smoke.py``),
int16 and int32, on fresh state; a checkout whose ``ops.event_sweep``
takes ``trace_events`` also times the trace three times over as one
batch of 3 x 28 lanes (the pool search's width).  Every checkout must
take ``ops.event_sweep(*events, group_of, fc, um, up, slots, sgb, pgb)``;
the results compared are the reject counts.

``--kernel k6``: Fig 16's full-width paged-KV streams (``chip_smoke.py``'s
``SPILL_FULL``: the reference's ``benchmarks/fig16_spill.py`` generator at
qwen2-1.5b's paged pool, 16,384 requests a stream, seeds 3-6, a peak of
1,280 pages); the device work of one sweep at 80 lanes (local tiers 16,
32, ..., 1,280 pages, a 1,024-page pool) and 1,280 lanes (local tiers 1
... 1,280), after one warm-up.  The device work is what the wrapper
enqueues after its checks: for a checkout with the linked kernel
(``ops.sweep_on_card``) the links pass and the kernel with its final map,
for the first kernel (no such function) its one launch.  The results
compared are the counters and the tier map's SHA-1.  ``--lanes`` is not
used.
"""
import argparse
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "build", "k1_ab", "events.npz")
STREAMS = os.path.join(ROOT, "build", "k1_ab", "streams.npz")
SEEDS, N_REQUESTS, PEAK_PAGES, NUM_POOL = (3, 4, 5, 6), 16384, 1280, 1024

# run in each checkout: argv = (checkout, data, lanes, reps)
_K1_TIMER = r"""
import inspect, json, sys
import numpy as np, torch
root, data, lanes, reps = sys.argv[1], sys.argv[2], int(sys.argv[3]), \
    int(sys.argv[4])
sys.path.insert(0, root + "/src")
from repro_torch.core import sweep_core
from repro_torch.kernels.event_sweep import kernel as K, ops
assert K.__file__.startswith(root), K.__file__
d = np.load(data)
dev = torch.device("cuda")
evs = tuple(torch.from_numpy(d[k]).to(dev) for k in
            ("kind", "slot", "cores", "local", "pool", "mem"))
group_of = torch.from_numpy(d["group_of"]).to(dev)
n_srv, n_grp, n_slots = (int(d[k]) for k in ("servers", "groups", "slots"))
batched = "trace_events" in inspect.signature(ops.event_sweep).parameters
if batched:
    evs3, counts3 = ops.pack_traces([evs] * 3, dev)


def time_it(width, fn, np_dt, reps):
    sgb, pgb = sweep_core.quantize_capacities(
        np.linspace(150.0, 700.0, width), np.linspace(0.0, 2000.0, width))
    def state():
        st = sweep_core.init_state(width, n_srv, 64.0, n_srv, n_grp,
                                   n_slots, np_dt)[:4]
        return [torch.from_numpy(a).to(dev) for a in st] + [
            torch.from_numpy(a.astype(np_dt)).to(dev) for a in (sgb, pgb)]
    states = [state() for _ in range(reps + 1)]
    rej = fn(states[0])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for st in states[1:]:
        fn(st)
    end.record()
    torch.cuda.synchronize()
    return dict(ms=start.elapsed_time(end) / reps, rejects=int(rej.sum()))


out = {}
for dt in ("int16", "int32"):
    np_dt = sweep_core.state_np_dtype(dt)
    out[dt] = time_it(lanes, lambda st: ops.event_sweep(*evs, group_of, *st),
                      np_dt, reps)
    if batched:
        out[dt + "_batch3x28"] = time_it(
            84, lambda st: ops.event_sweep(*evs3, group_of, *st,
                                           trace_events=counts3),
            np_dt, reps)
print(json.dumps(dict(checkout=root, lanes=lanes, reps=reps, **out)))
"""


# run in each checkout: argv = (checkout, data, lanes, reps)
_K6_TIMER = r"""
import hashlib, json, sys
import numpy as np, torch
root, data, reps = sys.argv[1], sys.argv[2], int(sys.argv[4])
sys.path.insert(0, root + "/src")
from repro_torch.kernels.spill_sweep import kernel as K, ops
assert K.__file__.startswith(root), K.__file__
d = np.load(data)
dev = torch.device("cuda")
kd = torch.from_numpy(d["kinds"]).to(dev)
ky = torch.from_numpy(d["keys"]).to(dev)
n_keys, num_pool = int(d["n_keys"]), int(d["num_pool"])
sms = torch.cuda.get_device_properties(dev).multi_processor_count
linked = hasattr(ops, "sweep_on_card")


def time_it(lanes):
    nl = torch.from_numpy(lanes).to(dev)
    npl = torch.full_like(nl, num_pool)
    tier = torch.empty((kd.shape[0], n_keys, len(lanes)), dtype=torch.int8,
                       device=dev)
    if linked:
        def run():
            return ops.sweep_on_card(kd, ky, nl, npl, tier)
    else:
        out = torch.empty((5, kd.shape[0], len(lanes)), dtype=torch.int32,
                          device=dev)
        plan = K.plan(len(lanes), kd.shape[0], sms)

        def run():
            K.spill_sweep_kernel(kd, ky, nl, npl, tier, out, plan=plan)
            return tuple(out)
    got = run()
    torch.cuda.synchronize()
    counters = [int(g.sum()) for g in got]
    tier_sha1 = hashlib.sha1(tier.cpu().numpy().tobytes()).hexdigest()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # ~50 ms of waiting on the card first: the host enqueues every run
    # before the first starts, so the events time the device's work alone
    torch.cuda._sleep(10 ** 8)
    start.record()
    for _ in range(reps):
        run()
    end.record()
    torch.cuda.synchronize()
    return dict(ms=start.elapsed_time(end) / reps, counters=counters,
                tier_sha1=tier_sha1)


out = {name: time_it(lanes) for name, lanes in (
    ("lanes80", np.arange(16, 1281, 16, dtype=np.int32)),
    ("lanes1280", np.arange(1, 1281, dtype=np.int32)))}
print(json.dumps(dict(checkout=root, linked=linked, reps=reps, **out)))
"""


def _save_events():
    """The trace's K1 event arrays, from this checkout's port."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core import cluster_sim, replay_engine, traces
    cfg = cluster_sim.ClusterConfig(n_servers=256, pool_sockets=16,
                                    gb_per_core=4.75)
    horizon = 7 * 86400
    n = cluster_sim.arrivals_for_util(cfg, 0.8, horizon)
    vms = traces.Population(seed=0).sample_vms(n, horizon, seed=2,
                                               start_id=10 ** 6)
    dec, _ = cluster_sim.policy_decisions(vms, "static",
                                          static_pool_frac=0.30,
                                          as_arrays=True)
    eng = replay_engine.CompiledReplay(vms, dec, cfg, device="cpu")
    host, n_slots = eng._host_events()
    os.makedirs(os.path.dirname(DATA), exist_ok=True)
    np.savez(DATA, **dict(zip(("kind", "slot", "cores", "local", "pool",
                               "mem"), host)),
             group_of=eng.group_of.astype(np.int32), servers=cfg.n_servers,
             groups=cfg.n_groups, slots=n_slots)
    return len(host[0])


def _save_streams():
    """Fig 16's full-width streams, padded with PAD to a multiple of 4
    events (the first kernel's staging; the linked one pads the same)."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels.spill_sweep import cases
    from repro_torch.kernels.spill_sweep.ref import PAD
    kinds, keys, _, _ = cases.kv_event_batch(SEEDS, N_REQUESTS, PEAK_PAGES)
    pad = ((0, 0), (0, -kinds.shape[1] % 4))
    os.makedirs(os.path.dirname(STREAMS), exist_ok=True)
    np.savez(STREAMS, kinds=np.pad(kinds, pad, constant_values=PAD),
             keys=np.pad(keys, pad), n_keys=int(keys.max()) + 1,
             num_pool=NUM_POOL)
    return kinds.shape


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--other", required=True, nargs="+",
                    help="other checkouts of this repo")
    ap.add_argument("--kernel", choices=("k1", "k6"), default="k1")
    ap.add_argument("--lanes", type=int, default=16)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    others = [os.path.abspath(o) for o in args.other]
    if args.kernel == "k1":
        timer, data = _K1_TIMER, DATA
        summary = {"kernel": "k1", "events": _save_events(),
                   "lanes": args.lanes}
    else:
        timer, data = _K6_TIMER, STREAMS
        n_streams, n_events = _save_streams()
        summary = {"kernel": "k6", "streams": n_streams, "events": n_events}
    runs = []
    for root in (*others, ROOT, ROOT, *others[::-1]):
        proc = subprocess.run(
            [sys.executable, "-c", timer, root, data, str(args.lanes),
             str(args.reps)], capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            proc.check_returncode()
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append(json.loads(line))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0])
    # a timing is a dict with "ms"; the rest of it is the result that every
    # run must agree on
    same = True
    for key in sorted({k for r in runs for k, v in r.items()
                       if isinstance(v, dict) and "ms" in v}):
        by = {}
        for r in runs:
            if key in r:
                by.setdefault(r["checkout"], []).append(r[key]["ms"])
        summary[key] = {os.path.relpath(c, ROOT): dict(ms=v, best=min(v))
                        for c, v in by.items()}
        same &= len({json.dumps({k: v for k, v in r[key].items()
                                 if k != "ms"}, sort_keys=True)
                     for r in runs if key in r}) == 1
    summary["same_results"] = same
    print(json.dumps(summary))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
