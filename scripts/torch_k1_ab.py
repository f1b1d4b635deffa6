#!/usr/bin/env python3
"""K1 (the event sweep) of checkouts of this repo, timed on one card in
turns.

    python3 scripts/torch_k1_ab.py --other DIR [DIR ...] [--lanes 16] [--reps 5]

Samples the full-width provisioning trace (256 servers x 64 cores,
16-socket pools, 7 days at 0.8 core utilisation, trace seed 2: the trace
of ``chip_smoke.py``'s ``provision_full``), compiles its static-0.30
decision set to K1's event arrays with this checkout's port and saves
them under ``build/k1_ab/``.  Then each checkout, in a process of its own
and with its own build of ``csrc/event_sweep.cu``, times K1 over those
events at ``--lanes`` lanes (the 16-lane frontier of ``chip_smoke.py``),
int16 and int32, ``--reps`` sweeps on fresh state by CUDA events, in the
order DIR..., this, this, ...DIR (the others reversed); a checkout whose
``ops.event_sweep`` takes ``trace_events`` also times the trace three
times over as one batch of 3 x 28 lanes (the pool search's width).
Prints one JSON line a run, then the card's name and power limit and a
summary line.  Every checkout must take
``ops.event_sweep(*events, group_of, fc, um, up, slots, sgb, pgb)``.
"""
import argparse
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "build", "k1_ab", "events.npz")

# run in each checkout: argv = (checkout, data, lanes, reps)
_TIMER = r"""
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--other", required=True, nargs="+",
                    help="other checkouts of this repo")
    ap.add_argument("--lanes", type=int, default=16)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    others = [os.path.abspath(o) for o in args.other]
    n_events = _save_events()
    runs = []
    for root in (*others, ROOT, ROOT, *others[::-1]):
        proc = subprocess.run(
            [sys.executable, "-c", _TIMER, root, DATA, str(args.lanes),
             str(args.reps)], capture_output=True, text=True, check=True,
            timeout=900)
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append(json.loads(line))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0])
    summary = {"events": n_events, "lanes": args.lanes}
    same = True
    for key in sorted({k for r in runs for k in r if k.startswith("int")}):
        by = {}
        for r in runs:
            if key in r:
                by.setdefault(r["checkout"], []).append(r[key]["ms"])
        summary[key] = {os.path.relpath(c, ROOT): dict(ms=v, best=min(v))
                        for c, v in by.items()}
        same &= len({r[key]["rejects"] for r in runs if key in r}) == 1
    summary["same_rejects"] = same
    print(json.dumps(summary))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
