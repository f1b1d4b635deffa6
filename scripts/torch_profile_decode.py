#!/usr/bin/env python3
"""Where a decode step of the PyTorch/CUDA port spends its time.

    PYTHONPATH=src python scripts/torch_profile_decode.py

Builds the engine of ``repro_torch.launch.serve`` for qwen2-1.5b at full
width in bf16 on the card with a full batch, lets it reach a steady state,
then traces a window of decode steps with ``torch.profiler`` and prints
one JSON object: wall time per step with and without the tracer, the
device's busy time per step (sum of kernel time), its idle share of an
untraced step, the number of kernels a step launches, and the kernels
that take the most device time.  Needs a CUDA device; nothing moves to
the CPU.
"""
from __future__ import annotations

import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.device import nvidia_smi_line
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.launch import serve

STEPS = 20       # decode steps in each timed window
WARMUP = 10      # steps before the first window
BATCH = 8        # rows that decode together, all admitted at once
TOP = 12         # kernels listed, by device time
NEW_TOKENS = 2 * STEPS + WARMUP + 8      # no row finishes inside a window
SERVE_ARGS = ["--arch", "qwen2-1.5b", "--full", "--dtype", "bfloat16",
              "--requests", str(BATCH), "--max-batch", str(BATCH),
              "--page-size", "16", "--local-pages", "256",
              "--pool-pages", "1024", "--prompt-len", "128", "1025",
              "--new-tokens", str(NEW_TOKENS), str(NEW_TOKENS + 1),
              "--seed", "0"]


def main():
    eng, _ = serve.build_engine(SERVE_ARGS)
    for _ in range(WARMUP):
        eng.step()
    torch.cuda.synchronize()

    # the step time without the tracer's cost, on the same steady batch
    t0 = time.perf_counter()
    for _ in range(STEPS):
        assert eng.step() == BATCH
    torch.cuda.synchronize()
    untraced = time.perf_counter() - t0

    pa_ops.launches = 0
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        for _ in range(STEPS):
            assert eng.step() == BATCH
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    rows = [(e.key, e.count, e.self_device_time_total)
            for e in prof.key_averages() if e.self_device_time_total > 0
            and e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(r[2] for r in rows)
    n_kernels = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[2])
    print(json.dumps({
        "card": nvidia_smi_line(), "arch": eng.model.cfg.name,
        "dtype": "bfloat16", "batch": BATCH, "steps": STEPS,
        "seq_lens": sorted(eng.kv.lens.values()),
        "wall_ms_per_step_untraced": untraced / STEPS * 1e3,
        "wall_ms_per_step_traced": wall / STEPS * 1e3,
        "device_busy_ms_per_step": busy_us / STEPS / 1e3,
        "device_idle_share_of_untraced_step":
            (1 - busy_us / 1e6 / untraced) if busy_us else None,
        "device_time_seen": bool(busy_us),
        "kernels_per_step": n_kernels / STEPS,
        "paged_attention_launches_per_step": pa_ops.launches / STEPS,
        "top_kernels": [
            {"name": k[:90], "per_step": c / STEPS,
             "device_ms_per_step": us / STEPS / 1e3,
             "share_of_busy": us / busy_us} for k, c, us in rows[:TOP]],
    }, indent=1))


if __name__ == "__main__":
    main()
