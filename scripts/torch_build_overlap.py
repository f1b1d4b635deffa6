#!/usr/bin/env python3
"""What kernel builds in flight cost the decode times taken beside them.

    PYTHONPATH=src python scripts/torch_build_overlap.py

``chip_smoke.py`` starts every kernel's ``nvcc`` together, waits for K2
and K3 (the kernels of the model phases) and lets K1, K4, K5 and K6
compile while the model phases run.  Those phases time their decode steps
by the host's clock, and the decodes are host-bound (eager launches).
This script times the same kind of decode step in one process on the
card, with the builds running and without: whisper-small and
granite-moe-1b-a400m at full width in bf16 (seeded weights, the shapes of
``configs/one_card.py``), in windows of ``WINDOW`` greedy steps taken by
the two models in turn.  First ``QUIET`` windows each with no build
running; then windows while fresh builds of K1, K4, K5 and K6 run (all
four started together, into a scratch directory under ``build/`` that is
removed after); then ``QUIET`` windows each again.  A window during
which a build ended is dropped.

Prints one JSON object: by model, the ms a step (median, mean, steps) with
no build running and with 1-4 builds running, and the ratio of the medians
busy / quiet; each build's own wall seconds; the card's name and power
limit.  Needs a CUDA device.
"""
from __future__ import annotations

import json
import shutil
import statistics
import sys
import tempfile
import time
from pathlib import Path

import torch

from repro_torch.configs.one_card import (ENCDEC_RUNS, RUNS, one_card_config,
                                          prompt_inputs)
from repro_torch.device import nvidia_smi_line, resolve_device
from repro_torch.kernels import build
from repro_torch.kernels.event_sweep import kernel as K1
from repro_torch.kernels.fail_sweep import kernel as K5
from repro_torch.kernels.pod_sweep import kernel as K4
from repro_torch.kernels.spill_sweep import kernel as K6
from repro_torch.models.model_zoo import build_model
from repro_torch.runtime.serve import make_decode_step, make_prefill_step
from repro_torch.sharding.rules import ShardCtx

WINDOW = 16      # greedy decode steps a window
QUIET = 8        # windows of each model before the builds, and after them
MODELS = {"whisper-small": ENCDEC_RUNS["whisper-small"],
          "granite-moe-1b-a400m": RUNS["granite-moe-1b-a400m"]}


def decode_windows(arch: str, run: dict, dev):
    """The model's prefill over ``run``'s seeded inputs, then a function
    that takes ``WINDOW`` greedy steps from the prompt's end and returns
    each step's host ms (its logits read back, so the card is waited
    for).  Every window writes the same cache slots."""
    cfg = one_card_config(arch)
    model = build_model(cfg, device=dev)
    model.init_params(torch.Generator(device=dev).manual_seed(0))
    inp = prompt_inputs(cfg, run, dev)
    b = inp["tokens"].shape[0]
    cache = model.init_cache(b, inp["start"] + WINDOW, **inp["cache_kw"])
    ctx = ShardCtx(attn_impl="flash")
    logits, cache = make_prefill_step(model, ctx)(
        inp["tokens"], inp["positions"], cache, embeds=inp["embeds"])
    decode = make_decode_step(model, ctx)
    first = torch.argmax(logits[:, -1], dim=-1)

    def window() -> list[float]:
        tok, ms = first, []
        for i in range(WINDOW):
            t0 = time.perf_counter()
            pos = torch.full((b,), inp["start"] + i, dtype=torch.int64,
                             device=dev)
            logits, _ = decode(tok[:, None], pos, cache)
            tok = torch.argmax(logits[:, 0], dim=-1)
            tok.tolist()                             # waits for the device
            ms.append((time.perf_counter() - t0) * 1e3)
        return ms
    return window


def summary(ms: list[float]) -> dict:
    return dict(median=statistics.median(ms), mean=statistics.fmean(ms),
                steps=len(ms))


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_build_overlap: no CUDA device is visible",
              file=sys.stderr)
        return 1
    dev = resolve_device(None)
    windows = {arch: decode_windows(arch, run, dev)
               for arch, run in MODELS.items()}
    quiet = {arch: [] for arch in windows}
    busy = {arch: {} for arch in windows}
    for w in windows.values():
        w()                                          # warm up
    for _ in range(QUIET):
        for arch, w in windows.items():
            quiet[arch] += w()
    scratch = Path(tempfile.mkdtemp(prefix="overlap-",
                                    dir=build.BUILD_DIR.parent))
    try:
        nvcc = build.find_nvcc()
        t0 = time.perf_counter()
        builds = [build.Nvcc(nvcc, K.NAME, scratch / f"lib{K.NAME}.so")
                  for K in (K1, K6, K5, K4)]

        def running() -> int:
            return sum(b.proc.poll() is None for b in builds)
        while running():
            for arch, w in windows.items():
                n = running()
                ms = w()
                if n and running() == n:
                    busy[arch].setdefault(n, []).extend(ms)
        nvcc_seconds = build.finish_builds(builds)
        builds_wall_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    for _ in range(QUIET):
        for arch, w in windows.items():
            quiet[arch] += w()
    out = {}
    for arch in windows:
        q = summary(quiet[arch])
        every = [m for ms in busy[arch].values() for m in ms]
        out[arch] = dict(
            run=MODELS[arch], quiet=q,
            busy_by_builds_running={n: summary(ms) for n, ms
                                    in sorted(busy[arch].items())},
            busy_any=summary(every) if every else None,
            busy_over_quiet_median=statistics.median(every) / q["median"]
            if every else None)
    print(json.dumps(dict(nvidia_smi=nvidia_smi_line(),
                          window_steps=WINDOW, models=out,
                          nvcc_seconds=nvcc_seconds,
                          builds_wall_s=builds_wall_s)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
