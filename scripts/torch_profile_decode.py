#!/usr/bin/env python3
"""Where a serving step of the PyTorch/CUDA port spends its time.

    PYTHONPATH=src python scripts/torch_profile_decode.py [paged] [ring]
        [families] [encdec]

Four paths (the first two when none is named), one JSON object each:

* ``paged``: the engine of ``repro_torch.launch.serve`` for qwen2-1.5b at
  full width in bf16 with a full batch, traced over a window of decode
  steps once it has reached a steady state;
* ``ring``: the ring-cache steps of ``repro_torch.runtime.serve`` for
  h2o-danube-1.8b at full width in bf16, two 8192-token prompts: one
  prefill (flash attention) traced on its own, then a window of decode
  steps past the ring's wrap;
* ``families``: the same for each decoder-only family at the bf16 shapes
  and depth cuts of ``repro_torch/configs/one_card.py`` (``RUNS``,
  ``one_card_config``): granite-moe, mamba2, qwen2-7b, qwen3-32b, jamba's
  and deepseek-v3's cuts;
* ``encdec``: the same for whisper-small (the prefill encodes the frames,
  stores the cross K/V and fills the decoder's prompt) and internvl2-26b
  (patch embeddings before the text) at ``ENCDEC_RUNS``' bf16 shapes.

Each object holds the wall time per step with and without the tracer
(``torch.profiler``), the device's busy time per step (sum of kernel
time), its idle share of an untraced step, the number of kernels a step
launches, and the kernels that take the most device time.  Needs a CUDA
device; nothing moves to the CPU.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.one_card import (ENCDEC_ARCHS, ENCDEC_RUNS,
                                          FAMILY_ARCHS, RUNS, one_card_config,
                                          prompt_inputs)
from repro_torch.configs.registry import get_config
from repro_torch.device import nvidia_smi_line
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.launch import serve
from repro_torch.models.model_zoo import build_model
from repro_torch.runtime.serve import make_decode_step, make_prefill_step
from repro_torch.sharding.rules import ShardCtx

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
RING_BATCH, RING_PROMPT = 2, 8192    # two prompts of twice the window


def _breakdown(prof, steps, untraced_s, traced_s):
    """Per-step figures of a traced window of ``steps`` steps; the kernel
    rows are (name, launches, device µs)."""
    rows = [(e.key, e.count, e.self_device_time_total)
            for e in prof.key_averages() if e.self_device_time_total > 0
            and e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(r[2] for r in rows)
    rows.sort(key=lambda r: -r[2])
    return {
        "wall_ms_per_step_untraced": untraced_s / steps * 1e3,
        "wall_ms_per_step_traced": traced_s / steps * 1e3,
        "device_busy_ms_per_step": busy_us / steps / 1e3,
        "device_idle_share_of_untraced_step":
            (1 - busy_us / 1e6 / untraced_s) if busy_us else None,
        "device_time_seen": bool(busy_us),
        "kernels_per_step": sum(r[1] for r in rows) / steps,
        "top_kernels": [
            {"name": k[:90], "per_step": c / steps,
             "device_ms_per_step": us / steps / 1e3,
             "share_of_busy": us / busy_us} for k, c, us in rows[:TOP]],
    }


def _traced(fn, steps):
    """(profile, wall seconds) of ``steps`` calls of fn under the tracer."""
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    return prof, time.perf_counter() - t0


def _untraced(fn, steps):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def profile_ring(cfg=None, batch=RING_BATCH, prompt=RING_PROMPT, run=None):
    """One traced prefill and a traced window of decode steps of ``cfg``
    (h2o-danube-1.8b by default) at ``batch`` x ``prompt``, or with the
    frames or patches of ``run`` (``one_card.ENCDEC_RUNS``)."""
    cfg = cfg or get_config("h2o-danube-1.8b")
    model = build_model(cfg)                     # bf16 weights, on the card
    model.init_params(torch.Generator(device=model.device).manual_seed(0))
    dev = model.device
    if run is None:
        rng = np.random.default_rng(0)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                             (batch, prompt))).to(dev)
        inp = dict(tokens=toks, embeds=None, cache_kw={}, start=prompt,
                   positions=torch.arange(prompt, device=dev).expand(
                       batch, prompt))
    else:
        inp = prompt_inputs(cfg, run, dev)
    toks, positions, embeds = inp["tokens"], inp["positions"], inp["embeds"]
    n_steps = WARMUP + 2 * STEPS
    cache = model.init_cache(batch, inp["start"] + n_steps, **inp["cache_kw"])
    ctx = ShardCtx(attn_impl="flash")
    prefill, decode = make_prefill_step(model, ctx), make_decode_step(model,
                                                                      ctx)
    state = {}

    def pre():
        state["logits"], _ = prefill(toks, positions, cache, embeds=embeds)

    _untraced(pre, 1)              # warm-up: builds K3, first cuBLAS calls
    pre_untraced = _untraced(pre, 1)
    fa_ops.launches = 0
    pre_prof, pre_traced = _traced(pre, 1)
    prefill_launches = fa_ops.launches
    state["tok"] = torch.argmax(state["logits"][:, -1], dim=-1)
    state["pos"] = inp["start"]

    def dec():
        pos = torch.full((batch,), state["pos"], dtype=torch.int64,
                         device=dev)
        logits, _ = decode(state["tok"][:, None], pos, cache)
        state["tok"] = torch.argmax(logits[:, 0], dim=-1)
        state["tok"].tolist()                    # the ids reach the host
        state["pos"] += 1

    _untraced(dec, WARMUP)
    dec_untraced = _untraced(dec, STEPS)
    dec_prof, dec_traced = _traced(dec, STEPS)
    return {
        "path": "ring", "card": nvidia_smi_line(), "arch": cfg.name,
        "dtype": "bfloat16", "batch": batch, "prompt": prompt,
        "flash_attention_launches_per_prefill": prefill_launches,
        "prefill": _breakdown(pre_prof, 1, pre_untraced, pre_traced),
        "embeds": None if embeds is None else list(embeds.shape),
        "decode_positions": [inp["start"] + WARMUP + STEPS,
                             inp["start"] + WARMUP + 2 * STEPS - 1],
        "decode": _breakdown(dec_prof, STEPS, dec_untraced, dec_traced),
    }


def profile_paged():
    eng, _ = serve.build_engine(SERVE_ARGS)

    def step():
        assert eng.step() == BATCH

    _untraced(eng.step, WARMUP)
    # the step time without the tracer's cost, on the same steady batch
    untraced = _untraced(step, STEPS)
    pa_ops.launches = 0
    prof, traced = _traced(step, STEPS)
    return {"path": "paged", "card": nvidia_smi_line(),
            "arch": eng.model.cfg.name, "dtype": "bfloat16", "batch": BATCH,
            "steps": STEPS, "seq_lens": sorted(eng.kv.lens.values()),
            "paged_attention_launches_per_step": pa_ops.launches / STEPS,
            **_breakdown(prof, STEPS, untraced, traced)}


def profile_families():
    """``profile_ring`` of each family at its one-card bf16 run's shapes."""
    for arch in FAMILY_ARCHS:
        f = RUNS[arch]
        yield profile_ring(one_card_config(arch), f["batch"], f["prompt"])
        torch.cuda.empty_cache()


def profile_encdec():
    """``profile_ring`` of whisper-small and internvl2-26b at their bf16
    runs' shapes, with their frames or patches."""
    for arch in ENCDEC_ARCHS:
        f = ENCDEC_RUNS[arch]
        yield profile_ring(one_card_config(arch), f["batch"], f["prompt"],
                           run=f)
        torch.cuda.empty_cache()


def main(argv=None):
    paths = (argv if argv is not None else sys.argv[1:]) or ["paged", "ring"]
    for path in paths:
        if path == "paged":
            print(json.dumps(profile_paged(), indent=1), flush=True)
        elif path == "ring":
            print(json.dumps(profile_ring(), indent=1), flush=True)
        elif path in ("families", "encdec"):
            gen = profile_families() if path == "families" else \
                profile_encdec()
            for rec in gen:
                print(json.dumps(rec, indent=1), flush=True)
        else:
            raise SystemExit(f"unknown path {path!r}; paged, ring, "
                             "families or encdec")
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
