#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds
each against its plain PyTorch version on the card, serves a few requests
through ``repro_torch.launch.serve`` with qwen2-1.5b at full width, and
shows that the serving path went through the kernels.  Every phase prints
one JSON line; any failure ends the process with a non-zero exit code.
Nothing runs on the CPU in place of the card: without a CUDA device the
script exits at once.  It imports only the port (``repro_torch``), never
the reference package.

The last three lines are: the ``{"kernels": [...]}`` record, the card's
name and power limit as ``nvidia-smi`` prints them, and ``{"ok": true,
"device": {...}}``.
"""
from __future__ import annotations

import json
import os
import re
import statistics
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: 2e-6, torch.bfloat16: 2e-2}
# At the full-width shape the long rows average ~2000 values of V, so an
# output is ~0.03 in size and 2e-2 would pass a wrong one: there bf16 is held
# to a few times its measured error (4.9e-4, one rounding of the output).
TOL_FULL = {torch.float32: 2e-6, torch.bfloat16: 4e-3}
LAYERS = 28                      # qwen2-1.5b: launches per decode step
FULL = dict(b=8, hq=12, hkv=2, d=128, page=16, max_len=2048, num_pages=1280)
SERVE_ARGS = ["--arch", "qwen2-1.5b", "--full", "--dtype", "bfloat16",
              "--requests", "16", "--max-batch", "8", "--page-size", "16",
              "--local-pages", "256", "--pool-pages", "1024",
              "--prompt-len", "128", "1025", "--new-tokens", "32", "65",
              "--seed", "0"]


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


# ------------------------------------------------------------------ build --
def phase_build():
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_attention import kernel as K
    t0 = time.perf_counter()
    K.build()
    seconds = time.perf_counter() - t0
    with open(f"{build.library_path(K.NAME)}.log") as f:
        log = f.read()
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
    spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores", log)]
    emit("build", kernel=K.NAME, source=K.SOURCE, seconds=round(seconds, 2),
         flags=" ".join(build.NVCC_FLAGS), instantiations=len(regs),
         max_registers=max(regs), spill_store_bytes=sum(spills))


# ---------------------------------------------------------------- kernels --
def _paged_inputs(rng, b, g, hkv, d, page, num_pages, lens, width, dtype, dev,
                  layers=1):
    """Random pools and queries; each row gets distinct random pages, the
    table is padded with page 0 to ``width`` columns."""
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(2 ** 31)))
    q = torch.randn((b, hkv * g, d), generator=gen, device=dev).to(dtype)
    shape = (layers, hkv, num_pages, page, d)
    kp = torch.randn(shape, generator=gen, device=dev).to(dtype)
    vp = torch.randn(shape, generator=gen, device=dev).to(dtype)
    tbl = np.zeros((b, width), np.int32)
    perm = rng.permutation(num_pages)
    used = 0
    for i, n in enumerate(lens):
        npg = -(-int(n) // page)
        if used + npg <= num_pages:          # distinct pages while they last
            tbl[i, :npg] = perm[used:used + npg]
            used += npg
        else:
            tbl[i, :npg] = rng.integers(0, num_pages, npg)
    return (q, kp, vp, torch.from_numpy(tbl).to(dev),
            torch.from_numpy(np.asarray(lens, np.int32)).to(dev))


def _max_err(got, want, tol, what):
    got, want = got.float(), want.float()
    err = (got - want).abs()
    if not bool((err <= tol + tol * want.abs()).all()):
        raise SystemExit(f"paged_attention disagrees with its plain version "
                         f"at {what}: max abs err {float(err.max()):.3e}, "
                         f"tolerance {tol:g}")
    return float(err.max())


def _time_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_kernels(dev):
    from repro_torch.kernels.paged_attention import kernel as K
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    rng = np.random.default_rng(0)
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    n_shapes = 0
    # the reference sweep, plus the page sizes and head dims the kernel is
    # built for beyond it
    sweep = [(b, g, hkv, d, page, pps)
             for g in (1, 2, 4) for hkv in (1, 2) for d in (16, 32)
             for page in (8, 16) for b, pps in ((1, 1), (2, 3), (3, 4))]
    sweep += [(2, 6, 2, 64, 4, 5), (2, 3, 1, 128, 4, 40), (3, 6, 2, 128, 8, 9)]
    for b, g, hkv, d, page, pps in sweep:
        lens = rng.integers(1, pps * page + 1, b)
        for dtype in (torch.float32, torch.bfloat16):
            q, kp, vp, tbl, ln = _paged_inputs(
                rng, b, g, hkv, d, page, 16, lens, pps + int(rng.integers(3)),
                dtype, dev)
            got = ops.paged_attention(q, kp[0], vp[0], tbl, ln)
            want = paged_attention_ref(q, kp[0], vp[0], tbl, ln,
                                       scale=d ** -0.5)
            torch.cuda.synchronize()
            errs[dtype] = max(errs[dtype], _max_err(
                got, want, TOL[dtype],
                f"b={b} g={g} hkv={hkv} d={d} page={page} {dtype}"))
            n_shapes += 1

    # the full-width shape of the serving path: ragged rows, padded table,
    # one pool per layer so that every launch finds its pages cold, as the
    # 28 layers of a decode step do
    f = FULL
    g = f["hq"] // f["hkv"]
    lens = rng.integers(1, f["max_len"] + 1, f["b"])
    lens[0], lens[1] = f["max_len"], 1
    width = f["max_len"] // f["page"]
    timing = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, kp, vp, tbl, ln = _paged_inputs(
            rng, f["b"], g, f["hkv"], f["d"], f["page"], f["num_pages"], lens,
            width, dtype, dev, layers=LAYERS)
        scale = f["d"] ** -0.5
        for li in (0, LAYERS - 1):
            got = ops.paged_attention(q, kp[li], vp[li], tbl, ln, scale=scale)
            want = paged_attention_ref(q, kp[li], vp[li], tbl, ln,
                                       scale=scale)
            torch.cuda.synchronize()
            errs[dtype] = max(errs[dtype], _max_err(
                got, want, TOL_FULL[dtype],
                f"full width, layer {li}, {dtype}"))
        n_shapes += 1
        if dtype is not torch.bfloat16:
            continue

        def run_kernel():
            for li in range(LAYERS):
                ops.paged_attention(q, kp[li], vp[li], tbl, ln, scale=scale)

        def run_plain():
            for li in range(LAYERS):
                paged_attention_ref(q, kp[li], vp[li], tbl, ln, scale=scale)

        # plain, kernel, kernel, plain: both versions within one run
        plain_a = _time_ms(run_plain, 3) / LAYERS
        kern_a = _time_ms(run_kernel, 10) / LAYERS
        kern_b = _time_ms(run_kernel, 10) / LAYERS
        plain_b = _time_ms(run_plain, 3) / LAYERS
        tokens = int(lens.sum())
        item = q.element_size()
        nbytes = (2 * tokens * f["hkv"] * f["d"] * item        # K and V rows
                  + 2 * q.numel() * item                       # q in, out
                  + tbl.numel() * 4 + ln.numel() * 4)
        flops = 4 * tokens * f["hq"] * f["d"]                  # q.K and p.V
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        timing = dict(ms=min(kern_a, kern_b), plain_ms=min(plain_a, plain_b),
                      ms_runs=[kern_a, kern_b], plain_ms_runs=[plain_a, plain_b],
                      bound_ms=max(t_bytes, t_ops),
                      bound_by="bytes" if t_bytes >= t_ops else "operations",
                      bytes=nbytes, flops=flops, tokens=tokens,
                      timed_shape=dict(f, dtype="bfloat16",
                                       lens=[int(x) for x in lens]))
    record = dict(
        name=K.NAME, route="cuda", source=K.SOURCE,
        replaces="src/repro/kernels/paged_attention/kernel.py:75",
        max_abs_err=max(errs.values()),
        max_err_fp32=errs[torch.float32], max_err_bf16=errs[torch.bfloat16],
        tol_fp32=TOL[torch.float32], tol_bf16=TOL[torch.bfloat16],
        tol_bf16_full_width=TOL_FULL[torch.bfloat16],
        shapes_checked=n_shapes, library_ms=None,
        library_note="no single PyTorch call computes attention through a "
                     "block table",
        **timing)
    emit("kernels", kernels=[record])
    return record


# ----------------------------------------------------------- parity_small --
def phase_parity_small(dev):
    """Smoke config, fp32, same weights and requests: the engine on the
    card (kernel) and on the CPU (plain version) must give identical token
    streams and identical statistics."""
    import dataclasses
    from repro_torch.configs.registry import get_smoke
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.models.model_zoo import build_model
    from repro_torch.serving.engine import DecodeEngine, paged_kv_config
    from repro_torch.serving.scheduler import Request

    cfg = get_smoke("qwen2-1.5b")
    cpu_model = build_model(cfg, device="cpu", dtype=torch.float32)
    cpu_model.init_params(torch.Generator().manual_seed(0))
    gpu_model = build_model(cfg, device=dev, dtype=torch.float32)
    gpu_model.load_state_dict(cpu_model.state_dict())

    def run(model):
        rng = np.random.default_rng(2)
        eng = DecodeEngine(model, paged_kv_config(
            cfg, page_size=4, num_local=12, num_pool=96), max_batch=3,
            pdm=0.05)
        for r in range(8):
            plen = int(rng.integers(5, 40))
            eng.submit(Request(req_id=r, prompt_len=plen,
                               max_new_tokens=int(rng.integers(2, 17))),
                       rng.integers(0, cfg.vocab_size, plen))
        stats = eng.run(500)
        return eng, stats

    before = ops.launches
    gpu_eng, gpu_stats = run(gpu_model)
    gpu_launches = ops.launches - before
    cpu_eng, cpu_stats = run(cpu_model)
    ok = (gpu_eng.outputs == cpu_eng.outputs
          and dataclasses.asdict(gpu_stats) == dataclasses.asdict(cpu_stats)
          and len(gpu_eng.batcher.completed) == 8
          and gpu_launches == gpu_stats.steps * cfg.num_layers
          and ops.launches - before == gpu_launches      # none from the CPU
          and bool(gpu_eng.logits_finite) and gpu_stats.migrations >= 1)
    emit("parity_small", ok=ok, steps=gpu_stats.steps, tokens=gpu_stats.tokens,
         migrations=gpu_stats.migrations, kernel_launches=gpu_launches,
         streams_equal=gpu_eng.outputs == cpu_eng.outputs,
         stats_equal=dataclasses.asdict(gpu_stats)
         == dataclasses.asdict(cpu_stats))
    if not ok:
        raise SystemExit("parity_small failed: the card and the CPU disagree")


# ------------------------------------------------------------- serve_full --
def phase_serve_full(dev):
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.launch import serve
    torch.cuda.reset_peak_memory_stats()
    ops.launches = 0                        # just before the main path ...
    t0 = time.perf_counter()
    eng = serve.serve(SERVE_ARGS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launches                 # ... and read just after it
    stats, alloc = eng.stats, eng.kv.alloc
    want_tokens = sum(r.max_new_tokens for r in eng.batcher.completed)
    checks = {
        "all_completed": len(eng.batcher.completed) == 16,
        "tokens": stats.tokens == want_tokens,
        "pages_returned": alloc.local_in_use == 0 and alloc.pool_in_use == 0,
        "launches": launches == stats.steps * LAYERS and launches > 0,
        "spilled": max(stats.pool_traffic_fracs) > 0,
        "migrated": stats.migrations >= 1,
        "logits_finite": bool(eng.logits_finite),
        "tokens_in_vocab": all(0 <= t < eng.model.cfg.vocab_size
                               for out in eng.outputs.values() for t in out),
        "on_card": eng.device.type == "cuda",
    }
    dec = eng.timings.decode_seconds
    pre = eng.timings.prefill_seconds
    emit("serve_full", ok=all(checks.values()), checks=checks,
         arch=eng.model.cfg.name, layers=eng.model.cfg.num_layers,
         params=sum(p.numel() for p in eng.model.parameters()),
         requests=16, steps=stats.steps, tokens=stats.tokens,
         kernel_launches=launches, migrations=stats.migrations,
         max_pool_traffic_frac=max(stats.pool_traffic_fracs),
         spill_fraction=alloc.spill_fraction,
         decode_ms_per_step_median=statistics.median(dec) * 1e3,
         decode_ms_per_step_mean=statistics.fmean(dec) * 1e3,
         prefill_ms_per_request_median=statistics.median(pre) * 1e3,
         prefill_ms_per_request_mean=statistics.fmean(pre) * 1e3,
         decode_tokens_per_s=stats.tokens / sum(dec),
         wall_seconds=wall,
         peak_memory_bytes=torch.cuda.max_memory_allocated())
    if not all(checks.values()):
        raise SystemExit(f"serve_full failed: {checks}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this script runs on "
              "the card only", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "src"))
    import repro_torch  # noqa: F401  (fails here if the checkout is missing)
    from repro_torch.device import nvidia_smi_line, resolve_device

    dev = resolve_device(None)
    smi = nvidia_smi_line()
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0])
    phase_build()
    record = phase_kernels(dev)
    phase_parity_small(dev)
    record["launches"] = phase_serve_full(dev)
    print(json.dumps({"kernels": [record]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
