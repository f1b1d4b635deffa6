"""Serving entry point: tiered-KV decode engine with synthetic traffic.

Demonstrates the full Pond serving path: zNUMA-biased page allocation,
slice-pool ownership, access-bit telemetry, QoS mitigation, and
straggler-aware replica routing.

  PYTHONPATH=src python -m repro_torch.launch.serve                # smoke config, on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu   # smoke config, on the CPU
  PYTHONPATH=src python -m repro_torch.launch.serve --full --dtype bfloat16 \\
      --requests 16 --max-batch 8 --page-size 16 --local-pages 256 \\
      --pool-pages 1024 --prompt-len 128 1024 --new-tokens 32 64
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs.registry import get_config, get_smoke
from repro_torch.core.slices import SlicePool
from repro_torch.device import resolve_device, resolve_dtype
from repro_torch.models.model_zoo import build_model
from repro_torch.serving.engine import DecodeEngine, paged_kv_config
from repro_torch.serving.scheduler import Request


def build_engine(argv=None) -> tuple[DecodeEngine, argparse.Namespace]:
    """Parse ``argv``, build the model and the engine, and submit the
    synthetic requests; nothing has run yet."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--local-pages", type=int, default=24)
    ap.add_argument("--pool-pages", type=int, default=96)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--pdm", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (an error if there is "
                         "none); 'cpu' runs the plain versions on the CPU")
    ap.add_argument("--full", action="store_true",
                    help="the published configuration at full width and "
                         "depth instead of its smoke reduction")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default="float32",
                    help="KV-pool dtype; bfloat16 also keeps the weights "
                         "in their declared bf16/fp32 mix, float32 casts "
                         "all of them to fp32")
    ap.add_argument("--prompt-len", type=int, nargs=2, default=(8, 48),
                    metavar=("MIN", "MAX"), help="prompt lengths, [MIN, MAX)")
    ap.add_argument("--new-tokens", type=int, nargs=2, default=(4, 16),
                    metavar=("MIN", "MAX"),
                    help="tokens to generate per request, [MIN, MAX)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch) if args.full else get_smoke(args.arch)
    model = build_model(
        cfg, device=device,
        dtype=None if args.dtype == "bfloat16" else resolve_dtype(args.dtype))
    model.init_params(torch.Generator(device=device).manual_seed(0))
    kvc = paged_kv_config(cfg, page_size=args.page_size,
                          num_local=args.local_pages,
                          num_pool=args.pool_pages, dtype=args.dtype)
    # Pond's slices are 1 GB; the smoke config's pool tier is a few hundred
    # KB, so its slices shrink with it
    slice_pool = SlicePool(num_slices=256,
                           slice_gb=1.0 if args.full else 0.001)
    eng = DecodeEngine(model, kvc, max_batch=args.max_batch, pdm=args.pdm,
                       slice_pool=slice_pool)
    rng = np.random.default_rng(args.seed)
    for r in range(args.requests):
        plen = int(rng.integers(*args.prompt_len))
        eng.submit(Request(req_id=r, prompt_len=plen,
                           max_new_tokens=int(rng.integers(*args.new_tokens))),
                   rng.integers(0, cfg.vocab_size, plen))
    return eng, args


def serve(argv=None) -> DecodeEngine:
    """Serve the synthetic requests of ``argv`` to completion, print the
    ``[serve]`` report and return the engine (stats, outputs, timings and
    the KV pool stay inspectable on it)."""
    eng, args = build_engine(argv)
    slice_pool = eng.kv.slice_pool
    stats = eng.run(max(2000, 2 * args.requests * args.new_tokens[1]))
    print(f"[serve] completed={len(eng.batcher.completed)} "
          f"steps={stats.steps} tokens={stats.tokens}")
    print(f"[serve] virtual time={stats.virtual_seconds:.3f}s "
          f"mean pool-traffic={np.mean(stats.pool_traffic_fracs or [0]):.4f} "
          f"migrations={stats.migrations} "
          f"(+{stats.migration_seconds * 1e3:.1f}ms copy)")
    print(f"[serve] znuma spill fraction={eng.kv.alloc.spill_fraction:.4f}")
    eng.kv.release_slices()
    print(f"[serve] slices draining={slice_pool.draining_gb():.3f}GB "
          f"offline events={len(slice_pool.offline_events)}")
    return eng


def main(argv=None):
    return serve(argv).stats


if __name__ == "__main__":
    main()
