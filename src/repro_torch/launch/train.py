"""Training entry point.

Trains on the card (``--device cpu`` on purpose runs it on the CPU), with
checkpoint/restart and straggler tracking, from seeded random weights and
the deterministic synthetic token pipeline (``data/pipeline.py``).
``--two-phase`` (or ``--moments int8``) is Pond's mode: the AdamW state
(fp32 master and both moments) lives in the pool tier, pinned host memory
beside the card, and phase B streams it through the card a parameter at a
time; otherwise the fused step keeps it on the card.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --smoke --steps 200 --global-batch 16 --seq-len 128 --ckpt-dir DIR
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --steps 3 --global-batch 8 --seq-len 2048 --microbatches 2 --two-phase
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.registry import get_config, get_smoke
from repro_torch.core.znuma import tier_place
from repro_torch.data.pipeline import DataConfig, ShardedBatches
from repro_torch.device import resolve_device
from repro_torch.models.model_zoo import build_model
from repro_torch.optim import adamw
from repro_torch.runtime import checkpoint as ckpt
from repro_torch.runtime import train as rt
from repro_torch.runtime.fault import StragglerTracker
from repro_torch.sharding.rules import ShardCtx


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def init_opt_state(params: dict, ocfg: adamw.AdamWConfig, two_phase: bool,
                   device: torch.device) -> dict:
    """The AdamW state for ``params``: on ``device`` for the fused step;
    for the two-phase step built on the host and placed by its tiers
    (``adamw.state_tier``: master, m and v pinned beside the card)."""
    if not two_phase:
        return adamw.init_state(params, ocfg)
    # a parameter at a time, each leaf pinned as soon as it is made: the
    # whole state built in pageable memory first would be held twice
    state = {"step": None, "master": {} if ocfg.master_fp32 else None,
             "m": {}, "v": {}}
    for n, p in params.items():
        one = adamw.init_state({n: p}, ocfg, device="cpu")
        one = tier_place(one, adamw.state_tier(one), device)
        state["step"] = one["step"]
        for g in ("master", "m", "v"):
            if one[g] is not None:
                state[g][n] = one[g][n]
    return state


def build_state(model, ocfg: adamw.AdamWConfig, *, seed: int = 0,
                two_phase: bool = False):
    """Seeded parameters (drawn on the model's device) and their AdamW
    state: ``(params, opt_state)``."""
    model.init_params(torch.Generator(device=model.device).manual_seed(seed))
    params = rt.train_params(model)
    return params, init_opt_state(params, ocfg, two_phase, model.device)


def make_step(model, ocfg: adamw.AdamWConfig, ctx: ShardCtx, *,
              two_phase: bool, microbatches: int = 1,
              xent_chunk: int = 512, accum_dtype=torch.float32):
    """``step(params, opt, batch) -> (params, opt, metrics)``: the fused
    step, or the two-phase step with its phases timed apart
    (``grad_ms``, ``opt_ms``; the card synchronised between them);
    ``accum_dtype`` sums the microbatches' gradients."""
    if not two_phase:
        return rt.jit_train_step(model, ocfg, ctx, microbatches=microbatches,
                                 xent_chunk=xent_chunk,
                                 accum_dtype=accum_dtype)
    grad_step, opt_step = rt.make_two_phase_steps(
        model, ocfg, ctx, microbatches=microbatches, xent_chunk=xent_chunk,
        accum_dtype=accum_dtype)

    def step(params, opt, batch):
        t0 = time.perf_counter()
        grads, metrics = grad_step(params, batch)
        _sync(model.device)
        t1 = time.perf_counter()
        params, opt, om = opt_step(params, opt, grads)
        _sync(model.device)
        return params, opt, {**metrics, **om, "grad_ms": (t1 - t0) * 1e3,
                             "opt_ms": (time.perf_counter() - t1) * 1e3}
    return step


def train_loop(model, params: dict, opt: dict, step_fn, data,
               start_step: int, steps: int, *, ckpt_dir: str | None = None,
               ckpt_every: int = 50, log_every: int = 10) -> list[dict]:
    """Run ``step_fn`` from ``start_step`` to ``steps`` on ``data``'s
    batches (copied to the model's device), logging and checkpointing;
    returns one dict a step: step, loss, grad_norm, lr, step_ms (host
    clock, the card synchronised), tokens, and for a two-phase step
    grad_ms, opt_ms, opt_bytes_in and opt_bytes_out."""
    device = model.device
    tracker = StragglerTracker()
    out = []
    for step in range(start_step, steps):
        batch = {"tokens": torch.from_numpy(next(data)["tokens"]).to(device)}
        _sync(device)
        t0 = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, batch)
        loss = float(metrics["loss"])
        _sync(device)
        dt = time.perf_counter() - t0
        tracker.record("host0", dt)
        rec = {"step": step + 1, "loss": loss,
               "grad_norm": float(metrics["grad_norm"]),
               "lr": float(metrics["lr"]), "step_ms": dt * 1e3,
               "tokens": int(batch["tokens"].shape[0]
                             * (batch["tokens"].shape[1] - 1))}
        for k in ("grad_ms", "opt_ms", "opt_bytes_in", "opt_bytes_out"):
            if k in metrics:
                rec[k] = metrics[k]
        out.append(rec)
        if (step + 1) % log_every == 0 or step == start_step:
            print(f"[train] step {step + 1:5d} loss {loss:.4f} "
                  f"gnorm {rec['grad_norm']:.3f} lr {rec['lr']:.2e} "
                  f"{dt * 1e3:.0f}ms", flush=True)
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            ckpt.save(ckpt_dir, step + 1, (params, opt))
    return out


def _restore_into(params: dict, opt: dict, restored) -> dict:
    """Copy a restored ``(params, opt)`` into the live parameters; the
    restored state (placed where ``opt`` lay) replaces ``opt``."""
    new_params, new_opt = restored
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(new_params[n])
    return new_opt


def parse_args(argv=None) -> argparse.Namespace:
    """The reference's flags, plus ``--device``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--moments", default="float32",
                    choices=["float32", "bfloat16", "int8"])
    ap.add_argument("--two-phase", action="store_true",
                    help="Pond mode: optimizer state on the pool tier")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--preset", default=None, choices=[None, "100m"],
                    help="predefined model size (e.g. ~100M param run)")
    ap.add_argument("--device", default="cuda",
                    help="the CUDA card (default; an error where there is "
                         "none); 'cpu' runs on the CPU")
    return ap.parse_args(argv)


def main(argv=None):
    """Parse ``argv`` and train: returns ``(params, opt)``."""
    return run(parse_args(argv))


def run(args, metrics_out: list | None = None):
    """:func:`main` after parsing: returns ``(params, opt)``; the per-step
    metrics are appended to ``metrics_out`` when given."""
    device = resolve_device(args.device)
    if args.preset == "100m":
        from repro_torch.configs.base import ArchConfig, Block, LayerGroup
        cfg = ArchConfig(
            name="qwen2-100m", family="dense", num_layers=12,
            d_model=768, num_heads=12, num_kv_heads=4, d_ff=2560,
            vocab_size=4096, qkv_bias=True, tie_embeddings=True,
            rope_theta=1e4,
            groups=(LayerGroup(12, (Block("attn", "mlp"),)),))
    else:
        cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg, device=device)
    ocfg = adamw.AdamWConfig(lr=args.lr, warmup_steps=20,
                             total_steps=args.steps,
                             moments_dtype=args.moments)
    ctx = ShardCtx()
    two_phase = args.two_phase or args.moments == "int8"
    params, opt = build_state(model, ocfg, two_phase=two_phase)

    start_step = 0
    if args.ckpt_dir:
        latest = ckpt.latest_step(args.ckpt_dir)
        if latest is not None:
            opt = _restore_into(params, opt, ckpt.restore(
                args.ckpt_dir, latest, (params, opt)))
            start_step = latest
            print(f"[train] restored step {latest} from {args.ckpt_dir}")

    step_fn = make_step(model, ocfg, ctx, two_phase=two_phase,
                        microbatches=args.microbatches)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                    global_batch=args.global_batch)
    data = ShardedBatches(dc, start_step=start_step)
    metrics = train_loop(model, params, opt, step_fn, data, start_step,
                         args.steps, ckpt_dir=args.ckpt_dir,
                         ckpt_every=args.ckpt_every,
                         log_every=args.log_every)
    if metrics_out is not None:
        metrics_out.extend(metrics)
    if args.ckpt_dir:
        ckpt.save(args.ckpt_dir, args.steps, (params, opt))
    return params, opt


if __name__ == "__main__":
    main()
