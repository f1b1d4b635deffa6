"""Multi-pod dry run: count every (arch x shape x mesh) cell's step on meta
tensors.

The dry run never allocates: the model, its parameters, the optimizer
state, the batch and the cache are meta tensors, and the step runs on
``device="meta"`` by definition (the one entry point of the port that does
not run on the card).  Per cell this driver

  1. builds the full-size ArchConfig's model on meta and the step's meta
     arguments (``models/params.py::abstract`` for the cache and the
     optimizer state),
  2. builds the port's train / prefill / decode step under the cell's plan
     and ``make_ctx``'s ``ShardCtx`` on the 16 x 16 (single pod) or 2 x 16
     x 16 (multi pod) mesh of meta devices,
  3. runs it once under ``launch/op_analysis.py``'s counter, in place of
     the reference's ``.lower().compile()`` (identical microbatches are
     counted once and multiplied),
  4. records the counts, the spec arithmetic (``structural_bytes``,
     ``active_param_count``, ``model_flops``, the reference's) and the
     roofline against the H100's figures (``launch/mesh.py``) as JSON.

The port has no partitioner: with a mesh, only ``shard_map`` code (the
sharded MoE paths, the tied-head loss) splits work over the mesh's
coordinates; the rest runs once, at the global batch.  So the counts are
the whole mesh's, divided by its devices for the per-device figures, and
``memory.temp_bytes`` is the counted peak of live bytes divided by the
batch axes' size: a split by the spec, not a measurement.
``memory.argument_bytes`` is each device's share of the parameters,
optimizer state, batch and cache as ``partition_tree`` places them.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import op_analysis
from repro_torch.models.attention import ring_width
from repro_torch.models.frontend import frontend_embed_spec, text_len
from repro_torch.models.model_zoo import build_model
from repro_torch.models.params import (ParamSpec, abstract, map_with_path,
                                       tree_leaves, tree_map_specs)
from repro_torch.optim import adamw
from repro_torch.runtime import serve as rt_serve
from repro_torch.runtime import train as rt_train
from repro_torch.sharding.rules import P, ShardCtx, default_rules, spec_for

META = torch.device("meta")
WHISPER_DEC_LEN = 448


@dataclasses.dataclass(frozen=True)
class CellPlan:
    microbatches: int = 8
    accum_dtype: str = "float32"
    two_phase: bool = False          # Pond pool-tier optimizer state
    xent_chunk: int = 512
    remat: bool = True
    attn_impl: str = "blocked"
    replicate_lm_head: bool = False     # hillclimb: tied-head replication
    moe_serve_impl: str = ""            # hillclimb: "sharded_a2a" override
    fsdp_pod: bool = False              # hillclimb: FSDP over (pod, data)
    notes: str = ""


PLANS: dict[str, CellPlan] = {
    "granite-moe-1b-a400m": CellPlan(microbatches=4),
    "deepseek-v3-671b": CellPlan(microbatches=16, accum_dtype="bfloat16",
                                 two_phase=True, xent_chunk=256,
                                 notes="pool-tier opt state; bf16 grad accum"),
    "mamba2-1.3b": CellPlan(microbatches=4),
    "qwen2-1.5b": CellPlan(microbatches=4),
    "qwen3-32b": CellPlan(microbatches=16, xent_chunk=256),
    "h2o-danube-1.8b": CellPlan(microbatches=4),
    "qwen2-7b": CellPlan(microbatches=8),
    "jamba-1.5-large-398b": CellPlan(microbatches=16, accum_dtype="bfloat16",
                                     two_phase=True, xent_chunk=256,
                                     notes="pool-tier opt state"),
    "whisper-small": CellPlan(microbatches=4),
    "internvl2-26b": CellPlan(microbatches=16, xent_chunk=256),
}

SKIPS: dict[tuple[str, str], str] = {
    (a, "long_500k"): "full quadratic attention; sub-quadratic required "
                      "(DESIGN.md §4)"
    for a in ("granite-moe-1b-a400m", "deepseek-v3-671b", "qwen2-1.5b",
              "qwen3-32b", "qwen2-7b", "internvl2-26b", "whisper-small")
}

NO_PARTITIONER = ("no partitioner: only shard_map code (the sharded MoE, "
                  "the tied-head loss) splits work over the mesh; the rest "
                  "runs once at the global batch")


def cell_skip_reason(arch_id: str, shape_name: str) -> str | None:
    return SKIPS.get((arch_id, shape_name))


def make_ctx(mesh, multi_pod: bool, shape: ShapeConfig,
             plan: CellPlan, arch_cfg: ArchConfig | None = None) -> ShardCtx:
    seq_shard = False
    if shape.kind in ("prefill", "decode"):
        # SP for the KV/latent cache: kv_heads rarely divide the 16-way
        # model axis, so the cache seq dim shards over "model" (and "data"
        # too when batch=1) -> flash-decoding style merge collectives.
        seq_shard = ("data", "model") if shape.global_batch == 1 \
            else "model"
    moe_impl = "auto"
    if shape.kind != "train" and arch_cfg is not None and arch_cfg.moe:
        ff = arch_cfg.moe.d_ff_expert or arch_cfg.d_ff
        n_moe = sum(g.repeat * sum(1 for bl in g.blocks if bl.ffn == "moe")
                    for g in arch_cfg.groups)
        expert_gb = (n_moe * arch_cfg.moe.num_experts * 3
                     * arch_cfg.d_model * ff * 2 / 2 ** 30)
        if expert_gb / 16 > 4:               # >4 GB/dev under 16-way TP
            moe_impl = "sharded2d"
        if plan.moe_serve_impl:
            moe_impl = plan.moe_serve_impl
    return ShardCtx(mesh=mesh, pod_axis="pod" if multi_pod else None,
                    remat=plan.remat and shape.kind == "train",
                    attn_impl=plan.attn_impl, moe_impl=moe_impl,
                    replicate_lm_head=plan.replicate_lm_head,
                    fsdp_pod=plan.fsdp_pod,
                    seq_shard_kv=seq_shard)


def batch_pspec(ctx: ShardCtx, batch: int, ndim: int) -> P:
    axes = ctx.batch_axes
    n = math.prod(ctx.mesh.shape[a] for a in axes)
    parts = [None] * ndim
    if batch % n == 0:
        parts[0] = axes
    return P(*parts)


def _whisper_lens(shape: ShapeConfig) -> tuple[int, int]:
    """(enc_frames, dec_len) for enc-dec cells."""
    if shape.kind == "train":
        return shape.seq_len, min(WHISPER_DEC_LEN, shape.seq_len)
    if shape.kind == "prefill":
        return shape.seq_len, 8
    return shape.seq_len, 1


# ------------------------------------------------------- the cell's step ---
def _meta(shape, dtype=torch.int32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _shard(shape, spec, mesh) -> float:
    """The share of a leaf of ``shape`` one device holds under ``spec``."""
    n = 1
    for axes in spec:
        if axes is None:
            continue
        for a in ((axes,) if isinstance(axes, str) else axes):
            n *= mesh.shape[a]
    return math.prod(shape) / n


def _spec_bytes(specs, rules, mesh, dtype=None) -> float:
    """Each device's bytes of a ParamSpec tree placed by
    ``partition_tree`` (every leaf cast to ``dtype`` where given)."""
    total = 0.0

    def one(leaf):
        nonlocal total
        total += (_shard(leaf.shape, spec_for(leaf, rules, mesh), mesh)
                  * (dtype or leaf.dtype).itemsize)
    tree_map_specs(one, specs)
    return total


def _moment_dtype(ocfg: adamw.AdamWConfig) -> torch.dtype:
    return {"float32": torch.float32,
            "bfloat16": torch.bfloat16}[ocfg.moments_dtype]


def abstract_opt_state(params: dict, ocfg: adamw.AdamWConfig) -> dict:
    """AdamW's state for ``params`` (a name -> tensor dict) as meta
    tensors, from ``abstract``: the layout ``adamw.init_state`` makes."""
    def specs(dtype):
        return {n: ParamSpec(tuple(p.shape), dtype)
                for n, p in params.items()}
    mdt = _moment_dtype(ocfg)
    return {"step": _meta((), torch.int32),
            "master": (abstract(specs(torch.float32))
                       if ocfg.master_fp32 else None),
            "m": abstract(specs(mdt)), "v": abstract(specs(mdt))}


def train_batch(cfg: ArchConfig, batch: int, seq_len: int,
                device=META) -> dict:
    """A train step's batch on ``device`` (meta: shapes only):
    ``tokens`` (B, S+1) int32, ``embeds`` where the config has a
    frontend (whisper's frames for its encoder)."""
    if cfg.is_encoder_decoder:
        enc, dec = _whisper_lens(ShapeConfig("", seq_len, batch, "train"))
        out = {"tokens": torch.empty((batch, dec + 1), dtype=torch.int32,
                                     device=device),
               "embeds": torch.empty((batch, enc, cfg.d_model),
                                     dtype=torch.bfloat16, device=device)}
        return out
    out = {"tokens": torch.empty((batch, text_len(cfg, seq_len) + 1),
                                 dtype=torch.int32, device=device)}
    spec = frontend_embed_spec(cfg, batch, seq_len)
    if spec is not None:
        out["embeds"] = torch.empty(spec[0], dtype=spec[1], device=device)
    return out


def build_cell(cfg: ArchConfig, shape: ShapeConfig, mesh, multi_pod: bool,
               plan: CellPlan):
    """Returns (step, meta args, extra): ``step(*args)`` runs the cell's
    step once; extra holds the ctx, the model, the plan's microbatches and
    each device's argument bytes."""
    model = build_model(cfg, device=META)
    ctx = make_ctx(mesh, multi_pod, shape, plan, cfg)
    b = shape.global_batch
    accum = torch.bfloat16 if plan.accum_dtype == "bfloat16" \
        else torch.float32
    extra = {"ctx": ctx, "model": model}
    mode = "train" if shape.kind == "train" else "serve"
    rules = default_rules(ctx, mode=mode)
    arg_bytes = _spec_bytes(model.specs(), rules, mesh)

    if shape.kind == "train":
        batch = train_batch(cfg, b, shape.seq_len)
        arg_bytes += sum(_shard(t.shape, batch_pspec(ctx, b, t.ndim), mesh)
                         * t.element_size() for t in batch.values())
        ocfg = adamw.AdamWConfig()
        mb = plan.microbatches
        while b % mb or (b // mb) % math.prod(
                mesh.shape[a] for a in ctx.batch_axes):
            mb //= 2
            if mb == 0:
                mb = 1
                break
        extra["microbatches"] = mb
        params = rt_train.train_params(model)
        if plan.two_phase:
            grad_step, _ = rt_train.make_two_phase_steps(
                model, ocfg, ctx, microbatches=mb,
                xent_chunk=plan.xent_chunk, accum_dtype=accum)
            extra["argument_bytes"] = arg_bytes
            return grad_step, (params, batch), extra
        step = rt_train.make_train_step(
            model, ocfg, ctx, microbatches=mb, xent_chunk=plan.xent_chunk,
            accum_dtype=accum)
        opt = abstract_opt_state(params, ocfg)
        arg_bytes += (2 * _spec_bytes(model.specs(), rules, mesh,
                                      _moment_dtype(ocfg))
                      + (_spec_bytes(model.specs(), rules, mesh,
                                     torch.float32)
                         if ocfg.master_fp32 else 0) + 4)
        extra["argument_bytes"] = arg_bytes
        return step, (params, opt, batch), extra

    # ---- serving shapes ---------------------------------------------------
    if cfg.is_encoder_decoder:
        enc, dec = _whisper_lens(shape)
        cache_specs = model.cache_specs(b, WHISPER_DEC_LEN, enc_len=enc)
    else:
        enc = dec = None
        cache_specs = model.cache_specs(b, shape.seq_len)
    cache = abstract(cache_specs)
    arg_bytes += _spec_bytes(cache_specs, rules, mesh)

    def tok_bytes(t):
        return _shard(t.shape, batch_pspec(ctx, b, t.ndim), mesh) \
            * t.element_size()

    if shape.kind == "prefill":
        if cfg.is_encoder_decoder:
            tokens = _meta((b, dec))
            positions = _meta((b, dec))
            embeds = _meta((b, enc, cfg.d_model), torch.bfloat16)
        else:
            stext = text_len(cfg, shape.seq_len)
            full = shape.seq_len if cfg.frontend == "vision" else stext
            tokens = _meta((b, stext))
            positions = _meta((b, full))
            spec = frontend_embed_spec(cfg, b, shape.seq_len)
            embeds = None if spec is None else _meta(*spec)
        step = rt_serve.make_prefill_step(model, ctx)
        args = [tokens, positions, cache]
        if embeds is not None:
            args.append(embeds)
        arg_bytes += sum(tok_bytes(t) for t in args if t is not cache)
        extra["argument_bytes"] = arg_bytes
        return step, tuple(args), extra

    # decode
    tokens = _meta((b, 1))
    positions = _meta((b,))
    step = rt_serve.make_decode_step(model, ctx)
    extra["argument_bytes"] = arg_bytes + tok_bytes(tokens) \
        + tok_bytes(positions)
    return step, (tokens, positions, cache), extra


# --------------------------------------------------------------- roofline --
def structural_bytes(cfg: ArchConfig, shape: ShapeConfig, plan: CellPlan,
                     mesh, model, ctx: ShardCtx) -> dict:
    """Analytical per-device HBM traffic per step (bytes), the reference's
    model: weight reads (FSDP-gathered per layer per pass), gradient and
    optimizer streams, layer-boundary activations, KV-cache traffic and the
    lm-head.  The op counts stay in the record as an upper bound."""
    rules = default_rules(ctx, mode="train" if shape.kind == "train"
                          else "serve")
    nbytes_dev = _spec_bytes(model.specs(), rules, mesh)
    tp = mesh.shape["model"]
    n_batch = math.prod(mesh.shape[a] for a in ctx.batch_axes)
    total_param_bytes = sum(math.prod(l.shape) * l.dtype.itemsize
                            for l in tree_leaves(model.specs()))
    gathered = total_param_bytes / tp          # FSDP-gathered working copy
    d = cfg.d_model
    if shape.kind == "train":
        mb = plan.microbatches
        b_mb = max(1, shape.global_batch // mb // n_batch)
        toks_mb = b_mb * shape.seq_len
        layers = cfg.num_layers + (cfg.encoder_layers or 0)
        acts = mb * layers * toks_mb * d * 2 * 2        # save + reread, bf16
        weights = mb * 3 * gathered                     # fwd + remat + bwd
        accum_b = 2 if plan.accum_dtype == "bfloat16" else 4
        grads = 2 * mb * nbytes_dev / 2 * accum_b       # accum rd+wr
        opt = 0 if plan.two_phase else 3 * 2 * nbytes_dev / 2 * 4
        head = mb * (toks_mb / plan.xent_chunk) * \
            (d * cfg.vocab_size * 2 / tp)               # head reread per chunk
        parts = {"weights": weights, "activations": acts, "grads": grads,
                 "optimizer": opt, "lm_head": head}
    else:
        # serve: weights once + cache traffic
        if cfg.attention_free:
            cache_traffic = 0.0
        else:
            kv_layers = sum(g.repeat * sum(1 for bl in g.blocks
                                           if bl.mixer != "mamba")
                            for g in cfg.groups) or cfg.num_layers
            w_len = (ring_width(cfg, shape.seq_len)
                     if shape.kind == "decode" else shape.seq_len)
            if cfg.mla:
                per_tok = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
            else:
                per_tok = 2 * cfg.num_kv_heads * cfg.head_dim
            cache_traffic = (kv_layers * shape.global_batch * w_len
                             * per_tok * 2 / (tp * n_batch))
            if shape.kind == "prefill":
                cache_traffic *= 1.0                    # one write pass
        parts = {"weights": total_param_bytes / tp,
                 "cache": cache_traffic,
                 "activations": (shape.global_batch * shape.seq_len * d * 2
                                 * (cfg.num_layers / 4) / n_batch
                                 if shape.kind == "prefill" else 0.0)}
    parts["total"] = sum(parts.values())
    return parts


def active_param_count(cfg: ArchConfig, model) -> tuple[int, int]:
    """(total, active) params excluding the token table (6ND convention)."""
    total = active = 0

    def visit(path, leaf):
        nonlocal total, active
        n = math.prod(leaf.shape)
        if path[-1] == "tok":
            return
        total += n
        if leaf.axes and "experts" in leaf.axes and cfg.moe:
            active += n * cfg.moe.top_k // cfg.moe.num_experts
        else:
            active += n
    map_with_path(visit, model.specs())
    return total, active


def model_flops(cfg: ArchConfig, shape: ShapeConfig, model) -> float:
    total, active = active_param_count(cfg, model)
    if shape.kind == "train":
        if cfg.is_encoder_decoder:
            enc, dec = _whisper_lens(shape)
            d = shape.global_batch * (enc + dec)
        else:
            d = shape.global_batch * shape.seq_len
        return 6.0 * active * d
    if shape.kind == "prefill":
        return 2.0 * active * shape.global_batch * shape.seq_len
    return 2.0 * active * shape.global_batch  # decode: one token per seq


def roofline(flops: float, memory_bytes: float, collective_bytes: float
             ) -> dict:
    """Compute, memory and collective seconds at the H100's figures, and
    the dominant one."""
    terms = {"compute": flops / meshlib.PEAK_FLOPS_BF16,
             "memory": memory_bytes / meshlib.HBM_BW,
             "collective": collective_bytes / meshlib.NVLINK_BW}
    return {"compute_s": terms["compute"], "memory_s": terms["memory"],
            "collective_s": terms["collective"],
            "dominant": max(terms, key=terms.get)}


def count_step(step, args, repeat: bool = True):
    """(counts, host seconds) of one run of ``step(*args)`` under the
    counter; ``repeat`` counts identical microbatches once, multiplied."""
    t0 = time.perf_counter()
    with op_analysis.OpCounter(repeat=repeat) as c:
        step(*args)
    return c.counts, time.perf_counter() - t0


def run_cell(arch_id: str, shape_name: str, multi_pod: bool,
             outdir: str, skip_existing: bool = True,
             plan_overrides: dict | None = None) -> dict:
    mesh_name = "multi" if multi_pod else "single"
    out_path = os.path.join(outdir, mesh_name,
                            f"{arch_id}__{shape_name}.json")
    if skip_existing and os.path.exists(out_path):
        with open(out_path) as f:
            return json.load(f)
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    shape = SHAPES[shape_name]
    reason = cell_skip_reason(arch_id, shape_name)
    rec = {"arch": arch_id, "shape": shape_name, "mesh": mesh_name,
           "status": "skip", "skip_reason": reason}
    if reason:
        with open(out_path, "w") as f:
            json.dump(rec, f, indent=1)
        return rec

    cfg = get_config(arch_id)
    plan = PLANS[arch_id]
    if plan_overrides:
        plan = dataclasses.replace(plan, **plan_overrides)
    n = 512 if multi_pod else 256
    mesh = meshlib.make_production_mesh(multi_pod=multi_pod,
                                        devices=[META] * n)
    n_dev = mesh.size
    try:
        t0 = time.perf_counter()
        fn, args, extra = build_cell(cfg, shape, mesh, multi_pod, plan)
        t_build = time.perf_counter() - t0
        counts, t_count = count_step(fn, args)
        model, ctx = extra["model"], extra["ctx"]
        mf = model_flops(cfg, shape, model)
        sbytes = structural_bytes(cfg, shape, plan, mesh, model, ctx)
        n_batch = math.prod(mesh.shape[a] for a in ctx.batch_axes)
        temp = counts.peak_bytes / n_batch
        dev_bytes = extra["argument_bytes"] + temp
        flops_dev = counts.flops / n_dev
        rl = roofline(flops_dev, sbytes["total"],
                      counts.collective_bytes / n_dev)
        rec.update({
            "status": "ok",
            "t_build_s": round(t_build, 1),
            "t_count_s": round(t_count, 1),
            "devices": n_dev,
            "memory": {
                "argument_bytes": extra["argument_bytes"],
                "temp_bytes": temp,
                "temp_bytes_is": "the counted peak of live bytes over the "
                                 f"{n_batch} batch shards: a split by the "
                                 "spec, not a measurement",
                "device_total_bytes": dev_bytes,
                "fits_device": bool(dev_bytes <= meshlib.HBM_BYTES),
            },
            "op_counts": {
                "flops": counts.flops,
                "flops_per_device": flops_dev,
                "bytes_per_device": counts.bytes / n_dev,
                "dot_bytes_per_device": counts.dot_bytes / n_dev,
                "collective_bytes_per_device":
                    counts.collective_bytes / n_dev,
                "by_collective": {k: v / n_dev for k, v in
                                  counts.by_collective.items()},
                "ops": counts.ops,
                "peak_live_bytes": counts.peak_bytes,
                "kernel_launches": counts.kernel_launches,
                "partitioner": NO_PARTITIONER,
            },
            "structural_bytes": sbytes,
            "roofline": {
                **rl,
                "model_flops_global": mf,
                "model_flops_per_device": mf / n_dev,
                "useful_flops_ratio":
                    (mf / n_dev) / flops_dev if flops_dev else None,
            },
            "plan": dataclasses.asdict(plan),
            "microbatches": extra.get("microbatches"),
        })
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec.update({"status": "error", "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-4000:]})
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def summarize(outdir: str):
    rows = []
    for mesh_name in ("single", "multi"):
        d = os.path.join(outdir, mesh_name)
        if not os.path.isdir(d):
            continue
        for fname in sorted(os.listdir(d)):
            with open(os.path.join(d, fname)) as f:
                rows.append(json.load(f))
    for r in rows:
        if r["status"] == "ok":
            rl = r["roofline"]
            print(f"{r['mesh']:6s} {r['arch']:24s} {r['shape']:12s} ok "
                  f"compute={rl['compute_s']:.3e}s mem={rl['memory_s']:.3e}s "
                  f"coll={rl['collective_s']:.3e}s dom={rl['dominant']:10s} "
                  f"useful={rl['useful_flops_ratio'] and round(rl['useful_flops_ratio'],3)} "
                  f"fits={r['memory']['fits_device']} "
                  f"count={r['t_count_s']}s")
        else:
            print(f"{r['mesh']:6s} {r['arch']:24s} {r['shape']:12s} "
                  f"{r['status']} {r.get('skip_reason') or r.get('error','')[:120]}")
    return rows


def parse_overrides(pairs) -> dict:
    """``--set key=value`` pairs -> CellPlan overrides (bools, ints)."""
    overrides = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        f = CellPlan.__dataclass_fields__[k]
        if f.type == "bool" or isinstance(f.default, bool):
            v = v.lower() in ("1", "true", "yes")
        elif isinstance(f.default, int):
            v = int(v)
        overrides[k] = v
    return overrides


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--outdir", default="experiments/torch_dryrun")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--summary", action="store_true")
    ap.add_argument("--set", action="append", default=[],
                    help="plan override key=value (hillclimb knobs)")
    args = ap.parse_args(argv)
    overrides = parse_overrides(args.set)
    if args.summary:
        summarize(args.outdir)
        return
    archs = ARCH_IDS if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                rec = run_cell(arch, shape, mp, args.outdir,
                               skip_existing=not args.force,
                               plan_overrides=overrides or None)
                status = rec["status"]
                msg = rec.get("skip_reason") or rec.get("error", "")
                dom = rec.get("roofline", {}).get("dominant", "")
                print(f"[dryrun] {'multi' if mp else 'single':6s} "
                      f"{arch:24s} {shape:12s} {status:5s} {dom} "
                      f"{rec.get('t_count_s', '')} {str(msg)[:100]}",
                      flush=True)


if __name__ == "__main__":
    main()
