#!/usr/bin/env python3
"""How far a family's served steps drift from its own forward, and why.

    PYTHONPATH=src python scripts/torch_family_drift.py [--smoke] [arch ...]

For each arch (mamba2-1.3b and granite-moe-1b-a400m by default), one JSON
object.  Full width on the card by default, at the shapes of
``repro_torch/configs/one_card.py``; ``--smoke`` runs the registry's smoke
configs on the CPU (B 2 x 40 + 6 steps) to try the script out.

* ``layers`` (fp32 weights, ``FP32_RUNS``' shapes): each block's output in
  the served run (a prefill of P tokens with flash attention, then N greedy
  decode steps through ``runtime/serve.py``) against the same block's
  output in the model's forward over the same P + N tokens, as the largest
  deviation over the largest |h| of that layer's forward, prompt and
  decode positions apart; and the logits' largest deviation.
* ``rounding``: that forward again with the embedding's output moved by
  one fp32 rounding (x (1 + 2^-24 s), s = +-1 seeded): the same numbers.
  Where they are the served run's size, the served path's drift is the
  model amplifying rounding, which no order of summation avoids.
* ``recurrent`` (models with Mamba layers): each Mamba layer's input in
  the served prefill, fed again one token at a time through
  ``mamba_decode`` from an empty cache: its SSM and conv states after P
  tokens against the prefill's chunked ones, the largest deviation over
  the largest |state|, by layer.
* ``margins`` (bf16 weights, ``RUNS``' shapes): at every served position,
  the forward's top-1 minus top-2 logit, the served logits' largest
  deviation there, and whether the argmax agrees.  An argmax can flip only
  where the gap is at most twice the deviation.
"""
from __future__ import annotations

import json
import sys

import numpy as np
import torch

from repro_torch.configs.one_card import (FP32_RUNS, RUNS, attention_layers,
                                          one_card_config)
from repro_torch.configs.registry import get_smoke
from repro_torch.models import mamba2
from repro_torch.models.model_zoo import build_model
from repro_torch.runtime.serve import make_decode_step, make_prefill_step
from repro_torch.sharding.rules import ShardCtx

DEFAULT_ARCHS = ("mamba2-1.3b", "granite-moe-1b-a400m")
SMOKE_RUN = dict(batch=2, prompt=40, steps=6)


def _model(cfg, dev, dtype):
    model = build_model(cfg, device=dev, dtype=dtype)
    gen = torch.Generator(device=dev).manual_seed(0)
    return model.init_params(gen)


def _capture(model, store):
    """Hooks that append each block's input, cache view and output to
    ``store[layer]``; returns their handles."""
    def hook(li):
        def fn(module, args, kwargs, output):
            x, _, cache = args
            views = None if cache is None else {k: t.clone()
                                                for k, t in cache.items()}
            store.setdefault(li, []).append((x, views, output[0]))
        return fn
    return [blk.register_forward_hook(hook(li), with_kwargs=True)
            for li, blk in enumerate(model.blocks())]


@torch.no_grad()
def _serve(model, batch, prompt, steps, store=None):
    """The served run: logits (steps + 1, B, V) on the host, the fed-back
    tokens (B, steps) and the prompt (B, P)."""
    cfg, dev = model.cfg, model.device
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (batch, prompt))).to(dev)
    positions = torch.arange(prompt, device=dev).expand(batch, prompt)
    fp32 = model.embed.tok.dtype == torch.float32
    cache = model.init_cache(batch, prompt + steps,
                             dtype=torch.float32 if fp32 else None)
    ctx = ShardCtx(attn_impl="flash" if dev.type == "cuda" else "blocked")
    prefill, decode = make_prefill_step(model, ctx), make_decode_step(model,
                                                                      ctx)
    handles = [] if store is None else _capture(model, store)
    try:
        logits, cache = prefill(toks, positions, cache)
        out, fed = [logits[:, -1]], []
        tok = torch.argmax(logits[:, -1], dim=-1)
        for i in range(steps):
            fed.append(tok)
            pos = torch.full((batch,), prompt + i, dtype=torch.int64,
                             device=dev)
            logits, cache = decode(tok[:, None], pos, cache)
            out.append(logits[:, 0])
            tok = torch.argmax(logits[:, 0], dim=-1)
    finally:
        for h in handles:
            h.remove()
    fed = torch.stack(fed, dim=1) if fed else toks[:, :0]
    return torch.stack(out).cpu(), fed, toks


@torch.no_grad()
def _forward(model, toks, fed, store=None, nudge=False):
    """The model's own forward over prompt + fed tokens: logits at the
    served positions (steps + 1, B, V) on the host.  ``nudge`` moves the
    embedding's output by one fp32 rounding."""
    seq = torch.cat([toks, fed], dim=1)
    b, s = seq.shape
    positions = torch.arange(s, device=seq.device).expand(b, s)
    handles = [] if store is None else _capture(model, store)
    if nudge:
        gen = torch.Generator(device=seq.device).manual_seed(7)

        def move(module, args, output):
            sign = torch.randint(0, 2, output.shape, generator=gen,
                                 device=output.device) * 2 - 1
            return output * (1 + 2.0 ** -24 * sign)
        handles.append(model.embed.register_forward_hook(move))
    try:
        hidden = model.forward(seq, positions)["hidden"]
    finally:
        for h in handles:
            h.remove()
    return model.logits(hidden[:, toks.shape[1] - 1:]).movedim(1, 0).cpu()


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _layer_devs(served, fwd, prompt):
    """By layer: the served outputs against the forward's, relative to the
    largest |h| of the forward's, over prompt and decode positions."""
    rows = []
    for li in sorted(fwd):
        ref = fwd[li][0][2]
        got = served[li]
        pre = got[0][2]
        row = dict(layer=li, prompt=_rel(pre, ref[:, :prompt]))
        if len(got) > 1:
            dec = torch.cat([g[2] for g in got[1:]], dim=1)
            row["decode"] = _rel(dec, ref[:, prompt:prompt + dec.shape[1]])
        rows.append(row)
    return rows


@torch.no_grad()
def _recurrent(model, served):
    """Each Mamba layer's prefill input fed one token at a time through
    ``mamba_decode``: its states against the prefill's chunked ones."""
    rows = []
    for li, blk in enumerate(model.blocks()):
        if blk.kind.mixer != "mamba":
            continue
        x, before, _ = served[li][0]
        h = blk.norm1(x)
        cache = {k: torch.zeros_like(t) for k, t in before.items()}
        for i in range(h.shape[1]):
            mamba2.mamba_decode(blk.mixer.tree, h[:, i:i + 1], model.cfg,
                                cache)
        _, chunked = mamba2.mamba_forward(blk.mixer.tree, h, model.cfg,
                                          return_cache=True)
        rows.append(dict(layer=li, **{k: _rel(cache[k], chunked[k])
                                      for k in chunked}))
    return rows


def _margins(served, fwd):
    top2 = fwd.topk(2, dim=-1).values
    gap = (top2[..., 0] - top2[..., 1]).flatten()
    dev = (served - fwd).abs().amax(-1).flatten()
    agree = (served.argmax(-1) == fwd.argmax(-1)).flatten()
    near = gap <= 2 * dev
    return dict(
        positions=int(gap.numel()), argmax_agreement=float(
            agree.double().mean()),
        flips=int((~agree).sum()), flips_where_gap_exceeds_2dev=int(
            (~agree & ~near).sum()),
        positions_where_gap_at_most_2dev=int(near.sum()),
        gap_median=float(gap.median()), dev_median=float(dev.median()),
        dev_max=float(dev.max()),
        logit_std=float(fwd.std()), logit_max_abs=float(fwd.abs().max()))


def drift(arch, smoke=False):
    dev = torch.device("cpu" if smoke else "cuda")
    cfg32 = get_smoke(arch) if smoke else one_card_config(arch, fp32=True)
    f = SMOKE_RUN if smoke else FP32_RUNS[arch]
    out = dict(arch=arch, layers_in_run=cfg32.num_layers,
               attention_layers=attention_layers(cfg32), fp32_run=f)
    model = _model(cfg32, dev, torch.float32)
    served_h, fwd_h, nudged_h = {}, {}, {}
    logits, fed, toks = _serve(model, f["batch"], f["prompt"], f["steps"],
                               served_h)
    fwd = _forward(model, toks, fed, fwd_h)
    nudged = _forward(model, toks, fed, nudged_h, nudge=True)
    out["layers"] = _layer_devs(served_h, fwd_h, f["prompt"])
    out["rounding"] = _layer_devs(
        {li: [(None, None, h[0][2][:, :f["prompt"]]),
              (None, None, h[0][2][:, f["prompt"]:])]
         for li, h in nudged_h.items()}, fwd_h, f["prompt"])
    out["logits"] = dict(served_max_abs_dev=float((logits - fwd).abs().max()),
                         rounding_max_abs_dev=float((nudged - fwd).abs()
                                                    .max()),
                         max_abs=float(fwd.abs().max()),
                         std=float(fwd.std()))
    if any(b.kind.mixer == "mamba" for b in model.blocks()):
        out["recurrent"] = _recurrent(model, served_h)
    del model, served_h, fwd_h, nudged_h
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    cfg16 = get_smoke(arch) if smoke else one_card_config(arch)
    f = SMOKE_RUN if smoke else RUNS[arch]
    model = _model(cfg16, dev, None)
    logits, fed, toks = _serve(model, f["batch"], f["prompt"], f["steps"])
    out["margins"] = dict(bf16_run=f, **_margins(
        logits, _forward(model, toks, fed)))
    del model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    smoke = "--smoke" in argv
    archs = [a for a in argv if a != "--smoke"] or list(DEFAULT_ARCHS)
    if not smoke:
        from repro_torch.device import nvidia_smi_line
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(json.dumps({"card": nvidia_smi_line()}), flush=True)
    for arch in archs:
        print(json.dumps(drift(arch, smoke)), flush=True)


if __name__ == "__main__":
    main()
