"""The model families served on one 80 GB card.

Each family runs at its published widths; only depth is cut, and only
where one card's memory forces it (``one_card_config``: a
``dataclasses.replace`` of the registry's config, each cut with its
reason).  ``RUNS`` gives each family's serving run in bf16 weights (fp32
norms, router and SSM scalars): B prompts of P tokens, then N greedy
decode steps.  ``FP32_RUNS`` gives the fp32 runs that hold the serving
steps to the model's own forward; fp32 weights take twice the memory, so
jamba and deepseek are cut further there.

``ENCDEC_RUNS`` and ``ENCDEC_FP32_RUNS`` do the same for the
encoder-decoder (whisper-small: B clips of ``frames`` encoder frames, a
decoder prompt of whisper's four start tokens) and the vision-frontend
model (internvl2-26b: B rows of ``patches`` patch embeddings before
``prompt`` text tokens); ``prompt_inputs`` makes a run's seeded inputs.

``TRAIN_RUNS`` gives each family's training run on one card (phase
``train_families_full``): the fused step keeps the parameters, the fp32
master, both moments and the gradients on the card, ~16-20 bytes a
parameter, so ``one_card_train_config`` cuts internvl2 and deepseek deeper
than serving does.

``chip_smoke.py`` (phases ``families_full``, ``encdec_full``,
``train_families_full``),
``scripts/torch_profile_decode.py families encdec`` and
``scripts/torch_family_drift.py`` run these.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig, Block, LayerGroup
from repro_torch.configs.registry import get_config

FAMILY_ARCHS = ("qwen2-7b", "qwen3-32b", "granite-moe-1b-a400m",
                "mamba2-1.3b", "jamba-1.5-large-398b", "deepseek-v3-671b")

RUNS = {
    "granite-moe-1b-a400m": dict(batch=4, prompt=2048, steps=32),
    "mamba2-1.3b": dict(batch=4, prompt=2048, steps=32),
    "qwen2-7b": dict(batch=4, prompt=2048, steps=32),
    "qwen3-32b": dict(batch=1, prompt=2048, steps=16),
    "jamba-1.5-large-398b": dict(batch=1, prompt=2048, steps=16),
    "deepseek-v3-671b": dict(batch=1, prompt=1024, steps=16),
}

ENCDEC_ARCHS = ("whisper-small", "internvl2-26b")

ENCDEC_RUNS = {
    "whisper-small": dict(batch=16, frames=1500, prompt=4, steps=124),
    "internvl2-26b": dict(batch=2, patches=1024, prompt=1024, steps=32),
}

ENCDEC_FP32_RUNS = {
    "whisper-small": dict(batch=2, frames=1500, prompt=4, steps=16),
    "internvl2-26b": dict(batch=1, patches=256, prompt=256, steps=8),
}

#: whisper's decoder prompt: <|startoftranscript|> <|en|> <|transcribe|>
#: <|notimestamps|>
WHISPER_PROMPT = (50258, 50259, 50359, 50363)

FP32_RUNS = {
    "granite-moe-1b-a400m": dict(batch=2, prompt=512, steps=16),
    "mamba2-1.3b": dict(batch=2, prompt=512, steps=16),
    "jamba-1.5-large-398b": dict(batch=1, prompt=256, steps=8),
    "deepseek-v3-671b": dict(batch=1, prompt=256, steps=8),
}


def one_card_config(arch: str, fp32: bool = False) -> ArchConfig:
    """The registry's config of ``arch``, cut in depth only where one
    card's 80 GB forces it (for fp32 weights when ``fp32``)."""
    cfg = get_config(arch)
    if arch == "jamba-1.5-large-398b":
        blocks = cfg.groups[0].blocks
        # one period of 8 is ~88 GB in bf16: keep blocks 0-4 of it
        # (mamba/mlp, mamba/moe, mamba/mlp, mamba/moe, attn/mlp), every
        # block kind the model has: 24.05 G parameters.  In fp32 keep
        # blocks 3-4 (mamba/moe, attn/mlp), still every mixer and ffn kind
        # but the plain MLP after a Mamba mixer: 11.91 G (47.7 GB)
        period = blocks[3:5] if fp32 else blocks[:5]
        return dataclasses.replace(cfg, num_layers=len(period),
                                   groups=(LayerGroup(1, period),))
    if arch == "deepseek-v3-671b":
        # the 3 leading dense MLA layers and 1 MLA + MoE layer with all 256
        # experts and the shared expert (15.11 G parameters); in fp32 the
        # MLA + MoE layer alone (13.36 G, 53.4 GB; the dense layers' MLP is
        # every dense family's).  No MTP head: serving never reads it (the
        # CPU tests hold it)
        moe = LayerGroup(1, (Block("mla", "moe"),))
        groups = (moe,) if fp32 else (LayerGroup(3, (Block("mla", "mlp"),)),
                                      moe)
        return dataclasses.replace(cfg, num_layers=sum(g.repeat
                                                       for g in groups),
                                   mtp_depth=0, groups=groups)
    if arch == "internvl2-26b" and fp32:
        # 48 layers are 79.4 GB in fp32 (19.86 G parameters): keep the
        # first 24 (10.50 G, 42.0 GB), every layer the same kind
        return dataclasses.replace(cfg, num_layers=24, groups=(
            LayerGroup(24, cfg.groups[0].blocks),))
    return cfg


def prompt_inputs(cfg: ArchConfig, run: dict, device, seed: int = 0):
    """A serving run's seeded inputs on ``device``: ``tokens`` (B, P),
    ``positions`` (B, P[+N]), ``embeds`` (the frames or patches, bf16, or
    None), ``cache_kw`` for ``init_cache`` and ``start``, the first
    decode position.  Text tokens come from a numpy generator, the
    embeddings from a generator on ``device``."""
    import numpy as np
    import torch

    from repro_torch.models import frontend
    b, p = run["batch"], run["prompt"]
    gen = torch.Generator(device=device).manual_seed(seed)
    if cfg.is_encoder_decoder:
        ids = (WHISPER_PROMPT if p == len(WHISPER_PROMPT)
               and cfg.vocab_size > max(WHISPER_PROMPT)
               else np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                        p))
        tokens = torch.tensor(ids, device=device).expand(b, p)
        embeds = frontend.make_fake_embeds(cfg, b, run["frames"], gen,
                                           device)
        return dict(tokens=tokens, embeds=embeds, start=p,
                    positions=torch.arange(p, device=device).expand(b, p),
                    cache_kw=dict(enc_len=run["frames"]))
    n = run.get("patches", 0)
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, p))).to(device)
    embeds = (frontend.make_fake_embeds(cfg, b, n, gen, device) if n
              else None)
    return dict(tokens=tokens, embeds=embeds, start=n + p,
                positions=torch.arange(n + p, device=device).expand(b, n + p),
                cache_kw={})


def attention_layers(cfg: ArchConfig) -> int:
    """The blocks of ``cfg`` whose mixer is attention: K3's launches in
    one prefill with ``attn_impl="flash"``."""
    return sum(g.repeat * sum(b.mixer == "attn" for b in g.blocks)
               for g in cfg.groups)


#: the training runs on one card: B sequences of ``seq`` tokens (whisper:
#: ``seq`` encoder frames and ``dec`` decoder tokens; internvl2: ``seq``
#: positions of which the first 1,024 are patch embeddings), 2 microbatches,
#: remat on and the cross-entropy chunk as the reference's dry-run plans
#: set them; ``accum`` the microbatches' gradient dtype
TRAIN_RUNS = {
    "granite-moe-1b-a400m": dict(batch=4, seq=2048, xent_chunk=512,
                                 accum="float32"),
    "mamba2-1.3b": dict(batch=4, seq=2048, xent_chunk=512,
                        accum="float32"),
    "whisper-small": dict(batch=8, seq=1500, xent_chunk=512,
                          accum="float32"),
    "internvl2-26b": dict(batch=2, seq=2048, xent_chunk=256,
                          accum="float32"),
    "deepseek-v3-671b": dict(batch=2, seq=2048, xent_chunk=256,
                             accum="bfloat16", two_phase=True),
}


def one_card_train_config(arch: str) -> ArchConfig:
    """The registry's config of ``arch``, cut in depth where one card's
    80 GB does not hold a fused training step (``TRAIN_RUNS``)."""
    cfg = get_config(arch)
    if arch == "internvl2-26b":
        # 48 layers are 19.86 G parameters (~360 GB in a fused step): keep
        # 4 (2.70 G with the 1.14 G embedding and head, ~49 GB of state)
        return dataclasses.replace(cfg, num_layers=4, groups=(
            LayerGroup(4, cfg.groups[0].blocks),))
    if arch == "deepseek-v3-671b":
        # one dense MLA layer and the MTP head, whose block follows the
        # last layer's kind: a dense MLA block, not the 256 experts (11.3 G
        # parameters, ~200 GB in a fused step).  3.12 G parameters, ~50 GB
        # of state with bf16 gradients; the 3 dense layers (4.29 G, ~69 GB
        # of state before activations) do not leave the fused step room
        dense = LayerGroup(1, (Block("mla", "mlp"),))
        return dataclasses.replace(cfg, num_layers=1, groups=(dense,))
    return cfg
