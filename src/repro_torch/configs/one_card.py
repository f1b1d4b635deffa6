"""The decoder-only families served on one 80 GB card.

Each family runs at its published widths; only depth is cut, and only
where one card's memory forces it (``one_card_config``: a
``dataclasses.replace`` of the registry's config, each cut with its
reason).  ``RUNS`` gives each family's serving run in bf16 weights (fp32
norms, router and SSM scalars): B prompts of P tokens, then N greedy
decode steps.  ``FP32_RUNS`` gives the fp32 runs that hold the serving
steps to the model's own forward; fp32 weights take twice the memory, so
jamba and deepseek are cut further there.

``chip_smoke.py`` (phase ``families_full``),
``scripts/torch_profile_decode.py families`` and
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
    return cfg


def attention_layers(cfg: ArchConfig) -> int:
    """The blocks of ``cfg`` whose mixer is attention: K3's launches in
    one prefill with ``attn_impl="flash"``."""
    return sum(g.repeat * sum(b.mixer == "attn" for b in g.blocks)
               for g in cfg.groups)
