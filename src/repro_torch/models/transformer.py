"""Decoder-only LM stack over layer groups.

A *group* is a repeated sequence of blocks.  The reference stacks each
group's parameters on a leading "layers" dim and scans them; here a group
is an ``nn.ModuleList`` of ``repeat`` block tuples, walked by a Python
loop.  ``LM.specs()`` still reports the reference's stacked shapes, which
is what ``models/convert.py`` checks a foreign parameter tree against.

The port has the homogeneous attention + MLP block.  MLA, Mamba and MoE
blocks, and the ring-cache ``prefill``/``decode`` entry points, follow
with their slices; the paged serving path drives the blocks itself
(``serving/engine.py``).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig, Block
from repro_torch.models import attention as attn
from repro_torch.models.layers import (MLP, Embedding, Norm, SpecModule,
                                       embed_specs, lm_logits, mlp_specs,
                                       norm_specs)
from repro_torch.models.params import stack_specs


# ----------------------------------------------------------------- specs ---
def block_specs(cfg: ArchConfig, blk: Block) -> dict:
    sp: dict = {"norm1": norm_specs(cfg.d_model, cfg.norm)}
    if blk.mixer == "attn":
        sp["mixer"] = attn.attention_specs(cfg)
    else:
        raise NotImplementedError(
            f"mixer {blk.mixer!r} is not ported yet (see ROADMAP.md)")
    if blk.ffn == "moe":
        raise NotImplementedError("MoE ffn is not ported yet (see ROADMAP.md)")
    if blk.ffn != "none":
        sp["norm2"] = norm_specs(cfg.d_model, cfg.norm)
        sp["ffn"] = mlp_specs(cfg, cfg.d_ff)
    return sp


class TransformerBlock(nn.Module):
    """Parameters of one pre-norm residual block: norm1 -> mixer, norm2 ->
    ffn.  The serving engine walks the blocks itself, because it writes
    each layer's K/V into the paged pool between projection and
    attention."""

    def __init__(self, cfg: ArchConfig, blk: Block, *, device, dtype):
        super().__init__()
        block_specs(cfg, blk)            # raises on what is not ported
        kw = dict(device=device, dtype=dtype)
        self.norm1 = Norm(cfg.d_model, cfg.norm, cfg.norm_eps, **kw)
        self.mixer = attn.Attention(cfg, **kw)
        if blk.ffn != "none":
            self.norm2 = Norm(cfg.d_model, cfg.norm, cfg.norm_eps, **kw)
            self.ffn = MLP(cfg, cfg.d_ff, **kw)


# -------------------------------------------------------------- LM model ---
class LM(nn.Module):
    """Decoder-only language model."""

    def __init__(self, cfg: ArchConfig, *, device: torch.device,
                 dtype: torch.dtype | None = None):
        """Parameters are allocated on ``device`` and left uninitialised:
        call :meth:`init_params` or load them (``models/convert.py``).
        ``dtype=None`` keeps the specs' dtypes, a dtype casts all to it."""
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        self.embed = Embedding(cfg, **kw)
        # groups[gi][layer][bi]: layer-major, the order a forward walks
        self.groups = nn.ModuleList(
            nn.ModuleList(
                nn.ModuleList(TransformerBlock(cfg, b, **kw)
                              for b in g.blocks)
                for _ in range(g.repeat))
            for g in cfg.groups)
        self.final_norm = Norm(cfg.d_model, cfg.norm, cfg.norm_eps, **kw)

    # ---- parameter declarations ----
    def specs(self) -> dict:
        """The reference's parameter tree, as ParamSpecs (stacked layers)."""
        cfg = self.cfg
        groups = []
        for g in cfg.groups:
            blocks = tuple(stack_specs(block_specs(cfg, b), g.repeat)
                           for b in g.blocks)
            groups.append({"blocks": blocks})
        return {
            "embed": embed_specs(cfg),
            "groups": tuple(groups),
            "final_norm": norm_specs(cfg.d_model, cfg.norm),
        }

    def init_params(self, generator: torch.Generator | None = None) -> "LM":
        """Seeded random init, drawn on the parameters' device.  The
        generator must live on that device."""
        for m in self.modules():
            if isinstance(m, SpecModule):
                m.init_own_params(generator)
        return self

    @property
    def device(self) -> torch.device:
        return self.embed.tok.device

    def blocks(self) -> list[TransformerBlock]:
        """All blocks in forward order."""
        return [b for g in self.groups for layer in g for b in layer]

    # ---- embedding / head ----
    def lm_head_weight(self) -> torch.Tensor:
        w = getattr(self.embed, "lm_head", None)
        return self.embed.tok.T if w is None else w

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return lm_logits(hidden, self.embed.tok,
                         getattr(self.embed, "lm_head", None))
