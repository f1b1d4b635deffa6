"""Decoder-only LM stack over layer groups.

A *group* is a repeated sequence of blocks.  The reference stacks each
group's parameters on a leading "layers" dim and scans them; here a group
is an ``nn.ModuleList`` of ``repeat`` block tuples, walked by a Python
loop.  ``LM.specs()`` still reports the reference's stacked shapes, which
is what ``models/convert.py`` checks a foreign parameter tree against.
The ring cache keeps the reference's stacked layout,
``{"groups": ({"blocks": ({"k": (L,B,W,Hkv,D), "v": ..., "pos": (L,B,W)},)},)}``,
and a layer works on its ``[layer]`` views, so updates land in place.

Entry points:
  forward  — training (no cache), returns hidden states + aux loss
  prefill  — forward + bulk cache fill, returns hidden states + cache
  decode   — single-token step over the cache
The paged serving path drives the blocks itself (``serving/engine.py``).
The port has the homogeneous attention + MLP block; MLA, Mamba and MoE
blocks and the multi-token-prediction head follow with their slices.
With ``ShardCtx.remat`` the training forward keeps no activations inside a
layer: each layer runs under ``torch.utils.checkpoint`` and is recomputed
in the backward (the reference's ``jax.checkpoint(nothing_saveable)``).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, Block
from repro_torch.models import attention as attn
from repro_torch.models.layers import (MLP, Embedding, Norm, SpecModule,
                                       embed_specs, lm_logits, mlp_specs,
                                       norm_specs)
from repro_torch.models.params import map_with_path, stack_specs
from repro_torch.sharding.rules import ShardCtx

_NULL_CTX = ShardCtx()


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


def block_cache_specs(cfg: ArchConfig, blk: Block, batch: int,
                      max_len: int) -> dict:
    if blk.mixer == "attn":
        return attn.kv_cache_specs(cfg, batch, max_len)
    raise NotImplementedError(
        f"mixer {blk.mixer!r} is not ported yet (see ROADMAP.md)")


def cache_specs(cfg: ArchConfig, batch: int, max_len: int) -> dict:
    """The reference's ring-cache tree, as ParamSpecs (stacked layers)."""
    groups = []
    for g in cfg.groups:
        blocks = tuple(
            stack_specs(block_cache_specs(cfg, b, batch, max_len), g.repeat)
            for b in g.blocks)
        groups.append({"blocks": blocks})
    return {"groups": tuple(groups)}


class TransformerBlock(nn.Module):
    """One pre-norm residual block: norm1 -> mixer, norm2 -> ffn.  The
    paged serving engine walks the blocks' parts itself, because it writes
    each layer's K/V into the paged pool between projection and
    attention; the ring-cache entry points call the block."""

    def __init__(self, cfg: ArchConfig, blk: Block, *, device, dtype):
        super().__init__()
        block_specs(cfg, blk)            # raises on what is not ported
        self.kind = blk
        kw = dict(device=device, dtype=dtype)
        self.norm1 = Norm(cfg.d_model, cfg.norm, cfg.norm_eps, **kw)
        self.mixer = attn.Attention(cfg, **kw)
        if blk.ffn != "none":
            self.norm2 = Norm(cfg.d_model, cfg.norm, cfg.norm_eps, **kw)
            self.ffn = MLP(cfg, cfg.d_ff, **kw)

    def _apply_mixer(self, h, positions, cache: dict | None, ctx: ShardCtx,
                     mode: str):
        """mode: train | prefill | decode.  Returns y; the cache (None in
        train mode) is updated in place."""
        if mode == "train":
            y = attn.attn_forward(self.mixer, h, positions,
                                  impl=ctx.attn_impl)
        elif mode == "prefill":
            y, _ = attn.attn_prefill(self.mixer, h, cache, positions,
                                     impl=ctx.attn_impl)
        elif mode == "decode":
            y, _ = attn.attn_decode(self.mixer, h, cache, positions)
        else:
            raise ValueError(f"mode {mode!r}; one of train, prefill, decode")
        return y

    def forward(self, x, positions, cache: dict | None, *, ctx: ShardCtx,
                mode: str):
        """Pre-norm residual block over ``cache``, this layer's views (None
        in train mode)."""
        x = x + self._apply_mixer(self.norm1(x), positions, cache, ctx, mode)
        if self.kind.ffn != "none":
            x = x + self.ffn(self.norm2(x))
        return x


def apply_block(block: TransformerBlock, x, positions, ctx: ShardCtx,
                cache: dict | None = None, mode: str = "train"):
    """The reference's ``apply_block`` over one block module: the pre-norm
    residual block.  Returns ``(x, aux, cache)``; aux is 0 without MoE."""
    x = block(x, positions, cache, ctx=ctx, mode=mode)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux, cache


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

    def cache_specs(self, batch: int, max_len: int) -> dict:
        return cache_specs(self.cfg, batch, max_len)

    def init_cache(self, batch: int, max_len: int,
                   dtype: torch.dtype | None = None) -> dict:
        """An empty ring cache on the model's device: K/V zeros, every
        ``pos`` -1.  ``dtype=None`` keeps the specs' bf16 K/V, a dtype
        casts them to it; ``pos`` stays int32."""
        def make(path, spec):
            if path[-1] == "pos":
                return torch.full(spec.shape, -1, dtype=spec.dtype,
                                  device=self.device)
            return torch.zeros(spec.shape, dtype=dtype or spec.dtype,
                               device=self.device)
        return map_with_path(make, self.cache_specs(batch, max_len))

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

    # ---- embedding / head (``self.embed(tokens, embeds)``: Embedding) ----
    def lm_head_weight(self) -> torch.Tensor:
        w = getattr(self.embed, "lm_head", None)
        return self.embed.tok.T if w is None else w

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return lm_logits(hidden, self.embed.tok,
                         getattr(self.embed, "lm_head", None))

    # ---- stacks ----
    def _run_groups(self, x, positions, ctx: ShardCtx, cache: dict | None,
                    mode: str):
        """Every block in order.  Train mode takes no cache; with
        ``ctx.remat`` each layer is recomputed in the backward."""
        remat = mode == "train" and ctx.remat
        for gi, group in enumerate(self.groups):
            gc = None if cache is None else cache["groups"][gi]["blocks"]
            for li, layer in enumerate(group):
                for bi, blk in enumerate(layer):
                    views = (None if gc is None else
                             {name: t[li] for name, t in gc[bi].items()})
                    if remat:
                        x = checkpoint(blk, x, positions, views, ctx=ctx,
                                       mode=mode, use_reentrant=False)
                    else:
                        x = blk(x, positions, views, ctx=ctx, mode=mode)
            x = ctx.constrain(x)
        return x

    # ---- public entry points ----
    def forward(self, tokens, positions, ctx: ShardCtx = _NULL_CTX,
                embeds=None) -> dict:
        """Training forward (no cache).  tokens: (B,S); positions:
        (B,S[+N]) covering ``embeds``' N rows, which come first.  Returns
        ``{"hidden": (B,S[+N],d), "aux": 0}``.  The multi-token-prediction
        head (``mtp_depth``, deepseek-v3) is not ported yet."""
        if self.cfg.mtp_depth:
            raise NotImplementedError(
                "the multi-token-prediction head is not ported yet "
                "(see ROADMAP.md, M14)")
        x = self.embed(tokens, embeds)
        x = self._run_groups(x, positions, ctx, None, "train")
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return {"hidden": self.final_norm(x), "aux": aux}

    def prefill(self, tokens, positions, cache: dict,
                ctx: ShardCtx = _NULL_CTX, embeds=None):
        """Process the prompt, fill the cache in place.  tokens: (B,S);
        positions: (B,S).  Returns (hidden, cache, aux); aux is 0 without
        MoE blocks."""
        x = self.embed(tokens, embeds)
        x = self._run_groups(x, positions, ctx, cache, "prefill")
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return self.final_norm(x), cache, aux

    def decode(self, tokens, positions, cache: dict,
               ctx: ShardCtx = _NULL_CTX):
        """One token per sequence. tokens: (B,1); positions: (B,).
        Returns (logits (B,1,V) fp32, cache); the cache is written in
        place."""
        x = self.embed(tokens)
        x = self._run_groups(x, positions, ctx, cache, "decode")
        return self.logits(self.final_norm(x)), cache
