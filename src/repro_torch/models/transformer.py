"""Decoder-only LM stack over layer groups.

A *group* is a repeated sequence of blocks (jamba's attn:mamba period of
8 is one group of 8 blocks; homogeneous archs are one group of one
block).  The reference stacks each group's parameters on a leading
"layers" dim and scans them; here a group is an ``nn.ModuleList`` of
``repeat`` block tuples, walked by a Python loop.  ``LM.specs()`` still
reports the reference's stacked shapes, which is what
``models/convert.py`` checks a foreign parameter tree against.  The cache
keeps the reference's stacked layout, one entry a block of the group:
``{"groups": ({"blocks": (cache of block 0, ...)},)}`` with a ring
cache ``{"k": (L,B,W,Hkv,D), "v": ..., "pos": (L,B,W)}`` for attention,
the latent cache ``{"c_kv", "k_rope", "pos"}`` for MLA and the conv and
SSM states ``{"conv_x", "conv_B", "conv_C", "ssm"}`` for Mamba (no
``pos``); a layer works on its ``[layer]`` views, so updates land in
place.

Entry points:
  forward  — training (no cache), returns hidden states + aux loss (and
             the multi-token-prediction hidden states where the config
             has ``mtp_depth``)
  prefill  — forward + bulk cache fill, returns hidden states + cache
  decode   — single-token step over the cache
The paged serving path drives attention blocks itself
(``serving/engine.py``).  With ``ShardCtx.remat`` the training forward
keeps no activations inside a layer: each layer runs under
``torch.utils.checkpoint`` and is recomputed in the backward (the
reference's ``jax.checkpoint(nothing_saveable)``; no block draws random
numbers, so no RNG state is saved for the recompute).

On a mesh (M18), ``forward``, ``prefill``, ``decode`` and ``logits`` take
``params=``, the model's parameters placed by name on the mesh
(``sharding/spmd.py``), and placed inputs; the model's own parameters are
then never read (they may lie on the meta device).  Each coordinate runs
its blocks: the embedding's d-slice then an all-gather over the model
axis, attention on its query heads (``attention.attn_local``; K3 in a
flash prefill, once a coordinate), MLA on its heads with the latents
computed whole (``mla.mla_placed``), Mamba-2 on its inner channels and
heads with B and C whole and the gated norm's sum of squares summed over
the model axis (``mamba2.mamba_placed``), SwiGLU on its ff columns, each
followed by a ``psum`` over the model axis where the heads, channels or
ff split, the weights' "embed" dim gathered over the data axes first
(FSDP); an MoE ffn by ``moe.moe_placed`` (its experts over the model
axis, its aux losses summed as here); norms and the residual stream are
replicated over the model axis, the batch split over the batch axes
where it splits (at batch 1 every coordinate holds the row).  A ring or
latent cache whose slots split over mesh axes (SP,
``ShardCtx.seq_shard_kv``) goes through ``attention.attn_seq_sharded``
or ``mla.mla_placed``'s merge.  The MTP head runs on the placed hidden
states (``_mesh_mtp``).  Every decoder-only family runs there
(``is_placed_family``, ``mesh_family_check``), the vision frontend
too: its patch rows (placed ``embeds``) go before each coordinate's token
embeddings.  The encoder-decoder's placed run is ``models/encdec.py``'s,
on this module's pieces.  A replicated bias after a split product (the
gelu MLP's and the attention's ``bo``) is added once, after the ``psum``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, Block
from repro_torch.models import attention as attn
from repro_torch.models import mamba2, mla, moe
from repro_torch.models.layers import (MLP, Embedding, Norm, SpecModule,
                                       apply_mlp, apply_norm, embed_specs,
                                       lm_logits, mlp_specs, norm_specs)
from repro_torch.models.params import ParamSpec, map_with_path, stack_specs
from repro_torch.sharding import spmd
from repro_torch.sharding.rules import P, NamedSharding, ShardCtx

_NULL_CTX = ShardCtx()


# ----------------------------------------------------------------- specs ---
def block_specs(cfg: ArchConfig, blk: Block) -> dict:
    sp: dict = {"norm1": norm_specs(cfg.d_model, cfg.norm)}
    if blk.mixer == "attn":
        sp["mixer"] = attn.attention_specs(cfg)
    elif blk.mixer == "mla":
        sp["mixer"] = mla.mla_specs(cfg)
    elif blk.mixer == "mamba":
        sp["mixer"] = mamba2.mamba_specs(cfg)
    else:
        raise ValueError(blk.mixer)
    if blk.ffn != "none":
        sp["norm2"] = norm_specs(cfg.d_model, cfg.norm)
        sp["ffn"] = (moe.moe_specs(cfg) if blk.ffn == "moe"
                     else mlp_specs(cfg, cfg.d_ff))
    return sp


def block_cache_specs(cfg: ArchConfig, blk: Block, batch: int,
                      max_len: int) -> dict:
    if blk.mixer == "attn":
        return attn.kv_cache_specs(cfg, batch, max_len)
    if blk.mixer == "mla":
        return mla.mla_cache_specs(cfg, batch, max_len)
    return mamba2.mamba_cache_specs(cfg, batch)


def cache_specs(cfg: ArchConfig, batch: int, max_len: int) -> dict:
    """The reference's cache tree, as ParamSpecs (stacked layers)."""
    groups = []
    for g in cfg.groups:
        blocks = tuple(
            stack_specs(block_cache_specs(cfg, b, batch, max_len), g.repeat)
            for b in g.blocks)
        groups.append({"blocks": blocks})
    return {"groups": tuple(groups)}


def lm_specs(cfg: ArchConfig) -> dict:
    """The reference's parameter tree, as ParamSpecs (stacked layers),
    without allocating anything."""
    groups = []
    for g in cfg.groups:
        blocks = tuple(stack_specs(block_specs(cfg, b), g.repeat)
                       for b in g.blocks)
        groups.append({"blocks": blocks})
    sp = {
        "embed": embed_specs(cfg),
        "groups": tuple(groups),
        "final_norm": norm_specs(cfg.d_model, cfg.norm),
    }
    if cfg.mtp_depth:  # DeepSeek multi-token prediction head
        sp["mtp"] = {
            "proj": _mtp_proj_spec(cfg),
            "block": block_specs(cfg, cfg.groups[-1].blocks[-1]),
            "norm": norm_specs(cfg.d_model, cfg.norm),
        }
    return sp


def _mtp_proj_spec(cfg: ArchConfig) -> ParamSpec:
    return ParamSpec((2 * cfg.d_model, cfg.d_model), torch.bfloat16,
                     ("embed", None))


_MIXERS = {"attn": attn.Attention, "mla": mla.MLA, "mamba": mamba2.Mamba}


class TransformerBlock(nn.Module):
    """One pre-norm residual block: norm1 -> mixer (attention, MLA or
    Mamba-2), norm2 -> ffn (MLP or MoE).  The paged serving engine walks
    an attention block's parts itself, because it writes each layer's K/V
    into the paged pool between projection and attention; the ring-cache
    entry points call the block."""

    def __init__(self, cfg: ArchConfig, blk: Block, *, device, dtype):
        super().__init__()
        if blk.mixer not in _MIXERS:
            raise ValueError(blk.mixer)
        self.kind = blk
        kw = dict(device=device, dtype=dtype)
        self.norm1 = Norm(cfg.d_model, cfg.norm, cfg.norm_eps, **kw)
        self.mixer = _MIXERS[blk.mixer](cfg, **kw)
        if blk.ffn != "none":
            self.norm2 = Norm(cfg.d_model, cfg.norm, cfg.norm_eps, **kw)
            self.ffn = (moe.MoE(cfg, **kw) if blk.ffn == "moe"
                        else MLP(cfg, cfg.d_ff, **kw))

    def _apply_mixer(self, h, positions, cache: dict | None, ctx: ShardCtx,
                     mode: str):
        """mode: train | prefill | decode.  Returns y; the cache (None in
        train mode) is updated in place."""
        if mode == "train":
            return self.mixer(h, positions, ctx.attn_impl)
        if mode == "prefill":
            return self.mixer.prefill(h, cache, positions, ctx.attn_impl)
        if mode == "decode":
            return self.mixer.decode(h, cache, positions)
        raise ValueError(f"mode {mode!r}; one of train, prefill, decode")

    def forward(self, x, positions, cache: dict | None, *, ctx: ShardCtx,
                mode: str):
        """Pre-norm residual block over ``cache``, this layer's views (None
        in train mode).  Returns ``(x, aux)``; aux is the MoE's load-balance
        and z loss, None without one (no zero tensor a layer a step)."""
        x = x + self._apply_mixer(self.norm1(x), positions, cache, ctx, mode)
        aux = None
        if self.kind.ffn == "moe":
            cf = ctx.moe_decode_cf if mode == "decode" else None
            y, aux = self.ffn(self.norm2(x), ctx, cf)
            x = x + y
        elif self.kind.ffn != "none":
            x = x + self.ffn(self.norm2(x))
        return x, aux


def apply_block(block: TransformerBlock, x, positions, ctx: ShardCtx,
                cache: dict | None = None, mode: str = "train"):
    """The reference's ``apply_block`` over one block module: the pre-norm
    residual block.  Returns ``(x, aux, cache)``; aux is 0 without MoE."""
    x, aux = block(x, positions, cache, ctx=ctx, mode=mode)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux, cache


class MTPHead(SpecModule):
    """DeepSeek's multi-token-prediction head: ``proj`` maps
    [h_i ; emb(t_{i+1})] to d, one block of the last group's last kind,
    and a norm (the reference's unstacked ``mtp`` subtree)."""

    def __init__(self, cfg: ArchConfig, *, device, dtype):
        kw = dict(device=device, dtype=dtype)
        super().__init__({"proj": _mtp_proj_spec(cfg)}, **kw)
        self.block = TransformerBlock(cfg, cfg.groups[-1].blocks[-1], **kw)
        self.norm = Norm(cfg.d_model, cfg.norm, cfg.norm_eps, **kw)


# -------------------------------------------------------- on a mesh (M18) --
def is_placed_family(cfg: ArchConfig) -> bool:
    """A stack the sharded steps place: a decoder-only stack whose blocks
    are attention, MLA or Mamba-2, each with an MLP (SwiGLU, or gelu with
    biases), an MoE ffn or none, an MTP head or a vision frontend where it
    has one (the dense decoder and the MoE, MLA, Mamba-2, hybrid and
    vision families), or the encoder-decoder's attention and MLP
    blocks."""
    if cfg.is_encoder_decoder:
        return all(b.mixer == "attn" and b.ffn == "mlp"
                   for g in cfg.groups for b in g.blocks)
    return (cfg.frontend in (None, "vision")
            and all(b.mixer in ("attn", "mla", "mamba")
                    and b.ffn in ("mlp", "moe", "none")
                    for g in cfg.groups for b in g.blocks))


def mesh_family_check(cfg: ArchConfig, what: str, ctx: ShardCtx) -> None:
    """Raise ``NotImplementedError`` unless the sharded steps place
    ``cfg`` (:func:`is_placed_family`), ``ValueError`` where ``ctx``'s
    rules split a Mamba mixer's inner channels and heads unalike
    (``mamba2.check_split``)."""
    if not is_placed_family(cfg):
        raise NotImplementedError(
            f"{what}: {cfg.name} ({cfg.family}) on a mesh; the sharded "
            "steps place attention, MLA and Mamba-2 blocks with an MLP, an "
            "MoE ffn or none, and the encoder-decoder's attention and MLP "
            "blocks")
    if any(b.mixer == "mamba" for g in cfg.groups for b in g.blocks):
        mamba2.check_split(cfg, ctx)


def _norm_blocks(params: dict, prefix: str, x, cfg: ArchConfig) -> list:
    """The replicated norm of every rank's residual stream, each with its
    own block of the scale (the replicas' partial gradients are summed
    after the backward, ``spmd.sum_replicas``)."""
    scale = params[prefix + "scale"].blocks
    bias = params.get(prefix + "bias")
    return [apply_norm(t, scale[r], None if bias is None else bias.blocks[r],
                       cfg.norm, cfg.norm_eps) for r, t in enumerate(x)]


#: each mixer's leaf whose dim splits its heads over the model axis
_HEADS_LEAF = {"attn": ("wq", 1), "mla": ("w_q_up", 1), "mamba": ("A_log", 0)}


def local_weights(bp: dict, prefix: str, ctx: ShardCtx) -> list[dict]:
    """Each coordinate's weights of the sub-module ``prefix`` by short
    name, gathered whole on every dim sharded outside the model axis
    (FSDP)."""
    w = {k[len(prefix):]: spmd.unshard(p, (ctx.model_axis,))
         for k, p in bp.items() if k.startswith(prefix)}
    n = len(next(iter(w.values())))
    return [{k: v[r] for k, v in w.items()} for r in range(n)]


def heads_first(p: spmd.Placed, dim: int, ctx: ShardCtx):
    """Whether ``p``'s heads (dimension ``dim``) split over the model
    axis, and each coordinate's first head."""
    ma = ctx.model_axis
    split = spmd.sharded_over(p, ma) is not None
    per = p.blocks[0].shape[dim]
    return split, ([j * per for j in spmd.axis_index(ctx.mesh, ma)]
                   if split else [0] * len(p.blocks))


def add_bias_once(y: list, bp: dict, name: str) -> list:
    """``y`` (every coordinate's whole output, after the sum over the model
    axis) plus the replicated bias ``bp[name]`` where the block has one:
    each coordinate adds its own block (its gradient summed over the
    replicas after the backward, ``spmd.sum_replicas``)."""
    bias = bp.get(name)
    if bias is None:
        return y
    return [a + b.to(a.dtype) for a, b in zip(y, bias.blocks)]


def mesh_mlp(bp: dict, prefix: str, h: list, ctx: ShardCtx) -> list:
    """The MLP ``prefix`` on every coordinate's ff columns (SwiGLU, or gelu
    with ``bi`` split with its columns), its weights gathered whole on
    "embed" (FSDP), the partial outputs summed over the model axis where
    ff splits, then ``bo`` added once."""
    y = [apply_mlp(h[r], **{k: v for k, v in w.items() if k != "bo"})
         for r, w in enumerate(local_weights(bp, prefix, ctx))]
    if spmd.sharded_over(bp[prefix + "wo"], ctx.model_axis) is not None:
        y = spmd.psum(y, ctx.mesh, ctx.model_axis)
    return add_bias_once(y, bp, prefix + "bo")


def mesh_mixer(cfg: ArchConfig, mixer: str, bp: dict, prefix: str, h: list,
               positions: list, ctx: ShardCtx, mode: str, views=None,
               kv_seq=None, causal: bool = True) -> list:
    """The mixer ``prefix`` of kind ``mixer`` on every coordinate's heads,
    its weights gathered whole on "embed" (FSDP): attention
    (``attn_local``, ``causal=False`` an encoder's; ``attn_seq_sharded``
    where the ring's slots split over ``kv_seq``), MLA
    (``mla.mla_placed``) or Mamba-2 (``mamba2.mamba_placed``; its inner
    channels split with its heads, ``mesh_family_check``).  Each
    coordinate's share of the output projection is summed over the model
    axis where the heads split, and ``bo`` added once: returns every
    coordinate's whole output."""
    mesh, ma = ctx.mesh, ctx.model_axis
    leaf, dim = _HEADS_LEAF[mixer]
    split, first = heads_first(bp[prefix + leaf], dim, ctx)
    ws = local_weights(bp, prefix, ctx)
    if mixer == "mla":
        y = mla.mla_placed(h, ws, cfg, positions, mode=mode, views=views,
                           mesh=mesh, model_axis=ma, seq_axes=kv_seq,
                           q_first=first, impl=ctx.attn_impl)
    elif mixer == "mamba":
        y = mamba2.mamba_placed(h, ws, cfg, mode=mode, views=views,
                                first=first, mesh=mesh, model_axis=ma,
                                split=split)
    elif kv_seq is not None:
        y = attn.attn_seq_sharded(h, ws, cfg, positions, mode=mode,
                                  q_first=first, views=views, mesh=mesh,
                                  model_axis=ma, seq_axes=kv_seq,
                                  impl=ctx.attn_impl)
    else:
        y = [attn.attn_local(h[r], ws[r], cfg, positions[r], mode=mode,
                             q_first=first[r], causal=causal,
                             cache=None if views is None else views[r],
                             impl=ctx.attn_impl) for r in range(len(h))]
    if split:
        y = spmd.psum(y, mesh, ma)
    return add_bias_once(y, bp, prefix + "bo")


def _mesh_block(cfg: ArchConfig, kind: Block, bp: dict, x: list,
                positions: list, ctx: ShardCtx, mode: str, views, x_spec,
                kv_seq=None, stats=None):
    """One pre-norm residual block of kind ``kind`` over every
    coordinate.  ``bp``: the block's placed parameters by short name;
    ``views``: a rank list of the layer's cache views (None in train
    mode), their slots split over ``kv_seq`` (SP) or whole; ``x_spec``:
    the residual stream's placement; ``stats``: the MoE's drop count.
    The mixer (:func:`mesh_mixer`), then the MLP (:func:`mesh_mlp`), the
    MoE (``moe.moe_placed``) or no ffn.  Returns (x, the MoE's aux or
    None)."""
    h = _norm_blocks(bp, "norm1.", x, cfg)
    y = mesh_mixer(cfg, kind.mixer, bp, "mixer.", h, positions, ctx, mode,
                   views, kv_seq)
    x = [a + b for a, b in zip(x, y)]
    if kind.ffn == "none":
        return x, None
    h = _norm_blocks(bp, "norm2.", x, cfg)
    if kind.ffn == "moe":
        cf = ctx.moe_decode_cf if mode == "decode" else None
        y, aux = moe.moe_placed(_block_params(bp, "ffn."), h, x_spec, cfg,
                                ctx, cf, stats)
        return [a + b for a, b in zip(x, y)], aux
    y = mesh_mlp(bp, "ffn.", h, ctx)
    return [a + b for a, b in zip(x, y)], None


class _Remat(torch.autograd.Function):
    """One block over every coordinate keeping nothing for the backward
    but its inputs (``ShardCtx.remat`` on a mesh): the forward runs without
    a graph; the backward runs the block again, its FSDP gathers too, and
    differentiates that.  ``torch.utils.checkpoint``'s non-reentrant hooks
    do not hold when autograd's threads, one a device, unpack one frame's
    tensors (seen on four cards), so the recompute is this function's own.
    ``run(xs, blocks, first)`` maps the rank list ``xs`` and the block's
    parameter blocks to a list of tensors (``first``: the forward's run,
    not the recompute)."""

    @staticmethod
    def forward(ctx, run, n_x, *ts):
        ctx.run, ctx.n_x = run, n_x
        ctx.save_for_backward(*ts)
        with torch.no_grad():
            return tuple(run(list(ts[:n_x]), list(ts[n_x:]), True))

    @staticmethod
    def backward(ctx, *gouts):
        ts = [t.detach().requires_grad_(t.requires_grad)
              for t in ctx.saved_tensors]
        with torch.enable_grad():
            outs = ctx.run(ts[:ctx.n_x], ts[ctx.n_x:], False)
        pairs = [(o, g) for o, g in zip(outs, gouts) if g is not None]
        wrt = [t for t in ts if t.requires_grad]
        gs = iter(torch.autograd.grad([o for o, _ in pairs], wrt,
                                      [g for _, g in pairs],
                                      allow_unused=True))
        return (None, None) + tuple(next(gs) if t.requires_grad else None
                                    for t in ts)


def remat_run(fn, xs: list, bp: dict) -> list:
    """``fn(xs, bp, first)`` (a list of tensors of the rank list ``xs``
    and the placed parameters ``bp``) under :class:`_Remat`: nothing kept
    for the backward but ``xs`` and ``bp``'s blocks."""
    names = list(bp)

    def run(ts, blocks, first):
        k, local = 0, {}
        for n in names:
            p = bp[n]
            local[n] = spmd.Placed(blocks[k:k + len(p.blocks)], p.sharding,
                                   p.shape)
            k += len(p.blocks)
        return fn(ts, local, first)

    return list(_Remat.apply(run, len(xs), *xs,
                             *[b for n in names for b in bp[n].blocks]))


def _remat_block(cfg: ArchConfig, kind: Block, bp: dict, x: list,
                 positions: list, ctx: ShardCtx, mode: str, x_spec,
                 stats=None):
    """``_mesh_block`` in train mode under :class:`_Remat` (the drops
    counted in the forward's run only); returns (x, aux or None)."""
    def fn(xs, local, first):
        out, aux = _mesh_block(cfg, kind, local, xs, positions, ctx, mode,
                               None, x_spec,
                               stats=stats if first else None)
        return out if aux is None else out + [aux]

    out = remat_run(fn, x, bp)
    return (out, None) if len(out) == len(x) else (out[:-1], out[-1])


def _block_params(params: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in params.items()
            if k.startswith(prefix)}


def check_inputs(tokens, positions, params: dict, ctx: ShardCtx,
                 embeds=None):
    """Placed inputs on the ``ShardCtx``'s mesh (``embeds`` where given,
    their rows placed as the tokens'), every parameter placed there."""
    for what, t in (("tokens", tokens), ("positions", positions),
                    ("embeds", embeds)):
        if what == "embeds" and t is None:
            continue
        if not isinstance(t, spmd.Placed):
            raise TypeError(f"{what}: placed parameters take placed inputs "
                            f"(got {type(t).__name__})")
        if t.mesh is not ctx.mesh:
            raise ValueError(f"{what}: placed on another mesh than the "
                             "ShardCtx's")
    if embeds is not None and embeds.spec[0] != tokens.spec[0]:
        raise ValueError(f"embeds: rows placed as {embeds.spec[0]}, the "
                         f"tokens' as {tokens.spec[0]}")
    for name, p in params.items():
        if not isinstance(p, spmd.Placed) or p.mesh is not ctx.mesh:
            raise ValueError(f"parameter {name} is not placed on the "
                             "ShardCtx's mesh")


def mesh_embed(params: dict, tokens: spmd.Placed, ctx: ShardCtx) -> list:
    """Each coordinate's rows of the table lookup, whole on d: its
    d-slice of "embed_tbl" looked up, then gathered over the model axis."""
    tok = params["embed.tok"]
    ma = ctx.model_axis
    tbl = spmd.unshard(tok, (ma,))
    xs = [F.embedding(t, w) for t, w in zip(tokens.blocks, tbl)]
    if spmd.sharded_over(tok, ma) == 1:
        xs = spmd.all_gather(xs, ctx.mesh, ma, dim=2)
    return xs


def _slot_axes(leaves: dict):
    """The mesh axes a layer's cache splits its slots over (SP), read from
    the leaf its mixer has: the ring's ``k``, the latent ``c_kv``; None
    for a Mamba cache, which has no slots, or where they are whole."""
    leaf = leaves.get("k", leaves.get("c_kv"))
    return None if leaf is None else leaf.spec[2]   # (layers, B, W, ...)


def _run_block(cfg: ArchConfig, kind: Block, bp: dict, x: list,
               positions: list, ctx: ShardCtx, mode: str, x_spec, stats,
               leaves=None, layer: int = 0):
    """One block over every coordinate: under :class:`_Remat` in train
    mode with ``ctx.remat``, else :func:`_mesh_block` on the views of
    ``leaves`` (the layer's placed cache leaves by name, None in train
    mode) at ``layer``."""
    if mode == "train" and ctx.remat:
        return _remat_block(cfg, kind, bp, x, positions, ctx, mode, x_spec,
                            stats)
    views = kv_seq = None
    if leaves is not None:
        views = [{k: t.blocks[r][layer] for k, t in leaves.items()}
                 for r in range(len(x))]
        kv_seq = _slot_axes(leaves)
    return _mesh_block(cfg, kind, bp, x, positions, ctx, mode, views,
                       x_spec, kv_seq, stats)


def _mesh_run(model, params: dict, tokens, positions, ctx: ShardCtx,
              cache, mode: str, embeds=None):
    """The embedding (a vision frontend's placed ``embeds`` rows first),
    every block and the final norm on placed parameters; returns the
    hidden states, placed as the tokens' rows (over the batch axes, or
    whole where the batch does not split), the MoE layers' summed aux on
    coordinate 0's device, and the tokens' embedding's rank list (the MTP
    head reads it)."""
    cfg = model.cfg
    mesh_family_check(cfg, f"LM {mode} with placed parameters", ctx)
    check_inputs(tokens, positions, params, ctx, embeds)
    emb = x = mesh_embed(params, tokens, ctx)
    if embeds is not None:
        x = [torch.cat([e.to(t.dtype), t], dim=1)
             for e, t in zip(embeds.blocks, emb)]
    pos = positions.blocks
    x_spec = P(tokens.spec[0], None, None)
    hs = NamedSharding(ctx.mesh, x_spec)
    aux = torch.zeros((), dtype=torch.float32, device=x[0].device)
    for gi, group in enumerate(model.groups):
        gc = None if cache is None else cache["groups"][gi]["blocks"]
        for li, layer in enumerate(group):
            for bi, blk in enumerate(layer):
                bp = _block_params(params, f"groups.{gi}.{li}.{bi}.")
                stats = getattr(getattr(blk, "ffn", None), "stats", None)
                x, a = _run_block(cfg, blk.kind, bp, x, pos, ctx, mode,
                                  x_spec, stats,
                                  None if gc is None else gc[bi], li)
                if a is not None:
                    aux = aux + a
        x = ctx.constrain(spmd.Placed(x, hs), x_spec).blocks
    hidden = spmd.Placed(_norm_blocks(params, "final_norm.", x, cfg), hs)
    return hidden, aux, emb


def _mesh_mtp(model, params: dict, hidden: spmd.Placed, emb: list,
              positions, ctx: ShardCtx):
    """The MTP head on placed parameters: h'_i = Block(proj [h_i ;
    emb(t_{i+1})]) with ``proj`` gathered over the data axes (FSDP), the
    head's block by :func:`_run_block`, its norm replicated.  Returns (the
    head's hidden states (B, S-1, d), placed as ``hidden``; the block's
    aux or None)."""
    cfg = model.cfg
    proj = spmd.unshard(params["mtp.proj"], (ctx.model_axis,))
    h = [torch.einsum("bsd,dk->bsk", torch.cat(
        [x[:, :-1], e[:, 1:].to(x.dtype)], dim=-1), w)
        for x, e, w in zip(hidden.blocks, emb, proj)]
    pos = [p[:, 1:] for p in positions.blocks]
    blk = model.mtp.block
    stats = getattr(getattr(blk, "ffn", None), "stats", None)
    h, aux = _run_block(cfg, blk.kind, _block_params(params, "mtp.block."),
                        h, pos, ctx, "train", hidden.spec, stats)
    return (spmd.Placed(_norm_blocks(params, "mtp.norm.", h, cfg),
                        hidden.sharding), aux)


def mesh_logits(params: dict, hidden: spmd.Placed,
                ctx: ShardCtx) -> spmd.Placed:
    """Logits (fp32, whole on the vocab) of placed hidden states: an
    untied head split on "vocab" gathers its columns over the model axis;
    the tied head with the table's d split over it sums its partial
    products there (``psum``)."""
    mesh, ma = ctx.mesh, ctx.model_axis
    head = params.get("embed.lm_head")
    n = len(hidden.blocks)
    if head is not None:
        w = spmd.unshard(head, (ma,))
        ys = [(hidden.blocks[r] @ w[r]).to(torch.float32) for r in range(n)]
        if spmd.sharded_over(head, ma) == 1:
            ys = spmd.all_gather(ys, mesh, ma, dim=2)
        return spmd.Placed(ys, hidden.sharding)
    tok = params["embed.tok"]
    w = spmd.unshard(tok, (ma,))
    if spmd.sharded_over(tok, ma) == 1:
        dm = w[0].shape[1]
        idx = spmd.axis_index(mesh, ma)
        ys = [(hidden.blocks[r][..., idx[r] * dm:(idx[r] + 1) * dm]
               @ w[r].T).to(torch.float32) for r in range(n)]
        ys = spmd.psum(ys, mesh, ma)
    else:
        ys = [(hidden.blocks[r] @ w[r].T).to(torch.float32)
              for r in range(n)]
    return spmd.Placed(ys, hidden.sharding)


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
        self.mtp = MTPHead(cfg, **kw) if cfg.mtp_depth else None

    # ---- parameter declarations ----
    def specs(self) -> dict:
        """The reference's parameter tree, as ParamSpecs (stacked layers)."""
        return lm_specs(self.cfg)

    def cache_specs(self, batch: int, max_len: int) -> dict:
        return cache_specs(self.cfg, batch, max_len)

    def init_cache(self, batch: int, max_len: int,
                   dtype: torch.dtype | None = None) -> dict:
        """An empty cache on the model's device, as the reference's
        ``init_cache`` makes it: every ``pos`` -1 (ring and MLA caches),
        every other leaf zeros.  ``dtype=None`` keeps the specs' dtypes; a
        dtype casts the bf16 leaves (K/V, ``c_kv``, ``k_rope``) to it.
        ``pos`` stays int32 and the Mamba states fp32."""
        def make(path, spec):
            if path[-1] == "pos":
                return torch.full(spec.shape, -1, dtype=spec.dtype,
                                  device=self.device)
            dt = dtype if dtype and spec.dtype == torch.bfloat16 else None
            return torch.zeros(spec.shape, dtype=dt or spec.dtype,
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

    def logits(self, hidden, params: dict | None = None,
               ctx: ShardCtx = _NULL_CTX):
        """(B, S, V) fp32 logits; with placed ``params`` of placed hidden
        states (``mesh_logits``), placed by the batch spec."""
        if params is not None:
            return mesh_logits(params, hidden, ctx)
        return lm_logits(hidden, self.embed.tok,
                         getattr(self.embed, "lm_head", None))

    # ---- stacks ----
    def _run_groups(self, x, positions, ctx: ShardCtx, cache: dict | None,
                    mode: str):
        """Every block in order.  Returns ``(x, aux)``, aux summed over
        every block.  Train mode takes no cache; with ``ctx.remat`` each
        layer is recomputed in the backward."""
        remat = mode == "train" and ctx.remat
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for gi, group in enumerate(self.groups):
            gc = None if cache is None else cache["groups"][gi]["blocks"]
            for li, layer in enumerate(group):
                for bi, blk in enumerate(layer):
                    views = (None if gc is None else
                             {name: t[li] for name, t in gc[bi].items()})
                    if remat:
                        x, a = checkpoint(blk, x, positions, views, ctx=ctx,
                                          mode=mode, use_reentrant=False,
                                          preserve_rng_state=False)
                    else:
                        x, a = blk(x, positions, views, ctx=ctx, mode=mode)
                    if a is not None:
                        aux = aux + a
            x = ctx.constrain(x)
        return x, aux

    # ---- public entry points ----
    def forward(self, tokens, positions, ctx: ShardCtx = _NULL_CTX,
                embeds=None, params: dict | None = None) -> dict:
        """Training forward (no cache).  tokens: (B,S); positions:
        (B,S[+N]) covering ``embeds``' N rows, which come first.  Returns
        ``{"hidden": (B,S[+N],d), "aux"}`` and, where the config has
        ``mtp_depth`` and the model its head, ``"mtp_hidden"`` (B,S-1,d):
        h'_i = Block(proj [h_i ; emb(t_{i+1})]) predicts t_{i+2}, and the
        head's block adds its aux.  With placed ``params`` (module
        docstring) tokens and positions are placed, and ``hidden`` and
        ``mtp_hidden`` are (the head where ``params`` hold it)."""
        cfg = self.cfg
        if params is not None:
            hidden, aux, emb = _mesh_run(self, params, tokens, positions,
                                         ctx, None, "train", embeds)
            out = {"hidden": hidden, "aux": aux}
            if cfg.mtp_depth and "mtp.proj" in params:
                out["mtp_hidden"], mtp_aux = _mesh_mtp(
                    self, params, hidden, emb, positions, ctx)
                if mtp_aux is not None:
                    out["aux"] = aux + mtp_aux
            return out
        x = self.embed(tokens, embeds)
        x, aux = self._run_groups(x, positions, ctx, None, "train")
        x = self.final_norm(x)
        out = {"hidden": x, "aux": aux}
        if cfg.mtp_depth and self.mtp is not None:
            emb_next = self.embed(tokens)[:, 1:]
            hcat = torch.cat([x[:, :-1], emb_next.to(x.dtype)], dim=-1)
            h2 = torch.einsum("bsd,dk->bsk", hcat, self.mtp.proj)
            h2, mtp_aux, _ = apply_block(self.mtp.block, h2, positions[:, 1:],
                                         ctx)
            out["mtp_hidden"] = self.mtp.norm(h2)
            out["aux"] = aux + mtp_aux
        return out

    def prefill(self, tokens, positions, cache: dict,
                ctx: ShardCtx = _NULL_CTX, embeds=None,
                params: dict | None = None):
        """Process the prompt, fill the cache in place.  tokens: (B,S);
        positions: (B,S[+N]) covering ``embeds``' N rows, which come first.
        Returns (hidden, cache, aux); aux is the MoE layers' summed
        load-balance and z loss, 0 without them.  With placed ``params``
        the inputs, the cache's leaves and the hidden states are
        placed."""
        if params is not None:
            hidden, aux, _ = _mesh_run(self, params, tokens, positions,
                                       ctx, cache, "prefill", embeds)
            return hidden, cache, aux
        x = self.embed(tokens, embeds)
        x, aux = self._run_groups(x, positions, ctx, cache, "prefill")
        return self.final_norm(x), cache, aux

    def decode(self, tokens, positions, cache: dict,
               ctx: ShardCtx = _NULL_CTX, params: dict | None = None):
        """One token per sequence. tokens: (B,1); positions: (B,).
        Returns (logits (B,1,V) fp32, cache); the cache is written in
        place.  With placed ``params`` the inputs, the cache's leaves and
        the logits are placed."""
        if params is not None:
            hidden, _, _ = _mesh_run(self, params, tokens, positions, ctx,
                                     cache, "decode")
            return mesh_logits(params, hidden, ctx), cache
        x = self.embed(tokens)
        x, _ = self._run_groups(x, positions, ctx, cache, "decode")
        return self.logits(self.final_norm(x)), cache
