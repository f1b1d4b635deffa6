"""Whisper-style encoder-decoder backbone.

The conv/mel frontend is a stub, as in the reference: callers provide
precomputed frame embeddings (B, S_enc, d_model).  The encoder adds
sinusoidal positions and runs bidirectional attention blocks (no RoPE).
The decoder adds learned positions (whisper's 448, clipped at 447), runs
causal self-attention over the ring cache and cross-attention over the
encoder's states, whose K/V are computed once at prefill and then only
read: the "computed once, then cold" buffer that Pond's zNUMA tier
targets.

Where the reference stacks each block's parameters on a leading "layers"
dim and scans them, the port holds ``encoder_layers`` encoder blocks and
``num_layers`` decoder blocks in ``nn.ModuleList``s and walks them in a
Python loop; ``specs()`` reports the reference's stacked shapes.  The
cache keeps the reference's stacked layout,
``{"self": {"k", "v", "pos"} (L, B, W, ...), "cross_k", "cross_v"
(L, B, S_enc, Hkv, D)}``, and is written in place.

The reference casts the frames to bf16 before the encoder, which its
scanned encoder cannot carry with fp32 weights (ROADMAP F15); the port
casts them to the weights' dtype, which is bf16 wherever the reference
runs.  The encoder's bidirectional attention takes the blocked core, or
with ``attn_impl="flash"`` the plain product, as the reference routes it:
flash attention (K3) runs only in the decoder's causal prefill.

On a mesh (M18c), ``forward``, ``prefill``, ``decode`` and ``logits``
take ``params=``, the parameters placed by name (``sharding/spmd.py``),
and placed inputs, as ``models/transformer.py``'s ``LM`` does: each
coordinate runs the encoder's and the decoder's blocks on its heads and
ff columns (``attention.attn_local``: the encoder's unrotated and
bidirectional), each split product summed over the model axis and its
replicated ``bo`` added once after the sum; the decoder's learned
positions are gathered over the data axes (FSDP) in train mode.  The
cross K/V are computed from each coordinate's encoder states on its KV
heads; at prefill they are written once into the placed
``cross_k``/``cross_v`` leaves, whose frames split over the model axis
under SP (``ShardCtx.seq_shard_kv``) or whose KV heads split without it,
and every cross-attention reads them (``attention.cross_attn_placed``: a
coordinate's heads, or fp32 partials over its block of the frames merged
across the axis).  With ``ShardCtx.remat`` each block of both stacks is
recomputed in the backward (``transformer.remat_run``).
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tr
from repro_torch.models.layers import (MLP, Embedding, Norm, SpecModule,
                                       embed_specs, embed_tokens, lm_logits,
                                       mlp_specs, norm_specs)
from repro_torch.models.params import (ParamSpec, init_tensor_,
                                       map_with_path, stack_specs)
from repro_torch.sharding import spmd
from repro_torch.sharding.rules import P, NamedSharding, ShardCtx

_NULL_CTX = ShardCtx()
MAX_DEC_LEN = 448  # whisper decoder context


def sinusoid(seq: int, dim: int) -> torch.Tensor:
    """(seq, dim) fp32 sinusoidal positions, made on the host (the CPU
    and the card then add the same table)."""
    pos = torch.arange(seq, dtype=torch.float32)[:, None]
    inv = torch.exp(-torch.arange(0, dim, 2, dtype=torch.float32) / dim
                    * torch.tensor(math.log(1e4), dtype=torch.float32))
    ang = pos * inv[None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1)


# ----------------------------------------------------------------- specs ---
def _enc_block_specs(cfg: ArchConfig) -> dict:
    return {"norm1": norm_specs(cfg.d_model, cfg.norm),
            "mixer": attn.attention_specs(cfg),
            "norm2": norm_specs(cfg.d_model, cfg.norm),
            "ffn": mlp_specs(cfg, cfg.d_ff)}


def _dec_block_specs(cfg: ArchConfig) -> dict:
    return {"norm1": norm_specs(cfg.d_model, cfg.norm),
            "self": attn.attention_specs(cfg),
            "norm_x": norm_specs(cfg.d_model, cfg.norm),
            "cross": attn.cross_attention_specs(cfg),
            "norm2": norm_specs(cfg.d_model, cfg.norm),
            "ffn": mlp_specs(cfg, cfg.d_ff)}


def _dec_pos_spec(cfg: ArchConfig) -> ParamSpec:
    return ParamSpec((MAX_DEC_LEN, cfg.d_model), torch.bfloat16,
                     (None, "embed"), "embed")


def encdec_specs(cfg: ArchConfig) -> dict:
    """The reference's parameter tree, as ParamSpecs (stacked layers),
    without allocating anything."""
    return {
        "embed": embed_specs(cfg),
        "dec_pos": _dec_pos_spec(cfg),
        "enc_blocks": stack_specs(_enc_block_specs(cfg), cfg.encoder_layers),
        "enc_norm": norm_specs(cfg.d_model, cfg.norm),
        "dec_blocks": stack_specs(_dec_block_specs(cfg), cfg.num_layers),
        "final_norm": norm_specs(cfg.d_model, cfg.norm),
    }


def encdec_cache_specs(cfg: ArchConfig, batch: int, max_len: int,
                       enc_len: int | None = None) -> dict:
    """The reference's cache tree: ``max_len`` bounds the decoder's ring
    (at most ``MAX_DEC_LEN``), ``enc_len`` (default ``max_len``) is the
    cross-KV's length."""
    enc_len = enc_len if enc_len is not None else max_len
    dec_w = min(MAX_DEC_LEN, max_len)
    hkv, hd = cfg.num_kv_heads, cfg.head_dim
    cross = ParamSpec((cfg.num_layers, batch, enc_len, hkv, hd),
                      torch.bfloat16,
                      ("layers", "batch", "kv_seq", "kv_heads", None),
                      "zeros")
    return {"self": stack_specs(attn.kv_cache_specs(cfg, batch, dec_w),
                                cfg.num_layers),
            "cross_k": cross, "cross_v": cross}


# ---------------------------------------------------------------- blocks ---
class EncoderBlock(nn.Module):
    """norm1 -> bidirectional self-attention, norm2 -> MLP."""

    def __init__(self, cfg: ArchConfig, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm1 = Norm(cfg.d_model, cfg.norm, cfg.norm_eps, **kw)
        self.mixer = attn.Attention(cfg, **kw)
        self.norm2 = Norm(cfg.d_model, cfg.norm, cfg.norm_eps, **kw)
        self.ffn = MLP(cfg, cfg.d_ff, **kw)

    def forward(self, x, positions, impl: str):
        x = x + attn.attn_forward(self.mixer, self.norm1(x), positions,
                                  causal=False, impl=impl)
        return x + self.ffn(self.norm2(x))


class DecoderBlock(nn.Module):
    """norm1 -> causal self-attention (ring cache), norm_x ->
    cross-attention over the encoder's K/V, norm2 -> MLP."""

    def __init__(self, cfg: ArchConfig, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm1 = Norm(cfg.d_model, cfg.norm, cfg.norm_eps, **kw)
        self.self = attn.Attention(cfg, **kw)
        self.norm_x = Norm(cfg.d_model, cfg.norm, cfg.norm_eps, **kw)
        self.cross = attn.Attention(cfg, **kw)
        self.norm2 = Norm(cfg.d_model, cfg.norm, cfg.norm_eps, **kw)
        self.ffn = MLP(cfg, cfg.d_ff, **kw)

    def forward(self, x, positions, enc_kv, cache: dict | None, *,
                impl: str, mode: str):
        """mode: train | prefill | decode; ``cache`` is this layer's ring
        views (None in train mode), written in place."""
        h = self.norm1(x)
        if mode == "train":
            y = attn.attn_forward(self.self, h, positions, impl=impl)
        elif mode == "prefill":
            y, _ = attn.attn_prefill(self.self, h, cache, positions,
                                     impl=impl)
        elif mode == "decode":
            y, _ = attn.attn_decode(self.self, h, cache, positions)
        else:
            raise ValueError(f"mode {mode!r}; one of train, prefill, decode")
        x = x + y
        x = x + attn.cross_attn_forward(self.cross, self.norm_x(x), enc_kv)
        return x + self.ffn(self.norm2(x))


# -------------------------------------------------------- on a mesh (M18c) --
def _enc_block(cfg: ArchConfig, bp: dict, x: list, positions: list,
               ctx: ShardCtx) -> list:
    """One encoder block over every coordinate: bidirectional attention,
    then the MLP, each residual."""
    h = tr._norm_blocks(bp, "norm1.", x, cfg)
    x = [a + b for a, b in zip(x, tr.mesh_mixer(cfg, "attn", bp, "mixer.", h,
                                                positions, ctx, "train",
                                                causal=False))]
    h = tr._norm_blocks(bp, "norm2.", x, cfg)
    return [a + b for a, b in zip(x, tr.mesh_mlp(bp, "ffn.", h, ctx))]


def _cross_kv(cfg: ArchConfig, bp: dict, enc: list, ctx: ShardCtx) -> list:
    """Each coordinate's cross (k, v) of its encoder states, on the KV
    heads its ``cross.wk``/``cross.wv`` blocks hold."""
    return [attn.cross_kv(e, cfg, **{k: w.get(k) for k in
                                     ("wk", "wv", "bk", "bv")})
            for e, w in zip(enc, tr.local_weights(bp, "cross.", ctx))]


def _dec_block(cfg: ArchConfig, bp: dict, x: list, positions: list,
               ctx: ShardCtx, mode: str, *, enc=None, views=None,
               kv_seq=None, cross=None, cross_seq=None) -> list:
    """One decoder block over every coordinate: causal self-attention (on
    ``views``, the layer's ring blocks, in prefill and decode),
    cross-attention over each coordinate's cross (k, v) (``cross``: read
    from the cache, their frames split over ``cross_seq``; in train mode
    computed from ``enc``), then the MLP."""
    h = tr._norm_blocks(bp, "norm1.", x, cfg)
    x = [a + b for a, b in zip(x, tr.mesh_mixer(cfg, "attn", bp, "self.", h,
                                                positions, ctx, mode,
                                                views=views, kv_seq=kv_seq))]
    h = tr._norm_blocks(bp, "norm_x.", x, cfg)
    if cross is None:
        cross = _cross_kv(cfg, bp, enc, ctx)
    split, first = tr.heads_first(bp["cross.wq"], 1, ctx)
    y = attn.cross_attn_placed(h, tr.local_weights(bp, "cross.", ctx), cfg,
                               cross, q_first=first, mesh=ctx.mesh,
                               model_axis=ctx.model_axis, seq_axes=cross_seq)
    if split:
        y = spmd.psum(y, ctx.mesh, ctx.model_axis)
    y = tr.add_bias_once(y, bp, "cross.bo")
    x = [a + b for a, b in zip(x, y)]
    h = tr._norm_blocks(bp, "norm2.", x, cfg)
    return [a + b for a, b in zip(x, tr.mesh_mlp(bp, "ffn.", h, ctx))]


def _write_cross(leaf: spmd.Placed, layer: int, kvs: list, ctx: ShardCtx):
    """Each coordinate's k (or v) of every encoder frame on its KV heads
    written into its block of the placed cache leaf at ``layer``: the KV
    heads gathered over the model axis where the block holds more, the
    block's frames cut where they split (SP)."""
    hc, w_loc = leaf.blocks[0].shape[3], leaf.blocks[0].shape[2]
    if kvs[0].shape[2] < hc:
        kvs = spmd.all_gather(kvs, ctx.mesh, ctx.model_axis, 2)
    if leaf.spec[2] is not None:
        idx = spmd.axis_index(ctx.mesh, leaf.spec[2])
        kvs = [t[:, i * w_loc:(i + 1) * w_loc] for t, i in zip(kvs, idx)]
    for blk, t in zip(leaf.blocks, kvs):
        blk[layer].copy_(t)


def _mesh_encode(model, params: dict, frames: spmd.Placed,
                 ctx: ShardCtx, train: bool) -> list:
    """The encoder on placed parameters: each coordinate's rows of the
    frames (cast to the weights' dtype) plus the sinusoids, every block
    (under remat in train mode with ``ctx.remat``), the final norm.
    Returns the rank list of encoder states, whole on d."""
    cfg = model.cfg
    dtype = params["embed.tok"].dtype
    x = []
    for f in frames.blocks:
        t = f.to(dtype)
        x.append(t + sinusoid(t.shape[1], cfg.d_model).to(t.device,
                                                          dtype)[None])
    s = x[0].shape[1]
    pos = [torch.arange(s, device=t.device).expand(t.shape[0], s)
           for t in x]
    for i in range(len(model.enc_blocks)):
        bp = tr._block_params(params, f"enc_blocks.{i}.")
        if train and ctx.remat:
            x = tr.remat_run(
                lambda xs, local, _first: _enc_block(cfg, local, xs, pos,
                                                     ctx), x, bp)
        else:
            x = _enc_block(cfg, bp, x, pos, ctx)
    return tr._norm_blocks(params, "enc_norm.", x, cfg)


def _mesh_decoder(model, params: dict, tokens: spmd.Placed, positions,
                  ctx: ShardCtx, mode: str, *, enc=None, cache=None):
    """The decoder on placed parameters: the tokens' embedding (the
    table's d-slices gathered over the model axis) plus the learned
    positions (gathered over the data axes in train mode), every block,
    the final norm.  Train mode computes each layer's cross K/V from
    ``enc`` (under remat with ``ctx.remat``); prefill and decode read
    them from ``cache``.  Returns the hidden states, placed as the tokens'
    rows."""
    cfg = model.cfg
    x = tr.mesh_embed(params, tokens, ctx)
    table = spmd.unshard(params["dec_pos"], (ctx.model_axis,))
    pos = positions.blocks
    at = pos if mode != "decode" else [p[:, None] for p in pos]
    x = [t + w[p.clamp(0, MAX_DEC_LEN - 1)].to(t.dtype)
         for t, w, p in zip(x, table, at)]
    n = len(x)
    for li in range(len(model.dec_blocks)):
        bp = tr._block_params(params, f"dec_blocks.{li}.")
        if mode == "train":
            if ctx.remat:
                x = tr.remat_run(
                    lambda ts, local, _first: _dec_block(
                        cfg, local, ts[:n], pos, ctx, mode, enc=ts[n:]),
                    x + list(enc), bp)
            else:
                x = _dec_block(cfg, bp, x, pos, ctx, mode, enc=enc)
            continue
        ring = cache["self"]
        views = [{k: t.blocks[r][li] for k, t in ring.items()}
                 for r in range(n)]
        cross = [(cache["cross_k"].blocks[r][li],
                  cache["cross_v"].blocks[r][li]) for r in range(n)]
        x = _dec_block(cfg, bp, x, pos, ctx, mode, views=views,
                       kv_seq=ring["k"].spec[2], cross=cross,
                       cross_seq=cache["cross_k"].spec[2])
    hs = NamedSharding(ctx.mesh, P(tokens.spec[0], None, None))
    return spmd.Placed(tr._norm_blocks(params, "final_norm.", x, cfg), hs)


def _check_placed(model, params, tokens, positions, ctx, what, frames=None):
    tr.mesh_family_check(model.cfg, f"EncDec {what} with placed "
                         "parameters", ctx)
    tr.check_inputs(tokens, positions, params, ctx, frames)


# ----------------------------------------------------------------- model ---
class EncDec(nn.Module):
    """Encoder-decoder model (whisper)."""

    def __init__(self, cfg: ArchConfig, *, device: torch.device,
                 dtype: torch.dtype | None = None):
        """Parameters are allocated on ``device`` and left uninitialised:
        call :meth:`init_params` or load them (``models/convert.py``).
        ``dtype=None`` keeps the specs' dtypes, a dtype casts all to it."""
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        self.embed = Embedding(cfg, **kw)
        spec = _dec_pos_spec(cfg)
        self.dec_pos = nn.Parameter(
            torch.empty(spec.shape, dtype=dtype or spec.dtype, device=device),
            requires_grad=False)
        self.enc_blocks = nn.ModuleList(
            EncoderBlock(cfg, **kw) for _ in range(cfg.encoder_layers))
        self.enc_norm = Norm(cfg.d_model, cfg.norm, cfg.norm_eps, **kw)
        self.dec_blocks = nn.ModuleList(
            DecoderBlock(cfg, **kw) for _ in range(cfg.num_layers))
        self.final_norm = Norm(cfg.d_model, cfg.norm, cfg.norm_eps, **kw)

    # ---- parameter / cache declarations ----
    def specs(self) -> dict:
        return encdec_specs(self.cfg)

    def cache_specs(self, batch: int, max_len: int,
                    enc_len: int | None = None) -> dict:
        return encdec_cache_specs(self.cfg, batch, max_len, enc_len)

    def init_cache(self, batch: int, max_len: int, enc_len: int | None = None,
                   dtype: torch.dtype | None = None) -> dict:
        """An empty cache on the model's device: ``pos`` -1, every other
        leaf zeros; ``dtype`` casts the bf16 leaves (K/V, cross K/V)."""
        def make(path, spec):
            if path[-1] == "pos":
                return torch.full(spec.shape, -1, dtype=spec.dtype,
                                  device=self.device)
            dt = dtype if dtype and spec.dtype == torch.bfloat16 else None
            return torch.zeros(spec.shape, dtype=dt or spec.dtype,
                               device=self.device)
        return map_with_path(make, self.cache_specs(batch, max_len, enc_len))

    def init_params(self, generator: torch.Generator | None = None
                    ) -> "EncDec":
        """Seeded random init, drawn on the parameters' device."""
        for m in self.modules():
            if isinstance(m, SpecModule):
                m.init_own_params(generator)
        init_tensor_(self.dec_pos, _dec_pos_spec(self.cfg), generator)
        return self

    @property
    def device(self) -> torch.device:
        return self.embed.tok.device

    # ---- encoder ----
    def encode(self, frames, ctx: ShardCtx = _NULL_CTX,
               train: bool = False):
        """frames: (B, S_enc, d) precomputed embeddings (frontend stub) ->
        the encoder's states (B, S_enc, d)."""
        x = frames.to(self.embed.tok.dtype)
        s = x.shape[1]
        x = x + sinusoid(s, self.cfg.d_model).to(x.device, x.dtype)[None]
        pos = torch.arange(s, device=x.device).expand(x.shape[0], s)
        for blk in self.enc_blocks:
            if train and ctx.remat:
                x = checkpoint(blk, x, pos, ctx.attn_impl,
                               use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = blk(x, pos, ctx.attn_impl)
        return self.enc_norm(x)

    # ---- decoder ----
    def _dec_embed(self, tokens, positions):
        x = embed_tokens(self.embed.tok, tokens)
        pe = self.dec_pos[positions.clamp(0, MAX_DEC_LEN - 1)]
        return x + pe.to(x.dtype)

    def _decoder(self, x, positions, ctx: ShardCtx, *, enc_out=None,
                 cache=None, cross_kv=None, mode: str = "train"):
        """Every decoder block, then the final norm.  Train mode computes
        each layer's cross K/V from ``enc_out``; prefill and decode read
        ``cross_kv`` ((L, B, S_enc, Hkv, D) each, or per-layer lists)."""
        remat = mode == "train" and ctx.remat
        for li, blk in enumerate(self.dec_blocks):
            if mode == "train":
                kv = attn.encode_cross_kv(blk.cross, enc_out)
            else:
                kv = (cross_kv[0][li], cross_kv[1][li])
            views = (None if cache is None else
                     {n: t[li] for n, t in cache["self"].items()})
            if remat:
                x = checkpoint(blk, x, positions, kv, views,
                               impl=ctx.attn_impl, mode=mode,
                               use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = blk(x, positions, kv, views, impl=ctx.attn_impl,
                        mode=mode)
        return self.final_norm(x)

    # ---- public entry points ----
    def lm_head_weight(self) -> torch.Tensor:
        w = getattr(self.embed, "lm_head", None)
        return self.embed.tok.T if w is None else w

    def logits(self, hidden, params: dict | None = None,
               ctx: ShardCtx = _NULL_CTX):
        """(B, S, V) fp32 logits; with placed ``params`` of placed hidden
        states (``transformer.mesh_logits``)."""
        if params is not None:
            return tr.mesh_logits(params, hidden, ctx)
        return lm_logits(hidden, self.embed.tok,
                         getattr(self.embed, "lm_head", None))

    def forward(self, tokens, positions, ctx: ShardCtx = _NULL_CTX,
                embeds=None, params: dict | None = None) -> dict:
        """Training: ``embeds`` are the encoder's frames, ``tokens`` (B, S)
        the decoder's, ``positions`` (B, S) theirs.  Returns ``{"hidden":
        (B, S, d), "aux": 0}``.  With placed ``params`` (module
        docstring) the inputs and ``hidden`` are placed."""
        if params is not None:
            _check_placed(self, params, tokens, positions, ctx, "train",
                          embeds)
            enc = _mesh_encode(self, params, embeds, ctx, train=True)
            hidden = _mesh_decoder(self, params, tokens, positions, ctx,
                                   "train", enc=enc)
            return {"hidden": hidden, "aux": torch.zeros(
                (), dtype=torch.float32, device=hidden.blocks[0].device)}
        enc_out = self.encode(embeds, ctx, train=True)
        x = self._dec_embed(tokens, positions)
        x = self._decoder(x, positions, ctx, enc_out=enc_out, mode="train")
        return {"hidden": x,
                "aux": torch.zeros((), dtype=torch.float32, device=x.device)}

    def prefill(self, tokens, positions, cache: dict,
                ctx: ShardCtx = _NULL_CTX, embeds=None,
                params: dict | None = None):
        """Encode the frames once, store every layer's cross K/V in the
        cache, prefill the decoder's prompt (tokens, positions: (B, S)).
        Returns (hidden, cache, aux 0); the cache is written in place.
        With placed ``params`` the inputs, the cache's leaves and the
        hidden states are placed: the cross K/V are written into their
        placed leaves first, then every layer reads them there."""
        if params is not None:
            _check_placed(self, params, tokens, positions, ctx, "prefill",
                          embeds)
            enc = _mesh_encode(self, params, embeds, ctx, train=False)
            for li in range(len(self.dec_blocks)):
                bp = tr._block_params(params, f"dec_blocks.{li}.")
                kvs = _cross_kv(self.cfg, bp, enc, ctx)
                _write_cross(cache["cross_k"], li, [k for k, _ in kvs], ctx)
                _write_cross(cache["cross_v"], li, [v for _, v in kvs], ctx)
            del enc
            hidden = _mesh_decoder(self, params, tokens, positions, ctx,
                                   "prefill", cache=cache)
            return hidden, cache, torch.zeros(
                (), dtype=torch.float32, device=hidden.blocks[0].device)
        enc_out = self.encode(embeds, ctx)
        kvs = [attn.encode_cross_kv(blk.cross, enc_out)
               for blk in self.dec_blocks]
        ck, cv = [k for k, _ in kvs], [v for _, v in kvs]
        x = self._dec_embed(tokens, positions)
        x = self._decoder(x, positions, ctx, cache=cache, cross_kv=(ck, cv),
                          mode="prefill")
        for li in range(len(kvs)):
            cache["cross_k"][li].copy_(ck[li])
            cache["cross_v"][li].copy_(cv[li])
        return x, cache, torch.zeros((), dtype=torch.float32,
                                     device=x.device)

    def decode(self, tokens, positions, cache: dict,
               ctx: ShardCtx = _NULL_CTX, params: dict | None = None):
        """One token per sequence. tokens: (B, 1); positions: (B,).
        Returns (logits (B, 1, V) fp32, cache); the ring is written in
        place, the cross K/V only read.  With placed ``params`` the
        inputs, the cache's leaves and the logits are placed."""
        if params is not None:
            _check_placed(self, params, tokens, positions, ctx, "decode")
            hidden = _mesh_decoder(self, params, tokens, positions, ctx,
                                   "decode", cache=cache)
            return tr.mesh_logits(params, hidden, ctx), cache
        x = self._dec_embed(tokens, positions[:, None])
        x = self._decoder(x, positions, ctx, cache=cache,
                          cross_kv=(cache["cross_k"], cache["cross_v"]),
                          mode="decode")
        return self.logits(x), cache
