"""Serve-step builders: prefill + decode over the ring, latent and
encoder-decoder caches.

The reference jits these steps and donates the cache to the decode step;
``make_prefill_step`` and ``make_decode_step`` run them eagerly on the
model's own parameters and write the cache in place.  With a mesh,
:func:`jit_prefill_step` and :func:`jit_decode_step` are the reference's
partitioned steps: the parameters placed by :func:`serve_shardings`
(``runtime/train.py::placed_params(..., mode="serve")``), the cache made
placed by :func:`init_cache` ("batch" over the batch axes, "kv_heads"
over the model axis; with ``seq_shard_kv`` (SP) "kv_seq" over its axes,
the model axis first), the tokens and positions placed by the step
(:func:`batch_pspec`), each coordinate running its rows and heads (K3
once a coordinate in a flash prefill) and, under SP, its block of the
cache's slots, the decode's softmax merged across them
(``models/attention.py::attn_seq_sharded``; the latent cache's by
``models/mla.py::mla_placed``).  Every family: attention, MLA and
Mamba-2 blocks, with MLP, MoE or no ffn, the vision frontend's patch rows
(the prefill's ``embeds``), and the encoder-decoder, whose prefill
encodes its frames (``embeds``) and writes every layer's cross K/V once
into the placed cache (``enc_len`` sizes them; their frames split over
the model axis under SP, their KV heads without it)
(``models/transformer.py::is_placed_family``, ``models/encdec.py``).
"""
from __future__ import annotations

import torch

from repro_torch.models.params import map_with_path
from repro_torch.sharding import spmd
from repro_torch.sharding.rules import (P, NamedSharding, ShardCtx,
                                        default_rules, sharding_tree)


def make_prefill_step(model, ctx: ShardCtx):
    """(tokens (B,S), positions (B,S), cache[, embeds]) -> (last-position
    logits (B,1,V) fp32, cache).  ``embeds`` are a vision model's patch
    rows (before the tokens) or an encoder-decoder's frames."""
    @torch.no_grad()
    def prefill(tokens, positions, cache, embeds=None):
        hidden, cache, _ = model.prefill(tokens, positions, cache, ctx,
                                         embeds=embeds)
        return model.logits(hidden[:, -1:]), cache
    return prefill


def make_decode_step(model, ctx: ShardCtx):
    """(tokens (B,1), positions (B,), cache) -> (logits (B,1,V) fp32,
    cache)."""
    @torch.no_grad()
    def decode(tokens, positions, cache):
        return model.decode(tokens, positions, cache, ctx)
    return decode


def serve_shardings(model, ctx: ShardCtx, batch: int, max_len: int,
                    enc_len: int | None = None):
    """(params, cache) ``NamedSharding`` trees for serving on
    ``ctx.mesh``; ``enc_len`` sizes an encoder-decoder's cross K/V."""
    rules_ = default_rules(ctx, mode="serve")
    params_sh = sharding_tree(model.specs(), rules_, ctx.mesh)
    kw = {} if enc_len is None else {"enc_len": enc_len}
    cache_sh = sharding_tree(model.cache_specs(batch, max_len, **kw),
                             rules_, ctx.mesh)
    return params_sh, cache_sh


# ------------------------------------------------------- on a mesh (M18) --
def _require_serve_mesh(model, ctx: ShardCtx, what: str) -> None:
    from repro_torch.runtime.train import _require_mesh_step
    _require_mesh_step(model, ctx, what)


def batch_pspec(ctx: ShardCtx, batch: int, ndim: int) -> P:
    """The tokens' (or positions') placement: rows over the batch axes
    where ``batch`` splits over them, else whole on every coordinate (the
    reference's ``launch/dryrun.py::batch_pspec``)."""
    parts = [None] * ndim
    if batch % ctx.axis_size(ctx.batch_axes) == 0:
        parts[0] = ctx.batch_axes
    return P(*parts)


def _cache_kw(model, enc_len: int | None) -> dict:
    """``cache_specs``' keywords: ``enc_len`` for an encoder-decoder; a
    decoder-only model's cache has no cross K/V (its ``cache_specs`` takes
    no ``enc_len``, as the reference's)."""
    if enc_len is None:
        return {}
    if not model.cfg.is_encoder_decoder:
        raise TypeError(f"enc_len: {model.cfg.name} is decoder-only, its "
                        "cache has no cross K/V")
    return {"enc_len": enc_len}


def init_cache(model, ctx: ShardCtx, batch: int, max_len: int,
               dtype: torch.dtype | None = None,
               enc_len: int | None = None) -> dict:
    """``model.init_cache`` placed by :func:`serve_shardings`' cache tree,
    made block by block on the coordinates' devices: every ``pos`` -1,
    the rest zeros; ``dtype`` casts the bf16 leaves as there; ``enc_len``
    sizes an encoder-decoder's cross K/V."""
    _require_serve_mesh(model, ctx, "init_cache")
    kw = _cache_kw(model, enc_len)
    _, cache_sh = serve_shardings(model, ctx, batch, max_len, **kw)
    specs = model.cache_specs(batch, max_len, **kw)
    leaves = {}
    map_with_path(lambda path, sh: leaves.__setitem__(path, sh), cache_sh)

    def make(path, spec):
        if path[-1] == "pos":
            return spmd.empty(spec.shape, spec.dtype, leaves[path], fill=-1)
        dt = dtype if dtype and spec.dtype == torch.bfloat16 else None
        return spmd.empty(spec.shape, dt or spec.dtype, leaves[path])
    return map_with_path(make, specs)


def _mesh_step(model, ctx: ShardCtx, batch: int, max_len: int, what: str,
               enc_len: int | None = None):
    """The checks and layouts both placed serve steps share."""
    _require_serve_mesh(model, ctx, what)
    params_sh, cache_sh = serve_shardings(model, ctx, batch, max_len,
                                          **_cache_kw(model, enc_len))
    named = spmd.named_shardings(model, params_sh)

    def check(params, cache):
        for n, sh in named.items():
            spmd.check(params.get(n), sh, n)
        spmd.map_tree(lambda x, sh: spmd.check(x, sh, "cache leaf"), cache,
                      cache_sh)
    return check


def jit_prefill_step(model, ctx: ShardCtx, batch: int, max_len: int,
                     enc_len: int | None = None):
    """The prefill step (``make_prefill_step``) on placed parameters and a
    placed cache (:func:`init_cache`, ``enc_len`` as there):
    ``prefill(params, tokens (B,S), positions (B,S[+N]), cache[,
    embeds]) -> (last-position logits (B,1,V) fp32, whole on coordinate
    0's device, cache)``, the cache filled in place; ``embeds`` (a vision
    frontend's N patch rows, or an encoder-decoder's frames) placed by the
    step as the reference's dry run places them
    (``batch_pspec(ctx, B, 3)``).  Without a mesh, ``params`` must be
    None: the model's own are read."""
    if ctx.mesh is None:
        step = make_prefill_step(model, ctx)

        def plain(params, tokens, positions, cache, embeds=None):
            _own_params(params)
            return step(tokens, positions, cache, embeds)
        return plain
    check = _mesh_step(model, ctx, batch, max_len, "jit_prefill_step",
                       enc_len)
    tok_sh = NamedSharding(ctx.mesh, batch_pspec(ctx, batch, 2))
    emb_sh = NamedSharding(ctx.mesh, batch_pspec(ctx, batch, 3))

    @torch.no_grad()
    def prefill(params, tokens, positions, cache, embeds=None):
        check(params, cache)
        hidden, cache, _ = model.prefill(
            spmd.place(tokens, tok_sh), spmd.place(positions, tok_sh),
            cache, ctx, params=params,
            embeds=None if embeds is None else spmd.place(embeds, emb_sh))
        last = hidden.map(lambda h: h[:, -1:])
        return spmd.gather(model.logits(last, params, ctx)), cache
    return prefill


def jit_decode_step(model, ctx: ShardCtx, batch: int, max_len: int,
                    enc_len: int | None = None, donate: bool = True):
    """The reference's decode-step builder: ``decode(params, tokens (B,1),
    positions (B,), cache) -> (logits (B,1,V) fp32, cache)``.  With a
    mesh the layouts come from :func:`serve_shardings` (a leaf placed
    otherwise raises), the logits come back whole on coordinate 0's
    device.  The cache is written in place; ``donate=False`` writes a copy
    and returns it, the caller's left as it was, with a mesh or without.
    Without a mesh, ``params`` must be None and the eager step runs on the
    model's own parameters.  ``enc_len`` sizes an encoder-decoder's cross
    K/V (a decoder-only model's raises ``TypeError``)."""
    if ctx.mesh is None:
        step = make_decode_step(model, ctx)

        def plain(params, tokens, positions, cache):
            _own_params(params)
            if not donate:
                cache = _clone_tree(cache)
            return step(tokens, positions, cache)
        return plain
    check = _mesh_step(model, ctx, batch, max_len, "jit_decode_step",
                       enc_len)
    tok_sh = NamedSharding(ctx.mesh, batch_pspec(ctx, batch, 2))
    pos_sh = NamedSharding(ctx.mesh, batch_pspec(ctx, batch, 1))

    @torch.no_grad()
    def decode(params, tokens, positions, cache):
        check(params, cache)
        if not donate:
            cache = _clone_tree(cache)
        logits, cache = model.decode(
            spmd.place(tokens, tok_sh), spmd.place(positions, pos_sh),
            cache, ctx, params=params)
        return spmd.gather(logits), cache
    return decode


def _clone_tree(cache):
    """A copy of every leaf of a cache, placed or not."""
    return spmd.map_tree(lambda x: x.map(torch.clone) if isinstance(
        x, spmd.Placed) else x.clone() if isinstance(x, torch.Tensor) else x,
        cache)


def _own_params(params) -> None:
    if params is not None:
        raise ValueError("without a mesh the serve steps read the model's "
                         "own parameters; pass params=None")
