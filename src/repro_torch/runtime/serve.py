"""Serve-step builders: prefill + decode over the ring, latent and
encoder-decoder caches.

The reference jits these steps and donates the cache to the decode step;
here they run eagerly and write the cache in place.  ``serve_shardings``
gives the reference's spec trees of the parameters and the cache on a
mesh; nothing places the arrays by them (``sharding/rules.py``).
"""
from __future__ import annotations

import torch

from repro_torch.sharding.rules import ShardCtx, default_rules, sharding_tree


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
