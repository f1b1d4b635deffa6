"""Serve-step builders: prefill + decode over the ring cache.

The reference jits these steps and donates the cache to the decode step;
here they run eagerly and write the cache in place.  ``serve_shardings``
and ``jit_decode_step`` are bound to meshes and arrive with them
(ROADMAP.md, M14b).
"""
from __future__ import annotations

import torch

from repro_torch.sharding.rules import ShardCtx


def make_prefill_step(model, ctx: ShardCtx):
    """(tokens (B,S), positions (B,S), cache[, embeds]) -> (last-position
    logits (B,1,V) fp32, cache)."""
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
