"""DeepSeek-V3 Multi-head Latent Attention (MLA), arXiv:2412.19437 §2.1.

Queries, keys and values come through low-rank latent projections; the
decode cache stores only the compressed latent ``c_kv`` (kv_lora_rank)
and the shared RoPE key (qk_rope_head_dim) a token.  Decode uses the
*absorbed* form: ``w_k_up`` is folded into the query and ``w_v_up`` into
the output, so scores and values are computed in latent space.

The query/key head is ``qk_nope + qk_rope`` wide (192 at deepseek-v3's
width) and the value head ``v_head_dim`` (128), so MLA never reaches the
flash kernel K3: as in the reference, ``impl="blocked"`` past 1,024
tokens takes the plain blocked attention and everything else the dot
path.  The cache is written in place (the reference donates it).

On a mesh (:func:`mla_placed`) each coordinate holds its heads of
``w_q_up``, ``w_k_up``, ``w_v_up`` and ``wo`` (the reference's "heads"
over the model axis) and the down projections and norms whole, so every
coordinate computes the same latents; its share of the output projection
is summed over the model axis by the caller.  A latent cache whose slots
split over mesh axes (SP) is written block by block at the absolute slot,
and the absorbed decode merges each block's partial softmax
(``attention.merge_partials``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.attention import (NEG_INF, _block_partials,
                                          block_write, blocked_attention,
                                          merge_partials)
from repro_torch.models.compute import einsum_f32
from repro_torch.models.layers import (SpecModule, apply_rope, rms_norm,
                                       rope_cos_sin)
from repro_torch.models.params import ParamSpec


def mla_specs(cfg: ArchConfig, prefix_axes=()) -> dict:
    m = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    pa = prefix_axes
    bf16, f32 = torch.bfloat16, torch.float32
    return {
        # query low-rank path
        "w_q_down": ParamSpec((d, m.q_lora_rank), bf16,
                              pa + ("embed", "q_lora")),
        "q_norm": ParamSpec((m.q_lora_rank,), f32, pa + (None,), "ones"),
        "w_q_up": ParamSpec((m.q_lora_rank, h, qk_head), bf16,
                            pa + ("q_lora", "heads", None), fan_in_dim=0),
        # kv low-rank path: joint down-proj emits [c_kv ; k_rope]
        "w_kv_down": ParamSpec((d, m.kv_lora_rank + m.qk_rope_head_dim),
                               bf16, pa + ("embed", None)),
        "kv_norm": ParamSpec((m.kv_lora_rank,), f32, pa + (None,), "ones"),
        "w_k_up": ParamSpec((m.kv_lora_rank, h, m.qk_nope_head_dim), bf16,
                            pa + ("kv_lora", "heads", None), fan_in_dim=0),
        "w_v_up": ParamSpec((m.kv_lora_rank, h, m.v_head_dim), bf16,
                            pa + ("kv_lora", "heads", None), fan_in_dim=0),
        "wo": ParamSpec((h, m.v_head_dim, d), bf16,
                        pa + ("heads", None, "embed"), fan_in_dim=(0, 1)),
    }


def _latents(p, x, cfg: ArchConfig, positions):
    """Shared q / c_kv / k_rope computation. x: (B,S,d)."""
    m = cfg.mla
    q_lat = rms_norm(p["q_norm"],
                     torch.einsum("bsd,dr->bsr", x, p["w_q_down"]),
                     cfg.norm_eps)
    q = torch.einsum("bsr,rhe->bshe", q_lat, p["w_q_up"])
    q_nope = q[..., : m.qk_nope_head_dim]
    q_rope = q[..., m.qk_nope_head_dim:]

    kv = torch.einsum("bsd,dr->bsr", x, p["w_kv_down"])
    c_kv = rms_norm(p["kv_norm"], kv[..., : m.kv_lora_rank], cfg.norm_eps)
    k_rope = kv[..., m.kv_lora_rank:]              # (B,S,rope_dim), shared

    cos, sin = rope_cos_sin(positions, m.qk_rope_head_dim, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope = apply_rope(k_rope[:, :, None, :], cos, sin)[:, :, 0, :]
    return q_nope, q_rope, c_kv, k_rope


def _mla_attend(p, q_nope, q_rope, c_kv, k_rope, cfg: ArchConfig,
                positions, impl: str):
    """Full-rank causal attention shared by forward and prefill.
    ``impl="blocked"`` past 1,024 tokens streams KV blocks so the (S, S)
    logits never exist; otherwise the dot path."""
    m = cfg.mla
    k_nope = torch.einsum("bsr,rhe->bshe", c_kv, p["w_k_up"])
    v = torch.einsum("bsr,rhe->bshe", c_kv, p["w_v_up"])
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    s = q_nope.shape[1]
    if impl == "blocked" and s > 1024:
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
            *k_nope.shape[:3], k_rope.shape[-1])], dim=-1)
        out = blocked_attention(q, k, v, scale, positions, positions,
                                causal=True)
        return torch.einsum("bshe,hed->bsd", out, p["wo"])
    logits = (einsum_f32("bqhe,bkhe->bhqk", q_nope, k_nope)
              + einsum_f32("bqhe,bke->bhqk", q_rope, k_rope)) * scale
    mask = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                 device=q_nope.device))
    logits = torch.where(mask[None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = einsum_f32("bhqk,bkhe->bqhe", probs.to(v.dtype),
                     v).to(q_nope.dtype)
    return torch.einsum("bshe,hed->bsd", out, p["wo"])


def mla_forward(p, x, cfg: ArchConfig, positions,
                impl: str = "blocked") -> torch.Tensor:
    """Training / prefill self-attention. x: (B,S,d) -> (B,S,d)."""
    q_nope, q_rope, c_kv, k_rope = _latents(p, x, cfg, positions)
    return _mla_attend(p, q_nope, q_rope, c_kv, k_rope, cfg, positions,
                       impl)


# ---------------------------------------------------------------- decode ---
def mla_cache_specs(cfg: ArchConfig, batch: int, max_len: int,
                    prefix_axes=()) -> dict:
    m = cfg.mla
    pa = prefix_axes
    return {
        "c_kv": ParamSpec((batch, max_len, m.kv_lora_rank), torch.bfloat16,
                          pa + ("batch", "kv_seq", None), "zeros"),
        "k_rope": ParamSpec((batch, max_len, m.qk_rope_head_dim),
                            torch.bfloat16, pa + ("batch", "kv_seq", None),
                            "zeros"),
        "pos": ParamSpec((batch, max_len), torch.int32,
                         pa + ("batch", "kv_seq"), "zeros"),
    }


def mla_prefill(p, x, cfg: ArchConfig, cache: dict, positions,
                impl: str = "blocked"):
    """Prefill: full-rank attention + the latent cache's bulk fill at the
    slots ``positions`` (in place). x: (B,S,d).  Returns (y, cache)."""
    q_nope, q_rope, c_kv, k_rope = _latents(p, x, cfg, positions)
    y = _mla_attend(p, q_nope, q_rope, c_kv, k_rope, cfg, positions, impl)
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    slots = positions.long()
    cache["c_kv"][rows, slots] = c_kv.to(cache["c_kv"].dtype)
    cache["k_rope"][rows, slots] = k_rope.to(cache["k_rope"].dtype)
    cache["pos"][rows, slots] = positions.to(cache["pos"].dtype)
    return y, cache


def mla_decode(p, x, cfg: ArchConfig, cache: dict, positions):
    """Absorbed single-token decode.  x: (B,1,d); positions: (B,).

    scores_k = q_nope @ w_k_up^T @ c_kv^T  (w_k_up absorbed into the query)
    out      = probs @ c_kv @ w_v_up       (w_v_up absorbed into the output)

    The slot is the absolute position (the MLA cache never windows),
    clamped to the last slot as the reference's ``dynamic_update_slice``
    clamps it; the mask is ``arange(W) <= positions``.
    """
    m = cfg.mla
    q_nope, q_rope, c_kv_new, k_rope_new = _latents(
        p, x, cfg, positions[:, None])
    width = cache["c_kv"].shape[1]
    rows = torch.arange(x.shape[0], device=x.device)
    slots = positions.long().clamp(0, width - 1)
    cache["c_kv"][rows, slots] = c_kv_new[:, 0].to(cache["c_kv"].dtype)
    cache["k_rope"][rows, slots] = k_rope_new[:, 0].to(cache["k_rope"].dtype)
    cache["pos"][rows, slots] = positions.to(cache["pos"].dtype)

    # absorbed queries: (B,1,H,nope) x (kv_lora,H,nope) -> (B,1,H,kv_lora)
    q_abs = torch.einsum("bqhe,rhe->bqhr", q_nope, p["w_k_up"])
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    logits = (einsum_f32("bqhr,bkr->bhqk", q_abs, cache["c_kv"])
              + einsum_f32("bqhe,bke->bhqk", q_rope, cache["k_rope"])) * scale
    valid = (torch.arange(width, device=x.device)[None]
             <= positions[:, None])                       # (B, W)
    logits = torch.where(valid[:, None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    o_lat = einsum_f32("bhqk,bkr->bqhr", probs.to(cache["c_kv"].dtype),
                       cache["c_kv"])
    out = torch.einsum("bqhr,rhe->bqhe", o_lat.to(x.dtype), p["w_v_up"])
    return torch.einsum("bshe,hed->bsd", out, p["wo"]), cache


def _absorbed_query(p, q_nope, q_rope):
    """The absorbed decode's query (B, 1, H, kv_lora + rope): ``w_k_up``
    folded into ``q_nope``, beside ``q_rope``; its product with a cache
    row [c_kv ; k_rope] is the reference's two score terms."""
    q_abs = torch.einsum("bqhe,rhe->bqhr", q_nope, p["w_k_up"])
    return torch.cat([q_abs, q_rope.to(q_abs.dtype)], -1)


def mla_placed(hs: list, ws: list, cfg: ArchConfig, positions: list, *,
               mode: str, views, mesh, model_axis: str, seq_axes,
               q_first: list, impl: str = "blocked") -> list:
    """MLA on rank lists (``models/transformer.py::_mesh_block``): ``hs``
    each coordinate's normed input, ``ws`` its weights (its heads of the
    up projections and ``wo`` from head ``q_first``, the rest whole),
    ``views`` its block of the layer's latent cache (None in train mode),
    whole on the slots or split over ``seq_axes`` (SP).  Returns each
    coordinate's share of the output projection (the partial sum over its
    heads).

    Under SP a prefill attends its fresh latents and each coordinate
    writes the tokens whose slots its block holds; a decode step writes
    the token at its slot (the position clamped to the last slot, as
    :func:`mla_decode`), each coordinate scores the heads its block serves
    (every head, the absorbed queries gathered over the model axis, where
    the model axis splits the slots) over its slots, masked by slot <=
    position as there, and the blocks' fp32 partials merge over
    ``seq_axes``; each coordinate keeps its own heads for ``w_v_up`` and
    ``wo``."""
    n = len(hs)
    if mode == "train":
        return [mla_forward(ws[r], hs[r], cfg, positions[r], impl)
                for r in range(n)]
    if seq_axes is None:
        step = ((lambda r: mla_prefill(ws[r], hs[r], cfg, views[r],
                                       positions[r], impl))
                if mode == "prefill" else
                (lambda r: mla_decode(ws[r], hs[r], cfg, views[r],
                                      positions[r])))
        return [step(r)[0] for r in range(n)]
    from repro_torch.sharding import spmd
    m = cfg.mla
    w_loc = views[0]["c_kv"].shape[1]
    blk = spmd.axis_index(mesh, seq_axes)
    width = w_loc * math.prod(mesh.shape[a] for a in spmd._axes(seq_axes))
    pos = positions if mode == "prefill" else [p[:, None]
                                               for p in positions]
    lat = [_latents(ws[r], hs[r], cfg, pos[r]) for r in range(n)]
    for r, (_, _, c_kv, k_rope) in enumerate(lat):
        slots = pos[r] if mode == "prefill" else pos[r].clamp(0, width - 1)
        block_write(views[r], {"c_kv": c_kv, "k_rope": k_rope,
                               "pos": pos[r]}, slots, blk[r] * w_loc)
    if mode == "prefill":
        return [_mla_attend(ws[r], *lat[r], cfg, positions[r], impl)
                for r in range(n)]
    qs = [_absorbed_query(ws[r], lat[r][0], lat[r][1]) for r in range(n)]
    n_q = qs[0].shape[2]
    if n_q < cfg.num_heads and model_axis in spmd._axes(seq_axes):
        qs = spmd.all_gather(qs, mesh, model_axis, 2)
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    parts = []
    for r, v in enumerate(views):
        slot = blk[r] * w_loc + torch.arange(w_loc, device=v["pos"].device)
        valid = slot[None] <= positions[r][:, None]           # (B, w_loc)
        kv = torch.cat([v["c_kv"], v["k_rope"]], -1)[:, :, None]
        parts.append(_block_partials(qs[r], kv, v["c_kv"][:, :, None],
                                     valid[:, None, None, None], scale))
    outs = []
    for r, o in enumerate(merge_partials(parts, mesh, seq_axes)):
        o = o.reshape(o.shape[0], 1, -1, o.shape[-1])       # (B,1,H,r)
        if o.shape[2] > n_q:
            o = o[:, :, q_first[r]:q_first[r] + n_q]
        out = torch.einsum("bqhr,rhe->bqhe", o.to(hs[r].dtype),
                           ws[r]["w_v_up"])
        outs.append(torch.einsum("bshe,hed->bsd", out, ws[r]["wo"]))
    return outs


class MLA(SpecModule):
    """Holds one layer's MLA weights in the reference's layouts."""

    def __init__(self, cfg: ArchConfig, *, device, dtype):
        super().__init__(mla_specs(cfg), device=device, dtype=dtype)
        self.cfg = cfg
        self.tree = self.param_tree()       # updated in place, built once

    def forward(self, x, positions, impl: str = "blocked"):
        return mla_forward(self.tree, x, self.cfg, positions, impl)

    def prefill(self, x, cache: dict, positions, impl: str = "blocked"):
        return mla_prefill(self.tree, x, self.cfg, cache, positions,
                           impl=impl)[0]

    def decode(self, x, cache: dict, positions):
        return mla_decode(self.tree, x, self.cfg, cache, positions)[0]
