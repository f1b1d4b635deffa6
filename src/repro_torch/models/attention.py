"""GQA attention (train / prefill / decode) with QKV-bias, qk-norm and
sliding-window variants, plus the unified ring-buffer KV cache.

The KV cache is a *ring buffer* of width W:

  * full attention:   W = max_seq_len  (slot == position, never wraps)
  * sliding window:   W = window       (slot = position mod W)

Each slot stores the absolute position it holds (``pos``, -1 = empty), so
the decode mask is position arithmetic and wrap-around is free.  Where the
reference returns a new cache from each update, the port writes the cache's
tensors in place and returns the same dict: the reference's decode step
donates its cache, so no caller holds the old one.

Training runs ``attn_forward`` through the blocked core, a
``torch.autograd.Function`` whose backward recomputes the probabilities
block by block from the saved log-sum-exp (the reference's custom VJP, in
plain PyTorch: the flash kernel K3 has no backward, as the reference's
Pallas kernel has none).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.compute import einsum_f32
from repro_torch.models.layers import (SpecModule, apply_rope, rms_norm,
                                       rope_cos_sin)
from repro_torch.models.params import ParamSpec

NEG_INF = -2.0 ** 30  # large-negative that survives bf16/f32 softmax


# ----------------------------------------------------------------- specs ---
def attention_specs(cfg: ArchConfig, prefix_axes=()):
    d, h, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    pa = prefix_axes
    bf16, f32 = torch.bfloat16, torch.float32
    sp = {
        "wq": ParamSpec((d, h, hd), bf16,
                        pa + ("embed", "heads", None), fan_in_dim=0),
        "wk": ParamSpec((d, hkv, hd), bf16,
                        pa + ("embed", "kv_heads", None), fan_in_dim=0),
        "wv": ParamSpec((d, hkv, hd), bf16,
                        pa + ("embed", "kv_heads", None), fan_in_dim=0),
        "wo": ParamSpec((h, hd, d), bf16,
                        pa + ("heads", None, "embed"), fan_in_dim=(0, 1)),
    }
    if cfg.qkv_bias:
        sp["bq"] = ParamSpec((h, hd), f32, pa + ("heads", None), "zeros")
        sp["bk"] = ParamSpec((hkv, hd), f32, pa + ("kv_heads", None), "zeros")
        sp["bv"] = ParamSpec((hkv, hd), f32, pa + ("kv_heads", None), "zeros")
    if cfg.qk_norm:
        sp["q_norm"] = ParamSpec((hd,), f32, pa + (None,), "ones")
        sp["k_norm"] = ParamSpec((hd,), f32, pa + (None,), "ones")
    if cfg.norm == "layernorm":  # whisper-style out-proj bias
        sp["bo"] = ParamSpec((d,), f32, pa + (None,), "zeros")
    return sp


# ------------------------------------------------------------ core math ----
def grouped_dot_attention(q, k, v, mask, scale: float):
    """GQA attention without materialising repeated KV heads.

    q: (B, Sq, Hq, D); k,v: (B, Skv, Hkv, D); mask broadcastable to
    (B, Hkv, G, Sq, Skv) or (B, 1, 1, Sq, Skv). fp32 softmax.
    """
    b, sq, hq, dd = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, dd)
    logits = einsum_f32("bqhgd,bkhd->bhgqk", qg, k) * scale
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = einsum_f32("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v)
    return out.reshape(b, sq, hq, dd).to(q.dtype)


def causal_mask(sq: int, skv: int, window: int | None, offset: int = 0,
                device=None):
    """(sq, skv) bool mask; query i attends to kv j iff j <= i+offset and
    within the sliding window."""
    qi = torch.arange(sq, device=device)[:, None] + offset
    kj = torch.arange(skv, device=device)[None, :]
    m = kj <= qi
    if window is not None:
        m &= kj > qi - window
    return m


# ------------------------------------------------------------- KV cache ----
def kv_cache_specs(cfg: ArchConfig, batch: int, max_len: int,
                   prefix_axes=()) -> dict:
    """Ring-buffer cache specs for one attention layer (stacked by caller)."""
    w = ring_width(cfg, max_len)
    hkv, hd = cfg.num_kv_heads, cfg.head_dim
    pa = prefix_axes
    return {
        "k": ParamSpec((batch, w, hkv, hd), torch.bfloat16,
                       pa + ("batch", "kv_seq", "kv_heads", None), "zeros"),
        "v": ParamSpec((batch, w, hkv, hd), torch.bfloat16,
                       pa + ("batch", "kv_seq", "kv_heads", None), "zeros"),
        "pos": ParamSpec((batch, w), torch.int32, pa + ("batch", "kv_seq"),
                         "zeros"),
    }


def ring_width(cfg: ArchConfig, max_len: int) -> int:
    if cfg.sliding_window is not None:
        return min(cfg.sliding_window, max_len)
    return max_len


def init_cache_pos(cache: dict) -> dict:
    """Mark all slots empty (pos = -1), in place."""
    cache["pos"].fill_(-1)
    return cache


def ring_cache_update(cache: dict, k_new, v_new, positions):
    """k_new/v_new: (B, 1, Hkv, D); positions: (B,) absolute index.  Writes
    each row's slot ``position % W`` in place."""
    width = cache["k"].shape[1]
    rows = torch.arange(positions.shape[0], device=positions.device)
    slots = (positions % width).long()
    cache["k"][rows, slots] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][rows, slots] = v_new[:, 0].to(cache["v"].dtype)
    cache["pos"][rows, slots] = positions.to(cache["pos"].dtype)
    return cache


def ring_cache_mask(pos_buf, positions, window: int | None):
    """(B, 1, 1, 1, W) mask of valid slots for the current query position."""
    p = positions[:, None].to(torch.int32)
    m = (pos_buf >= 0) & (pos_buf <= p)
    if window is not None:
        m &= pos_buf > p - window
    return m[:, None, None, None, :]


def ring_cache_fill(cache: dict, k, v, positions):
    """Bulk-fill the ring cache from a prefill, in place. k/v: (B,S,Hkv,D);
    positions: (B,S). Keeps the last ``width`` tokens."""
    w = cache["k"].shape[1]
    keep = min(k.shape[1], w)
    ks, vs, ps = k[:, -keep:], v[:, -keep:], positions[:, -keep:]
    rows = torch.arange(k.shape[0], device=k.device)[:, None]
    slots = (ps % w).long()
    cache["k"][rows, slots] = ks.to(cache["k"].dtype)
    cache["v"][rows, slots] = vs.to(cache["v"].dtype)
    cache["pos"][rows, slots] = ps.to(cache["pos"].dtype)
    return cache


# ------------------------------------------------- blocked (flash) path ----
def _flash_mask(q_pos, kpos, vld, causal, window):
    msk = vld[:, None]                                       # (B,1,K)
    if causal:
        msk = msk & (kpos[:, None] <= q_pos[:, :, None])
    if window is not None:
        msk = msk & (kpos[:, None] > q_pos[:, :, None] - window)
    return msk[:, None, None]                                # (B,1,1,Sq,K)


def _flash_fwd_impl(q, k, v, q_pos, kv_pos, kv_valid, scale, window, causal,
                    block_k):
    """Running (max, sum, acc) over KV blocks; rescale, then accumulate.
    Returns ``(out, lse)``: lse (B,Hkv,G,Sq) fp32, +inf where a query
    attends to nothing."""
    b, sq, hq, dd = q.shape
    hkv = k.shape[2]
    dv = v.shape[3]
    g = hq // hkv
    nb = k.shape[1] // block_k
    qg = q.reshape(b, sq, hkv, g, dd)
    dev = q.device
    m = torch.full((b, hkv, g, sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, g, sq, dv), dtype=torch.float32, device=dev)
    for i in range(nb):
        blk = slice(i * block_k, (i + 1) * block_k)
        kblk, vblk = k[:, blk], v[:, blk]
        logits = einsum_f32("bqhgd,bkhd->bhgqk", qg, kblk) * scale
        logits = torch.where(
            _flash_mask(q_pos, kv_pos[:, blk], kv_valid[:, blk], causal,
                        window), logits, NEG_INF)
        mnew = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - mnew[..., None])
        corr = torch.exp(m - mnew)
        l = l * corr + p.sum(dim=-1)
        acc = (acc * corr[..., None]
               + einsum_f32("bhgqk,bkhd->bhgqd", p.to(vblk.dtype), vblk))
        m = mnew
    out = acc / l.clamp_min(1e-30)[..., None]
    lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)),
                      torch.full_like(l, float("inf")))
    out = out.movedim(-2, 1).reshape(b, sq, hq, dv)
    return out.to(q.dtype), lse


def _flash_bwd_impl(q, k, v, q_pos, kv_pos, kv_valid, out, lse, do, scale,
                    window, causal, block_k):
    """Flash backward: recompute p a block at a time from the saved lse;
    never an (Sq, Skv) matrix.  Returns (dq, dk, dv) in q/k/v's dtypes."""
    b, sq, hq, dd = q.shape
    hkv = k.shape[2]
    dv = v.shape[3]
    g = hq // hkv
    nb = k.shape[1] // block_k
    qg = q.reshape(b, sq, hkv, g, dd)
    qt = qg.permute(0, 2, 3, 1, 4)                          # (B,H,G,Sq,D)
    dog = do.reshape(b, sq, hkv, g, dv).movedim(1, -2)
    outg = out.reshape(b, sq, hkv, g, dv).movedim(1, -2)
    dsum = (dog.to(torch.float32) * outg.to(torch.float32)).sum(-1)
    dq = torch.zeros((b, hkv, g, sq, dd), dtype=torch.float32,
                     device=q.device)
    dks, dvs = [], []
    for i in range(nb):
        blk = slice(i * block_k, (i + 1) * block_k)
        kblk, vblk = k[:, blk], v[:, blk]
        logits = einsum_f32("bqhgd,bkhd->bhgqk", qg, kblk) * scale
        logits = torch.where(
            _flash_mask(q_pos, kv_pos[:, blk], kv_valid[:, blk], causal,
                        window), logits, NEG_INF)
        p = torch.exp(logits - lse[..., None])              # (B,H,G,Sq,K)
        dvs.append(einsum_f32("bhgqk,bhgqd->bkhd", p.to(do.dtype), dog))
        dp = einsum_f32("bhgqd,bkhd->bhgqk", dog, vblk)
        ds = p * (dp - dsum[..., None]) * scale
        dq = dq + einsum_f32("bhgqk,bkhd->bhgqd", ds.to(kblk.dtype), kblk)
        dks.append(einsum_f32("bhgqk,bhgqd->bkhd", ds.to(q.dtype), qt))
    dq = dq.movedim(-2, 1).reshape(b, sq, hq, dd).to(q.dtype)
    return (dq, torch.cat(dks, dim=1).to(k.dtype),
            torch.cat(dvs, dim=1).to(v.dtype))


class _FlashCore(torch.autograd.Function):
    """The blocked core with the reference's custom VJP: the forward saves
    only (inputs, out, lse), the backward recomputes block by block."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos, kv_valid, scale, window,
                causal, block_k):
        out, lse = _flash_fwd_impl(q, k, v, q_pos, kv_pos, kv_valid, scale,
                                   window, causal, block_k)
        ctx.save_for_backward(q, k, v, q_pos, kv_pos, kv_valid, out, lse)
        ctx.static = (scale, window, causal, block_k)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, q_pos, kv_pos, kv_valid, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd_impl(q, k, v, q_pos, kv_pos, kv_valid, out,
                                     lse, do, *ctx.static)
        return dq, dk, dv, None, None, None, None, None, None, None


def blocked_attention(q, k, v, scale: float, q_pos, kv_pos,
                      window: int | None = None, causal: bool = True,
                      block_k: int = 512, kv_valid=None):
    """Flash attention in plain PyTorch with a hand-written backward: the
    forward loops over KV blocks with a running (max, sum, acc) and saves
    only (out, lse); the backward recomputes the probabilities block by
    block.  Memory is O(Sq * block_k), never O(Sq * Skv), both ways.

    q: (B,Sq,Hq,D); k,v: (B,Skv,Hkv,D); q_pos: (B,Sq); kv_pos: (B,Skv)
    kv_valid: optional (B,Skv) bool (slot validity).
    """
    b, skv = k.shape[0], k.shape[1]
    bk = min(block_k, skv)
    pad = (-skv) % bk
    if kv_valid is None:
        kv_valid = torch.ones((b, skv), dtype=torch.bool, device=k.device)
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_pos = F.pad(kv_pos, (0, pad), value=-1)
        kv_valid = F.pad(kv_valid, (0, pad))
    return _FlashCore.apply(q, k, v, q_pos, kv_pos, kv_valid, float(scale),
                            window, causal, bk)


# ---------------------------------------------------------- layer logic ----
def _project_qkv(x, cfg: ArchConfig, *, wq, wk, wv, bq=None, bk=None,
                 bv=None, q_norm=None, k_norm=None):
    """x: (B,S,d) -> q (B,S,H,hd), k,v (B,S,Hkv,hd)."""
    q = torch.einsum("bsd,dhe->bshe", x, wq)
    k = torch.einsum("bsd,dhe->bshe", x, wk)
    v = torch.einsum("bsd,dhe->bshe", x, wv)
    if cfg.qkv_bias:
        q = q + bq.to(q.dtype)
        k = k + bk.to(k.dtype)
        v = v + bv.to(v.dtype)
    if cfg.qk_norm:
        q = rms_norm(q_norm, q, cfg.norm_eps)
        k = rms_norm(k_norm, k, cfg.norm_eps)
    return q, k, v


def _self_attention(q, k, v, cfg: ArchConfig, positions, causal: bool,
                    impl: str):
    s = q.shape[1]
    scale = cfg.head_dim ** -0.5
    if impl == "flash" and causal:
        # K3 has no backward, as the reference's Pallas kernel has no VJP
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            raise ValueError("K3 has no backward; train with "
                             "attn_impl='blocked'")
        from repro_torch.kernels.flash_attention import ops as fa_ops
        return fa_ops.flash_attention(q, k, v, causal=True,
                                      window=cfg.sliding_window, scale=scale)
    if impl == "blocked":
        return blocked_attention(q, k, v, scale, positions, positions,
                                 window=cfg.sliding_window if causal else None,
                                 causal=causal)
    if impl not in ("dot", "flash"):
        raise ValueError(f"attention impl {impl!r}; one of blocked, dot, "
                         "flash")
    if causal:
        m = causal_mask(s, s, cfg.sliding_window,
                        device=q.device)[None, None, None]
    else:
        m = torch.ones((1, 1, 1, s, s), dtype=torch.bool, device=q.device)
    return grouped_dot_attention(q, k, v, m, scale)


class Attention(SpecModule):
    """Holds one layer's attention weights in the reference's layouts."""

    def __init__(self, cfg: ArchConfig, *, device, dtype):
        super().__init__(attention_specs(cfg), device=device, dtype=dtype)
        self.cfg = cfg

    def project_qkv(self, x: torch.Tensor):
        opt = {n: getattr(self, n, None)
               for n in ("bq", "bk", "bv", "q_norm", "k_norm")}
        return _project_qkv(x, self.cfg, wq=self.wq, wk=self.wk, wv=self.wv,
                            **opt)

    def project_out(self, out: torch.Tensor) -> torch.Tensor:
        """out: (B,S,H,hd) -> (B,S,d)."""
        y = torch.einsum("bshe,hed->bsd", out, self.wo)
        bo = getattr(self, "bo", None)
        return y if bo is None else y + bo.to(y.dtype)

    def forward(self, x, positions, impl: str = "blocked"):
        return attn_forward(self, x, positions, impl=impl)

    def prefill(self, x, cache: dict, positions, impl: str = "blocked"):
        return attn_prefill(self, x, cache, positions, impl=impl)[0]

    def decode(self, x, cache: dict, positions):
        return attn_decode(self, x, cache, positions)[0]


def attn_forward(mixer: Attention, x, positions, *, causal: bool = True,
                 impl: str = "blocked"):
    """Full self-attention over x: (B, S, d), positions (B, S).  Used by
    the training forward."""
    cfg = mixer.cfg
    q, k, v = mixer.project_qkv(x)
    if not cfg.is_encoder_decoder or causal:  # rope for LM archs
        cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return mixer.project_out(_self_attention(q, k, v, cfg, positions,
                                             causal, impl))


def attn_prefill(mixer: Attention, x, cache: dict, positions, *,
                 impl: str = "blocked"):
    """Prefill: causal self-attention + bulk ring-cache fill (in place).
    x: (B, S, d); positions: (B, S).  Returns (y, cache)."""
    cfg = mixer.cfg
    q, k, v = mixer.project_qkv(x)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    out = _self_attention(q, k, v, cfg, positions, True, impl)
    cache = ring_cache_fill(cache, k, v, positions)
    return mixer.project_out(out), cache


def attn_decode(mixer: Attention, x, cache: dict, positions):
    """One-token decode. x: (B, 1, d); positions: (B,) absolute index.
    Returns (y, cache); the cache is written in place."""
    cfg = mixer.cfg
    q, k, v = mixer.project_qkv(x)
    cos, sin = rope_cos_sin(positions[:, None], cfg.head_dim, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    cache = ring_cache_update(cache, k, v, positions)
    mask = ring_cache_mask(cache["pos"], positions, cfg.sliding_window)
    out = grouped_dot_attention(q, cache["k"], cache["v"], mask,
                                cfg.head_dim ** -0.5)
    return mixer.project_out(out), cache


# ------------------------------------------------- one mesh coordinate ---
_QKV = ("wq", "wk", "wv", "bq", "bk", "bv", "q_norm", "k_norm")


def kv_heads_for(k, v, q_first: int, n_q: int, hq: int):
    """The KV heads read by query heads ``q_first .. q_first + n_q - 1``
    of ``hq``, from ``k``/``v`` (B, S, Hkv, D) holding every KV head (a
    KV-head count the model axis does not divide stays replicated while
    the query heads split: with 12 / 2 heads on 4 coordinates, coordinate
    j's heads 3j..3j+2 read KV head 3j // 6).  A run of whole groups is a
    slice of heads, so the grouped product and K3 keep their group;
    otherwise each query head gets its own KV head (group 1)."""
    if n_q == hq:
        return k, v
    g = hq // k.shape[2]
    idx = [(q_first + i) // g for i in range(n_q)]
    first, n_kv = idx[0], idx[-1] - idx[0] + 1
    if n_q % n_kv == 0 and idx == [first + i // (n_q // n_kv)
                                   for i in range(n_q)]:
        return k[:, :, first:first + n_kv], v[:, :, first:first + n_kv]
    ix = torch.tensor(idx, device=k.device)
    return k.index_select(2, ix), v.index_select(2, ix)


def _qkv_local(x, w: dict, cfg: ArchConfig, positions, mode: str,
               causal: bool = True):
    """A coordinate's q, k, v (its heads of ``w``), rotated where
    :func:`attn_forward` rotates them (not in an encoder's bidirectional
    attention)."""
    q, k, v = _project_qkv(x, cfg, **{n: w.get(n) for n in _QKV})
    if cfg.is_encoder_decoder and not causal:
        return q, k, v
    pos = positions if mode != "decode" else positions[:, None]
    cos, sin = rope_cos_sin(pos, cfg.head_dim, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _kv_for_q(k, v, q, q_first: int, cfg: ArchConfig):
    """The KV heads ``q``'s heads read where the query heads split while
    every KV head is held (``kv_heads_for``), else ``k``, ``v``."""
    if k.shape[2] == cfg.num_kv_heads and q.shape[2] < cfg.num_heads:
        return kv_heads_for(k, v, q_first, q.shape[2], cfg.num_heads)
    return k, v


def attn_local(x, w: dict, cfg: ArchConfig, positions, *, mode: str,
               q_first: int = 0, cache: dict | None = None,
               impl: str = "blocked", causal: bool = True):
    """One mesh coordinate's attention (``runtime/train.py::
    jit_train_step``, ``runtime/serve.py::jit_decode_step``): ``w`` holds
    its blocks of the layer's weights, gathered whole on "embed" (``wq``
    (d, h, hd) of its ``h`` query heads from ``q_first`` on, ``wk``/``wv``
    of its KV heads or of all, ``wo`` (h, hd, d), the biases and qk-norms
    alike).  mode: train (``attn_forward``), prefill (``attn_prefill``:
    ``cache`` is its block of the layer's ring, filled in place), decode
    (``attn_decode``); ``causal=False`` (train mode) is an encoder's
    bidirectional attention, unrotated, the plain product where ``impl``
    is flash (``_self_attention``).  Returns ``x``'s share of the output
    projection, (B, S, d), without ``bo``: the partial sum over its heads,
    which the caller sums over the model axis where the heads split, and
    adds the bias to once."""
    q, k, v = _qkv_local(x, w, cfg, positions, mode, causal)
    if mode == "decode":
        cache = ring_cache_update(cache, k, v, positions)
        ks, vs = _kv_for_q(cache["k"], cache["v"], q, q_first, cfg)
        mask = ring_cache_mask(cache["pos"], positions, cfg.sliding_window)
        out = grouped_dot_attention(q, ks, vs, mask, cfg.head_dim ** -0.5)
    else:
        ks, vs = _kv_for_q(k, v, q, q_first, cfg)
        out = _self_attention(q, ks, vs, cfg, positions, causal, impl)
        if mode == "prefill":
            ring_cache_fill(cache, k, v, positions)
    return torch.einsum("bshe,hed->bsd", out, w["wo"])


# ----------------------------------- a sequence-sharded ring cache (SP) ---
def block_write(cache: dict, vals: dict, slots, first: int):
    """``vals[name]`` (B, T, ...) written into one coordinate's block of a
    cache whose slots split over mesh axes, the block holding slots
    ``first`` .. ``first + w_loc - 1``: each token at its absolute slot
    (``slots`` (B, T)) where the block holds it, in place.  One token a
    row (a decode step) writes back what it read where its slot lies
    elsewhere; more go through a copy of the block with a spare slot the
    others land in."""
    w_loc = cache[next(iter(vals))].shape[1]
    local = slots.long() - first
    mine = (local >= 0) & (local < w_loc)
    rows = torch.arange(slots.shape[0], device=slots.device)[:, None]
    if slots.shape[1] == 1:
        at = local.clamp(0, w_loc - 1)
        for name, val in vals.items():
            buf = cache[name]
            sel = mine.reshape(mine.shape + (1,) * (val.dim() - 2))
            buf[rows, at] = torch.where(sel, val.to(buf.dtype), buf[rows, at])
        return cache
    at = torch.where(mine, local, w_loc)
    for name, val in vals.items():
        buf = cache[name]
        tmp = torch.cat([buf, buf[:, :1]], 1)
        tmp[rows, at] = val.to(buf.dtype)
        buf.copy_(tmp[:, :w_loc])
    return cache


def ring_block_write(cache: dict, k, v, positions, first: int, width: int):
    """``ring_cache_fill`` (``k``/``v`` (B, T, Hkv, D), positions (B, T))
    into one coordinate's block of a ring of ``width`` slots, the block
    holding slots ``first`` .. ``first + w_loc - 1``: of the last
    ``min(T, width)`` tokens each writes its slot where the block holds
    it, in place (:func:`block_write`)."""
    keep = min(k.shape[1], width)
    pos = positions[:, -keep:]
    return block_write(cache, {"k": k[:, -keep:], "v": v[:, -keep:],
                               "pos": pos}, pos % width, first)


def _block_partials(q, k, v, mask, scale: float):
    """Decode attention over one block of slots, unnormalised, in fp32:
    (o (B, 1, Hkv, G, D), the running max m and sum l (B, 1, Hkv, G)).  A
    block with no valid slot gives m = ``NEG_INF``, l = 0 and o = 0."""
    b, sq, hq, dd = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, hq // hkv, dd)
    logits = einsum_f32("bqhgd,bkhd->bhgqk", qg, k) * scale
    logits = torch.where(mask, logits, NEG_INF)
    m = logits.amax(dim=-1)
    p = torch.where(mask, torch.exp(logits - m[..., None]), 0.0)
    o = einsum_f32("bhgqk,bkhd->bqhgd", p, v)
    return o, m.permute(0, 3, 1, 2), p.sum(-1).permute(0, 3, 1, 2)


def merge_partials(parts: list, mesh, seq_axes) -> list:
    """Each rank's attention output (B, 1, Hkv, G, D) fp32 from the
    blocks' ``_block_partials`` merged over ``seq_axes`` (flash-decoding:
    m* = max m, o = sum exp(m - m*) o / sum exp(m - m*) l); a block with
    no valid slot weighs 0."""
    from repro_torch.sharding import spmd
    top = spmd.pmax([m for _, m, _ in parts], mesh, seq_axes)
    sums = []
    for (o, m, l), mx in zip(parts, top):
        e = torch.exp(m - mx)
        sums.append(torch.cat([o * e[..., None], (l * e)[..., None]], -1))
    return [t[..., :-1] / t[..., -1:]
            for t in spmd.psum(sums, mesh, seq_axes)]


def attn_seq_sharded(hs: list, ws: list, cfg: ArchConfig, positions: list,
                     *, mode: str, q_first: list, views: list, mesh,
                     model_axis: str, seq_axes, impl: str = "blocked"):
    """Prefill or decode over a ring cache whose slots ``seq_axes`` split
    (SP, ``ShardCtx.seq_shard_kv``), on rank lists: ``hs`` each
    coordinate's normed input, ``ws`` its weights (``attn_local``'s),
    ``views`` its block of the layer's cache (``k``, ``v`` (B, w_loc,
    Hc, D): every KV head where the model axis splits the slots, else its
    own; ``pos``).  The fresh K/V are gathered over the model axis where
    the block holds more KV heads than the coordinate projects.  A prefill
    attends its fresh K/V as ``attn_local`` does (K3 in a flash prefill),
    then each coordinate writes the tokens whose slots its block holds
    (``ring_block_write``; a prompt past the ring wraps across blocks).  A
    decode step writes the token where its slot lies, each coordinate
    attends the heads its block serves (the query heads gathered over the
    model axis where needed) over its slots with its own ``pos`` as mask
    (``_block_partials``), and the partials merge over ``seq_axes``
    (:func:`merge_partials`); each coordinate keeps its own heads.
    Returns each coordinate's share of the output projection, as
    ``attn_local``."""
    from repro_torch.sharding import spmd
    n = len(hs)
    qkv = [_qkv_local(hs[r], ws[r], cfg, positions[r], mode)
           for r in range(n)]
    hc = views[0]["k"].shape[2]
    ks, vs = [t[1] for t in qkv], [t[2] for t in qkv]
    if ks[0].shape[2] < hc:
        ks = spmd.all_gather(ks, mesh, model_axis, 2)
        vs = spmd.all_gather(vs, mesh, model_axis, 2)
    w_loc = views[0]["k"].shape[1]
    blk = spmd.axis_index(mesh, seq_axes)
    width = w_loc * math.prod(mesh.shape[a] for a in spmd._axes(seq_axes))
    pos = positions if mode != "decode" else [p[:, None] for p in positions]
    for r in range(n):
        ring_block_write(views[r], ks[r], vs[r], pos[r], blk[r] * w_loc,
                         width)
    if mode == "prefill":
        outs = []
        for r, (q, k, v) in enumerate(qkv):
            k, v = _kv_for_q(k, v, q, q_first[r], cfg)
            outs.append(_self_attention(q, k, v, cfg, positions[r], True,
                                        impl))
    else:
        qs = [q for q, _, _ in qkv]
        n_q = qs[0].shape[2]
        if n_q < hc * (cfg.num_heads // cfg.num_kv_heads):
            qs = spmd.all_gather(qs, mesh, model_axis, 2)
        parts = [_block_partials(
            qs[r], views[r]["k"], views[r]["v"],
            ring_cache_mask(views[r]["pos"], positions[r],
                            cfg.sliding_window), cfg.head_dim ** -0.5)
            for r in range(n)]
        outs = []
        for r, o in enumerate(merge_partials(parts, mesh, seq_axes)):
            o = o.reshape(o.shape[0], 1, -1, o.shape[-1])
            if o.shape[2] > n_q:
                o = o[:, :, q_first[r]:q_first[r] + n_q]
            outs.append(o.to(qkv[r][0].dtype))
    return [torch.einsum("bshe,hed->bsd", o, w["wo"])
            for o, w in zip(outs, ws)]


# ------------------------------------------------------- cross-attention ---
def cross_attention_specs(cfg: ArchConfig, prefix_axes=()):
    """The cross-attention's leaves: the self-attention's (``wk``/``wv``
    project the encoder's states, ``wq`` the decoder's)."""
    return attention_specs(cfg, prefix_axes)


def cross_attn_forward(mixer: Attention, x, enc_kv):
    """x: (B, Sq, d); enc_kv: the precomputed (k, v), each (B, Senc, Hkv,
    D).  Every query sees every encoder position (no RoPE, no mask): the
    reference's plain product, outside any Pallas kernel."""
    cfg = mixer.cfg
    q = torch.einsum("bsd,dhe->bshe", x, mixer.wq)
    if cfg.qkv_bias:
        q = q + mixer.bq.to(q.dtype)
    k, v = enc_kv
    m = torch.ones((1, 1, 1, x.shape[1], k.shape[1]), dtype=torch.bool,
                   device=x.device)
    out = grouped_dot_attention(q, k, v, m, cfg.head_dim ** -0.5)
    return mixer.project_out(out)


def encode_cross_kv(mixer: Attention, enc_out):
    """The cross-attention's (k, v) of the encoder's states enc_out
    (B, Senc, d): each (B, Senc, Hkv, D)."""
    return cross_kv(enc_out, mixer.cfg, wk=mixer.wk, wv=mixer.wv,
                    bk=getattr(mixer, "bk", None),
                    bv=getattr(mixer, "bv", None))


def cross_kv(enc_out, cfg: ArchConfig, *, wk, wv, bk=None, bv=None):
    """(k, v) of ``enc_out`` (B, Senc, d) by the KV heads ``wk``/``wv``
    (d, h, D) hold (every KV head, or a mesh coordinate's)."""
    k = torch.einsum("bsd,dhe->bshe", enc_out, wk)
    v = torch.einsum("bsd,dhe->bshe", enc_out, wv)
    if cfg.qkv_bias:
        k = k + bk.to(k.dtype)
        v = v + bv.to(v.dtype)
    return k, v


def cross_attn_placed(hs: list, ws: list, cfg: ArchConfig, kvs: list, *,
                      q_first: list, mesh, model_axis: str, seq_axes=None):
    """Cross-attention on rank lists: ``hs`` each coordinate's normed
    decoder input (B, Sq, d), ``ws`` its weights (``wq``, ``bq`` of its
    query heads from ``q_first`` on, ``wo``), ``kvs`` its (k, v): the KV
    heads it holds over every encoder frame, or (``seq_axes``, SP: the
    cache's frames split over those axes) its block of the frames, every
    KV head or its own.  Every query sees every frame (no RoPE, no mask).
    Over a block of frames each coordinate gives fp32 partials
    (``_block_partials``, the query heads gathered over the model axis
    where its block serves more), merged over ``seq_axes``
    (:func:`merge_partials`); each keeps its own heads.  Returns each
    coordinate's share of the output projection, without ``bo``, as
    :func:`attn_local`."""
    from repro_torch.sharding import spmd
    n = len(hs)
    qs = []
    for r in range(n):
        q = torch.einsum("bsd,dhe->bshe", hs[r], ws[r]["wq"])
        if cfg.qkv_bias:
            q = q + ws[r]["bq"].to(q.dtype)
        qs.append(q)
    scale = cfg.head_dim ** -0.5
    b, sq, n_q, _ = qs[0].shape
    every = [torch.ones((1, 1, 1, sq, k.shape[1]), dtype=torch.bool,
                        device=k.device) for k, _ in kvs]
    if seq_axes is None:
        outs = []
        for r in range(n):
            k, v = _kv_for_q(kvs[r][0], kvs[r][1], qs[r], q_first[r], cfg)
            outs.append(grouped_dot_attention(qs[r], k, v, every[r], scale))
    else:
        dtype = qs[0].dtype
        hc = kvs[0][0].shape[2]
        if n_q < hc * (cfg.num_heads // cfg.num_kv_heads):
            qs = spmd.all_gather(qs, mesh, model_axis, 2)
        parts = [_block_partials(qs[r], kvs[r][0], kvs[r][1], every[r],
                                 scale) for r in range(n)]
        outs = []
        for r, o in enumerate(merge_partials(parts, mesh, seq_axes)):
            o = o.reshape(b, sq, -1, o.shape[-1])
            if o.shape[2] > n_q:
                o = o[:, :, q_first[r]:q_first[r] + n_q]
            outs.append(o.to(dtype))
    return [torch.einsum("bshe,hed->bsd", o, w["wo"])
            for o, w in zip(outs, ws)]
