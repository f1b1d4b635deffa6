"""GQA attention with QKV-bias and qk-norm: projections, the dense and the
blocked (flash-style) attention cores.

The serving slice needs the forward pass only; the blocked core's
hand-written backward and the ring-buffer KV cache arrive with the
training and ring-cache slices.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.compute import einsum_f32
from repro_torch.models.layers import SpecModule, rms_norm
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
    """Running (max, sum, acc) over KV blocks; rescale, then accumulate."""
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
    out = out.movedim(-2, 1).reshape(b, sq, hq, dv)
    return out.to(q.dtype)


def blocked_attention(q, k, v, scale: float, q_pos, kv_pos,
                      window: int | None = None, causal: bool = True,
                      block_k: int = 512, kv_valid=None):
    """Flash-style attention as a plain loop over KV blocks with a running
    (max, sum, acc): memory is O(Sq * block_k), never O(Sq * Skv).  Forward
    only.

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
    return _flash_fwd_impl(q, k, v, q_pos, kv_pos, kv_valid, float(scale),
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
    if impl == "blocked":
        return blocked_attention(q, k, v, scale, positions, positions,
                                 window=cfg.sliding_window if causal else None,
                                 causal=causal)
    if impl != "dot":
        raise NotImplementedError(
            f"attention impl {impl!r} is not ported yet (see ROADMAP.md)")
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
