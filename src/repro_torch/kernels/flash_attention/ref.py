"""Plain PyTorch oracle for the flash-attention kernel."""
from __future__ import annotations

import torch

NEG_INF = -2.0 ** 30
# The bf16 kernel against the plain version run in fp32 on the same inputs:
# rounding each p to bf16 before p @ V moves it by at most 2**-9 of itself,
# so it moves sum(p v) by at most 2**-9 sum(p |v|); rounding the output
# moves it by at most 2**-9 |out|.  Each 2**-8 leaves a factor of 2 for the
# order of the fp32 sums; 1e-5 covers outputs near 0.
BF16_ATOL = 1e-5
BF16_REL = 2.0 ** -8


def bf16_bound(plain, plain_abs_v):
    """Elementwise bound on |kernel - plain| for the bf16 kernel:
    1e-5 + 2**-8 |plain| + 2**-8 (P |V|).  ``plain`` is the fp32 plain
    attention on the bf16 inputs; ``plain_abs_v`` the same run on |v|."""
    return BF16_ATOL + BF16_REL * (plain.abs() + plain_abs_v)


def attention_ref(q, k, v, *, causal: bool = True, window: int | None = None,
                  scale: float | None = None):
    """q: (B,Sq,Hq,D); k,v: (B,Skv,Hkv,D). fp32 softmax, GQA by repeat."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    sq, hq = q.shape[1], q.shape[2]
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    kr = k.repeat_interleave(g, dim=2)
    vr = v.repeat_interleave(g, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          kr.to(torch.float32)) * scale
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = torch.where(mask[None, None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vr.to(torch.float32))
    return out.to(q.dtype)
