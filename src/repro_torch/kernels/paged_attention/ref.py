"""Plain PyTorch version of paged decode attention (the kernel's oracle,
and what the wrapper runs for CPU tensors)."""
from __future__ import annotations

import torch

NEG_INF = -2.0 ** 30


def paged_attention_ref(q, k_pages, v_pages, block_table, seq_lens, *,
                        scale: float):
    """Same contract as the kernel: q (B,Hq,D); pages (Hkv,P,page,D);
    block_table (B,pages_per_seq) int32; seq_lens (B,) int32 -> (B,Hq,D)
    in q's dtype.  Gathers each row's pages, masks positions >= seq_len,
    softmax in fp32."""
    b, hq, d = q.shape
    hkv, _, page, _ = k_pages.shape
    g = hq // hkv
    ppseq = block_table.shape[1]
    tbl = block_table.long()
    # gather each sequence's pages: (Hkv,B,ppseq,page,D) -> (B,Hkv,ppseq*page,D)
    k_seq = k_pages[:, tbl].movedim(0, 1).reshape(b, hkv, ppseq * page, d)
    v_seq = v_pages[:, tbl].movedim(0, 1).reshape(b, hkv, ppseq * page, d)
    qg = q.reshape(b, hkv, g, d).to(torch.float32)
    logits = torch.einsum("bhgd,bhkd->bhgk", qg,
                          k_seq.to(torch.float32)) * scale
    valid = (torch.arange(ppseq * page, device=q.device)[None]
             < seq_lens[:, None])
    logits = torch.where(valid[:, None, None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgk,bhkd->bhgd", p, v_seq.to(torch.float32))
    return out.reshape(b, hq, d).to(q.dtype)
