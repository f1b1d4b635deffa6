"""Plain PyTorch version of paged decode attention (the kernel's oracle,
and what the wrapper runs for CPU tensors)."""
from __future__ import annotations

import torch

from repro_torch.kernels.paged_attention import kernel as K

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


def paged_attention_split_ref(q, k_pages, v_pages, block_table, seq_lens, *,
                              scale: float, sm_count: int):
    """The kernel's algorithm in plain PyTorch: the table's width cut into
    ``num_splits`` ranges at the kernel's boundaries, a partial softmax
    (m, l, acc) for each, then the merge
    out = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s.  A split that
    starts at or beyond seq_len gives (NEG_INF, 0, 0) and weighs 0."""
    b, hq, d = q.shape
    hkv, _, page, _ = k_pages.shape
    g = hq // hkv
    width = block_table.shape[1]
    splits = K.num_splits(b, hkv, width, page, sm_count)
    per = K.split_tokens(width, page, splits)
    n = width * page
    tbl = block_table.long()
    k_seq = k_pages[:, tbl].movedim(0, 1).reshape(b, hkv, n, d).float()
    v_seq = v_pages[:, tbl].movedim(0, 1).reshape(b, hkv, n, d).float()
    qg = q.reshape(b, hkv, g, d).float()
    logits = torch.einsum("bhgd,bhkd->bhgk", qg, k_seq) * scale
    valid = (torch.arange(n, device=q.device)[None]
             < seq_lens[:, None])[:, None, None]           # (B,1,1,n)
    logits = torch.where(valid, logits, NEG_INF)
    ms, ls, accs = [], [], []
    for s in range(splits):
        lo, hi = s * per, min((s + 1) * per, n)
        lg, ok = logits[..., lo:hi], valid[..., lo:hi]
        m = lg.max(dim=-1, keepdim=True).values
        p = torch.where(ok, torch.exp(lg - m), 0.0)
        any_ok = ok.any(dim=-1, keepdim=True).expand_as(m)
        ms.append(torch.where(any_ok, m, NEG_INF))
        ls.append(p.sum(dim=-1, keepdim=True))
        accs.append(torch.einsum("bhgk,bhkd->bhgd", p, v_seq[:, :, lo:hi]))
    m_all = torch.stack(ms)                                  # (S,B,Hkv,g,1)
    w = torch.exp(m_all - m_all.max(dim=0).values)
    out = (w * torch.stack(accs)).sum(0) / (w * torch.stack(ls)).sum(0)
    return out.reshape(b, hq, d).to(q.dtype)
