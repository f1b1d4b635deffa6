"""Wrapper for paged decode attention: checks, dispatch, launch count.

A CUDA tensor goes to the hand-written kernel or raises; a CPU tensor goes
to the plain version, and only because it lies on the CPU.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels.paged_attention import kernel as K
from repro_torch.kernels.paged_attention import ref as R

# Number of kernel launches made by this process; callers that want to
# show a path went through the kernel set it to 0 and read it afterwards.
launches = 0


def _check(q, k_pages, v_pages, block_table, seq_lens):
    if q.dim() != 3 or k_pages.dim() != 4 or block_table.dim() != 2 \
            or seq_lens.dim() != 1:
        raise ValueError("paged_attention: q (B,Hq,D), pages (Hkv,P,page,D), "
                         "block_table (B,pages_per_seq), seq_lens (B,)")
    b, hq, d = q.shape
    hkv, _, _, dk = k_pages.shape
    if v_pages.shape != k_pages.shape or dk != d:
        raise ValueError(f"paged_attention: k_pages {tuple(k_pages.shape)}, "
                         f"v_pages {tuple(v_pages.shape)}, head_dim {d}")
    if hq % hkv:
        raise ValueError(f"paged_attention: {hq} query heads do not group "
                         f"over {hkv} KV heads")
    if block_table.shape[0] != b or seq_lens.shape[0] != b:
        raise ValueError("paged_attention: batch sizes differ")
    if not (q.dtype == k_pages.dtype == v_pages.dtype):
        raise TypeError("paged_attention: q, k_pages, v_pages dtypes differ: "
                        f"{q.dtype}, {k_pages.dtype}, {v_pages.dtype}")
    if block_table.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError("paged_attention: block_table and seq_lens are int32")
    tensors = (q, k_pages, v_pages, block_table, seq_lens)
    if any(t.device != q.device for t in tensors):
        raise ValueError("paged_attention: tensors lie on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention: tensors must be contiguous")


def paged_attention(q, k_pages, v_pages, block_table, seq_lens, *,
                    scale: float | None = None):
    """q: (B,Hq,D); pages: (Hkv,P,page,D); table: (B,ppseq); lens: (B,),
    every length >= 1.  Returns (B,Hq,D) in q's dtype."""
    global launches
    _check(q, k_pages, v_pages, block_table, seq_lens)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return R.paged_attention_ref(q, k_pages, v_pages, block_table,
                                     seq_lens, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: no kernel for {q.device}")
    d, page = q.shape[-1], k_pages.shape[2]
    if q.dtype not in K.DTYPES or d not in K.HEAD_DIMS \
            or page not in K.PAGE_SIZES:
        raise ValueError(
            f"paged_attention kernel takes dtypes {K.DTYPES}, head_dim "
            f"{K.HEAD_DIMS}, page_size {K.PAGE_SIZES}; got {q.dtype}, "
            f"{d}, {page}")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("paged_attention: the page pools must be 16-byte "
                         "aligned (the kernel loads 16 bytes a thread)")
    b, hq, _ = q.shape
    hkv = k_pages.shape[0]
    splits = K.num_splits(b, hkv, block_table.shape[1], page,
                          _sm_count(q.device))
    scratch = torch.empty(b * hq * splits * (d + 2), dtype=torch.float32,
                          device=q.device)
    out = torch.empty_like(q)
    K.paged_attention_kernel(q, k_pages, v_pages, block_table, seq_lens, out,
                             scratch, splits=splits, scale=scale)
    launches += 1
    return out


@functools.cache
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count
