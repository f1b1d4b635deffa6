"""Wrapper for flash attention: checks, dispatch, launch count.

The public layout is the model's (B,S,H,D).  A CUDA tensor goes to the
hand-written kernel, which reads that layout through its strides and takes
head_dim as it is, or raises; a CPU tensor goes to the plain blocked
attention, as the reference wrapper does off the TPU, and only because it
lies on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.models.attention import blocked_attention

# Number of kernel launches made by this process; callers that want to
# show a path went through the kernel set it to 0 and read it afterwards.
launches = 0


def _check(q, k, v, window):
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("flash_attention: q (B,Sq,Hq,D), k/v (B,Skv,Hkv,D)")
    b, sq, hq, d = q.shape
    if v.shape != k.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    skv, hkv = k.shape[1], k.shape[2]
    if min(b, sq, skv, hkv, d) < 1 or hq % hkv:
        raise ValueError(f"flash_attention: {hq} query heads do not group "
                         f"over {hkv} KV heads, or an extent is 0")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    # every query row needs a key in its band, or its softmax has no support
    if window is not None and sq - 1 > skv + window - 2:
        raise ValueError(f"flash_attention: query {sq - 1} has no key in its "
                         f"window {window} over {skv} keys")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("flash_attention: q, k, v dtypes differ: "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: tensors lie on different devices")


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None, scale: float | None = None):
    """q: (B,Sq,Hq,D); k,v: (B,Skv,Hkv,D) -> (B,Sq,Hq,D) in q's dtype.
    Key j is attended by query i iff j < Skv, j <= i (causal) and
    j > i - window (window); positions start at 0 for both."""
    global launches
    _check(q, k, v, window)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        b, sq, skv = q.shape[0], q.shape[1], k.shape[1]
        pos_q = torch.arange(sq).expand(b, sq)
        pos_k = torch.arange(skv).expand(b, skv)
        return blocked_attention(q, k, v, scale, pos_q, pos_k, window=window,
                                 causal=causal, block_k=512)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    d = q.shape[-1]
    if q.dtype not in K.DTYPES or d not in K.HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes dtypes {K.DTYPES}, "
                         f"head_dim {K.HEAD_DIMS}; got {q.dtype}, {d}")
    if q.shape[2] // k.shape[2] > K.MAX_GROUP:
        raise ValueError("flash_attention kernel takes at most "
                         f"{K.MAX_GROUP} query heads per KV head")
    vec = 16 // q.element_size()            # the kernel loads 16 bytes
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or any(s % vec for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} needs a dense last "
                             "dim, 16-byte aligned rows and base "
                             f"(strides {t.stride()})")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    K.flash_attention_kernel(q, k, v, out, causal=causal, window=window,
                             scale=scale)
    launches += 1
    return out
