"""Binding of the hand-written CUDA paged decode-attention kernel.

The kernel is ``csrc/paged_attention.cu`` (it replaces the reference's TPU
kernel ``repro/kernels/paged_attention/kernel.py::paged_attention_kernel``;
the design note is at the top of the source).  This module builds it at
first use, chooses how many blocks split a row's KV range, and hands raw
pointers to its C entry point; shapes, dtypes and contiguity are the
wrapper's business (``ops.py``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import bind

NAME = "paged_attention"
SOURCE = "src/repro_torch/csrc/paged_attention.cu"
HEAD_DIMS = (16, 32, 64, 128)
PAGE_SIZES = (4, 8, 16)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
DTYPES = tuple(_DTYPE_CODES)
TILE_TOKENS = 64                 # tokens a block stages per step
BLOCKS_PER_SM = 2                # blocks the split aims to put on each SM

_fns = None


def num_splits(batch: int, hkv: int, pages_per_seq: int, page_size: int,
               sm_count: int) -> int:
    """Blocks that share one (batch row, KV head)'s KV range.  Computed from
    the table's width alone (never from the lengths, which live on the
    device): one block per (row, KV head) when those already give
    ``BLOCKS_PER_SM`` blocks an SM, else enough whole 64-token tiles a
    split to reach that many blocks."""
    blocks = batch * hkv
    target = BLOCKS_PER_SM * sm_count
    if blocks >= target:
        return 1
    tiles = -(-pages_per_seq * page_size // TILE_TOKENS)
    want = -(-target // blocks)
    tiles_per_split = -(-tiles // want)
    return -(-tiles // tiles_per_split)


def split_tokens(pages_per_seq: int, page_size: int, splits: int) -> int:
    """Tokens of the table's width that each of ``splits`` blocks covers: a
    whole number of 64-token tiles (so a split starts on a page)."""
    tiles = -(-pages_per_seq * page_size // TILE_TOKENS)
    return -(-tiles // splits) * TILE_TOKENS


def _functions():
    """(launch, error_string) of the built library, bound once."""
    global _fns
    if _fns is None:
        _fns = bind(NAME, [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return _fns


def build() -> None:
    """Compile and load the kernel now (otherwise done at first launch)."""
    _functions()


def paged_attention_kernel(q, k_pages, v_pages, block_table, seq_lens, out,
                           scratch, *, splits: int, scale: float) -> None:
    """Enqueue the split kernel and its merge on PyTorch's current stream of
    ``q``'s device; writes ``out``; does not synchronise.  ``scratch`` holds
    the splits' partial results: fp32, B * Hkv * splits * g * (D + 2)
    elements.  Arguments are CUDA tensors the wrapper has already checked."""
    launch, err = _functions()
    b, hq, d = q.shape
    hkv, num_pages, page, _ = k_pages.shape
    width = block_table.shape[1]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                    block_table.data_ptr(), seq_lens.data_ptr(),
                    out.data_ptr(), scratch.data_ptr(), b, hkv, hq // hkv, d,
                    num_pages, page, width, splits,
                    split_tokens(width, page, splits), float(scale),
                    _DTYPE_CODES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError("paged_attention kernel launch failed "
                           f"({rc}): {err(rc).decode()}")
