"""Binding of the hand-written CUDA paged decode-attention kernel.

The kernel is ``csrc/paged_attention.cu`` (it replaces the reference's TPU
kernel ``repro/kernels/paged_attention/kernel.py::paged_attention_kernel``;
the design note is at the top of the source).  This module builds it at
first use and hands raw pointers to its C entry point; shapes, dtypes and
contiguity are the wrapper's business (``ops.py``).
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

_fns = None


def _functions():
    """(launch, error_string) of the built library, bound once."""
    global _fns
    if _fns is None:
        _fns = bind(NAME, [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return _fns


def build() -> None:
    """Compile and load the kernel now (otherwise done at first launch)."""
    _functions()


def paged_attention_kernel(q, k_pages, v_pages, block_table, seq_lens, out,
                           *, scale: float) -> None:
    """Enqueue the kernel on PyTorch's current stream of ``q``'s device;
    writes ``out``; does not synchronise.  Arguments are CUDA tensors the
    wrapper has already checked."""
    launch, err = _functions()
    b, hq, d = q.shape
    hkv, num_pages, page, _ = k_pages.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                    block_table.data_ptr(), seq_lens.data_ptr(),
                    out.data_ptr(), b, hkv, hq // hkv, d, num_pages, page,
                    block_table.shape[1], float(scale),
                    _DTYPE_CODES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError("paged_attention kernel launch failed "
                           f"({rc}): {err(rc).decode()}")
