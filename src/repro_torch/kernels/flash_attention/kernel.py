"""Binding of the hand-written CUDA flash-attention kernel.

The kernel is ``csrc/flash_attention.cu`` (it replaces the reference's TPU
kernel ``repro/kernels/flash_attention/kernel.py::flash_attention_kernel``;
the design note is at the top of the source).  This module builds it at
first use and hands raw pointers and strides to its C entry point; shapes,
dtypes and alignment are the wrapper's business (``ops.py``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import bind

NAME = "flash_attention"
SOURCE = "src/repro_torch/csrc/flash_attention.cu"
HEAD_DIMS = (16, 24, 32, 64, 80, 128)
MAX_GROUP = 128                  # query heads per KV head: a block's rows
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
DTYPES = tuple(_DTYPE_CODES)

_fns = None


def _functions():
    """(launch, error_string) of the built library, bound once; the
    strides go as a pointer to nine ``long long``."""
    global _fns
    if _fns is None:
        _fns = bind(NAME, [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_int, ctypes.c_void_p])
    return _fns


def build() -> None:
    """Compile and load the kernel now (otherwise done at first launch)."""
    _functions()


def flash_attention_kernel(q, k, v, out, *, causal: bool, window: int | None,
                           scale: float) -> None:
    """Enqueue the kernel on PyTorch's current stream of ``q``'s device;
    writes ``out`` (contiguous, q's shape); does not synchronise.  Arguments
    are CUDA tensors the wrapper has already checked."""
    launch, err = _functions()
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3],
                                      *v.stride()[:3])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    b, sq, skv, hkv, hq // hkv, d, ctypes.addressof(strides),
                    int(causal), 0 if window is None else int(window),
                    float(scale), _DTYPE_CODES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError("flash_attention kernel launch failed "
                           f"({rc}): {err(rc).decode()}")
