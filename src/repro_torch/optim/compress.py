"""Block-wise int8 quantization of optimizer moments.

``QTensor`` holds a tensor as int8 codes in blocks of ``BLOCK`` values with
one fp32 absmax scale a block: int8 moments make the pool-tier stream of an
AdamW step 4x smaller than fp32 moments, on top of pooling.  The same
arithmetic as the reference's ``repro/optim/compress.py``: ``torch.round``
rounds half to even, as ``jnp.round`` does.
"""
from __future__ import annotations

import dataclasses
import math

import torch

BLOCK = 256


@dataclasses.dataclass(frozen=True)
class QTensor:
    """Block-quantized int8 tensor with per-block fp32 absmax scales."""
    data: torch.Tensor    # int8, flat-padded (nblocks, BLOCK)
    scale: torch.Tensor   # fp32, (nblocks, 1)
    shape: tuple          # original shape

    @property
    def dtype(self):
        return torch.int8

    @property
    def device(self) -> torch.device:
        return self.data.device

    @staticmethod
    def _nblocks(shape) -> int:
        return -(-math.prod(shape) // BLOCK)

    @classmethod
    def zeros(cls, shape, device=None):
        nb = cls._nblocks(shape)
        return cls(torch.zeros((nb, BLOCK), dtype=torch.int8, device=device),
                   torch.zeros((nb, 1), dtype=torch.float32, device=device),
                   tuple(shape))

    @classmethod
    def quantize(cls, x: torch.Tensor) -> "QTensor":
        shape = tuple(x.shape)
        nb = cls._nblocks(shape)
        flat = x.to(torch.float32).reshape(-1)
        flat = torch.nn.functional.pad(flat, (0, nb * BLOCK - flat.numel()))
        blocks = flat.reshape(nb, BLOCK)
        scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
        q = torch.round(blocks / scale.clamp_min(1e-12))
        return cls(q.clamp(-127, 127).to(torch.int8), scale, shape)

    def dequantize(self) -> torch.Tensor:
        n = math.prod(self.shape)
        flat = (self.data.to(torch.float32) * self.scale).reshape(-1)[:n]
        return flat.reshape(self.shape)

    def map(self, fn) -> "QTensor":
        """The same codes and scales through ``fn`` (a copy, a move)."""
        return QTensor(fn(self.data), fn(self.scale), self.shape)


def quantize_tree(tree):
    """Every tensor of a dict / list / tuple tree as a ``QTensor``."""
    return _map(QTensor.quantize, tree)


def dequantize_tree(tree):
    """Every ``QTensor`` of a tree back to an fp32 tensor."""
    return _map(lambda q: q.dequantize(), tree)


def compression_error(x: torch.Tensor) -> torch.Tensor:
    """Max abs error of a quantize/dequantize round trip (for tests)."""
    return (QTensor.quantize(x).dequantize() - x.to(torch.float32)).abs().max()


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)
