"""Precision policy helpers."""
from __future__ import annotations

import torch


def einsum_f32(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """einsum with fp32 accumulation; returns fp32.

    Operands are upcast before the product.  That is what the reference
    does on its CPU backend and is numerically the same as a bf16 product
    with an fp32 accumulator; it costs an fp32 copy of a bf16 operand.
    """
    return torch.einsum(eq, *[o.to(torch.float32) for o in ops])
