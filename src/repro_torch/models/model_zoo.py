"""ArchConfig -> model."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.encdec import EncDec
from repro_torch.models.transformer import LM


def build_model(cfg: ArchConfig, *, device=None,
                dtype: torch.dtype | None = None) -> LM | EncDec:
    """Allocate (not initialise) the model on ``device``; ``None`` is the
    card.  ``dtype=None`` keeps the specs' dtypes (bf16 weights, fp32 norm
    scales and biases).  Encoder-decoder configs give an ``EncDec``, the
    rest an ``LM``."""
    cls = EncDec if cfg.is_encoder_decoder else LM
    return cls(cfg, device=resolve_device(device), dtype=dtype)
