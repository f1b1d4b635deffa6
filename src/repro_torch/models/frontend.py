"""Modality frontend stubs (the backbone only, as in the reference).

The audio (whisper) and vision (internvl2) architectures take
*precomputed* frame or patch embeddings: the conv mel-spectrogram stack and
the InternViT tower are out of scope in the reference too.
``frontend_embed_spec`` gives the shape and dtype of those embeddings and
``make_fake_embeds`` draws them from a seeded normal.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig


def frontend_embed_shape(cfg: ArchConfig, batch: int, seq_len: int):
    """Shape of the precomputed embedding tensor handed to the backbone."""
    if cfg.frontend == "audio":
        return (batch, seq_len, cfg.d_model)        # frame embeddings
    if cfg.frontend == "vision":
        n = min(cfg.num_frontend_tokens, seq_len)
        return (batch, n, cfg.d_model)              # patch embeddings
    return None


def frontend_embed_spec(cfg: ArchConfig, batch: int, seq_len: int):
    """``(shape, dtype)`` of the embeddings (bf16), or None without a
    frontend."""
    shape = frontend_embed_shape(cfg, batch, seq_len)
    if shape is None:
        return None
    return shape, torch.bfloat16


def make_fake_embeds(cfg: ArchConfig, batch: int, seq_len: int,
                     generator: torch.Generator, device=None):
    """Seeded stand-in embeddings, N(0, 0.02^2) drawn in fp32 on
    ``device`` (the generator's device; ``None`` is the CPU) and cast to
    bf16, or None without a frontend."""
    shape = frontend_embed_shape(cfg, batch, seq_len)
    if shape is None:
        return None
    draw = torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=device if device is not None
                       else generator.device)
    return (draw * 0.02).to(torch.bfloat16)


def text_len(cfg: ArchConfig, seq_len: int) -> int:
    """Text tokens in a length-seq_len sequence after frontend tokens."""
    if cfg.frontend == "vision":
        return seq_len - min(cfg.num_frontend_tokens, seq_len - 1)
    return seq_len
