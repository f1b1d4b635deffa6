"""Shared layers: norms, RoPE, MLPs, embeddings.

The math lives in plain functions on tensors; the ``nn.Module``s hold the
parameters (declared as ``ParamSpec``s like the reference's) and call
them.  Compute dtype is the activations' dtype, norm and RoPE arithmetic
is fp32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.params import (ParamSpec, init_params_,
                                       register_params)


class SpecModule(nn.Module):
    """A module whose parameters are exactly one dict of ParamSpecs."""

    def __init__(self, specs: dict[str, ParamSpec], *, device, dtype):
        super().__init__()
        self.param_specs = specs
        register_params(self, specs, device=device, dtype=dtype)

    def init_own_params(self, generator: torch.Generator | None) -> None:
        """Seeded init of this module's parameters (not its children's)."""
        init_params_(self, self.param_specs, generator)

    def _apply(self, fn, *args, **kwargs):
        # ``.to("meta")`` and other moves across tensor types put new
        # Parameter objects in place; a mixer's cached ``tree`` (MLA,
        # Mamba-2, MoE) is rebuilt on them, or it would keep the old ones,
        # and their memory, alive
        out = super()._apply(fn, *args, **kwargs)
        if "tree" in self.__dict__:
            self.tree = self.param_tree()
        return out

    def param_tree(self) -> dict:
        """This module's parameters as the reference's dict of leaves,
        a child ``SpecModule``'s as a nested dict under its name."""
        tree = dict(self.named_parameters(recurse=False))
        for name, child in self.named_children():
            if isinstance(child, SpecModule):
                tree[name] = child.param_tree()
        return tree


# ---------------------------------------------------------------- norms ----
def norm_specs(dim: int, kind: str, prefix_axes=()) -> dict:
    ax = prefix_axes + (None,)
    if kind == "layernorm":
        return {"scale": ParamSpec((dim,), torch.float32, ax, "ones"),
                "bias": ParamSpec((dim,), torch.float32, ax, "zeros")}
    return {"scale": ParamSpec((dim,), torch.float32, ax, "ones")}


def apply_norm(x: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor | None, kind: str,
               eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    if kind == "layernorm":
        xf = xf - xf.mean(dim=-1, keepdim=True)
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * scale
    if kind == "layernorm":
        y = y + bias
    return y.to(x.dtype)


def rms_norm(scale: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    return apply_norm(x, scale, None, "rmsnorm", eps)


class Norm(SpecModule):
    def __init__(self, dim: int, kind: str, eps: float, *, device, dtype):
        super().__init__(norm_specs(dim, kind), device=device, dtype=dtype)
        self.kind, self.eps = kind, eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_norm(x, self.scale, getattr(self, "bias", None),
                          self.kind, self.eps)


# ----------------------------------------------------------------- rope ----
def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """positions: (..., S) int -> cos,sin (..., S, head_dim//2), fp32.

    The frequency table is made on the host and copied to ``positions``'
    device, so that the CPU and the card rotate by the same angles (the
    two ``pow`` implementations differ in the last bit, which a position
    in the thousands multiplies up).
    """
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32) / half))
    ang = positions.to(torch.float32)[..., None] * freqs.to(positions.device)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D). cos/sin: (B, S, D/2) (broadcast over heads)."""
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    c = cos[..., None, :].to(torch.float32)
    s = sin[..., None, :].to(torch.float32)
    x1f, x2f = x1.to(torch.float32), x2.to(torch.float32)
    out = torch.cat([x1f * c - x2f * s, x2f * c + x1f * s], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------ mlp ----
def mlp_specs(cfg: ArchConfig, d_ff: int, prefix_axes=()) -> dict:
    d = cfg.d_model
    pa = prefix_axes
    if cfg.act == "gelu":  # whisper-style: single up + down, biases
        return {
            "wi": ParamSpec((d, d_ff), torch.bfloat16, pa + ("embed", "ff")),
            "bi": ParamSpec((d_ff,), torch.float32, pa + ("ff",), "zeros"),
            "wo": ParamSpec((d_ff, d), torch.bfloat16, pa + ("ff", "embed")),
            "bo": ParamSpec((d,), torch.float32, pa + (None,), "zeros"),
        }
    return {  # SwiGLU (llama/qwen family)
        "wi_gate": ParamSpec((d, d_ff), torch.bfloat16, pa + ("embed", "ff")),
        "wi_up": ParamSpec((d, d_ff), torch.bfloat16, pa + ("embed", "ff")),
        "wo": ParamSpec((d_ff, d), torch.bfloat16, pa + ("ff", "embed")),
    }


def apply_mlp(x: torch.Tensor, *, wo: torch.Tensor,
              wi_gate: torch.Tensor | None = None,
              wi_up: torch.Tensor | None = None,
              wi: torch.Tensor | None = None,
              bi: torch.Tensor | None = None,
              bo: torch.Tensor | None = None) -> torch.Tensor:
    """x: (B, S, d).  SwiGLU with ``wi_gate``/``wi_up``; with ``wi`` the
    single-up gelu MLP with biases (tanh approximation, the reference's
    default).  ``bo=None`` leaves the output bias out (a mesh coordinate's
    share, which the caller adds once after the sum over the model
    axis)."""
    if wi is not None:
        h = x @ wi + bi.to(x.dtype)
        h = F.gelu(h, approximate="tanh")
        y = h @ wo
        return y if bo is None else y + bo.to(x.dtype)
    h = F.silu(x @ wi_gate) * (x @ wi_up)
    return h @ wo


class MLP(SpecModule):
    def __init__(self, cfg: ArchConfig, d_ff: int, *, device, dtype):
        super().__init__(mlp_specs(cfg, d_ff), device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_mlp(x, **dict(self.named_parameters(recurse=False)))


# ----------------------------------------------------------- embeddings ----
def embed_specs(cfg: ArchConfig) -> dict:
    d = {"tok": ParamSpec((cfg.vocab_size, cfg.d_model), torch.bfloat16,
                          ("vocab_tbl", "embed_tbl"), "embed")}
    if not cfg.tie_embeddings:
        d["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab_size), torch.bfloat16,
                                 ("embed", "vocab"))
    return d


def embed_tokens(tok: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens, tok)


def lm_logits(x: torch.Tensor, tok: torch.Tensor,
              lm_head: torch.Tensor | None = None) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, V) fp32; a missing head ties to the table."""
    w = tok.T if lm_head is None else lm_head
    return (x @ w).to(torch.float32)


class Embedding(SpecModule):
    def __init__(self, cfg: ArchConfig, *, device, dtype):
        super().__init__(embed_specs(cfg), device=device, dtype=dtype)

    def forward(self, tokens: torch.Tensor,
                embeds: torch.Tensor | None = None) -> torch.Tensor:
        """tokens: (B, S) -> (B, S, d); ``embeds`` (B, S', d) from a
        modality frontend are put before the tokens' rows."""
        x = embed_tokens(self.tok, tokens)
        if embeds is not None:
            x = torch.cat([embeds.to(x.dtype), x], dim=1)
        return x
