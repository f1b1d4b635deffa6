"""Mixture-of-Experts layer: top-k router, shared experts, the dense path.

* ``moe_dense`` — every expert on every token, masked by the routing
  weights: exact (no capacity drops), the reference's oracle path.
* ``apply_moe`` — the reference's dispatch.  Its sharded paths
  (``moe_sharded``, ``moe_sharded_2d``, ``moe_sharded_a2a``) are
  ``shard_map`` code and need a mesh; the port's ``ShardCtx`` has none yet
  and refuses a sharded ``moe_impl`` (ROADMAP.md, M14b), so every call
  takes the dense path, as the reference's does without a mesh.  ``MoE``
  calls ``moe_dense`` itself.

The functions take the reference's parameter dict (``router``, ``w_gate``,
``w_up``, ``w_down`` and, with shared experts, ``shared``: ``wi_gate``,
``wi_up``, ``wo``); :class:`MoE` holds those leaves and passes them in.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import SpecModule
from repro_torch.models.params import ParamSpec

#: ``moe_dense`` computes experts a chunk at a time: a chunk holds as many
#: experts as keep (tokens x experts x (2 ff + 3 d)) transient elements
#: under this many, so its memory follows the chunk, not E x T.
EXPERT_CHUNK_ELEMENTS = 1 << 28


# ----------------------------------------------------------------- specs ---
def moe_specs(cfg: ArchConfig, prefix_axes=()) -> dict:
    m = cfg.moe
    d = cfg.d_model
    ff = m.d_ff_expert or cfg.d_ff
    pa = prefix_axes
    bf16, f32 = torch.bfloat16, torch.float32
    sp = {
        "router": ParamSpec((d, m.num_experts), f32, pa + ("embed", None)),
        "w_gate": ParamSpec((m.num_experts, d, ff), bf16,
                            pa + ("experts", "embed", "expert_ff")),
        "w_up": ParamSpec((m.num_experts, d, ff), bf16,
                          pa + ("experts", "embed", "expert_ff")),
        "w_down": ParamSpec((m.num_experts, ff, d), bf16,
                            pa + ("experts", "expert_ff", "embed")),
    }
    if m.num_shared_experts:
        sff = ff * m.num_shared_experts
        sp["shared"] = {
            "wi_gate": ParamSpec((d, sff), bf16, pa + ("embed", "ff")),
            "wi_up": ParamSpec((d, sff), bf16, pa + ("embed", "ff")),
            "wo": ParamSpec((sff, d), bf16, pa + ("ff", "embed")),
        }
    return sp


# ---------------------------------------------------------------- routing --
def router_topk(logits: torch.Tensor, k: int):
    """logits: (T, E) -> (gates (T,k) fp32 normalised, idx (T,k) int64)."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return gates, idx


def aux_losses(logits: torch.Tensor, idx: torch.Tensor, num_experts: int,
               aux_w: float, z_w: float) -> torch.Tensor:
    """Load-balance + router z-loss (scalar, fp32). logits: (T,E);
    idx: (T,k)."""
    logits = logits.to(torch.float32)
    pe = torch.softmax(logits, dim=-1).mean(dim=0)               # (E,)
    onehot = F.one_hot(idx, num_experts).to(torch.float32)
    fe = onehot.sum(dim=1).mean(dim=0)                            # (E,)
    lb = num_experts * (pe * fe).sum()
    z = torch.logsumexp(logits, dim=-1).square().mean()
    return aux_w * lb + z_w * z


def _expert_ffn(w_gate, w_up, w_down, x):
    """Grouped FFN. x: (E, C, d) -> (E, C, d)."""
    g = torch.einsum("ecd,edf->ecf", x, w_gate)
    u = torch.einsum("ecd,edf->ecf", x, w_up)
    return torch.einsum("ecf,efd->ecd", F.silu(g) * u, w_down)


def _shared_ffn(p, x):
    g = torch.einsum("bsd,df->bsf", x, p["wi_gate"])
    u = torch.einsum("bsd,df->bsf", x, p["wi_up"])
    return torch.einsum("bsf,fd->bsd", F.silu(g) * u, p["wo"])


def expert_chunk(tokens: int, d: int, ff: int, num_experts: int) -> int:
    """Experts a chunk of ``moe_dense`` computes at once."""
    per_expert = tokens * (2 * ff + 3 * d)
    return max(1, min(num_experts, EXPERT_CHUNK_ELEMENTS // per_expert))


# ------------------------------------------------------------- dense path --
def moe_dense(p: dict, x: torch.Tensor, cfg: ArchConfig):
    """All experts on all tokens. x: (B,S,d) -> (y (B,S,d), aux).

    The reference sums every expert's output in one product; here the
    experts are computed :func:`expert_chunk` at a time and their weighted
    outputs summed into an fp32 accumulator, so the transients follow the
    chunk, not E x T.  The function is the same; only the order of the
    sum over experts differs."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    logits = xt.to(torch.float32) @ p["router"].to(torch.float32)
    gates, idx = router_topk(logits, m.top_k)
    dense_w = torch.zeros((t, m.num_experts), dtype=torch.float32,
                          device=x.device).scatter_add_(1, idx, gates)
    ff = p["w_gate"].shape[-1]
    step = expert_chunk(t, d, ff, m.num_experts)
    y = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    for e0 in range(0, m.num_experts, step):
        sl = slice(e0, e0 + step)
        n = p["w_gate"][sl].shape[0]
        eo = _expert_ffn(p["w_gate"][sl], p["w_up"][sl], p["w_down"][sl],
                         xt.expand(n, t, d))
        y += torch.einsum("etd,te->td", eo.to(torch.float32), dense_w[:, sl])
    y = y.to(x.dtype).reshape(b, s, d)
    if m.num_shared_experts:
        y = y + _shared_ffn(p["shared"], x)
    aux = aux_losses(logits, idx, m.num_experts, m.aux_loss, m.router_z_loss)
    return y, aux


def apply_moe(p: dict, x: torch.Tensor, cfg: ArchConfig, ctx=None):
    """The reference's dispatch: sharded where a mesh with EP-divisible
    experts is present, dense otherwise.  The port's ``ShardCtx`` refuses
    a mesh and any ``moe_impl`` but "auto" and "dense", so this is
    ``moe_dense``."""
    return moe_dense(p, x, cfg)


class MoE(SpecModule):
    """One layer's router and experts (and shared experts, as a child
    module ``shared``) in the reference's layouts."""

    def __init__(self, cfg: ArchConfig, *, device, dtype):
        specs = moe_specs(cfg)
        shared = specs.pop("shared", None)
        super().__init__(specs, device=device, dtype=dtype)
        if shared is not None:
            self.shared = SpecModule(shared, device=device, dtype=dtype)
        self.cfg = cfg
        self.tree = self.param_tree()       # updated in place, built once

    def forward(self, x: torch.Tensor):
        """x: (B,S,d) -> (y, aux)."""
        return moe_dense(self.tree, x, self.cfg)
