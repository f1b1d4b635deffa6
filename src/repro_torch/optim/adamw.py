"""AdamW with cosine schedule, global-norm clipping, and a pool-tier-ready
state layout.

The optimizer state (fp32 master copy + moments) is the textbook Pond
workload: touched exactly once per step, streamed, never random-accessed.
``state_tier`` tags every state group so the zNUMA layer
(``core/znuma.py::tier_place``) can place it: on the card the pool tier
is pinned host memory, and the two-phase step
(``runtime/train.py::make_two_phase_steps``) streams it through the card a
parameter at a time.

Moments can be stored int8 (block-quantized, ``optim/compress.py``).

The state is ``{"step", "master", "m", "v"}``: ``step`` an int32 scalar
tensor, the others dicts of tensors (``QTensor`` for int8 moments) keyed
and ordered like the parameters they follow.  Where the reference returns
a new state from a donated one, :func:`apply_updates` writes the
parameters and the state in place.  Both steps share :func:`step_scalars`
and :func:`update_leaf`, so they give the same parameters bit for bit.

On a mesh (``runtime/train.py::jit_train_step``) the parameters, their
gradients and the state are ``sharding/spmd.py::Placed``: the state is
made and updated a block at a time on each block's device, the global
gradient norm counts each distinct block once (not once a replica), and
``step`` is a placed scalar, one copy a coordinate.  ``tier_place`` then
moves a placed state's pool tier to one host buffer a distinct block for
the placed two-phase step (int8 moments too, which only that step takes).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.optim.compress import QTensor
from repro_torch.sharding import spmd
from repro_torch.sharding.rules import P, NamedSharding


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    moments_dtype: str = "float32"        # "float32" | "bfloat16" | "int8"
    master_fp32: bool = True


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_frac``; fp32."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(1, cfg.warmup_steps), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos)


def _zeros_moment(p: torch.Tensor, cfg: AdamWConfig, device):
    if cfg.moments_dtype == "int8":
        return QTensor.zeros(p.shape, device=device)
    dt = torch.bfloat16 if cfg.moments_dtype == "bfloat16" else torch.float32
    return torch.zeros(p.shape, dtype=dt, device=device)


def init_state(params: dict, cfg: AdamWConfig, device=None) -> dict:
    """State ``{step, master, m, v}`` for ``params`` (a name -> tensor dict)
    on ``device`` (default: the parameters' device).  Pool-tier
    candidates: master, m, v."""
    if cfg.moments_dtype not in ("float32", "bfloat16", "int8"):
        raise ValueError(f"moments_dtype {cfg.moments_dtype!r}; one of "
                         "float32, bfloat16, int8")
    first = next(iter(params.values()))
    if isinstance(first, spmd.Placed):
        return _init_placed(params, cfg, device)
    device = first.device if device is None else torch.device(device)
    master = ({n: p.detach().to(device=device, dtype=torch.float32,
                                copy=True) for n, p in params.items()}
              if cfg.master_fp32 else None)
    return {
        "step": torch.zeros((), dtype=torch.int32, device=first.device),
        "master": master,
        "m": {n: _zeros_moment(p, cfg, device) for n, p in params.items()},
        "v": {n: _zeros_moment(p, cfg, device) for n, p in params.items()},
    }


def _init_placed(params: dict, cfg: AdamWConfig, device) -> dict:
    """The state of placed parameters, each leaf placed like its
    parameter, made block by block (int8 moments a ``QTensor`` a block:
    the placed two-phase step's, once ``core/znuma.py::tier_place`` has
    put them in the pool tier; the fused step raises on them)."""
    if device is not None:
        raise ValueError("placed parameters: the state is placed like them "
                         "(device= is for one device)")
    mesh = next(iter(params.values())).mesh
    step = spmd.empty((), torch.int32, NamedSharding(mesh, P()))
    return {
        "step": step,
        "master": ({n: p.map(lambda b: b.detach().to(torch.float32,
                                                      copy=True))
                    for n, p in params.items()} if cfg.master_fp32
                   else None),
        "m": {n: p.map(lambda b: _zeros_moment(b, cfg, b.device))
              for n, p in params.items()},
        "v": {n: p.map(lambda b: _zeros_moment(b, cfg, b.device))
              for n, p in params.items()},
    }


def init_placed_pool(params: dict, cfg: AdamWConfig, device=None) -> dict:
    """:func:`init_state` of placed parameters with its pool tier where
    ``core/znuma.py::tier_place`` puts it (pinned host memory beside the
    card ``device``, one buffer a distinct block), made a parameter at a
    time: the whole state is never on the cards at once.  ``step`` stays
    placed."""
    from repro_torch.core import znuma
    tiers = state_tier(None)
    out = None
    for n, p in params.items():
        one = znuma.tier_place(_init_placed({n: p}, cfg, None), tiers,
                               device)
        if out is None:
            out = one
            continue
        for g in ("master", "m", "v"):
            if out[g] is not None:
                out[g][n] = one[g][n]
    return out


def state_tier(state) -> dict:
    """Tier tag per top-level state group (see ``core/znuma.py``)."""
    return {"step": "local", "master": "pool", "m": "pool", "v": "pool"}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor of a dict (or list),
    each leaf's sum in fp32.  A placed leaf counts each distinct block
    once (its replicas not again), on coordinate 0's device."""
    leaves = list(tree.values() if isinstance(tree, dict) else tree)
    if isinstance(leaves[0], spmd.Placed):
        dev = leaves[0].blocks[0].device
        return torch.sqrt(torch.stack(
            [x.blocks[r].to(torch.float32).square().sum().to(dev)
             for x in leaves for r in x.distinct()]).sum())
    return torch.sqrt(torch.stack(
        [x.to(torch.float32).square().sum() for x in leaves]).sum())


def _read(x) -> torch.Tensor:
    return x.dequantize() if isinstance(x, QTensor) else \
        x.to(torch.float32)


def _store(x: torch.Tensor, like):
    if isinstance(like, QTensor):
        return QTensor.quantize(x)
    return x.to(like.dtype)


def step_scalars(step: torch.Tensor, grads, cfg: AdamWConfig) -> dict:
    """The step's shared scalars, on the grads' device: the new step count,
    the clip scale, the learning rate and the two bias corrections, and
    the grad norm."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    step = step.to(gnorm.device) + 1
    stepf = step.to(torch.float32)
    b1 = torch.tensor(cfg.b1, dtype=torch.float32, device=gnorm.device)
    b2 = torch.tensor(cfg.b2, dtype=torch.float32, device=gnorm.device)
    return {"step": step, "scale": scale, "lr": schedule(cfg, step),
            "b1c": 1 - b1 ** stepf, "b2c": 1 - b2 ** stepf,
            "grad_norm": gnorm}


def update_leaf(p, mst, m, v, g, sc: dict, cfg: AdamWConfig):
    """One parameter's AdamW update, out of place, on the device its
    inputs lie on.  Returns ``(new param, new master or None, new m, new
    v)`` in the inputs' storage types."""
    # m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2 and base - lr * (mhat /
    # (sqrt(vhat) + eps) + wd * base): the same roundings (a sum's or a
    # product's two operands swapped at most), in place where a temporary
    # is read no more, so a leaf holds fewer fp32 temporaries at once
    # (3.7 GB each for deepseek's head)
    gf = g.to(torch.float32) * sc["scale"]
    mf = (1 - cfg.b1) * gf
    mf.add_(cfg.b1 * _read(m))
    vf = gf.square_().mul_(1 - cfg.b2)
    del gf
    vf.add_(cfg.b2 * _read(v))
    base = _read(mst) if mst is not None else p.to(torch.float32)
    upd = mf / sc["b1c"]
    upd.div_((vf / sc["b2c"]).sqrt_().add_(cfg.eps))
    upd.add_(cfg.weight_decay * base)
    new = base - upd.mul_(sc["lr"])
    del upd
    return (new.to(p.dtype), new if mst is not None else None,
            _store(mf, m), _store(vf, v))


def write_leaf(dst, src) -> None:
    """Copy an updated leaf (a tensor or a ``QTensor``) into its buffer."""
    if isinstance(dst, QTensor):
        dst.data.copy_(src.data, non_blocking=True)
        dst.scale.copy_(src.scale, non_blocking=True)
    else:
        dst.copy_(src, non_blocking=True)


@torch.no_grad()
def apply_updates(params: dict, state: dict, grads: dict,
                  cfg: AdamWConfig):
    """One AdamW step, the state on the parameters' device: the
    parameters and the state are updated in place (the reference's
    donated step).  Returns ``(params, state, metrics)``."""
    if isinstance(state["step"], spmd.Placed):
        return _apply_placed(params, state, grads, cfg)
    sc = step_scalars(state["step"], grads, cfg)
    masters = state["master"]
    for n, p in params.items():
        mst = None if masters is None else masters[n]
        new_p, new_mst, new_m, new_v = update_leaf(
            p, mst, state["m"][n], state["v"][n], grads[n], sc, cfg)
        p.copy_(new_p)
        if mst is not None:
            mst.copy_(new_mst)
        write_leaf(state["m"][n], new_m)
        write_leaf(state["v"][n], new_v)
        del new_p, new_mst, new_m, new_v     # before the next leaf's
    state["step"].copy_(sc["step"])
    return params, state, {"grad_norm": sc["grad_norm"], "lr": sc["lr"]}


def _apply_placed(params: dict, state: dict, grads: dict, cfg: AdamWConfig):
    """:func:`apply_updates` on placed leaves: the shared scalars once (the
    norm over distinct blocks), copied to each device, then
    :func:`update_leaf` a block at a time, in place."""
    sc = step_scalars(state["step"].blocks[0], grads, cfg)
    on: dict = {}
    masters = state["master"]
    for n, p in params.items():
        for r, b in enumerate(p.blocks):
            scd = on.setdefault(b.device, {k: v.to(b.device)
                                           for k, v in sc.items()})
            mst = None if masters is None else masters[n].blocks[r]
            m, v = state["m"][n].blocks[r], state["v"][n].blocks[r]
            new_p, new_mst, new_m, new_v = update_leaf(
                b, mst, m, v, grads[n].blocks[r], scd, cfg)
            b.copy_(new_p)
            if mst is not None:
                mst.copy_(new_mst)
            m.copy_(new_m)
            v.copy_(new_v)
            del new_p, new_mst, new_m, new_v
    for b in state["step"].blocks:
        b.copy_(sc["step"].to(b.device))
    return params, state, {"grad_norm": sc["grad_norm"], "lr": sc["lr"]}
