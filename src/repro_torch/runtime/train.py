"""Train-step builders.

Layers:
  * ``chunked_xent``  — vocab logits are never materialised for the whole
    sequence: a loop over sequence chunks bounds live memory at
    (B, chunk, V) while keeping the fp32 logsumexp exact, in both
    directions (a ``torch.autograd.Function`` whose backward recomputes
    each chunk's logits: the reference's custom VJP).
  * microbatch gradient accumulation — bounds activation memory.
  * ``make_train_step`` — the fused step: forward/backward, then AdamW with
    its state on the card.
  * ``make_two_phase_steps`` — Pond mode: phase A (``grad_step``) computes
    the gradients on the card; phase B (``opt_step``) applies AdamW with
    ``master``, ``m`` and ``v`` in the pool tier, pinned host memory
    (``core/znuma.py::tier_place``), a parameter at a time: copy its state
    in, update on the card, copy it back into the same pinned buffers.
    The card's working set then excludes the optimizer state, less one
    parameter's share of it.

The parameters are the model's own (``model.named_parameters()``, the
dict :func:`train_params` returns); the steps update them in place, as
the reference's steps update their donated buffers.  Both steps share
``adamw.step_scalars`` and ``adamw.update_leaf``, so they give the same
parameters bit for bit.

With a mesh (``ShardCtx.mesh``), :func:`step_shardings` gives the
reference's spec trees of the fused step, but nothing places the arrays
by them: the step runs the model eagerly on the parameters' device, and
only ``shard_map`` code splits work over the mesh (the sharded MoE paths,
and here the tied-head loss with ``replicate_lm_head``: the chunks'
tokens split over the model axis, the partial sums ``psum``-ed).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.launch import op_analysis
from repro_torch.optim import adamw
from repro_torch.optim.compress import QTensor
from repro_torch.sharding import rules
from repro_torch.sharding.rules import (P, NamedSharding, ShardCtx,
                                        default_rules, sharding_tree)

MTP_WEIGHT = 0.3


def train_params(model) -> dict:
    """The model's parameters by name, set to take gradients."""
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    return params


# -------------------------------------------------------- cross-entropy --
def _chunk_stats(h, lab, wf):
    """One chunk's (nll sum, valid count); ``wf`` the fp32 head."""
    logits = torch.einsum("bcd,dv->bcv", h.to(torch.float32), wf)
    logz = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, lab.clamp_min(0).long()[..., None])[..., 0]
    valid = lab >= 0
    return (torch.where(valid, logz - tgt, 0.0).sum(),
            valid.sum())


class _XentCore(torch.autograd.Function):
    """hc: (n, B, c, d); lc: (n, B, c); w: (d, V) -> (nll sum, count).
    The backward recomputes each chunk's logits, so no (B, S, V) tensor
    outlives a chunk."""

    @staticmethod
    def forward(ctx, hc, lc, w):
        wf = w.to(torch.float32)
        total = torch.zeros((), dtype=torch.float32, device=hc.device)
        count = torch.zeros((), dtype=torch.int64, device=hc.device)
        for h, lab in zip(hc, lc):
            s, c = _chunk_stats(h, lab, wf)
            total = total + s
            count = count + c
        ctx.save_for_backward(hc, lc, w)
        ctx.mark_non_differentiable(count)
        return total, count

    @staticmethod
    def backward(ctx, g_sum, _g_count):
        hc, lc, w = ctx.saved_tensors
        wf = w.to(torch.float32)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        dhc = torch.empty_like(hc)
        for i, (h, lab) in enumerate(zip(hc, lc)):
            logits = torch.einsum("bcd,dv->bcv", h.to(torch.float32), wf)
            # softmax minus the one-hot target, in place (p - 1 at the
            # label: the reference's p - one_hot without a (B, c, V) one-hot)
            dlogit = torch.softmax(logits, dim=-1)
            dlogit.scatter_add_(-1, lab.clamp_min(0).long()[..., None],
                                torch.full(lab.shape + (1,), -1.0,
                                           device=lab.device))
            dlogit = dlogit * (lab >= 0)[..., None] * g_sum
            dhc[i] = torch.einsum("bcv,dv->bcd", dlogit.to(w.dtype), w)
            dw = dw + torch.einsum("bcd,bcv->dv", h.to(torch.float32),
                                   dlogit.to(h.dtype).to(torch.float32))
        return dhc, None, dw.to(w.dtype)


def chunked_xent(hidden, w, labels, chunk: int = 512,
                 ctx: ShardCtx | None = None):
    """Mean token NLL.  hidden: (B,S,d); w: (d,V); labels: (B,S) int, -1
    ignored.  Without the custom backward, autograd would keep every
    chunk's (B, chunk, V) fp32 logits: the whole logits tensor that
    chunking exists to avoid.  With a mesh and ``replicate_lm_head`` (a
    tied head, whose vocab dim does not shard) each chunk's tokens split
    over the model axis, as in the reference."""
    b, s, d = hidden.shape
    c = min(chunk, s)
    pad = (-s) % c
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    n = (s + pad) // c
    hc = hidden.reshape(b, n, c, d).movedim(1, 0)
    lc = labels.reshape(b, n, c).movedim(1, 0)
    if (ctx is not None and ctx.mesh is not None and ctx.replicate_lm_head
            and c % ctx.mesh.shape[ctx.model_axis] == 0):
        ma = ctx.model_axis

        def local(hc_l, lc_l, w_l):
            tot, cnt = _XentCore.apply(hc_l, lc_l, w_l)
            return rules.psum(tot, ma), rules.psum(cnt, ma)

        total, count = rules.shard_map(
            local, mesh=ctx.mesh,
            in_specs=(P(None, None, ma, None), P(None, None, ma),
                      P(None, None)),
            out_specs=(P(), P()))(hc, lc, w)
        return total / count.clamp_min(1)
    total, count = _XentCore.apply(hc, lc, w)
    return total / count.clamp_min(1)


def loss_fn(model, params, batch, ctx: ShardCtx, xent_chunk: int = 512):
    """batch: {"tokens": (B, S+1)[, "embeds": (B, N, d)]} on the model's
    device.  ``params`` are the model's own (:func:`train_params`)."""
    tokens = batch["tokens"]
    inp, labels = tokens[:, :-1], tokens[:, 1:]
    embeds = batch.get("embeds")
    # enc-dec: embeds feed the encoder, not the decoder prefix
    n_emb = (0 if embeds is None or model.cfg.is_encoder_decoder
             else embeds.shape[1])
    s = inp.shape[1] + n_emb
    positions = torch.arange(s, device=tokens.device)[None].expand(
        inp.shape[0], s)
    out = model.forward(inp, positions, ctx, embeds=embeds)
    hidden = out["hidden"][:, n_emb:]          # frontend tokens carry no loss
    w = model.lm_head_weight()
    loss = chunked_xent(hidden, w, labels, xent_chunk, ctx)
    total = loss + out["aux"]
    if "mtp_hidden" in out:                     # predict t+2 (DeepSeek MTP)
        mtp_loss = chunked_xent(out["mtp_hidden"][:, :-1], w, labels[:, 2:],
                                xent_chunk, ctx)
        total = total + MTP_WEIGHT * mtp_loss
    return total, {"loss": loss, "aux": out["aux"]}


def grads_fn(model, params, batch, ctx: ShardCtx, microbatches: int = 1,
             xent_chunk: int = 512, accum_dtype=torch.float32):
    """``(grads by parameter name, metrics)``.  With one microbatch the
    gradients keep the parameters' dtypes; with more they are summed in
    ``accum_dtype`` (fp32 by default) and averaged, a microbatch being a
    contiguous slice of the batch's rows."""
    names, leaves = list(params), list(params.values())

    def value_and_grad(b):
        total, metrics = loss_fn(model, params, b, ctx, xent_chunk)
        gs = torch.autograd.grad(total, leaves)
        return ({k: v.detach() for k, v in metrics.items()},
                dict(zip(names, gs)))

    if microbatches == 1:
        metrics, grads = value_and_grad(batch)
        return grads, metrics
    bsz = batch["tokens"].shape[0]
    if bsz % microbatches:
        raise ValueError(f"batch of {bsz} rows does not split into "
                         f"{microbatches} microbatches")
    rows = bsz // microbatches
    g_acc = {n: torch.zeros(p.shape, dtype=accum_dtype, device=p.device)
             for n, p in params.items()}
    loss_sum = torch.zeros((), dtype=torch.float32,
                           device=batch["tokens"].device)
    # identical iterations: a dry run's counter runs one, multiplied
    for i in op_analysis.repeats(microbatches):
        mb = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
        metrics, g = value_and_grad(mb)
        for n in names:
            g_acc[n] += g[n].to(accum_dtype)
        loss_sum = loss_sum + metrics["loss"]
        del g
    grads = {n: a / microbatches for n, a in g_acc.items()}
    return grads, {"loss": loss_sum / microbatches,
                   "aux": torch.zeros_like(loss_sum)}


# ------------------------------------------------------------ step builders
def make_train_step(model, opt_cfg: adamw.AdamWConfig, ctx: ShardCtx,
                    microbatches: int = 1, xent_chunk: int = 512,
                    accum_dtype=torch.float32):
    """Fused step: ``(params, opt_state, batch) -> (params, opt_state,
    metrics)``, the state on the parameters' device, everything updated in
    place."""
    def step(params, opt_state, batch):
        grads, metrics = grads_fn(model, params, batch, ctx, microbatches,
                                  xent_chunk, accum_dtype)
        params, opt_state, om = adamw.apply_updates(params, opt_state,
                                                    grads, opt_cfg)
        return params, opt_state, {**metrics, **om}
    return step


def _crossing_bytes(x, device) -> int:
    """Bytes of a pool-tier leaf (tensor, ``QTensor`` or None) that a copy
    to ``device`` moves: 0 where the leaf lies there already."""
    if x is None:
        return 0
    ts = (x.data, x.scale) if isinstance(x, QTensor) else (x,)
    if ts[0].device == device:
        return 0
    return sum(t.numel() * t.element_size() for t in ts)


def _to(x, device):
    """A pool-tier leaf (tensor or ``QTensor``) copied to ``device``; from
    pinned memory the copy does not wait on the host."""
    if x is None:
        return None
    if isinstance(x, QTensor):
        return x.map(lambda t: t.to(device, non_blocking=True))
    return x.to(device, non_blocking=True)


def make_two_phase_steps(model, opt_cfg: adamw.AdamWConfig, ctx: ShardCtx,
                         microbatches: int = 1, xent_chunk: int = 512,
                         accum_dtype=torch.float32):
    """Pond split: ``grad_step(params, batch) -> (grads, metrics)`` on the
    card; ``opt_step(params, opt_state, grads) -> (params, opt_state,
    metrics)`` streams the pool-tier state (wherever ``tier_place`` put
    it: pinned host memory beside the card) through the card a parameter
    at a time, and writes it back into the same buffers.  Its metrics add
    ``opt_bytes_in`` and ``opt_bytes_out``: the bytes of the leaves it
    copied from another device and back, counted copy by copy (0 where
    the state lies on the parameters' device).
    The copies of one parameter are not overlapped with the next
    parameter's update."""
    def grad_step(params, batch):
        return grads_fn(model, params, batch, ctx, microbatches, xent_chunk,
                        accum_dtype)

    @torch.no_grad()
    def opt_step(params, opt_state, grads):
        sc = adamw.step_scalars(opt_state["step"], grads, opt_cfg)
        masters = opt_state["master"]
        moved_in = moved_out = 0
        for n, p in params.items():
            host = (None if masters is None else masters[n],
                    opt_state["m"][n], opt_state["v"][n])
            mst, m, v = (_to(x, p.device) for x in host)
            moved_in += sum(_crossing_bytes(x, p.device) for x in host)
            new_p, new_mst, new_m, new_v = adamw.update_leaf(
                p, mst, m, v, grads[n], sc, opt_cfg)
            p.copy_(new_p)
            for dst, src in zip(host, (new_mst, new_m, new_v)):
                if dst is not None:
                    adamw.write_leaf(dst, src)
                    moved_out += _crossing_bytes(dst, p.device)
            # freed before the next leaf's; the copies queued on this
            # stream read them before any later kernel can reuse them
            del new_p, new_mst, new_m, new_v, mst, m, v
        opt_state["step"].copy_(sc["step"])
        if next(iter(params.values())).device.type == "cuda":
            # the pinned buffers are read back by copies still queued
            torch.cuda.current_stream().synchronize()
        return params, opt_state, {"grad_norm": sc["grad_norm"],
                                   "lr": sc["lr"], "opt_bytes_in": moved_in,
                                   "opt_bytes_out": moved_out}
    return grad_step, opt_step


# The reference's step builder on one card: the fused step, eager (nothing
# is compiled; the state is updated in place, as a donated step's is).
jit_train_step = make_train_step


def step_shardings(model, opt_cfg: adamw.AdamWConfig, ctx: ShardCtx,
                   mode: str = "train"):
    """The fused step's (params, opt_state, batch) ``NamedSharding`` trees
    on ``ctx.mesh``, in the reference's layouts (the parameters' tree is
    ``model.specs()``'s)."""
    rules_ = default_rules(ctx, mode=mode)
    params_sh = sharding_tree(model.specs(), rules_, ctx.mesh)
    opt_sh = {
        "step": NamedSharding(ctx.mesh, P()),
        "master": params_sh if opt_cfg.master_fp32 else None,
        "m": params_sh,
        "v": params_sh,
    }
    batch_sh = {"tokens": NamedSharding(ctx.mesh, P(ctx.batch_axes, None))}
    return params_sh, opt_sh, batch_sh
