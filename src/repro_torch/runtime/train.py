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

With a mesh (``ShardCtx.mesh``), :func:`jit_train_step` is the
reference's partitioned step: the parameters and the AdamW state arrive
placed on the mesh's devices by :func:`step_shardings`' trees
(``sharding/spmd.py``, :func:`placed_params`), the batch is placed a
microbatch at a time over the batch axes (its ``embeds`` too: a vision
frontend's patch rows, an encoder-decoder's frames), and the forward and
backward of every family (attention, MLA and Mamba-2 blocks, MLP or MoE
ffn, DeepSeek's MTP head, the vision frontend, the encoder-decoder) run
on those blocks (``models/transformer.py``, ``models/encdec.py``): DP
over ("pod", "data"), FSDP gathers of "embed" over "data", TP over heads,
ff, inner channels and vocab, EP over "experts".  The loss is
vocab-parallel for an untied head and reads the tied table whole
(:func:`mesh_xent`), and adds the MoE's aux losses (from the global
router logits) and the MTP term; each leaf's gradient is summed over the
mesh axes it is replicated on, the global norm counts each distinct block
once, and AdamW updates a block at a time, so replicas stay equal.
:func:`make_two_phase_steps` on placed parameters (M18d) takes the same
gradients and streams a pool tier of one buffer a distinct block
(``core/znuma.py::tier_place``) through the card.  int8 moments on a mesh
are the two-phase step's (the fused step raises); ``make_train_step``
with a mesh still runs the model eagerly on the parameters' device, where
only ``shard_map`` code (the sharded MoE paths, the tied-head loss with
``replicate_lm_head``) splits work over the mesh.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import znuma
from repro_torch.launch import op_analysis
from repro_torch.optim import adamw
from repro_torch.optim.compress import QTensor
from repro_torch.sharding import rules, spmd
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


# ---------------------------------------------- cross-entropy on a mesh --
class _MeshXent(torch.autograd.Function):
    """One data group's chunked cross-entropy with an untied head split on
    "vocab" over the model axis, the ``m``-th of its ``n`` members holding
    ``hcs[m]`` (its copy of the (k, B, c, d) hidden chunks), ``lcs[m]``
    (labels) and ``ws[m]``, columns ``offs[m]`` on of the (d, V) head: the
    logsumexp combines the members' maxima and exp-sums, the target logit
    comes from the member holding it.  Returns (nll sum, count) on member
    0's device; the backward recomputes each chunk, as ``_XentCore``'s
    does, and gives each member its share of the gradient."""

    @staticmethod
    def forward(ctx, offs, n, *ts):
        hcs, lcs, ws = ts[:n], ts[n:2 * n], ts[2 * n:]
        dev0 = hcs[0].device
        total = torch.zeros((), dtype=torch.float32, device=dev0)
        count = torch.zeros((), dtype=torch.int64, device=dev0)
        lse = torch.empty(lcs[0].shape, dtype=torch.float32, device=dev0)
        for i in range(lcs[0].shape[0]):
            lab = lcs[0][i]
            logits = _mesh_chunk_logits(hcs, ws, i)
            mx = logits[0].amax(-1)
            for lg in logits[1:]:
                mx = torch.maximum(mx, lg.amax(-1).to(dev0))
            se = None
            tgt = torch.zeros(lab.shape, dtype=torch.float32, device=dev0)
            for m, lg in enumerate(logits):
                e = torch.exp(lg - mx.to(lg.device)[..., None]).sum(-1)
                se = e.to(dev0) if se is None else se + e.to(dev0)
                lm, hit = _local_label(lcs[m][i], offs[m], lg.shape[-1])
                t = lg.gather(-1, lm[..., None])[..., 0]
                tgt = tgt + torch.where(hit, t, 0.0).to(dev0)
            logz = mx + torch.log(se)
            valid = lab >= 0
            total = total + torch.where(valid, logz - tgt, 0.0).sum()
            count = count + valid.sum()
            lse[i] = logz
        ctx.offs, ctx.n = offs, n
        ctx.save_for_backward(lse, *ts)
        ctx.mark_non_differentiable(count)
        return total, count

    @staticmethod
    def backward(ctx, g_sum, _g_count):
        lse, *ts = ctx.saved_tensors
        offs, n = ctx.offs, ctx.n
        hcs, lcs, ws = ts[:n], ts[n:2 * n], ts[2 * n:]
        dws = [torch.zeros(w.shape, dtype=torch.float32, device=w.device)
               for w in ws]
        dhcs = [torch.empty_like(h) for h in hcs]
        for i in range(lcs[0].shape[0]):
            logits = _mesh_chunk_logits(hcs, ws, i)
            for m in range(n):
                h, w, lab, lg = hcs[m][i], ws[m], lcs[m][i], logits[m]
                d = torch.exp(lg - lse[i].to(lg.device)[..., None])
                lm, hit = _local_label(lab, offs[m], lg.shape[-1])
                d.scatter_add_(-1, lm[..., None],
                               -hit.to(torch.float32)[..., None])
                d = d * (lab >= 0)[..., None] * g_sum.to(d.device)
                dhcs[m][i] = torch.einsum("bcv,dv->bcd", d.to(w.dtype), w)
                dws[m] = dws[m] + torch.einsum(
                    "bcd,bcv->dv", h.to(torch.float32),
                    d.to(h.dtype).to(torch.float32))
        return ((None, None) + tuple(dhcs) + (None,) * n
                + tuple(dw.to(w.dtype) for dw, w in zip(dws, ws)))


def _local_label(lab, off: int, width: int):
    """Labels as column indices of the block from ``off`` (0 where outside
    it), and whether each falls inside."""
    lm = lab.long() - off
    hit = (lm >= 0) & (lm < width) & (lab >= 0)
    return torch.where(hit, lm, 0), hit


def _mesh_chunk_logits(hcs, ws, i: int) -> list:
    """Chunk ``i``'s fp32 logits, each member's own vocab columns."""
    return [torch.einsum("bcd,dv->bcv", hc[i].to(torch.float32),
                         w.to(torch.float32)) for hc, w in zip(hcs, ws)]


def mesh_xent(hidden: spmd.Placed, params: dict, labels: spmd.Placed,
              ctx: ShardCtx, chunk: int = 512) -> torch.Tensor:
    """Mean token NLL of placed hidden states (B, S, d) and labels (B, S)
    on the placed head, on coordinate 0's device.  Vocab-parallel: an
    untied head split on "vocab" over the model axis combines each
    member's logsumexp (max, then a sum of exp-sums; ``_MeshXent``).  Any
    other head (the tied table, whose d the model axis splits, or a head
    replicated there) is gathered whole (``spmd.whole``) on each data
    group's model-coordinate 0, which runs the unsharded loss's
    ``_XentCore`` on it.  Each data group's sum is counted once, summed
    over the batch axes in row-major order."""
    mesh, ma = ctx.mesh, ctx.model_axis
    b, s, d = hidden.blocks[0].shape
    c = min(chunk, s)
    pad = (-s) % c
    n = (s + pad) // c

    def chunks(h, lab):
        if pad:
            h = F.pad(h, (0, 0, 0, pad))
            lab = F.pad(lab, (0, pad), value=-1)
        return (h.reshape(b, n, c, d).movedim(1, 0),
                lab.reshape(b, n, c).movedim(1, 0))

    head = params.get("embed.lm_head")
    vocab = head is not None and spmd.sharded_over(head, ma) == 1
    if vocab:
        ws = spmd.unshard(head, (ma,))
    totals, counts = [], []
    for members in spmd.groups(mesh, ma):
        hl = [chunks(hidden.blocks[r], labels.blocks[r]) for r in members]
        if vocab:
            offs = [j * ws[r].shape[1] for j, r in enumerate(members)]
            t, k = _MeshXent.apply(offs, len(members),
                                   *[h for h, _ in hl], *[lab for _, lab in hl],
                                   *[ws[r] for r in members])
        else:
            r = members[0]
            w = (spmd.whole(head, r) if head is not None
                 else spmd.whole(params["embed.tok"], r).T)
            t, k = _XentCore.apply(hl[0][0], hl[0][1], w)
        totals.append(t)
        counts.append(k)
    dev0 = totals[0].device
    total, count = totals[0], counts[0]
    for t, k in zip(totals[1:], counts[1:]):
        total = total + t.to(dev0)
        count = count + k.to(dev0)
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
    parameter's update.

    Placed parameters (``spmd.Placed``, :func:`placed_params`; the path is
    chosen by their type, as ``LM.forward`` chooses by ``params=``) take
    the placed steps (M18d): ``grad_step`` is :func:`jit_train_step`'s
    gradients (the same checks, the batch's global tensors placed by the
    step), placed like the parameters; ``opt_step`` takes a state whose
    pool tier ``tier_place`` holds as one buffer a distinct block
    (``znuma.PoolBlocks``) and updates each distinct block on its
    coordinate's device, then copies the new block to its replicas."""
    def grad_step(params, batch):
        if _placed(params):
            return _placed_grads(model, params, batch, ctx, microbatches,
                                 xent_chunk, accum_dtype)
        return grads_fn(model, params, batch, ctx, microbatches, xent_chunk,
                        accum_dtype)

    @torch.no_grad()
    def opt_step(params, opt_state, grads):
        if _placed(params):
            return _placed_opt_step(params, opt_state, grads, opt_cfg)
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


def _placed(params: dict) -> bool:
    return isinstance(next(iter(params.values())), spmd.Placed)


def _placed_grads(model, params: dict, batch: dict, ctx: ShardCtx,
                  microbatches: int, xent_chunk: int, accum_dtype):
    """The placed two-phase step's phase A: :func:`jit_train_step`'s
    checks, then :func:`_mesh_grads`."""
    _require_mesh_step(model, ctx, "make_two_phase_steps")
    params_sh = step_shardings(model, adamw.AdamWConfig(), ctx)[0]
    for n, sh in spmd.named_shardings(model, params_sh).items():
        spmd.check(params.get(n), sh, n)
    for p in params.values():
        for b in p.blocks:
            b.requires_grad_(True)
    return _mesh_grads(model, params, batch, ctx, microbatches, xent_chunk,
                       accum_dtype)


def _placed_opt_step(params: dict, opt_state: dict, grads: dict,
                     opt_cfg: adamw.AdamWConfig):
    """The placed two-phase step's phase B: the shared scalars once (the
    norm over distinct blocks), then each parameter's distinct blocks in
    turn: its master, m and v copied from their pool-tier buffers to the
    block's device, ``adamw.update_leaf``, the block and its replicas
    written, the state written back into the same buffers.  Returns
    ``(params, opt_state, metrics)`` as the unplaced step does."""
    step = opt_state["step"]
    sc = adamw.step_scalars(step.blocks[0], grads, opt_cfg)
    on: dict = {}
    moved_in = moved_out = 0
    for n, p in params.items():
        pools = [None if opt_state[g] is None else opt_state[g][n]
                 for g in ("master", "m", "v")]
        if not isinstance(pools[1], znuma.PoolBlocks):
            raise TypeError(f"opt state of {n}: the placed two-phase step "
                            "takes the pool tier of znuma.tier_place, got "
                            f"{type(pools[1]).__name__}")
        home = spmd.home_ranks(p.mesh, p.spec)
        for i, r in enumerate(pools[1].ranks):
            b = p.blocks[r]
            dev = b.device
            if dev not in on:
                on[dev] = {k: v.to(dev) for k, v in sc.items()}
            scd = on[dev]
            host = [None if q is None else q.blocks[i] for q in pools]
            mst, m, v = (_to(x, dev) for x in host)
            moved_in += sum(_crossing_bytes(x, dev) for x in host)
            new_p, new_mst, new_m, new_v = adamw.update_leaf(
                b, mst, m, v, grads[n].blocks[r], scd, opt_cfg)
            for rr, h in enumerate(home):
                if h == r:
                    p.blocks[rr].copy_(new_p)
            for dst, src in zip(host, (new_mst, new_m, new_v)):
                if dst is not None:
                    adamw.write_leaf(dst, src)
                    moved_out += _crossing_bytes(dst, dev)
            # freed before the next block's; the copies queued on this
            # stream read them before any later kernel can reuse them
            del new_p, new_mst, new_m, new_v, mst, m, v
    for b in step.blocks:
        b.copy_(sc["step"].to(b.device))
    for dev in on:
        if dev.type == "cuda":
            # the pinned buffers are read back by copies still queued
            torch.cuda.current_stream(dev).synchronize()
    return params, opt_state, {"grad_norm": sc["grad_norm"], "lr": sc["lr"],
                               "opt_bytes_in": moved_in,
                               "opt_bytes_out": moved_out}


# ------------------------------------------------------- on a mesh (M18) --
def _mesh_grads(model, params: dict, batch: dict, ctx: ShardCtx,
                microbatches: int, xent_chunk: int, accum_dtype):
    """``grads_fn`` on placed parameters: each microbatch (contiguous rows
    of the batch's global tensors) placed over the batch axes, the
    tokens', and ``embeds`` by ``serve.batch_pspec`` (the reference's dry
    run's rule): an encoder-decoder's frames feed its encoder, a vision
    frontend's patch rows go before the tokens and carry no loss; the
    loss (with the MTP head's term where the model has one) and every
    block's gradient; the gradients summed over the axes each leaf is
    replicated on.  Returns (grads by name, each placed like its
    parameter, metrics)."""
    from repro_torch.runtime.serve import batch_pspec
    mesh = ctx.mesh
    names = list(params)
    leaves = [b for n in names for b in params[n].blocks]
    tok_sh = NamedSharding(mesh, P(ctx.batch_axes, None))
    tokens, embeds = batch["tokens"], batch.get("embeds")
    encdec = model.cfg.is_encoder_decoder
    bsz = tokens.shape[0]
    if bsz % microbatches:
        raise ValueError(f"batch of {bsz} rows does not split into "
                         f"{microbatches} microbatches")
    rows = bsz // microbatches
    acc = None
    loss_sum = None
    for i in range(microbatches):
        mb = ctx.constrain(spmd.place(tokens[i * rows:(i + 1) * rows],
                                      tok_sh), P(ctx.batch_axes, None))
        inp = spmd.Placed([t[:, :-1] for t in mb.blocks], tok_sh)
        lab = spmd.Placed([t[:, 1:] for t in mb.blocks], tok_sh)
        emb = None
        if embeds is not None:
            emb = spmd.place(embeds[i * rows:(i + 1) * rows], NamedSharding(
                mesh, batch_pspec(ctx, rows, 3)))
        # enc-dec: embeds feed the encoder, not the decoder prefix
        n_emb = 0 if emb is None or encdec else emb.shape[1]
        s = inp.shape[1] + n_emb
        pos = inp.map(lambda t: torch.arange(s, device=t.device)[None]
                      .expand(t.shape[0], s))
        out = model.forward(inp, pos, ctx, embeds=emb, params=params)
        hidden = out["hidden"]
        if n_emb:                           # frontend rows carry no loss
            hidden = hidden.map(lambda h: h[:, n_emb:])
        loss = mesh_xent(hidden, params, lab, ctx, xent_chunk)
        total = loss + out["aux"]
        if "mtp_hidden" in out:                 # predict t+2 (DeepSeek MTP)
            total = total + MTP_WEIGHT * mesh_xent(
                out["mtp_hidden"].map(lambda h: h[:, :-1]), params,
                lab.map(lambda t: t[:, 2:]), ctx, xent_chunk)
        # a replica no coordinate read (a head replicated over the model
        # axis is read whole from index 0 there) has no gradient
        gs = [torch.zeros_like(b) if g is None else g for b, g in zip(
            leaves, torch.autograd.grad(total, leaves, allow_unused=True))]
        loss, aux = loss.detach(), out["aux"].detach()
        loss_sum = loss if loss_sum is None else loss_sum + loss
        if microbatches == 1:
            acc = gs
            continue
        if acc is None:
            acc = [None] * len(gs)
        for j, g in enumerate(gs):         # a leaf at a time, as grads_fn
            gs[j] = None
            acc[j] = (g.to(accum_dtype) if acc[j] is None
                      else acc[j].add_(g.to(accum_dtype)))
        del gs
    if microbatches > 1:                   # each block its own tensor here
        for g in acc:
            g.div_(microbatches)
    grads, k = {}, 0
    for n in names:
        p = params[n]
        blocks = spmd.sum_replicas(acc[k:k + len(p.blocks)], mesh, p.spec)
        k += len(p.blocks)
        grads[n] = spmd.Placed(blocks, p.sharding, p.shape)
    # as grads_fn: the aux of one microbatch, none of an accumulation
    return grads, {"loss": loss_sum / microbatches,
                   "aux": aux if microbatches == 1
                   else torch.zeros_like(loss_sum)}


def _require_mesh_step(model, ctx: ShardCtx, what: str) -> None:
    """The checks every sharded step makes before it runs."""
    from repro_torch.models.transformer import mesh_family_check
    mesh_family_check(model.cfg, what, ctx)
    if ctx.fsdp_pod and ctx.axis_size(ctx.batch_axes) > ctx.axis_size(
            ctx.data_axis):
        raise NotImplementedError(
            f"{what}: fsdp_pod (FSDP over pod and data) is not placed "
            "yet (ROADMAP Queue 1, M18e: fsdp_pod under placement)")


def placed_params(model, ctx: ShardCtx, mode: str = "train") -> dict:
    """The model's parameters placed on ``ctx.mesh`` by name, each by
    its leaf of :func:`step_shardings`' parameter tree (``mode``: the
    rules' train or serve layout); every block a copy, taking gradients."""
    sh = spmd.named_shardings(model, sharding_tree(
        model.specs(), default_rules(ctx, mode=mode), ctx.mesh))
    out = {}
    for n, p in model.named_parameters():
        out[n] = spmd.place(p, sh[n])
        for b in out[n].blocks:
            b.requires_grad_(mode == "train")
    return out


def jit_train_step(model, opt_cfg: adamw.AdamWConfig, ctx: ShardCtx, *,
                   mode: str = "train", microbatches: int = 1,
                   xent_chunk: int = 512, donate: bool = True,
                   accum_dtype=torch.float32):
    """The reference's step builder.  Without a mesh: the fused step,
    eager, on the model's own parameters (updated in place, as a donated
    step's are; ``donate=False`` raises, since the model reads its own
    parameters).  With a mesh: ``(params, opt_state, batch) -> (params,
    opt_state, metrics)`` on parameters and an AdamW state placed by
    :func:`step_shardings` (:func:`placed_params`, ``adamw.init_state``;
    a leaf placed otherwise raises), the batch's global tensors (tokens,
    ``embeds``) placed by the step, a microbatch at a time.
    ``donate=False`` updates copies and leaves the inputs as they were.
    int8 moments with a mesh raise ``ValueError`` (the reference's rule:
    a pool-tier feature, :func:`make_two_phase_steps`'); a family the
    steps do not place (``is_placed_family``) raises
    ``NotImplementedError``."""
    if ctx.mesh is None:
        if not donate:
            raise ValueError("donate=False without a mesh: the eager step "
                             "updates the model's own parameters")
        return make_train_step(model, opt_cfg, ctx, microbatches, xent_chunk,
                               accum_dtype)
    if opt_cfg.moments_dtype == "int8":
        raise ValueError("int8 moments are a pool-tier feature: use "
                         "make_two_phase_steps (opt state streams from the "
                         "pool tier, shardings inferred from buffers)")
    _require_mesh_step(model, ctx, "jit_train_step")
    params_sh, opt_sh, _ = step_shardings(model, opt_cfg, ctx, mode)
    named = spmd.named_shardings(model, params_sh)

    def step(params, opt_state, batch):
        for n, sh in named.items():
            spmd.check(params.get(n), sh, n)
            for g in ("master", "m", "v"):
                if opt_state[g] is not None:
                    spmd.check(opt_state[g].get(n), sh, f"{g} {n}")
        spmd.check(opt_state["step"], opt_sh["step"], "step")
        if not donate:
            params = {n: p.map(lambda b: b.detach().clone()
                               .requires_grad_(b.requires_grad))
                      for n, p in params.items()}
            opt_state = spmd.map_tree(
                lambda x: None if x is None else x.map(torch.clone),
                opt_state)
        for p in params.values():
            for b in p.blocks:
                b.requires_grad_(True)
        grads, metrics = _mesh_grads(model, params, batch, ctx,
                                     microbatches, xent_chunk, accum_dtype)
        params, opt_state, om = adamw.apply_updates(params, opt_state,
                                                    grads, opt_cfg)
        return params, opt_state, {**metrics, **om}
    return step


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
