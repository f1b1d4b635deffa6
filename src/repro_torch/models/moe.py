"""Mixture-of-Experts layer: top-k router, shared experts, the dense path
and the reference's three sharded dispatch paths.

* ``moe_dense`` — every expert on every token, masked by the routing
  weights: exact (no capacity drops), the reference's oracle path.
* ``moe_sharded`` — EP over the mesh's model axis through
  ``sharding/rules.py::shard_map``: each coordinate routes its tokens,
  scatters those routed to *its* experts into an (E_local, C, d) buffer
  (sort-based position in expert; a pair past the capacity C is dropped),
  runs the grouped expert FFN, scatter-adds back, and one ``psum`` over
  the model axis combines the expert groups.
* ``moe_sharded_2d`` — experts over "model" and the expert ffn dim over
  "data": tokens all-gathered over "data", partial sums reduce-scattered
  back, then summed over "model".
* ``moe_sharded_a2a`` — whole experts over ("data", "model"), tokens sent
  to their experts' owners and back by all-to-all (the sequence split over
  "model"); one-token steps take ``moe_sharded_2d``.  An owner runs each
  received row through its own expert only (``_owned_experts_ffn``; the
  reference's one-hot select computes every owned expert on every row).
* ``apply_moe`` — the reference's dispatch: a sharded path where a mesh
  with EP-divisible experts is present and ``moe_impl`` is not "dense",
  else ``moe_dense``.  The decode step passes ``ShardCtx.moe_decode_cf``
  as the capacity factor (the reference's looser capacity for few tokens).
* ``moe_placed`` — the same dispatch on the placed steps' rank lists
  (``sharding/spmd.py``; ``models/transformer.py::_mesh_block``): each
  path's ``local_fn`` run coordinate by coordinate between ``spmd``'s
  collectives, its inputs resharded from where the step placed them to
  the ``shard_map`` form's in_specs.

The aux losses (load balance + router z-loss) come from the global router
logits outside the ``shard_map`` (on rank lists: the input and router
gathered whole on coordinate 0), as in the reference.  A sharded path
called with ``stats={}`` adds to ``stats["dropped"]`` the (token, expert)
pairs it dropped, each pair counted once however many coordinates hold a
copy of its token.

The functions take the reference's parameter dict (``router``, ``w_gate``,
``w_up``, ``w_down`` and, with shared experts, ``shared``: ``wi_gate``,
``wi_up``, ``wo``); :class:`MoE` holds those leaves and passes them in.
"""
from __future__ import annotations

import math
from types import SimpleNamespace

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import SpecModule
from repro_torch.models.params import ParamSpec
from repro_torch.sharding import rules, spmd
from repro_torch.sharding.rules import P, NamedSharding, shard_map

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
    # the reference's one_hot(idx).sum(1): each token's count of each
    # expert, by a scatter (F.one_hot dispatches other ops on meta tensors
    # than on the card, and the dry run counts ops)
    hits = torch.zeros(idx.shape[0], num_experts, dtype=torch.float32,
                       device=idx.device).scatter_add_(
        1, idx, torch.ones(idx.shape, dtype=torch.float32,
                           device=idx.device))
    fe = hits.mean(dim=0)                                         # (E,)
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
    y, logits, idx = _routed_dense(p, x, cfg)
    if m.num_shared_experts:
        y = y + _shared_ffn(p["shared"], x)
    aux = aux_losses(logits, idx, m.num_experts, m.aux_loss, m.router_z_loss)
    return y, aux


def _routed_dense(p: dict, x: torch.Tensor, cfg: ArchConfig):
    """:func:`moe_dense`'s routed experts: (their output in x's dtype, the
    fp32 router logits, the top-k indices)."""
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
    return y.to(x.dtype).reshape(b, s, d), logits, idx


# ----------------------------------------------------------- sharded path --
def _positions_in_expert(e_flat: torch.Tensor, num_experts: int):
    """Sort-based position in expert (stable): pair i's rank among the
    earlier pairs routed to its expert.  e_flat: (Tk,) int."""
    tk = e_flat.shape[0]
    sort_idx = torch.argsort(e_flat, stable=True)
    e_sorted = e_flat[sort_idx]
    # bincount would read the max back to the host (a sync) on the card
    counts = torch.zeros(num_experts, dtype=torch.int64,
                         device=e_flat.device).index_add_(
        0, e_flat, torch.ones_like(e_flat))
    starts = torch.cumsum(counts, 0) - counts
    pos_sorted = (torch.arange(tk, device=e_flat.device)
                  - starts[e_sorted])
    return torch.zeros(tk, dtype=torch.int64,
                       device=e_flat.device).scatter_(0, sort_idx, pos_sorted)


def _batch_axes_for(ctx, b: int) -> tuple:
    """Largest prefix of ctx.batch_axes whose product divides b."""
    axes = []
    n = 1
    for a in ctx.batch_axes:
        if b % (n * ctx.mesh.shape[a]) == 0:
            axes.append(a)
            n *= ctx.mesh.shape[a]
    return tuple(axes)


def _global_aux(p, x, cfg):
    m = cfg.moe
    b, s, _ = x.shape
    logits = (x.to(torch.float32) @ p["router"].to(torch.float32)
              ).reshape(b * s, -1)
    _, idx = router_topk(logits, m.top_k)
    return aux_losses(logits, idx, m.num_experts, m.aux_loss,
                      m.router_z_loss)


def _count_dropped(stats, dropped, mesh, owner_axes, rank: int):
    """Add ``dropped`` (a count on the device) to ``stats`` at one
    coordinate of each group that holds the same pairs: where every axis
    outside ``owner_axes`` is 0 (``rank``: the coordinate's index in
    ``mesh.coords()``).  Reads the count (a sync) only where ``stats`` is
    given."""
    if stats is None:
        return
    if all(spmd.axis_index(mesh, a)[rank] == 0 for a in mesh.axis_names
           if a not in owner_axes):
        # one coordinate runs at a time (shard_map's baton, or the rank
        # list's loop): no lock
        stats["dropped"] = stats.get("dropped", 0) + int(dropped)


def _shard_map_rank(mesh) -> int:
    """The running ``shard_map`` coordinate's index in ``mesh.coords()``
    (row-major over every axis)."""
    return rules.axis_index(tuple(mesh.axis_names))


def _dispatch_local(xt, wr, wg, wu, wd, cfg, el, cap, rank):
    """One coordinate's capacity dispatch over its experts ``rank * el``
    .. ``rank * el + el - 1``: (y (t, d) fp32, the count of dropped pairs
    on the device)."""
    m = cfg.moe
    t, d = xt.shape
    logits = xt.to(torch.float32) @ wr.to(torch.float32)
    gates, idx = router_topk(logits, m.top_k)               # (t, k)
    e_flat = idx.reshape(-1)                                # (t*k,)
    pos = _positions_in_expert(e_flat, m.num_experts)
    mine = (e_flat // el) == rank
    keep = mine & (pos < cap)
    slot = torch.where(keep, (e_flat % el) * cap + pos, el * cap)
    tok_of = torch.arange(t, device=xt.device).repeat_interleave(m.top_k)
    buf = torch.zeros((el * cap + 1, d), dtype=xt.dtype, device=xt.device)
    buf.index_add_(0, slot, xt[tok_of])
    eo = _expert_ffn(wg, wu, wd, buf[:-1].reshape(el, cap, d))
    eo = eo.reshape(el * cap, d)
    g_flat = gates.reshape(-1).to(torch.float32)
    contrib = (eo[slot.clamp_max(el * cap - 1)].to(torch.float32)
               * (g_flat * keep)[:, None])
    # a token's k pairs are adjacent: summing them is the scatter-add
    y = contrib.reshape(t, m.top_k, d).sum(1)
    return y, (mine & ~keep).sum()


_WEIGHTS = ("router", "w_gate", "w_up", "w_down")


def _a2a_owners(cfg: ArchConfig, ctx) -> int:
    """The a2a path's expert owners, data x model; raises unless they
    split the experts (also where the path falls back to 2d)."""
    n_ep = ctx.mesh.shape[ctx.data_axis] * ctx.mesh.shape[ctx.model_axis]
    if cfg.moe.num_experts % n_ep:
        raise ValueError(f"{cfg.moe.num_experts} experts on {n_ep} "
                         "coordinates")
    return n_ep


def _plan(cfg: ArchConfig, ctx, path: str, b: int, s: int, cf: float):
    """What both forms of a sharded ``path`` ("sharded", "sharded2d",
    "a2a") need for a (b, s) input at capacity factor ``cf``: ``el``
    experts a coordinate, the batch axes the tokens split over, the
    tokens' in_spec ``x_spec``, the in_specs ``w_specs`` of ``_WEIGHTS``,
    the capacity ``cap``, and ``owners``, the axes whose coordinates route
    distinct pairs (a drop is counted at index 0 of every other axis)."""
    m = cfg.moe
    mesh, da, ma = ctx.mesh, ctx.data_axis, ctx.model_axis
    ba = _batch_axes_for(ctx, b)
    rows = b // math.prod(mesh.shape[a] for a in ba)     # a coordinate's
    bat = ba if ba else None
    if path == "a2a":
        n_ep = _a2a_owners(cfg, ctx)
        w = P((da, ma), None, None)
        # tokens fully sharded: batch over (pod, data), the sequence over
        # model; the capacity a (source, owner) pair's
        return SimpleNamespace(
            el=m.num_experts // n_ep, batch_axes=ba, x_spec=P(bat, ma, None),
            w_specs=(P(None, None), w, w, w), owners=ba + (ma,),
            cap=max(8, int(rows * (s // mesh.shape[ma]) * m.top_k * cf
                           / n_ep)))
    ep = mesh.shape[ma]
    if path == "sharded":
        if m.num_experts % ep:
            raise ValueError(f"{m.num_experts} experts on a {ep}-way model "
                             "axis")
        w = P(ma, None, None)
        return SimpleNamespace(
            el=m.num_experts // ep, batch_axes=ba, x_spec=P(bat, None, None),
            w_specs=(P(None, None), w, w, w), owners=ba + (ma,),
            cap=max(8, int(rows * s * m.top_k * cf / m.num_experts)))
    ff = m.d_ff_expert or cfg.d_ff
    if m.num_experts % ep or ff % mesh.shape[da]:
        raise ValueError(f"{m.num_experts} experts x ff {ff} on a "
                         f"{mesh.shape} mesh")
    # every data coordinate routes the data group's gathered tokens
    pod = tuple(a for a in ba if a != da)
    t_g = (b // math.prod(mesh.shape[a] for a in pod)) * s
    return SimpleNamespace(
        el=m.num_experts // ep, batch_axes=ba, x_spec=P(bat, None, None),
        w_specs=(P(None, None), P(ma, None, da), P(ma, None, da),
                 P(ma, da, None)), owners=pod + (ma,),
        cap=max(8, int(t_g * m.top_k * cf / m.num_experts)))


def moe_sharded(p: dict, x: torch.Tensor, cfg: ArchConfig, ctx,
                capacity_factor: float | None = None, stats=None):
    """EP dispatch over the model axis.  ctx: ShardCtx with a mesh."""
    m = cfg.moe
    b, s, d = x.shape
    ma = ctx.model_axis
    cf = capacity_factor if capacity_factor is not None else m.capacity_factor
    pl = _plan(cfg, ctx, "sharded", b, s, cf)
    aux = _global_aux(p, x, cfg)

    def local_fn(xl, wr, wg, wu, wd):
        bl, sl, _ = xl.shape
        y, dropped = _dispatch_local(xl.reshape(bl * sl, d), wr, wg, wu, wd,
                                     cfg, pl.el, pl.cap, rules.axis_index(ma))
        _count_dropped(stats, dropped, ctx.mesh, pl.owners,
                       _shard_map_rank(ctx.mesh))
        y = rules.psum(y, ma)
        return y.to(xl.dtype).reshape(bl, sl, d)

    y = shard_map(local_fn, mesh=ctx.mesh, in_specs=(pl.x_spec,) + pl.w_specs,
                  out_specs=pl.x_spec)(x, *(p[k] for k in _WEIGHTS))
    if m.num_shared_experts:
        y = y + _shared_ffn(p["shared"], x)
    return y, aux


def moe_sharded_2d(p: dict, x: torch.Tensor, cfg: ArchConfig, ctx,
                   capacity_factor: float | None = None, stats=None):
    """Serve-scale EP: experts over "model" AND the expert ffn dim over
    "data".  Each (data, model) coordinate all-gathers the tokens over
    "data", routes them, runs its experts on its ff shard, reduce-scatters
    the partial sums over "data" and sums the expert groups over
    "model"."""
    m = cfg.moe
    b, s, d = x.shape
    da, ma = ctx.data_axis, ctx.model_axis
    cf = capacity_factor if capacity_factor is not None else m.capacity_factor
    pl = _plan(cfg, ctx, "sharded2d", b, s, cf)
    aux = _global_aux(p, x, cfg)
    gather_data = da in pl.batch_axes

    def local_fn(xl, wr, wg, wu, wd):
        bl = xl.shape[0]
        if gather_data:
            xl = rules.all_gather(xl, da, axis=0)
        y, dropped = _dispatch_local(xl.reshape(-1, d), wr, wg, wu, wd, cfg,
                                     pl.el, pl.cap, rules.axis_index(ma))
        _count_dropped(stats, dropped, ctx.mesh, pl.owners,
                       _shard_map_rank(ctx.mesh))
        if gather_data:
            # returns each data-rank its own tokens, summing ff partials
            y = rules.psum_scatter(y, da, scatter_dimension=0)
        else:
            y = rules.psum(y, da)                # ff partials only
        y = rules.psum(y, ma)                    # expert groups
        return y.to(xl.dtype).reshape(bl, s, d)

    y = shard_map(local_fn, mesh=ctx.mesh, in_specs=(pl.x_spec,) + pl.w_specs,
                  out_specs=pl.x_spec)(x, *(p[k] for k in _WEIGHTS))
    if m.num_shared_experts:
        y = y + _shared_ffn(p["shared"], x)
    return y, aux


def _owned_experts_ffn(wg, wu, wd, x, le, el: int):
    """Each received row x[i] through its own expert ``le[i]`` (``el``, the
    pad id, gives a zero row).  The reference selects by a one-hot product:
    every owned expert on every row, then all but one term multiplied by 0;
    the sum is the same, and here the work and memory follow the rows, not
    el times them (on a (1, 1) mesh el is every expert)."""
    if le.device.type == "meta":
        raise NotImplementedError(
            "moe_sharded_a2a reads each owned expert's row count to the "
            "host, and a meta tensor holds none: the dry run cannot count "
            "this path")
    order = torch.argsort(le, stable=True)
    counts = torch.bincount(le, minlength=el + 1).tolist()
    y = torch.zeros_like(x)
    start = 0
    for e in range(el):
        rows = order[start:start + counts[e]]
        start += counts[e]
        if len(rows):
            y[rows] = _expert_ffn(wg[e:e + 1], wu[e:e + 1], wd[e:e + 1],
                                  x[rows][None])[0]
    return y


def _a2a_send(xt, wr, cfg: ArchConfig, el: int, n_ep: int, cap: int):
    """One coordinate's all-to-all payload of its tokens ``xt`` (t, d):
    ``send_x`` (n_ep, cap, d), each owner's rows (a pair past the
    capacity ``cap`` of its (source, owner) pair is dropped), ``send_le``
    (n_ep, cap), each row's expert at its owner (``el``, the pad id, on an
    empty row), and ``(slot, keep, gates)`` for :func:`_a2a_combine`."""
    m = cfg.moe
    t, d = xt.shape
    logits = xt.to(torch.float32) @ wr.to(torch.float32)
    gates, idx = router_topk(logits, m.top_k)
    e_flat = idx.reshape(-1)
    dest = e_flat // el                                   # owner coordinate
    pos = _positions_in_expert(dest, n_ep)                # slot at dest
    keep = pos < cap
    slot = torch.where(keep, dest * cap + pos, n_ep * cap)
    tok_of = torch.arange(t, device=xt.device).repeat_interleave(m.top_k)
    send_x = torch.zeros((n_ep * cap + 1, d), dtype=xt.dtype,
                         device=xt.device)
    send_x[slot] = xt[tok_of]
    send_le = torch.full((n_ep * cap + 1,), el, dtype=torch.int64,
                         device=xt.device)                # pad expert
    send_le[slot] = e_flat % el
    return (send_x[:-1].reshape(n_ep, cap, d),
            send_le[:-1].reshape(n_ep, cap), (slot, keep, gates))


def _a2a_combine(back, route, cfg: ArchConfig):
    """Each token's gated sum (t, d) fp32 of its pairs' rows ``back``
    (n_ep, cap, d) sent back by their owners (``route`` from
    :func:`_a2a_send`)."""
    slot, keep, gates = route
    n = back.shape[0] * back.shape[1]
    back = back.reshape(n, -1)
    g_flat = gates.reshape(-1).to(torch.float32)
    contrib = (back[slot.clamp_max(n - 1)].to(torch.float32)
               * (g_flat * keep)[:, None])
    return contrib.reshape(gates.shape[0], cfg.moe.top_k, -1).sum(1)


def moe_sharded_a2a(p: dict, x: torch.Tensor, cfg: ArchConfig, ctx,
                    capacity_factor: float | None = None, stats=None):
    """Token-routed EP over the combined ("data", "model") axes: each
    coordinate owns E / (data x model) experts, and tokens travel to them
    and back by all-to-all.  The sequence is split over "model"; where it
    does not split (or is one token) this is ``moe_sharded_2d``."""
    m = cfg.moe
    b, s, d = x.shape
    da, ma = ctx.data_axis, ctx.model_axis
    n_ep = _a2a_owners(cfg, ctx)
    if s % ctx.mesh.shape[ma] or s == 1:
        return moe_sharded_2d(p, x, cfg, ctx, capacity_factor, stats)
    cf = capacity_factor if capacity_factor is not None else m.capacity_factor
    pl = _plan(cfg, ctx, "a2a", b, s, cf)
    cap = pl.cap
    aux = _global_aux(p, x, cfg)

    def local_fn(xl, wr, wg, wu, wd):
        bl, sl, _ = xl.shape
        send_x, send_le, route = _a2a_send(xl.reshape(bl * sl, d), wr, cfg,
                                           pl.el, n_ep, cap)
        _count_dropped(stats, (~route[1]).sum(), ctx.mesh, pl.owners,
                       _shard_map_rank(ctx.mesh))
        # route tokens to expert owners (payload: activations + ids)
        recv_x = rules.all_to_all(send_x, (da, ma), 0, 0)
        recv_le = rules.all_to_all(send_le, (da, ma), 0, 0)
        y_tok = _owned_experts_ffn(wg, wu, wd, recv_x.reshape(n_ep * cap, d),
                                   recv_le.reshape(n_ep * cap), pl.el)
        # send results back to the token owners
        back = rules.all_to_all(y_tok.reshape(n_ep, cap, d), (da, ma), 0, 0)
        y = _a2a_combine(back, route, cfg)
        return y.to(xl.dtype).reshape(bl, sl, d)

    y = shard_map(local_fn, mesh=ctx.mesh, in_specs=(pl.x_spec,) + pl.w_specs,
                  out_specs=pl.x_spec)(x, *(p[k] for k in _WEIGHTS))
    if m.num_shared_experts:
        y = y + _shared_ffn(p["shared"], x)
    return y, aux


def apply_moe(p: dict, x: torch.Tensor, cfg: ArchConfig, ctx=None,
              capacity_factor: float | None = None, stats=None):
    """Dispatch on context: sharded when a mesh with EP-divisible experts
    is present and ``moe_impl`` is not "dense", the dense path otherwise
    (which takes no capacity factor: it drops nothing)."""
    if (ctx is not None and ctx.mesh is not None
            and cfg.moe.num_experts % ctx.mesh.shape[ctx.model_axis] == 0
            and ctx.moe_impl != "dense"):
        if ctx.moe_impl == "sharded2d":
            return moe_sharded_2d(p, x, cfg, ctx, capacity_factor, stats)
        if ctx.moe_impl == "sharded_a2a":
            return moe_sharded_a2a(p, x, cfg, ctx, capacity_factor, stats)
        return moe_sharded(p, x, cfg, ctx, capacity_factor, stats)
    return moe_dense(p, x, cfg)


# ------------------------------------------------- on rank lists (M18c) ---
# The same three dispatch paths on the placed steps' rank lists
# (``sharding/spmd.py``): one block a mesh coordinate, a loop over the
# coordinates between collectives, each coordinate's work the shard_map
# form's ``local_fn`` (routing, capacity, positions, drops), its inputs
# resharded from where the step placed them to the shard_map form's
# in_specs (the reference's partitioner does the same at the boundary).
def _impl_of(cfg: ArchConfig, ctx, s: int) -> str:
    """``apply_moe``'s choice on ``ctx``, the a2a path's one-token and
    odd-sequence fallback to 2d made explicit."""
    ma = ctx.model_axis
    if (ctx.moe_impl == "dense"
            or cfg.moe.num_experts % ctx.mesh.shape[ma]):
        return "dense"
    if ctx.moe_impl == "sharded_a2a":
        _a2a_owners(cfg, ctx)
        return "sharded2d" if s % ctx.mesh.shape[ma] or s == 1 else "a2a"
    return "sharded2d" if ctx.moe_impl == "sharded2d" else "sharded"


def _placed_weights(bp: dict, mesh, specs) -> list[dict]:
    """Each coordinate's blocks of ``_WEIGHTS`` resharded to ``specs``, by
    name."""
    w = {k: spmd.reshard(bp[k].blocks, mesh, bp[k].spec, sp)
         for k, sp in zip(_WEIGHTS, specs)}
    return [{k: v[r] for k, v in w.items()} for r in range(mesh.size)]


def moe_placed(bp: dict, xs: list, x_spec, cfg: ArchConfig, ctx,
               capacity_factor: float | None = None, stats=None):
    """The MoE layer on rank lists: ``bp`` its leaves placed by short name
    (``router``, ``w_gate``, ``w_up``, ``w_down``, ``shared.*``), ``xs``
    the blocks of its (B, S, d) input placed by ``x_spec``.  Returns
    (the output's blocks, placed as ``xs``; the aux losses of the global
    router logits, on coordinate 0's device).  Each sharded path runs as
    its ``shard_map`` form does (``_impl_of``), and ``stats`` counts the
    dropped pairs as there."""
    mesh, ma = ctx.mesh, ctx.model_axis
    m = cfg.moe
    xp = spmd.Placed(xs, NamedSharding(mesh, x_spec))
    b, s, d = xp.shape
    aux = _global_aux({"router": spmd.whole(bp["router"], 0)},
                      spmd.whole(xp, 0), cfg)
    cf = capacity_factor if capacity_factor is not None else m.capacity_factor
    impl = _impl_of(cfg, ctx, s)
    if impl == "dense":
        w = _placed_weights(bp, mesh, (P(),) * len(_WEIGHTS))
        ys = [_routed_dense(w[r], x, cfg)[0] for r, x in enumerate(xs)]
    else:
        pl = _plan(cfg, ctx, impl, b, s, cf)
        xl = spmd.reshard(xs, mesh, x_spec, pl.x_spec)
        ys = _PLACED[impl](xl, _placed_weights(bp, mesh, pl.w_specs), pl,
                           cfg, ctx, stats)
        ys = spmd.reshard(ys, mesh, pl.x_spec, x_spec)
    if m.num_shared_experts:
        sw = {k[len("shared."):]: spmd.unshard(p, (ma,))
              for k, p in bp.items() if k.startswith("shared.")}
        sy = [_shared_ffn({k: v[r] for k, v in sw.items()}, x)
              for r, x in enumerate(xs)]
        if spmd.sharded_over(bp["shared.wo"], ma) is not None:
            sy = spmd.psum(sy, mesh, ma)
        ys = [y + t for y, t in zip(ys, sy)]
    return ys, aux


def _placed_sharded(xl, w, pl, cfg, ctx, stats):
    """``moe_sharded``'s ``local_fn`` over the coordinates' tokens ``xl``
    and weights ``w`` (placed as ``pl``'s in_specs)."""
    mesh, ma = ctx.mesh, ctx.model_axis
    rank_ma = spmd.axis_index(mesh, ma)
    ys = []
    for r, x in enumerate(xl):
        y, dropped = _dispatch_local(x.reshape(-1, x.shape[-1]), *(
            w[r][k] for k in _WEIGHTS), cfg, pl.el, pl.cap, rank_ma[r])
        _count_dropped(stats, dropped, mesh, pl.owners, r)
        ys.append(y)
    ys = spmd.psum(ys, mesh, ma)
    return [y.to(x.dtype).reshape(x.shape) for y, x in zip(ys, xl)]


def _placed_2d(xl, w, pl, cfg, ctx, stats):
    """``moe_sharded_2d``'s ``local_fn`` over the coordinates (as
    :func:`_placed_sharded`)."""
    mesh, da, ma = ctx.mesh, ctx.data_axis, ctx.model_axis
    gather_data = da in pl.batch_axes
    xg = spmd.all_gather(xl, mesh, da, 0) if gather_data else xl
    rank_ma = spmd.axis_index(mesh, ma)
    ys = []
    for r, x in enumerate(xg):
        y, dropped = _dispatch_local(x.reshape(-1, x.shape[-1]), *(
            w[r][k] for k in _WEIGHTS), cfg, pl.el, pl.cap, rank_ma[r])
        _count_dropped(stats, dropped, mesh, pl.owners, r)
        ys.append(y)
    if gather_data:     # each data rank its own tokens, the ff partials summed
        ys = spmd.psum_scatter(ys, mesh, da, 0)
    else:
        ys = spmd.psum(ys, mesh, da)                # ff partials only
    ys = spmd.psum(ys, mesh, ma)                    # expert groups
    return [y.to(x.dtype).reshape(x.shape) for y, x in zip(ys, xl)]


def _placed_a2a(xl, w, pl, cfg, ctx, stats):
    """``moe_sharded_a2a``'s ``local_fn`` over the coordinates (as
    :func:`_placed_sharded`; a sequence the model axis splits, of more
    than one token)."""
    mesh, axes = ctx.mesh, (ctx.data_axis, ctx.model_axis)
    n_ep, cap = cfg.moe.num_experts // pl.el, pl.cap
    sends, routes = [], []
    for r, x in enumerate(xl):
        send_x, send_le, route = _a2a_send(x.reshape(-1, x.shape[-1]),
                                           w[r]["router"], cfg, pl.el, n_ep,
                                           cap)
        _count_dropped(stats, (~route[1]).sum(), mesh, pl.owners, r)
        sends.append((send_x, send_le))
        routes.append(route)
    recv_x = spmd.all_to_all([x for x, _ in sends], mesh, axes, 0, 0)
    recv_le = spmd.all_to_all([e for _, e in sends], mesh, axes, 0, 0)
    y_tok = [_owned_experts_ffn(w[r]["w_gate"], w[r]["w_up"],
                                w[r]["w_down"], rx.reshape(n_ep * cap, -1),
                                re.reshape(n_ep * cap), pl.el)
             .reshape(n_ep, cap, -1)
             for r, (rx, re) in enumerate(zip(recv_x, recv_le))]
    back = spmd.all_to_all(y_tok, mesh, axes, 0, 0)
    return [_a2a_combine(bk, route, cfg).to(x.dtype).reshape(x.shape)
            for bk, route, x in zip(back, routes, xl)]


_PLACED = {"sharded": _placed_sharded, "sharded2d": _placed_2d,
           "a2a": _placed_a2a}


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
        self.stats = None                   # a dict to count drops into

    def forward(self, x: torch.Tensor, ctx=None,
                capacity_factor: float | None = None):
        """x: (B,S,d) -> (y, aux); ``apply_moe``'s dispatch on ``ctx``."""
        return apply_moe(self.tree, x, self.cfg, ctx, capacity_factor,
                         self.stats)
