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

The aux losses (load balance + router z-loss) come from the global router
logits outside the ``shard_map``, as in the reference.  A sharded path
called with ``stats={}`` adds to ``stats["dropped"]`` the (token, expert)
pairs it dropped, each pair counted once however many coordinates hold a
copy of its token.

The functions take the reference's parameter dict (``router``, ``w_gate``,
``w_up``, ``w_down`` and, with shared experts, ``shared``: ``wi_gate``,
``wi_up``, ``wo``); :class:`MoE` holds those leaves and passes them in.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import SpecModule
from repro_torch.models.params import ParamSpec
from repro_torch.sharding import rules
from repro_torch.sharding.rules import P, shard_map

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


def _count_dropped(stats, dropped, mesh, owner_axes):
    """Add ``dropped`` (a count on the device) to ``stats`` at one
    coordinate of each group that holds the same pairs: where every axis
    outside ``owner_axes`` is 0.  Reads the count (a sync) only where
    ``stats`` is given."""
    if stats is None:
        return
    if all(rules.axis_index(a) == 0 for a in mesh.axis_names
           if a not in owner_axes):
        # one coordinate runs at a time (shard_map's baton): no lock
        stats["dropped"] = stats.get("dropped", 0) + int(dropped)


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


def moe_sharded(p: dict, x: torch.Tensor, cfg: ArchConfig, ctx,
                capacity_factor: float | None = None, stats=None):
    """EP dispatch over the model axis.  ctx: ShardCtx with a mesh."""
    m = cfg.moe
    b, s, d = x.shape
    ma = ctx.model_axis
    ep = ctx.mesh.shape[ma]
    if m.num_experts % ep:
        raise ValueError(f"{m.num_experts} experts on a {ep}-way model axis")
    el = m.num_experts // ep
    cf = capacity_factor if capacity_factor is not None else m.capacity_factor
    aux = _global_aux(p, x, cfg)
    batch_axes = _batch_axes_for(ctx, b)
    batch_spec = P(batch_axes if batch_axes else None, None, None)
    n_batch_shards = math.prod(ctx.mesh.shape[a] for a in batch_axes)
    t_local = (b // n_batch_shards) * s
    cap = max(8, int(t_local * m.top_k * cf / m.num_experts))

    def local_fn(xl, wr, wg, wu, wd):
        bl, sl, _ = xl.shape
        y, dropped = _dispatch_local(xl.reshape(bl * sl, d), wr, wg, wu, wd,
                                     cfg, el, cap, rules.axis_index(ma))
        _count_dropped(stats, dropped, ctx.mesh, batch_axes + (ma,))
        y = rules.psum(y, ma)
        return y.to(xl.dtype).reshape(bl, sl, d)

    w_spec = P(ma, None, None)
    y = shard_map(local_fn, mesh=ctx.mesh,
                  in_specs=(batch_spec, P(None, None), w_spec, w_spec,
                            w_spec),
                  out_specs=batch_spec)(x, p["router"], p["w_gate"],
                                        p["w_up"], p["w_down"])
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
    ep = ctx.mesh.shape[ma]
    ff = m.d_ff_expert or cfg.d_ff
    if m.num_experts % ep or ff % ctx.mesh.shape[da]:
        raise ValueError(f"{m.num_experts} experts x ff {ff} on a "
                         f"{ctx.mesh.shape} mesh")
    el = m.num_experts // ep
    cf = capacity_factor if capacity_factor is not None else m.capacity_factor
    aux = _global_aux(p, x, cfg)
    batch_axes = _batch_axes_for(ctx, b)
    gather_data = da in batch_axes
    batch_spec = P(batch_axes if batch_axes else None, None, None)
    n_pod = math.prod(ctx.mesh.shape[a] for a in batch_axes if a != da)
    t_g = (b // n_pod) * s                       # tokens after data-gather
    cap = max(8, int(t_g * m.top_k * cf / m.num_experts))

    def local_fn(xl, wr, wg, wu, wd):
        if gather_data:
            xl = rules.all_gather(xl, da, axis=0)
        y, dropped = _dispatch_local(xl.reshape(-1, d), wr, wg, wu, wd, cfg,
                                     el, cap, rules.axis_index(ma))
        # every data rank routes the same tokens: count them at rank 0
        _count_dropped(stats, dropped, ctx.mesh,
                       tuple(a for a in batch_axes if a != da) + (ma,))
        if gather_data:
            # returns each data-rank its own tokens, summing ff partials
            y = rules.psum_scatter(y, da, scatter_dimension=0)
            bl = b // (n_pod * ctx.mesh.shape[da])
        else:
            y = rules.psum(y, da)                # ff partials only
            bl = b // n_pod
        y = rules.psum(y, ma)                    # expert groups
        return y.to(xl.dtype).reshape(bl, s, d)

    y = shard_map(local_fn, mesh=ctx.mesh,
                  in_specs=(batch_spec, P(None, None), P(ma, None, da),
                            P(ma, None, da), P(ma, da, None)),
                  out_specs=batch_spec)(x, p["router"], p["w_gate"],
                                        p["w_up"], p["w_down"])
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


def moe_sharded_a2a(p: dict, x: torch.Tensor, cfg: ArchConfig, ctx,
                    capacity_factor: float | None = None, stats=None):
    """Token-routed EP over the combined ("data", "model") axes: each
    coordinate owns E / (data x model) experts, and tokens travel to them
    and back by all-to-all.  The sequence is split over "model"; where it
    does not split (or is one token) this is ``moe_sharded_2d``."""
    m = cfg.moe
    b, s, d = x.shape
    da, ma = ctx.data_axis, ctx.model_axis
    n_ep = ctx.mesh.shape[da] * ctx.mesh.shape[ma]
    if m.num_experts % n_ep:
        raise ValueError(f"{m.num_experts} experts on {n_ep} coordinates")
    el = m.num_experts // n_ep
    cf = capacity_factor if capacity_factor is not None else m.capacity_factor
    msize = ctx.mesh.shape[ma]
    if s % msize or s == 1:
        return moe_sharded_2d(p, x, cfg, ctx, capacity_factor, stats)
    aux = _global_aux(p, x, cfg)
    batch_axes = _batch_axes_for(ctx, b)
    # tokens fully sharded: batch over (pod, data), the sequence over model
    batch_spec = P(batch_axes if batch_axes else None, ma, None)
    n_shards = math.prod(ctx.mesh.shape[a] for a in batch_axes)
    t_loc = (b // n_shards) * (s // msize)
    cap = max(8, int(t_loc * m.top_k * cf / n_ep))   # per (src, dst) pair

    def local_fn(xl, wr, wg, wu, wd):
        bl, sl, _ = xl.shape
        t = bl * sl
        xt = xl.reshape(t, d)
        logits = xt.to(torch.float32) @ wr.to(torch.float32)
        gates, idx = router_topk(logits, m.top_k)
        e_flat = idx.reshape(-1)
        dest = e_flat // el                               # owner coordinate
        pos = _positions_in_expert(dest, n_ep)            # slot at dest
        keep = pos < cap
        _count_dropped(stats, (~keep).sum(), ctx.mesh,
                       batch_axes + (ma,))
        slot = torch.where(keep, dest * cap + pos, n_ep * cap)
        tok_of = torch.arange(t, device=xt.device).repeat_interleave(
            m.top_k)
        send_x = torch.zeros((n_ep * cap + 1, d), dtype=xt.dtype,
                             device=xt.device)
        send_x[slot] = xt[tok_of]
        send_le = torch.full((n_ep * cap + 1,), el, dtype=torch.int64,
                             device=xt.device)            # pad expert
        send_le[slot] = e_flat % el
        # route tokens to expert owners (payload: activations + ids)
        recv_x = rules.all_to_all(send_x[:-1].reshape(n_ep, cap, d),
                                  (da, ma), 0, 0)
        recv_le = rules.all_to_all(send_le[:-1].reshape(n_ep, cap),
                                   (da, ma), 0, 0)
        recv_x = recv_x.reshape(n_ep * cap, d)
        recv_le = recv_le.reshape(n_ep * cap)
        y_tok = _owned_experts_ffn(wg, wu, wd, recv_x, recv_le, el)
        # send results back to the token owners
        back = rules.all_to_all(y_tok.reshape(n_ep, cap, d), (da, ma), 0, 0)
        back = back.reshape(n_ep * cap, d)
        g_flat = gates.reshape(-1).to(torch.float32)
        contrib = (back[slot.clamp_max(n_ep * cap - 1)].to(torch.float32)
                   * (g_flat * keep)[:, None])
        y = contrib.reshape(t, m.top_k, d).sum(1)
        return y.to(xl.dtype).reshape(bl, sl, d)

    w_spec = P((da, ma), None, None)
    y = shard_map(local_fn, mesh=ctx.mesh,
                  in_specs=(batch_spec, P(None, None), w_spec, w_spec,
                            w_spec),
                  out_specs=batch_spec)(x, p["router"], p["w_gate"],
                                        p["w_up"], p["w_down"])
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
