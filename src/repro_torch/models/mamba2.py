"""Mamba-2 (SSD, state-space duality) mixer, arXiv:2405.21060.

Chunked SSD forward for train and prefill (O(S·Q) intra-chunk products and
an O(S/Q) inter-chunk state recurrence) and an O(1) single-token decode
step.  As in the reference, one weight leaf is kept per logical part of
the fused ``in_proj`` / conv layouts ([z | x | B | C | dt]).

The inter-chunk recurrence (the reference's ``lax.scan``) is a Python loop
over the S/Q chunks: few, large steps (8 at 2,048 tokens and Q 256).
The decode step writes the cache in place.

On a mesh (:func:`mamba_placed`) a coordinate holds its channels of the
"inner" leaves (``w_z``, ``w_x``, ``conv_x``, ``conv_bx``, ``norm``,
``out_proj``) and its heads of the "heads" leaves (``w_dt``, ``A_log``,
``D``, ``dt_bias``), both over the model axis, and ``w_B``, ``w_C`` and
their convs whole: it computes B and C whole and takes the columns of its
heads' groups (:func:`heads_groups`).  The gated RMSNorm spans the whole
inner dim, so its fp32 sum of squares is summed over the model axis
before the scale; the caller sums the ``out_proj`` partials there.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import SpecModule, rms_norm
from repro_torch.models.params import ParamSpec


def dims(cfg: ArchConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nheads = d_inner // s.head_dim
    return d_inner, nheads, s.n_groups, s.d_state, s.head_dim


# ----------------------------------------------------------------- specs ---
def mamba_specs(cfg: ArchConfig, prefix_axes=()) -> dict:
    s = cfg.ssm
    di, h, g, n, _ = dims(cfg)
    d = cfg.d_model
    pa = prefix_axes
    bf, f32 = torch.bfloat16, torch.float32
    return {
        "w_z": ParamSpec((d, di), bf, pa + ("embed", "inner")),
        "w_x": ParamSpec((d, di), bf, pa + ("embed", "inner")),
        "w_B": ParamSpec((d, g * n), bf, pa + ("embed", None)),
        "w_C": ParamSpec((d, g * n), bf, pa + ("embed", None)),
        "w_dt": ParamSpec((d, h), bf, pa + ("embed", "heads")),
        "conv_x": ParamSpec((s.d_conv, di), f32, pa + (None, "inner")),
        "conv_B": ParamSpec((s.d_conv, g * n), f32, pa + (None, None)),
        "conv_C": ParamSpec((s.d_conv, g * n), f32, pa + (None, None)),
        "conv_bx": ParamSpec((di,), f32, pa + ("inner",), "zeros"),
        "conv_bB": ParamSpec((g * n,), f32, pa + (None,), "zeros"),
        "conv_bC": ParamSpec((g * n,), f32, pa + (None,), "zeros"),
        "A_log": ParamSpec((h,), f32, pa + ("heads",), "zeros"),
        "D": ParamSpec((h,), f32, pa + ("heads",), "ones"),
        "dt_bias": ParamSpec((h,), f32, pa + ("heads",), "zeros"),
        "norm": ParamSpec((di,), f32, pa + ("inner",), "ones"),
        "out_proj": ParamSpec((di, d), bf, pa + ("inner", "embed")),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv. x: (B,S,C); w: (K,C). Returns (B,S,C) fp32."""
    k = w.shape[0]
    xp = F.pad(x.to(torch.float32), (0, 0, k - 1, 0))
    y = sum(xp[:, i: i + x.shape[1]] * w[i] for i in range(k))
    return y + b


def _conv_step(state, x_new, w, b):
    """state: (B,K-1,C); x_new: (B,C). Returns (y (B,C), new_state)."""
    window = torch.cat([state, x_new[:, None].to(state.dtype)], dim=1)
    y = torch.einsum("bkc,kc->bc", window.to(torch.float32), w) + b
    return y, window[:, 1:]


# ------------------------------------------------------------- SSD core ----
def ssd_chunked(xdt, a, B_, C_, chunk: int, h_init=None):
    """Chunked SSD scan.

    xdt: (B,S,H,P) fp32, dt-scaled inputs (dt·x)
    a:   (B,S,H)   fp32, log decay a step (dt·A, <= 0)
    B_:  (B,S,G,N) fp32;  C_: (B,S,G,N) fp32
    h_init: optional (B,H,P,N) starting state.
    Returns y (B,S,H,P) fp32 and the final state (B,H,P,N) fp32.
    """
    b, s, h, p = xdt.shape
    g, n = B_.shape[2], B_.shape[3]
    hg = h // g
    s_orig = s
    if s % chunk:  # zero-pad: a=0 -> decay 1 keeps state, xdt=0 adds nothing
        pad = chunk - s % chunk
        xdt, a, B_, C_ = (F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))
                          for t in (xdt, a, B_, C_))
        s = s + pad
    nc, q = s // chunk, chunk

    xc = xdt.reshape(b, nc, q, h, p)
    ac = a.reshape(b, nc, q, h)
    bc = B_.reshape(b, nc, q, g, n)
    cc = C_.reshape(b, nc, q, g, n)
    cum = torch.cumsum(ac, dim=2)                       # (B,nc,Q,H)
    # intra-chunk: scores[q,k] = (C_q·B_k)·exp(cum_q - cum_k), k<=q
    xch = xc.reshape(b, nc, q, g, hg, p)
    cumh = cum.reshape(b, nc, q, g, hg)
    cb = torch.einsum("bcqgn,bckgn->bcgqk", cc, bc)     # (B,nc,G,Q,K)
    dq = cumh.permute(0, 1, 3, 4, 2)                    # (B,nc,G,Hg,Q)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                 device=xdt.device))
    # k > q is masked before the exp, where the reference masks after it:
    # there cum_q - cum_k > 0 overflows to inf over a long chunk, and the
    # where's backward makes 0 * inf = NaN of it (mamba2-1.3b at 2,048
    # tokens); the forward's values and every finite gradient are the same
    dec = torch.exp(torch.where(mask, dq[..., :, None] - dq[..., None, :],
                                -torch.inf))            # (B,nc,G,Hg,Q,K)
    w_intra = torch.where(mask, cb[:, :, :, None] * dec, 0.0)
    y_intra = torch.einsum("bcghqk,bckghp->bcqghp", w_intra, xch)

    # local end-of-chunk states: S_c = sum_k exp(cum_last - cum_k) B_k x_k
    decay_to_end = torch.exp(cumh[:, :, -1:] - cumh)    # (B,nc,Q,G,Hg)
    s_local = torch.einsum("bckgn,bckgh,bckghp->bcghpn",
                           bc, decay_to_end, xch)       # (B,nc,G,Hg,P,N)
    cd = torch.exp(cum[:, :, -1]).reshape(b, nc, g, hg)

    if h_init is None:
        prev = torch.zeros((b, g, hg, p, n), dtype=torch.float32,
                           device=xdt.device)
    else:
        prev = h_init.reshape(b, g, hg, p, n)
    h_prevs = []                 # the state entering each chunk
    for c in range(nc):
        h_prevs.append(prev)
        prev = prev * cd[:, c, ..., None, None] + s_local[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)               # (B,nc,G,Hg,P,N)

    # inter-chunk contribution: C_q · h_prev · exp(cum_q)
    in_decay = torch.exp(cumh)                          # (B,nc,Q,G,Hg)
    y_inter = torch.einsum("bcqgn,bcghpn,bcqgh->bcqghp",
                           cc, h_prevs, in_decay)
    y = (y_intra + y_inter).reshape(b, s, h, p)
    return y[:, :s_orig], prev.reshape(b, h, p, n)


# ------------------------------------------------------------ layer apply --
def _project(p, x):
    z = torch.einsum("bsd,di->bsi", x, p["w_z"])
    xs = torch.einsum("bsd,di->bsi", x, p["w_x"])
    B_ = torch.einsum("bsd,dn->bsn", x, p["w_B"])
    C_ = torch.einsum("bsd,dn->bsn", x, p["w_C"])
    dt = torch.einsum("bsd,dh->bsh", x, p["w_dt"])
    return z, xs, B_, C_, dt


def _ssm_inputs(p, xs_c, B_c, C_c, dt, cfg: ArchConfig):
    """Post-conv activations -> fp32 SSD operands (the heads and groups
    those of the inputs: a coordinate's block or all)."""
    s_cfg = cfg.ssm
    bsz, s = xs_c.shape[:2]
    f32 = torch.float32
    x_h = F.silu(xs_c).reshape(bsz, s, -1, s_cfg.head_dim).to(f32)
    B_ = F.silu(B_c).reshape(bsz, s, -1, s_cfg.d_state).to(f32)
    C_ = F.silu(C_c).reshape(bsz, s, -1, s_cfg.d_state).to(f32)
    dtp = F.softplus(dt.to(f32) + p["dt_bias"].to(f32))
    a = dtp * (-torch.exp(p["A_log"].to(f32)))         # (B,S,H) <= 0
    xdt = x_h * dtp[..., None]
    return x_h, xdt, a, B_, C_


def heads_groups(B_, C_, first: int, n_heads: int, heads: int):
    """B and C (B, S, G, N) of all ``heads`` cut to what heads ``first``
    .. ``first + n_heads - 1`` read (head j reads group j // (heads / G)),
    as (B', C') of G' groups with the block's head i in group i // (n_heads
    / G'): a slice where the block holds whole groups or shares one group
    with other blocks, else a group a head."""
    if n_heads == heads:
        return B_, C_
    hg = heads // B_.shape[2]
    idx = [(first + i) // hg for i in range(n_heads)]
    g0, ng = idx[0], idx[-1] - idx[0] + 1
    if n_heads % ng == 0 and idx == [g0 + i // (n_heads // ng)
                                     for i in range(n_heads)]:
        return B_[:, :, g0:g0 + ng], C_[:, :, g0:g0 + ng]
    ix = torch.tensor(idx, device=B_.device)
    return B_.index_select(2, ix), C_.index_select(2, ix)


def _gated(p, y, x_h, z):
    """(y + D x) * silu(z): the gated norm's input (B, S, inner) in z's
    dtype."""
    bsz, s = z.shape[:2]
    y = y + p["D"].to(torch.float32)[None, None, :, None] * x_h
    y = y.reshape(bsz, s, -1).to(z.dtype)
    return y * F.silu(z)


def _scan(p, x, cfg: ArchConfig, first: int = 0):
    """Train / prefill of the heads ``p`` holds from head ``first`` on:
    the gated norm's input and the decode cache (the last K-1 pre-conv
    inputs (fp32) and the final state)."""
    z, xs, B_, C_, dt = _project(p, x)
    xs_c = _causal_conv(xs, p["conv_x"], p["conv_bx"])
    B_c = _causal_conv(B_, p["conv_B"], p["conv_bB"])
    C_c = _causal_conv(C_, p["conv_C"], p["conv_bC"])
    x_h, xdt, a, Bn, Cn = _ssm_inputs(p, xs_c, B_c, C_c, dt, cfg)
    Bn, Cn = heads_groups(Bn, Cn, first, x_h.shape[2], dims(cfg)[1])
    chunk = min(cfg.ssm.chunk_size, x.shape[1])
    y, h_last = ssd_chunked(xdt, a, Bn, Cn, chunk)
    k = cfg.ssm.d_conv - 1
    cache = {
        "conv_x": xs[:, -k:].to(torch.float32),
        "conv_B": B_[:, -k:].to(torch.float32),
        "conv_C": C_[:, -k:].to(torch.float32),
        "ssm": h_last,
    }
    return _gated(p, y, x_h, z), cache


def _step(p, x, cfg: ArchConfig, cache: dict, first: int = 0):
    """One-token decode of the heads ``p`` holds from head ``first`` on
    over their ``cache``: the gated norm's input and the new cache."""
    hp, n = cfg.ssm.head_dim, cfg.ssm.d_state
    z, xs, B_, C_, dt = _project(p, x)
    xc, cx = _conv_step(cache["conv_x"], xs[:, 0], p["conv_x"], p["conv_bx"])
    bc, cb = _conv_step(cache["conv_B"], B_[:, 0], p["conv_B"], p["conv_bB"])
    cc, ccs = _conv_step(cache["conv_C"], C_[:, 0], p["conv_C"], p["conv_bC"])
    x_h, xdt, a, Bn, Cn = _ssm_inputs(
        p, xc[:, None], bc[:, None], cc[:, None], dt, cfg)
    h = x_h.shape[2]
    Bn, Cn = heads_groups(Bn, Cn, first, h, dims(cfg)[1])
    g = Bn.shape[2]
    # state update: S = S*exp(a) + (dt x) ⊗ B  ; y = C·S
    bsz = x.shape[0]
    xdt1 = xdt[:, 0].reshape(bsz, g, h // g, hp)
    Bn1, Cn1 = Bn[:, 0], Cn[:, 0]                         # (B,G,N)
    ssm = cache["ssm"].reshape(bsz, g, h // g, hp, n)
    decay = torch.exp(a[:, 0]).reshape(bsz, g, h // g)
    ssm = (ssm * decay[..., None, None]
           + torch.einsum("bghp,bgn->bghpn", xdt1, Bn1))
    y = torch.einsum("bgn,bghpn->bghp", Cn1, ssm).reshape(bsz, 1, h, hp)
    return _gated(p, y, x_h, z), {"conv_x": cx, "conv_B": cb,
                                  "conv_C": ccs,
                                  "ssm": ssm.reshape(bsz, h, hp, n)}


def _out(p, y, cfg: ArchConfig):
    """The gated RMSNorm over the whole inner dim, then ``out_proj``."""
    y = rms_norm(p["norm"], y, cfg.norm_eps)
    return torch.einsum("bsi,id->bsd", y, p["out_proj"])


def mamba_forward(p, x, cfg: ArchConfig, return_cache: bool = False):
    """Train / prefill. x: (B,S,d).  With ``return_cache`` also the decode
    cache: the last K-1 pre-conv inputs (fp32) and the final state."""
    y, cache = _scan(p, x, cfg)
    out = _out(p, y, cfg)
    return (out, cache) if return_cache else out


def mamba_cache_specs(cfg: ArchConfig, batch: int, prefix_axes=()) -> dict:
    di, h, g, n, hp = dims(cfg)
    k = cfg.ssm.d_conv - 1
    pa = prefix_axes
    f32 = torch.float32
    return {
        "conv_x": ParamSpec((batch, k, di), f32,
                            pa + ("batch", None, "inner"), "zeros"),
        "conv_B": ParamSpec((batch, k, g * n), f32,
                            pa + ("batch", None, None), "zeros"),
        "conv_C": ParamSpec((batch, k, g * n), f32,
                            pa + ("batch", None, None), "zeros"),
        "ssm": ParamSpec((batch, h, hp, n), f32,
                         pa + ("batch", "heads", None, None), "zeros"),
    }


def _check_prompt(x, cfg: ArchConfig) -> None:
    k = cfg.ssm.d_conv - 1
    if x.shape[1] < k:
        raise ValueError(f"a Mamba prefill needs at least {k} tokens (the "
                         f"conv state's rows); got {x.shape[1]}")


def mamba_prefill(p, x, cfg: ArchConfig, cache: dict):
    """``mamba_forward(return_cache=True)`` with the cache written into
    ``cache``'s tensors in place.  Returns (y, cache).  A prompt shorter
    than the conv's K-1 rows leaves the reference a conv state of the
    wrong shape, which its decode step then refuses; here the prefill
    raises ``ValueError``."""
    _check_prompt(x, cfg)
    y, new = mamba_forward(p, x, cfg, return_cache=True)
    for name, t in new.items():
        cache[name].copy_(t)
    return y, cache


def mamba_decode(p, x, cfg: ArchConfig, cache: dict, positions=None):
    """One-token decode. x: (B,1,d). O(1) in sequence length; the cache is
    written in place.  Returns (y, cache)."""
    y, new = _step(p, x, cfg, cache)
    for name, t in new.items():
        cache[name].copy_(t)
    return _out(p, y, cfg), cache


# ------------------------------------------------------------ on a mesh ---
_INNER = ("w_z", "w_x", "conv_x", "conv_bx", "norm", "out_proj")
_HEADS = ("w_dt", "A_log", "D", "dt_bias")


def check_split(cfg: ArchConfig, ctx) -> bool:
    """Whether the model axis splits the mixer's inner channels and heads
    under ``ctx``'s rules (``spec_for``, the parameters' and the cache's
    leaves); a leaf split otherwise than ``w_x`` (inner split, heads
    dropped, or the reverse) raises ``ValueError`` naming it."""
    from repro_torch.sharding.rules import default_rules, spec_for
    ma = ctx.model_axis
    rules_ = default_rules(ctx, mode="serve")
    leaves = dict(mamba_specs(cfg))
    leaves.update({f"cache {k}": v
                   for k, v in mamba_cache_specs(cfg, 1).items()})
    want = None
    for name, leaf in leaves.items():
        spec = spec_for(leaf, rules_, ctx.mesh)
        for logical, entry in zip(leaf.axes, spec):
            if logical not in ("inner", "heads"):
                continue
            split = entry is not None and ma in (
                (entry,) if isinstance(entry, str) else entry)
            if want is None:
                want = split
            elif split != want:
                raise ValueError(
                    f"mamba leaf {name}: its {logical!r} dim is "
                    f"{'split' if split else 'not split'} over "
                    f"{ma!r} while w_x's inner dim is "
                    f"{'split' if want else 'not'}; the placed mixer "
                    "needs inner channels and heads split alike "
                    f"({dims(cfg)[0]} channels, {dims(cfg)[1]} heads on "
                    f"{ctx.mesh.shape[ma]} coordinates)")
    return bool(want)


def mamba_placed(hs: list, ws: list, cfg: ArchConfig, *, mode: str, views,
                 first: list, mesh, model_axis: str, split: bool) -> list:
    """The Mamba-2 mixer on rank lists (``models/transformer.py::
    _mesh_block``): ``hs`` each coordinate's normed input, ``ws`` its
    weights (its inner channels and heads from head ``first`` where
    ``split``, else whole), ``views`` its block of the layer's cache (None
    in train mode), written in place.  Returns each coordinate's share of
    ``out_proj`` (partial over its channels where ``split``).  The gated
    norm's fp32 sum of squares is summed over the model axis (in
    ``spmd.psum``'s row-major order) before the scale."""
    n = len(hs)
    ys = []
    for r in range(n):
        if mode == "decode":
            y, new = _step(ws[r], hs[r], cfg, views[r], first[r])
        else:
            if mode == "prefill":
                _check_prompt(hs[r], cfg)
            y, new = _scan(ws[r], hs[r], cfg, first[r])
        if views is not None:
            for name, t in new.items():
                views[r][name].copy_(t)
        ys.append(y)
    if not split:
        return [_out(w, y, cfg) for w, y in zip(ws, ys)]
    from repro_torch.sharding import spmd
    sq = spmd.psum([y.to(torch.float32).square().sum(-1, keepdim=True)
                    for y in ys], mesh, model_axis)
    di = dims(cfg)[0]
    outs = []
    for w, y, s in zip(ws, ys, sq):
        yn = (y.to(torch.float32) * torch.rsqrt(s / di + cfg.norm_eps)
              * w["norm"]).to(y.dtype)
        outs.append(torch.einsum("bsi,id->bsd", yn, w["out_proj"]))
    return outs


class Mamba(SpecModule):
    """Holds one layer's Mamba-2 weights in the reference's layouts."""

    def __init__(self, cfg: ArchConfig, *, device, dtype):
        super().__init__(mamba_specs(cfg), device=device, dtype=dtype)
        self.cfg = cfg
        self.tree = self.param_tree()       # updated in place, built once

    def forward(self, x, positions=None, impl=None):
        return mamba_forward(self.tree, x, self.cfg)

    def prefill(self, x, cache: dict, positions=None, impl=None):
        return mamba_prefill(self.tree, x, self.cfg, cache)[0]

    def decode(self, x, cache: dict, positions=None):
        return mamba_decode(self.tree, x, self.cfg, cache, positions)[0]
