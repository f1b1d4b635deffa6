"""Logical-axis -> mesh-axis sharding rules, and ``shard_map`` over the
port's meshes.

Parallelism map (the reference's):
  * DP   : batch over ("pod", "data")     — cross-pod gradient all-reduce
  * FSDP : weight "embed" dim over "data"
  * TP   : "ff"/"heads"/"vocab"/"inner" over "model"
  * EP   : "experts" over "model" (the sharded MoE's dispatch)
  * SP   : "kv_seq" over "data" (or the axes ``seq_shard_kv`` names)

Per-leaf divisibility: a mesh axis is dropped for a dimension it does not
divide (12 attention heads on a 16-way model axis stay replicated).
Duplicate mesh axes within one leaf keep the first occurrence (MoE weights:
"experts" -> model wins over "ff" -> model).  A partition spec is a tuple
a leaf (``P``, a tuple): one entry a dimension, each ``None``, an axis
name or a tuple of axis names (JAX's ``PartitionSpec`` is the same
tuple).

The reference hands these specs to XLA's partitioner, which places the
arrays and splits the work.  The port's counterpart is
``sharding/spmd.py``: ``spmd.place`` puts each leaf's blocks on its
coordinates' devices by these specs (``partition_tree``,
``train.step_shardings``, ``serve.serve_shardings``), and the sharded
steps of the dense decoder and the MoE family
(``runtime/train.py::jit_train_step``,
``runtime/serve.py::jit_decode_step``) run on those blocks, one host
thread looping over the coordinates, with ``spmd``'s differentiable
collectives between them (DP over the batch axes, FSDP gathers of
"embed", TP over heads, ff and vocab, EP over experts, SP over the
cache's slots).  The other families, and the eager
``LM.prefill(..., ShardCtx(mesh=...))`` route, keep running on the
caller's device, where only ``shard_map`` code splits work across the
mesh: the sharded MoE paths' ``shard_map`` forms (``models/moe.py``) and
the tied-head cross-entropy with ``replicate_lm_head``
(``runtime/train.py::chunked_xent``).

``shard_map(f, mesh=, in_specs=, out_specs=)`` runs ``f`` once a mesh
coordinate, each in a thread of its own (a pool kept a mesh size, so a
thread's CUDA and cuBLAS state outlives a call; one thread runs at a time,
in rank order, handing on at each collective) with that coordinate's
device current,
on its blocks of the inputs; ``axis_index``, ``psum``, ``pmax``,
``all_gather``, ``psum_scatter`` and ``all_to_all`` inside ``f`` are the
collectives the
reference's local functions call, made of explicit cross-device copies and
sums in a fixed (row-major) order.  A (1, ..., 1) mesh runs ``f`` inline.  Outputs are
assembled on the first input's device; an output axis a spec leaves out
must be replicated there, and coordinate 0's copy is taken.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Mapping

import torch

from repro_torch.launch import op_analysis
from repro_torch.launch.mesh import Mesh
from repro_torch.models.params import ParamSpec, tree_map_specs

MOE_IMPLS = ("auto", "dense", "sharded", "sharded2d", "sharded_a2a")


class P(tuple):
    """A partition spec: ``P(None, "model")`` is the tuple ``(None,
    "model")``; a one-axis tuple entry is that axis's name, as in JAX."""

    def __new__(cls, *parts):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, (tuple, list)) and len(e) == 1 else e
            for e in parts))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Threaded through the model's entry points; None mesh = one device."""
    mesh: Any = None                       # launch.mesh.Mesh | None
    pod_axis: str | None = "pod"           # None on single-pod meshes
    data_axis: str = "data"
    model_axis: str = "model"
    moe_impl: str = "auto"                 # see MOE_IMPLS
    attn_impl: str = "blocked"             # "blocked" | "dot" | "flash"
    seq_shard_kv: bool = False             # SP: shard kv_seq over data
    remat: bool = False                    # recompute each layer in backward
    moe_decode_cf: float = 8.0             # looser capacity for tiny decode T
    replicate_lm_head: bool = False        # tied-embed archs: shard the
                                           # loss's tokens, not the head
    fsdp_pod: bool = False                 # FSDP over (pod, data)

    def __post_init__(self):
        if self.mesh is not None and not isinstance(self.mesh, Mesh):
            raise TypeError(f"mesh must be a launch.mesh.Mesh, got "
                            f"{type(self.mesh).__name__}")
        if self.moe_impl not in MOE_IMPLS:
            raise ValueError(f"moe_impl {self.moe_impl!r}; one of "
                             f"{MOE_IMPLS}")
        if self.mesh is None and self.moe_impl not in ("auto", "dense"):
            raise ValueError(
                f"moe_impl {self.moe_impl!r}: the sharded MoE paths need a "
                "mesh (ShardCtx(mesh=launch.mesh.make_mesh(...)))")

    @property
    def batch_axes(self) -> tuple[str, ...]:
        axes = []
        if self.pod_axis and self.mesh is not None \
                and self.pod_axis in self.mesh.axis_names:
            axes.append(self.pod_axis)
        axes.append(self.data_axis)
        return tuple(axes)

    def axis_size(self, axes) -> int:
        if self.mesh is None:
            return 1
        if isinstance(axes, str):
            axes = (axes,)
        return math.prod(self.mesh.shape[a] for a in axes)

    def constrain(self, x, spec=None):
        """The reference's sharding constraint at its call sites (the
        residual stream after each layer group, a microbatch's rows): a
        placed tensor (``spmd.Placed``) must already be laid out by
        ``spec`` (default: ``batch_spec``), else ``ValueError``; it is
        never moved.  An eager tensor on one device has no layout and is
        returned as it is."""
        sharding = getattr(x, "sharding", None)
        if sharding is None:
            return x
        ndim = len(x.shape)
        want = self.batch_spec(ndim) if spec is None else P(*spec)
        pad = lambda s: tuple(s) + (None,) * (ndim - len(s))  # noqa: E731
        if pad(sharding.spec) != pad(want):
            raise ValueError(f"placed as {sharding.spec}; the constraint "
                             f"wants {want}")
        return x

    def batch_spec(self, ndim: int, batch_dim: int = 0) -> P:
        parts: list = [None] * ndim
        parts[batch_dim] = self.batch_axes
        return P(*parts)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A partition spec on a mesh (JAX's ``NamedSharding``)."""
    mesh: Mesh
    spec: P


def default_rules(ctx: ShardCtx, *, mode: str = "train") -> dict[str, Any]:
    """logical axis -> mesh axis (or tuple).  mode: "train" | "serve"."""
    ba = ctx.batch_axes
    return {
        "batch": ba,
        "embed": ((tuple(ba) if ctx.fsdp_pod and len(ba) > 1
                   else ctx.data_axis)
                  if mode == "train" else None),             # FSDP
        "ff": ctx.model_axis,
        "heads": ctx.model_axis,
        "kv_heads": ctx.model_axis,
        "vocab": ctx.model_axis,
        "vocab_tbl": None,                  # gather stays local
        "embed_tbl": None if ctx.replicate_lm_head else ctx.model_axis,
        # a2a EP shards whole experts over (data x model); 2D EP shards the
        # expert ffn dim over data instead (both serve-scale layouts)
        "experts": ((ctx.data_axis, ctx.model_axis)
                    if mode == "serve" and ctx.moe_impl == "sharded_a2a"
                    else ctx.model_axis),
        "expert_ff": (ctx.data_axis if mode == "serve"
                      and ctx.moe_impl == "sharded2d" else None),
        "inner": ctx.model_axis,
        "q_lora": None,
        "kv_lora": None,
        "layers": None,
        "kv_seq": (None if not ctx.seq_shard_kv else
                   ctx.data_axis if ctx.seq_shard_kv is True else
                   ctx.seq_shard_kv),
    }


def spec_for(leaf: ParamSpec, rules: Mapping[str, Any], mesh) -> P:
    """The partition spec of one ParamSpec, with divisibility and
    duplicate filtering.  Reads only ``mesh.shape``."""
    if not leaf.axes or mesh is None:
        return P()
    used: set[str] = set()
    parts = []
    for dim, logical in zip(leaf.shape, leaf.axes):
        axis = rules.get(logical) if logical else None
        if axis is None:
            parts.append(None)
            continue
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        kept = [a for a in axes if a not in used]
        if kept and dim % math.prod(mesh.shape[a] for a in kept) == 0:
            used.update(kept)
            parts.append(tuple(kept) if len(kept) > 1 else kept[0])
        else:
            parts.append(None)
    return P(*parts)


def partition_tree(specs, rules: Mapping[str, Any], mesh):
    """ParamSpec tree -> partition spec tree."""
    return tree_map_specs(lambda s: spec_for(s, rules, mesh), specs)


def sharding_tree(specs, rules, mesh: Mesh):
    """ParamSpec tree -> NamedSharding tree."""
    return tree_map_specs(
        lambda s: NamedSharding(mesh, spec_for(s, rules, mesh)), specs)


# ---------------------------------------------------------------- shard_map
_LOCAL = threading.local()
_POOLS: dict[int, ThreadPoolExecutor] = {}


def _pool(n: int) -> ThreadPoolExecutor:
    """n worker threads, made once: a call holds a thread a coordinate
    (they wait on one another at collectives)."""
    if n not in _POOLS:
        _POOLS[n] = ThreadPoolExecutor(max_workers=n,
                                       thread_name_prefix=f"shard_map{n}")
    return _POOLS[n]


class _Aborted(Exception):
    """Another coordinate of the call raised."""


class _Group:
    """The coordinates of one ``shard_map`` call.  One runs at a time, in
    rank order, handing a baton on at each collective: the threads are
    coroutines, so no two contend for the interpreter lock, and a
    coordinate's work reaches the device in one piece."""

    def __init__(self, mesh: Mesh, solo: bool = False):
        self.mesh = mesh
        self.solo = solo                # coordinate 0 stands for all
        self.coords = mesh.coords()
        self.rank_of = {c: i for i, c in enumerate(self.coords)}
        self.slots: list = [None] * len(self.coords)
        self.vals: list = []
        self.cond = threading.Condition()
        self.turn = 0                   # the rank that may run
        self.generation = 0             # collectives completed
        self.broken = False

    def _wait(self, ready):
        self.cond.wait_for(lambda: self.broken or ready())
        if self.broken:
            raise _Aborted

    def start(self, rank: int):
        with self.cond:
            self._wait(lambda: self.turn == rank)

    def exchange(self, value):
        """Every coordinate's ``value``, by rank (a rendezvous)."""
        rank, n = _LOCAL.rank, len(self.coords)
        if n == 1 or self.solo:
            return [value] * n
        with self.cond:
            self.slots[rank] = value
            gen = self.generation
            if rank == n - 1:           # the last one in completes it
                self.vals = list(self.slots)
                self.generation += 1
                self.turn = 0
            else:
                self.turn = rank + 1
            self.cond.notify_all()
            self._wait(lambda: self.generation > gen and self.turn == rank)
            return self.vals

    def finish(self, rank: int):
        with self.cond:
            self.turn = rank + 1
            self.cond.notify_all()

    def abort(self):
        with self.cond:
            self.broken = True
            self.cond.notify_all()


def _ctx():
    group = getattr(_LOCAL, "group", None)
    if group is None:
        raise RuntimeError("collectives run only inside shard_map")
    return group, _LOCAL.coord


def _axes(names) -> tuple[str, ...]:
    return (names,) if isinstance(names, str) else tuple(names)


def _members(names):
    """(ranks of the coordinates that differ from mine only on ``names``,
    row-major over ``names`` in the order given; my index among them)."""
    group, coord = _ctx()
    names = _axes(names)
    mesh = group.mesh
    dims = [mesh.axis_names.index(a) for a in names]
    members = []
    for idx in _row_major([mesh.devices.shape[d] for d in dims]):
        c = list(coord)
        for d, i in zip(dims, idx):
            c[d] = i
        members.append(group.rank_of[tuple(c)])
    mine = 0
    for d in dims:
        mine = mine * mesh.devices.shape[d] + coord[d]
    return members, mine


def _row_major(sizes):
    out = [()]
    for n in sizes:
        out = [p + (i,) for p in out for i in range(n)]
    return out


def axis_index(names) -> int:
    """My index along ``names`` (row-major over a tuple of axes)."""
    return _members(names)[1]


def _gathered(x, names):
    group, _ = _ctx()
    vals = group.exchange(x)
    members, mine = _members(names)
    return [vals[r].to(x.device) for r in members], mine


def _sum(vals):
    out = vals[0]
    for v in vals[1:]:
        out = out + v
    return out


# Each collective runs its emulation (copies and sums across the
# coordinates) uncounted and reports itself to an active counter as one
# op with the reference's ring factor (``launch/op_analysis.py``).
def psum(x, names):
    """Sum of ``x`` over the coordinates along ``names``, in member order."""
    with op_analysis.uncounted():
        vals = _gathered(x, names)[0]
        out = _sum(vals)
    op_analysis.report_collective("all-reduce", x, out, len(vals))
    return out


def pmax(x, names):
    """Elementwise maximum of ``x`` over the coordinates along ``names``."""
    with op_analysis.uncounted():
        vals = _gathered(x, names)[0]
        out = vals[0]
        for v in vals[1:]:
            out = torch.maximum(out, v)
    op_analysis.report_collective("all-reduce", x, out, len(vals))
    return out


def all_gather(x, names, axis: int = 0):
    """The members' ``x`` concatenated on ``axis`` (JAX's
    ``all_gather(..., tiled=True)``)."""
    with op_analysis.uncounted():
        vals = _gathered(x, names)[0]
        out = torch.cat(vals, dim=axis)
    op_analysis.report_collective("all-gather", x, out, len(vals))
    return out


def psum_scatter(x, names, scatter_dimension: int = 0):
    """The sum over ``names``, of which each member keeps its slice of
    ``scatter_dimension`` (JAX's ``psum_scatter(..., tiled=True)``)."""
    with op_analysis.uncounted():
        vals, mine = _gathered(x, names)
        out = _sum(vals).chunk(len(vals), dim=scatter_dimension)[mine]
    op_analysis.report_collective("reduce-scatter", x, out, len(vals))
    return out


def all_to_all(x, names, split_axis: int, concat_axis: int):
    """Member j's entry ``mine`` of ``split_axis`` (one entry a member)
    arrives as my entry j of a new ``concat_axis`` (JAX's
    ``all_to_all(..., tiled=False)``)."""
    with op_analysis.uncounted():
        vals, mine = _gathered(x, names)
        if x.shape[split_axis] != len(vals):
            raise ValueError(f"all_to_all: split axis of "
                             f"{x.shape[split_axis]} for {len(vals)} "
                             "members")
        out = torch.stack([v.select(split_axis, mine) for v in vals],
                          dim=concat_axis)
    op_analysis.report_collective("all-to-all", x, out, len(vals))
    return out


def _block(x, spec, mesh: Mesh, coord):
    """Coordinate ``coord``'s block of the global ``x`` under ``spec``."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = _axes(entry)
        n, idx = 1, 0
        for a in axes:
            d = mesh.axis_names.index(a)
            n *= mesh.devices.shape[d]
            idx = idx * mesh.devices.shape[d] + coord[d]
        if x.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                             f"split {n} ways over {axes}")
        x = x.chunk(n, dim=dim)[idx]
    return x


def _assemble(blocks: dict, spec, mesh: Mesh, device):
    """The global tensor from every coordinate's block under ``spec``."""
    shape = mesh.devices.shape
    sharded = {}
    for dim, entry in enumerate(spec):
        if entry is not None:
            sharded[dim] = [mesh.axis_names.index(a) for a in _axes(entry)]

    def build(dims_left, coord):
        if not dims_left:
            return blocks[tuple(coord)].to(device)
        dim, mesh_dims = dims_left[0]
        parts = []
        for idx in _row_major([shape[d] for d in mesh_dims]):
            c = list(coord)
            for d, i in zip(mesh_dims, idx):
                c[d] = i
            parts.append(build(dims_left[1:], c))
        return torch.cat(parts, dim=dim)

    # an axis no dim is sharded over holds copies: take coordinate 0's
    return build(sorted(sharded.items()), [0] * len(shape))


class _Replicated(torch.autograd.Function):
    """Coordinate 0's function counted for all ``n`` coordinates: its
    forward and its backward (an inner graph, differentiated by
    ``autograd.grad``) run under the counter's multiplier ``n``."""

    @staticmethod
    def forward(ctx, n, f, *inputs):
        with torch.enable_grad():
            xs = [t.detach().requires_grad_(t.requires_grad)
                  for t in inputs]
            with op_analysis.times(n):
                outs = f(*xs)
        outs = (outs,) if isinstance(outs, torch.Tensor) else tuple(outs)
        ctx.n, ctx.xs, ctx.outs = n, xs, outs
        ctx.mark_non_differentiable(*[o for o in outs
                                      if not o.requires_grad])
        return tuple(o.detach() for o in outs)

    @staticmethod
    def backward(ctx, *gouts):
        pairs = [(o, g) for o, g in zip(ctx.outs, gouts)
                 if o.requires_grad and g is not None]
        wrt = [x for x in ctx.xs if x.requires_grad]
        got = {}
        if pairs and wrt:
            with op_analysis.times(ctx.n):
                gs = torch.autograd.grad([o for o, _ in pairs], wrt,
                                         [g for _, g in pairs],
                                         allow_unused=True)
            got = {id(x): g for x, g in zip(wrt, gs)}
        return (None, None) + tuple(got.get(id(x)) for x in ctx.xs)


def _run_replicated(f, mesh: Mesh, in_specs, args):
    """A meta mesh under a counter with ``repeat``: the coordinates are
    identical iterations (the same shapes, no values), so coordinate 0
    runs alone, its counts (forward and backward) multiplied by the
    mesh's size; a collective's members are copies of its own value,
    every coordinate's output block a copy of its own.  The FLOPs and
    collective bytes are the full run's; the bytes differ by the copies
    and sums that carry blocks and gradients across the coordinates'
    boundary, which the emulation counts and a mesh would not do."""
    group = _Group(mesh, solo=True)
    coord = group.coords[0]
    _LOCAL.group, _LOCAL.coord, _LOCAL.rank = group, coord, 0
    try:
        local = [_block(a, s, mesh, coord) for a, s in zip(args, in_specs)]
        if torch.is_grad_enabled() and any(t.requires_grad for t in local):
            res = _Replicated.apply(mesh.size, f, *local)
            res = res[0] if len(res) == 1 else res
        else:
            with op_analysis.times(mesh.size):
                res = f(*local)
    finally:
        _LOCAL.group = None
    return {c: res for c in group.coords}


def shard_map(f, *, mesh: Mesh, in_specs, out_specs):
    """``f`` run once a coordinate of ``mesh`` on its blocks of the inputs
    (module docstring).  ``in_specs``: one spec an input; ``out_specs``:
    a ``P`` where ``f`` returns one tensor, else a tuple of specs.  On a
    mesh of meta devices under a counter made with ``repeat=True`` (the
    dry run), coordinate 0 runs alone, counted for every coordinate
    (``_run_replicated``)."""

    def run(*args):
        if len(args) != len(in_specs):
            raise ValueError(f"{len(args)} inputs for {len(in_specs)} specs")
        device = args[0].device
        grad = torch.is_grad_enabled()          # grad mode is per thread
        counter = op_analysis.current()         # dispatch modes too
        if (counter is not None and counter.repeat and mesh.size > 1
                and all(d.type == "meta" for d in mesh.devices.flat)):
            results = _run_replicated(f, mesh, in_specs, args)
            return _outputs(results, out_specs, mesh, device)
        group = _Group(mesh)
        results, errors = {}, []

        def one(rank, coord, pooled):
            _LOCAL.group, _LOCAL.coord, _LOCAL.rank = group, coord, rank
            dev = mesh.device_at(coord)
            try:
                group.start(rank)
                with torch.set_grad_enabled(grad), (
                        counter.in_thread() if counter is not None
                        and pooled else contextlib.nullcontext()):
                    local = [_block(a, s, mesh, coord).to(dev)
                             for a, s in zip(args, in_specs)]
                    if dev.type == "cuda":
                        with torch.cuda.device(dev):
                            results[coord] = f(*local)
                    else:
                        results[coord] = f(*local)
                group.finish(rank)
            except _Aborted:
                pass
            except BaseException as e:          # noqa: BLE001 (re-raised)
                errors.append(e)
                group.abort()
            finally:
                _LOCAL.group = None

        if mesh.size == 1:
            one(0, group.coords[0], False)
        else:
            futures = [_pool(mesh.size).submit(one, r, c, True)
                       for r, c in enumerate(group.coords)]
            for fut in futures:
                fut.result()
        if errors:
            raise errors[0]
        return _outputs(results, out_specs, mesh, device)
    return run


def _outputs(results, out_specs, mesh: Mesh, device):
    single = isinstance(out_specs, P)
    specs = [out_specs] if single else list(out_specs)
    outs = []
    for i, spec in enumerate(specs):
        blocks = {c: (r if single else r[i]) for c, r in results.items()}
        outs.append(_assemble(blocks, spec, mesh, device))
    return outs[0] if single else tuple(outs)
