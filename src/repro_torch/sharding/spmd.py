"""Placement of tensors on a mesh's devices, and the collectives of the
sharded steps: the port's stand-in for XLA's SPMD partitioner (as
``launch/op_analysis.py`` stands for the reference's ``hlo_analysis.py``;
the reference has no such module, since ``jax.jit(in_shardings=...)``
does this work).

A :class:`Placed` tensor is a global tensor held as one block a mesh
coordinate, each on that coordinate's device: coordinate ``c``'s block is
the slice ``rules._block`` cuts from the global tensor under the leaf's
``NamedSharding`` (the slice JAX's ``devices_indices_map`` gives the
device at ``c``); a dimension the spec leaves out is whole in every
block, so blocks along an axis the spec does not name are replicas.
:func:`place` cuts a tensor into its blocks (every block its own copy,
also where coordinates share a device), :func:`gather` puts them back
together.  A block on another device than its coordinate's raises:
nothing is moved silently.

The sharded steps (``runtime/train.py::jit_train_step``,
``runtime/serve.py::jit_decode_step``) run on one host thread.  Between
collectives each coordinate's work is a loop over the mesh's coordinates
on lists of blocks (a *rank list*, indexed like ``Mesh.coords()``); the
collectives below are plain differentiable PyTorch ops across devices
(copies with ``Tensor.to`` and sums), so one autograd graph spans every
card: the backward of :func:`all_gather` is the reduce-scatter, that of
:func:`psum` the sum of the copies' gradients (:func:`pmax` and
:func:`all_to_all` besides, and :func:`reshard` from one placement of a
tensor's blocks to another).  A sum runs over a group's
members in row-major order (``rules.shard_map``'s order), once for each
member on its own device, so every member holds the same bits and each
coordinate does its own work wherever the mesh puts it.  Unlike
``rules.shard_map`` no thread a coordinate is involved, so a collective
reached from ``backward()`` (which autograd runs on a worker thread a
device) is an op like any other.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from repro_torch.launch.mesh import Mesh
from repro_torch.sharding import rules
from repro_torch.sharding.rules import P, NamedSharding


def _axes(entry) -> tuple[str, ...]:
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_axes(spec) -> set[str]:
    """The mesh axes a partition spec names."""
    return {a for e in spec if e is not None for a in _axes(e)}


def _norm_device(dev) -> torch.device:
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def coordinate_device(mesh: Mesh, coord) -> torch.device:
    """The device a block of coordinate ``coord`` lies on: the mesh's
    entry, a bare ``cuda`` read as the current card."""
    return _norm_device(mesh.device_at(coord))


def block_shape(shape, spec, mesh: Mesh) -> tuple[int, ...]:
    """The shape of one coordinate's block of a ``shape`` tensor under
    ``spec`` (every block has it: a split is even or raises)."""
    out = list(shape)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        n = math.prod(mesh.shape[a] for a in _axes(entry))
        if out[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(shape)} does not "
                             f"split {n} ways over {_axes(entry)}")
        out[dim] //= n
    return tuple(out)


class Placed:
    """A global tensor of ``shape`` held as one block a coordinate of
    ``sharding.mesh`` (``blocks[i]`` is coordinate ``mesh.coords()[i]``'s,
    on that coordinate's device, shaped ``block_shape``)."""

    __slots__ = ("blocks", "sharding", "shape")

    def __init__(self, blocks, sharding: NamedSharding, shape=None):
        mesh, spec = sharding.mesh, sharding.spec
        blocks = list(blocks)
        coords = mesh.coords()
        if len(blocks) != len(coords):
            raise ValueError(f"{len(blocks)} blocks for a mesh of "
                             f"{len(coords)} coordinates")
        if shape is None:                       # from the blocks
            shape = list(blocks[0].shape)
            for dim, entry in enumerate(spec):
                if entry is not None:
                    shape[dim] *= math.prod(mesh.shape[a]
                                            for a in _axes(entry))
        self.shape = tuple(shape)
        want = block_shape(self.shape, spec, mesh)
        for c, b in zip(coords, blocks):
            dev = coordinate_device(mesh, c)
            if b.device != dev:
                raise ValueError(f"the block of coordinate {c} lies on "
                                 f"{b.device}, not on {dev}")
            if tuple(b.shape) != want:
                raise ValueError(f"the block of coordinate {c} has shape "
                                 f"{tuple(b.shape)}; {spec} on "
                                 f"{mesh.shape} wants {want}")
        self.blocks = blocks
        self.sharding = sharding

    @property
    def mesh(self) -> Mesh:
        return self.sharding.mesh

    @property
    def spec(self) -> P:
        return self.sharding.spec

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].dtype

    def numel(self) -> int:
        """The global tensor's element count."""
        return math.prod(self.shape)

    def distinct(self) -> list[int]:
        """The ranks holding each distinct block once: those at index 0 on
        every axis the spec does not name."""
        return distinct_ranks(self.mesh, self.spec)

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "Placed":
        """``fn`` of every block, placed by the same sharding (``fn`` keeps
        the block's device)."""
        return Placed([fn(b) for b in self.blocks], self.sharding)

    def __repr__(self) -> str:
        return (f"Placed(shape={self.shape}, dtype={self.dtype}, "
                f"spec={self.spec}, mesh={self.mesh.shape})")


def distinct_ranks(mesh: Mesh, spec) -> list[int]:
    named = spec_axes(spec)
    rep = [i for i, a in enumerate(mesh.axis_names) if a not in named]
    return [r for r, c in enumerate(mesh.coords())
            if all(c[i] == 0 for i in rep)]


def home_ranks(mesh: Mesh, spec) -> list[int]:
    """Each rank's holder of its block among :func:`distinct_ranks`: the
    rank at index 0 of every axis ``spec`` does not name (itself where it
    holds a distinct block)."""
    named = spec_axes(spec)
    rank = {c: r for r, c in enumerate(mesh.coords())}
    return [rank[tuple(i if a in named else 0
                       for a, i in zip(mesh.axis_names, c))]
            for c in mesh.coords()]


def _copy_to(t: torch.Tensor, dev) -> torch.Tensor:
    """A contiguous copy of ``t`` on ``dev``, never a view of ``t``."""
    out = torch.empty(t.shape, dtype=t.dtype, device=dev)
    out.copy_(t)
    return out


@torch.no_grad()
def place(x: torch.Tensor, sharding: NamedSharding) -> Placed:
    """``x`` cut into its blocks under ``sharding``, each copied onto its
    coordinate's device."""
    mesh, spec = sharding.mesh, sharding.spec
    x = x.detach()
    return Placed([_copy_to(rules._block(x, spec, mesh, c),
                            coordinate_device(mesh, c))
                   for c in mesh.coords()], sharding, tuple(x.shape))


def empty(shape, dtype, sharding: NamedSharding, fill=None) -> Placed:
    """A placed tensor made block by block on the coordinates' devices
    (``fill``: a value, else zeros): no global copy is ever made."""
    mesh = sharding.mesh
    bshape = block_shape(shape, sharding.spec, mesh)
    blocks = [torch.full(bshape, 0 if fill is None else fill, dtype=dtype,
                         device=coordinate_device(mesh, c))
              for c in mesh.coords()]
    return Placed(blocks, sharding, tuple(shape))


@torch.no_grad()
def gather(p: Placed, device=None) -> torch.Tensor:
    """The whole tensor of ``p`` on ``device`` (default: coordinate 0's
    device), never one of its blocks itself; replicas along an axis the
    spec does not name are read from index 0 of that axis."""
    device = p.blocks[0].device if device is None else torch.device(device)
    out = rules._assemble(dict(zip(p.mesh.coords(), p.blocks)), p.spec,
                          p.mesh, device)
    if any(out is b for b in p.blocks):
        out = out.clone()
    return out.detach()


# ------------------------------------------------------------ trees ------
def map_tree(fn, tree, *rest):
    """``fn(leaf, *rest_leaves)`` over nested dicts / tuples / lists whose
    leaves are tensors, ``Placed``s, ``NamedSharding``s or None."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_tree(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def place_tree(tree, shardings):
    """Every tensor leaf of ``tree`` placed by the ``NamedSharding`` at the
    same position of ``shardings`` (None stays None)."""
    return map_tree(lambda x, s: None if x is None else place(x, s), tree,
                    shardings)


def gather_tree(tree, device=None):
    """Every ``Placed`` leaf of ``tree`` gathered whole on ``device``."""
    return map_tree(lambda x: gather(x, device) if isinstance(x, Placed)
                    else x, tree)


def check(p, sharding: NamedSharding, what: str = "leaf") -> Placed:
    """``p`` if it is placed by ``sharding``; else raises (the sharded
    steps move nothing into place themselves)."""
    if not isinstance(p, Placed):
        raise TypeError(f"{what}: expected a Placed tensor on the mesh, got "
                        f"{type(p).__name__} (place it with "
                        "sharding.spmd.place)")
    if p.mesh is not sharding.mesh or tuple(p.spec) != tuple(sharding.spec):
        raise ValueError(f"{what}: placed as {p.spec} on {p.mesh.shape}; "
                         f"the step wants {sharding.spec} on "
                         f"{sharding.mesh.shape}")
    return p


def named_shardings(model, stacked) -> dict[str, NamedSharding]:
    """The ``NamedSharding`` of each of ``model``'s parameters, by name,
    from a tree in the reference's stacked layout (``step_shardings``,
    ``serve_shardings``): a group's leaf loses its leading "layers" entry
    (the rules never shard it)."""
    from repro_torch.models.convert import _source_of
    out = {}
    for name, _ in model.named_parameters():
        path, layer = _source_of(name)
        node = stacked
        for k in path:
            node = node[k]
        spec = node.spec
        if layer is not None:
            if spec and spec[0] is not None:
                raise ValueError(f"{name}: the layers dim is sharded "
                                 f"({spec})")
            spec = P(*spec[1:])
        out[name] = NamedSharding(node.mesh, spec)
    return out


# ------------------------------------------------------------ collectives
def groups(mesh: Mesh, axes) -> list[list[int]]:
    """The ranks of ``mesh`` in groups that differ only on ``axes``, each
    group's members row-major over ``axes`` in the order given."""
    axes = _axes(axes)
    dims = [mesh.axis_names.index(a) for a in axes]
    rank_of = {c: i for i, c in enumerate(mesh.coords())}
    shape = mesh.devices.shape
    out, seen = [], set()
    for c in mesh.coords():
        if rank_of[c] in seen:
            continue
        members = []
        for idx in rules._row_major([shape[d] for d in dims]):
            m = list(c)
            for d, i in zip(dims, idx):
                m[d] = i
            members.append(rank_of[tuple(m)])
        seen.update(members)
        out.append(members)
    return out


def psum(xs: list, mesh: Mesh, axes) -> list:
    """Each rank's sum of its group's blocks over ``axes``, in member
    order, on its own device."""
    out = [None] * len(xs)
    for members in groups(mesh, axes):
        for r in members:
            dev = xs[r].device
            s = xs[members[0]].to(dev)
            for m in members[1:]:
                s = s + xs[m].to(dev)
            out[r] = s
    return out


def pmax(xs: list, mesh: Mesh, axes) -> list:
    """Each rank's elementwise maximum of its group's blocks over
    ``axes``, in member order, on its own device (JAX's ``pmax``)."""
    out = [None] * len(xs)
    for members in groups(mesh, axes):
        for r in members:
            dev = xs[r].device
            s = xs[members[0]].to(dev)
            for m in members[1:]:
                s = torch.maximum(s, xs[m].to(dev))
            out[r] = s
    return out


def all_to_all(xs: list, mesh: Mesh, axes, split_axis: int,
               concat_axis: int) -> list:
    """Member j's entry ``i`` of ``split_axis`` (one entry a member)
    arrives as member i's entry j of a new ``concat_axis`` (JAX's
    ``all_to_all(..., tiled=False)``)."""
    out = [None] * len(xs)
    for members in groups(mesh, axes):
        n = len(members)
        for m in members:
            if xs[m].shape[split_axis] != n:
                raise ValueError(f"all_to_all: split axis of "
                                 f"{xs[m].shape[split_axis]} for {n} members")
        for i, r in enumerate(members):
            dev = xs[r].device
            out[r] = torch.stack([xs[m].select(split_axis, i).to(dev)
                                  for m in members], dim=concat_axis)
    return out


def reshard(xs: list, mesh: Mesh, src, dst) -> list:
    """Blocks of one global tensor placed by ``src`` as the blocks ``dst``
    places: every dimension whose entry differs is gathered over its
    ``src`` axes first, then cut by its ``dst`` axes (differentiable; a
    dimension both specs split alike is left as it is)."""
    ndim = xs[0].dim()
    src = tuple(src) + (None,) * (ndim - len(src))
    dst = tuple(dst) + (None,) * (ndim - len(dst))
    moved = [d for d in range(ndim) if src[d] != dst[d]]
    for d in moved:
        if src[d] is not None:
            xs = all_gather(xs, mesh, src[d], d)
    for d in moved:
        if dst[d] is not None:
            idx = axis_index(mesh, dst[d])
            n = math.prod(mesh.shape[a] for a in _axes(dst[d]))
            xs = [x.chunk(n, d)[idx[r]] for r, x in enumerate(xs)]
    return xs


def all_gather(xs: list, mesh: Mesh, axes, dim: int) -> list:
    """Each rank's group's blocks concatenated on ``dim`` in member order
    (JAX's ``all_gather(..., tiled=True)``)."""
    out = [None] * len(xs)
    for members in groups(mesh, axes):
        for r in members:
            dev = xs[r].device
            out[r] = torch.cat([xs[m].to(dev) for m in members], dim=dim)
    return out


def psum_scatter(xs: list, mesh: Mesh, axes, dim: int) -> list:
    """The group's sum over ``axes``, of which each member keeps its slice
    of ``dim`` (JAX's ``psum_scatter(..., tiled=True)``)."""
    out = [None] * len(xs)
    for members in groups(mesh, axes):
        n = len(members)
        for i, r in enumerate(members):
            dev = xs[r].device
            s = xs[members[0]].chunk(n, dim)[i].to(dev)
            for m in members[1:]:
                s = s + xs[m].chunk(n, dim)[i].to(dev)
            out[r] = s
    return out


def axis_index(mesh: Mesh, axes) -> list[int]:
    """Each rank's index along ``axes`` (row-major over a tuple)."""
    axes = _axes(axes)
    dims = [mesh.axis_names.index(a) for a in axes]
    out = []
    for c in mesh.coords():
        i = 0
        for d in dims:
            i = i * mesh.devices.shape[d] + c[d]
        out.append(i)
    return out


def unshard(p: Placed, keep=()) -> list:
    """``p``'s blocks gathered on every dimension sharded over axes outside
    ``keep`` (the FSDP gather before a weight is used; its backward
    reduce-scatters the gradient)."""
    xs = list(p.blocks)
    for dim, entry in enumerate(p.spec):
        if entry is None:
            continue
        ax = _axes(entry)
        inside = [a for a in ax if a in keep]
        if not inside:
            xs = all_gather(xs, p.mesh, ax, dim)
        elif len(inside) != len(ax):
            raise NotImplementedError(
                f"dimension {dim} sharded over {ax}: a kept axis mixed with "
                "gathered ones")
    return xs


def whole(p: Placed, rank: int) -> torch.Tensor:
    """``p``'s global tensor on rank ``rank``'s device, differentiably (the
    gradient reaches the blocks read: those at index 0 of each axis the
    spec does not name, whose replicas :func:`sum_replicas` then sums)."""
    return rules._assemble(dict(zip(p.mesh.coords(), p.blocks)), p.spec,
                           p.mesh, p.blocks[rank].device)


def sharded_over(p: Placed, axis: str) -> int | None:
    """The dimension of ``p`` sharded over ``axis``, or None."""
    for dim, entry in enumerate(p.spec):
        if entry is not None and axis in _axes(entry):
            return dim
    return None


@torch.no_grad()
def sum_replicas(xs: list, mesh: Mesh, spec) -> list:
    """Blocks (a leaf's gradient) summed over every mesh axis ``spec`` does
    not name: the replicas' partial gradients made the whole one, the same
    bits on every replica."""
    rep = [a for a in mesh.axis_names if a not in spec_axes(spec)]
    return psum(xs, mesh, tuple(rep)) if rep else list(xs)
