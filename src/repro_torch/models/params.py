"""Parameter-spec mini-framework.

Each module declares its parameters once as a dict of :class:`ParamSpec`
(shape + dtype + *logical axes* + initializer), exactly as the reference
does.  From that declaration the port derives

  * ``register_params(module, specs, ...)`` -> ``nn.Parameter``s on a module
  * ``init_tensor_(tensor, spec, generator)`` -> seeded random init
  * ``stack_specs(specs, repeat)`` -> the reference's stacked-layer shapes,
    which ``models/convert.py`` checks a parameter tree against
  * ``abstract(specs)`` -> a tree of meta tensors (the dry run: shapes and
    dtypes, no allocation; the reference's ``ShapeDtypeStruct`` tree)

Logical axes are what ``sharding/rules.py`` maps onto a mesh's axes
(``spec_for``, ``partition_tree``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
from torch import nn

Initializer = str  # "normal" | "zeros" | "ones" | "embed"


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    dtype: torch.dtype = torch.bfloat16
    # one logical-axis name (or None) per dim, e.g. ("layers", "embed", "heads")
    axes: tuple[str | None, ...] = ()
    init: Initializer = "normal"
    # fan-in dim index/indices for scaled init (default: second-to-last)
    fan_in_dim: int | tuple | None = None

    def __post_init__(self):
        if self.axes and len(self.axes) != len(self.shape):
            raise ValueError(
                f"axes {self.axes} rank != shape {self.shape} rank")


def _is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def tree_map_specs(fn: Callable[[ParamSpec], Any], specs):
    """Map over the ParamSpec leaves of nested dicts / tuples."""
    if _is_spec(specs):
        return fn(specs)
    if isinstance(specs, dict):
        return {k: tree_map_specs(fn, v) for k, v in specs.items()}
    if isinstance(specs, (tuple, list)):
        return type(specs)(tree_map_specs(fn, v) for v in specs)
    raise TypeError(f"not a spec tree: {type(specs).__name__}")


def map_with_path(fn: Callable[[tuple, Any], Any], tree, prefix=()):
    """Map ``fn(path, leaf)`` over the leaves of nested dicts / tuples; a
    path is the tuple of keys and indices down to the leaf."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, prefix + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(map_with_path(fn, v, prefix + (i,))
                     for i, v in enumerate(tree))
    return fn(prefix, tree)


def tree_leaves(specs) -> list[ParamSpec]:
    out: list[ParamSpec] = []
    tree_map_specs(out.append, specs)
    return out


def abstract(specs):
    """A tree of meta tensors with the specs' shapes and dtypes: the dry
    run's arguments (``launch/dryrun.py``), which allocate nothing."""
    return tree_map_specs(
        lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"), specs)


def _fan_in(spec: ParamSpec) -> int:
    fan_dim = spec.fan_in_dim
    if fan_dim is None:
        fan_dim = max(0, len(spec.shape) - 2)
    if isinstance(fan_dim, int):
        fan_dim = (fan_dim,)
    return math.prod(spec.shape[d] for d in fan_dim) if spec.shape else 1


@torch.no_grad()
def init_tensor_(t: torch.Tensor, spec: ParamSpec,
                 generator: torch.Generator | None) -> torch.Tensor:
    """Fill ``t`` in place by the spec's rule: zeros / ones / embed
    (normal, std 0.02) / truncated normal in [-2, 2] scaled by
    1/sqrt(fan_in).  Random draws are made in fp32 on ``t``'s device from
    ``generator`` and then cast, as the reference casts after drawing."""
    if spec.init == "zeros":
        return t.zero_()
    if spec.init == "ones":
        return t.fill_(1.0)
    draw = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    if spec.init == "embed":
        draw.normal_(0.0, 1.0, generator=generator).mul_(0.02)
    else:
        std = 1.0 / math.sqrt(max(1, _fan_in(spec)))
        nn.init.trunc_normal_(draw, 0.0, 1.0, -2.0, 2.0, generator=generator)
        draw.mul_(std)
    return t.copy_(draw)


def register_params(module: nn.Module, specs: dict[str, ParamSpec], *,
                    device: torch.device, dtype: torch.dtype | None) -> None:
    """Create one uninitialised ``nn.Parameter`` per spec on ``module``.

    ``dtype=None`` keeps each spec's own dtype (bf16 weights, fp32 norm
    scales and biases); a dtype casts every parameter to it, as the
    reference's CPU tests cast the whole tree to fp32.
    """
    for name, spec in specs.items():
        t = torch.empty(spec.shape, dtype=dtype or spec.dtype, device=device)
        module.register_parameter(name, nn.Parameter(t, requires_grad=False))


def init_params_(module: nn.Module, specs: dict[str, ParamSpec],
                 generator: torch.Generator | None) -> None:
    for name, spec in specs.items():
        init_tensor_(getattr(module, name), spec, generator)


def stack_specs(specs, repeat: int):
    """Prefix every leaf with a ("layers", repeat) dim: the shapes of the
    reference's stacked parameter tree."""
    def one(s: ParamSpec):
        axes = s.axes if s.axes else (None,) * len(s.shape)
        fan = s.fan_in_dim
        if fan is None and len(s.shape) >= 2 and s.init == "normal":
            fan = max(0, len(s.shape) - 2)  # preserve pre-stack fan-in dim
        if fan is not None:
            fan = tuple(f + 1 for f in ((fan,) if isinstance(fan, int)
                                        else fan))
        return ParamSpec((repeat,) + s.shape, s.dtype, ("layers",) + axes,
                         s.init, fan)
    return tree_map_specs(one, specs)


def param_count(specs) -> int:
    return sum(int(math.prod(s.shape)) for s in tree_leaves(specs))


def param_bytes(specs) -> int:
    return sum(int(math.prod(s.shape)) * s.dtype.itemsize
               for s in tree_leaves(specs))
