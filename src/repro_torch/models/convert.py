"""Load the reference package's parameter tree into the port's ``LM``.

The tree arrives as nested dicts / tuples of **numpy** arrays (the caller
converts; this module imports no other framework).  Weight layouts are the
reference's own, so nothing is transposed:

    reference leaf                                      port parameter
    --------------------------------------------------  ---------------------------
    embed/tok (V, d) [, embed/lm_head (d, V)]           embed.tok [, embed.lm_head]
    groups[g]/blocks[b]/norm1/scale (L, d)              groups.g.l.b.norm1.scale
    groups[g]/blocks[b]/mixer/wq (L, d, h, hd)          groups.g.l.b.mixer.wq
    .../mixer/wk, wv (L, d, hkv, hd); wo (L, h, hd, d)  ...mixer.wk, wv, wo
    .../mixer/bq (L, h, hd); bk, bv (L, hkv, hd)        ...mixer.bq, bk, bv
    .../ffn/wi_gate, wi_up (L, d, ff); wo (L, ff, d)    ...ffn.wi_gate, wi_up, wo
    final_norm/scale (d,)                               final_norm.scale

The leading ``L`` ("layers") dim of a group's stacked leaves is unstacked
into that group's ``L`` blocks.  The ring cache keeps that stacked layout
in the port too (``models/transformer.py``), so ``cache_from_numpy`` and
``cache_to_numpy`` carry it across leaf for leaf.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.model_zoo import build_model
from repro_torch.models.params import map_with_path
from repro_torch.models.transformer import LM, cache_specs


def _flatten(tree, prefix=()) -> dict[tuple, np.ndarray]:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out: dict[tuple, np.ndarray] = {}
    for k, v in items:
        out.update(_flatten(v, prefix + (k,)))
    return out


def _source_of(name: str) -> tuple[tuple, int | None]:
    """Port parameter name -> (path in the reference tree, layer index)."""
    parts = name.split(".")
    if parts[0] == "groups":
        gi, layer, bi = (int(p) for p in parts[1:4])
        return ("groups", gi, "blocks", bi, *parts[4:]), layer
    return tuple(parts), None


@torch.no_grad()
def params_from_numpy(tree, cfg: ArchConfig, *, device=None,
                      dtype: torch.dtype | None = torch.float32) -> LM:
    """Build the port's ``LM`` for ``cfg`` on ``device`` holding ``tree``'s
    values.  numpy has no bfloat16, so a tree arrives in fp32 and the
    default keeps every parameter in fp32; ``dtype=None`` casts each to
    its declared dtype (bf16 weights, fp32 norm scales and biases).
    Raises ``ValueError`` on a leaf the model does not consume, on a model
    parameter the tree does not set, and on a shape mismatch."""
    model = build_model(cfg, device=device, dtype=dtype)
    flat = _flatten(tree)
    used: set[tuple] = set()
    for name, param in model.named_parameters():
        path, layer = _source_of(name)
        if path not in flat:
            raise ValueError(f"parameter {name} is not set: the tree has no "
                             f"leaf {'/'.join(map(str, path))}")
        src = flat[path]
        if layer is not None:
            n_layers = len(model.groups[path[1]])
            if src.shape[0] != n_layers:
                raise ValueError(f"{'/'.join(map(str, path))}: {src.shape[0]} "
                                 f"stacked layers, model has {n_layers}")
            src = src[layer]
        if tuple(src.shape) != tuple(param.shape):
            raise ValueError(f"{name}: tree gives shape {tuple(src.shape)}, "
                             f"model wants {tuple(param.shape)}")
        param.copy_(torch.tensor(src))
        used.add(path)
    extra = sorted("/".join(map(str, p)) for p in set(flat) - used)
    if extra:
        raise ValueError(f"tree leaves not consumed by the model: {extra}")
    return model


def _path_str(path) -> str:
    return "/".join(map(str, path))


@torch.no_grad()
def cache_from_numpy(tree, cfg: ArchConfig, *, device=None,
                     dtype: torch.dtype | None = torch.float32) -> dict:
    """The reference's ring cache (nested dicts / tuples of numpy arrays)
    as the port's cache of tensors on ``device`` (``None`` is the card).
    Batch and width are read from the tree's first ``k`` leaf.  K/V are
    cast to ``dtype`` (``None``: their declared bf16); ``pos`` stays
    int32.  Raises ``ValueError`` on a missing or extra leaf and on a
    shape the config does not give."""
    device = resolve_device(device)
    flat = _flatten(tree)
    ks = [a for p, a in flat.items() if p and p[-1] == "k" and a.ndim == 5]
    if not ks:
        raise ValueError("cache tree has no (L,B,W,Hkv,D) 'k' leaf")
    batch, width = ks[0].shape[1:3]
    want = {}
    map_with_path(want.__setitem__, cache_specs(cfg, batch, width))
    missing = sorted(_path_str(p) for p in set(want) - set(flat))
    extra = sorted(_path_str(p) for p in set(flat) - set(want))
    if missing or extra:
        raise ValueError(f"cache tree: missing leaves {missing}, leaves the "
                         f"model does not hold {extra}")

    def take(path, spec):
        src = flat[path]
        if tuple(src.shape) != tuple(spec.shape):
            raise ValueError(f"{_path_str(path)}: tree gives shape "
                             f"{tuple(src.shape)}, model wants "
                             f"{tuple(spec.shape)}")
        dt = spec.dtype if path[-1] == "pos" else dtype or spec.dtype
        return torch.tensor(src, dtype=dt, device=device)
    return map_with_path(take, cache_specs(cfg, batch, width))


def cache_to_numpy(cache) -> dict:
    """The port's cache as nested dicts / tuples of numpy arrays: K/V in
    fp32 (numpy has no bfloat16), ``pos`` in int32."""
    def give(_, t):
        if t.is_floating_point():
            t = t.to(torch.float32)
        return t.detach().cpu().numpy()
    return map_with_path(give, cache)
