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
    .../mixer/w_q_down, ..., wo (MLA)                   ...mixer.<same names>
    .../mixer/w_z, ..., out_proj (Mamba-2)              ...mixer.<same names>
    .../ffn/router, w_gate, w_up, w_down (MoE)          ...ffn.<same names>
    .../ffn/shared/wi_gate, wi_up, wo                   ...ffn.shared.<same>
    final_norm/scale (d,)                               final_norm.scale
    mtp/proj, mtp/block/..., mtp/norm/scale (unstacked) mtp.proj, mtp.block...

    encoder-decoder (``EncDec``, whisper):
    embed/tok (V, d); dec_pos (448, d)                  embed.tok; dec_pos
    enc_blocks/{norm1,mixer,norm2,ffn}/... (Le, ...)    enc_blocks.l.<same>
    enc_norm/scale, bias (d,)                           enc_norm.scale, bias
    dec_blocks/{norm1,self,norm_x,cross,norm2,ffn}/...  dec_blocks.l.<same>
      (L, ...); ffn/wi, bi, wo, bo (gelu MLP)
    final_norm/scale, bias (d,)                         final_norm.scale, bias

The leading ``L`` ("layers") dim of a group's (or an encoder or decoder
stack's) leaves is unstacked into its ``L`` blocks (``params_to_numpy``
stacks them again).  The cache keeps that stacked layout in the port too
(``models/transformer.py``, ``models/encdec.py``): ring, MLA and Mamba
caches in any mix, or the encoder-decoder's ``self`` ring with its
``cross_k``/``cross_v``, so ``cache_from_numpy`` and ``cache_to_numpy``
carry it across leaf for leaf.  An AdamW state
(``optim/adamw.py``: ``master``, ``m``, ``v`` keyed by the port's
parameter names) crosses in the same stacked layout
(``opt_state_to_numpy`` / ``opt_state_from_numpy``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.encdec import encdec_cache_specs
from repro_torch.models.model_zoo import build_model
from repro_torch.models.params import map_with_path
from repro_torch.models.transformer import LM, cache_specs
from repro_torch.optim.compress import QTensor


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


_STACKS = ("enc_blocks", "dec_blocks")      # the encoder-decoder's stacks


def _source_of(name: str) -> tuple[tuple, int | None]:
    """Port parameter name -> (path in the reference tree, layer index)."""
    parts = name.split(".")
    if parts[0] == "groups":
        gi, layer, bi = (int(p) for p in parts[1:4])
        return ("groups", gi, "blocks", bi, *parts[4:]), layer
    if parts[0] in _STACKS:
        return (parts[0], *parts[2:]), int(parts[1])
    return tuple(parts), None


def _stack_len(model, path: tuple) -> int:
    """Blocks in the stack a stacked leaf at ``path`` is unstacked into."""
    if path[0] == "groups":
        return len(model.groups[path[1]])
    return len(getattr(model, path[0]))


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
            n_layers = _stack_len(model, path)
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
    """The reference's cache (nested dicts / tuples of numpy arrays: ring,
    MLA and Mamba caches in any mix, or an encoder-decoder's ``self`` ring
    and ``cross_k``/``cross_v``) as the port's cache of tensors on
    ``device`` (``None`` is the card).  :func:`_cache_extents` reads batch
    and width from the tree.  The leaves declared bf16 (K/V, ``c_kv``,
    ``k_rope``) are cast to ``dtype`` (``None``: bf16); ``pos`` stays
    int32 and the Mamba states fp32.  Raises ``ValueError`` on a missing
    or extra leaf and on a shape the config does not give."""
    device = resolve_device(device)
    flat = _flatten(tree)
    batch, width = _cache_extents(flat)
    if cfg.is_encoder_decoder:
        cross = flat.get(("cross_k",))
        specs = encdec_cache_specs(cfg, batch, width, enc_len=(
            width if cross is None or cross.ndim < 3 else cross.shape[2]))
    else:
        specs = cache_specs(cfg, batch, width)
    want = {}
    map_with_path(want.__setitem__, specs)
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
        dt = (dtype or spec.dtype if spec.dtype == torch.bfloat16
              else spec.dtype)
        return torch.tensor(src, dtype=dt, device=device)
    return map_with_path(take, specs)


def _cache_extents(flat: dict) -> tuple[int, int]:
    """(batch, width) of a stacked cache tree: the batch is every leaf's
    dim 1 (after the layers), the width that of a ring ``k`` (the
    encoder-decoder's ``self/k``) or an MLA ``c_kv`` leaf.  A tree of Mamba states alone has no width (its leaves
    do not depend on one): 1 stands in."""
    leaves = [a for a in flat.values() if a.ndim >= 2]
    if not leaves:
        raise ValueError("cache tree has no (L, B, ...) leaf")
    batch = leaves[0].shape[1]
    seq = [a for p, a in flat.items() if p and a.ndim >= 3
           and (p[-1] == "k" and a.ndim == 5 or p[-1] == "c_kv")]
    return batch, seq[0].shape[2] if seq else 1


def cache_to_numpy(cache) -> dict:
    """The port's cache as nested dicts / tuples of numpy arrays: K/V in
    fp32 (numpy has no bfloat16), ``pos`` in int32."""
    def give(_, t):
        if t.is_floating_point():
            t = t.to(torch.float32)
        return t.detach().cpu().numpy()
    return map_with_path(give, cache)


# ------------------------------------------------- port -> reference tree --
def _nest(flat: dict) -> dict:
    """``{path: leaf}`` as the reference's nested tree: str keys make
    dicts, int keys tuples (the ``groups`` and ``blocks`` sequences)."""
    root: dict = {}
    for path, leaf in flat.items():
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf

    def seal(node):
        if not isinstance(node, dict):
            return node
        if node and all(isinstance(k, int) for k in node):
            return tuple(seal(node[i]) for i in range(len(node)))
        return {k: seal(v) for k, v in node.items()}
    return seal(root)


def _to_numpy(t) -> np.ndarray:
    if isinstance(t, QTensor):
        t = t.dequantize()
    t = t.detach()
    if t.is_floating_point():
        t = t.to(torch.float32)
    return t.cpu().numpy()


def stacked_to_numpy(by_name: dict, model: LM) -> dict:
    """Tensors keyed by ``model``'s parameter names (parameters, gradients,
    a state group) as the reference's tree of numpy arrays: each group's
    per-layer leaves stacked on a leading layers dim, floating leaves in
    fp32, ``QTensor`` leaves dequantized."""
    parts: dict[tuple, dict[int, np.ndarray]] = {}
    flat: dict[tuple, np.ndarray] = {}
    for name, _ in model.named_parameters():
        path, layer = _source_of(name)
        arr = _to_numpy(by_name[name])
        if layer is None:
            flat[path] = arr
        else:
            parts.setdefault(path, {})[layer] = arr
    for path, layers in parts.items():
        flat[path] = np.stack([layers[i] for i in range(len(layers))])
    return _nest(flat)


def params_to_numpy(model: LM) -> dict:
    """The port's parameters as the reference's tree of numpy arrays (fp32
    for floating dtypes: numpy has no bfloat16), each group's layers
    stacked again: the inverse of :func:`params_from_numpy`."""
    return stacked_to_numpy(dict(model.named_parameters()), model)


def opt_state_to_numpy(state: dict, model: LM) -> dict:
    """An AdamW state of the port as the reference's: ``step`` an int32
    array, ``master``/``m``/``v`` stacked trees in fp32.  int8 moments
    cross as their dequantized values: the reference quantizes each
    stacked leaf in blocks that run across layers, so its codes are not
    the port's."""
    return {"step": np.asarray(state["step"].cpu().numpy(), np.int32),
            **{g: None if state[g] is None
               else stacked_to_numpy(state[g], model)
               for g in ("master", "m", "v")}}


def opt_state_from_numpy(tree: dict, model: LM,
                         moments_dtype: str = "float32",
                         device=None) -> dict:
    """The reference's AdamW state (numpy leaves: ``step``, ``master``,
    ``m``, ``v``) as the port's, keyed by ``model``'s parameter names, on
    ``device`` (``None`` is the card): master fp32, moments in
    ``moments_dtype`` (int8 moments are quantized a port leaf at a
    time)."""
    device = resolve_device(device)

    def unstack(group, kind):
        flat = _flatten(group)
        out = {}
        for name, _ in model.named_parameters():
            path, layer = _source_of(name)
            arr = flat[path] if layer is None else flat[path][layer]
            t = torch.tensor(arr, dtype=torch.float32, device=device)
            if kind == "int8":
                t = QTensor.quantize(t)
            elif kind == "bfloat16":
                t = t.to(torch.bfloat16)
            out[name] = t
        return out

    return {"step": torch.tensor(int(np.asarray(tree["step"])),
                                 dtype=torch.int32, device=device),
            "master": (None if tree.get("master") is None
                       else unstack(tree["master"], "float32")),
            "m": unstack(tree["m"], moments_dtype),
            "v": unstack(tree["v"], moments_dtype)}
