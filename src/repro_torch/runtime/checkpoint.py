"""Checkpointing: one ``.npy`` file a leaf and a manifest with a CRC-32 a
leaf, atomic commit, async save, and restore onto any device (leaves are
stored whole, so a checkpoint written from the card restores on the CPU
and back).  The reference's on-disk layout:

  <dir>/step_000123.tmp-*/...   (staging)
  <dir>/step_000123/leaf_0000.npy ... manifest.json   (committed by rename)

A tree is nested dicts / lists / tuples of tensors (or numpy arrays, or
numbers); a ``QTensor`` (int8 moments) is two leaves, its codes and its
scales, as in the reference.  bfloat16, which numpy cannot hold, is
stored widened to float32 and cast back on restore.

A placed leaf (``sharding/spmd.py::Placed``, a tensor held as blocks on
a mesh's devices) is written whole, in the same files and format, so a
checkpoint does not depend on the mesh: ``restore(..., shardings=)``
places each leaf on a target mesh (the elastic re-mesh, fed by
``fault.elastic_mesh``).
"""
from __future__ import annotations

import concurrent.futures as futures
import json
import os
import shutil
import zlib

import numpy as np
import torch

from repro_torch.optim.compress import QTensor
from repro_torch.sharding import spmd

_EXEC: futures.ThreadPoolExecutor | None = None


def _executor() -> futures.ThreadPoolExecutor:
    global _EXEC
    if _EXEC is None:
        _EXEC = futures.ThreadPoolExecutor(max_workers=1)
    return _EXEC


def _leaves(tree) -> list:
    """Leaves in order: dict values in insertion order, a ``QTensor`` as
    (codes, scales)."""
    if isinstance(tree, QTensor):
        return [tree.data, tree.scale]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _treedef(tree) -> str:
    if isinstance(tree, QTensor):
        return f"Q{list(tree.shape)}"
    if isinstance(tree, dict):
        return "{" + ",".join(f"{k!r}:{_treedef(v)}"
                              for k, v in tree.items()) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ",".join(_treedef(v) for v in tree)
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    return "*"


def _unflatten(like, it):
    if isinstance(like, QTensor):
        return QTensor(next(it), next(it), like.shape)
    if isinstance(like, dict):
        return {k: _unflatten(v, it) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, it) for v in like)
    return next(it)


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


def _to_storable(x) -> tuple[np.ndarray, str]:
    """A leaf as a host numpy array numpy can save, and its logical dtype
    (bfloat16 widened to float32, losslessly)."""
    if isinstance(x, spmd.Placed):
        x = spmd.gather(x, "cpu")
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.to(torch.float32).numpy(), "bfloat16"
        arr = t.numpy()
        return arr, arr.dtype.name
    arr = np.asarray(x)
    return arr, arr.dtype.name


def save(ckpt_dir: str, step: int, tree, *, blocking: bool = True):
    """Write a checkpoint; returns its path, or a future of it if
    ``blocking=False`` (the leaves are copied to the host before this
    returns, so the caller may update them at once)."""
    host = [_to_storable(x) for x in _leaves(tree)]     # off the device
    treedef = _treedef(tree)

    def _write():
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        tmp = final + f".tmp-{os.getpid()}"
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "treedef": treedef, "leaves": []}
        for i, (arr, logical) in enumerate(host):
            np.save(os.path.join(tmp, f"leaf_{i:04d}.npy"), arr)
            manifest["leaves"].append({
                "i": i, "shape": list(arr.shape), "dtype": str(arr.dtype),
                "logical_dtype": logical, "crc32": _crc(arr)})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        return final

    if blocking:
        return _write()
    return _executor().submit(_write)


def available_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and ".tmp" not in d and \
                os.path.exists(os.path.join(ckpt_dir, d, "manifest.json")):
            out.append(int(d.split("_")[1]))
    return sorted(out)


def latest_step(ckpt_dir: str) -> int | None:
    steps = available_steps(ckpt_dir)
    return steps[-1] if steps else None


def _place(arr: np.ndarray, logical: str, like, device):
    """A loaded leaf as ``like`` holds it: a tensor on ``device`` (or where
    ``like`` lies, pinned if it is pinned) in its logical dtype, or a
    numpy array / number where ``like`` is one."""
    t = torch.from_numpy(arr)
    if logical == "bfloat16":
        t = t.to(torch.bfloat16)
    if not isinstance(like, torch.Tensor) and device is None:
        return arr
    if device is not None:
        return t.to(device)
    if like.device.type == "cpu" and like.is_pinned():
        return t.pin_memory()
    return t.to(like.device)


def restore(ckpt_dir: str, step: int, like, device=None, *,
            shardings=None, verify: bool = True):
    """Restore into the structure of ``like``; each leaf on ``device``, or,
    with ``device=None``, where ``like``'s leaf lies (pinned pool-tier
    buffers stay pinned; a placed leaf of ``like`` is placed as it is).
    ``shardings``, a tree of ``like``'s
    structure with a ``NamedSharding`` a leaf (None where ``like`` holds
    None), places each leaf on its mesh instead (the reference's
    ``restore(..., shardings=)``).  A leaf whose CRC-32 differs from the
    manifest's raises ``IOError`` (``verify=False`` skips the check)."""
    if shardings is not None and device is not None:
        raise ValueError("restore: give device= or shardings=, not both")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    like_leaves = _leaves(like)
    if len(manifest["leaves"]) != len(like_leaves):
        raise ValueError(
            f"checkpoint has {len(manifest['leaves'])} leaves; target "
            f"structure expects {len(like_leaves)}")
    sh_leaves = (_leaves(shardings) if shardings is not None
                 else [None] * len(like_leaves))
    if len(sh_leaves) != len(like_leaves):
        raise ValueError(f"shardings have {len(sh_leaves)} leaves; target "
                         f"structure has {len(like_leaves)}")
    out = []
    for meta, lk, sh in zip(manifest["leaves"], like_leaves, sh_leaves):
        arr = np.load(os.path.join(path, f"leaf_{meta['i']:04d}.npy"))
        if verify and _crc(arr) != meta["crc32"]:
            raise IOError(f"crc mismatch on leaf {meta['i']} in {path}")
        logical = meta.get("logical_dtype", str(arr.dtype))
        if sh is None and isinstance(lk, spmd.Placed):
            sh = lk.sharding
        if sh is not None:
            out.append(spmd.place(_place(arr, logical, lk, "cpu"), sh))
        else:
            out.append(_place(arr, logical, lk, device))
    return _unflatten(like, iter(out))


def corrupt_leaf(ckpt_dir: str, step: int, leaf_idx: int = 0):
    """Flip bytes in one leaf (failure injection for tests)."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}",
                        f"leaf_{leaf_idx:04d}.npy")
    with open(path, "r+b") as f:
        f.seek(-8, os.SEEK_END)
        f.write(b"\xde\xad\xbe\xef\xde\xad\xbe\xef")
