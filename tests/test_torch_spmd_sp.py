"""The sequence-sharded cache (SP, ``ShardCtx.seq_shard_kv``) of the
placed serve steps (``runtime/serve.py::init_cache``,
``jit_prefill_step``, ``jit_decode_step`` over
``models/attention.py::attn_seq_sharded``) held against the reference's
partitioned steps and the port's unsharded ones.

The reference's steps run once for the module in a subprocess under
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` (as
``tests/test_torch_spmd.py`` does), jitted with the serve shardings and
the tokens placed by ``launch/dryrun.py::batch_pspec``'s rule, on the
same numpy tokens and the same seeded fp32 weights; XLA's partitioner
merges the decode's softmax over the cache's slots there, the port's
``attn_seq_sharded`` by its own max/sum merge.

Tolerances, fp32: logits and cache K/V rtol/atol 2e-5 (sums over the
slots' blocks and the model axis in another order than one device's
product, ``tests/test_torch_spmd.py``'s); the cache's ``pos`` and every
block's placement ``==``.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.models.params import map_with_path
from repro_torch.runtime import serve as tserve
from repro_torch.runtime import train as rt
from repro_torch.sharding import spmd
from repro_torch.sharding.rules import ShardCtx
from test_torch_spmd import cpu_mesh, ctx_of, key, port_model

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
LOGIT_TOL = dict(rtol=2e-5, atol=2e-5)
#: (id, arch, mesh shape, seq_shard_kv, batch, prompt, decode steps,
#: max_len).  qwen2's 2 KV heads split over a 2-way model axis but not a
#: 4-way one (query heads split, KV heads replicated); at batch 1 the
#: batch does not split and the slots go over ("data", "model"), or over
#: "data" with the KV heads over "model" (``True``); 19 slots do not split
#: (the leaf stays replicated over the model axis, its KV heads split);
#: danube's window of 16 is shorter than its 20-token prompt + 6 steps,
#: so the ring wraps across the two blocks; qwen3's 2-token prompt leaves
#: 7 of 8 blocks of 2 slots empty at the first decode step.
SP_CASES = [
    ("model_2x2", "qwen2-1.5b", (2, 2), "model", 4, 12, 4, 20),
    ("model_2x4", "qwen2-1.5b", (2, 4), "model", 4, 12, 4, 20),
    ("data_model_b1", "qwen2-1.5b", (2, 2), ("data", "model"), 1, 12, 4,
     20),
    ("data_b1", "qwen2-1.5b", (2, 2), True, 1, 12, 4, 20),
    ("odd_ring", "qwen2-1.5b", (2, 2), "model", 4, 12, 4, 19),
    ("danube_wrap", "h2o-danube-1.8b", (2, 2), "model", 4, 20, 6, 26),
    ("empty_blocks", "qwen3-32b", (2, 4), ("data", "model"), 1, 2, 4, 16),
]
IDS = [c[0] for c in SP_CASES]


def sp_tokens(vocab, batch, prompt, steps, seed=13):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, (batch, prompt)).astype(np.int32),
            rng.integers(0, vocab, (steps, batch)).astype(np.int32))


def tok_spec(batch_axes, n_batch, batch, ndim):
    """``launch/dryrun.py::batch_pspec``'s rule as a tuple."""
    return ((batch_axes,) if batch % n_batch == 0 else (None,)) + (
        None,) * (ndim - 1)


_SUBPROC = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
sys.path.insert(0, os.environ["TEST_DIR"])
import test_torch_spmd as T0
import test_torch_spmd_sp as T
from repro.launch.mesh import make_mesh
from repro.models.model_zoo import build_model
from repro.runtime import serve as rs
from repro.sharding.rules import ShardCtx

devs = jax.devices()
assert len(devs) == 8, devs
out = {}
for i, (_, arch, shape, sp, b, p, n, ml) in enumerate(T.SP_CASES):
    model = build_model(T0.cfgs(arch)[0])
    p0 = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jax.jit(model.init_params)(jax.random.key(0)))
    mesh = make_mesh(shape, ("data", "model"),
                     devices=devs[:int(np.prod(shape))])
    ctx = ShardCtx(mesh=mesh, pod_axis=None, seq_shard_kv=sp)
    psh, csh = rs.serve_shardings(model, ctx, b, ml)
    nb = int(np.prod([mesh.shape[a] for a in ctx.batch_axes]))
    tok_sh = NamedSharding(mesh, P(*T.tok_spec(ctx.batch_axes, nb, b, 2)))
    pos_sh = NamedSharding(mesh, P(*T.tok_spec(ctx.batch_axes, nb, b, 1)))
    params = jax.tree.map(jax.device_put, p0, psh)
    specs = model.cache_specs(b, ml)
    cache = jax.tree.map(
        lambda a, s: jax.device_put(a.astype(jnp.float32) if a.dtype ==
                                    jnp.bfloat16 else a, s),
        model.init_cache(b, ml), csh)
    # each cache leaf's slice for each coordinate (row-major)
    shapes = {jax.tree_util.keystr(q): s.shape for q, s in
              jax.tree_util.tree_flatten_with_path(specs)[0]}
    place = {}
    for q, s in jax.tree_util.tree_flatten_with_path(csh)[0]:
        k = jax.tree_util.keystr(q)
        m = s.devices_indices_map(shapes[k])
        place[k] = [[[sl.start or 0, d if sl.stop is None else sl.stop]
                     for sl, d in zip(m[dv], shapes[k])]
                    for dv in mesh.devices.flat]
    out[f"sp{i}_place"] = np.array(json.dumps(place))
    pre = jax.jit(rs.make_prefill_step(model, ctx),
                  in_shardings=(psh, tok_sh, tok_sh, csh),
                  out_shardings=(None, csh))
    dec = jax.jit(rs.make_decode_step(model, ctx),
                  in_shardings=(psh, tok_sh, pos_sh, csh),
                  out_shardings=(None, csh))
    prompt, steps = T.sp_tokens(model.cfg.vocab_size, b, p, n)
    pos = np.tile(np.arange(p, dtype=np.int32), (b, 1))
    lg, cache = pre(params, jnp.asarray(prompt), jnp.asarray(pos), cache)
    out[f"sp{i}_logits0"] = np.asarray(lg)
    for j in range(n):
        q = np.full((b,), p + j, np.int32)
        lg, cache = dec(params, jnp.asarray(steps[j][:, None]),
                        jnp.asarray(q), cache)
        out[f"sp{i}_logits{j + 1}"] = np.asarray(lg)
    for q, v in jax.tree_util.tree_flatten_with_path(cache)[0]:
        out[f"sp{i}_c{jax.tree_util.keystr(q)}"] = np.asarray(v)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's SP steps on 8 forced host devices, one
    subprocess."""
    path = str(tmp_path_factory.mktemp("spmd_sp") / "ref.npz")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               TEST_DIR=os.path.dirname(__file__))
    r = subprocess.run([sys.executable, "-c", _SUBPROC, path], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    return dict(np.load(path))


def _flat(tree) -> dict:
    out = {}
    map_with_path(lambda path, a: out.__setitem__(key(path), a), tree)
    return out


@pytest.mark.parametrize("case", range(len(SP_CASES)), ids=IDS)
def test_sp_steps_match_reference_and_unsharded(ref, case):
    """``init_cache`` places every leaf as the reference's
    ``devices_indices_map`` (slots over the SP axes where they split);
    prefill then decode steps against the reference's partitioned steps
    (the logits of every call, the cache's K/V at the end, its ``pos``
    ``==``) and the port's unsharded steps; every logit finite."""
    _, arch, shape, sp, b, p, n, ml = SP_CASES[case]
    model = port_model(arch)
    ctx = ctx_of(cpu_mesh(shape), seq_shard_kv=sp)
    params = rt.placed_params(model, ctx, mode="serve")
    cache = tserve.init_cache(model, ctx, b, ml, dtype=torch.float32)
    want = json.loads(str(ref[f"sp{case}_place"]))
    mesh = ctx.mesh
    for k, leaf in _flat(cache).items():
        for c, blk, sl in zip(mesh.coords(), leaf.blocks, want[k]):
            assert tuple(blk.shape) == tuple(e - s for s, e in sl), (k, c)
    starts = {k: [[s for s, _ in sl] for sl in v] for k, v in want.items()}
    got_starts = {}
    for k, leaf in _flat(cache).items():
        whole = leaf.shape
        idx = torch.arange(int(np.prod(whole))).reshape(whole)
        blocks = spmd.place(idx, leaf.sharding).blocks
        got_starts[k] = [[int(x) for x in np.unravel_index(
            int(blk.reshape(-1)[0]), whole)] for blk in blocks]
    assert got_starts == starts
    prompt, steps = sp_tokens(model.cfg.vocab_size, b, p, n)
    prompt = torch.from_numpy(prompt).long()
    pos = torch.arange(p)[None].expand(b, -1)
    cache0 = model.init_cache(b, ml, dtype=torch.float32)
    pre = tserve.jit_prefill_step(model, ctx, b, ml)
    dec = tserve.jit_decode_step(model, ctx, b, ml)
    pre0 = tserve.make_prefill_step(model, ShardCtx())
    dec0 = tserve.make_decode_step(model, ShardCtx())
    got, mine = [pre(params, prompt, pos, cache)[0]], [
        pre0(prompt, pos, cache0)[0]]
    for j in range(n):
        t = torch.from_numpy(steps[j][:, None]).long()
        q = torch.full((b,), p + j)
        got.append(dec(params, t, q, cache)[0])
        mine.append(dec0(t, q, cache0)[0])
    for j, (a, u) in enumerate(zip(got, mine)):
        assert bool(torch.isfinite(a).all()), f"step {j}"
        np.testing.assert_allclose(a.numpy(), ref[f"sp{case}_logits{j}"],
                                   err_msg=f"step {j}", **LOGIT_TOL)
        np.testing.assert_allclose(a.numpy(), u.numpy(), err_msg=f"step {j}",
                                   **LOGIT_TOL)
    flat0 = _flat(cache0)
    for k, a in _flat(spmd.gather_tree(cache)).items():
        w = ref[f"sp{case}_c{k}"]
        if k.endswith("['pos']"):
            np.testing.assert_array_equal(a.numpy(), w)
            assert torch.equal(a, flat0[k])
        else:
            np.testing.assert_allclose(a.numpy(), w, err_msg=k, **LOGIT_TOL)
            np.testing.assert_allclose(a.numpy(), flat0[k].numpy(),
                                       err_msg=k, **LOGIT_TOL)


def test_ring_block_write_matches_ring_fill():
    """Each block's ``ring_block_write`` of a prompt longer than the ring
    (it wraps) and of one-token steps, put together, ``==`` the whole
    ring's ``ring_cache_fill`` and ``ring_cache_update``."""
    from repro_torch.models import attention as A
    g = torch.Generator().manual_seed(5)
    b, w, nb, h, d = 3, 12, 4, 2, 5
    whole = {"k": torch.zeros(b, w, h, d), "v": torch.zeros(b, w, h, d),
             "pos": torch.full((b, w), -1, dtype=torch.int32)}
    blocks = [{k: t[:, i * w // nb:(i + 1) * w // nb].clone()
               for k, t in whole.items()} for i in range(nb)]
    pos = torch.arange(17)[None].expand(b, -1) + torch.tensor([[0], [3], [5]])
    k, v = torch.randn(b, 17, h, d, generator=g), torch.randn(
        b, 17, h, d, generator=g)
    A.ring_cache_fill(whole, k, v, pos)
    for i, blk in enumerate(blocks):
        A.ring_block_write(blk, k, v, pos, i * w // nb, w)
    for step in range(5):
        p = pos[:, -1] + 1 + step
        k1, v1 = torch.randn(b, 1, h, d, generator=g), torch.randn(
            b, 1, h, d, generator=g)
        A.ring_cache_update(whole, k1, v1, p)
        for i, blk in enumerate(blocks):
            A.ring_block_write(blk, k1, v1, p[:, None], i * w // nb, w)
        for name, t in whole.items():
            assert torch.equal(torch.cat([blk[name] for blk in blocks], 1),
                               t), (step, name)
