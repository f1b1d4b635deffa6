"""The sharded steps (``sharding/spmd.py``, ``runtime/train.py::
jit_train_step``, ``runtime/serve.py::jit_prefill_step`` and
``jit_decode_step``, ``runtime/checkpoint.py::restore(..., shardings=)``)
held against the reference's partitioned steps and the port's own
unsharded ones.

The port's meshes are lists of the CPU device (``[cpu] * n``).  The
reference's sharded steps need real devices: they run once for the whole
module in a subprocess under
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` (as
``tests/test_torch_mesh.py`` does), on the same numpy inputs and the same
seeded weights (the reference's ``init_params``, fp32, carried into the
port by ``models/convert.py``), and write their results to a file the
tests read.

Tolerances, all fp32: losses rtol 1e-5; updated parameters and first
moments rtol/atol 1e-5 (``tests/test_torch_train.py``'s); logits and
cache K/V rtol/atol 2e-5 (sums over the model axis in another order than
one device's product); placement, the cache's ``pos`` and the re-meshed
checkpoint ``==``.  The steps run at lr 1e-4 (5e-5 at step 1): AdamW's
first update is lr g / (|g| + eps), so a gradient within a few eps of 0
(one or two in 10^4 here) moves its parameter by a share of lr that its
rounding decides; at lr 1e-3 that reached 1.4e-5 against the
reference.  The gradients themselves are gated through the first moment
(0.1 g), whatever the lr.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke as jax_get_smoke
from repro.models.model_zoo import build_model as jax_build_model
from repro_torch.configs.registry import get_smoke
from repro_torch.launch import mesh as tmesh
from repro_torch.models import convert
from repro_torch.models.model_zoo import build_model
from repro_torch.models.params import map_with_path
from repro_torch.optim import adamw
from repro_torch.runtime import checkpoint as ckpt
from repro_torch.runtime import fault
from repro_torch.runtime import serve as tserve
from repro_torch.runtime import train as rt
from repro_torch.sharding import rules, spmd
from repro_torch.sharding.rules import P, NamedSharding, ShardCtx

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
CPU = torch.device("cpu")
AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}
PLACE_SHAPES = [(2, 2), (1, 4), (2, 4), (2, 2, 2)]
PLACE_ARCHS = ("qwen2-1.5b", "qwen3-32b")
#: (config, mesh shape, microbatches).  qwen2's 2 KV heads do not divide
#: a 4-way model axis (replicated KV heads, split query heads); "h6" has 6
#: query heads, which 4 does not divide (replicated attention); qwen3's
#: head is untied (vocab-parallel loss), qwen2's tied (d split)
TRAIN_CASES = [("qwen2-1.5b", (2, 4), 2), ("qwen2-1.5b", (2, 2), 1),
               ("qwen3-32b", (2, 4), 1), ("qwen3-32b", (2, 2), 2),
               ("h6", (2, 4), 1)]
DECODE_CASES = [("qwen2-1.5b", (2, 2)), ("qwen3-32b", (2, 2)),
                ("qwen2-1.5b", (2, 4))]
BATCH, SEQ = 8, 16                 # train: 8 rows of 16 + 1 tokens
SERVE = dict(batch=4, prompt=12, steps=4, max_len=20)
PLACE = dict(batch=8, max_len=16)
LR = dict(lr=1e-4, warmup_steps=2, total_steps=10)
TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=2e-5, atol=2e-5)


def cfgs(name):
    """(reference config, port config) of a test config."""
    if name == "h6":
        kw = dict(num_heads=6, num_kv_heads=2, head_dim=16)
        return (jax_get_smoke("qwen2-1.5b").scaled(**kw),
                get_smoke("qwen2-1.5b").scaled(**kw))
    return jax_get_smoke(name), get_smoke(name)


def tokens(vocab, rows=BATCH, cols=SEQ + 1, seed=7):
    return np.random.default_rng(seed).integers(
        0, vocab, (rows, cols)).astype(np.int32)


def serve_tokens(vocab):
    rng = np.random.default_rng(11)
    return (rng.integers(0, vocab, (SERVE["batch"], SERVE["prompt"]))
            .astype(np.int32),
            rng.integers(0, vocab, (SERVE["steps"], SERVE["batch"]))
            .astype(np.int32))


def key(path) -> str:
    """A tree path as ``jax.tree_util.keystr`` writes it."""
    return "".join(f"[{k!r}]" for k in path)


def cpu_mesh(shape):
    return tmesh.make_mesh(shape, AXES[len(shape)],
                           devices=[CPU] * int(np.prod(shape)))


def ctx_of(mesh, **kw):
    return ShardCtx(mesh=mesh, pod_axis="pod" if "pod" in mesh.axis_names
                    else None, **kw)


_SUBPROC = r"""
import os, sys, json, tempfile
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
sys.path.insert(0, os.environ["TEST_DIR"])
import test_torch_spmd as T
from repro.launch.mesh import make_mesh
from repro.models.model_zoo import build_model
from repro.optim import adamw
from repro.runtime import checkpoint as ckpt, fault
from repro.runtime import serve as rs, train as rt
from repro.sharding.rules import ShardCtx, default_rules, partition_tree

devs = jax.devices()
assert len(devs) == 8, devs
out = {}


def mesh_of(shape):
    return make_mesh(shape, T.AXES[len(shape)],
                     devices=devs[:int(np.prod(shape))])


def ctx_of(mesh):
    return ShardCtx(mesh=mesh, pod_axis="pod" if "pod" in mesh.axis_names
                    else None)


def flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def params_of(name):
    model = build_model(T.cfgs(name)[0])
    p = jax.tree.map(lambda a: a.astype(jnp.float32),
                     jax.jit(model.init_params)(jax.random.key(0)))
    return model, p


# placement: each leaf's slice for each coordinate (row-major)
place = {}
for arch in T.PLACE_ARCHS:
    model = build_model(T.cfgs(arch)[0])
    for shape in T.PLACE_SHAPES:
        mesh = mesh_of(shape)
        ctx = ctx_of(mesh)
        psh, _, _ = rt.step_shardings(model, adamw.AdamWConfig(), ctx)
        spsh, csh = rs.serve_shardings(model, ctx, T.PLACE["batch"],
                                       T.PLACE["max_len"])
        trees = {"step": (psh, model.specs()), "serve": (spsh, model.specs()),
                 "cache": (csh, model.cache_specs(T.PLACE["batch"],
                                                  T.PLACE["max_len"]))}
        for tname, (sh, specs) in trees.items():
            shapes = {jax.tree_util.keystr(p): s.shape for p, s in
                      jax.tree_util.tree_flatten_with_path(specs)[0]}
            got = {}
            for p, s in jax.tree_util.tree_flatten_with_path(sh)[0]:
                k = jax.tree_util.keystr(p)
                m = s.devices_indices_map(shapes[k])
                got[k] = [[[sl.start or 0, n if sl.stop is None else sl.stop]
                           for sl, n in zip(m[d], shapes[k])]
                          for d in mesh.devices.flat]
            place[f"{arch}|{shape}|{tname}"] = got
out["place"] = np.array(json.dumps(place))

# the sharded train steps
for i, (name, shape, mb) in enumerate(T.TRAIN_CASES):
    model, p0 = params_of(name)
    mesh = mesh_of(shape)
    ctx = ctx_of(mesh)
    ocfg = adamw.AdamWConfig(**T.LR)
    psh = jax.tree.map(lambda s: NamedSharding(mesh, s), partition_tree(
        model.specs(), default_rules(ctx, mode="train"), mesh))
    p1 = jax.tree.map(jax.device_put, p0, psh)
    o1 = adamw.init_state(p1, ocfg)
    step = rt.jit_train_step(model, ocfg, ctx, microbatches=mb, donate=False)
    toks = jnp.asarray(T.tokens(model.cfg.vocab_size))
    p1b, o1b, m1 = step(p1, o1, {"tokens": toks})
    out[f"train{i}_loss"] = np.asarray(m1["loss"])
    out[f"train{i}_gnorm"] = np.asarray(m1["grad_norm"])
    for k, v in flat(p1b).items():
        out[f"train{i}_p{k}"] = v
    for k, v in flat(o1b["m"]).items():
        out[f"train{i}_m{k}"] = v
    if i == 0:
        # the elastic re-mesh: saved from 2 x 4, restored onto 4 x 2
        with tempfile.TemporaryDirectory() as d:
            ckpt.save(d, 1, p1b)
            mesh2 = fault.elastic_mesh(devs, 2)
            ctx2 = ctx_of(mesh2)
            psh2 = jax.tree.map(lambda s: NamedSharding(mesh2, s),
                                partition_tree(model.specs(), default_rules(
                                    ctx2, mode="train"), mesh2))
            p2 = ckpt.restore(d, 1, p1b, shardings=psh2)
            step2 = rt.jit_train_step(model, ocfg, ctx2, donate=False)
            _, _, m2 = step2(p2, adamw.init_state(p2, ocfg), {"tokens": toks})
            out["remesh_loss"] = np.asarray(m2["loss"])

# the sharded serve steps: prefill + decode on fixed tokens
S = T.SERVE
for i, (name, shape) in enumerate(T.DECODE_CASES):
    model, p0 = params_of(name)
    mesh = mesh_of(shape)
    ctx = ctx_of(mesh)
    psh, csh = rs.serve_shardings(model, ctx, S["batch"], S["max_len"])
    params = jax.tree.map(jax.device_put, p0, psh)
    cache = jax.tree.map(
        lambda a, s: jax.device_put(a.astype(jnp.float32) if a.dtype ==
                                    jnp.bfloat16 else a, s),
        model.init_cache(S["batch"], S["max_len"]), csh)
    tok_sh = NamedSharding(mesh, P(ctx.batch_axes, None))
    pre = jax.jit(rs.make_prefill_step(model, ctx),
                  in_shardings=(psh, tok_sh, tok_sh, csh),
                  out_shardings=(None, csh))
    dec = rs.jit_decode_step(model, ctx, S["batch"], S["max_len"],
                             donate=False)
    prompt, steps = T.serve_tokens(model.cfg.vocab_size)
    pos = np.tile(np.arange(S["prompt"], dtype=np.int32), (S["batch"], 1))
    lg, cache = pre(params, jnp.asarray(prompt), jnp.asarray(pos), cache)
    out[f"serve{i}_logits0"] = np.asarray(lg)
    for j in range(S["steps"]):
        p = np.full((S["batch"],), S["prompt"] + j, np.int32)
        lg, cache = dec(params, jnp.asarray(steps[j][:, None]),
                        jnp.asarray(p), cache)
        out[f"serve{i}_logits{j + 1}"] = np.asarray(lg)
    for k, v in flat(cache).items():
        out[f"serve{i}_c{k}"] = v
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's results on 8 forced host devices, one subprocess."""
    path = str(tmp_path_factory.mktemp("spmd") / "ref.npz")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               TEST_DIR=os.path.dirname(__file__))
    r = subprocess.run([sys.executable, "-c", _SUBPROC, path], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    return dict(np.load(path))


def port_model(name):
    """The port's model on the CPU holding the reference's seeded fp32
    weights (the subprocess draws the same)."""
    jcfg, tcfg = cfgs(name)
    jm = jax_build_model(jcfg)
    p = jax.tree.map(lambda a: np.asarray(a, np.float32),
                     jax.jit(jm.init_params)(jax.random.key(0)))
    return convert.params_from_numpy(p, tcfg, device="cpu")


def _flat_port(by_name, model):
    """Placed (or plain) tensors by parameter name as the reference's
    flat ``keystr`` -> numpy dict."""
    whole = {n: spmd.gather(v) if isinstance(v, spmd.Placed) else v
             for n, v in by_name.items()}
    tree = convert.stacked_to_numpy(whole, model)
    out = {}
    map_with_path(lambda path, a: out.__setitem__(key(path), a), tree)
    return out


# --------------------------------------------------------------- placement
@pytest.mark.parametrize("shape", PLACE_SHAPES, ids=str)
@pytest.mark.parametrize("arch", PLACE_ARCHS)
def test_placement_matches_devices_indices_map(ref, arch, shape):
    """Every leaf's block of every coordinate ``==`` the slice the
    reference's ``devices_indices_map`` gives the device at that position,
    for ``step_shardings`` (parameters; the AdamW state is placed by the
    same tree) and ``serve_shardings`` (parameters and cache)."""
    want = json.loads(str(ref["place"]))
    mesh = cpu_mesh(shape)
    ctx = ctx_of(mesh)
    model = build_model(get_smoke(arch), device="meta")
    psh, osh, _ = rt.step_shardings(model, adamw.AdamWConfig(), ctx)
    assert osh["m"] is psh and osh["master"] is psh
    spsh, csh = tserve.serve_shardings(model, ctx, PLACE["batch"],
                                       PLACE["max_len"])
    trees = {"step": (psh, model.specs()), "serve": (spsh, model.specs()),
             "cache": (csh, model.cache_specs(PLACE["batch"],
                                              PLACE["max_len"]))}
    rng = np.random.default_rng(0)
    for tname, (sh, specs) in trees.items():
        glob = map_with_path(lambda path, s: torch.from_numpy(
            rng.standard_normal(s.shape).astype(np.float32)), specs)
        placed = spmd.place_tree(glob, sh)
        exp = want[f"{arch}|{shape}|{tname}"]
        got = {}
        map_with_path(lambda path, p: got.__setitem__(key(path), p), placed)
        flat_glob = {}
        map_with_path(lambda path, g: flat_glob.__setitem__(key(path), g),
                      glob)
        assert set(got) == set(exp)
        for k, p in got.items():
            assert len(p.blocks) == mesh.size
            for c, blk, sl in zip(mesh.coords(), p.blocks, exp[k]):
                idx = tuple(slice(a, b) for a, b in sl)
                assert blk.device == mesh.device_at(c)
                assert torch.equal(blk, flat_glob[k][idx]), (k, c)
            assert torch.equal(spmd.gather(p), flat_glob[k])


def test_named_shardings_and_placed_params():
    """A parameter's sharding is its stacked leaf's without the layers
    entry; ``placed_params`` places each by it, every block its own copy
    (coordinates sharing a device too), taking gradients in train mode."""
    model = port_model("qwen2-1.5b")
    mesh = cpu_mesh((2, 4))
    ctx = ctx_of(mesh)
    psh, _, _ = rt.step_shardings(model, adamw.AdamWConfig(), ctx)
    named = spmd.named_shardings(model, psh)
    assert named["groups.0.1.0.mixer.wq"].spec == P("data", "model", None)
    assert named["groups.0.1.0.mixer.wk"].spec == P("data", None, None)
    assert named["embed.tok"].spec == P(None, "model")
    assert named["final_norm.scale"].spec == P(None)
    placed = rt.placed_params(model, ctx)
    ptrs = [b.data_ptr() for p in placed.values() for b in p.blocks]
    assert len(set(ptrs)) == len(ptrs)
    assert all(b.requires_grad for p in placed.values() for b in p.blocks)
    for n, p in model.named_parameters():
        assert torch.equal(spmd.gather(placed[n]), p.detach())
    serve = rt.placed_params(model, ctx, mode="serve")
    assert serve["groups.0.1.0.mixer.wq"].spec == P(None, "model", None)
    assert not any(b.requires_grad for p in serve.values() for b in p.blocks)


# -------------------------------------------------------------- the steps
def _port_step(name, shape, mb, model=None, **ctx_kw):
    model = model or port_model(name)
    ctx = ctx_of(cpu_mesh(shape), **ctx_kw)
    ocfg = adamw.AdamWConfig(**LR)
    placed = rt.placed_params(model, ctx)
    opt = adamw.init_state(placed, ocfg)
    step = rt.jit_train_step(model, ocfg, ctx, microbatches=mb, donate=False)
    toks = torch.from_numpy(tokens(model.cfg.vocab_size)).long()
    p2, o2, m = step(placed, opt, {"tokens": toks})
    return model, ctx, (placed, opt), (p2, o2, m)


def _unsharded_step(model, mb):
    ocfg = adamw.AdamWConfig(**LR)
    params = rt.train_params(model)
    opt = adamw.init_state(params, ocfg)
    step = rt.jit_train_step(model, ocfg, ShardCtx(), microbatches=mb)
    toks = torch.from_numpy(tokens(model.cfg.vocab_size)).long()
    _, opt, m = step(params, opt, {"tokens": toks})
    return params, opt, m


@pytest.mark.parametrize("case", range(len(TRAIN_CASES)))
def test_train_step_matches_reference_and_unsharded(ref, case):
    """``jit_train_step`` on (2, 4) and (2, 2), 1 and 2 microbatches,
    against the reference's sharded ``jit_train_step`` (8 forced host
    devices) and the port's unsharded step: the loss, the grad norm, the
    updated parameters and the first moment (0.1 x the clipped gradient);
    every replica of a leaf ``torch.equal`` after the step."""
    name, shape, mb = TRAIN_CASES[case]
    model, ctx, _, (p2, o2, m) = _port_step(name, shape, mb)
    np.testing.assert_allclose(float(m["loss"]), float(ref[f"train{case}_loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(ref[f"train{case}_gnorm"]), rtol=1e-5)
    for label, got in (("p", _flat_port(p2, model)),
                       ("m", _flat_port(o2["m"], model))):
        for k, a in got.items():
            np.testing.assert_allclose(a, ref[f"train{case}_{label}{k}"],
                                       err_msg=f"{label} {k}", **TOL)
    for p in list(p2.values()) + list(o2["m"].values()):
        reps = spmd.distinct_ranks(p.mesh, p.spec)
        for r, blk in enumerate(p.blocks):
            c = p.mesh.coords()[r]
            twin = [q for q in reps if all(
                p.mesh.coords()[q][i] == c[i] for i, a in
                enumerate(p.mesh.axis_names) if a in spmd.spec_axes(p.spec))]
            assert torch.equal(blk, p.blocks[twin[0]])
    # the port's unsharded step from the same weights
    params, opt, m0 = _unsharded_step(port_model(name), mb)
    np.testing.assert_allclose(float(m["loss"]), float(m0["loss"]), rtol=1e-5)
    want = _flat_port({n: p.detach() for n, p in params.items()}, model)
    for k, a in _flat_port(p2, model).items():
        np.testing.assert_allclose(a, want[k], err_msg=k, **TOL)


def test_train_step_on_a_pod_mesh_and_with_remat():
    """(2, 2, 2) with a pod axis (DP over pod and data) and the step with
    ``remat`` (each layer recomputed in the backward, the FSDP gathers
    again) against the unsharded step; ``donate=False`` leaves the inputs
    as they were."""
    name = "qwen3-32b"
    params, _, m0 = _unsharded_step(port_model(name), 2)
    want = _flat_port({n: p.detach() for n, p in params.items()},
                      port_model(name))
    for shape, kw in (((2, 2, 2), {}), ((2, 4), {"remat": True})):
        model, _, (before, opt0), (p2, o2, m) = _port_step(name, shape, 2,
                                                          **kw)
        np.testing.assert_allclose(float(m["loss"]), float(m0["loss"]),
                                   rtol=1e-5)
        for k, a in _flat_port(p2, model).items():
            np.testing.assert_allclose(a, want[k], err_msg=k, **TOL)
        for n, p in model.named_parameters():       # donate=False
            assert torch.equal(spmd.gather(before[n]), p.detach())
        assert int(opt0["step"].blocks[0]) == 0
        assert all(int(b) == 1 for b in o2["step"].blocks)


def test_grouped_heads_that_split_unevenly_over_kv_heads():
    """6 query heads over 3 KV heads (group 2) on a 2-way model axis: a
    coordinate's 3 query heads read KV heads 0, 0, 1 (or 1, 2, 2), no run
    of whole groups, so ``kv_heads_for`` picks one KV head a query head.
    The train step (1 microbatch) and prefill + decode against the
    unsharded steps; ``kv_heads_for`` against a per-head expansion."""
    from repro_torch.models.attention import kv_heads_for
    k = torch.randn(2, 5, 3, 4)
    v = torch.randn(2, 5, 3, 4)
    for first in (0, 3):
        ks, vs = kv_heads_for(k, v, first, 3, 6)
        want = [(first + i) // 2 for i in range(3)]
        assert torch.equal(ks, k[:, :, want]) and torch.equal(vs, v[:, :, want])
    ks, vs = kv_heads_for(k, v, 2, 2, 6)                 # one whole group
    assert torch.equal(ks, k[:, :, 1:2])
    cfg = get_smoke("qwen2-1.5b").scaled(num_heads=6, num_kv_heads=3,
                                         head_dim=16)
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    model.init_params(torch.Generator().manual_seed(3))
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    _, ctx, _, (p2, _, m) = _port_step(None, (2, 2), 1, model=model)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(init[n])
    params, _, m0 = _unsharded_step(model, 1)
    np.testing.assert_allclose(float(m["loss"]), float(m0["loss"]), rtol=1e-5)
    for n, p in params.items():
        np.testing.assert_allclose(spmd.gather(p2[n]).numpy(),
                                   p.detach().numpy(), err_msg=n, **TOL)
    s = SERVE
    sp = rt.placed_params(model, ctx, mode="serve")
    cache = tserve.init_cache(model, ctx, s["batch"], s["max_len"],
                              dtype=torch.float32)
    cache0 = model.init_cache(s["batch"], s["max_len"], dtype=torch.float32)
    prompt, steps = serve_tokens(cfg.vocab_size)
    prompt = torch.from_numpy(prompt).long()
    pos = torch.arange(s["prompt"])[None].expand(s["batch"], -1)
    lg, _ = tserve.jit_prefill_step(model, ctx, s["batch"], s["max_len"])(
        sp, prompt, pos, cache)
    lg0, _ = tserve.make_prefill_step(model, ShardCtx())(prompt, pos, cache0)
    np.testing.assert_allclose(lg.numpy(), lg0.numpy(), **LOGIT_TOL)
    t = torch.from_numpy(steps[0][:, None]).long()
    p = torch.full((s["batch"],), s["prompt"])
    lg, _ = tserve.jit_decode_step(model, ctx, s["batch"], s["max_len"])(
        sp, t, p, cache)
    lg0, _ = tserve.make_decode_step(model, ShardCtx())(t, p, cache0)
    np.testing.assert_allclose(lg.numpy(), lg0.numpy(), **LOGIT_TOL)


@pytest.mark.parametrize("case", range(len(DECODE_CASES)))
def test_prefill_and_decode_match_reference(ref, case):
    """``jit_prefill_step`` then 4 ``jit_decode_step`` steps on (2, 2) and
    (2, 4) (KV heads replicated, query heads split) against the
    reference's partitioned steps on fixed tokens: the logits at every
    step, the cache's K/V and ``pos`` (``==``) at the end; and against the
    port's unsharded steps."""
    name, shape = DECODE_CASES[case]
    model = port_model(name)
    ctx = ctx_of(cpu_mesh(shape))
    s = SERVE
    params = rt.placed_params(model, ctx, mode="serve")
    cache = tserve.init_cache(model, ctx, s["batch"], s["max_len"],
                              dtype=torch.float32)
    pre = tserve.jit_prefill_step(model, ctx, s["batch"], s["max_len"])
    dec = tserve.jit_decode_step(model, ctx, s["batch"], s["max_len"])
    pre0 = tserve.make_prefill_step(model, ShardCtx())
    dec0 = tserve.make_decode_step(model, ShardCtx())
    cache0 = model.init_cache(s["batch"], s["max_len"], dtype=torch.float32)
    prompt, steps = serve_tokens(model.cfg.vocab_size)
    prompt = torch.from_numpy(prompt).long()
    pos = torch.arange(s["prompt"])[None].expand(s["batch"], -1)
    lg, cache2 = pre(params, prompt, pos, cache)
    lg0, _ = pre0(prompt, pos, cache0)
    assert cache2 is cache and lg.shape == (s["batch"], 1,
                                            model.cfg.vocab_size)
    got, mine = [lg], [lg0]
    for j in range(s["steps"]):
        t = torch.from_numpy(steps[j][:, None]).long()
        p = torch.full((s["batch"],), s["prompt"] + j)
        got.append(dec(params, t, p, cache)[0])
        mine.append(dec0(t, p, cache0)[0])
    for j, (a, b) in enumerate(zip(got, mine)):
        np.testing.assert_allclose(a.numpy(), ref[f"serve{case}_logits{j}"],
                                   err_msg=f"step {j}", **LOGIT_TOL)
        np.testing.assert_allclose(a.numpy(), b.numpy(), **LOGIT_TOL)
    whole = spmd.gather_tree(cache)
    flat = {}
    map_with_path(lambda path, a: flat.__setitem__(key(path), a), whole)
    for k, a in flat.items():
        w = ref[f"serve{case}_c{k}"]
        if k.endswith("['pos']"):
            np.testing.assert_array_equal(a.numpy(), w)
        else:
            np.testing.assert_allclose(a.numpy(), w, err_msg=k, **LOGIT_TOL)


# ------------------------------------------------------ elastic re-mesh ---
def test_checkpoint_remesh_2x4_onto_4x2(ref, tmp_path):
    """The state after the (2, 4) step saved (each leaf whole, the same
    files as an unplaced tree's) and restored onto ``elastic_mesh``'s
    (4, 2) by ``restore(..., shardings=)``: ``==`` the saved state (the
    reference's ``reshard_err`` 0.0), every block on its new coordinate;
    the re-meshed step's loss the reference's."""
    name, shape, mb = TRAIN_CASES[0]
    model, ctx, _, (p2, o2, _) = _port_step(name, shape, mb)
    ckpt.save(str(tmp_path), 1, (p2, o2))
    manifests = []
    for sub, tree in (("placed", p2), ("plain", {
            n: spmd.gather(p) for n, p in p2.items()})):
        ckpt.save(str(tmp_path / sub), 1, tree)
        with open(tmp_path / sub / "step_00000001" / "manifest.json") as f:
            manifests.append(json.load(f))
    assert manifests[0] == manifests[1]        # the same files and CRCs
    mesh2 = fault.elastic_mesh([CPU] * 8, 2)
    assert mesh2.shape == {"data": 4, "model": 2}
    ctx2 = ctx_of(mesh2)
    ocfg = adamw.AdamWConfig(**LR)
    psh, osh, _ = rt.step_shardings(model, ocfg, ctx2)
    named = spmd.named_shardings(model, psh)
    osh_named = {"step": osh["step"], "master": named, "m": named,
                 "v": named}
    p3, o3 = ckpt.restore(str(tmp_path), 1, (p2, o2),
                          shardings=(named, osh_named))
    for a, b in zip(ckpt._leaves((p2, o2)), ckpt._leaves((p3, o3))):
        assert b.mesh is mesh2 and b.dtype == a.dtype
        assert torch.equal(spmd.gather(a), spmd.gather(b))
    step = rt.jit_train_step(model, ocfg, ctx2, donate=False)
    toks = torch.from_numpy(tokens(model.cfg.vocab_size)).long()
    _, _, m = step(p3, o3, {"tokens": toks})
    np.testing.assert_allclose(float(m["loss"]), float(ref["remesh_loss"]),
                               rtol=1e-5)
    back = ckpt.restore(str(tmp_path), 1, (p2, o2))      # like's own mesh
    assert all(b.mesh is a.mesh and torch.equal(a.blocks[0], b.blocks[0])
               for a, b in zip(ckpt._leaves((p2, o2)), ckpt._leaves(back)))


# ------------------------------------------------------- the collectives --
def test_collectives_match_shard_map():
    """``spmd``'s rank-list collectives ``==`` ``rules.shard_map``'s on
    distinct values a coordinate (itself held to the reference's in
    ``tests/test_torch_mesh.py``), and their gradients are the
    transposes: all-gather's a reduce-scatter, psum's a psum."""
    mesh = cpu_mesh((2, 2, 2))
    A = ("pod", "data", "model")
    x = torch.arange(8 * 4 * 3, dtype=torch.float64).reshape(32, 3)
    xs = spmd.place(x, NamedSharding(mesh, P(A))).blocks

    def sm(f, o):
        return rules.shard_map(f, mesh=mesh, in_specs=(P(A),),
                               out_specs=o)(x)

    def assemble(blocks, spec):
        return rules._assemble(dict(zip(mesh.coords(), blocks)), spec, mesh,
                               CPU)

    for axes, spec in (("model", P(("pod", "data"))),
                       (("pod", "data"), P("model")), (A, P())):
        want = sm(lambda v: rules.psum(v, axes), spec)
        assert torch.equal(assemble(spmd.psum(xs, mesh, axes), spec), want)
    want = sm(lambda v: rules.all_gather(v, "data", axis=1),
              P(("pod", "model")))
    got = spmd.all_gather(xs, mesh, "data", dim=1)
    assert torch.equal(assemble(got, P(("pod", "model"))), want)
    want = sm(lambda v: rules.psum_scatter(v, "model", scatter_dimension=0),
              P(A))
    assert torch.equal(assemble(spmd.psum_scatter(xs, mesh, "model", 0),
                                P(A)), want)
    idx = spmd.axis_index(mesh, ("data", "model"))
    want = sm(lambda v: v[:1, :1] * 0 + rules.axis_index(("data", "model")),
              P(A))
    assert idx == [int(v) for v in want[:, 0]]
    # gradients: d(sum of every gathered copy)/d(block) = the group size
    leaves = [b.clone().requires_grad_(True) for b in xs]
    out = spmd.all_gather(leaves, mesh, "model", dim=0)
    torch.autograd.grad(sum(o.sum() for o in out), leaves)
    g = torch.autograd.grad(sum(o.sum() for o in out), leaves)
    assert all(torch.equal(gi, torch.full_like(gi, 2.0)) for gi in g)
    out = spmd.psum(leaves, mesh, A)
    g = torch.autograd.grad(out[0].sum() * 3, leaves)
    assert all(torch.equal(gi, torch.full_like(gi, 3.0)) for gi in g)
    assert spmd.groups(mesh, "model")[1] == [2, 3]
    assert spmd.groups(mesh, ("pod", "model"))[0] == [0, 1, 4, 5]


def test_sum_replicas_and_distinct_blocks():
    """A leaf replicated over data sums its replicas' partial gradients
    (the same bits on each replica); the global norm counts each distinct
    block once."""
    mesh = cpu_mesh((2, 2))
    sh = NamedSharding(mesh, P(None, "model"))
    parts = [torch.full((3, 2), float(r + 1)) for r in range(4)]
    summed = spmd.sum_replicas(parts, mesh, sh.spec)
    assert torch.equal(summed[0], torch.full((3, 2), 4.0))      # 1 + 3
    assert torch.equal(summed[2], summed[0])
    assert torch.equal(summed[1], torch.full((3, 2), 6.0))      # 2 + 4
    assert spmd.distinct_ranks(mesh, sh.spec) == [0, 1]
    g = spmd.Placed(summed, sh)
    norm = adamw.global_norm({"w": g})
    np.testing.assert_allclose(float(norm), np.sqrt(6 * 16 + 6 * 36))
    rep = spmd.place(torch.ones(5), NamedSharding(mesh, P()))
    assert rep.distinct() == [0]
    assert float(adamw.global_norm([rep])) == pytest.approx(np.sqrt(5))


# ------------------------------------------------------------- the errors
def test_placement_errors():
    """A block on another device than its coordinate's raises (nothing is
    moved silently), as does a wrong block shape, a leaf placed by
    another spec than the step's, an unplaced leaf, and a constraint the
    placed residual stream does not meet."""
    mesh = cpu_mesh((2, 2))
    sh = NamedSharding(mesh, P("data", None))
    good = spmd.place(torch.zeros(4, 3), sh)
    bad = list(good.blocks)
    bad[3] = torch.zeros(2, 3, device="meta")
    with pytest.raises(ValueError, match=r"coordinate \(1, 1\) lies on meta"):
        spmd.Placed(bad, sh)
    with pytest.raises(ValueError, match="has shape"):
        spmd.Placed([torch.zeros(2, 3)] * 3 + [torch.zeros(1, 3)], sh,
                    (4, 3))
    with pytest.raises(ValueError, match="does not split"):
        spmd.place(torch.zeros(3, 3), sh)
    with pytest.raises(ValueError, match="the step wants"):
        spmd.check(good, NamedSharding(mesh, P(None, None)))
    with pytest.raises(TypeError, match="Placed"):
        spmd.check(torch.zeros(4, 3), sh)
    ctx = ctx_of(mesh)
    x = spmd.place(torch.zeros(4, 2, 3), NamedSharding(mesh, P("data")))
    assert ctx.constrain(x) is x
    with pytest.raises(ValueError, match="constraint"):
        ctx.constrain(spmd.place(torch.zeros(4, 2, 4),
                                 NamedSharding(mesh, P(None, None, "model"))))


def test_step_errors():
    """int8 moments with a mesh (``ValueError``, the reference's rule: the
    fused step raises, the two-phase step builds); FSDP over pods
    (``NotImplementedError``, naming the ROADMAP item); ``enc_len`` for a
    decoder-only model (``TypeError``: its cache has no cross K/V, as the
    reference's ``cache_specs`` takes no ``enc_len``); the
    encoder-decoder's and the vision frontend's placed steps, the MLA,
    Mamba-2 and hybrid families' and the SP steps (``seq_shard_kv``)
    build, and the placed two-phase step builds and runs; an unplaced
    parameter; ``donate=False`` without a mesh."""
    mesh = cpu_mesh((2, 2))
    ctx = ctx_of(mesh)
    model = port_model("qwen2-1.5b")
    with pytest.raises(ValueError, match="int8"):
        rt.jit_train_step(model, adamw.AdamWConfig(moments_dtype="int8"), ctx)
    int8 = adamw.init_state(rt.placed_params(model, ctx),
                            adamw.AdamWConfig(moments_dtype="int8"))
    assert int8["m"]["embed.tok"].dtype == torch.int8
    for arch in ("whisper-small", "internvl2-26b"):
        other = build_model(get_smoke(arch), device="meta")
        assert callable(rt.jit_train_step(other, adamw.AdamWConfig(), ctx))
        kw = {"enc_len": 24} if arch == "whisper-small" else {}
        assert callable(tserve.jit_decode_step(other, ctx, 4, 16, **kw))
        assert callable(tserve.jit_prefill_step(other, ctx, 4, 16, **kw))
        # one coordinate: the placed steps too
        one = ctx_of(cpu_mesh((1, 1)))
        assert callable(rt.jit_train_step(other, adamw.AdamWConfig(), one))
    # the MLA (with its MTP head), Mamba-2 and hybrid families are placed
    for arch in ("deepseek-v3-671b", "mamba2-1.3b", "jamba-1.5-large-398b"):
        placed = build_model(get_smoke(arch), device="meta")
        assert callable(rt.jit_train_step(placed, adamw.AdamWConfig(), ctx))
        assert callable(tserve.jit_decode_step(placed, ctx, 4, 16))
        assert callable(tserve.jit_prefill_step(placed, ctx, 4, 16))
    for sp in (True, "model"):
        sp_ctx = ctx_of(mesh, seq_shard_kv=sp)
        assert callable(tserve.jit_decode_step(model, sp_ctx, 4, 16))
        cache = tserve.init_cache(model, sp_ctx, 4, 16)
        assert isinstance(cache["groups"][0]["blocks"][0]["k"], spmd.Placed)
    pod = ctx_of(cpu_mesh((2, 2, 2)), fsdp_pod=True)
    with pytest.raises(NotImplementedError, match="M18e"):
        rt.jit_train_step(model, adamw.AdamWConfig(), pod)
    with pytest.raises(TypeError, match="enc_len"):
        tserve.jit_decode_step(model, ctx, 4, 16, enc_len=24)
    with pytest.raises(TypeError, match="enc_len"):
        tserve.init_cache(model, ctx, 4, 16, enc_len=24)
    ocfg = adamw.AdamWConfig(**LR)
    grad_step, opt_step = rt.make_two_phase_steps(model, ocfg, ctx)
    placed = rt.placed_params(model, ctx)
    toks = torch.from_numpy(tokens(model.cfg.vocab_size)).long()
    grads, metrics = grad_step(placed, {"tokens": toks})
    assert np.isfinite(float(metrics["loss"]))
    from repro_torch.core import znuma
    pool = znuma.tier_place(adamw.init_state(placed, ocfg),
                            adamw.state_tier(None), "cpu")
    _, pool, om = opt_step(placed, pool, grads)
    assert all(int(b) == 1 for b in pool["step"].blocks)
    assert om["opt_bytes_in"] == om["opt_bytes_out"] == 0
    with pytest.raises(ValueError, match="donate"):
        rt.jit_train_step(model, adamw.AdamWConfig(), ShardCtx(),
                          donate=False)
    opt = adamw.init_state(placed, ocfg)
    step = rt.jit_train_step(model, ocfg, ctx)
    placed["embed.tok"] = spmd.gather(placed["embed.tok"])
    with pytest.raises(TypeError, match="embed.tok"):
        step(placed, opt, {"tokens": toks})
    serve_p = rt.placed_params(model, ctx, mode="serve")
    with pytest.raises(ValueError, match="params=None"):
        tserve.jit_decode_step(model, ShardCtx(), 4, 16)(
            serve_p, None, None, None)


@pytest.mark.parametrize("mesh_shape", [None, (2, 2)])
def test_decode_without_donation_keeps_the_callers_cache(mesh_shape):
    """``jit_decode_step(..., donate=False)`` leaves the caller's cache as
    it was and returns the written copy, without a mesh (the eager step)
    and with one; ``donate=True`` writes the caller's cache."""
    model = port_model("qwen2-1.5b")
    s = SERVE
    prompt, steps = serve_tokens(model.cfg.vocab_size)
    prompt = torch.from_numpy(prompt).long()
    pos = torch.arange(s["prompt"])[None].expand(s["batch"], -1)
    if mesh_shape is None:
        ctx, params = ShardCtx(), None
        cache = model.init_cache(s["batch"], s["max_len"],
                                 dtype=torch.float32)
        whole = lambda c: c                               # noqa: E731
    else:
        ctx = ctx_of(cpu_mesh(mesh_shape))
        params = rt.placed_params(model, ctx, mode="serve")
        cache = tserve.init_cache(model, ctx, s["batch"], s["max_len"],
                                  dtype=torch.float32)
        whole = spmd.gather_tree                          # noqa: E731
    _, cache = tserve.jit_prefill_step(model, ctx, s["batch"], s["max_len"])(
        params, prompt, pos, cache)
    before = spmd.map_tree(lambda x: x.clone(), whole(cache))
    t = torch.from_numpy(steps[0][:, None]).long()
    p = torch.full((s["batch"],), s["prompt"])
    keep = tserve.jit_decode_step(model, ctx, s["batch"], s["max_len"],
                                  donate=False)
    lg, new = keep(params, t, p, cache)
    same = spmd.map_tree(torch.equal, whole(cache), before)
    assert all(v for g in same["groups"] for b in g["blocks"]
               for v in b.values())
    written = whole(new)["groups"][0]["blocks"][0]["pos"]
    assert int(written[0, 0, s["prompt"]]) == s["prompt"]
    assert int(before["groups"][0]["blocks"][0]["pos"][0, 0, s["prompt"]]) \
        == -1
    lg2, _ = tserve.jit_decode_step(model, ctx, s["batch"], s["max_len"])(
        params, t, p, cache)
    assert torch.equal(lg, lg2)
    assert torch.equal(whole(cache)["groups"][0]["blocks"][0]["pos"],
                       written)
