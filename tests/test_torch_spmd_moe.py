"""The MoE family on a mesh: granite's smoke config placed by the spec
trees (experts over the model axis; the expert ff dim over data under
``sharded2d``'s serve layout; whole experts over (data, model) under
``sharded_a2a``'s), its train, prefill and decode steps running the
three dispatch paths on rank lists (``models/moe.py::moe_placed``), held
against the reference's partitioned steps and the port's unsharded ones;
and the rank-list collectives the paths add (``spmd.all_to_all``,
``spmd.pmax``) against ``rules.shard_map``'s.

The reference's steps run once for the module in a subprocess under
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` (as
``tests/test_torch_spmd.py`` does) on the same numpy tokens and the same
seeded fp32 weights.  Its dropped (token, expert) pairs are counted there
from each MoE layer's input and router, read by a ``jax.debug.callback``
inside the jitted step, with the capacity rule of the path the step
takes (:func:`plain_drops`); the port's come from its ``stats`` count.

Tolerances, fp32: the loss and the aux losses rtol 1e-5; updated
parameters and first moments rtol/atol 1e-5 (``tests/test_torch_spmd.py``'s,
at its lr); logits rtol/atol 2e-5; the drop counts ``==``.  AdamW runs at
eps 1e-6 here: its first update is lr g / (|g| + eps), whose slope in g
is lr / eps at g = 0, so at eps 1e-8 a gradient of ~1e-9 (one in 8,192
of a layer's ``wo`` entries, at cf 0.5 under ``sharded2d``) moved its
parameter 1.3e-5 away from the reference's on a 5e-10 difference in its
first moment; at 1e-6 the slope is 100 times less, and the gradients
themselves are gated through the first moment.
"""
import dataclasses
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
from repro_torch.models import convert
from repro_torch.models.moe import MoE
from repro_torch.optim import adamw
from repro_torch.runtime import serve as tserve
from repro_torch.runtime import train as rt
from repro_torch.sharding import rules, spmd
from repro_torch.sharding.rules import P, NamedSharding, ShardCtx
from test_torch_spmd import LR, _flat_port, cpu_mesh, ctx_of

OPT = dict(LR, eps=1e-6)

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=2e-5, atol=2e-5)
ARCH = "granite-moe-1b-a400m"
SHAPE = (2, 2)
#: (moe_impl, capacity factor, tied head, shared experts): the config's cf
#: 1.25 and a tight 0.5 that drops pairs on every path; granite's own tied
#: head once; a shared expert (its ff over the model axis) once
CASES = [(impl, cf, False, 0) for impl in ("sharded", "sharded2d",
                                           "sharded_a2a")
         for cf in (1.25, 0.5)] + [("sharded", 1.25, True, 0),
                                   ("sharded2d", 1.25, False, 1)]
IDS = [f"{i}-cf{cf}" + ("-tied" if t else "") + ("-shared" if sh else "")
       for i, cf, t, sh in CASES]
BATCH, SEQ = 8, 16                  # train: 8 rows of 16 + 1 tokens
SERVE = dict(batch=4, prompt=12, steps=3, max_len=16)


def scaled(cfg, cf, tied, shared):
    return dataclasses.replace(cfg, tie_embeddings=tied, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf, num_shared_experts=shared))


def cfgs(case):
    """(reference config, port config) of a case."""
    _, cf, tied, shared = CASES[case]
    return (scaled(jax_get_smoke(ARCH), cf, tied, shared),
            scaled(get_smoke(ARCH), cf, tied, shared))


def tokens(vocab):
    rng = np.random.default_rng(17)
    return (rng.integers(0, vocab, (BATCH, SEQ + 1)).astype(np.int32),
            rng.integers(0, vocab, (SERVE["batch"], SERVE["prompt"]))
            .astype(np.int32),
            rng.integers(0, vocab, (SERVE["steps"], SERVE["batch"]))
            .astype(np.int32))


def plain_drops(x, router, cfg, impl, shape, cf) -> int:
    """The (token, expert) pairs past capacity of one MoE layer's input
    ``x`` (B, S, d) and ``router`` (numpy), counted over the token set each
    coordinate routes with the capacity of the path ``impl`` takes on a
    (data, model) mesh: an expert's pairs (or, for the a2a path, an
    owner's) beyond it."""
    m = cfg.moe
    b, s, d = x.shape
    data, model = shape
    if impl == "sharded_a2a" and (s % model or s == 1):
        impl = "sharded2d"
    logits = x.reshape(-1, d).astype(np.float32) @ router.astype(np.float32)
    idx = np.argsort(-logits, axis=-1, kind="stable")[:, :m.top_k]
    idx = idx.reshape(b, s, m.top_k)
    nb = data if b % data == 0 else 1
    rows = [idx[i * b // nb:(i + 1) * b // nb] for i in range(nb)]
    if impl == "sharded":
        sets, owner = rows, 1
        cap = max(8, int((b // nb) * s * m.top_k * cf / m.num_experts))
    elif impl == "sharded2d":
        sets, owner = [idx], 1
        cap = max(8, int(b * s * m.top_k * cf / m.num_experts))
    else:
        n_ep = data * model
        owner = m.num_experts // n_ep
        sets = [r[:, j * s // model:(j + 1) * s // model] for r in rows
                for j in range(model)]
        cap = max(8, int((b // nb) * (s // model) * m.top_k * cf / n_ep))
    return sum(int(np.clip(np.bincount(st.reshape(-1) // owner) - cap, 0,
                           None).sum()) for st in sets)


_SUBPROC = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
sys.path.insert(0, os.environ["TEST_DIR"])
import test_torch_spmd_moe as T
from repro.launch.mesh import make_mesh
from repro.models import moe
from repro.models.model_zoo import build_model
from repro.optim import adamw
from repro.runtime import serve as rs, train as rt
from repro.sharding.rules import ShardCtx, default_rules, partition_tree

devs = jax.devices()
assert len(devs) == 8, devs
out = {}
drops = []
orig = moe.apply_moe


def spy(p, x, cfg, ctx=None, capacity_factor=None):
    cf = (capacity_factor if capacity_factor is not None
          else cfg.moe.capacity_factor)
    jax.debug.callback(lambda xv, rv: drops.append(T.plain_drops(
        np.asarray(xv), np.asarray(rv), cfg, ctx.moe_impl,
        tuple(ctx.mesh.devices.shape), cf)), x, p["router"])
    return orig(p, x, cfg, ctx, capacity_factor)


moe.apply_moe = spy


def counted(f, *args):
    drops.clear()
    res = f(*args)
    jax.block_until_ready(res)
    jax.effects_barrier()
    return res, sum(drops)


def flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


mesh = make_mesh(T.SHAPE, ("data", "model"), devices=devs[:4])
for i, (impl, cf, tied, shared) in enumerate(T.CASES):
    model = build_model(T.cfgs(i)[0])
    p0 = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jax.jit(model.init_params)(jax.random.key(0)))
    ctx = ShardCtx(mesh=mesh, pod_axis=None, moe_impl=impl)
    toks, prompt, steps = T.tokens(model.cfg.vocab_size)
    # the train step
    ocfg = adamw.AdamWConfig(**T.OPT)
    psh = jax.tree.map(lambda s: NamedSharding(mesh, s), partition_tree(
        model.specs(), default_rules(ctx, mode="train"), mesh))
    p1 = jax.tree.map(jax.device_put, p0, psh)
    o1 = adamw.init_state(p1, ocfg)
    step = rt.jit_train_step(model, ocfg, ctx, donate=False)
    (p2, o2, m), d = counted(step, p1, o1, {"tokens": jnp.asarray(toks)})
    out[f"c{i}_loss"] = np.asarray(m["loss"])
    out[f"c{i}_aux"] = np.asarray(m["aux"])
    out[f"c{i}_gnorm"] = np.asarray(m["grad_norm"])
    out[f"c{i}_train_drops"] = np.asarray(d)
    for k, v in flat(p2).items():
        out[f"c{i}_p{k}"] = v
    for k, v in flat(o2["m"]).items():
        out[f"c{i}_m{k}"] = v
    # prefill + decode
    S = T.SERVE
    b = S["batch"]
    psh, csh = rs.serve_shardings(model, ctx, b, S["max_len"])
    params = jax.tree.map(jax.device_put, p0, psh)
    cache = jax.tree.map(
        lambda a, s: jax.device_put(a.astype(jnp.float32) if a.dtype ==
                                    jnp.bfloat16 else a, s),
        model.init_cache(b, S["max_len"]), csh)
    tok_sh = NamedSharding(mesh, P(ctx.batch_axes, None))
    pre = jax.jit(rs.make_prefill_step(model, ctx),
                  in_shardings=(psh, tok_sh, tok_sh, csh),
                  out_shardings=(None, csh))
    dec = rs.jit_decode_step(model, ctx, b, S["max_len"], donate=False)
    pos = np.tile(np.arange(S["prompt"], dtype=np.int32), (b, 1))
    (lg, cache), d = counted(pre, params, jnp.asarray(prompt),
                             jnp.asarray(pos), cache)
    out[f"c{i}_logits0"], out[f"c{i}_drops0"] = np.asarray(lg), np.asarray(d)
    for j in range(S["steps"]):
        q = np.full((b,), S["prompt"] + j, np.int32)
        (lg, cache), d = counted(dec, params, jnp.asarray(steps[j][:, None]),
                                 jnp.asarray(q), cache)
        out[f"c{i}_logits{j + 1}"] = np.asarray(lg)
        out[f"c{i}_drops{j + 1}"] = np.asarray(d)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's MoE steps on 8 forced host devices, one
    subprocess."""
    path = str(tmp_path_factory.mktemp("spmd_moe") / "ref.npz")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               TEST_DIR=os.path.dirname(__file__))
    r = subprocess.run([sys.executable, "-c", _SUBPROC, path], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    return dict(np.load(path))


def port_model(case):
    """The port's model on the CPU holding the reference's seeded fp32
    weights (the subprocess draws the same)."""
    jcfg, tcfg = cfgs(case)
    jm = jax_build_model(jcfg)
    p = jax.tree.map(lambda a: np.asarray(a, np.float32),
                     jax.jit(jm.init_params)(jax.random.key(0)))
    return convert.params_from_numpy(p, tcfg, device="cpu")


def _counting(model):
    """A fresh drop count shared by every MoE layer of ``model``."""
    stats = {}
    for mod in model.modules():
        if isinstance(mod, MoE):
            mod.stats = stats
    return stats


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_moe_train_step_matches_reference_and_unsharded(ref, case):
    """``jit_train_step`` on a (2, 2) mesh: the loss, the aux losses and
    the grad norm, the updated parameters and first moments against the
    reference's partitioned step; the dropped pairs ``==`` its count;
    every replica ``torch.equal``; the loss and aux beside the port's
    unsharded step where nothing is dropped (the dense path drops
    nothing)."""
    impl = CASES[case][0]
    model = port_model(case)
    ctx = ctx_of(cpu_mesh(SHAPE), moe_impl=impl)
    ocfg = adamw.AdamWConfig(**OPT)
    placed = rt.placed_params(model, ctx)
    opt = adamw.init_state(placed, ocfg)
    toks = torch.from_numpy(tokens(model.cfg.vocab_size)[0]).long()
    stats = _counting(model)
    p2, o2, m = rt.jit_train_step(model, ocfg, ctx, donate=False)(
        placed, opt, {"tokens": toks})
    assert stats.get("dropped", 0) == int(ref[f"c{case}_train_drops"])
    for k in ("loss", "aux", "gnorm"):
        got = m["grad_norm" if k == "gnorm" else k]
        np.testing.assert_allclose(float(got), float(ref[f"c{case}_{k}"]),
                                   rtol=1e-5, err_msg=k)
    for label, got in (("p", _flat_port(p2, model)),
                       ("m", _flat_port(o2["m"], model))):
        for k, a in got.items():
            np.testing.assert_allclose(a, ref[f"c{case}_{label}{k}"],
                                       err_msg=f"{label} {k}", **TOL)
    for p in list(p2.values()) + list(o2["m"].values()):
        named = spmd.spec_axes(p.spec)
        coords = p.mesh.coords()
        rank = {c: r for r, c in enumerate(coords)}
        for c, blk in zip(coords, p.blocks):
            home = tuple(i if a in named else 0
                         for a, i in zip(p.mesh.axis_names, c))
            assert torch.equal(blk, p.blocks[rank[home]])
    if not stats.get("dropped", 0):
        plain = port_model(case)
        params = rt.train_params(plain)
        o0 = adamw.init_state(params, ocfg)
        _, _, m0 = rt.jit_train_step(plain, ocfg, ShardCtx())(
            params, o0, {"tokens": toks})
        np.testing.assert_allclose(float(m["loss"]), float(m0["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["aux"]), float(m0["aux"]),
                                   rtol=1e-5)


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_moe_prefill_and_decode_match_reference(ref, case):
    """``jit_prefill_step`` then ``jit_decode_step`` steps (the decode at
    ``moe_decode_cf``) on a (2, 2) mesh against the reference's
    partitioned steps: the logits of every call, the dropped pairs of
    every call ``==`` its count."""
    impl = CASES[case][0]
    model = port_model(case)
    ctx = ctx_of(cpu_mesh(SHAPE), moe_impl=impl)
    s = SERVE
    b = s["batch"]
    params = rt.placed_params(model, ctx, mode="serve")
    cache = tserve.init_cache(model, ctx, b, s["max_len"],
                              dtype=torch.float32)
    _, prompt, steps = tokens(model.cfg.vocab_size)
    prompt = torch.from_numpy(prompt).long()
    pos = torch.arange(s["prompt"])[None].expand(b, -1)
    stats = _counting(model)
    lg, _ = tserve.jit_prefill_step(model, ctx, b, s["max_len"])(
        params, prompt, pos, cache)
    got, drops = [lg], [stats.pop("dropped", 0)]
    dec = tserve.jit_decode_step(model, ctx, b, s["max_len"])
    for j in range(s["steps"]):
        t = torch.from_numpy(steps[j][:, None]).long()
        q = torch.full((b,), s["prompt"] + j)
        got.append(dec(params, t, q, cache)[0])
        drops.append(stats.pop("dropped", 0))
    for j, lg in enumerate(got):
        np.testing.assert_allclose(lg.numpy(), ref[f"c{case}_logits{j}"],
                                   err_msg=f"call {j}", **LOGIT_TOL)
        assert drops[j] == int(ref[f"c{case}_drops{j}"]), j


def test_tight_capacity_drops_on_every_path(ref):
    """The tight cases do drop pairs (in the train step on every path),
    so the counts above are held where they are not 0."""
    for case, (impl, cf, _, _) in enumerate(CASES):
        if cf < 1:
            assert int(ref[f"c{case}_train_drops"]) > 0, impl


def test_all_to_all_and_pmax_match_shard_map():
    """``spmd.all_to_all`` and ``spmd.pmax`` ``==`` ``rules.shard_map``'s
    ``all_to_all`` and ``pmax`` on distinct values a coordinate, over one
    axis and over two; ``rules.pmax`` is the elementwise maximum and
    ``spmd.all_to_all``'s gradient its transpose."""
    mesh = cpu_mesh((2, 2, 2))
    A = ("pod", "data", "model")
    x = torch.randn(32, 3, generator=torch.Generator().manual_seed(2),
                    dtype=torch.float64)
    xs = spmd.place(x, NamedSharding(mesh, P(A))).blocks

    def sm(f, o):
        return rules.shard_map(f, mesh=mesh, in_specs=(P(A),),
                               out_specs=o)(x)

    def assemble(blocks, spec):
        return rules._assemble(dict(zip(mesh.coords(), blocks)), spec, mesh,
                               torch.device("cpu"))

    for axes, spec in (("model", P(("pod", "data"))),
                       (("data", "model"), P("pod")), (A, P())):
        want = sm(lambda v: rules.pmax(v, axes), spec)
        assert torch.equal(assemble(spmd.pmax(xs, mesh, axes), spec), want)
    for axes in (("data", "model"), "model"):
        n = mesh.shape["model"] * (mesh.shape["data"] if len(axes) == 2
                                   else 1)
        want = sm(lambda v: rules.all_to_all(v.reshape(n, 4 // n, 3), axes,
                                             0, 0).reshape(4, 3), P(A))
        got = spmd.all_to_all([b.reshape(n, 4 // n, 3) for b in xs], mesh,
                              axes, 0, 0)
        assert torch.equal(assemble([g.reshape(4, 3) for g in got], P(A)),
                           want)
    want = sm(lambda v: v.amax(0, keepdim=True) * 0
              + rules.pmax(v, A).amax(0, keepdim=True), P(A))
    assert torch.equal(want, x.amax(0, keepdim=True).expand(8, 3))
    leaves = [b.reshape(4, 1, 3).clone().requires_grad_(True) for b in xs]
    out = spmd.all_to_all(leaves, mesh, ("data", "model"), 0, 0)
    wts = [torch.full_like(o, float(r)) for r, o in enumerate(out)]
    gs = torch.autograd.grad(sum((o * w).sum() for o, w in zip(out, wts)),
                             leaves)
    back = spmd.all_to_all(wts, mesh, ("data", "model"), 0, 0)
    assert all(torch.equal(g, w) for g, w in zip(gs, back))


def test_reshard_round_trips():
    """``spmd.reshard`` between the train layout of an expert weight
    (experts over model, embed over data) and each path's in_specs gives
    the blocks ``place`` cuts, and back."""
    mesh = cpu_mesh(SHAPE)
    w = torch.arange(4 * 6 * 8, dtype=torch.float32).reshape(4, 6, 8)
    src = P("model", "data", None)
    blocks = spmd.place(w, NamedSharding(mesh, src)).blocks
    for dst in (P("model", None, None), P("model", None, "data"),
                P(("data", "model"), None, None), P()):
        got = spmd.reshard(blocks, mesh, src, dst)
        want = spmd.place(w, NamedSharding(mesh, dst)).blocks
        assert all(torch.equal(a, b) for a, b in zip(got, want)), dst
        back = spmd.reshard(got, mesh, dst, src)
        assert all(torch.equal(a, b) for a, b in zip(back, blocks)), dst
