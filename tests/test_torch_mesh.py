"""The port's model meshes held against the reference: ``launch/mesh.py``,
``sharding/rules.py`` (``default_rules``, ``spec_for``, ``partition_tree``
and ``shard_map`` with its collectives), the sharded MoE paths, the
tied-head cross-entropy, ``step_shardings``, ``serve_shardings`` and
``elastic_mesh``.

The port's meshes here are lists of the CPU device (``[cpu] * n``), its
``shard_map`` running a thread a coordinate.  The reference's ``spec_for``
reads only ``mesh.shape``, so a stand-in with that mapping serves it the
production shapes on this one-device host.  Its sharded code needs real
devices: it runs in one subprocess for the whole module under
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` (as
``tests/test_device_shard.py`` does), on the same numpy inputs, and writes
its results to a file the tests read.  Tolerances: rtol/atol 2e-5 for the
MoE outputs (``tests/test_mixers.py``), 1e-6 for the loss."""
import dataclasses
import json
import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models.model_zoo import build_model as jax_build_model
from repro.sharding import rules as jrules
from repro_torch.configs import registry as treg
from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.launch import mesh as tmesh
from repro_torch.models import moe as tmoe
from repro_torch.models.model_zoo import build_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime import fault
from repro_torch.runtime import serve as tserve
from repro_torch.runtime import train as rt
from repro_torch.sharding import rules
from repro_torch.sharding.rules import P, ShardCtx

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
CPU = torch.device("cpu")
TOL = dict(rtol=2e-5, atol=2e-5)
SHAPES = {(2, 2): ("data", "model"), (2, 4): ("data", "model"),
          (2, 2, 2): ("pod", "data", "model")}
IMPLS = ("sharded", "sharded2d", "sharded_a2a")


def cpu_mesh(shape, axes=None):
    axes = axes or SHAPES.get(tuple(shape), ("data", "model"))
    return tmesh.make_mesh(shape, axes, devices=[CPU] * int(np.prod(shape)))


def _moe_cfg(shared=0, e=8, k=2):
    return ArchConfig(
        name="e", family="moe", num_layers=1, d_model=32, num_heads=2,
        num_kv_heads=2, d_ff=64, vocab_size=64,
        moe=MoEConfig(num_experts=e, top_k=k, d_ff_expert=32,
                      num_shared_experts=shared, capacity_factor=8.0))


def _moe_params(shared, seed=0):
    """fp32 numpy leaves of the MoE layer, the same in both packages."""
    cfg = _moe_cfg(shared)
    rng = np.random.default_rng(seed)
    m, d, ff = cfg.moe, cfg.d_model, cfg.moe.d_ff_expert
    p = {"router": rng.standard_normal((d, m.num_experts)),
         "w_gate": rng.standard_normal((m.num_experts, d, ff)) * 0.2,
         "w_up": rng.standard_normal((m.num_experts, d, ff)) * 0.2,
         "w_down": rng.standard_normal((m.num_experts, ff, d)) * 0.2}
    if shared:
        p["shared"] = {"wi_gate": rng.standard_normal((d, ff)) * 0.2,
                       "wi_up": rng.standard_normal((d, ff)) * 0.2,
                       "wo": rng.standard_normal((ff, d)) * 0.2}
    return jax.tree.map(lambda a: a.astype(np.float32), p)


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


#: (mesh shape, impl, capacity factor, shared experts, x shape)
MOE_CASES = [(s, i, cf, sh, (4, 8, 32))
             for s in ((2, 2), (2, 4)) for i in IMPLS
             for cf, sh in ((8.0, 1), (0.5, 0))]
MOE_CASES += [((2, 2, 2), i, 8.0, 0, (4, 8, 32))
              for i in ("sharded", "sharded_a2a")]
MOE_CASES += [((2, 2), "sharded_a2a", 8.0, 0, (4, 1, 32)),   # one token:
              ((2, 4), "sharded", 1.25, 1, (3, 8, 32))]      # 2d; odd batch
XENT = dict(b=2, s=24, d=32, v=64, chunk=8)

_SUBPROC = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
sys.path.insert(0, os.environ["TEST_DIR"])
import test_torch_mesh as T
from repro.configs.base import ArchConfig, MoEConfig
from repro.launch.mesh import make_mesh
from repro.models import moe
from repro.runtime import fault, train
from repro.sharding.rules import ShardCtx, shard_map

out = {}
devs = jax.devices()
assert len(devs) == 8, devs
for n, (shape, impl, cf, shared, xs) in enumerate(T.MOE_CASES):
    cfg = ArchConfig(name="e", family="moe", num_layers=1, d_model=32,
                     num_heads=2, num_kv_heads=2, d_ff=64, vocab_size=64,
                     moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=32,
                                   num_shared_experts=shared,
                                   capacity_factor=8.0))
    mesh = make_mesh(shape, T.SHAPES[shape],
                     devices=devs[:int(np.prod(shape))])
    ctx = ShardCtx(mesh=mesh, moe_impl=impl,
                   pod_axis="pod" if len(shape) == 3 else None)
    p = jax.tree.map(jnp.asarray, T._moe_params(shared))
    y, aux = jax.jit(lambda p, x: moe.apply_moe(p, x, cfg, ctx,
                                                capacity_factor=cf))(
        p, jnp.asarray(T._x(xs)))
    out[f"moe{n}"] = np.asarray(y)
    out[f"moe{n}_aux"] = np.asarray(aux)

# the tied-head loss over the model axis, and its gradients
X = T.XENT
rng = np.random.default_rng(3)
h = rng.standard_normal((X["b"], X["s"], X["d"])).astype(np.float32)
w = (rng.standard_normal((X["d"], X["v"])) * 0.3).astype(np.float32)
lab = rng.integers(-1, X["v"], (X["b"], X["s"])).astype(np.int32)
for shape in ((1, 2), (2, 4)):
    mesh = make_mesh(shape, ("data", "model"),
                     devices=devs[:int(np.prod(shape))])
    ctx = ShardCtx(mesh=mesh, pod_axis=None, replicate_lm_head=True)
    f = lambda h, w: train.chunked_xent(h, w, jnp.asarray(lab), X["chunk"],
                                        ctx)
    loss, (gh, gw) = jax.value_and_grad(f, argnums=(0, 1))(h, w)
    key = "x".join(map(str, shape))
    out[f"xent_{key}"], out[f"xent_{key}_gh"] = np.asarray(loss), gh
    out[f"xent_{key}_gw"] = gw

# the collectives, on distinct values a coordinate
mesh = make_mesh((2, 2), ("data", "model"), devices=devs[:4])
x = np.arange(32, dtype=np.float32).reshape(16, 2)
A = ("data", "model")
sm = lambda f, o: np.asarray(jax.jit(shard_map(
    f, mesh=mesh, in_specs=(P(A),), out_specs=o, check_vma=False))(x))
out["c_a2a"] = sm(lambda v: jax.lax.all_to_all(
    v.reshape(4, 1, 2), A, 0, 0, tiled=False).reshape(4, 2), P(A))
out["c_psum"] = sm(lambda v: jax.lax.psum(v, "model"), P("data"))
out["c_psum_all"] = sm(lambda v: jax.lax.psum(v, A), P())
out["c_gather"] = sm(lambda v: jax.lax.all_gather(v, "model", axis=0,
                                                  tiled=True), P("data"))
out["c_gather_s"] = sm(lambda v: jax.lax.all_gather(v, "data", axis=1,
                                                    tiled=True),
                       P(None, "model"))
out["c_scatter"] = sm(lambda v: jax.lax.psum_scatter(
    v, "data", scatter_dimension=0, tiled=True), P(A))
out["c_index"] = sm(lambda v: v * 0 + jax.lax.axis_index(A), P(A))

# the elastic re-mesh's shapes
shapes = {}
for n in range(1, 9):
    for mp in (1, 2, 4):
        for pods in (False, True):
            if n >= mp:
                m = fault.elastic_mesh(devs[:n], mp, pods)
                shapes[f"{n},{mp},{int(pods)}"] = [list(m.axis_names),
                                                   list(m.devices.shape)]
out["elastic"] = np.array(json.dumps(shapes))
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's results on 8 forced host devices, one subprocess."""
    path = str(tmp_path_factory.mktemp("mesh") / "ref.npz")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               TEST_DIR=os.path.dirname(__file__))
    r = subprocess.run([sys.executable, "-c", _SUBPROC, path], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    return dict(np.load(path))


# ---------------------------------------------------------------- meshes --
def test_make_mesh():
    m = cpu_mesh((2, 4))
    assert m.shape == {"data": 2, "model": 4} and m.size == 8
    assert list(m.shape) == ["data", "model"] and m.axis_names == (
        "data", "model")
    assert m.devices.shape == (2, 4) and m.device_at((1, 3)) == CPU
    assert m.coords()[:3] == [(0, 0), (0, 1), (0, 2)]
    with pytest.raises(ValueError, match="needs 8 devices"):
        tmesh.make_mesh((2, 4), ("data", "model"), devices=[CPU] * 4)
    with pytest.raises(ValueError, match="rank"):
        tmesh.make_mesh((2, 4), ("data",), devices=[CPU] * 8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="none is visible"):
            tmesh.make_mesh((1, 1), ("data", "model"))
    p = tmesh.make_production_mesh(devices=[CPU] * 256)
    assert p.shape == {"data": 16, "model": 16}
    p = tmesh.make_production_mesh(multi_pod=True, devices=[CPU] * 512)
    assert p.shape == {"pod": 2, "data": 16, "model": 16}


def test_shard_ctx_fields_match_reference():
    """The reference's fields, defaults and derived values."""
    jf = {f.name: f.default for f in dataclasses.fields(jrules.ShardCtx)}
    tf = {f.name: f.default for f in dataclasses.fields(ShardCtx)}
    assert jf == tf
    for shape, axes in SHAPES.items():
        m = cpu_mesh(shape, axes)
        stand_in = types.SimpleNamespace(shape=dict(m.shape),
                                         axis_names=m.axis_names)
        for pod in ("pod", None):
            t, j = (ShardCtx(mesh=m, pod_axis=pod),
                    jrules.ShardCtx(mesh=stand_in, pod_axis=pod))
            assert t.batch_axes == j.batch_axes
            assert t.axis_size(("data", "model")) == j.axis_size(
                ("data", "model"))
            assert t.batch_spec(3, 1) == tuple(j.batch_spec(3, 1))
    ctx = ShardCtx(mesh=cpu_mesh((1, 1)), moe_impl="sharded2d")
    x = torch.ones(3)
    assert ctx.constrain(x, P("data")) is x


def _norm(spec):
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


_OPTIONS = [dict(mode=m, moe_impl=i, fsdp_pod=f, seq_shard_kv=s,
                 replicate_lm_head=r)
            for m in ("train", "serve")
            for i, f, s, r in (("auto", False, False, False),
                               ("sharded2d", True, True, False),
                               ("sharded_a2a", False, True, True))]


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
def test_partition_trees_match_reference(arch, multi_pod):
    """``default_rules``, ``spec_for`` and ``partition_tree`` over the full
    config's parameter and cache specs, at 16 x 16 and 2 x 16 x 16, in
    train and serve modes, with the sharded MoE layouts, FSDP over pods,
    the sharded KV sequence and the replicated head."""
    shape = {"pod": 2, "data": 16, "model": 16} if multi_pod else {
        "data": 16, "model": 16}
    stand_in = types.SimpleNamespace(shape=shape, axis_names=tuple(shape))
    tmesh_ = cpu_mesh(tuple(shape.values()), tuple(shape))
    jm = jax_build_model(jreg.get_config(arch))
    tm = build_model(treg.get_config(arch), device="meta")
    kw = {"enc_len": 1500} if arch == "whisper-small" else {}
    trees = [(tm.specs(), jm.specs()),
             (tm.cache_specs(8, 1024, **kw), jm.cache_specs(8, 1024, **kw))]
    for opt in _OPTIONS:
        mode = opt["mode"]
        ctx_kw = {k: v for k, v in opt.items() if k != "mode"}
        tctx = ShardCtx(mesh=tmesh_, **ctx_kw)
        jctx = jrules.ShardCtx(mesh=stand_in, **ctx_kw)
        trules, jrules_ = (rules.default_rules(tctx, mode=mode),
                           jrules.default_rules(jctx, mode=mode))
        assert trules == jrules_
        for tspecs, jspecs in trees:
            got = []
            _leaves(rules.partition_tree(tspecs, trules, tmesh_), got)
            want = jax.tree.leaves(
                jrules.partition_tree(jspecs, jrules_, stand_in),
                is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
            assert len(got) == len(want)
            assert [_norm(g) for g in got] == [_norm(tuple(w))
                                               for w in want], opt


@pytest.mark.parametrize("arch", ["whisper-small", "granite-moe-1b-a400m",
                                  "deepseek-v3-671b"])
def test_step_and_serve_shardings(arch):
    """The spec trees of the fused step and of serving ``==`` the
    reference's rules over its own trees."""
    m = cpu_mesh((2, 4))
    stand_in = types.SimpleNamespace(shape=dict(m.shape),
                                     axis_names=m.axis_names)
    tm = build_model(treg.get_config(arch), device="meta")
    jm = jax_build_model(jreg.get_config(arch))
    ctx = ShardCtx(mesh=m, pod_axis=None)
    jctx = jrules.ShardCtx(mesh=stand_in, pod_axis=None)
    for master in (True, False):
        psh, osh, bsh = rt.step_shardings(tm, AdamWConfig(master_fp32=master),
                                          ctx)
        want = jax.tree.leaves(jrules.partition_tree(
            jm.specs(), jrules.default_rules(jctx, mode="train"), stand_in),
            is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
        got = []
        _leaves(psh, got)
        assert [_norm(g.spec) for g in got] == [_norm(tuple(w))
                                                for w in want]
        assert all(g.mesh is m for g in got)
        assert osh["step"].spec == () and (osh["master"] is None) != master
        assert bsh["tokens"].spec == ("data", None)
    kw = {"enc_len": 1500} if arch == "whisper-small" else {}
    psh, csh = tserve.serve_shardings(tm, ctx, 8, 512, **kw)
    jr = jrules.default_rules(jctx, mode="serve")
    for tree, jspecs in ((psh, jm.specs()),
                         (csh, jm.cache_specs(8, 512, **kw))):
        got = []
        _leaves(tree, got)
        want = jax.tree.leaves(
            jrules.partition_tree(jspecs, jr, stand_in),
            is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
        assert [_norm(g.spec) for g in got] == [_norm(tuple(w))
                                                for w in want]


def _leaves(tree, out):
    """A spec or sharding tree's leaves in ``jax.tree.leaves``' order
    (dict keys sorted)."""
    if isinstance(tree, (rules.NamedSharding, P)):
        out.append(tree)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            _leaves(tree[k], out)
    else:
        for v in tree:
            _leaves(v, out)


# ------------------------------------------------------------ shard_map ---
def _sm(f, out_spec, x, shape=(2, 2)):
    m = cpu_mesh(shape)
    A = ("data", "model")
    return rules.shard_map(f, mesh=m, in_specs=(P(A),),
                           out_specs=out_spec)(x).numpy()


def test_collectives_match_reference(ref):
    A = ("data", "model")
    x = torch.arange(32, dtype=torch.float32).reshape(16, 2)
    got = {
        "c_a2a": _sm(lambda v: rules.all_to_all(v.reshape(4, 1, 2), A, 0,
                                                0).reshape(4, 2), P(A), x),
        "c_psum": _sm(lambda v: rules.psum(v, "model"), P("data"), x),
        "c_psum_all": _sm(lambda v: rules.psum(v, A), P(), x),
        "c_gather": _sm(lambda v: rules.all_gather(v, "model", axis=0),
                        P("data"), x),
        "c_gather_s": _sm(lambda v: rules.all_gather(v, "data", axis=1),
                          P(None, "model"), x),
        "c_scatter": _sm(lambda v: rules.psum_scatter(
            v, "data", scatter_dimension=0), P(A), x),
        "c_index": _sm(lambda v: v * 0 + rules.axis_index(A), P(A), x),
    }
    for k, v in got.items():
        np.testing.assert_array_equal(v, ref[k], err_msg=k)


def test_shard_map_errors_and_outputs():
    m = cpu_mesh((2, 2))
    x = torch.arange(12.0).reshape(6, 2)
    with pytest.raises(ValueError, match="does not split"):
        rules.shard_map(lambda v: v, mesh=m, in_specs=(P(("data", "model")),),
                        out_specs=P(("data", "model")))(x)

    def boom(v):
        if rules.axis_index("model") == 1:
            raise KeyError("one coordinate fails")
        return rules.psum(v, "model")
    with pytest.raises(KeyError, match="one coordinate"):
        rules.shard_map(boom, mesh=m, in_specs=(P("data"),),
                        out_specs=P("data"))(x)
    with pytest.raises(RuntimeError, match="inside shard_map"):
        rules.psum(x, "model")
    two = rules.shard_map(lambda v: (v + 1, rules.psum(v.sum(), "data")),
                          mesh=m, in_specs=(P("data"),),
                          out_specs=(P("data"), P()))(x)
    assert torch.equal(two[0], x + 1) and float(two[1]) == float(x.sum())


def test_shard_map_stress_with_a_short_switch_interval():
    """16 coordinates (more workers than this host's cores need not be)
    through a chain of collectives, the interpreter switching threads every
    microsecond: every result is the plain computation's, and the call
    ends within its time."""
    import threading
    m = tmesh.make_mesh((2, 4, 2), ("pod", "data", "model"),
                        devices=[CPU] * 16)
    A = ("pod", "data", "model")
    x = torch.arange(16 * 16 * 3, dtype=torch.float64).reshape(256, 3)

    def f(v):
        s = rules.psum(v, "model")
        s = rules.psum(s, ("pod", "data")) + rules.axis_index(A)
        t = rules.all_to_all(v.reshape(16, 16 // 16, 3), A, 0, 0)
        g = rules.all_gather(v, "data", axis=0)
        return s, t.reshape(16, 3), g.sum(0, keepdim=True).expand(16, 3)

    blocks = x.reshape(16, 16, 3)
    total = blocks.sum(0)                        # psum over every axis
    want_s = torch.cat([total + r for r in range(16)])
    want_t = blocks.transpose(0, 1).reshape(256, 3)
    by_rank = {r: blocks[r] for r in range(16)}
    want_g = torch.cat([sum(by_rank[p * 8 + d * 2 + mm] for d in range(4))
                        .sum(0, keepdim=True).expand(16, 3)
                        for p in range(2) for d in range(4)
                        for mm in range(2)])
    run = rules.shard_map(f, mesh=m, in_specs=(P(A),),
                          out_specs=(P(A), P(A), P(A)))
    out, errs = [], []

    def loop():
        try:
            for _ in range(20):
                out.append(run(x))
        except BaseException as e:            # noqa: BLE001 (asserted)
            errs.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t = threading.Thread(target=loop)
        t.start()
        t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not t.is_alive() and not errs and len(out) == 20
    for s_, t_, g_ in out:
        assert torch.equal(s_, want_s) and torch.equal(t_, want_t)
        assert torch.equal(g_, want_g)


# ------------------------------------------------------------- MoE paths --
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("shared", [0, 1])
def test_moe_sharded_degenerate_mesh_matches_reference(impl, shared):
    """On a (1, 1) mesh every sharded path ``==`` the reference's on its
    (1, 1) mesh and the dense path (capacity 8: no drops), as
    ``tests/test_mixers.py`` holds the reference."""
    from repro.launch.mesh import make_mesh as jmake_mesh
    from repro.models import moe as jmoe
    import jax.numpy as jnp
    cfg = _moe_cfg(shared)
    p = _moe_params(shared)
    x = _x((2, 8, 32))
    jctx = jrules.ShardCtx(mesh=jmake_mesh((1, 1), ("data", "model")),
                           pod_axis=None, moe_impl=impl)
    jy, jaux = jax.jit(lambda p, x: jmoe.apply_moe(p, x, cfg, jctx))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tp = jax.tree.map(torch.from_numpy, p)
    ctx = ShardCtx(mesh=cpu_mesh((1, 1)), pod_axis=None, moe_impl=impl)
    stats = {}
    ty, taux = tmoe.apply_moe(tp, torch.from_numpy(x), cfg, ctx,
                              stats=stats)
    dy, daux = tmoe.moe_dense(tp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(ty.numpy(), dy.numpy(), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    assert float(taux) == float(daux) and stats == {"dropped": 0}


@pytest.mark.parametrize("case", range(len(MOE_CASES)))
def test_moe_sharded_meshes_match_reference(ref, case):
    """(2, 2), (2, 4) and (2, 2, 2) meshes of the CPU against the
    reference on 8 forced host devices: with room for every token and
    with capacity drops, shared experts, one-token steps (the a2a path
    falls back to 2d) and a batch that does not split over data."""
    shape, impl, cf, shared, xs = MOE_CASES[case]
    cfg = _moe_cfg(shared)
    ctx = ShardCtx(mesh=cpu_mesh(shape), moe_impl=impl,
                   pod_axis="pod" if len(shape) == 3 else None)
    tp = jax.tree.map(torch.from_numpy, _moe_params(shared))
    y, aux = tmoe.apply_moe(tp, torch.from_numpy(_x(xs)), cfg, ctx,
                            capacity_factor=cf)
    np.testing.assert_allclose(y.numpy(), ref[f"moe{case}"], **TOL)
    np.testing.assert_allclose(float(aux), float(ref[f"moe{case}_aux"]),
                               rtol=1e-5)


def _plain_dropped(x, router, cfg, impl, shape, cf):
    """The (token, expert) pairs past capacity, counted directly from the
    routing: for each coordinate's token set, each expert's (or each
    owner's) pairs beyond the capacity."""
    m = cfg.moe
    b, s, d = x.shape
    data, model = shape
    logits = x.reshape(-1, d) @ router
    _, idx = tmoe.router_topk(logits, m.top_k)
    idx = idx.reshape(b, s, m.top_k)
    if impl == "sharded":
        shards = [idx[i * b // data:(i + 1) * b // data]
                  for i in range(data)]
        cap = max(8, int((b // data) * s * m.top_k * cf / m.num_experts))
        key = lambda e: e                                # noqa: E731
    elif impl == "sharded2d":
        shards, key = [idx], (lambda e: e)
        cap = max(8, int(b * s * m.top_k * cf / m.num_experts))
    else:
        n_ep = data * model
        el = m.num_experts // n_ep
        shards = [idx[i * b // data:(i + 1) * b // data, j * s // model:
                      (j + 1) * s // model]
                  for i in range(data) for j in range(model)]
        t_loc = (b // data) * (s // model)
        cap = max(8, int(t_loc * m.top_k * cf / n_ep))
        key = lambda e: e // el                          # noqa: E731
    dropped = 0
    for sh in shards:
        counts = torch.bincount(key(sh.reshape(-1)))
        dropped += int((counts - cap).clamp_min(0).sum())
    return dropped


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (2, 4)])
def test_moe_capacity_drops_tokens(impl, shape):
    """A tight capacity drops pairs (the output differs from dense) but
    stays finite; the count of dropped pairs ``==`` a plain count of the
    same routing (``tests/test_mixers.py``'s capacity case)."""
    cfg = _moe_cfg()
    x = torch.from_numpy(_x((4, 32, 32)))
    tp = jax.tree.map(torch.from_numpy, _moe_params(0))
    ctx = ShardCtx(mesh=cpu_mesh(shape), pod_axis=None, moe_impl=impl)
    stats = {}
    y, _ = tmoe.apply_moe(tp, x, cfg, ctx, capacity_factor=0.1,
                          stats=stats)
    dy, _ = tmoe.moe_dense(tp, x, cfg)
    assert bool(torch.isfinite(y).all())
    assert not torch.allclose(y, dy, atol=1e-3)
    want = _plain_dropped(x, tp["router"], cfg, impl, shape, 0.1)
    assert want > 0 and stats["dropped"] == want
    stats = {}
    tmoe.apply_moe(tp, x, cfg, ctx, capacity_factor=8.0, stats=stats)
    assert stats["dropped"] == 0


def test_moe_module_takes_the_mesh_path_and_decode_cf():
    """The ``MoE`` module dispatches on the context; the decode step
    passes ``moe_decode_cf``; without a mesh a sharded impl is refused."""
    from repro_torch.configs.registry import get_smoke
    cfg = get_smoke("granite-moe-1b-a400m")
    # capacity for every pair (cf >= E / top_k): the sharded paths drop
    # nothing, so they are the dense path
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    model.init_params(torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 8),
                         generator=torch.Generator().manual_seed(1))
    pos = torch.arange(8).expand(2, 8)
    dense = model(toks, pos)["hidden"]
    for impl in IMPLS:
        ctx = ShardCtx(mesh=cpu_mesh((2, 2)), pod_axis=None, moe_impl=impl)
        out = model(toks, pos, ctx)["hidden"]
        np.testing.assert_allclose(out.detach().numpy(),
                                   dense.detach().numpy(), rtol=2e-4,
                                   atol=2e-4)
    seen = []
    orig = tmoe.apply_moe

    def spy(p, x, cfg_, ctx=None, capacity_factor=None, stats=None):
        seen.append(capacity_factor)
        return orig(p, x, cfg_, ctx, capacity_factor, stats)
    tmoe.apply_moe = spy
    try:
        ctx = ShardCtx(mesh=cpu_mesh((1, 1)), moe_impl="sharded",
                       moe_decode_cf=3.0)
        cache = model.init_cache(2, 9, dtype=torch.float32)
        with torch.no_grad():
            model.prefill(toks, pos, cache, ctx)
            model.decode(toks[:, :1], torch.full((2,), 8), cache, ctx)
    finally:
        tmoe.apply_moe = orig
    assert seen == [None] * cfg.num_layers + [3.0] * cfg.num_layers
    with pytest.raises(ValueError, match="need a mesh"):
        ShardCtx(moe_impl="sharded2d")
    with pytest.raises(ValueError, match="moe_impl"):
        ShardCtx(mesh=cpu_mesh((1, 1)), moe_impl="ring")


# ------------------------------------------------------- tied-head loss ---
@pytest.mark.parametrize("shape", [(1, 2), (2, 4)])
def test_tied_head_xent_over_the_model_axis(ref, shape):
    """With ``replicate_lm_head`` the chunks' tokens split over the model
    axis: the loss and its gradients agree with the unsharded loss and
    with the reference's sharded one."""
    X = XENT
    rng = np.random.default_rng(3)
    h = rng.standard_normal((X["b"], X["s"], X["d"])).astype(np.float32)
    w = (rng.standard_normal((X["d"], X["v"])) * 0.3).astype(np.float32)
    lab = torch.from_numpy(rng.integers(-1, X["v"], (X["b"], X["s"]))
                           .astype(np.int32))
    ctx = ShardCtx(mesh=cpu_mesh(shape), pod_axis=None,
                   replicate_lm_head=True)
    got = {}
    for name, c in (("sharded", ctx), ("plain", None)):
        th = torch.from_numpy(h).requires_grad_(True)
        tw = torch.from_numpy(w).requires_grad_(True)
        loss = rt.chunked_xent(th, tw, lab, X["chunk"], c)
        gh, gw = torch.autograd.grad(loss, (th, tw))
        got[name] = (float(loss.detach()), gh.numpy(), gw.numpy())
    key = "x".join(map(str, shape))
    for name in got:
        loss, gh, gw = got[name]
        np.testing.assert_allclose(loss, float(ref[f"xent_{key}"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(gh, ref[f"xent_{key}_gh"], rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(gw, ref[f"xent_{key}_gw"], rtol=1e-5,
                                   atol=1e-7)
    np.testing.assert_allclose(got["sharded"][0], got["plain"][0], rtol=1e-6)


# ---------------------------------------------------------- elastic mesh --
def test_elastic_mesh_matches_reference(ref):
    want = json.loads(str(ref["elastic"]))
    for key, (names, shape) in want.items():
        n, mp, pods = (int(v) for v in key.split(","))
        m = fault.elastic_mesh([CPU] * n, mp, bool(pods))
        assert [list(m.axis_names), list(m.devices.shape)] == [names, shape]
    with pytest.raises(ValueError, match="cannot host"):
        fault.elastic_mesh([CPU] * 3, 4)
