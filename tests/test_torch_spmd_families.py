"""The MLA family with its MTP head, the Mamba-2 family and jamba's
hybrid blocks on a mesh: deepseek-v3's, mamba2-1.3b's and jamba's smoke
configs placed by the spec trees, their train, prefill and decode steps
(``models/mla.py::mla_placed``, ``models/mamba2.py::mamba_placed``,
``models/transformer.py::_mesh_mtp``) held against the reference's
partitioned steps; and the placed Mamba mixer's parts (the gated norm over
the whole inner dim, each block's groups of B and C, the inner/heads
check) against their whole forms.

The reference's steps run once for the module in a subprocess under
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` (as
``tests/test_torch_spmd_sp.py`` does), the serve steps jitted with the
serve shardings and the tokens placed by ``launch/dryrun.py::batch_pspec``'s
rule, on the same numpy tokens and the same seeded fp32 weights (carried
into the port by ``models/convert.py``).

Tolerances, fp32: the loss (its MTP term reaches the gradients), the aux
losses and the grad norm rtol 1e-5; updated parameters and first moments
rtol/atol 1e-5 (AdamW at eps 1e-6, ``tests/test_torch_spmd_moe.py``'s
reason); logits and the gathered cache rtol/atol 2e-5; every leaf's
partition spec and the cache's ``pos`` ``==``.  The prompt of 13 tokens
and 4 decode steps reach position 16 of a 16-slot cache: the last step's
latent goes to the last slot (clamped, as the reference's
``dynamic_update_slice``) and jamba's ring wraps.
"""
import dataclasses
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
from repro_torch.models import convert, mamba2
from repro_torch.models.layers import rms_norm
from repro_torch.models.model_zoo import build_model
from repro_torch.models.params import map_with_path
from repro_torch.optim import adamw
from repro_torch.runtime import serve as tserve
from repro_torch.runtime import train as rt
from repro_torch.sharding import spmd
from repro_torch.sharding.rules import P, NamedSharding, ShardCtx
from test_torch_spmd import LR, _flat_port, cpu_mesh, ctx_of, key
from test_torch_spmd_sp import tok_spec

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
OPT = dict(LR, eps=1e-6)
TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=2e-5, atol=2e-5)
ARCHS = ("deepseek-v3-671b", "mamba2-1.3b", "jamba-1.5-large-398b")
SHAPES = ((2, 2), (2, 4))
#: (arch, mesh shape): each family once against the reference (its
#: partitioned train steps compile for ~10-25 s each here), mamba2's 16
#: heads in 2 groups on 4 coordinates (two blocks share a group), jamba's
#: on 2 (a whole group a block); remat and the dense MoE path are held to
#: the port's unsharded step (``test_remat_and_dense_moe_match_unsharded``)
TRAIN_CASES = [("deepseek-v3-671b", (2, 2)), ("mamba2-1.3b", (2, 4)),
               ("jamba-1.5-large-398b", (2, 2))]
TRAIN_IDS = [f"{a.split('-')[0]}-{s[0]}x{s[1]}" for a, s in TRAIN_CASES]
#: (arch, mesh shape, seq_shard_kv, batch): SP off and over "model" at
#: batch 4 (rows over "data"), over ("data", "model") at batch 1 (the
#: reference's ``make_ctx`` layouts); each family on both meshes, each
#: layout on both meshes, MLA under all three
SERVE_CASES = [
    ("deepseek-v3-671b", (2, 2), False, 4),
    ("deepseek-v3-671b", (2, 2), "model", 4),
    ("deepseek-v3-671b", (2, 4), ("data", "model"), 1),
    ("mamba2-1.3b", (2, 4), False, 4),
    ("mamba2-1.3b", (2, 2), ("data", "model"), 1),
    ("jamba-1.5-large-398b", (2, 4), "model", 4),
    ("jamba-1.5-large-398b", (2, 2), ("data", "model"), 1),
]
SERVE_IDS = [f"{a.split('-')[0]}-{s[0]}x{s[1]}-"
             + ("off" if not sp else "model" if sp == "model" else "dm")
             for a, s, sp, _ in SERVE_CASES]
BATCH, SEQ = 8, 16                  # train: 8 rows of 16 + 1 tokens
PROMPT, STEPS, MAX_LEN = 13, 4, 16


def tokens(vocab, batch=BATCH):
    """(train tokens, a prompt of ``batch`` rows, the decode steps')."""
    rng = np.random.default_rng(23)
    return (rng.integers(0, vocab, (BATCH, SEQ + 1)).astype(np.int32),
            rng.integers(0, vocab, (batch, PROMPT)).astype(np.int32),
            rng.integers(0, vocab, (STEPS, batch)).astype(np.int32))


def spec_json(spec) -> list:
    """A partition spec as JSON: None, an axis name, or a list of them."""
    return [list(e) if isinstance(e, tuple) else e for e in spec]


_SUBPROC = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
sys.path.insert(0, os.environ["TEST_DIR"])
import test_torch_spmd_families as T
from repro.configs.registry import get_smoke
from repro.launch.mesh import make_mesh
from repro.models.model_zoo import build_model
from repro.optim import adamw
from repro.runtime import serve as rs, train as rt
from repro.sharding.rules import ShardCtx, default_rules, partition_tree

devs = jax.devices()
assert len(devs) == 8, devs
out = {}
models = {}
part = json.loads(sys.argv[1])


def model_of(arch):
    # the reference's model and its seeded fp32 weights (its jitted
    # init_params: the same draws, faster), written out for the port
    if arch not in models:
        model = build_model(get_smoke(arch))
        p0 = jax.tree.map(lambda a: a.astype(jnp.float32),
                          jax.jit(model.init_params)(jax.random.key(0)))
        for k, v in flat(p0).items():
            out[f"w{arch}|{k}"] = v
        models[arch] = model, p0
    return models[arch]


def mesh_of(shape):
    return make_mesh(shape, ("data", "model"),
                     devices=devs[:int(np.prod(shape))])


def flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def specs_json(tree):
    return {jax.tree_util.keystr(p): T.spec_json(s) for p, s in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, P))[0]}


for i in part["train"]:
    arch, shape = T.TRAIN_CASES[i]
    model, p0 = model_of(arch)
    mesh = mesh_of(shape)
    ctx = ShardCtx(mesh=mesh, pod_axis=None)
    ocfg = adamw.AdamWConfig(**T.OPT)
    psh = jax.tree.map(lambda s: NamedSharding(mesh, s), partition_tree(
        model.specs(), default_rules(ctx, mode="train"), mesh))
    p1 = jax.tree.map(jax.device_put, p0, psh)
    o1 = adamw.init_state(p1, ocfg)
    toks = T.tokens(model.cfg.vocab_size)[0]
    p2, o2, m = rt.jit_train_step(model, ocfg, ctx, donate=False)(
        p1, o1, {"tokens": jnp.asarray(toks)})
    for k in ("loss", "aux", "grad_norm"):
        out[f"t{i}_{k}"] = np.asarray(m[k])
    for k, v in flat(p2).items():
        out[f"t{i}_p{k}"] = v
    for k, v in flat(o2["m"]).items():
        out[f"t{i}_m{k}"] = v

for i in part["serve"]:
    arch, shape, sp, b = T.SERVE_CASES[i]
    model, p0 = model_of(arch)
    mesh = mesh_of(shape)
    ctx = ShardCtx(mesh=mesh, pod_axis=None, seq_shard_kv=sp)
    rules = default_rules(ctx, mode="serve")
    out[f"s{i}_place"] = np.array(json.dumps({
        "params": specs_json(partition_tree(model.specs(), rules, mesh)),
        "cache": specs_json(partition_tree(
            model.cache_specs(b, T.MAX_LEN), rules, mesh))}))
    psh, csh = rs.serve_shardings(model, ctx, b, T.MAX_LEN)
    nb = mesh.shape["data"]
    tok_sh = NamedSharding(mesh, P(*T.tok_spec(ctx.batch_axes, nb, b, 2)))
    pos_sh = NamedSharding(mesh, P(*T.tok_spec(ctx.batch_axes, nb, b, 1)))
    params = jax.tree.map(jax.device_put, p0, psh)
    cache = jax.tree.map(
        lambda a, s: jax.device_put(a.astype(jnp.float32) if a.dtype ==
                                    jnp.bfloat16 else a, s),
        model.init_cache(b, T.MAX_LEN), csh)
    pre = jax.jit(rs.make_prefill_step(model, ctx),
                  in_shardings=(psh, tok_sh, tok_sh, csh),
                  out_shardings=(None, csh))
    dec = jax.jit(rs.make_decode_step(model, ctx),
                  in_shardings=(psh, tok_sh, pos_sh, csh),
                  out_shardings=(None, csh))
    _, prompt, steps = T.tokens(model.cfg.vocab_size, b)
    pos = np.tile(np.arange(T.PROMPT, dtype=np.int32), (b, 1))
    lg, cache = pre(params, jnp.asarray(prompt), jnp.asarray(pos), cache)
    out[f"s{i}_logits0"] = np.asarray(lg)
    for j in range(T.STEPS):
        q = np.full((b,), T.PROMPT + j, np.int32)
        lg, cache = dec(params, jnp.asarray(steps[j][:, None]),
                        jnp.asarray(q), cache)
        out[f"s{i}_logits{j + 1}"] = np.asarray(lg)
    for q, v in jax.tree_util.tree_flatten_with_path(cache)[0]:
        out[f"s{i}_c{jax.tree_util.keystr(q)}"] = np.asarray(v)
np.savez(sys.argv[2], **out)
"""


#: the cases each reference subprocess runs: their compiles take ~25 s
#: (deepseek's train step), ~30 s (mamba2's and jamba's) and ~45 s (the
#: serve steps) on 8 host devices
_PARTS = ({"train": [0], "serve": []}, {"train": [1, 2], "serve": []},
          {"train": [], "serve": list(range(len(SERVE_CASES)))})


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's steps of the three families on 8 forced host
    devices, in subprocesses run side by side (:data:`_PARTS`), and the
    seeded weights they drew."""
    d = tmp_path_factory.mktemp("spmd_families")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               TEST_DIR=os.path.dirname(__file__))
    procs = {j: subprocess.Popen(
        [sys.executable, "-c", _SUBPROC, json.dumps(part),
         str(d / f"{j}.npz")], env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True) for j, part in enumerate(_PARTS)}
    out = {}
    for j, proc in procs.items():
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-4000:]
        out.update(np.load(d / f"{j}.npz"))
    return out


def port_model(ref, arch):
    """The port's model on the CPU holding the reference's seeded fp32
    weights (those the subprocesses drew)."""
    specs = jax_build_model(jax_get_smoke(arch)).specs()
    tree = jax.tree_util.tree_map_with_path(
        lambda q, _: ref[f"w{arch}|{jax.tree_util.keystr(q)}"], specs)
    return convert.params_from_numpy(tree, get_smoke(arch), device="cpu")


def _flat(tree) -> dict:
    out = {}
    map_with_path(lambda path, a: out.__setitem__(key(path), a), tree)
    return out


@pytest.mark.parametrize("case", range(len(TRAIN_CASES)), ids=TRAIN_IDS)
def test_train_step_matches_reference(ref, case):
    """``jit_train_step`` on a placed model: the loss, the aux losses
    (deepseek's MTP block's among them) and the grad norm, the updated
    parameters and first moments against the reference's partitioned
    step; every replica ``torch.equal``."""
    arch, shape = TRAIN_CASES[case]
    model = port_model(ref, arch)
    ctx = ctx_of(cpu_mesh(shape))
    ocfg = adamw.AdamWConfig(**OPT)
    placed = rt.placed_params(model, ctx)
    opt = adamw.init_state(placed, ocfg)
    toks = torch.from_numpy(tokens(model.cfg.vocab_size)[0]).long()
    p2, o2, m = rt.jit_train_step(model, ocfg, ctx, donate=False)(
        placed, opt, {"tokens": toks})
    for k in ("loss", "aux", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(ref[f"t{case}_{k}"]),
                                   rtol=1e-5, err_msg=k)
    for label, got in (("p", _flat_port(p2, model)),
                       ("m", _flat_port(o2["m"], model))):
        for k, a in got.items():
            np.testing.assert_allclose(a, ref[f"t{case}_{label}{k}"],
                                       err_msg=f"{label} {k}", **TOL)
    for p in list(p2.values()) + list(o2["m"].values()):
        named = spmd.spec_axes(p.spec)
        rank = {c: r for r, c in enumerate(p.mesh.coords())}
        for c, blk in zip(p.mesh.coords(), p.blocks):
            home = tuple(i if a in named else 0
                         for a, i in zip(p.mesh.axis_names, c))
            assert torch.equal(blk, p.blocks[rank[home]])


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_and_dense_moe_match_unsharded(ref, arch):
    """The train step on a 2 x 4 mesh with remat (deepseek's MTP block
    recomputed too) and the MoE's dense path (whose shared expert is added
    once, ROADMAP F19) against the port's unsharded step: the loss, the
    aux losses and the grad norm rtol 1e-5, the updated parameters
    rtol/atol 1e-5."""
    model = port_model(ref, arch)
    ctx = ctx_of(cpu_mesh((2, 4)), moe_impl="dense", remat=True)
    ocfg = adamw.AdamWConfig(**OPT)
    placed = rt.placed_params(model, ctx)
    toks = torch.from_numpy(tokens(model.cfg.vocab_size)[0]).long()
    p2, _, m = rt.jit_train_step(model, ocfg, ctx, donate=False)(
        placed, adamw.init_state(placed, ocfg), {"tokens": toks})
    params = rt.train_params(model)
    _, _, m0 = rt.jit_train_step(model, ocfg, ShardCtx())(
        params, adamw.init_state(params, ocfg), {"tokens": toks})
    for k in ("loss", "aux", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(m0[k]), rtol=1e-5,
                                   err_msg=k)
    for n, p in p2.items():
        torch.testing.assert_close(spmd.gather(p), params[n].detach(),
                                   msg=n, **TOL)


@pytest.mark.parametrize("case", range(len(SERVE_CASES)), ids=SERVE_IDS)
def test_serve_steps_match_reference(ref, case):
    """``init_cache``, ``jit_prefill_step`` and ``jit_decode_step`` on a
    placed model: every parameter's and cache leaf's partition spec ``==``
    the reference's ``partition_tree``; the logits of the prefill and of
    every decode step, and the gathered cache at the end (its ``pos``
    ``==``), against the reference's partitioned steps; the logits beside
    the port's unsharded steps where no MoE drops pairs."""
    arch, shape, sp, b = SERVE_CASES[case]
    model = port_model(ref, arch)
    ctx = ctx_of(cpu_mesh(shape), seq_shard_kv=sp)
    params = rt.placed_params(model, ctx, mode="serve")
    cache = tserve.init_cache(model, ctx, b, MAX_LEN, dtype=torch.float32)
    want = json.loads(str(ref[f"s{case}_place"]))
    params_sh, _ = tserve.serve_shardings(model, ctx, b, MAX_LEN)
    got = {"params": {k: spec_json(s.spec)
                      for k, s in _flat(params_sh).items()},
           "cache": {k: spec_json(x.spec) for k, x in _flat(cache).items()}}
    assert got == want
    for n, sh in spmd.named_shardings(model, params_sh).items():
        assert params[n].spec == sh.spec, n
    _, prompt, steps = tokens(model.cfg.vocab_size, b)
    prompt = torch.from_numpy(prompt).long()
    pos = torch.arange(PROMPT)[None].expand(b, -1)
    cache0 = model.init_cache(b, MAX_LEN, dtype=torch.float32)
    calls = [(tserve.jit_prefill_step(model, ctx, b, MAX_LEN),
              tserve.make_prefill_step(model, ShardCtx()))]
    got = [calls[0][0](params, prompt, pos, cache)[0]]
    mine = [calls[0][1](prompt, pos, cache0)[0]]
    dec = tserve.jit_decode_step(model, ctx, b, MAX_LEN)
    dec0 = tserve.make_decode_step(model, ShardCtx())
    for j in range(STEPS):
        t = torch.from_numpy(steps[j][:, None]).long()
        q = torch.full((b,), PROMPT + j)
        got.append(dec(params, t, q, cache)[0])
        mine.append(dec0(t, q, cache0)[0])
    for j, (a, u) in enumerate(zip(got, mine)):
        assert bool(torch.isfinite(a).all()), f"step {j}"
        np.testing.assert_allclose(a.numpy(), ref[f"s{case}_logits{j}"],
                                   err_msg=f"step {j}", **LOGIT_TOL)
        if model.cfg.moe is None:   # the sharded MoE drops what dense keeps
            np.testing.assert_allclose(a.numpy(), u.numpy(),
                                       err_msg=f"step {j}", **LOGIT_TOL)
    for k, a in _flat(spmd.gather_tree(cache)).items():
        w = ref[f"s{case}_c{k}"]
        if k.endswith("['pos']"):
            np.testing.assert_array_equal(a.numpy(), w)
        else:
            np.testing.assert_allclose(a.numpy(), w, err_msg=k, **LOGIT_TOL)


def _mamba_weights(cfg, seed=3):
    """A Mamba mixer's weights (fp32, non-trivial norm scale)."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, spec in mamba2.mamba_specs(cfg).items():
        out[name] = torch.randn(spec.shape, generator=g) * 0.2
    out["norm"] = 1 + out["norm"]
    out["A_log"] = out["A_log"].abs()
    return out


@pytest.mark.parametrize("shape", ((1, 2), (1, 4)), ids=str)
def test_gated_norm_over_the_whole_inner_dim(shape):
    """``mamba_placed`` on blocks of the inner channels and heads ``==``
    (within 2e-6) the whole mixer in every mode, the gated norm's sum of
    squares summed over the model axis; the norm over each block's own
    channels alone (the fault the sum guards against) is far off."""
    cfg = get_smoke("mamba2-1.3b")
    mesh = cpu_mesh(shape)
    ctx = ctx_of(mesh)
    m = shape[1]
    w = _mamba_weights(cfg)
    assert mamba2.check_split(cfg, ctx)
    spec = {n: s.axes for n, s in mamba2.mamba_specs(cfg).items()}
    ws = [{} for _ in range(m)]
    for n, t in w.items():
        dim = next((i for i, a in enumerate(spec[n])
                    if a in ("inner", "heads")), None)
        for r in range(m):
            ws[r][n] = t if dim is None else t.chunk(m, dim)[r]
    per = mamba2.dims(cfg)[1] // m
    first = [r * per for r in range(m)]
    x = torch.randn(2, 11, cfg.d_model,
                    generator=torch.Generator().manual_seed(4))
    whole = mamba2.mamba_forward(w, x, cfg)
    ys = mamba2.mamba_placed([x] * m, ws, cfg, mode="train", views=None,
                             first=first, mesh=mesh, model_axis="model",
                             split=True)
    got = spmd.psum(ys, mesh, "model")[0]
    torch.testing.assert_close(got, whole, rtol=2e-6, atol=2e-6)
    local = sum(torch.einsum("bsi,id->bsd", rms_norm(
        wr["norm"], mamba2._scan(wr, x, cfg, f)[0], cfg.norm_eps),
        wr["out_proj"]) for wr, f in zip(ws, first))
    assert float((local - whole).abs().max()) > 1e-3
    cache = {k: torch.zeros(s.shape) for k, s in
             mamba2.mamba_cache_specs(cfg, 2).items()}
    mamba2.mamba_prefill(w, x, cfg, cache)
    views = [{k: (t if k in ("conv_B", "conv_C")
                  else t.chunk(m, 2 if k == "conv_x" else 1)[r]).clone()
              for k, t in cache.items()} for r in range(m)]
    x1 = x[:, -1:] * 0.5
    whole, _ = mamba2.mamba_decode(w, x1, cfg, cache)
    ys = mamba2.mamba_placed([x1] * m, ws, cfg, mode="decode", views=views,
                             first=first, mesh=mesh, model_axis="model",
                             split=True)
    torch.testing.assert_close(spmd.psum(ys, mesh, "model")[0], whole,
                               rtol=2e-6, atol=2e-6)
    torch.testing.assert_close(torch.cat([v["ssm"] for v in views], 1),
                               cache["ssm"], rtol=2e-6, atol=2e-6)
    assert torch.equal(torch.cat([v["conv_x"] for v in views], 2),
                       cache["conv_x"])


@pytest.mark.parametrize("heads,groups,blocks", [
    (256, 8, 2),        # whole groups a block (jamba at m = 2)
    (64, 1, 2),         # one group two blocks share (mamba2-1.3b at m = 2)
    (16, 2, 4),         # mamba2-smoke at m = 4
    (16, 2, 2),         # one whole group a block
    (12, 4, 3),         # 4 heads a block over groups of 3: a head a group
])
def test_heads_groups_selects_each_blocks_groups(heads, groups, blocks):
    """``heads_groups``: each block of heads gets B and C columns such that
    its head i reads, at group i // (n / G'), the group head first + i
    reads whole (j // (heads / groups)); a run of whole groups or a shared
    group is a slice of the whole."""
    n_st = 3
    g = torch.Generator().manual_seed(heads + groups)
    B_ = torch.randn(2, 5, groups, n_st, generator=g)
    C_ = torch.randn(2, 5, groups, n_st, generator=g)
    hl = heads // blocks
    for j in range(blocks):
        first = j * hl
        b_loc, c_loc = mamba2.heads_groups(B_, C_, first, hl, heads)
        gl = b_loc.shape[2]
        assert hl % gl == 0
        for i in range(hl):
            want = (first + i) // (heads // groups)
            assert torch.equal(b_loc[:, :, i // (hl // gl)], B_[:, :, want])
            assert torch.equal(c_loc[:, :, i // (hl // gl)], C_[:, :, want])
        if hl % (heads // groups) == 0 or (heads // groups) % hl == 0:
            assert b_loc._base is B_                     # a slice


def test_inner_and_heads_split_unalike_raise():
    """A Mamba mixer whose inner channels split over the model axis while
    its heads do not (2 heads of 64 channels on 4 coordinates) raises
    ``ValueError`` naming the leaf, when a step or a cache is built and
    when a placed forward runs; both split alike on 2 coordinates."""
    cfg = get_smoke("mamba2-1.3b")
    cfg = cfg.scaled(ssm=dataclasses.replace(cfg.ssm, head_dim=64))
    assert mamba2.dims(cfg)[:2] == (128, 2)
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    model.init_params(torch.Generator().manual_seed(0))
    ctx = ctx_of(cpu_mesh((1, 4)))
    for build in (lambda: rt.jit_train_step(model, adamw.AdamWConfig(), ctx),
                  lambda: tserve.jit_decode_step(model, ctx, 2, 8),
                  lambda: tserve.init_cache(model, ctx, 2, 8)):
        with pytest.raises(ValueError, match="mamba leaf .*heads"):
            build()
    params = rt.placed_params(model, ctx)
    tok = spmd.place(torch.zeros(2, 5, dtype=torch.long),
                     NamedSharding(ctx.mesh, P(ctx.batch_axes, None)))
    pos = tok.map(lambda t: torch.arange(5)[None].expand(2, 5))
    with pytest.raises(ValueError, match="mamba leaf"):
        model.forward(tok, pos, ctx, params=params)
    assert mamba2.check_split(cfg, ctx_of(cpu_mesh((2, 2))))
    assert not mamba2.check_split(cfg, ctx_of(cpu_mesh((1, 3))))


@pytest.mark.parametrize("arch", ARCHS)
def test_model_to_meta_frees_the_mixers_weights(arch):
    """Once placed, a model's own parameters go to the meta device: no
    old parameter stays alive (the MLA, Mamba-2 and MoE modules' cached
    trees are rebuilt on the new ones, ROADMAP F20) and every tree's
    leaf is on meta."""
    import gc
    import weakref
    model = build_model(get_smoke(arch), device="cpu", dtype=torch.float32)
    old = [weakref.ref(p) for p in model.parameters()]
    model.to("meta")
    gc.collect()
    assert not [r for r in old if r() is not None]
    trees = [m.tree for m in model.modules() if "tree" in m.__dict__]
    assert trees
    leaves = []
    spmd.map_tree(leaves.append, trees)
    assert all(t.device.type == "meta" for t in leaves)
