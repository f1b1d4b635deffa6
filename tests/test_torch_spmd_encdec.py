"""The encoder-decoder and the vision frontend on a mesh: whisper-small's
and internvl2-26b's smoke configs placed by the spec trees, their train,
prefill and decode steps (``models/encdec.py``'s placed runs,
``models/attention.py::cross_attn_placed``, ``models/transformer.py::
_mesh_run`` with placed ``embeds``) held against the reference's
partitioned steps, jitted with ``launch/dryrun.py::build_cell``'s
in-shardings (``batch_pspec``'s rule for the tokens, the positions and
the ``embeds``; the subprocess cannot import that module, which forces
512 host devices).

The reference's steps run once for the module in one subprocess under
``XLA_FLAGS=--xla_force_host_platform_device_count=8``, on the same numpy
tokens and frames and the same seeded fp32 weights (carried into the port
by ``models/convert.py``).  The reference initialises every bias (``bo``,
``bi``, ``bq``, ``bk``, ``bv``, the layer norms' ``bias``) to zeros, so a
bias added once a coordinate instead of once would pass unseen: the
subprocess draws each from a seeded normal before either package reads
it.  whisper runs the reference's ``models/encdec.py`` with its bf16 casts
read as fp32 (ROADMAP F15, ``tests/test_torch_encdec.py::ref_fp32``).

Tolerances, fp32, as ``tests/test_torch_spmd_families.py`` states them:
the loss and the grad norm rtol 1e-5; updated parameters and first
moments rtol/atol 1e-5 (AdamW at eps 1e-6); logits and the gathered
cache, the cross K/V included, rtol/atol 2e-5; every leaf's partition
spec and the cache's ``pos`` ``==``.
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
from repro_torch.models import convert
from repro_torch.optim import adamw
from repro_torch.runtime import serve as tserve
from repro_torch.runtime import train as rt
from repro_torch.sharding import spmd
from repro_torch.sharding.rules import ShardCtx
from test_torch_spmd import LR, _flat_port, cpu_mesh, ctx_of, key
from test_torch_spmd_families import _flat, spec_json
from test_torch_spmd_sp import tok_spec  # noqa: F401  (the subprocess's)

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
OPT = dict(LR, eps=1e-6)
TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=2e-5, atol=2e-5)
ARCHS = ("whisper-small", "internvl2-26b")
#: the names of the leaves the reference initialises to zeros
BIASES = ("['bo']", "['bi']", "['bq']", "['bk']", "['bv']", "['bias']")
#: (arch, mesh shape, microbatches): whisper's 4 heads split 2 ways,
#: internvl2's 4 query heads 4 ways over its 2 KV heads (replicated)
TRAIN_CASES = [("whisper-small", (2, 2), 2), ("internvl2-26b", (2, 4), 1)]
TRAIN_IDS = [f"{a.split('-')[0]}-{s[0]}x{s[1]}" for a, s, _ in TRAIN_CASES]
#: (arch, mesh shape, seq_shard_kv): whisper without SP (the cross K/V's
#: heads split) and with it over "model" (their frames split, the partials
#: merged), internvl2 with SP and without
SERVE_CASES = [("whisper-small", (2, 2), False),
               ("whisper-small", (2, 4), "model"),
               ("internvl2-26b", (2, 2), "model"),
               ("internvl2-26b", (2, 4), False)]
SERVE_IDS = [f"{a.split('-')[0]}-{s[0]}x{s[1]}-{'model' if sp else 'off'}"
             for a, s, sp in SERVE_CASES]
BATCH, SEQ, FRAMES = 8, 16, 24     # train: 8 rows of 16 + 1 tokens
SERVE_B, PROMPT, STEPS = 4, 5, 4
MAX_LEN = 20                        # decoder ring; 8 patches + 5 + 4 fit


def n_embeds(arch):
    """The ``embeds`` rows of ``arch``: whisper's encoder frames,
    internvl2's patch rows."""
    return FRAMES if arch == "whisper-small" else \
        get_smoke(arch).num_frontend_tokens


def inputs(arch, batch):
    """(tokens (batch, SEQ + 1), embeds, a prompt, the decode steps'
    tokens), seeded numpy."""
    cfg = get_smoke(arch)
    rng = np.random.default_rng(29)
    return (rng.integers(0, cfg.vocab_size, (batch, SEQ + 1)).astype(np.int32),
            (rng.standard_normal((batch, n_embeds(arch), cfg.d_model))
             * 0.5).astype(np.float32),
            rng.integers(0, cfg.vocab_size, (batch, PROMPT)).astype(np.int32),
            rng.integers(0, cfg.vocab_size, (STEPS, batch)).astype(np.int32))


def serve_shape(arch):
    """(positions of the prompt, the cache's ``enc_len`` keywords)."""
    if arch == "whisper-small":
        return PROMPT, {"enc_len": FRAMES}
    return n_embeds(arch) + PROMPT, {}


_SUBPROC = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
sys.path.insert(0, os.environ["TEST_DIR"])
import test_torch_spmd_encdec as T
from repro.configs.registry import get_smoke
from repro.launch.mesh import make_mesh
from repro.models import encdec
from repro.models.model_zoo import build_model
from repro.optim import adamw
from repro.runtime import serve as rs, train as rt
from repro.sharding.rules import ShardCtx, default_rules, partition_tree


class F32:                      # the reference's bf16 casts read as fp32
    bfloat16 = jnp.float32

    def __getattr__(self, name):
        return getattr(jnp, name)


def batch_pspec(ctx, b, ndim):     # launch/dryrun.py's rule
    return P(*T.tok_spec(ctx.batch_axes, ctx.mesh.shape["data"], b, ndim))


encdec.jnp = F32()
devs = jax.devices()
assert len(devs) == 8, devs
out = {}
models = {}


def flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def model_of(arch):
    # the reference's model and its seeded fp32 weights, every bias drawn
    # nonzero, written out for the port
    if arch not in models:
        model = build_model(get_smoke(arch))
        p0 = jax.tree.map(lambda a: a.astype(jnp.float32),
                          jax.jit(model.init_params)(jax.random.key(0)))
        rng = np.random.default_rng(5)

        def bias(path, a):
            if jax.tree_util.keystr(path).endswith(T.BIASES):
                return jnp.asarray(rng.standard_normal(a.shape) * 0.1,
                                   jnp.float32)
            return a
        p0 = jax.tree_util.tree_map_with_path(bias, p0)
        for k, v in flat(p0).items():
            out[f"w{arch}|{k}"] = v
        models[arch] = model, p0
    return models[arch]


def mesh_of(shape):
    return make_mesh(shape, ("data", "model"),
                     devices=devs[:int(np.prod(shape))])


def specs_json(tree):
    return {jax.tree_util.keystr(p): T.spec_json(s) for p, s in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, P))[0]}


def shardings(tree, mesh):
    return jax.tree.map(lambda s: NamedSharding(mesh, s), tree,
                        is_leaf=lambda x: isinstance(x, P))


for i, (arch, shape, mb) in enumerate(T.TRAIN_CASES):
    model, p0 = model_of(arch)
    mesh = mesh_of(shape)
    ctx = ShardCtx(mesh=mesh, pod_axis=None)
    ocfg = adamw.AdamWConfig(**T.OPT)
    psh = shardings(partition_tree(model.specs(),
                                   default_rules(ctx, mode="train"), mesh),
                    mesh)
    osh = {"step": NamedSharding(mesh, P()), "master": psh, "m": psh,
           "v": psh}
    bsh = {"tokens": NamedSharding(mesh, batch_pspec(ctx, T.BATCH, 2)),
           "embeds": NamedSharding(mesh, batch_pspec(ctx, T.BATCH, 3))}
    p1 = jax.tree.map(jax.device_put, p0, psh)
    o1 = adamw.init_state(p1, ocfg)
    toks, emb, _, _ = T.inputs(arch, T.BATCH)
    step = jax.jit(rt.make_train_step(model, ocfg, ctx, microbatches=mb),
                   in_shardings=(psh, osh, bsh),
                   out_shardings=(psh, osh, None))
    p2, o2, m = step(p1, o1, {"tokens": jnp.asarray(toks),
                              "embeds": jnp.asarray(emb)})
    for k in ("loss", "aux", "grad_norm"):
        out[f"t{i}_{k}"] = np.asarray(m[k])
    for k, v in flat(p2).items():
        out[f"t{i}_p{k}"] = v
    for k, v in flat(o2["m"]).items():
        out[f"t{i}_m{k}"] = v

for i, (arch, shape, sp) in enumerate(T.SERVE_CASES):
    model, p0 = model_of(arch)
    mesh = mesh_of(shape)
    ctx = ShardCtx(mesh=mesh, pod_axis=None, seq_shard_kv=sp)
    b = T.SERVE_B
    n_pos, kw = T.serve_shape(arch)
    rules = default_rules(ctx, mode="serve")
    out[f"s{i}_place"] = np.array(json.dumps({
        "params": specs_json(partition_tree(model.specs(), rules, mesh)),
        "cache": specs_json(partition_tree(
            model.cache_specs(b, T.MAX_LEN, **kw), rules, mesh))}))
    psh, csh = rs.serve_shardings(model, ctx, b, T.MAX_LEN, **kw)
    tok_sh = NamedSharding(mesh, batch_pspec(ctx, b, 2))
    pos_sh = NamedSharding(mesh, batch_pspec(ctx, b, 1))
    emb_sh = NamedSharding(mesh, batch_pspec(ctx, b, 3))
    params = jax.tree.map(jax.device_put, p0, psh)
    cache = jax.tree.map(
        lambda a, s: jax.device_put(a.astype(jnp.float32) if a.dtype ==
                                    jnp.bfloat16 else a, s),
        model.init_cache(b, T.MAX_LEN, **kw), csh)
    pre = jax.jit(rs.make_prefill_step(model, ctx),
                  in_shardings=(psh, tok_sh, tok_sh, csh, emb_sh),
                  out_shardings=(None, csh))
    dec = jax.jit(rs.make_decode_step(model, ctx),
                  in_shardings=(psh, tok_sh, pos_sh, csh),
                  out_shardings=(None, csh))
    _, emb, prompt, steps = T.inputs(arch, b)
    pos = np.tile(np.arange(n_pos, dtype=np.int32), (b, 1))
    lg, cache = pre(params, jnp.asarray(prompt), jnp.asarray(pos), cache,
                    jnp.asarray(emb))
    out[f"s{i}_logits0"] = np.asarray(lg)
    for j in range(T.STEPS):
        q = np.full((b,), n_pos + j, np.int32)
        lg, cache = dec(params, jnp.asarray(steps[j][:, None]),
                        jnp.asarray(q), cache)
        out[f"s{i}_logits{j + 1}"] = np.asarray(lg)
    for q, v in jax.tree_util.tree_flatten_with_path(cache)[0]:
        out[f"s{i}_c{jax.tree_util.keystr(q)}"] = np.asarray(v)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's steps of both families on 8 forced host devices,
    in one subprocess, and the seeded weights (biases nonzero) it drew."""
    path = tmp_path_factory.mktemp("spmd_encdec") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               TEST_DIR=os.path.dirname(__file__))
    proc = subprocess.run([sys.executable, "-c", _SUBPROC, str(path)],
                          env=env, stdout=subprocess.DEVNULL,
                          stderr=subprocess.PIPE, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(path))


def port_model(ref, arch):
    """The port's model on the CPU holding the reference's seeded fp32
    weights (those the subprocess drew)."""
    specs = jax_build_model(jax_get_smoke(arch)).specs()
    tree = jax.tree_util.tree_map_with_path(
        lambda q, _: ref[f"w{arch}|{jax.tree_util.keystr(q)}"], specs)
    return convert.params_from_numpy(tree, get_smoke(arch), device="cpu")


def test_every_bias_is_nonzero(ref):
    """Each bias leaf of both models (the attention's ``bo``, ``bq``,
    ``bk``, ``bv``, the gelu MLP's ``bi`` and ``bo``, the layer norms'
    ``bias``) reaches the port nonzero: an extra or a missing copy of one
    moves the steps' results."""
    for arch in ARCHS:
        model = port_model(ref, arch)
        names = [n for n, _ in model.named_parameters()
                 if n.rsplit(".", 1)[-1] in ("bo", "bi", "bq", "bk", "bv",
                                             "bias")]
        if arch == "whisper-small":
            assert {n.rsplit(".", 1)[-1] for n in names} == {
                "bo", "bi", "bq", "bk", "bv", "bias"}
        for n in names:
            assert bool((dict(model.named_parameters())[n] != 0).all()), n


@pytest.mark.parametrize("case", range(len(TRAIN_CASES)), ids=TRAIN_IDS)
def test_train_step_matches_reference(ref, case):
    """``jit_train_step`` on a placed model with the batch's ``embeds``
    (whisper's frames feed its encoder; internvl2's patch rows go first
    and carry no loss): the loss, the aux and the grad norm, the updated
    parameters and first moments against the reference's partitioned
    step; every replica ``torch.equal``."""
    arch, shape, mb = TRAIN_CASES[case]
    model = port_model(ref, arch)
    ctx = ctx_of(cpu_mesh(shape))
    ocfg = adamw.AdamWConfig(**OPT)
    placed = rt.placed_params(model, ctx)
    opt = adamw.init_state(placed, ocfg)
    toks, emb, _, _ = inputs(arch, BATCH)
    batch = {"tokens": torch.from_numpy(toks).long(),
             "embeds": torch.from_numpy(emb)}
    p2, o2, m = rt.jit_train_step(model, ocfg, ctx, microbatches=mb,
                                  donate=False)(placed, opt, batch)
    for k in ("loss", "aux", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(ref[f"t{case}_{k}"]),
                                   rtol=1e-5, err_msg=k)
    for label, got in (("p", _flat_port(p2, model)),
                       ("m", _flat_port(o2["m"], model))):
        for k, a in got.items():
            np.testing.assert_allclose(a, ref[f"t{case}_{label}{k}"],
                                       err_msg=f"{label} {k}", **TOL)
    for p in list(p2.values()) + list(o2["m"].values()):
        home = spmd.home_ranks(p.mesh, p.spec)
        assert all(torch.equal(b, p.blocks[h])
                   for b, h in zip(p.blocks, home))


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_matches_unsharded(ref, arch):
    """The train step on a 2 x 4 mesh with remat (the encoder's and the
    decoder's blocks recomputed, the encoder's states an input of every
    decoder block's recompute) and 2 microbatches against the port's
    unsharded step: the loss and the grad norm rtol 1e-5, the updated
    parameters rtol/atol 1e-5."""
    model = port_model(ref, arch)
    ctx = ctx_of(cpu_mesh((2, 4)), remat=True)
    ocfg = adamw.AdamWConfig(**OPT)
    placed = rt.placed_params(model, ctx)
    toks, emb, _, _ = inputs(arch, BATCH)
    batch = {"tokens": torch.from_numpy(toks).long(),
             "embeds": torch.from_numpy(emb)}
    p2, _, m = rt.jit_train_step(model, ocfg, ctx, microbatches=2,
                                 donate=False)(
        placed, adamw.init_state(placed, ocfg), batch)
    params = rt.train_params(model)
    _, _, m0 = rt.jit_train_step(model, ocfg, ShardCtx(remat=True),
                                 microbatches=2)(
        params, adamw.init_state(params, ocfg), batch)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(m0[k]), rtol=1e-5,
                                   err_msg=k)
    for n, p in p2.items():
        torch.testing.assert_close(spmd.gather(p), params[n].detach(),
                                   msg=n, **TOL)


@pytest.mark.parametrize("case", range(len(SERVE_CASES)), ids=SERVE_IDS)
def test_serve_steps_match_reference(ref, case):
    """``init_cache`` (``enc_len`` for whisper), ``jit_prefill_step`` with
    ``embeds`` and ``jit_decode_step`` on a placed model: every
    parameter's and cache leaf's partition spec ``==`` the reference's
    ``partition_tree`` (whisper's cross K/V split on their frames under
    SP, on their KV heads without it); the logits of the prefill and of
    every decode step, and the gathered cache at the end (the cross K/V
    among it; its ``pos`` ``==``), against the reference's partitioned
    steps and beside the port's unsharded steps."""
    arch, shape, sp = SERVE_CASES[case]
    model = port_model(ref, arch)
    ctx = ctx_of(cpu_mesh(shape), seq_shard_kv=sp)
    b = SERVE_B
    n_pos, kw = serve_shape(arch)
    params = rt.placed_params(model, ctx, mode="serve")
    cache = tserve.init_cache(model, ctx, b, MAX_LEN, dtype=torch.float32,
                              **kw)
    want = json.loads(str(ref[f"s{case}_place"]))
    got = {"params": {k: spec_json(s.spec) for k, s in _flat(
        tserve.serve_shardings(model, ctx, b, MAX_LEN, **kw)[0]).items()},
           "cache": {k: spec_json(x.spec) for k, x in _flat(cache).items()}}
    assert got == want
    _, emb, prompt, steps = inputs(arch, b)
    emb = torch.from_numpy(emb)
    prompt = torch.from_numpy(prompt).long()
    pos = torch.arange(n_pos)[None].expand(b, -1)
    cache0 = model.init_cache(b, MAX_LEN, dtype=torch.float32, **kw)
    got = [tserve.jit_prefill_step(model, ctx, b, MAX_LEN, **kw)(
        params, prompt, pos, cache, emb)[0]]
    mine = [tserve.make_prefill_step(model, ShardCtx())(
        prompt, pos, cache0, emb)[0]]
    dec = tserve.jit_decode_step(model, ctx, b, MAX_LEN, **kw)
    dec0 = tserve.make_decode_step(model, ShardCtx())
    for j in range(STEPS):
        t = torch.from_numpy(steps[j][:, None]).long()
        q = torch.full((b,), n_pos + j)
        got.append(dec(params, t, q, cache)[0])
        mine.append(dec0(t, q, cache0)[0])
    for j, (a, u) in enumerate(zip(got, mine)):
        assert bool(torch.isfinite(a).all()), f"step {j}"
        np.testing.assert_allclose(a.numpy(), ref[f"s{case}_logits{j}"],
                                   err_msg=f"step {j}", **LOGIT_TOL)
        np.testing.assert_allclose(a.numpy(), u.numpy(),
                                   err_msg=f"step {j}", **LOGIT_TOL)
    whole = _flat(spmd.gather_tree(cache))
    if arch == "whisper-small":
        assert {"['cross_k']", "['cross_v']"} <= set(whole)
    for k, a in whole.items():
        w = ref[f"s{case}_c{k}"]
        if k.endswith("['pos']"):
            np.testing.assert_array_equal(a.numpy(), w)
        else:
            np.testing.assert_allclose(a.numpy(), w, err_msg=k, **LOGIT_TOL)


def test_bias_once_after_the_sum():
    """``transformer.mesh_mlp`` on whisper's gelu MLP split over a 4-way
    model axis ``==`` (within 2e-6) the whole MLP, ``bo`` added once after
    the ``psum``; each coordinate adding it before the sum is off by
    three copies of ``bo``."""
    from repro_torch.models import transformer as tr
    from repro_torch.models.layers import apply_mlp, mlp_specs
    from repro_torch.sharding.rules import NamedSharding, P
    cfg = get_smoke("whisper-small")
    ctx = ctx_of(cpu_mesh((1, 4)))
    g = torch.Generator().manual_seed(2)
    w = {n: torch.randn(s.shape, generator=g) * 0.2
         for n, s in mlp_specs(cfg, cfg.d_ff).items()}
    bp = {f"ffn.{n}": spmd.place(t, NamedSharding(ctx.mesh, P(*(
        "model" if a == "ff" else None for a in s.axes))))
          for (n, t), s in zip(w.items(), mlp_specs(cfg, cfg.d_ff).values())}
    x = torch.randn(2, 5, cfg.d_model, generator=g)
    whole = apply_mlp(x, **w)
    got = tr.mesh_mlp(bp, "ffn.", [x] * 4, ctx)
    for y in got:
        torch.testing.assert_close(y, whole, rtol=2e-6, atol=2e-6)
    twice = spmd.psum([apply_mlp(x, **{n: t.blocks[r] for n, t in (
        (k[4:], v) for k, v in bp.items())}) for r in range(4)],
        ctx.mesh, "model")[0]
    torch.testing.assert_close(twice - whole, 3 * w["bo"].expand_as(whole),
                               rtol=1e-5, atol=1e-5)


def test_cross_attention_partials_match_the_whole():
    """``attention.cross_attn_placed`` on blocks of the encoder's frames
    (SP over a 4-way model axis, every KV head a block) and on blocks of
    the heads against ``cross_attn_forward`` over every frame, summed over
    the model axis: rtol/atol 2e-5, the logits' (the output projection
    summed in another order)."""
    from repro_torch.models import attention as attn
    from repro_torch.models.model_zoo import build_model
    cfg = get_smoke("whisper-small")
    mesh = cpu_mesh((1, 4))
    g = torch.Generator().manual_seed(6)
    mixer = build_model(cfg, device="cpu", dtype=torch.float32) \
        .dec_blocks[0].cross
    with torch.no_grad():
        for p in mixer.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.3)
    x = torch.randn(2, 3, cfg.d_model, generator=g)
    enc = torch.randn(2, FRAMES, cfg.d_model, generator=g)
    k, v = attn.encode_cross_kv(mixer, enc)
    whole = attn.cross_attn_forward(mixer, x, (k, v)) - mixer.bo
    hl = cfg.num_heads // 4
    heads = [{"wq": mixer.wq[:, r * hl:(r + 1) * hl],
              "bq": mixer.bq[r * hl:(r + 1) * hl],
              "wo": mixer.wo[r * hl:(r + 1) * hl]} for r in range(4)]
    first = [r * hl for r in range(4)]
    by_heads = attn.cross_attn_placed(
        [x] * 4, heads, cfg,
        [(k[:, :, r * hl:(r + 1) * hl], v[:, :, r * hl:(r + 1) * hl])
         for r in range(4)], q_first=first, mesh=mesh, model_axis="model")
    fl = FRAMES // 4
    by_frames = attn.cross_attn_placed(
        [x] * 4, heads, cfg,
        [(k[:, r * fl:(r + 1) * fl], v[:, r * fl:(r + 1) * fl])
         for r in range(4)], q_first=first, mesh=mesh, model_axis="model",
        seq_axes="model")
    for ys in (by_heads, by_frames):
        torch.testing.assert_close(spmd.psum(ys, mesh, "model")[0], whole,
                                   **LOGIT_TOL)
