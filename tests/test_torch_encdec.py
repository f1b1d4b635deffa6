"""The port's encoder-decoder (whisper) and vision-frontend (internvl2)
families held against the reference on the smoke configs: ``sinusoid``,
the cross-attention, ``EncDec``'s encode, forward, prefill (the cache leaf
for leaf) and decode, the serving steps with embeds, the training loss and
its gradients, the frontend's shapes, the full configs' parameter counts
without allocating, and the converters both ways.

The reference's ``EncDec.encode`` casts the frames to bf16, which its
scanned encoder cannot carry with fp32 weights (ROADMAP F15).  So the fp32
comparisons run the reference's own ``models/encdec.py`` with its
``jnp.bfloat16`` read as fp32 (``ref_fp32``); the declared dtypes (bf16
weights) run it unchanged, at bf16's tolerance.  Tolerances: fp32 2e-4 for
hidden states and caches, 2e-3 for logits (``tests/test_models.py``); bf16
2e-2."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import attention as jattn
from repro.models import encdec as jencdec
from repro.models import frontend as jfrontend
from repro.models.model_zoo import build_model as jax_build_model
from repro.models.params import param_count as jax_param_count
from repro.runtime import serve as jserve
from repro.runtime import train as jax_rt
from repro.sharding.rules import ShardCtx as JShardCtx
from repro_torch.configs import registry as treg
from repro_torch.models import attention as tattn
from repro_torch.models import convert
from repro_torch.models import encdec as tencdec
from repro_torch.models import frontend as tfrontend
from repro_torch.models.encdec import EncDec
from repro_torch.models.model_zoo import build_model
from repro_torch.models.params import map_with_path, param_count
from repro_torch.models.params import tree_map_specs
from repro_torch.runtime import serve as tserve
from repro_torch.runtime import train as rt
from repro_torch.sharding.rules import ShardCtx

from _torch_port_util import numpy_tree, port_model, reference_model

HID = dict(rtol=2e-4, atol=2e-4)
LOGIT = dict(rtol=2e-3, atol=2e-3)
BF16 = dict(rtol=2e-2, atol=2e-2)
ARCHS = ("whisper-small", "internvl2-26b")
B, S_ENC, PROMPT, STEPS = 2, 16, 5, 3


class _F32Numpy:
    """``jax.numpy`` with ``bfloat16`` read as ``float32``."""
    bfloat16 = jnp.float32

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.fixture
def ref_fp32(monkeypatch):
    """The reference's encoder-decoder with its bf16 casts read as fp32
    (F15): the same code path, in fp32."""
    monkeypatch.setattr(jencdec, "jnp", _F32Numpy())


def _t(a):
    a = np.array(a)
    return torch.from_numpy(a.astype(np.float32) if a.dtype.kind == "f"
                            else a)


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32)) if hasattr(
        a, "dtype") and a.dtype == jnp.bfloat16 else np.asarray(a)


def _flat(tree):
    out = {}
    map_with_path(out.__setitem__, tree)
    return out


def _jflat(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        out[tuple(getattr(k, "key", getattr(k, "idx", None))
                  for k in path)] = leaf
    return out


def _f32(tree):
    return jax.tree.map(lambda a: a.astype(jnp.float32)
                        if a.dtype == jnp.bfloat16 else a, tree)


def _frames(cfg, b=B, s=S_ENC, seed=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, cfg.d_model)) * 0.5).astype(np.float32)


def _tokens(cfg, b=B, s=PROMPT + STEPS, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    return toks, np.tile(np.arange(s, dtype=np.int32), (b, 1))


@pytest.fixture(scope="module")
def whisper():
    cfg, jmodel, params = reference_model(0, "whisper-small")
    return cfg, jmodel, params, port_model(params, "whisper-small")


@pytest.fixture(scope="module")
def internvl():
    cfg, jmodel, params = reference_model(0, "internvl2-26b")
    return cfg, jmodel, params, port_model(params, "internvl2-26b")


# ------------------------------------------------------------- configs ----
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_build(arch):
    for getter in ("get_smoke", "get_config"):
        assert dataclasses.asdict(getattr(jreg, getter)(arch)) == \
            dataclasses.asdict(getattr(treg, getter)(arch))
    model = build_model(treg.get_smoke(arch), device="cpu")
    assert isinstance(model, EncDec) == (arch == "whisper-small")


@pytest.mark.parametrize("arch,want", [("whisper-small", 278_645_760),
                                       ("internvl2-26b", 19_862_722_560)])
def test_full_config_specs_and_param_counts(arch, want):
    """The published widths: the spec trees' shapes ``==`` the
    reference's, the parameter counts the reference's, and a model built
    on the meta device holds that many parameters."""
    jspecs = jax_build_model(jreg.get_config(arch)).specs()
    model = build_model(treg.get_config(arch), device="meta")
    specs = model.specs()
    assert tree_map_specs(lambda s: tuple(s.shape), specs) == jax.tree.map(
        lambda s: tuple(s.shape), jspecs,
        is_leaf=lambda s: hasattr(s, "shape"))
    assert param_count(specs) == jax_param_count(jspecs) == want
    assert sum(p.numel() for p in model.parameters()) == want


@pytest.mark.parametrize("batch,max_len,enc_len", [(2, 16, None),
                                                   (3, 600, 1500),
                                                   (1, 448, 7)])
def test_cache_specs_match_reference(batch, max_len, enc_len):
    """The decoder's ring is capped at 448 slots, the cross K/V at the
    encoder's length."""
    cfg = treg.get_config("whisper-small")
    jm = jax_build_model(jreg.get_config("whisper-small"))
    got = EncDec(cfg, device=torch.device("meta")).cache_specs(
        batch, max_len, enc_len)
    want = jm.cache_specs(batch, max_len, enc_len)
    assert tree_map_specs(lambda s: (tuple(s.shape), s.axes), got) == \
        jax.tree.map(lambda s: (tuple(s.shape), s.axes), want,
                     is_leaf=lambda s: hasattr(s, "shape"))


# ------------------------------------------------------------ frontend ----
@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
@pytest.mark.parametrize("seq", [1, 2, 8, 9, 64, 1500, 2048])
def test_frontend_shapes_and_text_len(arch, seq):
    for getter in ("get_smoke", "get_config"):
        jc, tc = getattr(jreg, getter)(arch), getattr(treg, getter)(arch)
        assert tfrontend.frontend_embed_shape(tc, 3, seq) == \
            jfrontend.frontend_embed_shape(jc, 3, seq)
        assert tfrontend.text_len(tc, seq) == jfrontend.text_len(jc, seq)
        js = jfrontend.frontend_embed_spec(jc, 3, seq)
        ts = tfrontend.frontend_embed_spec(tc, 3, seq)
        assert (ts is None) == (js is None)
        if ts is not None:
            assert ts == (tuple(js.shape), torch.bfloat16)


def test_make_fake_embeds():
    cfg = treg.get_smoke("internvl2-26b")
    e = tfrontend.make_fake_embeds(cfg, 4, 64,
                                   torch.Generator().manual_seed(0))
    assert e.shape == (4, cfg.num_frontend_tokens, cfg.d_model)
    assert e.dtype == torch.bfloat16
    assert abs(float(e.float().std()) - 0.02) < 2e-3
    again = tfrontend.make_fake_embeds(cfg, 4, 64,
                                       torch.Generator().manual_seed(0))
    assert torch.equal(e, again)
    assert tfrontend.make_fake_embeds(treg.get_smoke("qwen2-1.5b"), 4, 64,
                                      torch.Generator()) is None


# ------------------------------------------------------ cross-attention ---
@pytest.mark.parametrize("seq", [16, 1500])
def test_sinusoid_matches_reference(seq):
    np.testing.assert_allclose(tencdec.sinusoid(seq, 64).numpy(),
                               np.asarray(jencdec.sinusoid(seq, 64)),
                               rtol=0, atol=1e-5)


def test_cross_attention_matches_reference(whisper):
    cfg, _, params, tmodel = whisper
    lp = jax.tree.map(lambda a: a[0], params["dec_blocks"])["cross"]
    rng = np.random.default_rng(3)
    enc = rng.standard_normal((B, S_ENC, cfg.d_model)).astype(np.float32)
    x = rng.standard_normal((B, 4, cfg.d_model)).astype(np.float32)
    jk, jv = jattn.encode_cross_kv(lp, jnp.asarray(enc), cfg)
    mixer = tmodel.dec_blocks[0].cross
    tk, tv = tattn.encode_cross_kv(mixer, _t(enc))
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **HID)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **HID)
    want = jattn.cross_attn_forward(lp, jnp.asarray(x), (jk, jv), cfg)
    got = tattn.cross_attn_forward(mixer, _t(x), (tk, tv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **HID)


# ------------------------------------------------------------- whisper ----
def test_encode_and_forward_match_reference(whisper, ref_fp32):
    cfg, jmodel, params, tmodel = whisper
    frames = _frames(cfg)
    toks, pos = _tokens(cfg)
    want = jax.jit(jmodel.encode)(params, jnp.asarray(frames))
    got = tmodel.encode(_t(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **HID)
    jout = jax.jit(lambda p, t, ps, e: jmodel.forward(p, t, ps, embeds=e))(
        params, toks, pos, jnp.asarray(frames))
    for impl in ("blocked", "dot"):
        tout = tmodel(_t(toks), _t(pos), ShardCtx(attn_impl=impl),
                      embeds=_t(frames))
        np.testing.assert_allclose(tout["hidden"].detach().numpy(),
                                   np.asarray(jout["hidden"]), **HID)
        assert float(tout["aux"]) == 0.0


@pytest.mark.parametrize("impl", ["flash", "blocked", "dot"])
def test_prefill_cache_and_decode_match_reference(whisper, ref_fp32, impl):
    """The serving steps (prefill with the frames, then decode) against
    the reference's: last-position logits, every cache leaf (ring K/V,
    ``pos`` with ``==``, the cross K/V) and each decode's logits."""
    cfg, jmodel, params, tmodel = whisper
    frames = _frames(cfg)
    toks, pos = _tokens(cfg)
    max_len = PROMPT + STEPS + 2
    jcache = _f32(jmodel.init_cache(B, max_len, enc_len=S_ENC))
    tcache = tmodel.init_cache(B, max_len, enc_len=S_ENC,
                               dtype=torch.float32)
    jpre = jax.jit(jserve.make_prefill_step(jmodel, JShardCtx(
        attn_impl=impl)))
    jl, jcache = jpre(params, toks[:, :PROMPT], pos[:, :PROMPT], jcache,
                      jnp.asarray(frames))
    tpre = tserve.make_prefill_step(tmodel, ShardCtx(attn_impl=impl))
    tl, tcache = tpre(_t(toks[:, :PROMPT]), _t(pos[:, :PROMPT]), tcache,
                      embeds=_t(frames))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT)
    got, want = _flat(tcache), _jflat(jcache)
    assert set(got) == set(want)
    for k in want:
        if k[-1] == "pos":
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        else:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       **HID)
    jdec = jax.jit(jserve.make_decode_step(jmodel, JShardCtx()))
    tdec = tserve.make_decode_step(tmodel, ShardCtx())
    for t in range(PROMPT, PROMPT + STEPS):
        jl, jcache = jdec(params, toks[:, t:t + 1], jnp.full((B,), t), jcache)
        tl, tcache = tdec(_t(toks[:, t:t + 1]),
                          torch.full((B,), t, dtype=torch.int64), tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT)
    for k, v in _jflat(jcache).items():
        if k[-1] == "pos":
            np.testing.assert_array_equal(_flat(tcache)[k].numpy(),
                                          np.asarray(v))


def test_decoder_positions_clip_past_448(whisper, ref_fp32):
    """Past whisper's 448 positions the ring wraps and the learned
    positions clip at 447, as in the reference."""
    cfg, jmodel, params, tmodel = whisper
    frames = _frames(cfg, b=1, s=8)
    n = 446
    toks, pos = _tokens(cfg, b=1, s=n + 4, seed=7)
    jcache = _f32(jmodel.init_cache(1, 600, enc_len=8))
    tcache = tmodel.init_cache(1, 600, enc_len=8, dtype=torch.float32)
    assert tcache["self"]["k"].shape[2] == 448
    jl, jcache = jax.jit(jserve.make_prefill_step(jmodel, JShardCtx()))(
        params, toks[:, :n], pos[:, :n], jcache, jnp.asarray(frames))
    tl, tcache = tserve.make_prefill_step(tmodel, ShardCtx())(
        _t(toks[:, :n]), _t(pos[:, :n]), tcache, embeds=_t(frames))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT)
    jdec = jax.jit(jserve.make_decode_step(jmodel, JShardCtx()))
    for t in range(n, n + 4):
        jl, jcache = jdec(params, toks[:, t:t + 1], jnp.full((1,), t), jcache)
        tl, tcache = tserve.make_decode_step(tmodel, ShardCtx())(
            _t(toks[:, t:t + 1]), torch.full((1,), t, dtype=torch.int64),
            tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT)
    np.testing.assert_array_equal(tcache["self"]["pos"].numpy(),
                                  np.asarray(jcache["self"]["pos"]))


def test_declared_dtypes_match_reference():
    """bf16 weights (fp32 norms and biases), the reference unchanged:
    forward hidden, prefill and decode logits within bf16's 2e-2."""
    cfg = jreg.get_smoke("whisper-small")
    jmodel = jax_build_model(cfg)
    params = jax.jit(jmodel.init_params)(jax.random.key(0))
    tmodel = convert.params_from_numpy(
        numpy_tree(_f32(params)), treg.get_smoke("whisper-small"),
        device="cpu", dtype=None)
    assert tmodel.dec_blocks[0].self.wq.dtype == torch.bfloat16
    frames = _frames(cfg)
    toks, pos = _tokens(cfg)
    fr_bf = jnp.asarray(frames, jnp.bfloat16)
    jout = jax.jit(lambda p, t, ps, e: jmodel.forward(p, t, ps, embeds=e))(
        params, toks, pos, fr_bf)
    tout = tmodel(_t(toks), _t(pos), embeds=_t(frames).to(torch.bfloat16))
    assert tout["hidden"].dtype == torch.bfloat16
    np.testing.assert_allclose(tout["hidden"].float().numpy(),
                               _np(jout["hidden"]), **BF16)
    jcache = jmodel.init_cache(B, PROMPT + STEPS, enc_len=S_ENC)
    tcache = tmodel.init_cache(B, PROMPT + STEPS, enc_len=S_ENC)
    jl, jcache = jax.jit(jserve.make_prefill_step(jmodel, JShardCtx()))(
        params, toks[:, :PROMPT], pos[:, :PROMPT], jcache, fr_bf)
    tl, tcache = tserve.make_prefill_step(tmodel, ShardCtx())(
        _t(toks[:, :PROMPT]), _t(pos[:, :PROMPT]), tcache,
        embeds=_t(frames).to(torch.bfloat16))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **BF16)
    assert tcache["cross_k"].dtype == torch.bfloat16
    np.testing.assert_allclose(tcache["cross_k"].float().numpy(),
                               _np(jcache["cross_k"]), **BF16)
    jdec = jax.jit(jserve.make_decode_step(jmodel, JShardCtx()))
    for t in range(PROMPT, PROMPT + STEPS):
        jl, jcache = jdec(params, toks[:, t:t + 1], jnp.full((B,), t), jcache)
        tl, tcache = tserve.make_decode_step(tmodel, ShardCtx())(
            _t(toks[:, t:t + 1]), torch.full((B,), t, dtype=torch.int64),
            tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **BF16)


def test_teacher_forced_serving_matches_own_forward(whisper):
    """The port's prefill + decode against its own forward (fp32)."""
    cfg, _, _, tmodel = whisper
    frames = _frames(cfg, seed=9)
    toks, pos = _tokens(cfg, seed=9)
    full = tmodel(_t(toks), _t(pos), embeds=_t(frames))["hidden"]
    cache = tmodel.init_cache(B, PROMPT + STEPS, enc_len=S_ENC,
                              dtype=torch.float32)
    h, cache, _ = tmodel.prefill(_t(toks[:, :PROMPT]), _t(pos[:, :PROMPT]),
                                 cache, ShardCtx(attn_impl="flash"),
                                 embeds=_t(frames))
    np.testing.assert_allclose(h.numpy(), full[:, :PROMPT].numpy(), **HID)
    for t in range(PROMPT, PROMPT + STEPS):
        lg, cache = tmodel.decode(_t(toks[:, t:t + 1]),
                                  torch.full((B,), t, dtype=torch.int64),
                                  cache)
        np.testing.assert_allclose(
            lg[:, 0].numpy(), tmodel.logits(full[:, t]).numpy(), **LOGIT)


def _grads_match(tmodel, jmodel, params, batch_np, tol):
    """loss_fn's total, loss and gradients, port against reference."""
    jbatch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    (jtotal, jm), jg = jax.value_and_grad(
        lambda p: jax_rt.loss_fn(jmodel, p, jbatch, JShardCtx()),
        has_aux=True)(params)
    tp = rt.train_params(tmodel)
    try:
        total, m = rt.loss_fn(tmodel, tp, {k: _t(v) for k, v in
                                           batch_np.items()}, ShardCtx())
        grads = dict(zip(tp, torch.autograd.grad(total, list(tp.values()))))
    finally:
        for p in tp.values():
            p.requires_grad_(False)
    np.testing.assert_allclose(float(total.detach()), float(jtotal),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["loss"].detach()), float(jm["loss"]),
                               rtol=1e-5)
    got = _jflat(convert.stacked_to_numpy(grads, tmodel))
    want = _jflat(jg)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), **tol,
                                   err_msg=str(k))
    return float(total.detach())


def test_whisper_loss_and_grads_match_reference(whisper, ref_fp32):
    """The encoder-decoder branch of ``loss_fn``: the frames feed the
    encoder, so every decoder position carries loss."""
    cfg, jmodel, params, tmodel = whisper
    toks, _ = _tokens(cfg, s=9, seed=4)
    _grads_match(tmodel, jmodel, params,
                 {"tokens": toks, "embeds": _frames(cfg, seed=4)}, HID)


def test_internvl2_loss_and_grads_match_reference(internvl):
    """The frontend rows come first and carry no loss."""
    cfg, jmodel, params, tmodel = internvl
    toks, _ = _tokens(cfg, s=9, seed=4)
    emb = _frames(cfg, s=cfg.num_frontend_tokens, seed=4) * 0.1
    _grads_match(tmodel, jmodel, params, {"tokens": toks, "embeds": emb},
                 HID)


# ------------------------------------------------------------ internvl2 ---
def test_internvl2_forward_prefill_decode_match_reference(internvl):
    """The patch embeddings go before the text (``text_len``'s split):
    forward, prefill with the embeds (cache leaf for leaf) and decode."""
    cfg, jmodel, params, tmodel = internvl
    seq = 16
    n_emb = seq - jfrontend.text_len(cfg, seq)
    stext = tfrontend.text_len(treg.get_smoke("internvl2-26b"), seq)
    emb = _frames(cfg, s=n_emb, seed=6) * 0.1
    toks, _ = _tokens(cfg, s=stext + STEPS, seed=6)
    full = n_emb + stext
    pos = np.tile(np.arange(full + STEPS, dtype=np.int32), (B, 1))
    jout = jax.jit(lambda p, t, ps, e: jmodel.forward(p, t, ps, embeds=e))(
        params, toks[:, :stext], pos[:, :full], jnp.asarray(emb))
    tout = tmodel(_t(toks[:, :stext]), _t(pos[:, :full]), embeds=_t(emb))
    np.testing.assert_allclose(tout["hidden"].numpy(),
                               np.asarray(jout["hidden"]), **HID)
    jcache = _f32(jmodel.init_cache(B, full + STEPS))
    tcache = convert.cache_from_numpy(numpy_tree(jcache),
                                      treg.get_smoke("internvl2-26b"),
                                      device="cpu")
    jl, jcache = jax.jit(jserve.make_prefill_step(jmodel, JShardCtx(
        attn_impl="flash")))(params, toks[:, :stext], pos[:, :full], jcache,
                             jnp.asarray(emb))
    tl, tcache = tserve.make_prefill_step(tmodel, ShardCtx(
        attn_impl="flash"))(_t(toks[:, :stext]), _t(pos[:, :full]), tcache,
                            embeds=_t(emb))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT)
    for k, v in _jflat(jcache).items():
        np.testing.assert_allclose(_flat(tcache)[k].numpy(), np.asarray(v),
                                   **HID)
    jdec = jax.jit(jserve.make_decode_step(jmodel, JShardCtx()))
    for i in range(STEPS):
        t = full + i
        tok = toks[:, stext + i:stext + i + 1]
        jl, jcache = jdec(params, tok, jnp.full((B,), t), jcache)
        tl, tcache = tserve.make_decode_step(tmodel, ShardCtx())(
            _t(tok), torch.full((B,), t, dtype=torch.int64), tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT)
    # the port's own forward over the whole sequence agrees with its steps
    own = tmodel(_t(toks), _t(pos), embeds=_t(emb))["hidden"]
    np.testing.assert_allclose(
        tl[:, 0].numpy(), tmodel.logits(own[:, -1]).numpy(), **LOGIT)


# ----------------------------------------------------------- converters ---
def test_params_round_trip(whisper):
    cfg, _, params, tmodel = whisper
    want = _jflat(numpy_tree(params))
    got = _jflat(convert.params_to_numpy(tmodel))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    again = convert.params_from_numpy(convert.params_to_numpy(tmodel),
                                      treg.get_smoke("whisper-small"),
                                      device="cpu")
    for (n, a), (_, b) in zip(tmodel.named_parameters(),
                              again.named_parameters()):
        assert torch.equal(a, b), n
    bad = numpy_tree(params)
    bad["enc_blocks"]["mixer"]["wq"] = bad["enc_blocks"]["mixer"]["wq"][:1]
    with pytest.raises(ValueError, match="stacked layers"):
        convert.params_from_numpy(bad, treg.get_smoke("whisper-small"),
                                  device="cpu")


def test_cache_round_trip(whisper, ref_fp32):
    cfg, jmodel, params, tmodel = whisper
    frames = _frames(cfg)
    toks, pos = _tokens(cfg)
    jcache = _f32(jmodel.init_cache(B, 12, enc_len=S_ENC))
    _, jcache = jax.jit(jserve.make_prefill_step(jmodel, JShardCtx()))(
        params, toks[:, :PROMPT], pos[:, :PROMPT], jcache,
        jnp.asarray(frames))
    tcache = convert.cache_from_numpy(numpy_tree(jcache),
                                      treg.get_smoke("whisper-small"),
                                      device="cpu")
    assert tcache["self"]["k"].dtype == torch.float32
    assert tcache["cross_k"].shape == (cfg.num_layers, B, S_ENC,
                                       cfg.num_kv_heads, cfg.head_dim)
    back = _jflat(convert.cache_to_numpy(tcache))
    for k, v in _jflat(numpy_tree(jcache)).items():
        np.testing.assert_array_equal(back[k], v)
    bf = convert.cache_from_numpy(numpy_tree(jcache),
                                  treg.get_smoke("whisper-small"),
                                  device="cpu", dtype=None)
    assert bf["cross_v"].dtype == torch.bfloat16
    assert bf["self"]["pos"].dtype == torch.int32
    tree = numpy_tree(jcache)
    del tree["cross_v"]
    with pytest.raises(ValueError, match="missing leaves"):
        convert.cache_from_numpy(tree, treg.get_smoke("whisper-small"),
                                 device="cpu")
