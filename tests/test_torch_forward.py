"""The port's parallel forward against the reference: ``LM.forward`` (with
and without remat) on the qwen2-1.5b and h2o-danube-1.8b smoke configs,
``LM.embed`` with ``embeds=``, ``attn_forward``'s three impls, the
teacher-forced prefill/decode check of ``tests/test_models.py``, and the
blocked attention's hand-written backward against the reference's
``jax.grad`` (``tests/test_kernels.py::test_flash_backward_matches_dot``'s
tolerances).  Weights are the reference's (fp32), inputs numpy-seeded;
everything runs on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.models import attention as tattn
from repro_torch.models.transformer import apply_block
from repro_torch.sharding.rules import ShardCtx
from tests._torch_port_util import port_model, reference_model

ARCHS = ["qwen2-1.5b", "h2o-danube-1.8b"]


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    cfg, jmodel, params = reference_model(0, request.param)
    return request.param, cfg, jmodel, params, port_model(params,
                                                          request.param)


def _tokens(cfg, b=2, s=12, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    pos = np.broadcast_to(np.arange(s)[None], (b, s)).astype(np.int32)
    return toks, pos


@pytest.mark.parametrize("remat", [False, True])
def test_forward_matches_reference(models, remat):
    _, cfg, jmodel, params, model = models
    toks, pos = _tokens(cfg)
    want = jax.jit(lambda p, t, ps: jmodel.forward(p, t, ps))(
        params, toks, pos)
    got = model.forward(_t(toks), _t(pos), ShardCtx(remat=remat))
    np.testing.assert_allclose(got["hidden"].detach().numpy(),
                               np.asarray(want["hidden"]), rtol=2e-5,
                               atol=2e-5)
    assert float(got["aux"]) == float(want["aux"]) == 0.0


def test_remat_gives_the_same_gradients(models):
    """Recomputing each layer in the backward changes no gradient."""
    _, cfg, _, _, model = models
    toks, pos = _tokens(cfg)
    params = {n: p for n, p in model.named_parameters()
              if n != "embed.lm_head"}          # the hidden skips the head
    grads = []
    for remat in (False, True):
        for p in params.values():
            p.requires_grad_(True)
        out = model.forward(_t(toks), _t(pos), ShardCtx(remat=remat))
        grads.append(torch.autograd.grad(out["hidden"].square().sum(),
                                         list(params.values())))
        for p in params.values():
            p.requires_grad_(False)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_embed_with_frontend_rows(models):
    """``LM.embed(tokens, embeds)``: frontend rows first, as the
    reference's; the forward takes positions over both."""
    _, cfg, jmodel, params, model = models
    toks, _ = _tokens(cfg, s=6)
    emb = np.random.default_rng(3).normal(
        size=(2, 3, cfg.d_model)).astype(np.float32)
    want = jmodel.embed(params, toks, jnp.asarray(emb))
    got = model.embed(_t(toks), _t(emb))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    pos = np.broadcast_to(np.arange(9)[None], (2, 9)).astype(np.int32)
    want_h = jmodel.forward(params, toks, pos, embeds=jnp.asarray(emb))
    got_h = model.forward(_t(toks), _t(pos), embeds=_t(emb))
    np.testing.assert_allclose(got_h["hidden"].detach().numpy(),
                               np.asarray(want_h["hidden"]), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("impl", ["blocked", "dot", "flash"])
def test_attn_forward_and_apply_block_match_reference(models, impl):
    _, cfg, jmodel, params, model = models
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 10, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(10)[None], (2, 10)).astype(np.int32)
    bp = jax.tree.map(lambda a: a[0], params["groups"][0]["blocks"][0])
    want = jattn.attn_forward(bp["mixer"], jnp.asarray(x), cfg,
                              jnp.asarray(pos), impl=impl)
    block = model.groups[0][0][0]
    got = tattn.attn_forward(block.mixer, _t(x), _t(pos), impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    from repro.models.transformer import apply_block as japply_block
    from repro.sharding.rules import ShardCtx as JShardCtx
    jx, jaux, _ = japply_block(bp, jnp.asarray(x), cfg.groups[0].blocks[0],
                               cfg, JShardCtx(attn_impl=impl),
                               jnp.asarray(pos))
    tx, taux, cache = apply_block(block, _t(x), _t(pos),
                                  ShardCtx(attn_impl=impl))
    assert cache is None and float(taux) == float(jaux) == 0.0
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=2e-5,
                               atol=2e-5)


def test_flash_refuses_a_forward_that_builds_a_graph(models):
    """K3 has no backward: ``impl="flash"`` with a graph being built
    raises instead of taking another core; without one it runs."""
    _, cfg, _, _, model = models
    rng = np.random.default_rng(6)
    x = _t(rng.normal(size=(2, 10, cfg.d_model)).astype(np.float32))
    pos = torch.arange(10)[None].expand(2, 10)
    block = model.groups[0][0][0]
    block.mixer.wq.requires_grad_(True)
    try:
        with pytest.raises(ValueError, match="K3 has no backward"):
            tattn.attn_forward(block.mixer, x, pos, impl="flash")
        with pytest.raises(ValueError, match="K3 has no backward"):
            apply_block(block, x, pos, ShardCtx(attn_impl="flash"))
        with torch.no_grad():
            got = tattn.attn_forward(block.mixer, x, pos, impl="flash")
        want = tattn.attn_forward(block.mixer, x, pos, impl="blocked")
        torch.testing.assert_close(got, want.detach(), rtol=2e-5,
                                   atol=2e-5)
    finally:
        block.mixer.wq.requires_grad_(False)


def test_prefill_decode_matches_forward(models):
    """Teacher-forced prefill + decode hidden equals the parallel forward
    (``tests/test_models.py::test_prefill_decode_matches_forward``, fp32,
    its tolerances)."""
    _, cfg, _, _, model = models
    B, S, SPLIT = 2, 12, 8
    rng = np.random.default_rng(1)
    tokens = _t(rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int64))
    pos = torch.arange(S)[None].expand(B, S)
    with torch.no_grad():
        full = model.forward(tokens, pos)["hidden"]
        cache = model.init_cache(B, S, dtype=torch.float32)
        hp, cache, _ = model.prefill(tokens[:, :SPLIT], pos[:, :SPLIT],
                                     cache)
        np.testing.assert_allclose(hp.numpy(), full[:, :SPLIT].numpy(),
                                   rtol=2e-4, atol=2e-4)
        w = model.lm_head_weight()
        for t in range(SPLIT, S):
            lg, cache = model.decode(tokens[:, t:t + 1],
                                     torch.full((B,), t), cache)
            ref_lg = full[:, t] @ w
            np.testing.assert_allclose(lg[:, 0].numpy(), ref_lg.numpy(),
                                       rtol=2e-3, atol=2e-3)


def test_mtp_head_is_not_ported(models):
    """A model built without the multi-token-prediction head (its config
    had no ``mtp_depth``) gives no ``mtp_hidden`` when the config later
    asks for one, as the reference's forward gives none for a parameter
    tree without an ``mtp`` subtree; the hidden states are unchanged."""
    import dataclasses
    _, cfg, jmodel, params, model = models
    toks, pos = _tokens(cfg)
    want = jmodel.forward(params, toks, pos)
    model.cfg = dataclasses.replace(model.cfg, mtp_depth=1)
    jmodel.cfg = dataclasses.replace(jmodel.cfg, mtp_depth=1)
    try:
        got = model.forward(_t(toks), _t(pos))
        jgot = jmodel.forward(params, toks, pos)
    finally:
        model.cfg = dataclasses.replace(model.cfg, mtp_depth=0)
        jmodel.cfg = dataclasses.replace(jmodel.cfg, mtp_depth=0)
    assert model.mtp is None
    assert set(got) == set(jgot) == {"hidden", "aux"}
    np.testing.assert_allclose(got["hidden"].detach().numpy(),
                               np.asarray(want["hidden"]), rtol=2e-5,
                               atol=2e-5)


# ------------------------------------------------------- blocked backward --
@pytest.mark.parametrize("window,block_k,seq", [(9, 8, 24), (None, 8, 21),
                                                (None, 512, 24),
                                                (5, 7, 30)])
def test_blocked_backward_matches_reference_grad(window, block_k, seq):
    """The hand-written backward against the reference's ``jax.grad`` of
    its custom VJP, and against autograd through ``grouped_dot_attention``
    (``test_flash_backward_matches_dot``'s rtol/atol 1e-4)."""
    rng = np.random.default_rng(0)
    b, hq, hkv, d = 2, 4, 2, 16
    q, k, v = (rng.normal(size=(b, seq, h, d)).astype(np.float32)
               for h in (hq, hkv, hkv))
    pos = np.broadcast_to(np.arange(seq)[None], (b, seq)).astype(np.int32)

    def f_ref(q, k, v):
        return (jattn.blocked_attention(q, k, v, 0.25, pos, pos,
                                        window=window, block_k=block_k)
                ** 2).sum()
    want = jax.jit(jax.grad(f_ref, argnums=(0, 1, 2)))(q, k, v)
    tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    out = tattn.blocked_attention(tq, tk, tv, 0.25, _t(pos), _t(pos),
                                  window=window, block_k=block_k)
    got = torch.autograd.grad((out ** 2).sum(), (tq, tk, tv))
    for a, c in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=1e-4,
                                   atol=1e-4)
    tq2, tk2, tv2 = (_t(a).requires_grad_(True) for a in (q, k, v))
    m = tattn.causal_mask(seq, seq, window)[None, None, None]
    dot = tattn.grouped_dot_attention(tq2, tk2, tv2, m, 0.25)
    got_dot = torch.autograd.grad((dot ** 2).sum(), (tq2, tk2, tv2))
    for a, c in zip(got, got_dot):
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=1e-4,
                                   atol=1e-4)


def test_blocked_forward_saves_no_score_matrix():
    """The autograd graph holds the inputs, out and lse only: no tensor of
    Sq x Skv scores survives the forward."""
    rng = np.random.default_rng(2)
    s = 64
    q = _t(rng.normal(size=(1, s, 2, 8)).astype(np.float32))
    k = _t(rng.normal(size=(1, s, 1, 8)).astype(np.float32))
    q.requires_grad_(True)
    k.requires_grad_(True)
    pos = torch.arange(s)[None]
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t.numel()) or t, lambda t: t):
        tattn.blocked_attention(q, k, k, 0.3, pos, pos, block_k=16)
    assert saved and max(saved) < s * s
