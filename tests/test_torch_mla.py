"""The port's MLA mixer (``models/mla.py``) held against the reference's on
the same numpy inputs: the forward on both branches (the dot path, and the
blocked path past 1,024 tokens at tiny widths), the prefill's latent-cache
writes, and the absorbed decode step by step.  fp32; 2e-5 against the
reference, the reference's own 1e-4 for decode against the forward
(``tests/test_mixers.py::test_mla_decode_matches_forward``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as JArchConfig
from repro.configs.base import MLAConfig as JMLAConfig
from repro.models import mla as jmla
from repro.models.params import abstract, materialize
from repro_torch.configs.base import ArchConfig, MLAConfig
from repro_torch.models import mla as tmla

TOL = dict(rtol=2e-5, atol=2e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs(d=64, heads=4, q_lora=32, kv_lora=16, nope=16, rope=8, v=16):
    """``test_mixers``' MLA config in both packages."""
    kw = dict(name="m", family="moe", num_layers=1, d_model=d,
              num_heads=heads, num_kv_heads=heads, d_ff=128, vocab_size=64)
    mk = dict(q_lora_rank=q_lora, kv_lora_rank=kv_lora,
              qk_nope_head_dim=nope, qk_rope_head_dim=rope, v_head_dim=v)
    return (JArchConfig(**kw, mla=JMLAConfig(**mk)),
            ArchConfig(**kw, mla=MLAConfig(**mk)))


def _params(jcfg, seed=0):
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      materialize(jmla.mla_specs(jcfg), jax.random.key(seed)))
    return jp, {k: _t(v) for k, v in jp.items()}


def _inputs(b, s, d, seed=1):
    x = np.random.default_rng(seed).normal(size=(b, s, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s)[None], (b, s)).astype(np.int32)
    return x, pos


def _empty_caches(jcfg, cfg, b, w):
    """The reference's empty cache (fp32 latents, pos -1, as its
    ``init_cache`` leaves them) and the same for the port."""
    jc = jax.tree.map(
        lambda s: jnp.full(s.shape, -1, s.dtype) if s.dtype == jnp.int32
        else jnp.zeros(s.shape, jnp.float32),
        abstract(jmla.mla_cache_specs(jcfg, b, w)))
    return jc, {k: _t(v) for k, v in jc.items()}


@pytest.mark.parametrize("s,impl", [(10, "blocked"), (10, "dot"),
                                    (10, "flash"), (1100, "blocked"),
                                    (1100, "dot")])
def test_mla_forward_matches_reference(s, impl):
    """``impl="blocked"`` past 1,024 tokens takes the blocked attention
    (q/k heads 24 wide, v 16); everything else the dot path."""
    small = s > 1024
    jcfg, cfg = (_cfgs(d=32, heads=2, q_lora=16, kv_lora=8, nope=16,
                       rope=8, v=16) if small else _cfgs())
    jp, tp = _params(jcfg)
    x, pos = _inputs(1 if small else 2, s, cfg.d_model)
    want = jax.jit(lambda p, xx, ps: jmla.mla_forward(p, xx, jcfg, ps,
                                                      impl=impl))(
        jp, jnp.asarray(x), jnp.asarray(pos))
    got = tmla.mla_forward(tp, _t(x), cfg, _t(pos), impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_mla_prefill_writes_the_latent_cache():
    """The prefill fills slots ``positions`` (here 3..10 of a 14-wide
    cache) in place; the rest keeps pos -1 and zeros, as the
    reference's."""
    jcfg, cfg = _cfgs()
    jp, tp = _params(jcfg)
    x, _ = _inputs(2, 8, 64)
    pos = np.broadcast_to(np.arange(3, 11)[None], (2, 8)).astype(np.int32)
    jc, tc = _empty_caches(jcfg, cfg, 2, 14)
    held = dict(tc)
    jy, jc = jax.jit(lambda p, xx, c, ps: jmla.mla_prefill(p, xx, jcfg, c,
                                                           ps))(
        jp, jnp.asarray(x), jc, jnp.asarray(pos))
    ty, out = tmla.mla_prefill(tp, _t(x), cfg, tc, _t(pos))
    assert out is tc and all(tc[n] is held[n] for n in held)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    assert (tc["pos"].numpy()[:, :3] == -1).all()
    assert (tc["pos"].numpy()[:, 11:] == -1).all()
    for n in ("c_kv", "k_rope"):
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]), **TOL)


@pytest.mark.parametrize("prefill", [0, 6])
def test_mla_decode_step_by_step_matches_reference(prefill):
    """From an empty cache (or after a 6-token prefill), one absorbed
    decode step a token to 10: outputs and every cache leaf against the
    reference's at each step; all outputs against the forward."""
    jcfg, cfg = _cfgs()
    jp, tp = _params(jcfg)
    x, pos = _inputs(2, 10, 64)
    jc, tc = _empty_caches(jcfg, cfg, 2, 10)
    ys = []
    if prefill:
        jy, jc = jmla.mla_prefill(jp, jnp.asarray(x[:, :prefill]), jcfg, jc,
                                  jnp.asarray(pos[:, :prefill]))
        ty, tc = tmla.mla_prefill(tp, _t(x[:, :prefill]), cfg, tc,
                                  _t(pos[:, :prefill]))
        ys.append(ty)
    dec = jax.jit(lambda p, xx, cc, ps: jmla.mla_decode(p, xx, jcfg, cc, ps))
    for t in range(prefill, 10):
        p_t = np.full((2,), t, np.int32)
        jyt, jc = dec(jp, jnp.asarray(x[:, t:t + 1]), jc, jnp.asarray(p_t))
        tyt, tc = tmla.mla_decode(tp, _t(x[:, t:t + 1]), cfg, tc, _t(p_t))
        np.testing.assert_allclose(tyt.numpy(), np.asarray(jyt), **TOL)
        np.testing.assert_array_equal(tc["pos"].numpy(),
                                      np.asarray(jc["pos"]))
        for n in ("c_kv", "k_rope"):
            np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]),
                                       **TOL)
        ys.append(tyt)
    full = tmla.mla_forward(tp, _t(x), cfg, _t(pos))
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), full.numpy(),
                               rtol=1e-4, atol=1e-4)


def test_mla_decode_clamps_the_slot_as_the_reference():
    """A position past the cache's width writes the last slot (the
    reference's ``dynamic_update_slice`` clamps its start)."""
    jcfg, cfg = _cfgs()
    jp, tp = _params(jcfg)
    x, _ = _inputs(2, 1, 64)
    jc, tc = _empty_caches(jcfg, cfg, 2, 4)
    p_t = np.array([2, 7], np.int32)
    jy, jc = jmla.mla_decode(jp, jnp.asarray(x), jcfg, jc, jnp.asarray(p_t))
    ty, tc = tmla.mla_decode(tp, _t(x), cfg, tc, _t(p_t))
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    assert tc["pos"].tolist() == [[-1, -1, 2, -1], [-1, -1, -1, 7]]
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)


def test_mla_forward_and_decode_bf16_match_reference():
    """The declared dtypes (bf16 weights and latent cache, fp32 norms),
    bf16 activations: the dot-path forward, the prefill's cache and a
    decode step within 2e-2."""
    jcfg, cfg = _cfgs()
    jp = materialize(jmla.mla_specs(jcfg), jax.random.key(0))
    tp = {k: _t(np.asarray(v, np.float32)).to(
        torch.bfloat16 if v.dtype == jnp.bfloat16 else torch.float32)
        for k, v in jp.items()}
    x, pos = _inputs(2, 9, 64)
    jc = jax.tree.map(lambda s: jnp.full(s.shape, -1, s.dtype)
                      if s.dtype == jnp.int32 else jnp.zeros(s.shape, s.dtype),
                      abstract(jmla.mla_cache_specs(jcfg, 2, 10)))
    tc = {k: _t(np.asarray(v, np.float32)).to(
        torch.bfloat16 if v.dtype == jnp.bfloat16 else torch.int32)
        for k, v in jc.items()}
    jy, jc = jmla.mla_prefill(jp, jnp.asarray(x, jnp.bfloat16), jcfg, jc,
                              jnp.asarray(pos))
    ty, tc = tmla.mla_prefill(tp, _t(x).to(torch.bfloat16), cfg, tc,
                              _t(pos))
    assert ty.dtype == torch.bfloat16 and tc["c_kv"].dtype == torch.bfloat16
    np.testing.assert_allclose(ty.float().numpy(), np.asarray(jy, np.float32),
                               rtol=2e-2, atol=2e-2)
    x1, _ = _inputs(2, 1, 64, seed=4)
    p9 = np.full((2,), 9, np.int32)
    jy1, jc = jmla.mla_decode(jp, jnp.asarray(x1, jnp.bfloat16), jcfg, jc,
                              jnp.asarray(p9))
    ty1, tc = tmla.mla_decode(tp, _t(x1).to(torch.bfloat16), cfg, tc,
                              _t(p9))
    np.testing.assert_allclose(ty1.float().numpy(),
                               np.asarray(jy1, np.float32), rtol=2e-2,
                               atol=2e-2)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    for n in ("c_kv", "k_rope"):
        np.testing.assert_allclose(tc[n].float().numpy(),
                                   np.asarray(jc[n], np.float32), rtol=2e-2,
                                   atol=2e-2)
