"""Port's layer math held against the reference's, fp32, same numpy
inputs.  atol 1e-5 throughout: the two frameworks' CPU matrix products sum
in different orders."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke as jax_smoke
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro_torch.configs.registry import get_smoke
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol)


def test_configs_agree_field_by_field():
    for getter in ("get_smoke", "get_config"):
        from repro.configs import registry as jreg
        from repro_torch.configs import registry as treg
        for arch in ("qwen2-1.5b", "whisper-small", "internvl2-26b"):
            a = dataclasses.asdict(getattr(jreg, getter)(arch))
            b = dataclasses.asdict(getattr(treg, getter)(arch))
            assert a == b


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_apply_norm(kind):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32) * 3 + 1
    scale = rng.standard_normal(48).astype(np.float32)
    bias = rng.standard_normal(48).astype(np.float32)
    p = {"scale": jnp.asarray(scale)}
    if kind == "layernorm":
        p["bias"] = jnp.asarray(bias)
    want = jlayers.apply_norm(p, jnp.asarray(x), kind, 1e-6)
    got = tlayers.apply_norm(_t(x), _t(scale),
                             _t(bias) if kind == "layernorm" else None,
                             kind, 1e-6)
    _close(got, want)
    if kind == "rmsnorm":
        _close(tlayers.rms_norm(_t(scale), _t(x), 1e-6), want)


@pytest.mark.parametrize("theta,head_dim", [(1e4, 16), (1e6, 64), (1e6, 128)])
def test_rope(theta, head_dim):
    rng = np.random.default_rng(1)
    pos = np.stack([np.arange(0, 2048, 64), rng.integers(0, 2048, 32)])
    pos[1, -1] = 2047
    x = rng.standard_normal((2, 32, 3, head_dim)).astype(np.float32)
    jc, js = jlayers.rope_cos_sin(jnp.asarray(pos), head_dim, theta)
    tc, ts = tlayers.rope_cos_sin(_t(pos), head_dim, theta)
    assert tc.dtype == torch.float32 and tc.shape == (2, 32, head_dim // 2)
    _close(tc, jc)
    _close(ts, js)
    _close(tlayers.apply_rope(_t(x), tc, ts),
           jlayers.apply_rope(jnp.asarray(x), jc, js))


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_apply_mlp(act):
    rng = np.random.default_rng(2)
    cfg = dataclasses.replace(jax_smoke("qwen2-1.5b"), act=act)
    d, ff = cfg.d_model, cfg.d_ff
    x = rng.standard_normal((2, 3, d)).astype(np.float32)
    names = (("wi", "bi", "wo", "bo") if act == "gelu"
             else ("wi_gate", "wi_up", "wo"))
    shapes = {"wi": (d, ff), "bi": (ff,), "wo": (ff, d), "bo": (d,),
              "wi_gate": (d, ff), "wi_up": (d, ff)}
    p = {n: (rng.standard_normal(shapes[n]) * 0.2).astype(np.float32)
         for n in names}
    want = jlayers.apply_mlp({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x), cfg)
    got = tlayers.apply_mlp(_t(x), **{k: _t(v) for k, v in p.items()})
    _close(got, want)


def test_embed_and_tied_logits():
    rng = np.random.default_rng(3)
    tok = rng.standard_normal((50, 16)).astype(np.float32)
    ids = rng.integers(0, 50, (2, 7))
    x = rng.standard_normal((2, 7, 16)).astype(np.float32)
    _close(tlayers.embed_tokens(_t(tok), _t(ids)),
           jlayers.embed_tokens({"tok": jnp.asarray(tok)}, jnp.asarray(ids)))
    got = tlayers.lm_logits(_t(x), _t(tok))
    assert got.dtype == torch.float32
    _close(got, jlayers.lm_logits({"tok": jnp.asarray(tok)}, jnp.asarray(x)))


@pytest.mark.parametrize("qk_norm", [False, True])
def test_project_qkv_with_bias(qk_norm):
    rng = np.random.default_rng(4)
    jcfg = dataclasses.replace(jax_smoke("qwen2-1.5b"), qk_norm=qk_norm)
    tcfg = dataclasses.replace(get_smoke("qwen2-1.5b"), qk_norm=qk_norm)
    specs = tattn.attention_specs(tcfg)
    p = {n: (rng.standard_normal(s.shape) * 0.3).astype(np.float32)
         for n, s in specs.items()}
    assert {"bq", "bk", "bv"} <= set(p)
    x = rng.standard_normal((2, 5, tcfg.d_model)).astype(np.float32)
    want = jattn._project_qkv({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x), jcfg)
    kw = {k: _t(v) for k, v in p.items() if k != "wo"}
    got = tattn._project_qkv(_t(x), tcfg, **kw)
    for g, w in zip(got, want):
        _close(g, w)


def _qkv(rng, b, s, hq, hkv, d):
    return (rng.standard_normal((b, s, hq, d)).astype(np.float32),
            rng.standard_normal((b, s, hkv, d)).astype(np.float32),
            rng.standard_normal((b, s, hkv, d)).astype(np.float32))


@pytest.mark.parametrize("seq", [24, 37])
@pytest.mark.parametrize("window", [None, 9])
def test_blocked_attention_forward(seq, window):
    """vs the reference's blocked forward (KV padded to block multiples
    when seq = 37) and vs the dense grouped attention of both packages."""
    rng = np.random.default_rng(5)
    b, hq, hkv, d = 2, 4, 2, 16
    q, k, v = _qkv(rng, b, seq, hq, hkv, d)
    pos = np.broadcast_to(np.arange(seq), (b, seq)).copy()
    scale = d ** -0.5
    want = jattn.blocked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
        jnp.asarray(pos), jnp.asarray(pos), window=window, block_k=8)
    got = tattn.blocked_attention(_t(q), _t(k), _t(v), scale, _t(pos),
                                  _t(pos), window=window, block_k=8)
    _close(got, want)
    jmask = jattn.causal_mask(seq, seq, window)[None, None, None]
    jdense = jattn.grouped_dot_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jmask, scale)
    tmask = tattn.causal_mask(seq, seq, window)[None, None, None]
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    tdense = tattn.grouped_dot_attention(_t(q), _t(k), _t(v), tmask, scale)
    _close(tdense, jdense)
    _close(got, jdense)


def test_blocked_attention_single_block_and_validity():
    """block_k >= seq takes one block; kv_valid masks slots."""
    rng = np.random.default_rng(6)
    b, seq, hq, hkv, d = 1, 12, 4, 2, 16
    q, k, v = _qkv(rng, b, seq, hq, hkv, d)
    pos = np.arange(seq)[None]
    valid = rng.random((b, seq)) > 0.3
    valid[:, 0] = True
    want = jattn.blocked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.25,
        jnp.asarray(pos), jnp.asarray(pos), kv_valid=jnp.asarray(valid))
    got = tattn.blocked_attention(_t(q), _t(k), _t(v), 0.25, _t(pos),
                                  _t(pos), kv_valid=_t(valid))
    _close(got, want)
