"""The port's Mamba-2 mixer (``models/mamba2.py``) held against the
reference's on the same numpy inputs: the chunked SSD scan over the
reference's hypothesis sweep (lengths that are not a whole chunk, a
starting state), the causal conv and its step, the forward with its
decode cache, and the decode step by step.  fp32, the reference's own
tolerances (``tests/test_mixers.py``: 2e-5 for the scan, 2e-4 for decode
against the forward)."""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as JArchConfig
from repro.configs.base import Block as JBlock
from repro.configs.base import LayerGroup as JLayerGroup
from repro.configs.base import SSMConfig as JSSMConfig
from repro.models import mamba2 as jm
from repro.models.params import materialize
from repro_torch.configs.base import ArchConfig, Block, LayerGroup, SSMConfig
from repro_torch.models import mamba2 as tm

TOL = dict(rtol=2e-5, atol=2e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _sequential(xdt, a, B_, C_, h0):
    """The recurrence one step at a time in float64 (``test_mixers``)."""
    b, s, h, p = xdt.shape
    g, n = B_.shape[2:]
    hg = h // g
    st = h0.reshape(b, g, hg, p, n).astype(np.float64)
    ys = np.zeros((b, s, h, p))
    xr = xdt.reshape(b, s, g, hg, p)
    ar = a.reshape(b, s, g, hg)
    for t in range(s):
        st = st * np.exp(ar[:, t])[..., None, None] + np.einsum(
            "bghp,bgn->bghpn", xr[:, t], B_[:, t])
        ys[:, t] = np.einsum("bgn,bghpn->bghp", C_[:, t], st).reshape(b, h, p)
    return ys, st.reshape(b, h, p, n)


# the reference's hypothesis axes, sampled: lengths 7/16/24 against chunks
# of 4 and 8 (7 and 24 are not whole chunks of 8, 7 not of 4)
_SSD_CASES = [(b, s, h, p, g, n, chunk)
              for (b, s, chunk), (h, p, g, n) in itertools.product(
                  [(1, 7, 4), (2, 16, 8), (2, 24, 8), (1, 7, 8), (2, 5, 8)],
                  [(2, 4, 1, 4), (4, 8, 2, 16)])]


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", _SSD_CASES)
@pytest.mark.parametrize("with_h_init", [False, True])
def test_ssd_chunked_matches_reference(b, s, h, p, g, n, chunk, with_h_init):
    rng = np.random.default_rng(s * 100 + h * 10 + chunk)
    xdt = rng.normal(size=(b, s, h, p)).astype(np.float32) * .5
    a = -np.abs(rng.normal(size=(b, s, h)).astype(np.float32)) * 0.3
    B_ = rng.normal(size=(b, s, g, n)).astype(np.float32) * .5
    C_ = rng.normal(size=(b, s, g, n)).astype(np.float32) * .5
    h0 = (rng.normal(size=(b, h, p, n)).astype(np.float32) if with_h_init
          else np.zeros((b, h, p, n), np.float32))
    jy, jh = jax.jit(jm.ssd_chunked, static_argnums=4)(
        *map(jnp.asarray, (xdt, a, B_, C_)), chunk,
        h_init=jnp.asarray(h0) if with_h_init else None)
    ty, th = tm.ssd_chunked(*map(_t, (xdt, a, B_, C_)), chunk,
                            h_init=_t(h0) if with_h_init else None)
    assert ty.shape == (b, s, h, p) and th.shape == (b, h, p, n)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    ys, hs = _sequential(xdt, a, B_, C_, h0)
    np.testing.assert_allclose(ty.numpy(), ys, **TOL)
    np.testing.assert_allclose(th.numpy(), hs, **TOL)


def _cfgs(d=32, heads=8, groups=2, chunk=8):
    """``test_mixers._mamba_cfg`` in both packages."""
    kw = dict(name="t", family="ssm", num_layers=1, d_model=d,
              num_heads=heads, num_kv_heads=0, d_ff=0, vocab_size=64,
              head_dim=8)
    sk = dict(d_state=16, d_conv=4, expand=2, head_dim=8, n_groups=groups,
              chunk_size=chunk)
    return (JArchConfig(**kw, ssm=JSSMConfig(**sk),
                        groups=(JLayerGroup(1, (JBlock("mamba", "none"),)),)),
            ArchConfig(**kw, ssm=SSMConfig(**sk),
                       groups=(LayerGroup(1, (Block("mamba", "none"),)),)))


def _params(jcfg, seed=0):
    """fp32 reference params with non-trivial A_log / dt_bias / conv
    biases (their specs init them to 0), and the same leaves for the
    port."""
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      materialize(jm.mamba_specs(jcfg), jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    for name in ("A_log", "dt_bias", "conv_bx", "conv_bB", "conv_bC"):
        jp[name] = jnp.asarray(
            rng.normal(size=jp[name].shape).astype(np.float32) * 0.3)
    return jp, {k: _t(v) for k, v in jp.items()}


def _x(b, s, d, seed=1):
    return np.random.default_rng(seed).normal(size=(b, s, d)).astype(
        np.float32)


def test_causal_conv_and_conv_step_match_reference():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 9, 12)).astype(np.float32)
    w = rng.normal(size=(4, 12)).astype(np.float32)
    b = rng.normal(size=(12,)).astype(np.float32)
    np.testing.assert_allclose(
        tm._causal_conv(_t(x), _t(w), _t(b)).numpy(),
        np.asarray(jm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(b))), **TOL)
    state = rng.normal(size=(2, 3, 12)).astype(np.float32)
    jy, js = jm._conv_step(jnp.asarray(state), jnp.asarray(x[:, 0]),
                           jnp.asarray(w), jnp.asarray(b))
    ty, ts = tm._conv_step(_t(state), _t(x[:, 0]), _t(w), _t(b))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("s", [16, 13, 3])
@pytest.mark.parametrize("groups", [1, 2])
def test_mamba_forward_with_cache_matches_reference(s, groups):
    """Whole, part and under-one chunk lengths (13 pads to 16)."""
    jcfg, cfg = _cfgs(groups=groups)
    jp, tp = _params(jcfg)
    x = _x(2, s, 32)
    jy, jc = jax.jit(lambda p, xx: jm.mamba_forward(
        p, xx, jcfg, return_cache=True))(jp, jnp.asarray(x))
    ty, tc = tm.mamba_forward(tp, _t(x), cfg, return_cache=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    assert set(tc) == set(jc)
    for name in jc:
        assert tc[name].dtype == torch.float32
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   **TOL)
    np.testing.assert_allclose(tm.mamba_forward(tp, _t(x), cfg).numpy(),
                               np.asarray(jy), **TOL)


def test_mamba_prefill_writes_the_cache_in_place():
    jcfg, cfg = _cfgs()
    _, tp = _params(jcfg)
    x = _t(_x(2, 11, 32))
    cache = {n: torch.zeros(spec.shape, dtype=spec.dtype)
             for n, spec in tm.mamba_cache_specs(cfg, 2).items()}
    held = dict(cache)
    y, out = tm.mamba_prefill(tp, x, cfg, cache)
    wy, want = tm.mamba_forward(tp, x, cfg, return_cache=True)
    assert out is cache and all(cache[n] is held[n] for n in held)
    assert torch.equal(y, wy)
    for n in want:
        assert torch.equal(cache[n], want[n])


@pytest.mark.parametrize("s", [1, 2])
def test_mamba_prefill_refuses_a_prompt_shorter_than_the_conv_state(s):
    """The reference's cache from such a prompt has s conv rows, not K-1,
    and its decode step fails on them; the port's prefill raises."""
    jcfg, cfg = _cfgs()
    jp, tp = _params(jcfg)
    x = _x(2, s, 32)
    _, jc = jm.mamba_forward(jp, jnp.asarray(x), jcfg, return_cache=True)
    assert jc["conv_x"].shape[1] == s < 3
    with pytest.raises(ValueError):             # 3 conv rows wanted
        jm.mamba_decode(jp, jnp.asarray(x[:, :1]), jcfg, jc)
    cache = {n: torch.zeros(spec.shape, dtype=spec.dtype)
             for n, spec in tm.mamba_cache_specs(cfg, 2).items()}
    with pytest.raises(ValueError, match="at least 3 tokens"):
        tm.mamba_prefill(tp, _t(x), cfg, cache)


@pytest.mark.parametrize("groups", [1, 2])
def test_mamba_decode_step_by_step_matches_reference(groups):
    """Prefill 12 tokens, then 4 decode steps in each package: outputs and
    every cache leaf to 2e-5 at each step; all outputs together against
    the forward over the 16 tokens within the reference's 2e-4."""
    jcfg, cfg = _cfgs(groups=groups)
    jp, tp = _params(jcfg)
    x = _x(2, 16, 32)
    jy, jc = jax.jit(lambda p, xx: jm.mamba_forward(
        p, xx, jcfg, return_cache=True))(jp, jnp.asarray(x[:, :12]))
    ty, tc = tm.mamba_forward(tp, _t(x[:, :12]), cfg, return_cache=True)
    ys = [ty]
    dec = jax.jit(lambda p, xx, cc: jm.mamba_decode(p, xx, jcfg, cc))
    for t in range(12, 16):
        jyt, jc = dec(jp, jnp.asarray(x[:, t:t + 1]), jc)
        held = dict(tc)
        tyt, tc = tm.mamba_decode(tp, _t(x[:, t:t + 1]), cfg, tc)
        assert all(tc[n] is held[n] for n in held)        # in place
        np.testing.assert_allclose(tyt.numpy(), np.asarray(jyt), **TOL)
        for name in jc:
            np.testing.assert_allclose(tc[name].numpy(),
                                       np.asarray(jc[name]), **TOL)
        ys.append(tyt)
    full = tm.mamba_forward(tp, _t(x), cfg)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), full.numpy(),
                               rtol=2e-4, atol=2e-4)


def test_mamba_module_holds_the_reference_leaves():
    jcfg, cfg = _cfgs()
    jp, _ = _params(jcfg)
    mod = tm.Mamba(cfg, device="cpu", dtype=None)
    tree = mod.param_tree()
    assert {n: tuple(t.shape) for n, t in tree.items()} == \
        {n: tuple(a.shape) for n, a in jp.items()}
    want = {n: s.dtype for n, s in tm.mamba_specs(cfg).items()}
    assert {n: t.dtype for n, t in tree.items()} == want
    assert tm.dims(cfg) == jm.dims(jcfg)


def test_mamba_forward_and_decode_bf16_match_reference():
    """The declared dtypes (bf16 projections, fp32 conv, SSM scalars and
    cache) in both packages, bf16 activations: within 2e-2."""
    jcfg, cfg = _cfgs()
    jp = materialize(jm.mamba_specs(jcfg), jax.random.key(0))
    tp = {k: _t(np.asarray(v, np.float32)).to(
        torch.bfloat16 if v.dtype == jnp.bfloat16 else torch.float32)
        for k, v in jp.items()}
    x = _x(2, 12, 32)
    jy, jc = jax.jit(lambda p, xx: jm.mamba_forward(
        p, xx, jcfg, return_cache=True))(jp, jnp.asarray(x, jnp.bfloat16))
    ty, tc = tm.mamba_forward(tp, _t(x).to(torch.bfloat16), cfg,
                              return_cache=True)
    assert ty.dtype == torch.bfloat16
    np.testing.assert_allclose(ty.float().numpy(), np.asarray(jy, np.float32),
                               rtol=2e-2, atol=2e-2)
    x1 = _x(2, 1, 32, seed=5)
    jy1, jc = jm.mamba_decode(jp, jnp.asarray(x1, jnp.bfloat16), jcfg, jc)
    ty1, tc = tm.mamba_decode(tp, _t(x1).to(torch.bfloat16), cfg, tc)
    np.testing.assert_allclose(ty1.float().numpy(),
                               np.asarray(jy1, np.float32), rtol=2e-2,
                               atol=2e-2)
    for name in jc:
        assert tc[name].dtype == torch.float32
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   rtol=2e-2, atol=2e-2)
