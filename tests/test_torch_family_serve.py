"""The port's serving steps (``runtime/serve.py``: ``LM.prefill`` and
``LM.decode`` over the cache) on the decoder-only families held against
``jax.jit`` of the reference's serve steps on the same fp32 weights, for
each of the three attention impls: the logits to 1e-4, every block's
cache leaves (ring K/V, MLA latents, Mamba conv and SSM states) within
rtol and atol 2e-5 (``tests/test_mixers.py``'s tolerance; the SSM states
reach ~10), every ``pos`` and the greedy token streams with ``==``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import serve as jserve
from repro.sharding.rules import ShardCtx as JShardCtx
from repro_torch.configs.registry import get_smoke
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.convert import cache_from_numpy, cache_to_numpy
from repro_torch.models.params import map_with_path
from repro_torch.runtime.serve import make_decode_step, make_prefill_step
from repro_torch.sharding.rules import ShardCtx

from _torch_port_util import numpy_tree, port_model, reference_model

ARCHS = ("granite-moe-1b-a400m", "mamba2-1.3b", "jamba-1.5-large-398b",
         "deepseek-v3-671b")
PROMPT, STEPS = 13, 4      # 13: not a whole chunk of the SSM smoke's 8


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    """(arch, cfg, reference model, params, port model, the reference's
    jitted decode step).  One decode step serves every impl: the
    reference's decode reads no ``attn_impl`` (its attention, MLA and
    Mamba decodes take none)."""
    cfg, jmodel, params = reference_model(0, request.param)
    jdec = jax.jit(jserve.make_decode_step(jmodel, JShardCtx()))
    return (request.param, cfg, jmodel, params,
            port_model(params, request.param), jdec)


def _flat(tree):
    out = {}
    map_with_path(out.__setitem__, tree)
    return out


@pytest.mark.parametrize("impl", ["flash", "blocked", "dot"])
def test_prefill_and_decode_match_reference(models, impl):
    arch, cfg, jmodel, params, tmodel, jdec = models
    rng = np.random.default_rng(5)
    b = 2
    toks = rng.integers(0, cfg.vocab_size, (b, PROMPT))
    positions = np.tile(np.arange(PROMPT), (b, 1))
    jcache = jax.tree.map(
        lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a,
        jmodel.init_cache(b, PROMPT + STEPS))
    tcache = cache_from_numpy(numpy_tree(jcache), get_smoke(arch),
                              device="cpu")
    jpre = jax.jit(jserve.make_prefill_step(jmodel,
                                            JShardCtx(attn_impl=impl)))
    ctx = ShardCtx(attn_impl=impl)
    tpre, tdec = make_prefill_step(tmodel, ctx), make_decode_step(tmodel, ctx)

    def check(jl, tl):
        assert tl.shape == (b, 1, cfg.vocab_size) and tl.dtype == torch.float32
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=1e-4)
        want = _flat(numpy_tree(jcache))
        got = _flat(cache_to_numpy(tcache))
        assert set(got) == set(want)
        for path, w in want.items():
            if path[-1] == "pos":
                np.testing.assert_array_equal(got[path], w, str(path))
            else:
                np.testing.assert_allclose(got[path], w, rtol=2e-5,
                                           atol=2e-5, err_msg=str(path))

    fa_ops.launches = 0
    jl, jcache = jpre(params, jnp.asarray(toks), jnp.asarray(positions),
                      jcache)
    tl, out = tpre(torch.from_numpy(toks), torch.from_numpy(positions),
                   tcache)
    assert out is tcache                                # written in place
    check(jl, tl)
    jt = np.asarray(jnp.argmax(jl[:, -1], axis=-1))
    tt = torch.argmax(tl[:, -1], dim=-1)
    jstream, tstream = [jt.tolist()], [tt.tolist()]
    for step in range(STEPS):
        pos = np.full((b,), PROMPT + step, np.int32)
        jl, jcache = jdec(params, jnp.asarray(jt[:, None], jnp.int32),
                          jnp.asarray(pos), jcache)
        tl, _ = tdec(tt[:, None], torch.from_numpy(pos), tcache)
        check(jl, tl)
        jt = np.asarray(jnp.argmax(jl[:, 0], axis=-1))
        tt = torch.argmax(tl[:, 0], dim=-1)
        jstream.append(jt.tolist())
        tstream.append(tt.tolist())
    assert tstream == jstream
    assert fa_ops.launches == 0                         # CPU: plain version
    flat = _flat(tcache)
    for path, t in flat.items():            # MLA and ring: every row filled
        if path[-1] == "pos":
            assert (t == torch.arange(PROMPT + STEPS)).all(), path
    if cfg.ssm is not None:
        ssm = [t for p, t in flat.items() if p[-1] == "ssm"]
        assert ssm and all(bool(t.abs().sum() > 0) for t in ssm)
