"""Port's ring-cache serving path (``LM.prefill``/``LM.decode`` through
``runtime/serve.py``) held against the reference's jitted steps on the same
fp32 weights, and its ring-cache helpers and cache converters held to the
reference's with ``==``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.runtime import serve as jserve
from repro.sharding.rules import ShardCtx as JShardCtx
from repro_torch.configs.registry import get_smoke
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import attention as tattn
from repro_torch.models.convert import cache_from_numpy, cache_to_numpy
from repro_torch.runtime.serve import make_decode_step, make_prefill_step
from repro_torch.serving.engine import DecodeEngine, paged_kv_config
from repro_torch.serving.scheduler import Request
from repro_torch.sharding.rules import ShardCtx

from _torch_port_util import numpy_tree, port_model, reference_model

ARCHS = ("h2o-danube-1.8b", "qwen2-1.5b", "qwen2-7b", "qwen3-32b")
PROMPT, STEPS = 40, 6            # 40 > 2 x danube-smoke's window of 16


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ARCHS:
        cfg, jmodel, params = reference_model(arch=arch)
        out[arch] = (cfg, jmodel, params, port_model(params, arch=arch))
    return out


def _fp32_cache(jmodel, batch, max_len):
    return jax.tree.map(
        lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a,
        jmodel.init_cache(batch, max_len))


# ------------------------------------------------------------ ring helpers --
@pytest.mark.parametrize("seq,window", [(3, None), (12, None), (12, 3),
                                        (3, 3)])
def test_ring_cache_helpers_match_reference(seq, window):
    """Fill, then one update per row at positions past the width (the ring
    wraps), then the decode mask: all equal to the reference's."""
    rng = np.random.default_rng(seq * 10 + (window or 0))
    b, w, hkv, d = 3, 5, 2, 4
    cache = {"k": rng.standard_normal((b, w, hkv, d)).astype(np.float32),
             "v": rng.standard_normal((b, w, hkv, d)).astype(np.float32),
             "pos": np.full((b, w), -1, np.int32)}
    k = rng.standard_normal((b, seq, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, seq, hkv, d)).astype(np.float32)
    positions = (np.arange(seq)[None] + np.array([[0], [3], [7]])).astype(
        np.int32)
    k1 = rng.standard_normal((b, 1, hkv, d)).astype(np.float32)
    v1 = rng.standard_normal((b, 1, hkv, d)).astype(np.float32)
    new_pos = positions[:, -1] + 1

    jc = jattn.ring_cache_fill({n: jnp.asarray(a) for n, a in cache.items()},
                               jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(positions))
    tc = {n: torch.from_numpy(a.copy()) for n, a in cache.items()}
    same = tattn.ring_cache_fill(tc, torch.from_numpy(k), torch.from_numpy(v),
                                 torch.from_numpy(positions))
    assert same is tc                                   # written in place
    for n in cache:
        np.testing.assert_array_equal(tc[n].numpy(), np.asarray(jc[n]))

    jc = jattn.ring_cache_update(jc, jnp.asarray(k1), jnp.asarray(v1),
                                 jnp.asarray(new_pos))
    tattn.ring_cache_update(tc, torch.from_numpy(k1), torch.from_numpy(v1),
                            torch.from_numpy(new_pos))
    for n in cache:
        np.testing.assert_array_equal(tc[n].numpy(), np.asarray(jc[n]))
    assert (tc["pos"].numpy().max(axis=1) == new_pos).all()

    jm = jattn.ring_cache_mask(jc["pos"], jnp.asarray(new_pos), window)
    tm = tattn.ring_cache_mask(tc["pos"], torch.from_numpy(new_pos), window)
    assert tm.shape == (b, 1, 1, 1, w)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(
        tattn.init_cache_pos(tc)["pos"].numpy(),
        np.asarray(jattn.init_cache_pos(jc)["pos"]))


# -------------------------------------------------------------- converters --
def test_cache_round_trip_and_init_cache(models):
    cfg, jmodel, _, tmodel = models["h2o-danube-1.8b"]
    jcache = numpy_tree(_fp32_cache(jmodel, 2, 20))
    rng = np.random.default_rng(0)
    jcache = jax.tree.map(
        lambda a: (rng.standard_normal(a.shape).astype(np.float32)
                   if a.dtype == np.float32
                   else rng.integers(-1, 50, a.shape).astype(np.int32)),
        jcache)
    cache = cache_from_numpy(jcache, cfg, device="cpu")
    blk = cache["groups"][0]["blocks"][0]
    assert blk["k"].shape == (2, 2, 16, 2, 16)          # W = window = 16
    assert blk["k"].dtype == torch.float32 and blk["pos"].dtype == torch.int32
    back = cache_to_numpy(cache)
    assert jax.tree.structure(back) == jax.tree.structure(jcache)
    jax.tree.map(np.testing.assert_array_equal, back, jcache)
    bf16 = cache_from_numpy(jcache, cfg, device="cpu", dtype=None)
    assert bf16["groups"][0]["blocks"][0]["v"].dtype == torch.bfloat16
    # an empty cache of the port is the reference's empty cache
    jax.tree.map(np.testing.assert_array_equal,
                 cache_to_numpy(tmodel.init_cache(2, 20)),
                 numpy_tree(_fp32_cache(jmodel, 2, 20)))


@pytest.mark.parametrize("breakage", ["missing", "extra", "shape", "width"])
def test_cache_from_numpy_raises(models, breakage):
    cfg, jmodel, _, _ = models["h2o-danube-1.8b"]
    tree = numpy_tree(_fp32_cache(jmodel, 2, 20))
    blk = dict(tree["groups"][0]["blocks"][0])
    if breakage == "missing":
        del blk["v"]
    elif breakage == "extra":
        blk["scale"] = np.ones(3, np.float32)
    elif breakage == "shape":
        blk["pos"] = blk["pos"][:, :1]
    else:                        # wider than the window: not danube's ring
        blk = {n: np.concatenate([a, a], axis=2) for n, a in blk.items()}
    tree = {"groups": ({"blocks": (blk,)},)}
    with pytest.raises(ValueError):
        cache_from_numpy(tree, cfg, device="cpu")


# ----------------------------------------------------- prefill + decode ----
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["flash", "blocked", "dot"])
def test_prefill_and_decode_match_reference(models, arch, impl):
    """B 2 x 40-token prompts, then 6 greedy decode steps through each
    framework's serve steps: logits to 1e-4, the cache's K/V to 1e-5, its
    ``pos`` and the token streams with ``==``."""
    cfg, jmodel, params, tmodel = models[arch]
    rng = np.random.default_rng(5)
    b = 2
    toks = rng.integers(0, cfg.vocab_size, (b, PROMPT))
    positions = np.tile(np.arange(PROMPT), (b, 1))
    jcache = _fp32_cache(jmodel, b, PROMPT + STEPS)
    tcache = cache_from_numpy(numpy_tree(jcache), get_smoke(arch),
                              device="cpu")
    jctx = JShardCtx(attn_impl=impl)
    jpre = jax.jit(jserve.make_prefill_step(jmodel, jctx))
    jdec = jax.jit(jserve.make_decode_step(jmodel, jctx))
    ctx = ShardCtx(attn_impl=impl)
    tpre, tdec = make_prefill_step(tmodel, ctx), make_decode_step(tmodel, ctx)

    def check(jl, tl, jcache, tcache):
        assert tl.shape == (b, 1, cfg.vocab_size) and tl.dtype == torch.float32
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=1e-4)
        want = numpy_tree(jcache)["groups"][0]["blocks"][0]
        got = cache_to_numpy(tcache)["groups"][0]["blocks"][0]
        np.testing.assert_array_equal(got["pos"], want["pos"])
        for n in ("k", "v"):
            np.testing.assert_allclose(got[n], want[n], rtol=0, atol=1e-5)

    fa_ops.launches = 0
    jl, jcache = jpre(params, jnp.asarray(toks), jnp.asarray(positions),
                      jcache)
    tl, tcache2 = tpre(torch.from_numpy(toks), torch.from_numpy(positions),
                       tcache)
    assert tcache2 is tcache                            # written in place
    check(jl, tl, jcache, tcache)
    jt = np.asarray(jnp.argmax(jl[:, -1], axis=-1))
    tt = torch.argmax(tl[:, -1], dim=-1)
    jstream, tstream = [jt.tolist()], [tt.tolist()]
    for step in range(STEPS):
        pos = np.full((b,), PROMPT + step, np.int32)
        jl, jcache = jdec(params, jnp.asarray(jt[:, None], jnp.int32),
                          jnp.asarray(pos), jcache)
        tl, _ = tdec(tt[:, None], torch.from_numpy(pos), tcache)
        check(jl, tl, jcache, tcache)
        jt = np.asarray(jnp.argmax(jl[:, 0], axis=-1))
        tt = torch.argmax(tl[:, 0], dim=-1)
        jstream.append(jt.tolist())
        tstream.append(tt.tolist())
    assert tstream == jstream
    assert fa_ops.launches == 0                         # CPU: plain version
    if cfg.sliding_window is not None:                  # the ring wrapped
        pos_buf = tcache["groups"][0]["blocks"][0]["pos"]
        last = PROMPT + STEPS - 1
        want = np.arange(last - cfg.sliding_window + 1, last + 1)
        assert (np.sort(pos_buf.numpy(), axis=-1) == want).all()


def test_ring_decode_matches_paged_engine(models):
    """Mirrors ``tests/test_serving.py::test_paged_decode_matches_ring_
    decode`` on the port alone: the ring-cache steps and the paged engine
    give the same greedy tokens for one 12-token prompt."""
    cfg, _, _, tmodel = models["qwen2-1.5b"]
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, 12))[None]
    cache = tmodel.init_cache(1, 40, dtype=torch.float32)
    ctx = ShardCtx()
    logits, cache = make_prefill_step(tmodel, ctx)(
        toks, torch.arange(12)[None], cache)
    ring = [int(torch.argmax(logits[0, -1]))]
    dec = make_decode_step(tmodel, ctx)
    pos, nt = 12, ring[0]
    for _ in range(3):
        lg, cache = dec(torch.tensor([[nt]]), torch.tensor([pos]), cache)
        nt = int(torch.argmax(lg[0, 0]))
        ring.append(nt)
        pos += 1
    eng = DecodeEngine(tmodel, paged_kv_config(cfg, page_size=8, num_local=32,
                                               num_pool=8), max_batch=1)
    eng.submit(Request(req_id=0, prompt_len=12, max_new_tokens=4),
               toks[0].numpy())
    for _ in range(4):
        eng.step()
    assert eng.outputs[0][:4] == ring


def test_shard_ctx_is_single_device_only(models):
    """A context takes no mesh but the port's own (``launch.mesh``), and
    without one it is the single-device context."""
    with pytest.raises(TypeError, match="Mesh"):
        ShardCtx(mesh=object())
    assert ShardCtx().mesh is None and ShardCtx().axis_size("model") == 1
    x = torch.ones(2)
    assert ShardCtx(attn_impl="flash").constrain(x) is x
    cfg, _, _, tmodel = models["h2o-danube-1.8b"]
    with pytest.raises(ValueError):                     # no such attention
        make_prefill_step(tmodel, ShardCtx(attn_impl="pallas"))(
            torch.zeros((1, 4), dtype=torch.int64), torch.arange(4)[None],
            tmodel.init_cache(1, 4))
