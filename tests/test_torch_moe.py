"""The port's MoE layer (``models/moe.py``) held against the reference's on
the same numpy inputs: the router's top-k, the aux losses, the dense path
with and without a shared expert (every expert chunking the port may
take), the dispatch, in fp32 (2e-5, ``tests/test_mixers.py``'s
tolerance) and bf16 (2e-2)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as JArchConfig
from repro.configs.base import MoEConfig as JMoEConfig
from repro.models import moe as jmoe
from repro.models.params import materialize
from repro.sharding.rules import ShardCtx as JShardCtx
from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.models import moe as tmoe
from repro_torch.sharding.rules import ShardCtx

TOL = dict(rtol=2e-5, atol=2e-5)


def _cfgs(e=4, k=2, shared=0, d=32, ff=32):
    """The same MoE config in both packages (``test_mixers._moe_cfg``)."""
    kw = dict(name="e", family="moe", num_layers=1, d_model=d, num_heads=2,
              num_kv_heads=2, d_ff=64, vocab_size=64)
    mk = dict(num_experts=e, top_k=k, d_ff_expert=ff,
              num_shared_experts=shared, capacity_factor=8.0)
    return (JArchConfig(**kw, moe=JMoEConfig(**mk)),
            ArchConfig(**kw, moe=MoEConfig(**mk)))


def _params(jcfg, dtype=jnp.float32, seed=0):
    """(reference params, the same leaves as torch tensors)."""
    jp = jax.tree.map(lambda a: a.astype(dtype),
                      materialize(jmoe.moe_specs(jcfg), jax.random.key(seed)))
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    tp = jax.tree.map(
        lambda a: torch.from_numpy(np.array(a, np.float32)).to(tdt), jp)
    return jp, tp


def _x(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("t,e,k", [(16, 4, 2), (7, 32, 8), (33, 8, 1),
                                   (5, 256, 8)])
def test_router_topk_matches_reference(t, e, k):
    logits = _x((t, e), seed=t) * 3
    jg, ji = jmoe.router_topk(jnp.asarray(logits), k)
    tg, ti = tmoe.router_topk(torch.from_numpy(logits), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **TOL)
    np.testing.assert_allclose(tg.sum(-1).numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("t,e,k", [(16, 4, 2), (64, 32, 8), (9, 256, 8)])
def test_aux_losses_match_reference(t, e, k):
    logits = _x((t, e), seed=e) * 2
    _, ji = jmoe.router_topk(jnp.asarray(logits), k)
    want = jmoe.aux_losses(jnp.asarray(logits), ji, e, 1e-2, 1e-3)
    got = tmoe.aux_losses(torch.from_numpy(logits),
                          torch.from_numpy(np.asarray(ji).astype(np.int64)),
                          e, 1e-2, 1e-3)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# 16 tokens x (2 x 32 + 3 x 32) = 2,560 transient elements an expert
@pytest.mark.parametrize("shared", [0, 1, 2])
@pytest.mark.parametrize("budget,chunk", [(None, 4), (2560, 1), (7680, 3),
                                          (10239, 3)])
def test_moe_dense_matches_reference(monkeypatch, shared, budget, chunk):
    """Every chunking of the experts (the budget lowered to force 1 or 3
    of the 4 a chunk) gives the reference's output and aux: only the
    order of the sum over experts differs."""
    if budget is not None:
        monkeypatch.setattr(tmoe, "EXPERT_CHUNK_ELEMENTS", budget)
    assert tmoe.expert_chunk(16, 32, 32, 4) == chunk
    jcfg, cfg = _cfgs(shared=shared)
    jp, tp = _params(jcfg)
    x = _x((2, 8, 32))
    jy, jaux = jmoe.moe_dense(jp, jnp.asarray(x), jcfg)
    ty, taux = tmoe.moe_dense(tp, torch.from_numpy(x), cfg)
    assert ty.shape == (2, 8, 32) and ty.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


def test_moe_dense_bf16_matches_reference(monkeypatch):
    monkeypatch.setattr(tmoe, "EXPERT_CHUNK_ELEMENTS", 3 * 2560)
    jcfg, cfg = _cfgs(e=8, k=2, shared=1)
    jp, tp = _params(jcfg, jnp.bfloat16)
    jp["router"] = jp["router"].astype(jnp.float32)     # declared fp32
    tp["router"] = tp["router"].to(torch.float32)
    x = _x((2, 8, 32))
    jy, jaux = jmoe.moe_dense(jp, jnp.asarray(x, jnp.bfloat16), jcfg)
    ty, taux = tmoe.moe_dense(tp, torch.from_numpy(x).to(torch.bfloat16),
                              cfg)
    assert ty.dtype == torch.bfloat16
    np.testing.assert_allclose(ty.to(torch.float32).numpy(),
                               np.asarray(jy, np.float32), rtol=2e-2,
                               atol=2e-2)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=2e-2)


@pytest.mark.parametrize("impl", ["auto", "dense"])
def test_apply_moe_takes_the_dense_path_without_a_mesh(impl):
    """Without a mesh the reference's ``apply_moe`` is ``moe_dense``; so
    is the port's, whose context has no mesh."""
    jcfg, cfg = _cfgs(shared=1)
    jp, tp = _params(jcfg)
    x = _x((1, 6, 32), seed=4)
    jy, jaux = jmoe.apply_moe(jp, jnp.asarray(x), jcfg,
                              JShardCtx(moe_impl=impl), capacity_factor=0.1)
    ctx = ShardCtx(moe_impl=impl)
    ty, taux = tmoe.apply_moe(tp, torch.from_numpy(x), cfg, ctx)
    dy, daux = tmoe.moe_dense(tp, torch.from_numpy(x), cfg)
    assert torch.equal(ty, dy) and torch.equal(taux, daux)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("impl", ["sharded", "sharded2d", "sharded_a2a"])
def test_shard_ctx_refuses_a_sharded_moe_impl(impl):
    """The sharded paths need a mesh, which the port does not have yet:
    the context refuses them rather than quietly serving the dense one."""
    with pytest.raises(ValueError, match="need a mesh"):
        ShardCtx(moe_impl=impl)


def test_moe_module_holds_the_reference_leaves():
    """``MoE``'s parameter tree has the reference's leaves and shapes (the
    shared expert as the nested ``shared`` dict), and its forward is
    ``moe_dense`` on them, after the leaves were written in place."""
    jcfg, cfg = _cfgs(shared=1)
    jp, tp = _params(jcfg)
    mod = tmoe.MoE(cfg, device="cpu", dtype=torch.float32)
    tree = mod.param_tree()
    assert jax.tree.map(lambda a: tuple(a.shape), tree) == \
        jax.tree.map(lambda a: tuple(a.shape), jp)
    with torch.no_grad():
        for name, leaf in tp.items():
            if name == "shared":
                for n, a in leaf.items():
                    getattr(mod.shared, n).copy_(a)
            else:
                getattr(mod, name).copy_(leaf)
    x = torch.from_numpy(_x((2, 5, 32), seed=7))
    y, aux = mod(x)
    wy, waux = tmoe.moe_dense(tp, x, cfg)
    assert torch.equal(y, wy) and torch.equal(aux, waux)


@pytest.mark.parametrize("tokens,d,ff,e,want", [
    (1024, 7168, 2048, 256, 10),     # deepseek-v3's prefill at B 1 x 1,024
    (1, 7168, 2048, 256, 256),       # its decode step: one chunk
    (8192, 1024, 512, 32, 8),        # granite at B 4 x 2,048
    (2048, 8192, 24576, 16, 1),      # jamba: one expert a chunk
])
def test_expert_chunk_bounds_the_transients(tokens, d, ff, e, want):
    """The most experts whose transients stay under the budget, at least
    one, at most all."""
    n = tmoe.expert_chunk(tokens, d, ff, e)
    assert n == want
    per_expert = tokens * (2 * ff + 3 * d)
    assert n == 1 or n * per_expert <= tmoe.EXPERT_CHUNK_ELEMENTS
    assert n == e or (n + 1) * per_expert > tmoe.EXPERT_CHUNK_ELEMENTS
