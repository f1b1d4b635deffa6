"""Port's model held against the reference's: weights carried across, the
prefill fill and one decode step on the same pools, tables and lengths."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import engine as jengine
from repro_torch.configs.registry import get_smoke
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model_zoo import build_model
from repro_torch.models.params import param_count
from repro_torch.serving import engine as tengine

from _torch_port_util import numpy_tree, port_model, reference_model

PAGE, NPAGES = 4, 24


@pytest.fixture(scope="module")
def models():
    cfg, jmodel, params = reference_model()
    return cfg, jmodel, params, port_model(params)


def test_params_round_trip(models):
    cfg, jmodel, params, tmodel = models
    tree = numpy_tree(params)
    blocks = tree["groups"][0]["blocks"][0]
    assert len(tmodel.blocks()) == cfg.num_layers
    for li, blk in enumerate(tmodel.blocks()):
        for sub in ("norm1", "mixer", "norm2", "ffn"):
            for name, leaf in blocks[sub].items():
                got = getattr(getattr(blk, sub), name)
                assert got.dtype == torch.float32
                np.testing.assert_array_equal(got.numpy(), leaf[li])
    np.testing.assert_array_equal(tmodel.embed.tok.numpy(),
                                  tree["embed"]["tok"])
    np.testing.assert_array_equal(tmodel.final_norm.scale.numpy(),
                                  tree["final_norm"]["scale"])
    n_leaves = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(tree))
    assert sum(p.numel() for p in tmodel.parameters()) == n_leaves
    assert param_count(tmodel.specs()) == n_leaves
    # tied embeddings: the head is the table, transposed, in both
    np.testing.assert_array_equal(tmodel.lm_head_weight().numpy(),
                                  np.asarray(jmodel.lm_head_weight(params)))


def test_spec_tree_has_the_reference_shapes(models):
    cfg, jmodel, params, tmodel = models
    want = jax.tree.map(lambda a: tuple(a.shape), params)
    from repro_torch.models.params import tree_map_specs
    got = tree_map_specs(lambda s: tuple(s.shape), tmodel.specs())
    assert got == want


@pytest.mark.parametrize("breakage", ["extra", "missing", "shape", "layers"])
def test_params_from_numpy_raises(models, breakage):
    tree = numpy_tree(models[2])
    blocks = dict(tree["groups"][0]["blocks"][0])
    if breakage == "extra":
        tree["embed"] = {**tree["embed"], "lm_head": np.zeros((64, 256))}
    elif breakage == "missing":
        blocks["mixer"] = {k: v for k, v in blocks["mixer"].items()
                           if k != "bq"}
    elif breakage == "shape":
        tree["final_norm"] = {"scale": np.ones(65, np.float32)}
    else:
        blocks = jax.tree.map(lambda a: np.concatenate([a, a[:1]]), blocks)
    tree["groups"] = ({"blocks": (blocks,)},)
    with pytest.raises(ValueError):
        params_from_numpy(tree, get_smoke("qwen2-1.5b"), device="cpu")


def test_seeded_init_follows_the_spec_rules():
    cfg = get_smoke("qwen2-1.5b")
    a = build_model(cfg, device="cpu", dtype=torch.float32).init_params(
        torch.Generator().manual_seed(3))
    b = build_model(cfg, device="cpu", dtype=torch.float32).init_params(
        torch.Generator().manual_seed(3))
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), n
    blk = a.blocks()[0]
    assert torch.all(blk.norm1.scale == 1) and torch.all(blk.mixer.bq == 0)
    # truncated normal in [-2, 2] scaled by 1/sqrt(fan_in); wo fans in (h, hd)
    assert blk.mixer.wq.abs().max() <= 2 / cfg.d_model ** 0.5 + 1e-6
    assert blk.mixer.wo.abs().max() <= \
        2 / (cfg.num_heads * cfg.head_dim) ** 0.5 + 1e-6
    assert 0.5 < blk.ffn.wi_gate.std() * cfg.d_model ** 0.5 < 1.0
    assert 0.015 < a.embed.tok.std() < 0.025
    # spec dtypes when no dtype is forced: bf16 weights, fp32 scales/biases
    m = build_model(cfg, device="cpu")
    assert m.blocks()[0].mixer.wq.dtype == torch.bfloat16
    assert m.blocks()[0].mixer.bq.dtype == torch.float32
    assert m.final_norm.scale.dtype == torch.float32


def _pools(cfg, rng):
    shape = (cfg.num_layers, cfg.num_kv_heads, NPAGES, PAGE, cfg.head_dim)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("plen", [5, 16])
def test_prefill_fill_matches_reference(models, plen):
    cfg, jmodel, params, tmodel = models
    rng = np.random.default_rng(plen)
    k0, v0 = _pools(cfg, rng)
    toks = rng.integers(0, cfg.vocab_size, (1, plen))
    npg = -(-(plen + 3) // PAGE)                  # with reserved tail pages
    pages = rng.permutation(NPAGES)[:npg].astype(np.int32)
    jl, jk, jv = jengine.make_paged_prefill_fill(jmodel, PAGE)(
        params, jnp.asarray(k0), jnp.asarray(v0), jnp.asarray(toks),
        jnp.asarray(pages))
    tk, tv = torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy())
    tl = tengine.make_paged_prefill_fill(tmodel, PAGE)(
        tk, tv, torch.from_numpy(toks), torch.from_numpy(pages))
    assert tl.shape == (1, 1, cfg.vocab_size) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
    # pools are filled in place; untouched pages keep their contents
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-5)
    rest = np.setdiff1d(np.arange(NPAGES), pages)
    np.testing.assert_array_equal(tk.numpy()[:, :, rest], k0[:, :, rest])


def test_decode_step_matches_reference(models):
    cfg, jmodel, params, tmodel = models
    rng = np.random.default_rng(11)
    k0, v0 = _pools(cfg, rng)
    lens = np.array([9, 1, 16], np.int32)         # incl. the new token
    maxp = 5
    tbl = np.zeros((3, maxp), np.int32)
    perm = rng.permutation(NPAGES)
    used = 0
    for i, n in enumerate(lens):
        npg = -(-int(n) // PAGE)
        tbl[i, :npg] = perm[used:used + npg]
        used += npg
    toks = rng.integers(0, cfg.vocab_size, (3, 1))
    jl, jk, jv = jengine.make_paged_decode_step(jmodel, PAGE)(
        params, jnp.asarray(k0), jnp.asarray(v0), jnp.asarray(tbl),
        jnp.asarray(lens), jnp.asarray(toks, jnp.int32))
    tk, tv = torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy())
    tl = tengine.make_paged_decode_step(tmodel, PAGE)(
        tk, tv, torch.from_numpy(tbl), torch.from_numpy(lens),
        torch.from_numpy(toks))
    assert tl.shape == (3, 1, cfg.vocab_size) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-5)
    # exactly one slot per row and layer was written
    changed = (tk.numpy() != k0).any(axis=-1)      # (L,Hkv,P,page)
    assert changed.sum() == cfg.num_layers * cfg.num_kv_heads * 3
