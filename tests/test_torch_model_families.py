"""The port's decoder-only model families (MoE, MLA with the MTP head,
Mamba-2, and the dense qwen2-7b / qwen3-32b) held against the reference
on each architecture's smoke config with fp32 weights: the registry's
configs field by field, the full configs' parameter counts without
allocating, the parameters carried across both ways, ``LM.forward``
(``hidden``, ``aux``, ``mtp_hidden``), the empty cache and the cache
converters, the teacher-forced prefill + decode against the port's own
forward (``tests/test_models.py``'s tolerances) and the training loss's
MTP term.  The serving steps against the
reference's are ``tests/test_torch_family_serve.py``."""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models.model_zoo import build_model as jax_build_model
from repro.models.params import param_count as jax_param_count
from repro.runtime import train as jax_rt
from repro.sharding.rules import ShardCtx as JShardCtx
from repro_torch.configs import registry as treg
from repro_torch.models import convert
from repro_torch.models.model_zoo import build_model
from repro_torch.models.params import map_with_path, param_count
from repro_torch.models.params import tree_map_specs
from repro_torch.models.transformer import lm_specs
from repro_torch.runtime import train as rt
from repro_torch.sharding.rules import ShardCtx

from _torch_port_util import numpy_tree, port_model, reference_model

ARCHS = ("qwen2-7b", "qwen3-32b", "granite-moe-1b-a400m", "mamba2-1.3b",
         "jamba-1.5-large-398b", "deepseek-v3-671b")
TOL = dict(rtol=2e-5, atol=2e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


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


@functools.cache
def _deepseek():
    """deepseek's smoke config (the one with the MTP head): the reference's
    (cfg, model, fp32 params)."""
    return reference_model(0, "deepseek-v3-671b")


def _flat(tree):
    out = {}
    map_with_path(out.__setitem__, tree)
    return out


# ------------------------------------------------------------- configs ----
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_agree_field_by_field(arch):
    for getter in ("get_smoke", "get_config"):
        assert dataclasses.asdict(getattr(jreg, getter)(arch)) == \
            dataclasses.asdict(getattr(treg, getter)(arch))


def test_registry_knows_the_decoder_only_archs():
    """The registry is the reference's: all ten archs, in its order."""
    assert treg.ARCH_IDS == jreg.ARCH_IDS and len(treg.ARCH_IDS) == 10
    with pytest.raises(KeyError, match="unknown arch"):
        treg.get_config("llama-70b")


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_param_counts_match_reference(arch):
    """The published widths and depths: the spec trees' shapes and
    parameter counts ``==`` the reference's, and a model built on the meta
    device (nothing allocated) holds exactly that many parameters."""
    jspecs = jax_build_model(jreg.get_config(arch)).specs()
    cfg = treg.get_config(arch)
    specs = lm_specs(cfg)
    assert tree_map_specs(lambda s: tuple(s.shape), specs) == jax.tree.map(
        lambda s: tuple(s.shape), jspecs,
        is_leaf=lambda s: hasattr(s, "shape"))
    n = param_count(specs)
    assert n == jax_param_count(jspecs)
    model = build_model(cfg, device="meta")
    assert sum(p.numel() for p in model.parameters()) == n
    assert model.specs() == specs


# The parameters of each one-card run's config (G, to 2 decimals), as
# ``configs/one_card.py`` documents them
ONE_CARD_G = {("qwen2-7b", False): 7.62, ("qwen3-32b", False): 32.76,
              ("granite-moe-1b-a400m", False): 1.33,
              ("granite-moe-1b-a400m", True): 1.33,
              ("mamba2-1.3b", False): 1.34, ("mamba2-1.3b", True): 1.34,
              ("jamba-1.5-large-398b", False): 24.05,
              ("jamba-1.5-large-398b", True): 11.91,
              ("deepseek-v3-671b", False): 15.11,
              ("deepseek-v3-671b", True): 13.36}


@pytest.mark.parametrize("arch,fp32", list(ONE_CARD_G))
def test_one_card_cuts_keep_the_published_widths(arch, fp32):
    """``configs/one_card.py`` cuts depth only: every field but the layer
    stack (and deepseek's MTP head) is the registry's, the cut keeps every
    mixer kind the model has and every ffn kind but in deepseek's fp32 cut
    (its MoE layer alone), and its weights fit one 80 GB card."""
    from repro_torch.configs import one_card
    assert set(one_card.FAMILY_ARCHS) == set(ARCHS)
    assert not fp32 or arch in one_card.FP32_RUNS
    full, cut = treg.get_config(arch), one_card.one_card_config(arch, fp32)
    same = {f.name for f in dataclasses.fields(full)} - {
        "num_layers", "groups", "mtp_depth"}
    assert all(getattr(cut, f) == getattr(full, f) for f in same)
    assert cut.num_layers == sum(g.repeat * len(g.blocks)
                                 for g in cut.groups)

    def kinds(cfg, attr):
        return {getattr(b, attr) for g in cfg.groups for b in g.blocks}
    assert kinds(cut, "mixer") == kinds(full, "mixer")
    ffns = {"moe"} if (arch, fp32) == ("deepseek-v3-671b", True) else \
        kinds(full, "ffn")
    assert kinds(cut, "ffn") == ffns
    n = sum(math.prod(s.shape) for s in _flat(lm_specs(cut)).values())
    assert round(n / 1e9, 2) == ONE_CARD_G[arch, fp32]
    assert (4 if fp32 else 2) * n < 80e9


# ---------------------------------------------------------- parameters ----
def test_params_round_trip(models):
    """Every leaf (the stacked groups, the MoE's shared expert, the MTP
    head's unstacked subtree) crosses both ways unchanged."""
    _, cfg, _, params, model = models
    tree = numpy_tree(params)
    back = convert.params_to_numpy(model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    jax.tree.map(np.testing.assert_array_equal, back, tree)
    assert sum(p.numel() for p in model.parameters()) == sum(
        a.size for a in jax.tree.leaves(tree))
    assert (model.mtp is not None) == bool(cfg.mtp_depth)


def test_params_from_numpy_refuses_a_tree_without_the_mtp_head():
    _, _, params = _deepseek()
    tree = dict(numpy_tree(params))
    del tree["mtp"]
    with pytest.raises(ValueError, match="mtp"):
        convert.params_from_numpy(tree, treg.get_smoke("deepseek-v3-671b"),
                                  device="cpu")


# ------------------------------------------------------------- forward ----
@pytest.mark.parametrize("remat", [False, True])
def test_forward_matches_reference(models, remat):
    _, cfg, jmodel, params, model = models
    toks, pos = _tokens(cfg)
    want = jax.jit(lambda p, t, ps: jmodel.forward(p, t, ps))(
        params, toks, pos)
    got = model.forward(_t(toks), _t(pos), ShardCtx(remat=remat))
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name].detach().numpy(),
                                   np.asarray(want[name]), **TOL)
    assert (float(got["aux"]) > 0) == (cfg.moe is not None)


def test_prefill_decode_matches_forward(models):
    """Teacher-forced prefill + decode equals the parallel forward
    (``tests/test_models.py::test_prefill_decode_matches_forward``: hidden
    to 2e-4, logits to 2e-3), and the prefill's aux is the forward's over
    the same tokens."""
    _, cfg, _, _, model = models
    B, S, SPLIT = 2, 12, 8
    toks, pos = _tokens(cfg, B, S)
    tokens, pos = _t(toks).long(), _t(pos)
    with torch.no_grad():
        full = model.forward(tokens, pos)["hidden"]
        cache = model.init_cache(B, S, dtype=torch.float32)
        hp, cache, aux = model.prefill(tokens[:, :SPLIT], pos[:, :SPLIT],
                                       cache)
        np.testing.assert_allclose(hp.numpy(), full[:, :SPLIT].numpy(),
                                   rtol=2e-4, atol=2e-4)
        # the layers' aux over the same tokens (the forward's adds the MTP
        # head's block where there is one)
        _, want_aux = model._run_groups(model.embed(tokens[:, :SPLIT]),
                                        pos[:, :SPLIT], ShardCtx(), None,
                                        "train")
        w = model.lm_head_weight()
        for t in range(SPLIT, S):
            lg, cache = model.decode(tokens[:, t:t + 1], torch.full((B,), t),
                                     cache)
            np.testing.assert_allclose(lg[:, 0].numpy(),
                                       (full[:, t] @ w).numpy(), rtol=2e-3,
                                       atol=2e-3)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)
    assert (float(aux) > 0) == (cfg.moe is not None)


# --------------------------------------------------------------- caches ----
def _fp32(tree):
    return jax.tree.map(
        lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a,
        tree)


def test_init_cache_and_converters_match_reference(models):
    """The port's empty cache is the reference's (``pos`` -1 in ring and
    MLA caches, zeros elsewhere, Mamba states fp32); a cache of random
    values crosses both ways unchanged, any mix of block kinds."""
    arch, cfg, jmodel, _, model = models
    want = numpy_tree(_fp32(jmodel.init_cache(2, 20)))
    got = convert.cache_to_numpy(model.init_cache(2, 20,
                                                  dtype=torch.float32))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    jax.tree.map(np.testing.assert_array_equal, got, want)
    bf16 = _flat(model.init_cache(2, 20))
    for path, t in bf16.items():
        spec = _flat(model.cache_specs(2, 20))[path]
        assert t.dtype == spec.dtype, path
    rng = np.random.default_rng(0)
    tree = jax.tree.map(
        lambda a: (rng.standard_normal(a.shape).astype(np.float32)
                   if a.dtype == np.float32
                   else rng.integers(-1, 20, a.shape).astype(np.int32)),
        want)
    cache = convert.cache_from_numpy(tree, treg.get_smoke(arch),
                                     device="cpu")
    jax.tree.map(np.testing.assert_array_equal,
                 convert.cache_to_numpy(cache), tree)
    for path, t in _flat(convert.cache_from_numpy(
            tree, treg.get_smoke(arch), device="cpu", dtype=None)).items():
        assert t.dtype == _flat(model.cache_specs(2, 20))[path].dtype, path


@pytest.mark.parametrize("arch,breakage", [
    ("mamba2-1.3b", "missing"), ("mamba2-1.3b", "shape"),
    ("deepseek-v3-671b", "extra"), ("deepseek-v3-671b", "shape"),
    ("jamba-1.5-large-398b", "missing")])
def test_cache_from_numpy_raises(arch, breakage):
    jmodel = jax_build_model(jreg.get_smoke(arch))
    tree = numpy_tree(_fp32(jmodel.init_cache(2, 20)))
    blk = dict(tree["groups"][-1]["blocks"][0])
    name = sorted(blk)[0]
    if breakage == "missing":
        del blk[name]
    elif breakage == "extra":
        blk["scale"] = np.ones((1, 2, 3), np.float32)
    else:
        blk[name] = blk[name][:, :, :1]
    groups = list(tree["groups"])
    groups[-1] = {"blocks": (blk,) + tuple(groups[-1]["blocks"][1:])}
    with pytest.raises(ValueError):
        convert.cache_from_numpy({"groups": tuple(groups)},
                                 treg.get_smoke(arch), device="cpu")


# ------------------------------------------------------------ training ----
def test_loss_with_the_mtp_term_matches_reference():
    """deepseek's smoke config: the loss adds 0.3 x the MTP head's
    cross-entropy against t+2, as the reference's ``loss_fn``; the loss,
    its parts and the gradients of every parameter (the MTP head's
    included) agree."""
    cfg, jmodel, params = _deepseek()
    model = port_model(params, "deepseek-v3-671b")
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 17)).astype(np.int32)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jax_rt.loss_fn(jmodel, p, b, JShardCtx()),
        has_aux=True))(params, {"tokens": jnp.asarray(toks)})
    tp = rt.train_params(model)
    total, m = rt.loss_fn(model, tp, {"tokens": _t(toks).long()},
                          ShardCtx())
    np.testing.assert_allclose(float(total.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(m["loss"].detach()), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["aux"].detach()), float(jm["aux"]),
                               rtol=1e-5)
    assert float(total.detach()) > float(m["loss"].detach()
                                         + m["aux"].detach())  # MTP term
    grads, _ = rt.grads_fn(model, tp, {"tokens": _t(toks).long()},
                           ShardCtx())
    want = _flat(numpy_tree(jg))
    got = _flat(convert.stacked_to_numpy(grads, model))
    assert set(got) == set(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=1e-4,
                                   atol=1e-5, err_msg=str(path))
    for p in tp.values():
        p.requires_grad_(False)
