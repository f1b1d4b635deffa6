"""The port's training stack against the reference, mirroring
``tests/test_runtime.py`` (its ten tests) and adding parity: chunked
cross-entropy, ``loss_fn``/``grads_fn`` (1 and 4 microbatches, fp32 and
bf16) against ``jax.value_and_grad`` of the reference's, one AdamW step
for each moment dtype (int8 codes ``==``), ``QTensor``, the data pipeline
and the checkpoint CRC ``==`` the reference's, a bitwise restart, the
loss falling over 30 smoke steps, the fused and two-phase steps giving
the same parameters, the zNUMA tier placement, the AdamW state carried
across packages and the training entry point on the CPU.  Inputs come
from numpy seeds; the reference's parameters are cast to fp32 for the
fp32 cases."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke as jax_get_smoke
from repro.data import pipeline as jax_pipeline
from repro.optim import adamw as jax_adamw
from repro.optim import compress as jax_compress
from repro.runtime import checkpoint as jax_ckpt
from repro.runtime import train as jax_rt
from repro.sharding.rules import ShardCtx as JShardCtx
from repro_torch.configs.registry import get_smoke
from repro_torch.core import znuma
from repro_torch.data.pipeline import DataConfig, ShardedBatches
from repro_torch.launch import train as launch_train
from repro_torch.models import convert
from repro_torch.models.model_zoo import build_model
from repro_torch.optim import adamw, compress
from repro_torch.runtime import checkpoint as ckpt
from repro_torch.runtime import train as rt
from repro_torch.sharding.rules import ShardCtx
from tests._torch_port_util import numpy_tree, port_model, reference_model

CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _smoke_model(seed=0, dtype=None):
    """The port's qwen2 smoke model on the CPU, seeded, parameters taking
    gradients (``dtype=None``: bf16 weights, fp32 norms and biases)."""
    model = build_model(get_smoke("qwen2-1.5b"), device="cpu", dtype=dtype)
    model.init_params(torch.Generator().manual_seed(seed))
    return model, rt.train_params(model)


def _batch(vocab, seq=32, gb=8, step=0):
    dc = DataConfig(vocab_size=vocab, seq_len=seq, global_batch=gb)
    return ShardedBatches(dc).batch_at(step)["tokens"]


def _close(got_by_name, model, want_tree, **tol):
    got = jax.tree.leaves(convert.stacked_to_numpy(got_by_name, model))
    want = jax.tree.leaves(jax.tree.map(np.asarray, want_tree))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b, np.float32), **tol)


# ----------------------------------------------------------- cross-entropy
@pytest.mark.parametrize("chunk", [7, 24, 512])
def test_chunked_xent_matches_reference(rng, chunk):
    B, S, D, V = 2, 24, 16, 50
    h = rng.normal(size=(B, S, D)).astype(np.float32)
    w = rng.normal(size=(D, V)).astype(np.float32)
    lab = rng.integers(0, V, (B, S)).astype(np.int32)
    lab[0, 3] = -1                                   # an ignored target

    def f(h, w):
        return jax_rt.chunked_xent(h, w, lab, chunk=chunk)
    want = jax.jit(f)(h, w)
    gwant = jax.jit(jax.grad(f, argnums=(0, 1)))(h, w)
    th, tw = _t(h).requires_grad_(True), _t(w).requires_grad_(True)
    got = rt.chunked_xent(th, tw, _t(lab), chunk=chunk)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    for a, b in zip(torch.autograd.grad(got, (th, tw)), gwant):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    # and the plain log-softmax mean over the valid targets
    logits = torch.einsum("bsd,dv->bsv", _t(h), _t(w))
    valid = _t(lab) >= 0
    ref = -torch.log_softmax(logits, -1).gather(
        -1, _t(lab).clamp_min(0).long()[..., None])[..., 0][valid].mean()
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-6)


# -------------------------------------------------------- loss and grads --
@pytest.fixture(scope="module")
def fp32_pair():
    cfg, jmodel, params = reference_model(0, "qwen2-1.5b")
    return cfg, jmodel, params, port_model(params, "qwen2-1.5b")


@pytest.mark.parametrize("microbatches", [1, 4])
def test_loss_and_grads_match_reference_fp32(fp32_pair, microbatches):
    cfg, jmodel, params, model = fp32_pair
    toks = _batch(cfg.vocab_size)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jax_rt.loss_fn(jmodel, p, b, JShardCtx()),
        has_aux=True))(params, {"tokens": jnp.asarray(toks)})
    tp = rt.train_params(model)
    total, metrics = rt.loss_fn(model, tp, {"tokens": _t(toks)}, ShardCtx())
    np.testing.assert_allclose(float(total.detach()), float(jl), rtol=1e-5)
    gw, mw = jax.jit(lambda p, b: jax_rt.grads_fn(
        jmodel, p, b, JShardCtx(), microbatches))(
            params, {"tokens": jnp.asarray(toks)})
    grads, m = rt.grads_fn(model, tp, {"tokens": _t(toks)}, ShardCtx(),
                           microbatches)
    np.testing.assert_allclose(float(m["loss"]), float(mw["loss"]),
                               rtol=1e-5, atol=1e-5)
    _close(grads, model, gw, rtol=1e-5, atol=1e-5)
    if microbatches == 1:
        _close(grads, model, jg, rtol=1e-5, atol=1e-5)
    for p in tp.values():
        p.requires_grad_(False)


@pytest.mark.parametrize("microbatches", [1, 4])
def test_loss_and_grads_match_reference_bf16(microbatches):
    """The declared dtypes (bf16 weights): the reference's bf16 tolerances
    (``test_microbatch_grad_equivalence``'s rtol 0.05 / atol 0.02)."""
    jcfg = jax_get_smoke("qwen2-1.5b")
    from repro.models.model_zoo import build_model as jax_build_model
    jmodel = jax_build_model(jcfg)
    params = jmodel.init_params(jax.random.key(0))
    model = convert.params_from_numpy(
        jax.tree.map(lambda a: np.asarray(a, np.float32), params),
        get_smoke("qwen2-1.5b"), device="cpu", dtype=None)
    toks = _batch(jcfg.vocab_size)
    gw, mw = jax.jit(lambda p, b: jax_rt.grads_fn(
        jmodel, p, b, JShardCtx(), microbatches))(
            params, {"tokens": jnp.asarray(toks)})
    tp = rt.train_params(model)
    grads, m = rt.grads_fn(model, tp, {"tokens": _t(toks)}, ShardCtx(),
                           microbatches)
    want_dtype = (torch.float32 if microbatches > 1 else None)
    for n, g in grads.items():
        assert g.dtype == (want_dtype or tp[n].dtype), n
    np.testing.assert_allclose(float(m["loss"]), float(mw["loss"]),
                               rtol=0.05, atol=0.02)
    _close(grads, model, gw, rtol=0.05, atol=0.02)


def test_microbatch_grad_equivalence():
    model, tp = _smoke_model()
    toks = {"tokens": _t(_batch(model.cfg.vocab_size))}
    g1, _ = rt.grads_fn(model, tp, toks, ShardCtx(), 1)
    g4, _ = rt.grads_fn(model, tp, toks, ShardCtx(), 4)
    for n in g1:
        np.testing.assert_allclose(g1[n].float().numpy(),
                                   g4[n].float().numpy(), rtol=0.05,
                                   atol=0.02)  # bf16 fwd
    with pytest.raises(ValueError, match="microbatches"):
        rt.grads_fn(model, tp, toks, ShardCtx(), 3)


def test_loss_decreases_30_steps():
    model, tp = _smoke_model()
    ocfg = adamw.AdamWConfig(lr=2e-2, warmup_steps=3, total_steps=40)
    opt = adamw.init_state(tp, ocfg)
    step = rt.jit_train_step(model, ocfg, ShardCtx())
    it = ShardedBatches(DataConfig(vocab_size=model.cfg.vocab_size,
                                   seq_len=32, global_batch=8))
    losses = []
    for _ in range(30):
        tp, opt, m = step(tp, opt, {"tokens": _t(next(it)["tokens"])})
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2, losses
    assert int(opt["step"]) == 30


# --------------------------------------------------------------- AdamW --
def test_adamw_reference_step():
    """One AdamW step against a hand-rolled reference."""
    ocfg = adamw.AdamWConfig(lr=0.1, warmup_steps=0, total_steps=10,
                             weight_decay=0.0, grad_clip=1e9,
                             min_lr_frac=1.0)
    p = {"w": torch.tensor([1.0, -2.0])}
    g = {"w": torch.tensor([0.5, -0.5])}
    st_ = adamw.init_state(p, ocfg)
    p2, st2, m = adamw.apply_updates(p, st_, g, ocfg)
    gw = g["w"].numpy()
    expect = np.array([1.0, -2.0]) - 0.1 * (
        (0.1 * gw / (1 - 0.9 ** 1))
        / (np.sqrt(0.05 * gw ** 2 / (1 - 0.95 ** 1)) + ocfg.eps))
    np.testing.assert_allclose(p2["w"].numpy(), expect, rtol=1e-5)
    assert int(st2["step"]) == 1 and float(m["lr"]) == pytest.approx(0.1)


@pytest.mark.parametrize("moments", ["float32", "bfloat16", "int8"])
def test_apply_updates_matches_reference(rng, moments):
    """Two AdamW steps on the same leaves and grads: parameters, master
    and moments at rtol 1e-6 (bf16 moments: one bf16 step), int8 codes
    ``==``."""
    shapes = {"a": (3, 300), "b": (517,), "c": (2, 2, 64)}
    ocfg = adamw.AdamWConfig(lr=0.05, warmup_steps=1, total_steps=5,
                             grad_clip=0.5, moments_dtype=moments)
    jcfg = jax_adamw.AdamWConfig(lr=0.05, warmup_steps=1, total_steps=5,
                                 grad_clip=0.5, moments_dtype=moments)
    p_np = {k: rng.normal(size=s).astype(np.float32)
            for k, s in shapes.items()}
    tp = {k: _t(v.copy()) for k, v in p_np.items()}
    jp = {k: jnp.asarray(v) for k, v in p_np.items()}
    opt, jopt = adamw.init_state(tp, ocfg), jax_adamw.init_state(jp, jcfg)
    for i in range(2):
        g_np = {k: (rng.normal(size=s) * (1 + i)).astype(np.float32)
                for k, s in shapes.items()}
        tp, opt, m = adamw.apply_updates(tp, opt, {k: _t(v) for k, v in
                                                   g_np.items()}, ocfg)
        jp, jopt, jm = jax_adamw.apply_updates(
            jp, jopt, {k: jnp.asarray(v) for k, v in g_np.items()}, jcfg)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        tol = dict(rtol=1e-6, atol=1e-7)
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       **tol)
            np.testing.assert_allclose(opt["master"][k].numpy(),
                                       np.asarray(jopt["master"][k]), **tol)
            for g in ("m", "v"):
                got, want = opt[g][k], jopt[g][k]
                if moments == "int8":
                    np.testing.assert_array_equal(got.data.numpy(),
                                                  np.asarray(want.data))
                    np.testing.assert_allclose(got.scale.numpy(),
                                               np.asarray(want.scale), **tol)
                else:
                    np.testing.assert_allclose(
                        got.float().numpy(),
                        np.asarray(want, np.float32), **tol)
    assert int(opt["step"]) == int(jopt["step"]) == 2


@pytest.mark.parametrize("seed,n", [(s, n) for s in (1, 2, 3, 4)
                                    for n in (3, 64, 257, 1000)])
def test_int8_quantization_error_bound(seed, n):
    """The reference's error bound, and the codes ``==`` the reference's
    ``QTensor.quantize`` on the same input."""
    x = np.random.default_rng(seed).normal(size=(n,)).astype(np.float32)
    x = x * 10
    err = float(compress.compression_error(_t(x)))
    assert err <= np.abs(x).max() / 127.0 + 1e-6
    got, want = compress.QTensor.quantize(_t(x)), \
        jax_compress.QTensor.quantize(jnp.asarray(x))
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(got.dequantize().numpy(),
                                  np.asarray(want.dequantize()))
    tree = compress.quantize_tree({"x": _t(x), "y": [_t(x[:2])]})
    back = compress.dequantize_tree(tree)
    assert back["y"][0].shape == (2,) and compress.QTensor.zeros(
        (5, 3)).dequantize().abs().sum() == 0


def test_int8_moments_training_step():
    model, tp = _smoke_model()
    ocfg = adamw.AdamWConfig(lr=1e-2, moments_dtype="int8")
    opt = adamw.init_state(tp, ocfg)
    gs, os_ = rt.make_two_phase_steps(model, ocfg, ShardCtx())
    b = {"tokens": _t(_batch(model.cfg.vocab_size, seq=16, gb=4))}
    g, _ = gs(tp, b)
    p2, o2, m = os_(tp, opt, g)
    assert bool(torch.isfinite(m["grad_norm"]))
    assert int(o2["step"]) == 1
    # the state lies on the parameters' device: no copy crosses a link
    assert m["opt_bytes_in"] == m["opt_bytes_out"] == 0


def test_fused_and_two_phase_give_the_same_parameters():
    """The two steps share the update: after a step (2 microbatches) the
    parameters, master and moments are ``torch.equal``; so is the loss."""
    model, tp = _smoke_model(seed=3)
    init = {n: p.detach().clone() for n, p in tp.items()}
    ocfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1)
    b = {"tokens": _t(_batch(model.cfg.vocab_size, seq=24, gb=4))}
    fused = launch_train.make_step(model, ocfg, ShardCtx(), two_phase=False,
                                   microbatches=2)
    opt_a = launch_train.init_opt_state(tp, ocfg, False, CPU)
    _, opt_a, m_a = fused(tp, opt_a, b)
    after_a = {n: p.detach().clone() for n, p in tp.items()}
    with torch.no_grad():
        for n, p in tp.items():
            p.copy_(init[n])
    two = launch_train.make_step(model, ocfg, ShardCtx(), two_phase=True,
                                 microbatches=2)
    opt_b = launch_train.init_opt_state(tp, ocfg, True, CPU)
    _, opt_b, m_b = two(tp, opt_b, b)
    assert float(m_a["loss"]) == float(m_b["loss"])
    assert float(m_a["grad_norm"]) == float(m_b["grad_norm"])
    for n, p in tp.items():
        assert torch.equal(p, after_a[n]), n
        for g in ("master", "m", "v"):
            assert torch.equal(opt_a[g][n], opt_b[g][n]), (g, n)
    assert m_b["opt_bytes_in"] == m_b["opt_bytes_out"] == 0   # one device


# ------------------------------------------------------ tiers and state --
def test_tier_place_and_account():
    model, tp = _smoke_model()
    ocfg = adamw.AdamWConfig(moments_dtype="int8")
    state = adamw.init_state(tp, ocfg)
    tiers = adamw.state_tier(state)
    placed = znuma.tier_place(state, tiers, "cpu")
    assert all(t.device == CPU for t in znuma.tree_tensors(placed))
    acct = znuma.TierAccount()
    for g, sub in placed.items():
        acct.add(sub, tiers[g])
    n = sum(p.numel() for p in tp.values())
    blocks = sum(-(-p.numel() // compress.BLOCK) for p in tp.values())
    assert acct.pool_bytes == 4 * n + 2 * (blocks * compress.BLOCK
                                           + 4 * blocks)
    assert acct.local_bytes == 4 and 0.99 < acct.pool_fraction < 1
    # a copy of every pool-tier leaf to another device moves the tier
    meta = torch.device("meta")
    assert sum(rt._crossing_bytes(x, meta) for g in ("master", "m", "v")
               for x in placed[g].values()) == acct.pool_bytes
    assert all(rt._crossing_bytes(x, CPU) == 0
               for x in placed["m"].values())
    with pytest.raises(ValueError, match="tier"):
        znuma.tier_place(state, {"m": "far"}, "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            znuma.tier_place(state, tiers)      # None is the card


def test_opt_state_and_params_cross_packages(fp32_pair):
    """The port's AdamW state and parameters through the reference's
    stacked tree and back, leaf for leaf; one reference step on the
    carried tree equals the port's step."""
    cfg, jmodel, params, model = fp32_pair
    np_params = convert.params_to_numpy(model)
    for a, b in zip(jax.tree.leaves(np_params),
                    jax.tree.leaves(numpy_tree(params))):
        np.testing.assert_array_equal(a, b)
    tp = dict(model.named_parameters())
    ocfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=0)
    state = adamw.init_state(tp, ocfg)
    grads = {n: torch.full_like(p, 0.01) for n, p in tp.items()}
    saved = {n: p.clone() for n, p in tp.items()}
    adamw.apply_updates(tp, state, grads, ocfg)
    tree = convert.opt_state_to_numpy(state, model)
    back = convert.opt_state_from_numpy(tree, model, device="cpu")
    for g in ("master", "m", "v"):
        for n in tp:
            assert torch.equal(back[g][n], state[g][n]), (g, n)
    assert int(back["step"]) == 1
    jstate = jax_adamw.init_state(params, jax_adamw.AdamWConfig(
        lr=1e-2, warmup_steps=0))
    jg = jax.tree.map(lambda a: jnp.full_like(a, 0.01), params)
    jp, jst, _ = jax_adamw.apply_updates(params, jstate, jg,
                                         jax_adamw.AdamWConfig(
                                             lr=1e-2, warmup_steps=0))
    # the clip scale's global norm sums in another order: a few ulps
    for a, b in zip(jax.tree.leaves(tree["m"]), jax.tree.leaves(jst["m"])):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5)
    _close(tp, model, jp, rtol=1e-6, atol=1e-7)
    with torch.no_grad():
        for n, p in tp.items():
            p.copy_(saved[n])


# ------------------------------------------------------------ data, CRC --
@pytest.mark.parametrize("hosts", [1, 2, 4])
def test_batches_equal_reference(hosts):
    dc = dict(vocab_size=97, seq_len=16, global_batch=8)
    for step in (0, 3, 11):
        for h in range(hosts):
            got = ShardedBatches(DataConfig(**dc), num_hosts=hosts,
                                 host_id=h).batch_at(step)["tokens"]
            want = jax_pipeline.ShardedBatches(
                jax_pipeline.DataConfig(**dc), num_hosts=hosts,
                host_id=h).batch_at(step)["tokens"]
            np.testing.assert_array_equal(got, want)
    it = ShardedBatches(DataConfig(**dc), start_step=3)
    np.testing.assert_array_equal(next(it)["tokens"], jax_pipeline
                                  .ShardedBatches(jax_pipeline.DataConfig(
                                      **dc)).batch_at(3)["tokens"])
    with pytest.raises(ValueError, match="split"):
        ShardedBatches(DataConfig(**dc), num_hosts=3)


def test_data_pipeline_deterministic_and_elastic():
    dc = DataConfig(vocab_size=97, seq_len=16, global_batch=8)
    one = ShardedBatches(dc, num_hosts=1, host_id=0).batch_at(5)["tokens"]
    two = [ShardedBatches(dc, num_hosts=2, host_id=h).batch_at(5)["tokens"]
           for h in range(2)]
    np.testing.assert_array_equal(one, np.concatenate(two, axis=0))
    again = ShardedBatches(dc, num_hosts=1, host_id=0).batch_at(5)["tokens"]
    np.testing.assert_array_equal(one, again)


def test_crc_equals_reference(rng):
    for arr in (rng.normal(size=(4, 5)).astype(np.float32),
                np.arange(7, dtype=np.int64), np.asarray(2.5),
                rng.integers(-127, 127, (3, 256)).astype(np.int8)):
        assert ckpt._crc(arr) == jax_ckpt._crc(arr)


# ---------------------------------------------------------- checkpoints --
def test_checkpoint_roundtrip_and_corruption(tmp_path, rng):
    tree = {"a": _t(rng.normal(size=(4, 5)).astype(np.float32)),
            "b": [torch.arange(7), {"c": torch.tensor(2.5)}],
            "h": torch.tensor([1.5, -2.25]).to(torch.bfloat16),
            "q": compress.QTensor.quantize(_t(rng.normal(size=300)
                                              .astype(np.float32)))}
    ckpt.save(str(tmp_path), 3, tree)
    back = ckpt.restore(str(tmp_path), 3, tree)
    assert back["h"].dtype == torch.bfloat16
    for x, y in zip(ckpt._leaves(tree), ckpt._leaves(back)):
        assert torch.equal(x, y)
    assert isinstance(back["q"], compress.QTensor)
    assert ckpt.latest_step(str(tmp_path)) == 3
    with open(os.path.join(tmp_path, "step_00000003",
                           "manifest.json")) as f:
        assert '"crc32"' in f.read()
    ckpt.corrupt_leaf(str(tmp_path), 3, 0)
    with pytest.raises(IOError):
        ckpt.restore(str(tmp_path), 3, tree)
    ckpt.restore(str(tmp_path), 3, tree, verify=False)  # best effort
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(str(tmp_path), 3, {"a": tree["a"]}, verify=False)


def test_checkpoint_async_save(tmp_path, rng):
    tree = {"w": _t(rng.normal(size=(64,)).astype(np.float32))}
    fut = ckpt.save(str(tmp_path), 7, tree, blocking=False)
    fut.result(timeout=30)
    back = ckpt.restore(str(tmp_path), 7, tree, device="cpu")
    assert torch.equal(tree["w"], back["w"])
    assert ckpt.available_steps(str(tmp_path)) == [7]
    assert ckpt.available_steps(str(tmp_path / "none")) == []


def test_train_restart_bitwise(tmp_path):
    """Kill/restart drill: the restored run reproduces the same next
    loss."""
    model, tp = _smoke_model()
    ocfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=20)
    opt = adamw.init_state(tp, ocfg)
    step = rt.jit_train_step(model, ocfg, ShardCtx())
    data = ShardedBatches(DataConfig(vocab_size=model.cfg.vocab_size,
                                     seq_len=16, global_batch=4))
    for i in range(3):
        tp, opt, _ = step(tp, opt, {"tokens": _t(data.batch_at(i)
                                                 ["tokens"])})
    ckpt.save(str(tmp_path), 3, (tp, opt))
    saved = {n: p.detach().clone() for n, p in tp.items()}
    b4 = {"tokens": _t(data.batch_at(3)["tokens"])}
    _, _, m_cont = step(tp, opt, b4)
    p2, o2 = ckpt.restore(str(tmp_path), 3, (saved, opt))
    with torch.no_grad():
        for n, p in tp.items():
            p.copy_(p2[n])
    _, _, m_rest = step(tp, o2, b4)
    assert float(m_cont["loss"]) == float(m_rest["loss"])


# ---------------------------------------------------------- entry point --
def test_launch_train_on_the_cpu_resumes(tmp_path, capsys):
    """``main`` with the reference's flags and ``--device cpu``: the loop's
    metrics, a checkpoint, and a resumed run that goes on from it."""
    argv = ["--smoke", "--steps", "4", "--global-batch", "4", "--seq-len",
            "16", "--device", "cpu", "--two-phase", "--microbatches", "2",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
            "--log-every", "2"]
    metrics: list = []
    params, opt = launch_train.run(launch_train.parse_args(argv), metrics)
    assert [m["step"] for m in metrics] == [1, 2, 3, 4]
    for m in metrics:
        assert np.isfinite(m["loss"]) and m["tokens"] == 4 * 16
        assert m["opt_bytes_in"] == m["opt_bytes_out"] == 0  # one device
    assert ckpt.available_steps(str(tmp_path)) == [2, 4]
    assert int(opt["step"]) == 4
    out = launch_train.main(argv[:2] + ["6"] + argv[3:])
    assert int(out[1]["step"]) == 6
    assert "restored step 4" in capsys.readouterr().out


def test_launch_train_takes_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_train.main(["--smoke", "--steps", "1"])
