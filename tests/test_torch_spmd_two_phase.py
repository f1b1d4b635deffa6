"""The two-phase step with a mesh (M18d): ``runtime/train.py::
make_two_phase_steps`` on placed parameters, its pool tier placed and
counted by ``core/znuma.py::tier_place`` and ``TierAccount`` (one buffer a
distinct block).

Phase A (``grad_step``) is held against the reference's
``make_two_phase_steps`` grad step, jitted with ``(params_sh, batch_sh)``
as ``launch/dryrun.py::build_cell`` jits it, on deepseek-v3's smoke config
(its MTP head) and qwen2's.  The reference runs once for the module in one
subprocess under ``XLA_FLAGS=--xla_force_host_platform_device_count=8``,
on the same numpy tokens and the same seeded fp32 weights (carried into
the port by ``models/convert.py``).  Phase B (``opt_step``) is held to the
port's fused placed step (``jit_train_step``) from the same gradients:
``torch.equal`` on every parameter block and every state block, ``step``
and the grad norm ``==``; int8 moments to the unplaced two-phase step on
the same blocks (codes and scales ``==``).

Tolerances, fp32: the loss, the aux and the grad norm rtol 1e-5; the
gradients through the first moment they make (0.1 g) rtol/atol 1e-5, as
``tests/test_torch_spmd.py`` gates them.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke as jax_get_smoke
from repro.models.model_zoo import build_model as jax_build_model
from repro_torch.configs.registry import get_smoke
from repro_torch.core import znuma
from repro_torch.models import convert
from repro_torch.optim import adamw
from repro_torch.optim.compress import QTensor
from repro_torch.runtime import train as rt
from repro_torch.sharding import spmd
from repro_torch.sharding.rules import ShardCtx
from test_torch_spmd import LR, _flat_port, cpu_mesh, ctx_of

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
TOL = dict(rtol=1e-5, atol=1e-5)
#: (arch, mesh shape, microbatches)
CASES = [("deepseek-v3-671b", (2, 2), 1), ("qwen2-1.5b", (2, 4), 2)]
IDS = [f"{a.split('-')[0]}-{s[0]}x{s[1]}" for a, s, _ in CASES]
BATCH, SEQ = 8, 16


def tokens(vocab, seed=31):
    return np.random.default_rng(seed).integers(
        0, vocab, (BATCH, SEQ + 1)).astype(np.int32)


_SUBPROC = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
sys.path.insert(0, os.environ["TEST_DIR"])
import test_torch_spmd_two_phase as T
from repro.configs.registry import get_smoke
from repro.launch.mesh import make_mesh
from repro.models.model_zoo import build_model
from repro.optim import adamw
from repro.runtime import train as rt
from repro.sharding.rules import ShardCtx, default_rules, partition_tree

devs = jax.devices()
assert len(devs) == 8, devs
out = {}


def flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


for i, (arch, shape, mb) in enumerate(T.CASES):
    model = build_model(get_smoke(arch))
    p0 = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jax.jit(model.init_params)(jax.random.key(0)))
    for k, v in flat(p0).items():
        out[f"w{i}|{k}"] = v
    mesh = make_mesh(shape, ("data", "model"),
                     devices=devs[:int(np.prod(shape))])
    ctx = ShardCtx(mesh=mesh, pod_axis=None)
    psh = jax.tree.map(lambda s: NamedSharding(mesh, s), partition_tree(
        model.specs(), default_rules(ctx, mode="train"), mesh),
        is_leaf=lambda x: isinstance(x, P))
    bsh = {"tokens": NamedSharding(mesh, P(ctx.batch_axes, None))}
    grad_step, _ = rt.make_two_phase_steps(model, adamw.AdamWConfig(), ctx,
                                           microbatches=mb)
    fn = jax.jit(grad_step, in_shardings=(psh, bsh),
                 out_shardings=(psh, None))
    grads, m = fn(jax.tree.map(jax.device_put, p0, psh),
                  {"tokens": jnp.asarray(T.tokens(model.cfg.vocab_size))})
    for k in ("loss", "aux"):
        out[f"g{i}_{k}"] = np.asarray(m[k])
    out[f"g{i}_norm"] = np.asarray(adamw.global_norm(grads))
    for k, v in flat(grads).items():
        out[f"g{i}_g{k}"] = v
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's grad steps on 8 forced host devices, in one
    subprocess, and the seeded weights it drew."""
    path = tmp_path_factory.mktemp("spmd_two_phase") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               TEST_DIR=os.path.dirname(__file__))
    proc = subprocess.run([sys.executable, "-c", _SUBPROC, str(path)],
                          env=env, stdout=subprocess.DEVNULL,
                          stderr=subprocess.PIPE, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(path))


def port_model(ref, case):
    arch = CASES[case][0]
    specs = jax_build_model(jax_get_smoke(arch)).specs()
    tree = jax.tree_util.tree_map_with_path(
        lambda q, _: ref[f"w{case}|{jax.tree_util.keystr(q)}"], specs)
    return convert.params_from_numpy(tree, get_smoke(arch), device="cpu")


def _batch(model):
    return {"tokens": torch.from_numpy(tokens(model.cfg.vocab_size)).long()}


def _pool(placed, ocfg):
    return znuma.tier_place(adamw.init_state(placed, ocfg),
                            adamw.state_tier(None), "cpu")


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_grad_step_matches_reference(ref, case):
    """The placed ``grad_step``: the loss and the aux (deepseek's MTP term
    among them) and the gradients' global norm rtol 1e-5 against the
    reference's partitioned grad step, every gathered gradient through
    its first moment rtol/atol 1e-5, each placed like its parameter."""
    arch, shape, mb = CASES[case]
    model = port_model(ref, case)
    ctx = ctx_of(cpu_mesh(shape))
    grad_step, _ = rt.make_two_phase_steps(model, adamw.AdamWConfig(), ctx,
                                           microbatches=mb)
    placed = rt.placed_params(model, ctx)
    grads, m = grad_step(placed, _batch(model))
    for k in ("loss", "aux"):
        np.testing.assert_allclose(float(m[k]), float(ref[f"g{case}_{k}"]),
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(adamw.global_norm(grads)),
                               float(ref[f"g{case}_norm"]), rtol=1e-5)
    for n, g in grads.items():
        assert g.spec == placed[n].spec, n
    for k, a in _flat_port(grads, model).items():
        np.testing.assert_allclose(0.1 * a, 0.1 * ref[f"g{case}_g{k}"],
                                   err_msg=k, **TOL)


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_opt_step_equals_the_fused_placed_step(ref, case):
    """Two steps of the placed two-phase step and of the fused placed step
    from the same parameters and batch: every parameter block and every
    distinct state block ``torch.equal``, the grad norms and ``step``
    ``==``; every replica equal to its holder after each update; the
    pool tier one buffer a distinct block (replicated leaves once), as
    ``TierAccount`` counts it; no copy across devices on the CPU."""
    arch, shape, mb = CASES[case]
    model = port_model(ref, case)
    ctx = ctx_of(cpu_mesh(shape))
    ocfg = adamw.AdamWConfig(**LR)
    fused = rt.placed_params(model, ctx)
    f_opt = adamw.init_state(fused, ocfg)
    step = rt.jit_train_step(model, ocfg, ctx, microbatches=mb)
    two = rt.placed_params(model, ctx)
    pool = _pool(two, ocfg)
    grad_step, opt_step = rt.make_two_phase_steps(model, ocfg, ctx,
                                                  microbatches=mb)
    batch = _batch(model)
    for _ in range(2):
        fused, f_opt, fm = step(fused, f_opt, batch)
        grads, gm = grad_step(two, batch)
        two, pool, om = opt_step(two, pool, grads)
        assert float(gm["loss"]) == float(fm["loss"])
        assert float(om["grad_norm"]) == float(fm["grad_norm"])
        assert om["opt_bytes_in"] == om["opt_bytes_out"] == 0
        for n, p in two.items():
            home = spmd.home_ranks(p.mesh, p.spec)
            for r, b in enumerate(p.blocks):
                assert torch.equal(b, fused[n].blocks[r]), n
                assert torch.equal(b, p.blocks[home[r]]), n
            for g in ("master", "m", "v"):
                buf = pool[g][n]
                assert buf.ranks == p.distinct()
                for i, r in enumerate(buf.ranks):
                    assert torch.equal(buf.blocks[i],
                                       f_opt[g][n].blocks[r]), (g, n)
    assert [int(b) for b in pool["step"].blocks] == \
        [int(b) for b in f_opt["step"].blocks] == [2] * ctx.mesh.size
    acct = znuma.TierAccount().add(pool["m"], "pool")
    want = sum(b.numel() * 4 for p in two.values()
               for b in (p.blocks[r] for r in p.distinct()))
    assert acct.pool_bytes == want
    assert want < sum(b.numel() * 4 for p in two.values() for b in p.blocks)


def test_int8_moments_equal_the_unplaced_two_phase_step(ref):
    """int8 moments (the reference's rule points them at this step): two
    placed two-phase steps on deepseek's smoke config; the same two steps
    of the unplaced two-phase step on the distinct blocks themselves (the
    parameters a dict of the blocks, the gradients the placed step's)
    give the same codes and scales (``==``), the same parameters and the
    same grad norm; every replica equal to its holder."""
    model = port_model(ref, 0)
    ctx = ctx_of(cpu_mesh((2, 2)))
    ocfg = adamw.AdamWConfig(**LR, moments_dtype="int8")
    placed = rt.placed_params(model, ctx)
    pool = _pool(placed, ocfg)
    assert isinstance(pool["m"]["embed.tok"].blocks[0], QTensor)
    flat = {f"{n}#{r}": placed[n].blocks[r].detach().clone()
            for n in placed for r in placed[n].distinct()}
    flat_pool = znuma.tier_place(adamw.init_state(flat, ocfg),
                                 adamw.state_tier(None), "cpu")
    grad_step, opt_step = rt.make_two_phase_steps(model, ocfg, ctx)
    _, flat_opt = rt.make_two_phase_steps(model, ocfg, ShardCtx())
    batch = _batch(model)
    for _ in range(2):
        grads, _ = grad_step(placed, batch)
        flat_g = {f"{n}#{r}": grads[n].blocks[r] for n in placed
                  for r in placed[n].distinct()}
        placed, pool, om = opt_step(placed, pool, grads)
        flat, flat_pool, fom = flat_opt(flat, flat_pool, flat_g)
        assert float(om["grad_norm"]) == float(fom["grad_norm"])
    for n, p in placed.items():
        home = spmd.home_ranks(p.mesh, p.spec)
        assert all(torch.equal(b, p.blocks[h])
                   for b, h in zip(p.blocks, home)), n
        for i, r in enumerate(p.distinct()):
            assert torch.equal(p.blocks[r], flat[f"{n}#{r}"]), n
            for g in ("m", "v"):
                q, w = pool[g][n].blocks[i], flat_pool[g][f"{n}#{r}"]
                assert torch.equal(q.data, w.data), (g, n)
                assert torch.equal(q.scale, w.scale), (g, n)


@pytest.mark.parametrize("moments", ["float32", "int8"])
def test_init_placed_pool_equals_tier_place_of_the_state(moments):
    """``adamw.init_placed_pool`` (the pool tier made a parameter at a
    time) ``==`` ``tier_place`` of the whole placed state: the same
    distinct ranks, every buffer ``torch.equal`` (codes and scales for
    int8), ``step`` placed; replicated leaves one buffer, split leaves
    one a block."""
    model = port_model_plain()
    ctx = ctx_of(cpu_mesh((2, 2)))
    ocfg = adamw.AdamWConfig(**LR, moments_dtype=moments)
    placed = rt.placed_params(model, ctx)
    a = adamw.init_placed_pool(placed, ocfg, "cpu")
    b = _pool(placed, ocfg)
    assert isinstance(a["step"], spmd.Placed)
    for g in ("master", "m", "v"):
        assert list(a[g]) == list(placed)
        for n, p in placed.items():
            x, y = a[g][n], b[g][n]
            assert x.ranks == y.ranks == p.distinct()
            assert len(x.blocks) == (1 if not spmd.spec_axes(p.spec)
                                     else len(p.distinct()))
            for u, w in zip(x.blocks, y.blocks):
                if isinstance(u, QTensor):
                    assert torch.equal(u.data, w.data)
                    assert torch.equal(u.scale, w.scale)
                else:
                    assert torch.equal(u, w)


def test_unplaced_steps_unchanged():
    """Unplaced parameters on a mesh (the dry run's case: ``make_two_phase_
    steps`` with a mesh, the model's own parameters) take the unplaced
    steps: the grads are plain tensors and the opt step updates the
    model's own parameters, as without a mesh."""
    model = port_model_plain()
    ctx = ctx_of(cpu_mesh((1, 1)))
    ocfg = adamw.AdamWConfig(**LR)
    params = rt.train_params(model)
    state = znuma.tier_place(adamw.init_state(params, ocfg),
                             adamw.state_tier(None), "cpu")
    grad_step, opt_step = rt.make_two_phase_steps(model, ocfg, ctx)
    grads, _ = grad_step(params, _batch(model))
    assert all(isinstance(g, torch.Tensor) for g in grads.values())
    before = {n: p.detach().clone() for n, p in params.items()}
    opt_step(params, state, grads)
    assert any(not torch.equal(p, before[n]) for n, p in params.items())


def port_model_plain():
    from repro_torch.models.model_zoo import build_model
    model = build_model(get_smoke("qwen2-1.5b"), device="cpu",
                        dtype=torch.float32)
    return model.init_params(torch.Generator().manual_seed(0))
