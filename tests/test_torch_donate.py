"""``runtime/train.py::jit_train_step(..., donate=False)`` never changes
the caller's tensors: the reference's ``donate=False`` leaves its inputs
valid (its ``launch/train.py`` passes it).  Without a mesh the eager
step reads and updates the model's own parameters, so ``donate=False``
raises ``ValueError`` before anything runs; on a mesh, one coordinate or
more, every family is placed (granite's MoE, qwen2's dense decoder,
mamba2, internvl2's vision frontend) and updates copies and returns
them.  Beside ``tests/test_torch_spmd.py::
test_decode_without_donation_keeps_the_callers_cache``, which holds the
serve step to the same contract."""
import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_smoke
from repro_torch.launch import mesh as tmesh
from repro_torch.models.model_zoo import build_model
from repro_torch.optim import adamw
from repro_torch.runtime import train as rt
from repro_torch.sharding import spmd
from repro_torch.sharding.rules import ShardCtx

CPU = torch.device("cpu")
OCFG = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)


def _setup(arch, shape):
    cfg = get_smoke(arch)
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    model.init_params(torch.Generator().manual_seed(0))
    mesh = tmesh.make_mesh(shape, ("data", "model"),
                           devices=[CPU] * int(np.prod(shape)))
    ctx = ShardCtx(mesh=mesh, pod_axis=None)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (4, 9)))
    return model, ctx, {"tokens": toks}


def _snapshot(tree):
    return spmd.map_tree(lambda x: None if x is None else (
        [b.detach().clone() for b in x.blocks] if isinstance(x, spmd.Placed)
        else x.detach().clone()), tree)


def _equal(a, b) -> bool:
    out = []
    spmd.map_tree(lambda x, y: out.append(
        x is None and y is None or torch.equal(x, y)), a, b)
    return all(out)


def test_eager_family_on_one_coordinate_refuses_donate_false():
    """internvl2 (the vision frontend, placed since the sharded steps take
    every family) on a (1, 1) mesh: ``donate=False`` updates copies and
    leaves the caller's parameters and AdamW state as they were.  Without
    a mesh the eager step reads and updates the model's own parameters:
    ``donate=False`` raises ``ValueError`` before anything runs, the
    state stays as it was, and with ``donate=True`` the step updates them
    in place."""
    model, ctx, batch = _setup("internvl2-26b", (1, 1))
    batch = dict(batch, embeds=torch.randn(
        4, 3, model.cfg.d_model, generator=torch.Generator().manual_seed(1)))
    placed = rt.placed_params(model, ctx)
    opt = adamw.init_state(placed, OCFG)
    before = _snapshot((placed, opt))
    p2, o2, m = rt.jit_train_step(model, OCFG, ctx, donate=False)(
        placed, opt, batch)
    assert np.isfinite(float(m["loss"]))
    assert _equal(_snapshot((placed, opt)), before)
    assert not _equal(_snapshot(p2), before[0])
    params = rt.train_params(model)
    opt = adamw.init_state(params, OCFG)
    before = _snapshot((params, opt))
    with pytest.raises(ValueError, match="donate=False"):
        rt.jit_train_step(model, OCFG, ShardCtx(), donate=False)
    assert _equal(_snapshot((params, opt)), before)
    rt.jit_train_step(model, OCFG, ShardCtx())(params, opt, batch)
    assert not _equal(_snapshot(params), before[0])


@pytest.mark.parametrize("arch,shape", [
    ("granite-moe-1b-a400m", (1, 1)), ("qwen2-1.5b", (1, 1)),
    ("granite-moe-1b-a400m", (2, 2)), ("mamba2-1.3b", (1, 1))], ids=str)
def test_placed_step_without_donation_keeps_the_callers_state(arch, shape):
    """A placed family's step with ``donate=False``: every parameter block
    and every AdamW leaf ``torch.equal`` to before the step, the returned
    state updated (the step counter at 1, the parameters moved)."""
    model, ctx, batch = _setup(arch, shape)
    placed = rt.placed_params(model, ctx)
    opt = adamw.init_state(placed, OCFG)
    before = _snapshot((placed, opt))
    p2, o2, m = rt.jit_train_step(model, OCFG, ctx, donate=False)(
        placed, opt, batch)
    assert np.isfinite(float(m["loss"]))
    assert _equal(_snapshot((placed, opt)), before)
    assert all(int(b) == 1 for b in o2["step"].blocks)
    assert not _equal(_snapshot(p2), before[0])
