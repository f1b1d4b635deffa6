"""Training steps of the model families held to the reference on each
family's smoke config with fp32 weights: the MoE (granite), Mamba-2
(mamba2), the hybrid (jamba), MLA with its MTP head (deepseek), the
encoder-decoder (whisper, the reference read in fp32: F15) and the vision
frontend (internvl2).  One fused step (``launch/train.py::make_step``, 2
microbatches) and one two-phase step from the same parameters and batch,
each against the reference's ``make_train_step`` (``jax.jit``, fp32,
the same AdamW config): the loss and grad norm at rtol 1e-5, the first
moment after the step (0.1 x the clipped gradient) at rtol 1e-5 / atol
1e-6, and the parameters at rtol 1e-5 / atol 1e-6 wherever the clipped
gradient exceeds 1e-4.  The step-1 update is lr x g / (|g| + eps): where
|g| is within the gradients' own tolerance of 0 (whisper's cross-attention
key bias has a gradient of exactly 0 in exact arithmetic, its computed
one rounding noise) the direction is the noise's, so there the
parameters are held to the update's bound, 2 lr apart at most.  The two
steps' parameters ``torch.equal``.  And the chunked SSD's gradients where
its decay overflows fp32 (F17).  Inputs from numpy seeds."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import encdec as jencdec
from repro.optim import adamw as jax_adamw
from repro.runtime import train as jax_rt
from repro.sharding.rules import ShardCtx as JShardCtx
from repro_torch.launch import train as launch_train
from repro_torch.models import convert
from repro_torch.models.params import map_with_path
from repro_torch.optim import adamw
from repro_torch.runtime import train as rt
from repro_torch.sharding.rules import ShardCtx

from _torch_port_util import port_model, reference_model

ARCHS = ("granite-moe-1b-a400m", "mamba2-1.3b", "jamba-1.5-large-398b",
         "deepseek-v3-671b", "whisper-small", "internvl2-26b")
CPU = torch.device("cpu")
LR = 1e-2
B, S, MICRO = 4, 12, 2
STEP_TOL = dict(rtol=1e-5)
MOMENT_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)
#: |m| = 0.1 |clipped g| above which the update's direction is the
#: gradient's own (10x the moments' atol)
M_FLOOR = 1e-5


class _F32Numpy:
    """``jax.numpy`` with ``bfloat16`` read as ``float32`` (F15)."""
    bfloat16 = jnp.float32

    def __getattr__(self, name):
        return getattr(jnp, name)


def _batch(cfg, seed=5):
    """tokens (B, S+1) int32 and, with a frontend, its embeddings."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size,
                                  (B, S + 1)).astype(np.int32)}
    if cfg.is_encoder_decoder:
        out["embeds"] = (rng.standard_normal((B, 16, cfg.d_model))
                         * 0.5).astype(np.float32)
    elif cfg.frontend == "vision":
        out["embeds"] = (rng.standard_normal(
            (B, cfg.num_frontend_tokens, cfg.d_model)) * 0.05
        ).astype(np.float32)
    return out


def _jflat(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        out[tuple(getattr(k, "key", getattr(k, "idx", None))
                  for k in path)] = np.asarray(leaf)
    return out


def _flat(tree):
    out = {}
    map_with_path(out.__setitem__, tree)
    return out


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    arch = request.param
    cfg, jmodel, params = reference_model(0, arch)
    return arch, cfg, jmodel, params


def _reference_step(jmodel, params, batch):
    jcfg = jax_adamw.AdamWConfig(lr=LR, warmup_steps=1)
    opt = jax_adamw.init_state(params, jcfg)
    step = jax.jit(jax_rt.make_train_step(jmodel, jcfg, JShardCtx(),
                                          microbatches=MICRO))
    p2, o2, m = step(params, opt, {k: jnp.asarray(v)
                                   for k, v in batch.items()})
    return (_jflat(p2), _jflat(o2["m"]), float(m["loss"]),
            float(m["grad_norm"]))


def test_fused_and_two_phase_steps_match_reference(family, monkeypatch):
    arch, cfg, jmodel, params = family
    if cfg.is_encoder_decoder:
        monkeypatch.setattr(jencdec, "jnp", _F32Numpy())
    batch = _batch(cfg)
    want, want_m, want_loss, want_norm = _reference_step(jmodel, params,
                                                         batch)
    ocfg = adamw.AdamWConfig(lr=LR, warmup_steps=1)
    after = {}
    for two_phase in (False, True):
        model = port_model(params, arch)
        tp = rt.train_params(model)
        opt = launch_train.init_opt_state(tp, ocfg, two_phase, CPU)
        step = launch_train.make_step(model, ocfg, ShardCtx(),
                                      two_phase=two_phase,
                                      microbatches=MICRO)
        _, _, m = step(tp, opt, {k: torch.from_numpy(v)
                                 for k, v in batch.items()})
        np.testing.assert_allclose(float(m["loss"]), want_loss, **STEP_TOL)
        np.testing.assert_allclose(float(m["grad_norm"]), want_norm,
                                   **STEP_TOL)
        got = _flat(convert.stacked_to_numpy(
            {n: p.detach() for n, p in tp.items()}, model))
        got_m = _flat(convert.stacked_to_numpy(opt["m"], model))
        assert set(got) == set(want) == set(got_m)
        for k in want:
            np.testing.assert_allclose(got_m[k], want_m[k], **MOMENT_TOL,
                                       err_msg=f"{arch} m {k}")
            sure = np.abs(want_m[k]) > M_FLOOR
            np.testing.assert_allclose(got[k][sure], want[k][sure],
                                       **PARAM_TOL, err_msg=f"{arch} {k}")
            assert np.abs(got[k] - want[k]).max(initial=0) <= 2 * LR, k
        after[two_phase] = {n: p.detach().clone() for n, p in tp.items()}
    for n in after[False]:
        assert torch.equal(after[False][n], after[True][n]), n


def test_ssd_gradients_stay_finite_where_the_decay_overflows():
    """Steep decays (a = -12 a step over 16-step chunks: cum_q - cum_k up
    to 180 above the diagonal, past fp32's exp limit of 88): the port's
    chunked SSD gives the reference's output and finite gradients, where
    masking after the exp, as the reference does, gives NaN (F17)."""
    from repro.models import mamba2 as jax_mamba2
    from repro_torch.models import mamba2
    rng = np.random.default_rng(7)
    b, s, h, p, g, n, chunk = 2, 32, 4, 8, 2, 6, 16
    xdt = rng.standard_normal((b, s, h, p)).astype(np.float32)
    a = np.full((b, s, h), -12.0, np.float32)
    bb = rng.standard_normal((b, s, g, n)).astype(np.float32)
    cc = rng.standard_normal((b, s, g, n)).astype(np.float32)
    want, _ = jax_mamba2.ssd_chunked(*(jnp.asarray(t) for t in
                                       (xdt, a, bb, cc)), chunk)
    ts = [torch.from_numpy(t).requires_grad_(True)
          for t in (xdt, a, bb, cc)]
    y, state = mamba2.ssd_chunked(*ts, chunk)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    grads = torch.autograd.grad((y.sum() + state.sum()), ts)
    assert all(bool(torch.isfinite(gr).all()) for gr in grads)
    jgrad = jax.grad(lambda a_: jax_mamba2.ssd_chunked(
        jnp.asarray(xdt), a_, jnp.asarray(bb), jnp.asarray(cc),
        chunk)[0].sum())(jnp.asarray(a))
    assert not np.isfinite(np.asarray(jgrad)).all()
