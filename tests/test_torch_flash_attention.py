"""Port's flash attention (its oracle ``ref.attention_ref`` and the CPU
path of the wrapper ``ops.flash_attention``) held against the reference's
Pallas kernel in interpret mode, its jnp oracle and its wrapper, on the
same numpy-made inputs (mirrors ``tests/test_kernels.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jfa_ops
from repro.kernels.flash_attention.kernel import flash_attention_kernel
from repro.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_ref as port_ref
from repro_torch.kernels.flash_attention.ref import bf16_bound

_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# fp32: sums taken in other orders; bf16: one rounding of the output
_TOL = {"float32": 2e-6, "bfloat16": 2e-2}
# the reference's oracle, compiled once per shape (op by op it compiles
# each small op anew for every shape of the sweep)
jax_ref = jax.jit(attention_ref, static_argnames=("causal", "window"))


def _sweep():
    """24 cases of the reference's sweep (b 1-2, nblk 2-4, g {1,2,4},
    hkv {1,2}, d {16,32,64}, window {None,7,33}, fp32/bf16): each index
    cycles through its values at its own rate, so every value is met and
    the values meet in many combinations."""
    cases = []
    for i in range(24):
        cases.append((1 + i % 2, 2 + i % 3, (1, 2, 4)[(i // 3) % 3],
                      1 + (i // 2) % 2, (16, 32, 64)[(i // 4) % 3],
                      (None, 7, 33)[(i // 6) % 3],
                      ("float32", "bfloat16")[(i // 5) % 2]))
    return cases


def _inputs(rng, shapes, dtype):
    """The same values for both frameworks: numpy fp32, cast by each."""
    arrs = [rng.normal(size=s).astype(np.float32) * 0.5 for s in shapes]
    return ([jnp.asarray(a).astype(_JNP[dtype]) for a in arrs],
            [torch.from_numpy(a).to(_TORCH[dtype]) for a in arrs])


def _run_pallas(q, k, v, window, block):
    """The reference's Pallas kernel in interpret mode, as its own test
    runs it: head-major, head_dim padded to 128 lanes."""
    d = q.shape[-1]
    dp = (-d) % 128

    def prep(t):
        return jnp.moveaxis(jnp.pad(t, ((0, 0), (0, 0), (0, 0), (0, dp))),
                            2, 1)
    out = flash_attention_kernel(prep(q), prep(k), prep(v), scale=d ** -0.5,
                                 causal=True, window=window, block_q=block,
                                 block_k=block, interpret=True)
    return jnp.moveaxis(out, 1, 2)[..., :d]


def _np(t):
    return np.asarray(t.to(torch.float32) if isinstance(t, torch.Tensor)
                      else t.astype(jnp.float32))


@pytest.mark.parametrize("b,nblk,g,hkv,d,window,dtype", _sweep())
def test_flash_matches_reference_kernel_and_oracle(b, nblk, g, hkv, d,
                                                   window, dtype):
    rng = np.random.default_rng(b * 1000 + nblk * 100 + g * 10 + hkv + d)
    s = nblk * 16
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        rng, [(b, s, hkv * g, d), (b, s, hkv, d), (b, s, hkv, d)], dtype)
    want_kernel = _np(_run_pallas(jq, jk, jv, window, 16))
    want_ref = _np(jax_ref(jq, jk, jv, causal=True, window=window))
    fa_ops.launches = 0
    got_ops = fa_ops.flash_attention(tq, tk, tv, causal=True, window=window)
    got_ref = port_ref(tq, tk, tv, causal=True, window=window)
    assert fa_ops.launches == 0                  # CPU: the plain version
    tol = _TOL[dtype]
    for got in (got_ops, got_ref):
        assert got.dtype == _TORCH[dtype] and got.shape == tq.shape
        for want in (want_kernel, want_ref):
            np.testing.assert_allclose(_np(got), want, rtol=tol, atol=tol)


def test_odd_shapes_match_the_reference_wrapper():
    """seq 37, head_dim 24: the reference wrapper off the TPU (blocked) and
    with interpret=True (padded to 16-row blocks and 128 lanes)."""
    rng = np.random.default_rng(0)
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        rng, [(2, 37, 4, 24), (2, 37, 2, 24), (2, 37, 2, 24)], "float32")
    got = fa_ops.flash_attention(tq, tk, tv, causal=True).numpy()
    want_cpu = np.asarray(jfa_ops.flash_attention(jq, jk, jv, causal=True))
    want_i = np.asarray(jfa_ops.flash_attention(
        jq, jk, jv, causal=True, interpret=True, block_q=16, block_k=16))
    np.testing.assert_allclose(got, want_cpu, rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(got, want_i, rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(port_ref(tq, tk, tv).numpy(), want_cpu,
                               rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_non_causal_masks_padded_keys_like_the_reference_cpu_path(dtype):
    """causal=False with Skv 45, which the reference pads to 48 keys: its
    CPU path masks the padding (the TPU kernel would not; ROADMAP F6), and
    so does the port, by the true length."""
    rng = np.random.default_rng(1)
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        rng, [(2, 37, 4, 32), (2, 45, 2, 32), (2, 45, 2, 32)], dtype)
    want = _np(jfa_ops.flash_attention(jq, jk, jv, causal=False,
                                       block_k=16))
    want_ref = _np(jax_ref(jq, jk, jv, causal=False))
    tol = _TOL[dtype]
    for got in (fa_ops.flash_attention(tq, tk, tv, causal=False),
                port_ref(tq, tk, tv, causal=False)):
        np.testing.assert_allclose(_np(got), want, rtol=tol, atol=tol)
        np.testing.assert_allclose(_np(got), want_ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("breakage", ["rank", "heads", "v_shape", "dtype",
                                      "window", "empty_band", "mixed",
                                      "meta"])
def test_wrapper_refuses_bad_inputs(breakage):
    q = torch.zeros((2, 8, 4, 16))
    k = torch.zeros((2, 8, 2, 16))
    v = torch.zeros((2, 8, 2, 16))
    kw = {}
    exc = ValueError
    if breakage == "rank":
        q = q[0]
    elif breakage == "heads":
        q = torch.zeros((2, 8, 3, 16))
    elif breakage == "v_shape":
        v = torch.zeros((2, 9, 2, 16))
    elif breakage == "dtype":
        q, exc = q.to(torch.bfloat16), TypeError
    elif breakage == "window":
        kw = dict(window=0)
    elif breakage == "empty_band":               # query 7 sees no key < 2
        k, v = k[:, :2], v[:, :2]
        kw = dict(window=3)
    elif breakage == "mixed":
        k = k.to("meta")
    else:                                        # neither CPU nor CUDA
        q, k, v = q.to("meta"), k.to("meta"), v.to("meta")
    with pytest.raises(exc):
        fa_ops.flash_attention(q, k, v, **kw)


def _emulate_bf16_kernel(q, k, v, window):
    """The bf16 kernel's rounding in plain fp32: p rounded to bf16 before
    p @ V (the sum l of the unrounded p), the output rounded to bf16."""
    g = q.shape[2] // k.shape[2]
    kr = k.float().repeat_interleave(g, dim=2)
    vr = v.float().repeat_interleave(g, dim=2)
    s_len = q.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr) \
        * q.shape[-1] ** -0.5
    i = torch.arange(s_len)[:, None]
    j = torch.arange(s_len)[None]
    logits = torch.where((j <= i) & (j > i - window), logits, -2.0 ** 30)
    p = torch.exp(logits - logits.max(dim=-1, keepdim=True).values)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(torch.bfloat16).float(), vr)
    return (out / p.sum(-1).transpose(1, 2)[..., None]).to(torch.bfloat16)


def test_bf16_bound_holds_the_kernels_rounding_and_no_more():
    """danube-like shape (D 80, g 4, window shorter than the sequence),
    bf16 inputs: an emulation of the kernel's rounding lies within the
    bound against the fp32 plain version; the same output with one row
    moved by 4x its bound does not."""
    rng = np.random.default_rng(13)
    b, s_len, hkv, g, d, window = 2, 96, 2, 4, 80, 40
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               .to(torch.bfloat16)
               for shape in ((b, s_len, hkv * g, d), (b, s_len, hkv, d),
                             (b, s_len, hkv, d)))
    plain = port_ref(q.float(), k.float(), v.float(), window=window)
    plain_abs_v = port_ref(q.float(), k.float(), v.float().abs(),
                           window=window)
    bound = bf16_bound(plain, plain_abs_v)
    emulated = _emulate_bf16_kernel(q, k, v, window).float()
    err = (emulated - plain).abs()
    assert bool((err <= bound).all())
    assert float((err / bound).max()) > 0.1      # the bound is not slack
    moved = emulated.clone()
    moved[1, 70, 5] = plain[1, 70, 5] + 4 * bound[1, 70, 5]
    assert not bool(((moved - plain).abs() <= bound).all())
    assert bool(((moved - plain).abs() <= bound)[0].all())
