"""Port's paged decode attention (plain version, the CPU path of the
wrapper) held against the reference's Pallas kernel in interpret mode and
its jnp oracle, on the same numpy-made inputs."""
import inspect
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention.kernel import paged_attention_kernel
from repro.kernels.paged_attention.ref import paged_attention_ref as jax_ref
from repro_torch.kernels.paged_attention import kernel as pa_kernel
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention.ref import (paged_attention_ref,
                                                     paged_attention_split_ref)

_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _sweep():
    """The whole reference sweep: every (g, hkv, d, page) of g {1,2,4},
    hkv {1,2}, d {16,32}, page {8,16} in both dtypes, b (1-3) and the
    pages per row (1-4) cycling so that each value is met; then the
    full-width group (g 6, D 128) and a table padded beyond what the
    rows need."""
    cases = []
    combos = itertools.product((1, 2, 4), (1, 2), (16, 32), (8, 16))
    for i, (g, hkv, d, page) in enumerate(combos):
        for j, dtype in enumerate(("float32", "bfloat16")):
            cases.append((1 + (i + j) % 3, g, hkv, d, page,
                          1 + (i // 3 + j) % 4, 0, dtype))
    for dtype in ("float32", "bfloat16"):
        cases.append((3, 6, 2, 128, 16, 5, 0, dtype))      # full-width group
        cases.append((2, 2, 2, 32, 8, 3, 4, dtype))        # padded table
        cases.append((2, 6, 2, 128, 16, 4, 3, dtype))
    return cases


def _inputs(b, g, hkv, d, page, ppseq, extra, seed):
    rng = np.random.default_rng(seed)
    npages = 16
    q = rng.standard_normal((b, hkv * g, d)).astype(np.float32)
    kp = rng.standard_normal((hkv, npages, page, d)).astype(np.float32)
    vp = rng.standard_normal((hkv, npages, page, d)).astype(np.float32)
    tbl = rng.integers(0, npages, (b, ppseq)).astype(np.int32)
    lens = rng.integers(1, ppseq * page + 1, (b,)).astype(np.int32)
    # padding beyond the row's pages is page 0: valid memory, never attended
    tbl = np.concatenate([tbl, np.zeros((b, extra), np.int32)], axis=1)
    return q, kp, vp, tbl, lens


@pytest.mark.parametrize("b,g,hkv,d,page,ppseq,extra,dtype", _sweep())
def test_paged_plain_matches_reference(b, g, hkv, d, page, ppseq, extra,
                                       dtype):
    seed = abs(hash((b, g, hkv, d, page, ppseq, extra))) % 2 ** 31
    q, kp, vp, tbl, lens = _inputs(b, g, hkv, d, page, ppseq, extra, seed)
    scale = d ** -0.5
    jd, td = _JNP[dtype], _TORCH[dtype]
    jargs = (jnp.asarray(q, jd), jnp.asarray(kp, jd), jnp.asarray(vp, jd),
             jnp.asarray(tbl), jnp.asarray(lens))
    want_kernel = np.asarray(paged_attention_kernel(
        *jargs, scale=scale, interpret=True), np.float32)
    want_ref = np.asarray(jax_ref(*jargs, scale=scale), np.float32)
    targs = (torch.from_numpy(q).to(td), torch.from_numpy(kp).to(td),
             torch.from_numpy(vp).to(td), torch.from_numpy(tbl),
             torch.from_numpy(lens))
    got = paged_attention_ref(*targs, scale=scale)
    assert got.dtype == td and got.shape == (b, hkv * g, d)
    got = got.to(torch.float32).numpy()
    # fp32: two CPU einsums in different summation orders; bf16: one
    # rounding of the output to 8 bits of mantissa
    tol = 2e-6 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got, want_kernel, rtol=tol, atol=tol)
    np.testing.assert_allclose(got, want_ref, rtol=tol, atol=tol)


def test_wrapper_takes_plain_path_on_cpu_and_counts_no_launch():
    q, kp, vp, tbl, lens = _inputs(2, 2, 2, 16, 8, 3, 1, seed=7)
    targs = tuple(torch.from_numpy(a) for a in (q, kp, vp, tbl, lens))
    pa_ops.launches = 0
    out = pa_ops.paged_attention(*targs)          # default scale d ** -0.5
    ref = paged_attention_ref(*targs, scale=16 ** -0.5)
    assert torch.equal(out, ref)
    assert pa_ops.launches == 0


@pytest.mark.parametrize("breakage", ["noncontiguous", "dtype", "table_dtype",
                                      "heads", "batch"])
def test_wrapper_refuses_bad_inputs(breakage):
    q, kp, vp, tbl, lens = (torch.from_numpy(a) for a in
                            _inputs(2, 2, 2, 16, 8, 3, 0, seed=3))
    if breakage == "noncontiguous":
        kp = kp.transpose(1, 2).contiguous().transpose(1, 2)
        vp = vp.transpose(1, 2).contiguous().transpose(1, 2)
        exc = ValueError
    elif breakage == "dtype":
        q, exc = q.to(torch.bfloat16), TypeError
    elif breakage == "table_dtype":
        tbl, exc = tbl.long(), TypeError
    elif breakage == "heads":
        q, exc = q[:, :3].contiguous(), ValueError
    else:
        lens, exc = lens[:1], ValueError
    with pytest.raises(exc):
        pa_ops.paged_attention(q, kp, vp, tbl, lens)


# (b, g, hkv, d, page, width in pages, lens, sm_count): the kernel's split
# edges on the card's 132 SMs, and SM counts that give one split or many
_SPLIT_CASES = {
    "lens_1": (2, 6, 2, 128, 16, 16, [1, 1], 132),
    "empty_split": (3, 2, 2, 32, 16, 16, [200, 40, 129], 132),
    "ends_on_boundary": (3, 4, 1, 64, 8, 24, [64, 128, 192], 132),
    "padded_table": (2, 2, 2, 32, 8, 40, [50, 9], 132),
    "one_split": (2, 3, 2, 16, 4, 20, [80, 33], 1),
    "many_splits": (2, 1, 1, 16, 8, 32, [256, 70], 1000),
}


@pytest.mark.parametrize("case", sorted(_SPLIT_CASES))
def test_split_and_merge_matches_plain_and_reference(case):
    """The kernel's split-KV algorithm in plain PyTorch, cut where the
    kernel cuts, equals the one-pass plain version and the reference's
    Pallas kernel within 2e-6 in fp32."""
    b, g, hkv, d, page, width, lens, sm = _SPLIT_CASES[case]
    splits = pa_kernel.num_splits(b, hkv, width, page, sm)
    per = pa_kernel.split_tokens(width, page, splits)
    if case == "one_split":
        assert splits == 1
    elif case == "ends_on_boundary":
        assert splits > 1 and all(n % per == 0 for n in lens)
    else:
        assert splits > 1
    if case in ("lens_1", "empty_split"):       # some split starts past a row
        assert min(lens) <= per * (splits - 1)
    rng = np.random.default_rng(sum(map(ord, case)))
    npages = 64
    q = rng.standard_normal((b, hkv * g, d)).astype(np.float32)
    kp = rng.standard_normal((hkv, npages, page, d)).astype(np.float32)
    vp = rng.standard_normal((hkv, npages, page, d)).astype(np.float32)
    tbl = np.zeros((b, width), np.int32)        # padded with page 0
    for i, n in enumerate(lens):
        tbl[i, :-(-n // page)] = rng.permutation(npages)[:-(-n // page)]
    lens = np.asarray(lens, np.int32)
    scale = d ** -0.5
    targs = tuple(torch.from_numpy(a) for a in (q, kp, vp, tbl, lens))
    got = paged_attention_split_ref(*targs, scale=scale, sm_count=sm)
    assert got.dtype == torch.float32 and got.shape == (b, hkv * g, d)
    plain = paged_attention_ref(*targs, scale=scale)
    want = np.asarray(paged_attention_kernel(
        *(jnp.asarray(a) for a in (q, kp, vp, tbl, lens)), scale=scale,
        interpret=True))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=2e-6,
                               atol=2e-6)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("shape", [(8, 2, 128, 16), (2, 2, 16, 16),
                                   (3, 2, 9, 8), (1, 1, 1, 4), (8, 2, 129, 16),
                                   (132, 2, 8, 8), (1, 6, 512, 16)])
def test_num_splits_cuts_whole_tiles_from_the_width(shape):
    batch, hkv, width, page = shape
    splits = pa_kernel.num_splits(batch, hkv, width, page, 132)
    per = pa_kernel.split_tokens(width, page, splits)
    n = width * page
    assert splits >= 1 and per % pa_kernel.TILE_TOKENS == 0
    assert (splits - 1) * per < n <= splits * per   # no split past the width
    if batch * hkv >= 2 * 132:
        assert splits == 1
    else:      # aims at two blocks an SM: reaches one at least, if tiles allow
        tiles = -(-n // pa_kernel.TILE_TOKENS)
        assert 2 * batch * hkv * splits >= min(2 * 132, batch * hkv * tiles)
    if shape == (8, 2, 128, 16):       # the serving path's timed shape
        assert (splits, per) == (16, 128)


def test_num_splits_never_sees_the_lengths():
    """The split count comes from shapes alone: the lengths live on the
    device, and reading them would cost a host sync per layer."""
    params = inspect.signature(pa_kernel.num_splits).parameters
    assert list(params) == ["batch", "hkv", "pages_per_seq", "page_size",
                            "sm_count"]
    assert list(inspect.signature(pa_kernel.split_tokens).parameters) == [
        "pages_per_seq", "page_size", "splits"]
