"""K6, the zNUMA spill sweep: its plain version against the reference.

The wrapper (``kernels/spill_sweep/ops.py``) on CPU tensors runs the
plain version (``ref.py``), counts no launch, and is held with ``==`` to
the reference's ``spill_grid`` scan (``backend="jax"``, run on the CPU),
its numpy branch and the scalar oracle ``scalar_spill_replay`` — per
stream and lane, its final tier map to each lane's held blocks too — on
the edge and seeded cases the chip holds the kernel to
(``kernels/spill_sweep/cases.py``).  The reference's grid refuses more
than 96 config lanes (ROADMAP F9); the port takes any number, held
against the reference called in chunks of at most 96.  The launch plan,
the ptxas-log reader (``build.ptxas_entries``) and the wrapper's
refusals are CPU tests too; the kernel itself runs on the card
(``chip_smoke.py``, phase ``kernels_spill``).  The kernel's linked form
(its links and its tiled walk in plain torch) is held here too, and in
``tests/test_torch_spill_links.py``.
"""
import numpy as np
import pytest
import torch

from benchmarks.fig16_spill import synthetic_kv_events as jax_kv_events
from repro.core import latency_engine as jax_le
from repro.core.znuma import ZNumaAllocator as JaxZNumaAllocator
from repro_torch.core import latency_engine as le
from repro_torch.kernels import build
from repro_torch.kernels.spill_sweep import cases, ops
from repro_torch.kernels.spill_sweep import kernel as K

REF_LANES = 96          # the reference's widest grid (F9)
COUNTERS = ("allocs", "pool_allocs", "failed", "local_in_use",
            "pool_in_use")


def _reference(kinds, keys, nl, npl, backend):
    """The reference's spill_grid over (K, E) streams, in chunks of at
    most REF_LANES lanes: five (K, C) int64 arrays."""
    parts = []
    for i in range(0, len(nl), REF_LANES):
        g = jax_le.spill_grid(kinds, keys, nl[i:i + REF_LANES],
                              npl[i:i + REF_LANES], backend=backend)
        parts.append([getattr(g, f) for f in COUNTERS])
    return [np.concatenate([p[j] for p in parts], axis=-1)
            for j in range(5)]


def _plain(kinds, keys, nl, npl, n_keys=None):
    """The wrapper on CPU tensors (the plain version): five (K, C) int32
    arrays and the final tier map."""
    n_keys = n_keys or int(keys.max(initial=0)) + 1
    tier = torch.empty((kinds.shape[0], n_keys, len(nl)), dtype=torch.int8)
    out = ops.spill_sweep(*(torch.from_numpy(np.ascontiguousarray(a))
                            for a in (kinds, keys, nl, npl)), n_keys,
                          tier=tier)
    return [o.numpy() for o in out], tier.numpy()


def _held_tiers(kinds, keys, nl, npl, n_keys):
    """The oracle's tier map of one stream: for each lane, each key's tier
    after replaying the stream on ZNumaAllocator (-1 unbound)."""
    out = np.full((n_keys, len(nl)), -1, np.int8)
    for c, (a, b) in enumerate(zip(nl.tolist(), npl.tolist())):
        alloc, held = JaxZNumaAllocator(a, b), {}
        for kind, key in zip(kinds.tolist(), keys.tolist()):
            if kind == jax_le.ALLOC:
                try:
                    held[key] = alloc.alloc()
                except MemoryError:
                    pass
            elif kind == jax_le.FREE and key in held:
                alloc.free(held.pop(key))
        for key, blk in held.items():
            out[key, c] = int(alloc.is_pool(blk))
    return out


def _check_case(kinds, keys, nl, npl):
    before = ops.launches
    got, tier = _plain(kinds, keys, nl, npl)
    assert ops.launches == before                 # no launch on the CPU
    assert all(g.dtype == np.int32 and g.shape == (kinds.shape[0], len(nl))
               for g in got)
    for backend in ("jax", "numpy"):
        want = _reference(kinds, keys, nl, npl, backend)
        assert [g.tolist() for g in got] == [w.tolist() for w in want], \
            backend
    for s in range(kinds.shape[0]):
        for c in range(len(nl)):
            ref = jax_le.scalar_spill_replay(kinds[s], keys[s], nl[c],
                                             npl[c])
            assert [int(g[s, c]) for g in got] == \
                [int(getattr(ref, f)) for f in COUNTERS]
        assert tier[s].tolist() == _held_tiers(
            kinds[s], keys[s], nl, npl, tier.shape[1]).tolist()


@pytest.mark.parametrize("case", cases.seeded_cases(), ids=lambda c: c[0])
def test_plain_version_equals_reference_seeded(case):
    """Seeds 0-2 x c in {1, 2, 3, 5, 17}: 120 random events over 24
    keys."""
    _check_case(*case[1:])


@pytest.mark.parametrize("case", cases.edge_cases(), ids=lambda c: c[0])
def test_plain_version_equals_reference_edges(case):
    """PAD only, a FREE of an unbound key, failed allocations, num_local
    and num_pool 0, a key freed and allocated again, 1/33/130 lanes, K 1
    and 3 padded by PAD."""
    _check_case(*case[1:])


def test_failed_allocs_are_not_counted():
    kinds, keys = cases.to_arrays([("alloc", k) for k in range(4)])
    got, tier = _plain(kinds[None], keys[None], np.array([1], np.int32),
                       np.array([1], np.int32))
    assert [int(g[0, 0]) for g in got] == [2, 1, 2, 1, 1]
    assert tier[0, :, 0].tolist() == [0, 1, -1, -1]   # failures unbound


def test_wider_than_the_reference_grid():
    """More than 96 config lanes: the reference's grid refuses them
    (F9, reference-side); the port takes any number, held to the
    reference called in chunks of at most 96 lanes."""
    kinds, keys = cases.to_arrays(cases.random_events(
        np.random.default_rng(9), 40, 300))
    nl = np.arange(200, dtype=np.int32) % 23
    npl = (np.arange(200, dtype=np.int32) * 7) % 11
    with pytest.raises(ValueError):
        jax_le.spill_grid(kinds, keys, nl, npl, backend="numpy")
    _check_case(kinds[None], keys[None], nl, npl)
    grid = le.spill_grid(kinds, keys, nl, npl, device="cpu")
    assert grid.allocs.shape == (200,)


@pytest.mark.parametrize("seed,n_requests,peak", [(3, 40, 16), (5, 200, 64)])
def test_fig16_stream_is_the_references(seed, n_requests, peak):
    """Fig 16's paged-KV generator, copied: the same events and peak."""
    assert cases.synthetic_kv_events(seed, n_requests, peak) == \
        jax_kv_events(seed, n_requests, peak)


def test_spill_grid_guards_zero_allocs():
    g = le.spill_grid(np.zeros((2, 0), np.int32), np.zeros((2, 0), np.int32),
                      [4, 0], [4, 0], device="cpu")
    assert g.allocs.shape == (2, 2)
    assert g.spill_fraction.tolist() == [[0.0, 0.0], [0.0, 0.0]]


# ------------------------------------------------------------- the wrapper --
def _args(kinds=None, keys=None):
    kinds = np.array([[0, 0, 1, 2]], np.int32) if kinds is None else kinds
    keys = np.array([[0, 1, 0, 9]], np.int32) if keys is None else keys
    return [torch.from_numpy(kinds), torch.from_numpy(keys),
            torch.tensor([1, 2], dtype=torch.int32),
            torch.tensor([1, 0], dtype=torch.int32)]


def test_wrapper_refuses_keys_outside_the_map():
    # a PAD's key is never read (9 here)
    ops.spill_sweep(*_args(), 2)
    with pytest.raises(ValueError, match="key -1"):
        ops.spill_sweep(*_args(keys=np.array([[0, -1, 0, 0]], np.int32)), 2)
    with pytest.raises(ValueError, match="key 2, outside"):
        ops.spill_sweep(*_args(keys=np.array([[0, 2, 0, 0]], np.int32)), 2)


def test_wrapper_refuses_bad_shapes_and_types():
    a = _args()
    with pytest.raises(ValueError, match="one shape"):
        ops.spill_sweep(a[0], a[1][:, :3], a[2], a[3], 2)
    with pytest.raises(ValueError, match="one shape"):
        ops.spill_sweep(a[0], a[1], a[2], a[3][:1], 2)
    with pytest.raises(ValueError, match="one shape"):
        ops.spill_sweep(a[0][0], a[1][0], a[2], a[3], 2)
    with pytest.raises(TypeError, match="int32"):
        ops.spill_sweep(a[0].long(), a[1], a[2], a[3], 2)
    with pytest.raises(ValueError, match="tier"):
        ops.spill_sweep(*a, 2, tier=torch.empty((1, 3, 2), dtype=torch.int8))
    with pytest.raises(ValueError, match="at least"):
        ops.spill_sweep(a[0], a[1], a[2][:0], a[3][:0], 2)


def test_launch_plan_spreads_warps_over_the_sms():
    # Fig 16 at full width: 4 streams x 80 lanes = 12 warps, one a block
    assert K.plan(80, 4, 132) == K.Plan(1, 3, K.MAX_TILE)
    # 4 x 1,280 lanes = 160 warps on 132 SMs: two a block
    assert K.plan(1280, 4, 132) == K.Plan(2, 20, K.MAX_TILE)
    # never more warps a block than a stream's lanes fill, nor than 8; the
    # tile halves where 8 warps' buffers do not fit beside the stages
    assert K.plan(33, 1000, 132) == K.Plan(2, 1, K.MAX_TILE)
    assert K.plan(4096, 64, 132) == K.Plan(K.MAX_WARPS_PER_BLOCK, 16,
                                           K.MAX_TILE // 2)
    for c, k in ((1, 1), (97, 3), (1280, 4), (130, 7), (8000, 50)):
        p = K.plan(c, k, 132)
        assert 32 * p.warps_per_block * p.blocks_per_stream >= c
        assert 1 <= p.warps_per_block <= K.MAX_WARPS_PER_BLOCK
        assert K.shared_bytes(p.tile, p.warps_per_block) <= K.MAX_SHARED
        assert p.tile % 4 == 0 and p.tile <= K.MAX_TILE
    # five warps still take the largest tile (204,816 bytes), six do not
    assert K.shared_bytes(K.MAX_TILE, 5) == 204816 <= K.MAX_SHARED
    assert K.plan(6 * 32, 200, 132).tile == K.MAX_TILE // 2
    with pytest.raises(ValueError):
        K.plan(0, 1, 132)


def test_ptxas_log_reader_reads_the_kernel():
    name = ("_ZN12_GLOBAL__N_118spill_sweep_kernelEPKiS1_S1_S1_PaPiiii")
    log = (f"ptxas info    : 0 bytes gmem\nptxas info    : Compiling entry "
           f"function '{name}' for 'sm_90a'\nptxas info    : Function "
           f"properties for {name}\n    8 bytes stack frame, 4 bytes spill "
           "stores, 4 bytes spill loads\nptxas info    : Used 30 registers, "
           "used 1 barriers, 32768 bytes smem, 404 bytes cmem[0]\n")
    assert build.ptxas_entries(log) == [dict(
        function=name, stack_bytes=8, spill_store_bytes=4,
        spill_load_bytes=4, registers=30)]


def test_event_kinds_are_defined_once():
    # latency_engine takes the kinds from the plain version, and the .cu's
    # constants agree with them (PAD is whatever is neither)
    from repro_torch.kernels.spill_sweep import ref
    assert (le.ALLOC, le.FREE, le.PAD) == (ref.ALLOC, ref.FREE, ref.PAD)
    src = (build.CSRC_DIR / "spill_sweep.cu").read_text()
    assert "constexpr int kAlloc = 0, kFree = 1;" in src
    assert (ref.ALLOC, ref.FREE) == (0, 1)
    assert ref.PAD not in (ref.ALLOC, ref.FREE)
