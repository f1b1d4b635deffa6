"""Port's serving stack on the CPU: the reference's serving tests mirrored,
and the engine held to the reference engine with ``==`` on the same
weights and request streams."""
import dataclasses

import numpy as np
import pytest

from repro.serving import engine as jengine
from repro.serving.scheduler import Request as JRequest
from repro_torch.core.slices import SlicePool
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.launch import serve as tserve
from repro_torch.serving.engine import DecodeEngine, paged_kv_config
from repro_torch.serving.kv_cache import KVConfig, TieredPagedKV
from repro_torch.serving.scheduler import ContinuousBatcher, Request

from _torch_port_util import port_model, reference_model


@pytest.fixture(scope="module")
def models():
    cfg, jmodel, params = reference_model()
    return cfg, jmodel, params, port_model(params)


def _kvc(cfg, **kw):
    return paged_kv_config(cfg, **kw)


# The reference's three traffic set-ups (tests/test_serving.py): continuous
# batching, spill + QoS migration, and a single sequence.
def _traffic(name, vocab):
    if name == "batching":
        rng = np.random.default_rng(1)
        reqs = []
        for r in range(6):
            plen = int(rng.integers(5, 20))
            reqs.append((r, plen, 5, rng.integers(0, vocab, plen)))
        return dict(page_size=8, num_local=16, num_pool=48), \
            dict(max_batch=3, pdm=0.9), reqs, 300
    if name == "spill":
        rng = np.random.default_rng(2)
        reqs = [(0, 16, 2, rng.integers(0, vocab, 16)),
                (1, 16, 16, rng.integers(0, vocab, 16))]
        return dict(page_size=4, num_local=4, num_pool=64), \
            dict(max_batch=2, pdm=0.05), reqs, 100
    rng = np.random.default_rng(0)
    reqs = [(0, 12, 4, rng.integers(0, vocab, 12))]
    return dict(page_size=8, num_local=32, num_pool=8), \
        dict(max_batch=1), reqs, 4


def _run_port(models, name):
    cfg, _, _, tmodel = models
    kv_kw, eng_kw, reqs, steps = _traffic(name, cfg.vocab_size)
    eng = DecodeEngine(tmodel, _kvc(cfg, **kv_kw), **eng_kw)
    for rid, plen, new, toks in reqs:
        eng.submit(Request(req_id=rid, prompt_len=plen, max_new_tokens=new),
                   toks)
    return eng, eng.run(steps)


def test_engine_completes_with_continuous_batching(models):
    eng, stats = _run_port(models, "batching")
    assert len(eng.batcher.completed) == 6
    assert stats.tokens == 6 * 5
    # all pages returned
    assert eng.kv.alloc.local_in_use == 0 and eng.kv.alloc.pool_in_use == 0
    assert bool(eng.logits_finite)
    assert len(eng.timings.decode_seconds) == stats.steps
    assert len(eng.timings.prefill_seconds) == 6


def test_znuma_spill_and_migration(models):
    """Local tier too small -> spill to pool -> QoS migrates once local
    frees up; pool traffic fraction drops."""
    eng, stats = _run_port(models, "spill")
    assert max(stats.pool_traffic_fracs) > 0.0     # spilled
    assert eng.kv.alloc.spill_fraction > 0.0
    assert stats.migrations >= 1                   # QoS engaged
    assert stats.migration_seconds > 0.0


def test_slice_pool_backing_and_release(models):
    cfg, _, _, tmodel = models
    sp = SlicePool(num_slices=128, slice_gb=0.0005)
    eng = DecodeEngine(tmodel, _kvc(cfg, page_size=8, num_local=8,
                                    num_pool=32), max_batch=1, slice_pool=sp)
    owned0 = sp.owned_gb(0)
    assert owned0 > 0                              # pool tier owns slices
    eng.kv.release_slices(now=0.0)
    assert sp.draining_gb() == pytest.approx(owned0)
    sp.tick(1e9)
    assert sp.free_gb() == pytest.approx(128 * 0.0005)


def test_scheduler_fcfs_and_stragglers():
    b = ContinuousBatcher(max_batch=2)
    for r in range(4):
        b.submit(Request(req_id=r, prompt_len=4, max_new_tokens=2))
    admitted = b.admit(lambda req: True)
    assert [r.req_id for r in admitted] == [0, 1]
    b.step_done([0])
    admitted = b.admit(lambda req: req.req_id != 3)
    assert [r.req_id for r in admitted] == [2]
    for _ in range(5):
        b.record_replica_time("fast1", 0.1)
        b.record_replica_time("fast2", 0.11)
        b.record_replica_time("slow", 0.5)
    assert b.healthy_replicas(["fast1", "fast2", "slow"]) == \
        ["fast1", "fast2"]


def test_kv_admission_control():
    kv = TieredPagedKV(KVConfig(num_layers=2, num_kv_heads=2, head_dim=8,
                                page_size=4, num_local_pages=4,
                                num_pool_pages=2), device="cpu")
    assert kv.can_admit(prompt_len=16, max_new=8)
    assert not kv.can_admit(prompt_len=25, max_new=8)
    kv.admit(0, 16)
    assert not kv.can_admit(prompt_len=8, max_new=2)
    kv.release(0)
    assert kv.can_admit(prompt_len=8, max_new=2)


def test_kv_page_bytes_tables_and_migration_copy():
    kvc = KVConfig(num_layers=2, num_kv_heads=2, head_dim=8, page_size=4,
                   num_local_pages=2, num_pool_pages=4, dtype="bfloat16")
    assert kvc.page_bytes() == 2 * 2 * 2 * 4 * 8 * 2
    kv = TieredPagedKV(dataclasses.replace(kvc, dtype="float32"),
                       device="cpu")
    kv.admit(0, 8)                                 # pages 0, 1 (local)
    kv.admit(1, 12)                                # pages 2, 3, 4 (pool)
    tbl, lens = kv.batch_tables([0, 1], pad_to=5)
    assert tbl.dtype == lens.dtype and str(tbl.dtype) == "torch.int32"
    assert tbl.tolist() == [[0, 1, 0, 0, 0], [2, 3, 4, 0, 0]]
    assert lens.tolist() == [8, 12]
    kv.k.copy_(kv.k.new_tensor(np.arange(kv.k.numel(),
                                         dtype=np.float32)).view_as(kv.k))
    before = kv.k.clone()
    allocs = kv.alloc.allocs
    kv.release(0)
    assert kv.migrate_seq_to_local(1) == 2         # two local pages free
    assert kv.alloc.allocs == allocs               # spill fraction untouched
    new = kv.tables[1]
    assert sorted(new[:2]) == [0, 1] and new[2] == 4
    for old, now in zip((2, 3), new[:2]):
        assert (kv.k[:, :, now] == before[:, :, old]).all()


@pytest.mark.parametrize("traffic", ["batching", "spill", "single"])
def test_engine_parity_with_reference_engine(models, traffic):
    """Same weights, same requests, both engines stepped side by side:
    page tables after every step, token streams and Pond statistics are
    equal, compared with ``==``."""
    cfg, jmodel, params, tmodel = models
    kv_kw, eng_kw, reqs, steps = _traffic(traffic, cfg.vocab_size)
    jeng = jengine.DecodeEngine(jmodel, params,
                                jengine.paged_kv_config(cfg, **kv_kw),
                                **eng_kw)
    teng = DecodeEngine(tmodel, _kvc(cfg, **kv_kw), **eng_kw)
    for rid, plen, new, toks in reqs:
        jeng.submit(JRequest(req_id=rid, prompt_len=plen,
                             max_new_tokens=new), toks)
        teng.submit(Request(req_id=rid, prompt_len=plen, max_new_tokens=new),
                    toks)
    pa_ops.launches = 0
    for _ in range(steps):
        if not jeng.batcher.queue and not jeng.batcher.active:
            break
        assert teng.step() == jeng.step()
        assert teng.kv.tables == jeng.kv.tables
        assert teng.kv.lens == jeng.kv.lens
    assert not teng.batcher.queue and not teng.batcher.active
    tstats, jstats = teng.stats, jeng.stats
    assert teng.outputs == jeng.outputs
    for f in ("steps", "tokens", "migrations", "pool_traffic_fracs",
              "virtual_seconds", "migration_seconds"):
        assert getattr(tstats, f) == getattr(jstats, f), f
    assert teng.kv.alloc.spill_fraction == jeng.kv.alloc.spill_fraction
    assert teng.kv.alloc.allocs == jeng.kv.alloc.allocs
    assert teng.kv.alloc.free_local == jeng.kv.alloc.free_local
    assert teng.kv.alloc.free_pool == jeng.kv.alloc.free_pool
    assert [r.req_id for r in teng.batcher.completed] == \
        [r.req_id for r in jeng.batcher.completed]
    assert pa_ops.launches == 0                    # CPU: the plain version


def test_serve_main_on_cpu_prints_the_reference_report(capsys):
    from repro.launch import serve as jserve
    argv = ["--requests", "5", "--max-batch", "2", "--local-pages", "6",
            "--pool-pages", "40", "--page-size", "4", "--pdm", "0.2"]
    jstats = jserve.main(argv)
    jout = capsys.readouterr().out
    tstats = tserve.main(argv + ["--device", "cpu"])
    tout = capsys.readouterr().out
    # weights differ (each framework draws its own), the control flow and
    # the Pond accounting do not depend on them
    assert tstats.steps == jstats.steps and tstats.tokens == jstats.tokens
    assert tstats.pool_traffic_fracs == jstats.pool_traffic_fracs
    assert tstats.migrations == jstats.migrations
    assert tout == jout
    assert tout.count("[serve]") == 4
