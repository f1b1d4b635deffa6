"""The port's op counter (``launch/op_analysis.py``) against the
reference's HLO analysis (``launch/hlo_analysis.py``) and against itself:

* the counted matrix-product FLOPs of smoke cells within 5 % of the
  reference's ``analyze(...).flops`` of the compiled cell on a (1, 1) CPU
  mesh (``tests/test_hlo_analysis.py``'s own tolerance): qwen2's train,
  prefill and decode, granite's train, whisper's prefill, and mamba2's and
  deepseek's train;
* each collective's wire bytes ``==`` the reference's on the matching HLO
  line (the same group size and bytes), on a (2, 4) mesh;
* the repeat multiplier (one microbatch counted, multiplied) ``==`` the
  full count; a meta mesh's coordinates counted once (``shard_map``'s
  replicated run) ``==`` the full run in FLOPs and collective bytes;
* a step on CPU tensors ``==`` the same step on meta tensors (FLOPs,
  bytes and ops less the host moves the meta run makes), the CPU stand-in
  for the card check in ``chip_smoke.py``;
* the peak of live bytes on a hand-counted sequence; the kernels' launch
  counts;
* ``core/telemetry.py``'s counters ``==`` the reference's with its
  constants passed; the grad-compression example's fp32 and int8 wire
  bytes ``==`` the reference example's.

The reference runs in subprocesses (``tests/_torch_dryrun_reference.py``),
which force 512 host devices on JAX without touching this process."""
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import telemetry as jax_telemetry
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import get_smoke
from repro_torch.core import telemetry
from repro_torch.launch import dryrun, op_analysis
from repro_torch.launch import mesh as meshlib
from repro_torch.models import moe
from repro_torch.models.model_zoo import build_model
from repro_torch.optim import adamw
from repro_torch.runtime import train as rt
from repro_torch.sharding import rules
from repro_torch.sharding.rules import P, ShardCtx, shard_map

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
META = torch.device("meta")
CPU = torch.device("cpu")
#: tests/test_hlo_analysis.py's tolerance on FLOPs
FLOP_RTOL = 0.05
CELLS = [["qwen2-1.5b", "train", 64, 4], ["qwen2-1.5b", "prefill", 64, 2],
         ["qwen2-1.5b", "decode", 64, 2],
         ["granite-moe-1b-a400m", "train", 64, 4],
         ["whisper-small", "prefill", 64, 2], ["mamba2-1.3b", "train", 64, 4],
         ["deepseek-v3-671b", "train", 64, 4]]


def _reference(*args):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "tests",
                                      "_torch_dryrun_reference.py"), *args],
        env=env, capture_output=True, text=True, check=True, cwd=REPO)
    return json.loads(out.stdout.strip().splitlines()[-1])


@functools.cache
def _reference_hlo():
    return _reference("hlo", json.dumps(CELLS))


def _mesh(shape=(1, 1), axes=("data", "model"), device=META):
    import math
    return meshlib.make_mesh(shape, axes, devices=[device] *
                             math.prod(shape))


# ------------------------------------------------------- FLOPs vs the HLO --
@pytest.mark.parametrize("cell", CELLS, ids=lambda c: "-".join(map(str, c)))
def test_counted_flops_within_5pct_of_the_reference_hlo(cell):
    arch, kind, seq, batch = cell
    shape = ShapeConfig("smoke", seq, batch, kind)
    fn, args, _ = dryrun.build_cell(get_smoke(arch), shape, _mesh(), False,
                                    dryrun.PLANS[arch])
    counts, _ = dryrun.count_step(fn, args)
    want = _reference_hlo()[f"{arch}|{kind}|{seq}|{batch}"]
    assert counts.flops == pytest.approx(want, rel=FLOP_RTOL)


# ------------------------------------------------------------ collectives --
def _port_collectives():
    """The reference's four cases (``_torch_dryrun_reference.py``) through
    the port's ``shard_map`` on a (2, 4) CPU mesh, each under a counter."""
    mesh = _mesh((2, 4), ("pod", "data"), CPU)
    g = torch.Generator().manual_seed(0)
    cases = {
        "psum": (lambda x: rules.psum(x, "pod"),
                 torch.randn(8, 96, generator=g), P("data", None),
                 P("data", None)),
        "all_gather": (lambda x: rules.all_gather(x, "data", axis=0),
                       torch.randint(-9, 9, (64, 24), generator=g,
                                     dtype=torch.int8),
                       P("data", None), P(None, None)),
        "psum_scatter": (lambda x: rules.psum_scatter(
            x, "data", scatter_dimension=0), torch.randn(32, 40, generator=g),
            P(None, None), P("data", None)),
        "all_to_all": (lambda x: rules.all_to_all(x, "data", 0, 0),
                       torch.randn(4, 6, 16, generator=g),
                       P(None, None, None), P(None, None, None)),
    }
    out = {}
    for name, (f, x, ins, outs) in cases.items():
        with op_analysis.OpCounter() as c:
            shard_map(f, mesh=mesh, in_specs=(ins,), out_specs=outs)(x)
        out[name] = c.counts
    return out


def test_collective_wire_bytes_equal_the_reference_hlo():
    """Per device: the port's counts are every coordinate's (8), the
    reference's HLO one device's."""
    want = _reference("collectives")
    got = _port_collectives()
    for name, counts in got.items():
        assert counts.collective_bytes / 8 == want[name]["collective_bytes"]
        (kind, t_out, group, mult, wire), = want[name]["details"]
        assert {(d[0], d[1], d[2], d[4]) for d in
                counts.collective_details} == {(kind, t_out, group, wire)}
        assert len(counts.collective_details) == 8
        assert dict(counts.by_collective) == {kind: 8 * wire}


# ------------------------------------------------------ repeat multiplier --
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "granite-moe-1b-a400m",
                                  "deepseek-v3-671b", "whisper-small"])
def test_microbatch_multiplier_equals_the_full_count(arch):
    shape = ShapeConfig("s", 32, 8, "train")
    got = []
    for repeat in (False, True):
        fn, args, extra = dryrun.build_cell(get_smoke(arch), shape, _mesh(),
                                            False, dryrun.PLANS[arch])
        c, _ = dryrun.count_step(fn, args, repeat=repeat)
        got.append((c.flops, c.bytes, c.ops, c.collective_bytes))
    assert extra["microbatches"] > 1
    assert got[0] == got[1]


@pytest.mark.parametrize("impl", ["sharded", "sharded2d"])
@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (2, 4)])
def test_replicated_coordinates_equal_the_full_run(impl, shape):
    """On a meta mesh under ``repeat``, coordinate 0 stands for all: the
    FLOPs and collective bytes of a MoE layer's forward and backward are
    the run of every coordinate's; the bytes differ only by the copies and
    sums across the coordinates' boundary (within 12 % at these tiny
    widths, where those are a large share)."""
    cfg = get_smoke("granite-moe-1b-a400m")
    got = []
    for repeat in (False, True):
        ctx = ShardCtx(mesh=_mesh(shape), pod_axis=None, moe_impl=impl)
        layer = moe.MoE(cfg, device=META, dtype=None)
        for p in layer.parameters():
            p.requires_grad_(True)
        x = torch.empty(8, 16, cfg.d_model, dtype=torch.bfloat16,
                        device=META, requires_grad=True)
        with op_analysis.OpCounter(repeat=repeat) as c:
            y, aux = layer(x, ctx)
            (y.float().sum() + aux).backward()
        got.append(c.counts)
    full, once = got
    assert once.flops == full.flops
    assert once.collective_bytes == full.collective_bytes
    assert dict(once.by_collective) == dict(full.by_collective)
    assert once.bytes == pytest.approx(full.bytes, rel=0.12)


# ------------------------------------------------------- CPU against meta --
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "granite-moe-1b-a400m",
                                  "deepseek-v3-671b", "whisper-small",
                                  "internvl2-26b", "mamba2-1.3b"])
def test_a_cpu_step_counts_as_its_meta_twin(arch):
    """A fused step (2 microbatches, remat) on CPU tensors with values and
    on meta tensors: the same FLOPs, bytes and ops once the meta run's
    moves from the host (the rope table, made on the host) are taken out;
    the peaks within 64 bytes (a storage's rounding)."""
    cfg = get_smoke(arch)
    got = []
    for dev in (META, CPU):
        model = build_model(cfg, device=dev)
        if dev == CPU:
            model.init_params(torch.Generator().manual_seed(0))
        params = rt.train_params(model)
        ocfg = adamw.AdamWConfig()
        opt = adamw.init_state(params, ocfg)
        batch = dryrun.train_batch(cfg, 4, 32, device=dev)
        if dev == CPU:
            rng = np.random.default_rng(1)
            batch["tokens"] = torch.from_numpy(rng.integers(
                0, cfg.vocab_size, tuple(batch["tokens"].shape),
                dtype=np.int32))
            if "embeds" in batch:
                batch["embeds"] = torch.from_numpy(rng.standard_normal(
                    tuple(batch["embeds"].shape), dtype=np.float32)
                ).to(torch.bfloat16)
        step = rt.make_train_step(model, ocfg, ShardCtx(remat=True),
                                  microbatches=2, xent_chunk=16)
        c, _ = dryrun.count_step(step, (params, opt, batch),
                                 repeat=dev == META)
        got.append(c)
    meta, cpu = got
    assert cpu.h2d_ops == 0
    assert meta.flops == cpu.flops
    assert meta.bytes - meta.h2d_bytes == cpu.bytes
    assert meta.ops - meta.h2d_ops == cpu.ops
    assert abs(meta.peak_bytes - cpu.peak_bytes) <= 64


# -------------------------------------------------------------- the peak --
def test_peak_live_bytes_of_a_hand_counted_sequence():
    x = torch.zeros(1000)                       # an argument: not counted
    with op_analysis.OpCounter() as c:
        a = x * 2                               # 4,000 live
        b = a + 1                               # 8,000
        del a                                   # 4,000
        d = b.view(10, 100) * 3                 # 8,000; the view is free
        b.add_(1)                               # in place: nothing new
        del b, d
        e = torch.cat([x, x])                   # 8,000
        del e
    assert c.counts.peak_bytes == 8000
    assert c.counts.ops == 5
    assert c.counts.flops == 0
    # mm: 2 M N K, its bytes operands + output
    a, b = torch.ones(3, 5), torch.ones(5, 7)
    with op_analysis.OpCounter() as c:
        torch.mm(a, b)
    assert c.counts.flops == 2 * 3 * 5 * 7
    assert c.counts.dot_bytes == c.counts.bytes == 4 * (15 + 35 + 21)


def test_kernel_launches_are_reported_not_counted(monkeypatch):
    from repro_torch.kernels.flash_attention import ops as k3
    with op_analysis.OpCounter() as c:
        monkeypatch.setattr(k3, "launches", k3.launches + 3)
    assert c.counts.kernel_launches["flash_attention"] == 3
    assert set(c.counts.kernel_launches) == set(op_analysis.KERNEL_WRAPPERS)
    assert c.counts.flops == c.counts.bytes == 0


# -------------------------------------------------------------- telemetry --
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_step_counters_and_log_equal_the_reference(seed):
    """With the reference's TPU constants passed explicitly the vectors are
    ``==``; the port's defaults are the H100's."""
    rng = np.random.default_rng(seed)
    rows = [dict(flops=float(rng.uniform(1e9, 1e15)),
                 bytes=float(rng.uniform(1e6, 1e12)),
                 collective_bytes=float(rng.uniform(0, 1e10)),
                 step_time_s=float(rng.uniform(0.01, 2)), tokens=4096)
            for _ in range(4)]
    tpu = dict(peak_flops=197e12, hbm_bw=819e9, ici_bw=50e9)
    for r in rows:
        assert telemetry.StepCounters(**r).tma_vector(**tpu) == \
            jax_telemetry.StepCounters(**r).tma_vector(**tpu)
        card = telemetry.StepCounters(**r).tma_vector()
        assert card == telemetry.StepCounters(**r).tma_vector(
            meshlib.PEAK_FLOPS_BF16, meshlib.HBM_BW, meshlib.NVLINK_BW)
        assert sum(card.values()) == pytest.approx(1.0)
    assert telemetry.TMA_METRICS == jax_telemetry.TMA_METRICS
    log, jlog = telemetry.CounterLog(), jax_telemetry.CounterLog()
    for r in rows:
        log.record("job", telemetry.StepCounters(**r))
        jlog.record("job", jax_telemetry.StepCounters(**r))
    # the reference's CounterLog reads its own (TPU) defaults: compare the
    # port's log with the card's figures against the same mean by hand
    want = {k: float(np.mean([telemetry.StepCounters(**r).tma_vector()[k]
                              for r in rows])) for k in log.features("job")}
    assert log.features("job") == want
    assert log.features("none") == jlog.features("none") == {}
    assert set(log.features("job")) == set(jlog.features("job"))


def test_hardware_figures_are_the_cards():
    assert meshlib.PEAK_FLOPS_BF16 == 989e12
    assert meshlib.HBM_BW == 3.35e12
    assert meshlib.NVLINK_BW == 450e9
    assert 79 * 2 ** 30 < meshlib.HBM_BYTES < 80 * 2 ** 30


# ------------------------------------------------------- grad compression --
def test_grad_compression_example_equals_the_reference_example():
    sys.path.insert(0, os.path.join(REPO, "examples"))
    try:
        import torch_grad_compression as ex
    finally:
        sys.path.pop(0)
    got = ex.wire_bytes(device="cpu")
    want = _reference("grad_compression")
    assert got == want
    assert want["int8"] < want["fp32"] / 3.9
