"""The port's dry run (``launch/dryrun.py``, M16) and the spec arithmetic
it rests on, held against the reference:

* ``params.abstract`` (meta tensors), ``param_bytes`` and
  ``param_count`` ``==`` the reference's on the ten registry configs;
* ``structural_bytes``, ``active_param_count`` and ``model_flops`` ``==``
  the reference's for every arch x shape x mesh, and ``make_ctx``'s
  choices (the reference's side runs in a subprocess with its 512 forced
  host devices, ``tests/_torch_dryrun_reference.py``);
* the plans, skips and constants are the reference's;
* ``run_cell`` records a cell (``ok``, ``skip``, and ``error`` for the a2a
  override the meta run cannot count) without a tensor off the meta
  device; the CLI and ``--summary``;
* the examples ``torch_quickstart.py`` and ``torch_train_small.py`` on the
  CPU.

The whole grid (``--mesh single``, ~4.5 min on one core) is
``chip_smoke.py``'s ``dryrun_full``; here a cheap cell of each kind."""
import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import registry as jreg
from repro.models.model_zoo import build_model as jax_build_model
from repro.models.params import abstract as jax_abstract
from repro.models.params import param_bytes as jax_param_bytes
from repro.models.params import param_count as jax_param_count
from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as meshlib
from repro_torch.models.model_zoo import build_model
from repro_torch.models.params import (abstract, map_with_path, param_bytes,
                                       param_count)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
META = torch.device("meta")


@functools.cache
def _reference_spec():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "tests",
                                      "_torch_dryrun_reference.py"), "spec"],
        env=env, capture_output=True, text=True, check=True, cwd=REPO)
    return json.loads(out.stdout.strip().splitlines()[-1])


def _jflat(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        out[tuple(getattr(k, "key", getattr(k, "idx", None))
                  for k in path)] = leaf
    return out


# ------------------------------------------------------------ the specs ---
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_param_bytes_and_count_equal_the_reference(arch):
    jspecs = jax_build_model(jreg.get_config(arch)).specs()
    specs = build_model(get_config(arch), device=META).specs()
    assert param_count(specs) == jax_param_count(jspecs)
    assert param_bytes(specs) == jax_param_bytes(jspecs)
    want = {k: (tuple(v.shape), str(np.dtype(v.dtype)))
            for k, v in _jflat(jax_abstract(jspecs)).items()}
    got = {}
    map_with_path(lambda p, t: got.__setitem__(
        p, (tuple(t.shape), str(t.dtype).replace("torch.", ""))),
        abstract(specs))
    assert got == want
    assert all(t.device == META for t in _leaves(abstract(specs)))


def _leaves(tree):
    out = []
    map_with_path(lambda _, t: out.append(t), tree)
    return out


def test_plans_skips_and_constants_are_the_references():
    from repro.configs.base import SHAPES as JSHAPES
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JSHAPES.items()}
    want = _reference_spec()
    assert want["plans"] == {k: dataclasses.asdict(v)
                             for k, v in dryrun.PLANS.items()}
    assert want["skips"] == {f"{a}|{s}": r
                             for (a, s), r in dryrun.SKIPS.items()}
    assert want["whisper_dec_len"] == dryrun.WHISPER_DEC_LEN


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_arithmetic_equals_the_reference(arch, multi_pod):
    """Every shape of ``arch`` on one mesh: ``structural_bytes``,
    ``active_param_count``, ``model_flops`` and ``make_ctx``'s fields,
    all ``==``."""
    ref = _reference_spec()
    n = 512 if multi_pod else 256
    mesh = meshlib.make_production_mesh(multi_pod=multi_pod,
                                        devices=[META] * n)
    cfg = get_config(arch)
    model = build_model(cfg, device=META)
    plan = dryrun.PLANS[arch]
    for name, shape in SHAPES.items():
        want = ref["cells"][f"{int(multi_pod)}|{arch}|{name}"]
        ctx = dryrun.make_ctx(mesh, multi_pod, shape, plan, cfg)
        assert dryrun.structural_bytes(cfg, shape, plan, mesh, model,
                                       ctx) == want["structural_bytes"]
        assert list(dryrun.active_param_count(cfg, model)) == \
            want["active_param_count"]
        assert dryrun.model_flops(cfg, shape, model) == want["model_flops"]
        assert {k: (list(v) if isinstance(v, tuple) else v)
                for k, v in dict(
                    moe_impl=ctx.moe_impl, remat=ctx.remat,
                    seq_shard_kv=ctx.seq_shard_kv, pod_axis=ctx.pod_axis,
                    batch_axes=ctx.batch_axes).items()} == want["ctx"]
        assert [list(e) if isinstance(e, tuple) else e for e in
                dryrun.batch_pspec(ctx, shape.global_batch, 2)] == \
            want["batch_pspec"]


# ------------------------------------------------------------- run_cell ---
class _Devices(TorchDispatchMode):
    """Every device an op's output lies on."""

    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for o in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(o, torch.Tensor):
                self.seen.add(o.device.type)
        return out


@pytest.mark.parametrize("arch,shape", [
    ("qwen2-1.5b", "decode_32k"), ("mamba2-1.3b", "long_500k"),
    ("granite-moe-1b-a400m", "decode_32k"),
    ("whisper-small", "decode_32k")])
def test_run_cell_records_a_cell_on_meta_alone(tmp_path, arch, shape):
    with _Devices() as d:
        rec = dryrun.run_cell(arch, shape, False, str(tmp_path))
    assert d.seen <= {"meta", "cpu"}, d.seen
    assert rec["status"] == "ok", rec.get("error")
    assert rec["devices"] == 256
    oc = rec["op_counts"]
    assert oc["flops"] > 0 and oc["bytes_per_device"] > 0
    assert oc["flops_per_device"] == oc["flops"] / 256
    assert rec["memory"]["fits_device"] == (
        rec["memory"]["device_total_bytes"] <= meshlib.HBM_BYTES)
    assert rec["roofline"]["dominant"] in ("compute", "memory",
                                           "collective")
    assert set(oc["kernel_launches"]) >= {"flash_attention",
                                          "paged_attention"}
    with open(tmp_path / "single" / f"{arch}__{shape}.json") as f:
        assert json.load(f) == json.loads(json.dumps(rec))


def test_cpu_tensors_the_dry_run_makes_are_host_tables(tmp_path):
    """The only CPU tensors of a cell are the host's small tables (the
    rope frequencies, whisper's sinusoids): nothing the size of a weight
    or an activation."""
    big = []

    class _Big(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for o in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(o, torch.Tensor) and o.device.type == "cpu" \
                        and o.numel() > 1 << 20:
                    big.append((str(func), tuple(o.shape)))
            return out

    with _Big():
        rec = dryrun.run_cell("qwen2-1.5b", "decode_32k", False,
                              str(tmp_path))
    assert rec["status"] == "ok" and big == []


def test_skips_and_the_a2a_override(tmp_path):
    rec = dryrun.run_cell("qwen2-1.5b", "long_500k", False, str(tmp_path))
    assert rec == {"arch": "qwen2-1.5b", "shape": "long_500k",
                   "mesh": "single", "status": "skip",
                   "skip_reason": dryrun.SKIPS[("qwen2-1.5b", "long_500k")]}
    assert dryrun.cell_skip_reason("mamba2-1.3b", "long_500k") is None
    # the a2a expert path reads its row counts to the host: on meta the
    # cell records the error, as the reference records a failed compile
    rec = dryrun.run_cell("deepseek-v3-671b", "prefill_32k", False,
                          str(tmp_path),
                          plan_overrides={"moe_serve_impl": "sharded_a2a"})
    assert rec["status"] == "error"
    assert rec["error"].startswith("NotImplementedError: moe_sharded_a2a")


def test_cli_writes_and_summarizes(tmp_path, capsys):
    out = str(tmp_path)
    dryrun.main(["--arch", "qwen2-1.5b,whisper-small", "--shape",
                 "decode_32k,long_500k", "--mesh", "single", "--outdir",
                 out, "--set", "xent_chunk=256", "--set", "remat=false"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 4
    assert sorted(os.listdir(tmp_path / "single")) == sorted(
        f"{a}__{s}.json" for a in ("qwen2-1.5b", "whisper-small")
        for s in ("decode_32k", "long_500k"))
    with open(tmp_path / "single" / "qwen2-1.5b__decode_32k.json") as f:
        plan = json.load(f)["plan"]
    assert plan["xent_chunk"] == 256 and plan["remat"] is False
    dryrun.main(["--summary", "--outdir", out])
    summary = capsys.readouterr().out.splitlines()
    assert len(summary) == 4
    assert sum(" ok " in s for s in summary) == 2
    assert sum(" skip " in s for s in summary) == 2
    assert dryrun.parse_overrides(["microbatches=2", "two_phase=yes"]) == \
        {"microbatches": 2, "two_phase": True}


def test_multi_pod_cell(tmp_path):
    rec = dryrun.run_cell("h2o-danube-1.8b", "long_500k", True,
                          str(tmp_path))
    assert rec["status"] == "ok" and rec["devices"] == 512
    assert rec["mesh"] == "multi"


# ------------------------------------------------------------- examples ---
def _example(name):
    sys.path.insert(0, os.path.join(REPO, "examples"))
    try:
        return __import__(name)
    finally:
        sys.path.pop(0)


def test_quickstart_example_on_the_cpu(capsys):
    out = _example("torch_quickstart").main(["--device", "cpu"])
    assert all(np.isfinite(out["losses"])) and len(out["losses"]) == 2
    assert len(out["generated"]) == 5
    # the placement is the reference's (the same VM, the same plane)
    assert out["placement"] == (8.0, 8.0, 0.0)
    assert "VM 8GB -> local=8GB pool=0GB" in capsys.readouterr().out


def test_train_small_example_on_the_cpu(tmp_path):
    params, opt = _example("torch_train_small").main(
        ["--device", "cpu", "--steps", "1", "--ckpt-dir", str(tmp_path)])
    assert int(opt["step"]) == 1
    assert os.path.isdir(tmp_path / "step_00000001")
    assert all(bool(torch.isfinite(p).all()) for p in params.values())
