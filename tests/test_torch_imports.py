"""The port stands alone: it imports neither JAX nor the reference
package, and its entry points refuse to run without a CUDA device unless
the caller asks for the CPU."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "examples", "torch_serve_tiered.py"),
             os.path.join(REPO, "examples", "torch_cluster_savings.py"),
             os.path.join(REPO, "examples", "torch_fig21_savings.py"),
             os.path.join(REPO, "examples", "torch_fig16_spill.py"),
             os.path.join(REPO, "examples", "torch_fig_availability.py"),
             os.path.join(REPO, "scripts", "torch_profile_decode.py"),
             os.path.join(REPO, "scripts", "torch_k1_ab.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_import_of_jax_or_the_reference_package(path):
    assert not (_imported_roots(path) & FORBIDDEN)


def test_port_mirrors_the_reference_layout():
    for rel in ("configs/base.py", "configs/registry.py",
                "configs/qwen2_1_5b.py", "models/params.py",
                "models/compute.py", "models/layers.py",
                "models/attention.py", "models/transformer.py",
                "models/model_zoo.py", "kernels/paged_attention/kernel.py",
                "kernels/paged_attention/ops.py",
                "kernels/paged_attention/ref.py", "core/znuma.py",
                "core/slices.py", "core/telemetry.py",
                "core/latency_model.py", "runtime/fault.py",
                "serving/kv_cache.py", "serving/scheduler.py",
                "serving/engine.py", "launch/serve.py",
                "configs/h2o_danube_1_8b.py",
                "kernels/flash_attention/kernel.py",
                "kernels/flash_attention/ops.py",
                "kernels/flash_attention/ref.py", "sharding/rules.py",
                "runtime/serve.py", "core/traces.py", "core/qos.py",
                "core/policy_engine.py", "core/sweep_core.py",
                "core/replay_engine.py", "core/cluster_sim.py",
                "core/control_plane.py", "core/pool_manager.py",
                "core/predictors/trees.py", "core/predictors/forest.py",
                "core/predictors/gbm.py", "core/predictors/models.py",
                "core/latency_engine.py", "core/eqn1.py"):
        assert os.path.isfile(os.path.join(PORT, rel)), rel
        assert os.path.isfile(os.path.join(REPO, "src", "repro", rel)), rel
    for name in ("paged_attention.cu", "flash_attention.cu",
                 "event_sweep.cu", "spill_sweep.cu", "fail_sweep.cu"):
        assert os.path.isfile(os.path.join(PORT, "csrc", name)), name
    # K1, K5 and K6 replace lax.scans, not Pallas kernels: their modules
    # have no counterpart path in the reference
    for kernel in ("event_sweep", "spill_sweep", "fail_sweep"):
        for name in ("kernel.py", "ops.py", "ref.py", "cases.py"):
            assert os.path.isfile(os.path.join(PORT, "kernels", kernel,
                                               name)), (kernel, name)


def _run(code_or_args, **kw):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.run([sys.executable, *code_or_args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120, **kw)


def test_importing_the_port_pulls_in_neither_jax_nor_repro():
    code = ("import sys, pkgutil, importlib, repro_torch\n"
            "import repro_torch.launch.serve\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, "
            "'repro_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "print('BAD', bad)\n")
    proc = _run(["-c", code])
    assert proc.returncode == 0, proc.stderr
    assert "BAD []" in proc.stdout


def test_entry_points_refuse_to_run_without_a_card():
    """This machine has no CUDA device: ``device=None`` must raise, never
    run on the CPU."""
    import torch
    import importlib.util
    from repro_torch.configs.registry import get_smoke
    from repro_torch.core import cluster_sim
    from repro_torch.core import latency_engine as le
    from repro_torch.core.policy_engine import PolicyDecisions
    from repro_torch.core.predictors.forest import RandomForest
    from repro_torch.core.predictors.gbm import (QuantileGBM, pack_gbms,
                                                 predict_gbms_torch)
    from repro_torch.core.predictors.trees import Tree
    from repro_torch.core.replay_engine import CompiledReplay
    from repro_torch.device import resolve_device
    from repro_torch.launch import serve
    from repro_torch.models.convert import cache_from_numpy, params_from_numpy
    from repro_torch.models.model_zoo import build_model
    from repro_torch.serving.kv_cache import KVConfig, TieredPagedKV
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    cfg = get_smoke("qwen2-1.5b")
    spec = importlib.util.spec_from_file_location(
        "torch_cluster_savings",
        os.path.join(REPO, "examples", "torch_cluster_savings.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    spec = importlib.util.spec_from_file_location(
        "torch_fig21_savings",
        os.path.join(REPO, "examples", "torch_fig21_savings.py"))
    fig21 = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fig21)
    spec = importlib.util.spec_from_file_location(
        "torch_fig16_spill",
        os.path.join(REPO, "examples", "torch_fig16_spill.py"))
    fig16 = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fig16)
    spec = importlib.util.spec_from_file_location(
        "torch_fig_availability",
        os.path.join(REPO, "examples", "torch_fig_availability.py"))
    fig_avail = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fig_avail)
    from repro_torch.runtime.fault import FailureSchedule
    schedule = FailureSchedule(np.zeros(0), np.zeros(0, np.int64),
                               np.zeros(0, bool))
    leaf = Tree(np.array([-1], np.int32), np.zeros(1, np.float32),
                np.zeros(1, np.int32), np.zeros(1, np.int32),
                np.zeros(1, np.float32), 0)
    gbm = QuantileGBM(0.0, [leaf], 0.1, 0.05)
    empty = PolicyDecisions(*(np.zeros(0),) * 4)
    cluster = cluster_sim.ClusterConfig(n_servers=8)
    for call in (lambda: resolve_device(None),
                 lambda: CompiledReplay([], empty, cluster),
                 lambda: CompiledReplay([], empty, cluster,
                                        failure_schedule=schedule),
                 lambda: fig_avail.main(["--servers", "2"]),
                 lambda: cluster_sim.savings_analysis([], cluster, "local"),
                 lambda: cluster_sim.savings_analysis_batched([[]], cluster,
                                                              "local"),
                 lambda: example.main(["--days", "0.1"]),
                 lambda: fig21.main(["--days", "0.1", "--seeds", "1",
                                     "--servers", "2", "--train-vms", "60"]),
                 lambda: fig16.main(["--requests", "4", "--peak-pages", "8",
                                     "--local-step", "4"]),
                 lambda: le.spill_grid([0], [0], [1], [1]),
                 lambda: le.slowdown_band_grid([0.1]),
                 lambda: cluster_sim.tiered_pricing(empty),
                 lambda: RandomForest([]).predict_proba_torch(np.zeros((1, 1))),
                 lambda: QuantileGBM(0.0, [], 0.1, 0.5).predict_torch(
                     np.zeros((1, 1))),
                 lambda: predict_gbms_torch(pack_gbms([gbm, gbm]),
                                            np.zeros((1, 1))),
                 lambda: resolve_device("cuda"),
                 lambda: build_model(cfg),
                 lambda: params_from_numpy({}, cfg),
                 lambda: cache_from_numpy({}, cfg),
                 lambda: TieredPagedKV(KVConfig(1, 1, 8)),
                 lambda: serve.main([])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert resolve_device("cpu").type == "cpu"


def test_cuda_tensor_path_never_falls_back_in_source():
    """The wrappers have no ``try`` around build or launch, and the port
    never calls PyTorch's fused attention: only ``chip_smoke.py`` times it,
    as the library yardstick, in one function of its own."""
    for rel in ("kernels/paged_attention/ops.py",
                "kernels/paged_attention/kernel.py", "kernels/build.py",
                "kernels/flash_attention/ops.py",
                "kernels/flash_attention/kernel.py",
                "kernels/event_sweep/ops.py",
                "kernels/event_sweep/kernel.py",
                "kernels/spill_sweep/ops.py",
                "kernels/spill_sweep/kernel.py",
                "kernels/fail_sweep/ops.py",
                "kernels/fail_sweep/kernel.py"):
        with open(os.path.join(PORT, rel)) as f:
            tree = ast.parse(f.read())
        assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)], rel
    smoke = os.path.join(REPO, "chip_smoke.py")
    for path in _port_files():
        with open(path) as f:
            src = f.read()
        if path != smoke:
            assert "scaled_dot_product_attention" not in src, path
            continue
        yardstick = [n for n in ast.walk(ast.parse(src))
                     if isinstance(n, ast.FunctionDef)
                     and n.name == "_sdpa_library_call"]
        assert len(yardstick) == 1
        inside = ast.get_source_segment(src, yardstick[0])
        assert src.count("scaled_dot_product_attention") == \
            inside.count("scaled_dot_product_attention")


def test_chip_smoke_fails_without_a_card(tmp_path):
    """With no CUDA device visible the script exits non-zero and prints no
    result; so does a copy of it that stands alone, without the package."""
    import shutil
    hidden = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), alone)
    for script, cwd in (("chip_smoke.py", REPO), (str(alone), tmp_path)):
        proc = subprocess.run([sys.executable, script], cwd=cwd, env=hidden,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
        assert proc.stdout.strip() == ""
