"""The port's ``runtime/fault.py`` as ``tests/test_fault.py`` covers the
reference's: heartbeats, the largest mesh shape (arithmetic, ``==`` the
reference's over a grid), stragglers, the failure injector and the EMC
failure schedule; the elastic restore becomes a restore onto another
device.  The re-mesh itself (``elastic_mesh``) is held to the reference's
in ``tests/test_torch_mesh.py``."""
import numpy as np
import pytest
import torch

from repro.runtime import fault as jax_fault
from repro_torch.runtime import checkpoint as ckpt
from repro_torch.runtime import fault


def test_heartbeat_monitor():
    t = {"now": 0.0}
    mon = fault.HeartbeatMonitor(["h0", "h1", "h2"], timeout=2.0,
                                 clock=lambda: t["now"])
    t["now"] = 1.0
    mon.beat("h0")
    mon.beat("h1")
    t["now"] = 2.5
    assert mon.dead_hosts() == ["h2"]
    assert mon.alive_hosts() == ["h0", "h1"]
    t["now"] = 3.5
    assert mon.dead_hosts() == ["h0", "h1", "h2"] and not mon.alive_hosts()


def test_largest_mesh_shape():
    assert fault.largest_mesh_shape(256, 16) == (16, 16)
    assert fault.largest_mesh_shape(240, 16) == (15, 16)
    assert fault.largest_mesh_shape(512, 16, multi_pod=True) == (2, 16, 16)
    with pytest.raises(ValueError):
        fault.largest_mesh_shape(8, 16)
    for n in (1, 3, 16, 17, 100, 512):
        for mp in (1, 2, 4, 16):
            for pods in (False, True):
                if n < mp:
                    continue
                assert fault.largest_mesh_shape(n, mp, pods) == \
                    jax_fault.largest_mesh_shape(n, mp, pods)


def test_straggler_tracker():
    tr = fault.StragglerTracker(factor=1.5)
    for _ in range(5):
        tr.record("a", 1.0)
        tr.record("b", 1.05)
        tr.record("c", 2.2)
    assert tr.stragglers() == ["c"]


def test_failure_injector():
    inj = fault.FailureInjector({5: ["h1"], 9: ["h2"]})
    assert inj.failed_by(4) == set()
    assert inj.failed_by(5) == {"h1"}
    assert inj.failed_by(9) == {"h1", "h2"}
    ref = jax_fault.FailureInjector({5: ["h1"], 9: ["h2"]})
    assert all(inj.failed_by(s) == ref.failed_by(s) for s in range(12))


def test_failure_schedule_generate_deterministic():
    a = fault.FailureSchedule.generate(86400, 4, 3600.0, 600.0, seed=3)
    b = fault.FailureSchedule.generate(86400, 4, 3600.0, 600.0, seed=3)
    np.testing.assert_array_equal(a.times, b.times)
    np.testing.assert_array_equal(a.domains, b.domains)
    np.testing.assert_array_equal(a.recovers, b.recovers)
    c = fault.FailureSchedule.generate(86400, 4, 3600.0, 600.0, seed=4)
    assert not np.array_equal(a.times, c.times)
    ref = jax_fault.FailureSchedule.generate(86400, 4, 3600.0, 600.0, seed=3)
    np.testing.assert_array_equal(a.times, ref.times)
    np.testing.assert_array_equal(a.domains, ref.domains)


def test_failure_schedule_shape_and_order():
    s = fault.FailureSchedule.generate(10 * 86400, 3, 6 * 3600.0, 1800.0,
                                       seed=0)
    assert len(s) > 0
    assert (np.diff(s.times) >= 0).all()
    assert s.max_domain() < 3
    assert s.n_failures == int((~s.recovers).sum())
    for d in range(3):
        rec = s.recovers[s.domains == d]
        assert (rec == (np.arange(len(rec)) % 2 == 1)).all()


def test_failure_schedule_validation():
    with pytest.raises(ValueError):
        fault.FailureSchedule(np.array([2.0, 1.0]), np.array([0, 0]),
                              np.array([False, True]))
    with pytest.raises(ValueError):
        fault.FailureSchedule(np.array([1.0]), np.array([-1]),
                              np.array([False]))
    with pytest.raises(ValueError):
        fault.FailureSchedule(np.array([1.0]), np.array([0, 1]),
                              np.array([False]))


def test_checkpoint_restores_onto_another_device(tmp_path, rng):
    """A checkpoint is device-agnostic: written from one device, restored
    onto the one given (the reference's restore under new shardings)."""
    tree = {"w": torch.from_numpy(rng.normal(size=(8, 4)).astype(np.float32)),
            "s": torch.tensor(3, dtype=torch.int32)}
    ckpt.save(str(tmp_path), 1, tree)
    back = ckpt.restore(str(tmp_path), 1, tree, device="cpu")
    assert torch.equal(back["w"], tree["w"]) and int(back["s"]) == 3
    assert back["w"].device == torch.device("cpu")
