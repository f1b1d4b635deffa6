"""Device meshes: a grid of torch devices with named axes.

The port drives every device from one process (the design of ``devices=``
since M13): a mesh is an array of ``torch.device``s, repeats allowed, so
``[card] * 4`` is a 2 x 2 mesh of one card and ``[torch.device("cpu")] *
8`` a 2 x 4 mesh on the CPU.  No ``torch.distributed`` process group is
made.  ``Mesh.shape`` maps each axis name to its size, as JAX's does;
``sharding/rules.py::shard_map`` runs a function once a coordinate on that
coordinate's device.

The production shapes are the reference's: one pod 16 x 16 ("data",
"model"), two pods 2 x 16 x 16 ("pod", "data", "model").
"""
from __future__ import annotations

import itertools
import math

import numpy as np
import torch


class Mesh:
    """An n-d array of devices with one name an axis."""

    def __init__(self, devices: np.ndarray, axis_names):
        """``devices``: an object array of ``torch.device``s, one dim an
        axis name."""
        self.axis_names = tuple(axis_names)
        self.devices = devices
        if devices.ndim != len(self.axis_names):
            raise ValueError(f"{devices.ndim}-d devices for axes "
                             f"{self.axis_names}")
        if len(self.axis_names) != len(set(self.axis_names)):
            raise ValueError(f"repeated axis name in {self.axis_names}")

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, in axis order."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def coords(self):
        """Every coordinate, row-major (the last axis fastest)."""
        return list(itertools.product(*(range(n)
                                        for n in self.devices.shape)))

    def device_at(self, coord) -> torch.device:
        return self.devices[tuple(coord)]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.flat]})")


def make_mesh(shape, axes, devices=None) -> Mesh:
    """A mesh of ``shape`` with axis names ``axes`` over ``devices``
    (exactly prod(shape) of them, repeats allowed).  ``None`` takes the
    first prod(shape) visible CUDA cards and raises where there are fewer:
    to put several coordinates on one card, list it that many times."""
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    n = math.prod(shape)
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh(devices=None) takes the CUDA cards and none is "
                "visible; pass devices= (e.g. [torch.device('cpu')] * n) to "
                "make a mesh on the CPU on purpose")
        count = torch.cuda.device_count()
        if count < n:
            raise ValueError(
                f"a {shape} mesh needs {n} devices and {count} cards are "
                "visible; pass devices= (repeats allowed: [card] * n)")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = list(devices)
    if len(devices) != n:
        raise ValueError(f"a {shape} mesh needs {n} devices, got "
                         f"{len(devices)}")
    grid = np.empty(n, dtype=object)
    grid[:] = [torch.device(d) for d in devices]
    return Mesh(grid.reshape(shape), axes)


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    """The reference's production shapes over ``devices`` (256 or 512 of
    them, repeats allowed; ``None`` takes the visible cards)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices)


# The H100's figures, the roofline targets of the dry run
# (``launch/dryrun.py``) and ``core/telemetry.py``.  Card: ``NVIDIA H100
# 80GB HBM3, 700.00 W`` (nvidia-smi's name and power limit); the first
# three are the SXM5 data sheet's, the last what
# ``torch.cuda.get_device_properties(0).total_memory`` reads on that card.
PEAK_FLOPS_BF16 = 989e12        # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12                # bytes/s of HBM3
NVLINK_BW = 450e9               # bytes/s each way, a card's NVLink total
HBM_BYTES = 85_017_493_504      # 79.18 GiB: what the card reports
