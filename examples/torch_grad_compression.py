"""Cross-pod int8 gradient all-reduce on the PyTorch/CUDA port: the wire
bytes of the fp32 ``psum`` and of the int8 ``all_gather``
(``optim/compress.py::QTensor``) counted by ``launch/op_analysis.py``, the
twin of ``examples/grad_compression.py`` (which reads them from compiled
HLO).  A (2, 4) ("pod", "data") mesh: the card listed eight times (the
coordinates run in turn on it), or the CPU with ``--device cpu``.

  PYTHONPATH=src python examples/torch_grad_compression.py               # on the card
  PYTHONPATH=src python examples/torch_grad_compression.py --device cpu
"""
import argparse

import torch

from repro_torch.device import resolve_device
from repro_torch.launch import op_analysis
from repro_torch.launch.mesh import make_mesh
from repro_torch.optim.compress import QTensor
from repro_torch.sharding import rules
from repro_torch.sharding.rules import P, shard_map

SHAPE = (1024, 512)       # the gradient, sharded (256, 512) a data rank


def _syncs(mesh):
    spec = P("data", None)

    def sync_fp32(g):
        return shard_map(lambda x: rules.psum(x, "pod") / 2, mesh=mesh,
                         in_specs=(spec,), out_specs=spec)(g)

    def sync_int8(g):
        def local(x):
            q = QTensor.quantize(x)
            # the wire carries the int8 payload (+ tiny fp32 scales):
            # all-gather, then reduce locally: ~4x less cross-pod traffic
            datas = rules.all_gather(q.data, "pod", axis=0)     # int8 wire
            scales = rules.all_gather(q.scale, "pod", axis=0)   # fp32, small
            deq = (datas.to(torch.float32) * scales).reshape(2, -1).mean(0)
            return deq[: x.numel()].reshape(x.shape)
        return shard_map(local, mesh=mesh, in_specs=(spec,),
                         out_specs=spec)(g)
    return {"fp32": sync_fp32, "int8": sync_int8}


def wire_bytes(device=None, seed: int = 0) -> dict:
    """Cross-pod collective wire bytes a device of each sync (the mesh's
    count over its 8 devices); ``device=None`` is the card."""
    dev = resolve_device(device)
    mesh = make_mesh((2, 4), ("pod", "data"), devices=[dev] * 8)
    g = torch.randn(SHAPE, generator=torch.Generator(device=dev)
                    .manual_seed(seed), device=dev)
    out = {}
    for name, fn in _syncs(mesh).items():
        with op_analysis.OpCounter() as c:
            fn(g)
        out[name] = c.counts.collective_bytes / mesh.size
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' to run on the CPU")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    mesh = make_mesh((2, 4), ("pod", "data"), devices=[dev] * 8)
    g = torch.randn(SHAPE, generator=torch.Generator(device=dev)
                    .manual_seed(0), device=dev)
    syncs = _syncs(mesh)
    exact, approx = syncs["fp32"](g), syncs["int8"](g)
    for name, b in wire_bytes(dev).items():
        print(f"{name}: cross-pod collective wire bytes/device = {b:,.0f}")
    err = float((exact - approx).abs().max())
    print(f"int8 against fp32: max abs difference {err:.3e} "
          f"(|g| max {float(g.abs().max()):.2f})")


if __name__ == "__main__":
    main()
