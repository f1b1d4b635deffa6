"""Quickstart on the PyTorch/CUDA port: the whole stack in one page, the
twin of ``examples/quickstart.py``.

  PYTHONPATH=src python examples/torch_quickstart.py               # on the card
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu

1. build an assigned architecture (reduced config),
2. take two training steps,
3. prefill + decode a few tokens,
4. let the Pond control plane place a "VM" across local/pool memory.
"""
import argparse

import torch

from repro_torch.configs.registry import get_smoke
from repro_torch.core import traces
from repro_torch.core.control_plane import ControlPlane, ControlPlaneConfig
from repro_torch.core.pool_manager import PoolManager
from repro_torch.data.pipeline import DataConfig, ShardedBatches
from repro_torch.device import resolve_device
from repro_torch.models.model_zoo import build_model
from repro_torch.optim import adamw
from repro_torch.runtime import train as rt
from repro_torch.sharding.rules import ShardCtx


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' to run on the CPU")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_smoke("qwen2-1.5b")
    model = build_model(cfg, device=dev)
    model.init_params(torch.Generator(device=dev).manual_seed(0))
    print(f"arch={cfg.name}: {cfg.num_layers}L d={cfg.d_model} on {dev}")

    # --- train two steps ---------------------------------------------------
    ocfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    params = rt.train_params(model)
    opt = adamw.init_state(params, ocfg)
    step = rt.jit_train_step(model, ocfg, ShardCtx())
    data = ShardedBatches(DataConfig(cfg.vocab_size, 32, 4))
    losses = []
    for i in range(2):
        batch = {"tokens": torch.from_numpy(next(data)["tokens"]).to(dev)}
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        print(f"step {i}: loss={losses[-1]:.3f}")
    for p in params.values():
        p.requires_grad_(False)

    # --- prefill + decode --------------------------------------------------
    with torch.no_grad():
        toks = torch.arange(8, device=dev)[None]
        cache = model.init_cache(1, 32)
        h, cache, _ = model.prefill(toks, torch.arange(8, device=dev)[None],
                                    cache)
        nxt = int(torch.argmax(model.logits(h[:, -1:])[0, -1]))
        outs = [nxt]
        for t in range(8, 12):
            lg, cache = model.decode(torch.tensor([[nxt]], device=dev),
                                     torch.tensor([t], device=dev), cache)
            nxt = int(torch.argmax(lg[0, 0]))
            outs.append(nxt)
    print("generated:", outs)

    # --- Pond placement ----------------------------------------------------
    pop = traces.Population(seed=0)
    vm = pop.sample_vms(1, 60.0, seed=3)[0]
    cp = ControlPlane(ControlPlaneConfig(), None, None,
                      PoolManager(pool_gb=64, buffer_gb=8))
    pl = cp.on_request(vm, host=0, now=0.0)
    print(f"VM {vm.mem_gb:.0f}GB -> local={pl.local_gb:.0f}GB "
          f"pool={pl.pool_gb:.0f}GB")
    return {"losses": losses, "generated": outs,
            "placement": (vm.mem_gb, pl.local_gb, pl.pool_gb)}


if __name__ == "__main__":
    main()
