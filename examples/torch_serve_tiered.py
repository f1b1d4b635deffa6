"""Tiered-KV serving demo on the PyTorch/CUDA port: zNUMA bias, slice
ownership, QoS migration.

  PYTHONPATH=src python examples/torch_serve_tiered.py               # on the card
  PYTHONPATH=src python examples/torch_serve_tiered.py --device cpu  # plain versions
"""
import argparse

from repro_torch.launch import serve as ls


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' to run on the CPU")
    args = ap.parse_args(argv)
    # local tier deliberately small -> visible zNUMA spill + mitigation
    argv = ["--arch", "qwen2-1.5b", "--requests", "10",
            "--max-batch", "3", "--local-pages", "8",
            "--pool-pages", "96", "--page-size", "4", "--pdm", "0.2"]
    if args.device is not None:
        argv += ["--device", args.device]
    ls.main(argv)


if __name__ == "__main__":
    main()
