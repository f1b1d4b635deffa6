"""End-to-end driver on the PyTorch/CUDA port: train a ~100M-param
qwen2-family model for a few hundred steps on the synthetic bigram
stream, with checkpointing; the twin of ``examples/train_small.py``.

  PYTHONPATH=src python examples/torch_train_small.py [--steps 200]
  PYTHONPATH=src python examples/torch_train_small.py --device cpu --steps 4

(~100M params: d_model=768, 12 layers, ff=2560, vocab 4096 tied.)  The
checkpoints go to ``build/torch_train_small`` under the checkout unless
``--ckpt-dir`` says otherwise.
"""
import argparse
import os

from repro_torch.launch import train as lt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(REPO, "build", "torch_train_small"))
    ap.add_argument("--device", default="cuda",
                    help="the CUDA card (default); 'cpu' runs on the CPU")
    args = ap.parse_args(argv)
    return lt.main([
        "--arch", "qwen2-1.5b", "--preset", "100m",
        "--steps", str(args.steps),
        "--global-batch", "2", "--seq-len", "128",
        "--lr", "3e-4", "--log-every", "5",
        "--ckpt-dir", args.ckpt_dir, "--ckpt-every", "50",
        "--device", args.device,
    ])


if __name__ == "__main__":
    main()
