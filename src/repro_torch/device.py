"""Device policy of the port: the card unless the caller asks for the CPU."""
from __future__ import annotations

import subprocess

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the CUDA card and raises where none is visible.

    Only an explicit ``device="cpu"`` runs on the CPU: no entry point of
    the port moves there on its own.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device and none is visible; "
                "pass device='cpu' to run on the CPU on purpose")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not "
                               "available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def resolve_dtype(dtype: str | torch.dtype) -> torch.dtype:
    """'float32' | 'bfloat16' (or the torch dtypes themselves)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    except KeyError:
        raise ValueError(f"unsupported dtype {dtype!r}; "
                         "use 'float32' or 'bfloat16'") from None


def nvidia_smi_line() -> str:
    """The first card's name and power limit, as ``nvidia-smi`` prints
    them; every measurement is reported beside this line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]
