"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and becomes one shared
library, compiled for ``sm_90a`` at first use into ``build/`` at the root
of the checkout (git-ignored).  The library's file name carries a hash of
the source and the flags, so an edited source is rebuilt and an unchanged
one is reused.  A missing compiler or a failed build raises; nothing falls
back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PACKAGE = Path(__file__).resolve().parents[1]           # src/repro_torch
CSRC_DIR = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE.parents[1] / "build" / "repro_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.isfile(nvcc):
        raise RuntimeError(
            "nvcc not found (looked on PATH and under "
            f"{cuda_home}/bin): the CUDA kernels cannot be built here")
    return nvcc


def library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build_library(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built.
    The compiler's output (registers, shared memory, spills per kernel)
    is kept beside the library as ``<library>.log``."""
    lib = library_path(name)
    if lib.exists():
        return lib
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    Path(f"{lib}.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {name}.cu "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)             # atomic: a reader never sees half a file
    return lib


def load_library(name: str) -> ctypes.CDLL:
    """Build if needed, then load once per process."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(str(build_library(name)))
    return _LIBS[name]
