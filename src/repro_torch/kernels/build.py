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
import re
import shutil
import subprocess
import threading
import time
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


class Nvcc:
    """One ``nvcc`` in flight.  A thread reads its output as it comes and
    notes the wall seconds it ran (``seconds``), so a build that ends
    while its caller is busy elsewhere still has its own time."""

    def __init__(self, nvcc: str, name: str, lib: Path):
        self.name, self.lib = name, lib
        self.tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        self.log, self.seconds = "", None
        t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(self.tmp),
             str(CSRC_DIR / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

        def drain():
            self.log = self.proc.communicate()[0]
            self.seconds = time.perf_counter() - t0
        self._reader = threading.Thread(target=drain, daemon=True)
        self._reader.start()


def start_builds(names) -> list[Nvcc]:
    """Start one ``nvcc`` for each ``csrc/<name>.cu`` whose library is not
    built yet, all together, and return without waiting: pass the result
    to :func:`finish_builds`."""
    todo = [(n, library_path(n)) for n in names]
    todo = [(n, lib) for n, lib in todo if not lib.exists()]
    if todo:
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return [Nvcc(nvcc, name, lib) for name, lib in todo]


def build_libraries(names) -> list[Path]:
    """Compile each ``csrc/<name>.cu`` whose library is not built yet, one
    ``nvcc`` per source, all started together.  The compiler's output
    (registers, shared memory, spills per kernel) is kept beside each
    library as ``<library>.log``."""
    finish_builds(start_builds(names))
    return [library_path(n) for n in names]


def finish_builds(builds) -> dict[str, float]:
    """Wait for builds :func:`start_builds` started; keep each log beside
    its library, move each library into place, raise if any failed.
    Returns each build's own wall seconds by source name."""
    failed = []
    for b in builds:
        b._reader.join()
        Path(f"{b.lib}.log").write_text(b.log)
        if b.proc.returncode != 0:
            b.tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed on {b.name}.cu "
                          f"(exit {b.proc.returncode}):\n{b.log}")
        else:
            os.replace(b.tmp, b.lib)  # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("\n".join(failed))
    return {b.name: b.seconds for b in builds}


def build_library(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    return build_libraries([name])[0]


def load_library(name: str) -> ctypes.CDLL:
    """Build if needed, then load once per process."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(str(build_library(name)))
    return _LIBS[name]


def bind(name: str, launch_argtypes: list):
    """(launch, error_string) C functions of library ``name``: the entry
    point ``<name>_launch`` returning an int error code, and
    ``<name>_error_string`` mapping a code to its message.  Every pointer
    and the stream must be ``c_void_p`` in ``launch_argtypes``: ctypes
    passes a bare Python int as a 32-bit int and would cut them."""
    lib = load_library(name)
    launch = getattr(lib, f"{name}_launch")
    launch.argtypes = launch_argtypes
    launch.restype = ctypes.c_int
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return launch, err


_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def ptxas_entries(log: str) -> list[dict]:
    """Registers, stack frame and spills of each kernel (entry function)
    of a build, from its ``nvcc -Xptxas -v`` log: one dict a kernel with
    ``function`` (the mangled name), ``stack_bytes``,
    ``spill_store_bytes``, ``spill_load_bytes`` and ``registers``."""
    out, cur = [], None
    for line in log.splitlines():
        if m := _ENTRY.search(line):
            cur = dict(function=m.group(1))
            out.append(cur)
        elif cur is not None and (m := _FRAME.search(line)):
            cur.update(stack_bytes=int(m.group(1)),
                       spill_store_bytes=int(m.group(2)),
                       spill_load_bytes=int(m.group(3)))
        elif cur is not None and (m := _REGS.search(line)):
            cur.update(registers=int(m.group(1)))
    return out
