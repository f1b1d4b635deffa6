#!/usr/bin/env python3
"""SASS instructions of a CUDA kernel, counted by the source line they come
from.

    python3 scripts/torch_sass_lines.py SOURCE.cu FUNCTION_REGEX
        [--range NAME=FIRST-LAST ...] [--dump DIR]

Compiles ``SOURCE.cu`` to a cubin for ``sm_90a`` with the port's flags
(``kernels/build.py``) and ``-lineinfo``, disassembles it with ``nvdisasm``
and, for every kernel whose mangled name matches ``FUNCTION_REGEX``, counts
its instructions by the line of ``SOURCE.cu`` each one belongs to.  An
instruction of an inlined function counts at its outermost call site in
``SOURCE.cu``, so a helper such as a predicated add counts where the kernel
calls it.  Each ``--range`` sums the lines ``FIRST`` to ``LAST`` under
``NAME``.  Prints one JSON object: per function the total, the ranges and
the per-line counts.  ``--dump DIR`` writes each matching function's
annotated disassembly there.  Needs ``nvcc`` and ``nvdisasm`` (the CUDA
toolkit), no GPU.

The event loops of the fleet sweeps are fully unrolled over a thread's
servers, so the instructions of a branch of the event loop are those one
event of that kind issues (less what predication skips).
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

_FUNC = re.compile(r"^\s*\.text\.(\S+?):\s*$")
_LINE = re.compile(r'//## File "([^"]+)", line (\d+)(.*)$')
_INLINED = re.compile(r'inlined at "([^"]+)", line (\d+)')
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:\{\s*)?(?:@!?U?P[T0-9]+\s+)?"
                   r"([A-Z][A-Z0-9_.]*)")


def disassemble(source: str, out_dir: str) -> str:
    """The ``nvdisasm`` text, with line and inlining info, of ``source``
    compiled to a cubin under ``out_dir``."""
    from repro_torch.kernels.build import NVCC_FLAGS, find_nvcc
    nvcc = find_nvcc()
    os.makedirs(out_dir, exist_ok=True)
    cubin = os.path.join(out_dir, os.path.basename(source) + ".cubin")
    flags = [f for f in NVCC_FLAGS if f not in ("-shared", "-Xcompiler",
                                                 "-fPIC", "-Xptxas", "-v")]
    subprocess.run([nvcc, *flags, "-lineinfo", "-cubin", "-o", cubin,
                    source], check=True, timeout=900)
    tool = os.path.join(os.path.dirname(nvcc), "nvdisasm")
    for info in ("-gi", "-g"):     # -gi adds the inlining chain
        proc = subprocess.run([tool, "-c", info, cubin], capture_output=True,
                              text=True, timeout=600)
        if proc.returncode == 0:
            return proc.stdout
    proc.check_returncode()
    return ""


def count_lines(text: str, source: str, pattern: str):
    """({function: {line: instructions}}, {function: listing}) for the
    functions matching ``pattern``; an instruction counts at the outermost
    line of ``source`` in its line info (0: none)."""
    base = os.path.basename(source)
    out, listing, func, line = {}, {}, None, 0
    for raw in text.splitlines():
        if m := _FUNC.match(raw):
            func = m.group(1) if re.search(pattern, m.group(1)) else None
            line = 0
            if func is not None:
                out[func], listing[func] = {}, []
            continue
        if func is None:
            continue
        listing[func].append(raw)
        if m := _LINE.search(raw):
            sites = [(m.group(1), int(m.group(2)))]
            sites += [(f, int(n)) for f, n in _INLINED.findall(m.group(3))]
            mine = [n for f, n in sites if os.path.basename(f) == base]
            line = mine[-1] if mine else 0
            continue
        if _INSN.search(raw):
            out[func][line] = out[func].get(line, 0) + 1
    return out, listing


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("source")
    ap.add_argument("function")
    ap.add_argument("--range", action="append", default=[],
                    help="NAME=FIRST-LAST: lines summed under NAME")
    ap.add_argument("--dump", help="directory for each function's listing")
    args = ap.parse_args(argv)
    ranges = {}
    for r in args.range:
        name, _, span = r.partition("=")
        lo, _, hi = span.partition("-")
        ranges[name] = (int(lo), int(hi or lo))
    out_dir = os.path.join(ROOT, "build", "sass")
    text = disassemble(args.source, out_dir)
    counts, listing = count_lines(text, args.source, args.function)
    if not counts:
        sys.stderr.write("\n".join(text.splitlines()[:80]) + "\n")
        raise SystemExit(f"no function matches {args.function!r}")
    res = {}
    for func, by_line in counts.items():
        res[func] = dict(
            instructions=sum(by_line.values()),
            ranges={name: sum(n for ln, n in by_line.items()
                              if lo <= ln <= hi)
                    for name, (lo, hi) in ranges.items()},
            by_line={str(k): v for k, v in sorted(by_line.items())})
    if args.dump:
        os.makedirs(args.dump, exist_ok=True)
        for func, lines in listing.items():
            short = re.search(r"([a-z_]+kernelI\w*?)EEv", func)
            name = short.group(1) if short else func[:80]
            with open(os.path.join(args.dump, f"{name}.sass"), "w") as f:
                f.write("\n".join(lines) + "\n")
    print(json.dumps(dict(source=os.path.relpath(args.source, ROOT),
                          pattern=args.function, functions=res)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
