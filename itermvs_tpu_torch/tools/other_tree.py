"""Build a kernel source of another checkout of the port in this one and
bind its launchers, for the tools that time two versions of a kernel in
one process (`time_readout.py`, `time_sweep_taps.py`, `time_upsample.py`).

The other checkout's `itermvs_tpu_torch/csrc/<source>.cu` is compiled
with this checkout's nvcc flags into this checkout's
`itermvs_tpu_torch/_build/`, under a name that carries a hash of the
source, the other checkout's shared headers and the flags. Needs nvcc
(the card's machine).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess

from itermvs_tpu_torch import kernels


def source_path(tree: str, source: str) -> str:
    return os.path.join(tree, "itermvs_tpu_torch", "csrc", f"{source}.cu")


def library(tree: str, source: str) -> str:
    """The shared library of `tree`'s `source`.cu, built here if needed;
    its name hashes the source, the tree's shared headers (`csrc/*.cuh`)
    and the flags. The ptxas report is kept beside it as `<lib>.log`."""
    path = source_path(tree, source)
    csrc = os.path.dirname(path)
    digest = hashlib.sha256(" ".join(kernels.NVCC_FLAGS).encode())
    for name in (f"{source}.cu", *sorted(f for f in os.listdir(csrc) if f.endswith(".cuh"))):
        with open(os.path.join(csrc, name), "rb") as f:
            digest.update(f.read())
    lib = os.path.join(kernels.BUILD_DIR, f"lib{source}_other-{digest.hexdigest()[:16]}.so")
    if not os.path.exists(lib):
        os.makedirs(kernels.BUILD_DIR, exist_ok=True)
        out = subprocess.run([kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o", lib, path],
                             capture_output=True, text=True)
        if out.returncode != 0:
            raise SystemExit(f"nvcc failed for {path}:\n{out.stdout}{out.stderr}")
        with open(f"{lib}.log", "w") as f:
            f.write(out.stdout + out.stderr)
    return lib


def bind(lib: str, symbol: str, argtypes):
    fn = getattr(ctypes.CDLL(lib), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def query(lib: str, symbol: str) -> bool:
    """The value of a library's exported query `symbol` (an `int (void)`
    function), False where the library predates it."""
    fn = getattr(ctypes.CDLL(lib), symbol, None)
    return bool(fn()) if fn is not None else False


def launcher_arity(tree: str, source: str, symbol: str) -> int:
    """The number of parameters of `tree`'s exported launcher `symbol`."""
    with open(source_path(tree, source)) as f:
        text = f.read()
    found = re.search(r'extern "C" int ' + re.escape(symbol) + r"\((.*?)\)", text, re.S)
    if found is None:
        raise SystemExit(f"{symbol} not found in {source_path(tree, source)}")
    return found.group(1).count(",") + 1


def sass_instructions(lib: str) -> dict:
    """{kernel function (mangled): its SASS instruction count} of a
    library, from `cuobjdump -sass`."""
    cuobjdump = os.path.join(os.path.dirname(kernels.nvcc_path()), "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                         check=True).stdout
    counts, name = {}, None
    for line in out.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            name = head.group(1)
            counts[name] = 0
        elif name is not None and re.match(r"\s*/\*[0-9a-f]{4}\*/", line):
            counts[name] += 1
    return counts


def registers(lib: str) -> dict:
    """{kernel function (mangled): registers per thread} from the ptxas
    report kept beside a library (`<lib>.log`)."""
    counts, name = {}, None
    with open(f"{lib}.log") as f:
        for line in f:
            head = re.search(r"Compiling entry function '(\S+)'", line)
            used = re.search(r"Used (\d+) registers", line)
            if head:
                name = head.group(1)
            elif used and name is not None:
                counts[name] = int(used.group(1))
                name = None
    return counts
