"""Build a kernel source of another checkout of the port in this one and
bind its launchers, for the tools that time two versions of a kernel in
one process (`time_readout.py`, `time_sweep_taps.py`).

The other checkout's `itermvs_tpu_torch/csrc/<source>.cu` is compiled
with this checkout's nvcc flags into this checkout's
`itermvs_tpu_torch/_build/`, under a name that carries a hash of the
source and the flags. Needs nvcc (the card's machine).
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
    """The shared library of `tree`'s `source`.cu, built here if needed."""
    path = source_path(tree, source)
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(kernels.NVCC_FLAGS).encode())
    lib = os.path.join(kernels.BUILD_DIR, f"lib{source}_other-{digest.hexdigest()[:16]}.so")
    if not os.path.exists(lib):
        os.makedirs(kernels.BUILD_DIR, exist_ok=True)
        out = subprocess.run([kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o", lib, path],
                             capture_output=True, text=True)
        if out.returncode != 0:
            raise SystemExit(f"nvcc failed for {path}:\n{out.stdout}{out.stderr}")
    return lib


def bind(lib: str, symbol: str, argtypes):
    fn = getattr(ctypes.CDLL(lib), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


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
