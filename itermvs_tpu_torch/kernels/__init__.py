"""Build, load and bind the port's hand-written CUDA kernels.

Each source `itermvs_tpu_torch/csrc/<name>.cu` is compiled by `nvcc` for
Hopper (`sm_90a`) into its own shared library with a plain C interface,
loaded with `ctypes` (pointers and the stream pass as `c_void_p`). The
libraries go to `itermvs_tpu_torch/_build/` under a name that carries a
hash of the source and flags, so an edited source is rebuilt. Every
missing library is built at once, one `nvcc` per source, all started
together. Nothing is built at import: the first call of a kernel's
wrapper builds it, and `build_all` does so up front.

There is no fallback here: a missing `nvcc` or a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
SOURCES = ("corr_epilogue", "sweep_premul", "fusion_consistency")
# No --use_fast_math: fusion_consistency needs IEEE divides and sqrt.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# C signatures of the exported launchers (symbol -> (argtypes, restype)).
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
SIGNATURES = {
    "corr_epilogue": ("itermvs_corr_epilogue", (_P, _P, _L, _I, _I, _P)),
    "sweep_premul": ("itermvs_sweep_premul",
                     (_P, _P, _P, _P, _P, _I, _L, _I, _I, _I, _I, _P)),
    "fusion_consistency": ("itermvs_fusion_consistency",
                           (_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _I, _P)),
}

_lock = threading.Lock()
_functions: dict = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda, or PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                           "kernels are built from source at first use")
    return found


def library_path(name: str) -> str:
    with open(os.path.join(CSRC_DIR, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()
                                ).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def build_all(names=SOURCES) -> float:
    """Compile every library in `names` that is not built yet, all in
    parallel. Returns the wall seconds spent; raises on any failure with
    the compiler's output. The ptxas report (registers, shared memory,
    spills) is kept beside each library as `<lib>.log`."""
    start = time.perf_counter()
    todo = [n for n in names if not os.path.exists(library_path(n))]
    if not todo:
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    for name in todo:
        out = library_path(name)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failures = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        with open(f"{out}.log", "w") as f:
            f.write(log)
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return time.perf_counter() - start


def function(name: str):
    """The bound C launcher of kernel `name`, building it if needed."""
    with _lock:
        fn = _functions.get(name)
        if fn is None:
            build_all((name,))
            symbol, argtypes = SIGNATURES[name]
            fn = getattr(ctypes.CDLL(library_path(name)), symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _functions[name] = fn
        return fn


def check_launch(name: str, status: int) -> None:
    """Raise if a launcher returned a non-zero cudaGetLastError()."""
    if status != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {status}")
