"""Build, load and bind the port's hand-written CUDA kernels.

Each source `itermvs_tpu_torch/csrc/<name>.cu` is compiled by `nvcc` for
Hopper (`sm_90a`) into its own shared library with a plain C interface,
loaded with `ctypes` (pointers and the stream pass as `c_void_p`). A
kernel is named by its source, or, where one templated source exports
both dtype forms, its bfloat16 form is `<name>_bf16` in the library of
`<name>` (`SIGNATURES` gives the source). The
libraries go to `itermvs_tpu_torch/_build/` under a name that carries a
hash of the source, the shared headers (`csrc/*.cuh`) and the flags, so
an edited source or header is rebuilt. Every
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
SOURCES = ("corr_epilogue", "sweep_premul", "fusion_consistency", "sweep_grad_ref",
           "sweep_grad_src", "corr_epilogue_bf16", "sweep_premul_bf16",
           "sweep_grad_ref_bf16", "sweep_grad_src_bf16", "depth_readout",
           "depth_readout_grad", "sweep_taps", "convex_upsample", "convex_upsample_grad",
           "view_aggregate", "view_aggregate_grad", "gru_reset", "gru_update",
           "gru_update_grad", "gru_reset_grad", "bn_act", "bn_act_grad", "upsample2x_add",
           "upsample2x_grad", "bn_stats", "bn_stats_grad", "full_loss", "full_loss_grad",
           "grad_norm", "clip_adam", "depth_metrics", "resize_bilinear",
           "resize_bilinear_grad", "view_weight", "view_weight_grad", "init_depth",
           "init_depth_grad")
# No --use_fast_math: fusion_consistency needs IEEE divides and sqrt.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# C signatures of the exported launchers: kernel -> (symbol, argtypes[,
# source]); every launcher returns an int (cudaGetLastError()).
_P, _I, _L, _F, _D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float,
                      ctypes.c_double)
SIGNATURES = {
    "corr_epilogue": ("itermvs_corr_epilogue", (_P, _P, _L, _I, _I, _P)),
    "sweep_premul": ("itermvs_sweep_premul",
                     (_P, _P, _P, _P, _P, _I, _L, _I, _I, _I, _I, _P)),
    "fusion_consistency": ("itermvs_fusion_consistency",
                           (_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _I, _P)),
    "sweep_grad_ref": ("itermvs_sweep_grad_ref",
                       (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P)),
    "sweep_grad_src": ("itermvs_sweep_grad_src",
                       (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P)),
    "corr_epilogue_bf16": ("itermvs_corr_epilogue_bf16", (_P, _P, _L, _I, _I, _P)),
    "sweep_premul_bf16": ("itermvs_sweep_premul_bf16",
                          (_P, _P, _P, _P, _P, _I, _L, _I, _I, _I, _I, _P)),
    "sweep_grad_ref_bf16": ("itermvs_sweep_grad_ref_bf16",
                            (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P)),
    "sweep_grad_src_bf16": ("itermvs_sweep_grad_src_bf16",
                            (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P)),
    "depth_readout": ("itermvs_depth_readout", (_P, _P, _P, _P, _P, _P, _I, _I, _P)),
    "depth_readout_bf16": ("itermvs_depth_readout_bf16",
                           (_P, _P, _P, _P, _P, _P, _I, _I, _P), "depth_readout"),
    "depth_readout_grad": ("itermvs_depth_readout_grad",
                           (_P, _P, _P, _P, _P, _P, _P, _I, _I, _L, _L, _L, _P)),
    "depth_readout_grad_bf16": ("itermvs_depth_readout_grad_bf16",
                                (_P, _P, _P, _P, _P, _P, _P, _I, _I, _L, _L, _L, _P),
                                "depth_readout_grad"),
    "sweep_taps": ("itermvs_sweep_taps",
                   (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _L, _L, _L, _L, _P)),
    "sweep_taps_bf16": ("itermvs_sweep_taps_bf16",
                        (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _L, _L, _L, _L, _P),
                        "sweep_taps"),
    "convex_upsample": ("itermvs_convex_upsample", (_P, _P, _P, _I, _I, _I, _P)),
    "convex_upsample_bf16": ("itermvs_convex_upsample_bf16", (_P, _P, _P, _I, _I, _I, _P),
                             "convex_upsample"),
    "convex_upsample_grad": ("itermvs_convex_upsample_grad",
                             (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P)),
    "convex_upsample_grad_bf16": ("itermvs_convex_upsample_grad_bf16",
                                  (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
                                  "convex_upsample_grad"),
    "view_aggregate": ("itermvs_view_aggregate", (_P, _I, _P, _P, _I, _I, _I, _L, _P)),
    "view_aggregate_grad": ("itermvs_view_aggregate_grad",
                            (_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _L, _P)),
    "gru_reset": ("itermvs_gru_reset", (_P, _P, _P, _I, _I, _I, _I, _P)),
    "gru_reset_bf16": ("itermvs_gru_reset_bf16", (_P, _P, _P, _I, _I, _I, _I, _P),
                       "gru_reset"),
    "gru_update": ("itermvs_gru_update", (_P, _P, _P, _P, _L, _P)),
    "gru_update_bf16": ("itermvs_gru_update_bf16", (_P, _P, _P, _P, _L, _P), "gru_update"),
    "gru_update_grad": ("itermvs_gru_update_grad", (_P, _P, _P, _P, _P, _P, _P, _L, _P)),
    "gru_update_grad_bf16": ("itermvs_gru_update_grad_bf16",
                             (_P, _P, _P, _P, _P, _P, _P, _L, _P), "gru_update_grad"),
    "gru_reset_grad": ("itermvs_gru_reset_grad", (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P)),
    "gru_reset_grad_bf16": ("itermvs_gru_reset_grad_bf16",
                            (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P), "gru_reset_grad"),
    "bn_act": ("itermvs_bn_act", (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _L, _I,
                                  _I, _P)),
    "bn_act_bf16": ("itermvs_bn_act_bf16", (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                            _L, _I, _I, _P), "bn_act"),
    "bn_act_grad": ("itermvs_bn_act_grad", (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                            _P, _I, _I, _L, _I, _I, _I, _P)),
    "bn_act_grad_bf16": ("itermvs_bn_act_grad_bf16",
                         (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _L,
                          _I, _I, _I, _P), "bn_act_grad"),
    "upsample2x_add": ("itermvs_upsample2x_add", (_P, _P, _P, _L, _I, _I, _P)),
    "upsample2x_add_bf16": ("itermvs_upsample2x_add_bf16", (_P, _P, _P, _L, _I, _I, _P),
                            "upsample2x_add"),
    "upsample2x_grad": ("itermvs_upsample2x_grad", (_P, _P, _L, _I, _I, _P)),
    "upsample2x_grad_bf16": ("itermvs_upsample2x_grad_bf16", (_P, _P, _L, _I, _I, _P),
                             "upsample2x_grad"),
    "bn_stats": ("itermvs_bn_stats", (_P, _P, _I, _P, _I, _I, _L, _I, _D, _P)),
    "bn_stats_bf16": ("itermvs_bn_stats_bf16", (_P, _P, _I, _P, _I, _I, _L, _I, _D, _P),
                      "bn_stats"),
    "bn_stats_grad": ("itermvs_bn_stats_grad", (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _F, _I,
                                                _I, _L, _P)),
    "bn_stats_grad_bf16": ("itermvs_bn_stats_grad_bf16",
                           (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _F, _I, _I, _L, _P),
                           "bn_stats_grad"),
    "full_loss": ("itermvs_full_loss", (_P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                        _L, _L, _P, _P, _P, _P, _P, _P)),
    "full_loss_grad": ("itermvs_full_loss_grad",
                       (_P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _L, _L, _P, _P, _P,
                        _P, _P, _P, _P, _P, _P)),
    "grad_norm": ("itermvs_grad_norm", (_P, _I, _P, _I, _P, _P)),
    "clip_adam": ("itermvs_clip_adam", (_P, _I, _P, *(_F,) * 10, _P)),
    "depth_metrics": ("itermvs_depth_metrics",
                      (_P, _I, *(_P,) * 5, _I, _L, _L, _P, _L, _P, _P, _P)),
    "resize_bilinear": ("itermvs_resize_bilinear",
                        (_P, _P, _L, _I, _L, _I, _I, _I, _I, _I, _P)),
    "resize_bilinear_bf16": ("itermvs_resize_bilinear_bf16",
                             (_P, _P, _L, _I, _L, _I, _I, _I, _I, _I, _P), "resize_bilinear"),
    "resize_bilinear_grad": ("itermvs_resize_bilinear_grad",
                             (_P, _P, _P, _L, _I, _I, _I, _I, _P)),
    "resize_bilinear_grad_bf16": ("itermvs_resize_bilinear_grad_bf16",
                                  (_P, _P, _P, _L, _I, _I, _I, _I, _P),
                                  "resize_bilinear_grad"),
    "view_weight": ("itermvs_view_weight", (_P, _P, _P, _L, _I, _I, _P)),
    "view_weight_bf16": ("itermvs_view_weight_bf16", (_P, _P, _P, _L, _I, _I, _P),
                         "view_weight"),
    "view_weight_grad": ("itermvs_view_weight_grad", (_P, _P, _P, _L, _I, _I, _P)),
    "view_weight_grad_bf16": ("itermvs_view_weight_grad_bf16", (_P, _P, _P, _L, _I, _I, _P),
                              "view_weight_grad"),
    "init_depth": ("itermvs_init_depth", (_P, _P, _P, _P, _L, _I, _I, _P)),
    "init_depth_grad": ("itermvs_init_depth_grad", (_P, _P, _P, _P, _P, _L, _I, _I, _P)),
    # Not a kernel: 1 where K10's kernels are programmatic dependent launches.
    "convex_upsample_grad_programmatic": ("itermvs_convex_upsample_grad_programmatic", (),
                                          "convex_upsample_grad"),
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
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for source in (f"{name}.cu", *headers):
        with open(os.path.join(CSRC_DIR, source), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


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
    """The bound C launcher of kernel `name`, building its source if
    needed."""
    with _lock:
        fn = _functions.get(name)
        if fn is None:
            symbol, argtypes, *source = SIGNATURES[name]
            source = source[0] if source else name
            build_all((source,))
            fn = getattr(ctypes.CDLL(library_path(source)), symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _functions[name] = fn
        return fn


def check_launch(name: str, status: int) -> None:
    """Raise if a launcher returned a non-zero cudaGetLastError()."""
    if status != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {status}")
