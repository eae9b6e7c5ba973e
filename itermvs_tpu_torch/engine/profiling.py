"""Tracing / profiling hooks (counterpart of itermvs_tpu/engine/profiling.py).

Usage:
    with trace("/tmp/tb"):          # torch.profiler trace for TensorBoard
        step(...)

    timer = StepTimer()
    with timer.measure():
        step(...)
    print(timer.summary())

    with maybe_enable_nan_debugging(model, args.debug_nans):
        run(...)                    # raises at the first NaN

`--debug_nans` (or ITERMVS_DEBUG_NANS=1) is the JAX package's
`jax_debug_nans`, which aborts at the first NaN any operation produces,
in two parts: a forward hook on every submodule raises
`FloatingPointError` naming the module whose output holds a NaN, and
autograd's anomaly mode raises at the first backward function that
returns one, naming it and the forward call that made it.
"""
from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch


def _has_nan(value) -> bool:
    if isinstance(value, torch.Tensor):
        return value.is_floating_point() and bool(torch.isnan(value).any())
    if isinstance(value, dict):
        return any(_has_nan(v) for v in value.values())
    if isinstance(value, (list, tuple)):
        return any(_has_nan(v) for v in value)
    return False


def _nan_hook(name):
    def hook(module, inputs, output):
        if _has_nan(output):
            raise FloatingPointError(
                f"NaN in the output of module {name or '<root>'} "
                f"({type(module).__name__})")
    return hook


@contextlib.contextmanager
def maybe_enable_nan_debugging(model: torch.nn.Module, enabled: bool = False):
    """Within the block, stop at the first NaN `model` produces, forward or
    backward, when `enabled` or ITERMVS_DEBUG_NANS=1; otherwise do
    nothing. Each check reads a flag back from the device, so this is a
    debugging mode, not a fast one."""
    if not (enabled or os.environ.get("ITERMVS_DEBUG_NANS") == "1"):
        yield
        return
    handles = [m.register_forward_hook(_nan_hook(name))
               for name, m in model.named_modules()]
    try:
        with torch.autograd.detect_anomaly(check_nan=True):
            yield
    finally:
        for h in handles:
            h.remove()


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler trace of the block (host and device), written to
    `logdir` for TensorBoard's profile plugin."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


class StepTimer:
    """Wall-clock step-time meter with percentile summary."""

    def __init__(self):
        self.times: list[float] = []

    @contextlib.contextmanager
    def measure(self):
        start = time.perf_counter()
        yield
        self.times.append(time.perf_counter() - start)

    def summary(self, skip_warmup: int = 1) -> dict:
        t = np.asarray(self.times[skip_warmup:] or self.times)
        return {
            "steps": len(t),
            "mean_s": float(t.mean()),
            "p50_s": float(np.percentile(t, 50)),
            "p90_s": float(np.percentile(t, 90)),
            "steps_per_sec": float(1.0 / t.mean()) if t.mean() > 0 else 0.0,
        }
