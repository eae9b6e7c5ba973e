"""Kernel K1, `corr_epilogue`: corner sum + group mean of a premultiplied
plane-sweep block.

Counterpart of itermvs_tpu/ops/sweep_epilogue.py, with its signature and
layout: `premul [P, 4C]` (rows sample-major, corners k-major inside a
row, as `sweep_premul` writes them) → `[G, n, HW]` float32, the group
mean accumulated in f32 whether premul is float32 or bfloat16 (the JAX
bf16 mode's `jnp.mean(..., dtype=float32)`). On a CUDA tensor the wrapper
launches the hand-written kernel of premul's dtype (csrc/corr_epilogue.cu,
csrc/corr_epilogue_bf16.cu) or raises; only a CPU tensor takes the plain
PyTorch version beside it.
"""
from __future__ import annotations

import math

import torch

from itermvs_tpu_torch import kernels

KERNELS = {torch.float32: "corr_epilogue", torch.bfloat16: "corr_epilogue_bf16"}
# The bfloat16 kernel's threads own lcm(8, cg) channels of a row: whole
# 16-byte vectors and whole groups, at most 4 vectors a corner.
BF16_SPAN = 32


def corr_epilogue_plain(premul: torch.Tensor, n: int, groups: int) -> torch.Tensor:
    """Plain PyTorch version: the JAX oracle's math
    (`corr_epilogue_reference`): corner sum, then per-group channel mean."""
    p, c4 = premul.shape
    c = c4 // 4
    # f32 accumulation (f64 stays f64, for gradcheck).
    s = premul.reshape(n, p // n, 4, c).to(
        torch.promote_types(premul.dtype, torch.float32)).sum(dim=2)
    corr = s.reshape(n, p // n, groups, c // groups).mean(dim=-1)
    return corr.permute(2, 0, 1).contiguous()               # [G, n, HW]


def check_kernel_input(premul: torch.Tensor, groups: int) -> None:
    """Raise ValueError where the kernel of premul's dtype does not take
    `premul` [P, 4C] with `groups` groups (its device aside)."""
    c = premul.shape[1] // 4
    if premul.dtype not in KERNELS or not premul.is_contiguous():
        raise ValueError("corr_epilogue: premul must be contiguous float32 or bfloat16")
    if not 0 < groups <= 32:
        raise ValueError(f"corr_epilogue: groups must be in 1..32, got {groups}")
    if premul.dtype == torch.bfloat16 and (
            c % 8 or math.lcm(8, c // groups) > BF16_SPAN or premul.data_ptr() % 16):
        raise ValueError(f"corr_epilogue: bfloat16 premul needs C % 8 == 0, lcm(8, C/G) "
                         f"<= {BF16_SPAN} and 16-byte alignment, got C={c}, G={groups}")


def launch_corr_epilogue(premul, out) -> None:
    """K1's bare launch (the kernel of premul's dtype) into `out` [G, ...]
    float32 on the current stream, for checked inputs; counts nothing (the
    wrapper does)."""
    p, c4 = premul.shape
    name = KERNELS[premul.dtype]
    kernels.check_launch(name, kernels.function(name)(
        premul.data_ptr(), out.data_ptr(), p, c4 // 4, out.shape[0],
        torch.cuda.current_stream().cuda_stream))


def corr_epilogue(premul: torch.Tensor, n: int, groups: int) -> torch.Tensor:
    """Fused corner sum + group mean.

    Args:
      premul: [n*HW, 4C] float32 or bfloat16, contiguous (from
        `sweep_premul`; bfloat16 16-byte aligned, C % 8 == 0 and
        lcm(8, C/G) <= 32: C = 16, 32, 48 at G = 8).
      n: sample count (rows are sample-major).
      groups: correlation group count G (C must divide; G <= 32).

    Returns [G, n, HW] float32.
    """
    if premul.ndim != 2 or premul.shape[1] % 4:
        raise ValueError(f"premul must be [P, 4C], got {tuple(premul.shape)}")
    p, c4 = premul.shape
    c = c4 // 4
    if p % n or c % groups:
        raise ValueError(f"P={p} not divisible by n={n} or C={c} by G={groups}")
    if premul.device.type == "cpu":
        return corr_epilogue_plain(premul, n, groups)
    if premul.device.type != "cuda":
        raise ValueError(f"corr_epilogue: unsupported device {premul.device}")
    check_kernel_input(premul, groups)
    out = torch.empty((groups, n, p // n), dtype=torch.float32,
                      device=premul.device)
    with torch.cuda.device(premul.device):
        launch_corr_epilogue(premul, out)
    if premul.dtype == torch.float32:
        corr_epilogue.launches += 1
    else:
        corr_epilogue.launches_bf16 += 1
    return out


# Launches of the float32 and the bfloat16 kernel.
corr_epilogue.launches = 0
corr_epilogue.launches_bf16 = 0
