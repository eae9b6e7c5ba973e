"""Kernel K1, `corr_epilogue`: corner sum + group mean of a premultiplied
plane-sweep block.

Counterpart of itermvs_tpu/ops/sweep_epilogue.py, with its signature and
layout: `premul [P, 4C]` (rows sample-major, corners k-major inside a
row, as `sweep_premul` writes them) → `[G, n, HW]` float32, the group
mean accumulated in f32. On a CUDA tensor the wrapper launches the
hand-written kernel (csrc/corr_epilogue.cu) or raises; only a CPU tensor
takes the plain PyTorch version beside it.
"""
from __future__ import annotations

import torch

from itermvs_tpu_torch import kernels


def corr_epilogue_plain(premul: torch.Tensor, n: int, groups: int) -> torch.Tensor:
    """Plain PyTorch version: the JAX oracle's math
    (`corr_epilogue_reference`): corner sum, then per-group channel mean."""
    p, c4 = premul.shape
    c = c4 // 4
    s = premul.reshape(n, p // n, 4, c).float().sum(dim=2)
    corr = s.reshape(n, p // n, groups, c // groups).mean(dim=-1)
    return corr.permute(2, 0, 1).contiguous()               # [G, n, HW]


def corr_epilogue(premul: torch.Tensor, n: int, groups: int) -> torch.Tensor:
    """Fused corner sum + group mean.

    Args:
      premul: [n*HW, 4C] float32, contiguous (from `sweep_premul`).
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
    if premul.dtype != torch.float32 or not premul.is_contiguous():
        raise ValueError("corr_epilogue: premul must be contiguous float32")
    if not 0 < groups <= 32:
        raise ValueError(f"corr_epilogue: groups must be in 1..32, got {groups}")
    out = torch.empty((groups, n, p // n), dtype=torch.float32,
                      device=premul.device)
    fn = kernels.function("corr_epilogue")
    with torch.cuda.device(premul.device):
        stream = torch.cuda.current_stream().cuda_stream
        kernels.check_launch("corr_epilogue", fn(
            premul.data_ptr(), out.data_ptr(), p, c, groups, stream))
    corr_epilogue.launches += 1
    return out


corr_epilogue.launches = 0
