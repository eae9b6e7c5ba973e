"""Bilinear resizing, NCHW (counterpart of itermvs_tpu/ops/resize.py).

The JAX package's half-pixel bilinear resize with an edge-clamped upper
neighbour (`src = max((dst + 0.5)·in/out − 0.5, 0)`) is exactly
`F.interpolate(mode="bilinear", align_corners=False)` given an output
size, which computes the scale as in/out.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of [N, C, H, W] maps to (H_out, W_out)."""
    if tuple(x.shape[-2:]) == tuple(out_hw):
        return x
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                         align_corners=False)


def upsample_bilinear(x: torch.Tensor, scale: int) -> torch.Tensor:
    """×scale bilinear upsample of [N, C, H, W] maps."""
    return resize_bilinear(x, (x.shape[-2] * scale, x.shape[-1] * scale))
