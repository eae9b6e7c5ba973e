"""Convex-combination ×4 upsampling (counterpart of itermvs_tpu/ops/upsample.py).

Each output sub-pixel is a softmax-weighted combination of the 3×3
neighbourhood of its parent coarse pixel, with EDGE (replicate) padding
at the border — `F.unfold`'s zero padding would differ there.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def convex_upsample(x: torch.Tensor, weights: torch.Tensor, scale: int = 4
                    ) -> torch.Tensor:
    """Upsample [B, 1, H, W] to [B, 1, scale·H, scale·W].

    `weights`: [B, 9, scale, scale, H, W], convex over the 9 taps, tap
    order row-major over (dy, dx) ∈ {−1, 0, 1}².
    """
    b, c, h, w = x.shape
    if c != 1:
        raise ValueError("convex_upsample expects a single-channel map")
    padded = F.pad(x, (1, 1, 1, 1), mode="replicate")[:, 0]     # [B,H+2,W+2]
    taps = torch.stack([padded[:, dy:dy + h, dx:dx + w]
                        for dy in range(3) for dx in range(3)], dim=1)
    up = (taps[:, :, None, None] * weights).sum(dim=1)          # [B,s,s,H,W]
    return up.permute(0, 3, 1, 4, 2).reshape(b, 1, h * scale, w * scale)
