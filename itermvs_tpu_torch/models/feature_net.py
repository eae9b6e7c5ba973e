"""Multi-scale FPN feature extractor (counterpart of
itermvs_tpu/models/feature_net.py, standard stem).

Encoder: conv 3→8, then three 2-block residual stages 8→16→32→48 with
stride-2 entries. FPN decoder with 1×1 laterals and ×2 bilinear adds (K19
`upsample2x_add`, and K20 `upsample2x_grad` as its backward in training,
under the label `fpn_add`).
Outputs `level3` 48ch @ H/8, `level2` 32ch @ H/4, `level1` 16ch @ H/2,
NCHW, in the compute dtype `dtype` (the image is cast to it first, as
the JAX FeatureNet does). The reference's unused `inner3` lateral is not
built.
"""
from __future__ import annotations

import torch
import torch.nn as nn
from torch.profiler import record_function

from itermvs_tpu_torch.models.blocks import ConvBnReLU, ResidualBlock, conv
from itermvs_tpu_torch.ops.resize import upsample2x_add


class FeatureNet(nn.Module):
    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        dt = self.compute_dtype = dtype
        self.conv1 = ConvBnReLU(3, 8, dtype=dt)
        self.layer1 = nn.Sequential(ResidualBlock(8, 16, 2, dt), ResidualBlock(16, 16, dtype=dt))
        self.layer2 = nn.Sequential(ResidualBlock(16, 32, 2, dt), ResidualBlock(32, 32, dtype=dt))
        self.layer3 = nn.Sequential(ResidualBlock(32, 48, 2, dt), ResidualBlock(48, 48, dtype=dt))
        self.output1 = conv(48, 16, dtype=dt)
        self.output2 = conv(48, 32, dtype=dt)
        self.output3 = conv(48, 48, dtype=dt)
        self.inner1 = conv(16, 48, 1, pad=0, dtype=dt)
        self.inner2 = conv(32, 48, 1, pad=0, dtype=dt)

    def forward(self, x):
        """x: [N, 3, H, W] float in [-1, 1] → dict level1/2/3, NCHW."""
        x = x.to(self.compute_dtype)
        fea1 = self.layer1(self.conv1(x))
        fea2 = self.layer2(fea1)
        fea3 = self.layer3(fea2)
        level3 = self.output3(fea3)
        lateral = self.inner2(fea2)
        with record_function("fpn_add"):
            intra = upsample2x_add(fea3, lateral)
        level2 = self.output2(intra)
        lateral = self.inner1(fea1)
        with record_function("fpn_add"):
            intra = upsample2x_add(intra, lateral)
        level1 = self.output1(intra)
        return {"level1": level1, "level2": level2, "level3": level3}
