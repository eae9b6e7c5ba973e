"""Multi-scale FPN feature extractor (counterpart of
itermvs_tpu/models/feature_net.py, standard stem).

Encoder: conv 3→8, then three 2-block residual stages 8→16→32→48 with
stride-2 entries. FPN decoder with 1×1 laterals and ×2 bilinear adds.
Outputs `level3` 48ch @ H/8, `level2` 32ch @ H/4, `level1` 16ch @ H/2,
NCHW. The reference's unused `inner3` lateral is not built.
"""
from __future__ import annotations

import torch.nn as nn

from itermvs_tpu_torch.models.blocks import ConvBnReLU, ResidualBlock, conv
from itermvs_tpu_torch.ops.resize import upsample_bilinear


class FeatureNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = ConvBnReLU(3, 8)
        self.layer1 = nn.Sequential(ResidualBlock(8, 16, 2), ResidualBlock(16, 16))
        self.layer2 = nn.Sequential(ResidualBlock(16, 32, 2), ResidualBlock(32, 32))
        self.layer3 = nn.Sequential(ResidualBlock(32, 48, 2), ResidualBlock(48, 48))
        self.output1 = conv(48, 16)
        self.output2 = conv(48, 32)
        self.output3 = conv(48, 48)
        self.inner1 = conv(16, 48, 1, pad=0)
        self.inner2 = conv(32, 48, 1, pad=0)

    def forward(self, x):
        """x: [N, 3, H, W] float in [-1, 1] → dict level1/2/3, NCHW."""
        fea1 = self.layer1(self.conv1(x))
        fea2 = self.layer2(fea1)
        fea3 = self.layer3(fea2)
        level3 = self.output3(fea3)
        intra = upsample_bilinear(fea3, 2) + self.inner2(fea2)
        level2 = self.output2(intra)
        intra = upsample_bilinear(intra, 2) + self.inner1(fea1)
        level1 = self.output1(intra)
        return {"level1": level1, "level2": level2, "level3": level3}
