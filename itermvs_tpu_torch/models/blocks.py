"""NN building blocks, NCHW (counterpart of itermvs_tpu/models/blocks.py).

Convolutions are `nn.Conv2d` / `nn.ConvTranspose2d` (cuDNN on the card),
BN is `BatchNorm`, an `nn.BatchNorm2d` (eps 1e-5) whose train mode keeps
the JAX package's (flax's) running statistics. Module and
parameter names follow the reference's torch state_dict (e.g.
`conv1.conv.weight`, `conv1.bn.running_mean`), which `weights.py` fills
from the vendored flax checkpoint.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def conv(cin: int, cout: int, kernel: int = 3, stride: int = 1, pad: int = 1,
         dilation: int = 1, bias: bool = True) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel, stride=stride, padding=pad,
                     dilation=dilation, bias=bias)


def conv_transpose(cin: int, cout: int) -> nn.ConvTranspose2d:
    """k3, stride 2, pad 1, output_padding 1, no bias: ×2 exactly."""
    return nn.ConvTranspose2d(cin, cout, 3, stride=2, padding=1,
                              output_padding=1, bias=False)


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d with flax's statistics (itermvs_tpu/models/blocks.py
    `BatchNorm`: momentum 0.9, eps 1e-5). Both normalize a training batch
    with its biased variance, but torch moves `running_var` towards the
    unbiased one (n/(n-1) larger); flax, and so this module, towards the
    biased one: running = 0.9·running + 0.1·batch for mean and variance.
    Eval mode is `nn.BatchNorm2d`'s."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            self.running_mean.mul_(0.9).add_(0.1 * mean)
            self.running_var.mul_(0.9).add_(0.1 * var)
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


class ConvBn(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 pad: int = 1):
        super().__init__()
        self.conv = conv(cin, cout, kernel, stride, pad, bias=False)
        self.bn = BatchNorm(cout)

    def forward(self, x):
        return self.bn(self.conv(x))


class ConvBnReLU(ConvBn):
    def forward(self, x):
        return torch.relu(super().forward(x))


class ConvReLU(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 pad: int = 1):
        super().__init__()
        self.conv = conv(cin, cout, kernel, stride, pad, bias=False)

    def forward(self, x):
        return torch.relu(self.conv(x))


class ResidualBlock(nn.Module):
    """ConvBnReLU → ConvBn, plus a strided ConvBn skip when stride != 1."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = ConvBnReLU(cin, cout, stride=stride)
        self.conv2 = ConvBn(cout, cout)
        self.downsample = ConvBn(cin, cout, stride=stride) if stride != 1 else None

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        if self.downsample is not None:
            x = self.downsample(x)
        return torch.relu(x + y)


class ConvGRU(nn.Module):
    """Convolutional GRU with 3×3 dilation-2 gates."""

    def __init__(self, hidden_dim: int, input_dim: int):
        super().__init__()
        cin = hidden_dim + input_dim
        self.convz = conv(cin, hidden_dim, 3, pad=2, dilation=2)
        self.convr = conv(cin, hidden_dim, 3, pad=2, dilation=2)
        self.convq = conv(cin, hidden_dim, 3, pad=2, dilation=2)

    def forward(self, h, x):
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(self.convz(hx))
        r = torch.sigmoid(self.convr(hx))
        q = torch.tanh(self.convq(torch.cat([r * h, x], dim=1)))
        return (1.0 - z) * h + z * q
