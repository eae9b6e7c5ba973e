"""NN building blocks, NCHW (counterpart of itermvs_tpu/models/blocks.py).

Convolutions are `Conv2d` / `ConvTranspose2d` (cuDNN on the card), BN is
`BatchNorm`, an `nn.BatchNorm2d` (eps 1e-5) whose train mode keeps the
JAX package's (flax's) running statistics. Module and parameter names
follow the reference's torch state_dict (e.g. `conv1.conv.weight`,
`conv1.bn.running_mean`), which `weights.py` fills from the vendored
flax checkpoint.

Every block takes a `dtype`, the compute dtype, as the JAX blocks do:
float32, or bfloat16. Parameters are float32 in both modes (the same
checkpoints); a convolution casts its input, weight and bias to the
compute dtype (flax's `nn.Conv(dtype=...)`), and BatchNorm computes its
statistics and normalisation in float32 and returns the compute dtype
(flax's `nn.BatchNorm(dtype=...)`). In float32 every cast is a no-op.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class Conv2d(nn.Conv2d):
    """`nn.Conv2d` computing in `compute_dtype`, its float32 parameters
    cast at the input (the cast's gradient reaches them in float32)."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    """`nn.ConvTranspose2d` computing in `compute_dtype` (see `Conv2d`)."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt), bias, self.stride,
                                  self.padding, self.output_padding, self.groups,
                                  self.dilation)


def conv(cin: int, cout: int, kernel: int = 3, stride: int = 1, pad: int = 1,
         dilation: int = 1, bias: bool = True, dtype: torch.dtype = torch.float32
         ) -> Conv2d:
    return Conv2d(cin, cout, kernel, stride=stride, padding=pad, dilation=dilation,
                  bias=bias, compute_dtype=dtype)


def conv_transpose(cin: int, cout: int, dtype: torch.dtype = torch.float32
                   ) -> ConvTranspose2d:
    """k3, stride 2, pad 1, output_padding 1, no bias: ×2 exactly."""
    return ConvTranspose2d(cin, cout, 3, stride=2, padding=1, output_padding=1,
                           bias=False, compute_dtype=dtype)


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d with flax's statistics (itermvs_tpu/models/blocks.py
    `BatchNorm`: momentum 0.9, eps 1e-5). Both normalize a training batch
    with its biased variance, but torch moves `running_var` towards the
    unbiased one (n/(n-1) larger); flax, and so this module, towards the
    biased one: running = 0.9·running + 0.1·batch for mean and variance.
    Eval mode is `nn.BatchNorm2d`'s. Statistics, their update and the
    normalisation run in float32 whatever the input's dtype; the output
    is `dtype`."""

    def __init__(self, num_features: int, dtype: torch.dtype = torch.float32):
        super().__init__(num_features, eps=1e-5, momentum=0.1)
        self.compute_dtype = dtype

    def forward(self, x):
        x = x.float()
        if not self.training:
            return super().forward(x).to(self.compute_dtype)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            self.running_mean.mul_(0.9).add_(0.1 * mean)
            self.running_var.mul_(0.9).add_(0.1 * var)
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps).to(self.compute_dtype)


class ConvBn(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 pad: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = conv(cin, cout, kernel, stride, pad, bias=False, dtype=dtype)
        self.bn = BatchNorm(cout, dtype)

    def forward(self, x):
        return self.bn(self.conv(x))


class ConvBnReLU(ConvBn):
    def forward(self, x):
        return torch.relu(super().forward(x))


class ConvReLU(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 pad: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = conv(cin, cout, kernel, stride, pad, bias=False, dtype=dtype)

    def forward(self, x):
        return torch.relu(self.conv(x))


class ResidualBlock(nn.Module):
    """ConvBnReLU → ConvBn, plus a strided ConvBn skip when stride != 1."""

    def __init__(self, cin: int, cout: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = ConvBnReLU(cin, cout, stride=stride, dtype=dtype)
        self.conv2 = ConvBn(cout, cout, dtype=dtype)
        self.downsample = (ConvBn(cin, cout, stride=stride, dtype=dtype)
                           if stride != 1 else None)

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        if self.downsample is not None:
            x = self.downsample(x)
        return torch.relu(x + y)


class ConvGRU(nn.Module):
    """Convolutional GRU with 3×3 dilation-2 gates. The input is cast to
    the hidden state's dtype, and the update runs in it."""

    def __init__(self, hidden_dim: int, input_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        cin = hidden_dim + input_dim
        self.convz = conv(cin, hidden_dim, 3, pad=2, dilation=2, dtype=dtype)
        self.convr = conv(cin, hidden_dim, 3, pad=2, dilation=2, dtype=dtype)
        self.convq = conv(cin, hidden_dim, 3, pad=2, dilation=2, dtype=dtype)

    def forward(self, h, x):
        x = x.to(h.dtype)
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(self.convz(hx))
        r = torch.sigmoid(self.convr(hx))
        q = torch.tanh(self.convq(torch.cat([r * h, x], dim=1)))
        return (1.0 - z) * h + z * q
