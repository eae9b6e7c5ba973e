"""NN building blocks, NCHW (counterpart of itermvs_tpu/models/blocks.py).

Convolutions are `Conv2d` / `ConvTranspose2d` (cuDNN on the card), BN is
`BatchNorm`, an `nn.BatchNorm2d` (eps 1e-5) whose train mode keeps the
JAX package's (flax's) running statistics, over the global batch when
the process is one rank of a data-parallel group. Module and parameter names
follow the reference's torch state_dict (e.g. `conv1.conv.weight`,
`conv1.bn.running_mean`), which `weights.py` fills from the vendored
flax checkpoint.

Every block takes a `dtype`, the compute dtype, as the JAX blocks do:
float32, or bfloat16. Parameters are float32 in both modes (the same
checkpoints); a convolution casts its input, weight and bias to the
compute dtype (flax's `nn.Conv(dtype=...)`), and BatchNorm computes its
statistics and normalisation in float32 and returns the compute dtype
(flax's `nn.BatchNorm(dtype=...)`). In float32 every cast is a no-op.

The BN normalise, the ReLU and the residual add after a convolution run
as one launch of K17 `bn_act` (ops/bn_act.py, label `bn_act`), in
training with K18 `bn_act_grad` as its backward. In training each BN's
batch statistics are one launch of K21 `bn_stats` (ops/bn_stats.py,
label `bn_stats`) and their term of the input gradient one launch of K22
`bn_stats_grad` per epilogue, after K18 (`bn_train`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function

from itermvs_tpu_torch.ops.bn_act import bn_act
from itermvs_tpu_torch.ops.bn_stats import bn_batch_stats, bn_sums, bn_train
from itermvs_tpu_torch.ops.conv_gru import gru_reset, gru_update
from itermvs_tpu_torch.parallel.mesh import all_reduce_sum, is_initialized


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
    Statistics, their update and the normalisation run in float32
    whatever the input's dtype; the output is `dtype`.

    `statistics` gives the `Stats` that normalise a batch, which K17
    `bn_act` consumes (`forward`, and the blocks below with their ReLU
    and residual add, through `epilogue`): in eval the running
    statistics, in training the batch's from K21 (`bn_batch_stats`, label
    `bn_stats`) with their count, not differentiated: `bn_train`'s
    backward adds their term of the input gradient (K22). In a process
    group (parallel/mesh.py) a training batch is the global batch, as in
    the JAX step over a sharded batch: `_global_statistics` merges each
    rank's one-read sums by Chan's rule (not E[x²]−E[x]², which at these
    counts loses the variance in float32), and the backward sums ∂mean
    and ∂var over the ranks."""

    def __init__(self, num_features: int, dtype: torch.dtype = torch.float32):
        super().__init__(num_features, eps=1e-5, momentum=0.1)
        self.compute_dtype = dtype

    def _update_running(self, mean, var):
        with torch.no_grad():
            self.running_mean.mul_(0.9).add_(0.1 * mean)
            self.running_var.mul_(0.9).add_(0.1 * var)
            self.num_batches_tracked.add_(1)

    @staticmethod
    def _global_statistics(x):
        """(mean, var, count) of x over the process group, float32, count a
        tensor [1]: each rank's n, Σx and Σ(x − x̄)² about its own mean
        x̄ (one launch of K21, float64), then Σx and n summed over the
        ranks for the mean, then Σ(x − x̄)² + n·(x̄ − mean)² for the
        squares about it, in float64 (in float32 the rounding of x̄ would
        enter the variance at first order)."""
        c, n = x.shape[1], x.numel() // x.shape[1]
        s, q = bn_sums(x)
        total = all_reduce_sum(torch.cat([s, s.new_full((1,), n)]))
        count = total[c:]
        mean = total[:c] / count
        var = all_reduce_sum(q + n * (s / n - mean).square()) / count
        return mean.float(), var.float(), count.float()

    def statistics(self, x) -> Stats:
        """The `Stats` that normalise `x` in this mode; in training also
        moves the running statistics."""
        if not self.training:
            return Stats(self.weight, self.bias, self.running_mean, self.running_var)
        with record_function("bn_stats"):
            if is_initialized():
                mean, var, count = self._global_statistics(x)
            else:
                (mean, var), count = bn_batch_stats(x), x.numel() // x.shape[1]
        self._update_running(mean, var)
        return Stats(self.weight, self.bias, mean, var, count)

    def forward(self, x):
        return epilogue(x.to(self.compute_dtype), self.statistics(x), relu=False)


class Stats(NamedTuple):
    """A BatchNorm's (weight, bias, mean, var), float32 [C], and in
    training the batch statistics' element count per channel (an int, or
    the process group's as a float32 tensor [1]); None in eval."""
    w: torch.Tensor
    b: torch.Tensor
    mean: torch.Tensor
    var: torch.Tensor
    count: int | torch.Tensor | None = None


def epilogue(y, stats: Stats, skip=None, skip_stats: Stats | None = None, relu=True):
    """K17 on y with its BN's `stats` (and the identity `skip`, or the
    downsample's output `skip` with its BN's `skip_stats`), under the
    label `bn_act`: `bn_act` in eval, `bn_train` on batch statistics."""
    skip_bn = None if skip_stats is None else tuple(skip_stats[:4])
    with record_function("bn_act"):
        if stats.count is None:
            return bn_act(y, *stats[:4], skip=skip, skip_bn=skip_bn, relu=relu)
        return bn_train(y, *stats[:4], stats.count, skip=skip, skip_bn=skip_bn, relu=relu)


class ConvBn(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 pad: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = conv(cin, cout, kernel, stride, pad, bias=False, dtype=dtype)
        self.bn = BatchNorm(cout, dtype)

    def forward(self, x):
        return self.bn(self.conv(x))

    def conv_statistics(self, x):
        """(the convolution's output y, its BN's `statistics(y)`)."""
        y = self.conv(x)
        return y, self.bn.statistics(y)


class ConvBnReLU(ConvBn):
    def forward(self, x):
        return epilogue(*self.conv_statistics(x))


class ConvReLU(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 pad: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = conv(cin, cout, kernel, stride, pad, bias=False, dtype=dtype)

    def forward(self, x):
        return torch.relu(self.conv(x))


class ResidualBlock(nn.Module):
    """ConvBnReLU → ConvBn, plus a strided ConvBn skip when stride != 1;
    conv2's BN, the skip's BN, the add and the ReLU are one K17 launch."""

    def __init__(self, cin: int, cout: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = ConvBnReLU(cin, cout, stride=stride, dtype=dtype)
        self.conv2 = ConvBn(cout, cout, dtype=dtype)
        self.downsample = (ConvBn(cin, cout, stride=stride, dtype=dtype)
                           if stride != 1 else None)

    def forward(self, x):
        y, stats = self.conv2.conv_statistics(self.conv1(x))
        if self.downsample is None:
            return epilogue(y, stats, skip=x)
        return epilogue(y, stats, *self.downsample.conv_statistics(x))


class ConvGRU(nn.Module):
    """Convolutional GRU with 3×3 dilation-2 gates. The input is cast to
    the hidden state's dtype, and the update runs in it: the convolutions
    in cuDNN, the gates' elementwise work in K13 `gru_reset` (convq's
    input [σ(r_l)·h, x]) and K14 `gru_update` (the new hidden state), with
    their backwards K15 and K16 (ops/conv_gru.py), each under the
    `conv_gru` profiler label."""

    def __init__(self, hidden_dim: int, input_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        cin = hidden_dim + input_dim
        self.convz = conv(cin, hidden_dim, 3, pad=2, dilation=2, dtype=dtype)
        self.convr = conv(cin, hidden_dim, 3, pad=2, dilation=2, dtype=dtype)
        self.convq = conv(cin, hidden_dim, 3, pad=2, dilation=2, dtype=dtype)

    def forward(self, h, x):
        hx = torch.cat([h, x.to(h.dtype)], dim=1)
        z_l = self.convz(hx)
        r_l = self.convr(hx)
        with record_function("conv_gru"):
            rh_x = gru_reset(r_l, hx)
        q_l = self.convq(rh_x)
        with record_function("conv_gru"):
            return gru_update(z_l, q_l, h)
