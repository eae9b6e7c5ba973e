"""BatchNorm's training statistics and their term of the input gradient
(the counterpart of flax's `_compute_stats`, the mean and variance that
nn.BatchNorm computes in training at itermvs_tpu/models/blocks.py:90-103,
one XLA fusion, and of its autodiff, which XLA fuses into the
normalise's backward), kernels K21 `bn_stats` and K22 `bn_stats_grad`,
and the training epilogue `bn_train` (`BnTrain`: K17 forward, K18 then
K22 backward, ops/bn_act.py).

For a convolution's output y [N, C, H, W] in the compute dtype, per
channel over n = N·H·W elements, in float32:
    mean = Σy / n,   var = Σ(y − mean)² / n       (the biased variance)
K21 takes both in one read of y: per span of a plane the sum S and the
squares Q about the span's own mean a, merged per channel in float64 by
Chan's rule, Σ(y − mean)² = Σ [Q − 2(mean − a)(S − m·a) + m(mean − a)²]
over the spans of m elements (not E[y²] − E[y]², which at these counts
loses the variance in float32). In a process group the statistics are
the global batch's: models/blocks.py merges the ranks' float64 (Σy,
Σ(y − ȳ)²) from `bn_sums` the same way, over two all-reduces.

Their term of ∂y, added to K18's ∂y (ops/bn_act.py) in place, with ∂mean
and ∂var from K18's rows (summed over the group first, where the
statistics were the group's) and r = 1/n rounded to float32:
    ∂y ← dtype( (f32(∂y) + ∂mean·r) + ((2·∂var)·r)·(f32(y) − mean) )
each operation rounded in float32 in this order.

On a CUDA tensor the wrappers launch the hand-written kernels
(csrc/bn_stats.cu, csrc/bn_stats_grad.cu) or raise; only a CPU tensor
takes the plain PyTorch versions beside them: `torch.var_mean` of the
float32 input for one process (what the port computed before K21), the
group path's sums in float64. The kernels take contiguous NCHW
tensors of one dtype and contiguous float32 vectors [C]: nothing is
copied. K21 sums each thread's ≤ 16 elements in float32 and everything
after in float64, so its mean and variance lie within a few float32
roundings of the exact ones (not bit-equal to var_mean's Welford sums);
K22 is bit-equal to its plain version.
"""
from __future__ import annotations

import numpy as np
import torch

from itermvs_tpu_torch.ops import bn_act as bn_ops
from itermvs_tpu_torch.parallel.mesh import all_reduce_sum

DIMS = (0, 2, 3)


def _col(v: torch.Tensor) -> torch.Tensor:
    return v.view(1, -1, 1, 1)


def bn_sums_plain(y) -> torch.Tensor:
    """Plain version of `bn_sums`: [Σy, Σ(y − Σy/n)²] of y in float64,
    [2, C]."""
    x = y.double()
    s = x.sum(DIMS)
    return torch.stack([s, (x - _col(s / (x.numel() // x.shape[1]))).square().sum(DIMS)])


def bn_batch_stats_plain(y) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `bn_batch_stats`: (mean, var) from `torch.var_mean`
    of the float32 y."""
    var, mean = torch.var_mean(y.float(), dim=DIMS, unbiased=False)
    return mean, var


def inv_count(count) -> float:
    """1 / count rounded to float32, K22's r."""
    return float(np.float32(1.0 / count))


def bn_stats_grad_plain(d_y, y, mean, d_mean, d_var, count) -> torch.Tensor:
    """Plain version of K22 (one BN): ∂y plus the statistics' term, in
    float32, rounded to ∂y's dtype (for float64 inputs in float64, with
    r = 1/count exactly)."""
    acc = bn_ops._acc(d_y.dtype)
    r = 1.0 / count if acc == torch.float64 else inv_count(count)
    cm, cv = _col((d_mean * r).to(acc)), _col(((2 * d_var) * r).to(acc))
    return ((d_y.to(acc) + cm) + cv * (y.to(acc) - _col(mean).to(acc))).to(d_y.dtype)


def _check(name, tensors, vectors) -> None:
    """Raise unless `tensors` are [N, C, H, W] of one shape and the
    vectors [C]; on a CUDA device also bn_act's dtype, layout and device
    rules."""
    y = tensors[0]
    if y.dim() != 4 or any(t.shape != y.shape for t in tensors):
        raise ValueError(f"{name}: tensors {[tuple(t.shape) for t in tensors]} must be one "
                         f"[N, C, H, W]")
    if any(v.shape != (y.shape[1],) for v in vectors):
        raise ValueError(f"{name}: per-channel vectors must be [{y.shape[1]}], got "
                         f"{[tuple(v.shape) for v in vectors]}")
    if y.device.type != "cpu":
        bn_ops._check(name, tensors, vectors)


def stats_buffers(y, wide=False):
    """K21's output [2, C], float32 (or float64 where `wide`), and its
    float64 scratch [3·N·C·spans] for y, from one allocation (the output
    at its head: whoever keeps the statistics keeps the scratch, a few
    bytes per span)."""
    n, c, h, w = y.shape
    head = 2 * c if wide else c
    buf = torch.empty(head + 3 * n * c * bn_ops.spans_of(h * w), dtype=torch.float64,
                      device=y.device)
    out = buf[:head] if wide else buf[:head].view(torch.float32)
    return out.view(2, c), buf[head:]


def bn_stats_args(y, out, partials, count) -> tuple:
    """K21's C arguments for checked inputs, writing `out` [2, C] (float32
    or float64) with the scratch `partials` (`stats_buffers`)."""
    n, c, h, w = y.shape
    return (y.data_ptr(), out.data_ptr(), int(out.dtype == torch.float64), partials.data_ptr(),
            n, c, h * w, bn_ops.spans_of(h * w), float(count), bn_ops._stream())


def _stats(y, count, wide) -> torch.Tensor:
    """K21 on y with divisor `count`: one check, one allocation, one launch
    (its two kernels)."""
    _check("bn_stats", [y], [])
    out, partials = stats_buffers(y, wide)
    with torch.cuda.device(y.device):
        bn_ops.launch("bn_stats", y.dtype, bn_stats_args(y, out, partials, count))
    bn_ops._count(bn_sums, y.dtype)
    return out


def bn_sums(y: torch.Tensor) -> torch.Tensor:
    """Per channel [Σy, Σ(y − ȳ)²] with ȳ = Σy/n this y's own mean,
    float64 [2, C]: one launch of K21 with a divisor of 1 (its plain
    version on the CPU), a rank's share of a process group's statistics.
    Not differentiated."""
    if y.device.type == "cpu":
        _check("bn_stats", [y], [])
        with torch.no_grad():
            return bn_sums_plain(y)
    return _stats(y, 1, True)


def bn_batch_stats(y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One process's batch (mean, var), float32 [C], of y: one launch of
    K21 on a CUDA tensor, its plain version on the CPU. Not
    differentiated."""
    if y.device.type == "cpu":
        _check("bn_stats", [y], [])
        with torch.no_grad():
            return bn_batch_stats_plain(y)
    mean, var = _stats(y, y.numel() // y.shape[1], False)
    return mean, var


def bn_stats_grad_args(d_y, y, mean, d_mean, d_var, count, second) -> tuple:
    """K22's C arguments for checked inputs (`second`: the downsample BN's
    (∂skip, xd, mean', ∂mean', ∂var'), or None)."""
    n, c, h, w = y.shape
    d_skip, xd, mean2, d_mean2, d_var2 = second or (None,) * 5
    ptr = bn_ops._ptr
    return (d_y.data_ptr(), y.data_ptr(), mean.data_ptr(), d_mean.data_ptr(), d_var.data_ptr(),
            ptr(d_skip), ptr(xd), ptr(mean2), ptr(d_mean2), ptr(d_var2), inv_count(count), n,
            c, h * w, bn_ops._stream())


def bn_stats_grad_(d_y: torch.Tensor, y: torch.Tensor, mean: torch.Tensor,
                   d_mean: torch.Tensor, d_var: torch.Tensor, count,
                   second: tuple | None = None) -> torch.Tensor:
    """∂y += the batch statistics' term (see the module docstring), in
    place; with `second` = (∂skip, xd, mean', ∂mean', ∂var') (ResidualBlock
    at stride 2) ∂skip += the downsample BN's in the same launch. K22 (its
    plain version on the CPU). Returns ∂y."""
    d_skip, xd, *vectors2 = second or (None, None)
    tensors = [d_y, y] + ([d_skip, xd] if second else [])
    _check("bn_stats_grad", tensors, [mean, d_mean, d_var, *vectors2])
    if y.device.type == "cpu":
        d_y.copy_(bn_stats_grad_plain(d_y, y, mean, d_mean, d_var, count))
        if second:
            d_skip.copy_(bn_stats_grad_plain(d_skip, xd, *vectors2, count))
        return d_y
    with torch.cuda.device(y.device):
        bn_ops.launch("bn_stats_grad", y.dtype,
                      bn_stats_grad_args(d_y, y, mean, d_mean, d_var, count, second))
    bn_ops._count(bn_stats_grad_, y.dtype)
    return d_y


class BnTrain(torch.autograd.Function):
    """A training epilogue: K17 forward on the batch statistics (K21's,
    computed by the caller, not differentiated here), K18 then K22
    backward (their plain versions on the CPU): K22 adds the statistics'
    term to ∂y (and in form c the downsample BN's to ∂skip) in place.
    `count` is the statistics' element count per channel, an int, or in a
    process group the global count as a float32 tensor [1], and then
    the backward first sums each BN's ∂mean and ∂var over the group (one
    all-reduce) and divides them by it."""

    @staticmethod
    def forward(ctx, y, w, b, mean, var, skip, w2, b2, mean2, var2, relu, count):
        skip_bn = None if w2 is None else (w2, b2, mean2, var2)
        out = bn_ops._forward(y, w, b, mean, var, skip, skip_bn, relu)
        ctx.form, ctx.relu = bn_ops._form(skip, skip_bn), relu
        ctx.count = count
        ctx.save_for_backward(y, out if relu else None, w, mean, var,
                              skip if skip_bn is not None else None, w2, mean2, var2)
        return out

    @staticmethod
    def backward(ctx, grad):
        y, out, w, mean, var, xd, w2, mean2, var2 = ctx.saved_tensors
        skip_bn = None if w2 is None else (w2, None, mean2, var2)
        d_y, d_skip, rows = bn_ops.bn_act_grad(grad, y, out, w, mean, var, ctx.form, xd,
                                               skip_bn, ctx.relu)
        rows = rows.view(-1, 5, rows.shape[-1])
        terms, count = rows[:, 3:5], ctx.count           # each BN's ∂mean, ∂var
        if torch.is_tensor(count):
            terms, count = all_reduce_sum(terms) / count, 1
        skip_term = None if xd is None else (d_skip, xd, mean2, *terms[1])
        bn_stats_grad_(d_y, y, mean, *terms[0], count, skip_term)
        # Per BN: ∂w, ∂b (= s1) from rows [s1, s2, ∂w, ∂mean, ∂var].
        vec = [(r[2], r[0]) for r in rows]
        second = vec[1] if xd is not None else (None, None)
        grads = (d_y, *vec[0], None, None, d_skip, *second, None, None, None, None)
        return tuple(g if need else None for g, need in zip(grads, ctx.needs_input_grad))


def bn_train(y: torch.Tensor, w: torch.Tensor, b: torch.Tensor, mean: torch.Tensor,
             var: torch.Tensor, count, skip: torch.Tensor | None = None,
             skip_bn: tuple | None = None, relu: bool = True) -> torch.Tensor:
    """`bn_act` in training: `mean`, `var` (and skip_bn's) are the batch
    statistics of y (and of the skip) over `count` elements per channel
    (see `BnTrain`), whose gradient the backward carries to y (and the
    skip) with K22. Differentiable in y, w, b and the skip and its w', b'."""
    w2, b2, mean2, var2 = skip_bn or (None,) * 4
    if bn_ops._needs_grad((y, w, b, skip, w2, b2)):
        return BnTrain.apply(y, w, b, mean, var, skip, w2, b2, mean2, var2, relu, count)
    return bn_ops._forward(y, w, b, mean, var, skip, skip_bn, relu)


# Launches of each kernel's float32 and bfloat16 forms.
bn_sums.launches = bn_sums.launches_bf16 = 0
bn_stats_grad_.launches = bn_stats_grad_.launches_bf16 = 0
