"""View-weighted correlation aggregation (the counterpart of the XLA
fusions at itermvs_tpu/models/itermvs.py:251-252 in the init branch and
:297-298, 314-316, 347-349 in the iterations), and kernels K11
`view_aggregate` and K12 `view_aggregate_grad`.

With the V−1 source views' correlations c_v [B, n, G, P] and their
per-pixel weights w [B, V−1, P]:
    S   = 1e-5 + Σ_v w_v
    out = (Σ_v c_v · w_v) / S
both sums folded in view order, ((c_0·w_0 + c_1·w_1) + c_2·w_2) + …,
and not through a reduction whose order torch does not fix, so that K11
is bit-equal to the plain version. The backward, with g = ∂L/∂out:
    ∂c_v = (g / S) · w_v                     (autograd's order)
    ∂w_v = Σ_{n,G} (g / S) · (c_v − out)     (through the sum and S).

On a CUDA tensor `view_aggregate` launches the hand-written kernels
(csrc/view_aggregate.cu forward, csrc/view_aggregate_grad.cu backward,
sharing csrc/view_aggregate.cuh) or raises; only a CPU tensor takes the
plain PyTorch versions beside them. The views are read through their own
base pointers with one batch stride, so the init branch's slices of its
stacked correlation pass without a copy.
"""
from __future__ import annotations

import ctypes

import torch

from itermvs_tpu_torch import kernels

MAX_VIEWS = 256         # the kernels' pointer array
ROWS_PER_THREAD = 8     # K11: n·G must be a multiple of this


def _weight_sum(weights: torch.Tensor) -> torch.Tensor:
    """S = 1e-5 + Σ_v w_v [B, 1, 1, P], folded in view order."""
    s = weights[:, 0]
    for v in range(1, weights.shape[1]):
        s = s + weights[:, v]
    return (1e-5 + s)[:, None, None]


def view_aggregate_plain(corrs, weights: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K11: (Σ_v c_v · w_v) / (1e-5 + Σ_v w_v)
    [B, n, G, P] of the V−1 correlations `corrs` [B, n, G, P] and the
    weights [B, V−1, P], both sums folded in view order."""
    num = None
    for v, c in enumerate(corrs):
        t = c * weights[:, v, None, None]
        num = t if num is None else num + t
    return num / _weight_sum(weights)


def view_aggregate_grad_plain(corrs, weights: torch.Tensor, grad: torch.Tensor,
                              need_weight_grad: bool):
    """Plain PyTorch version of K12: ([∂c_v], ∂w [B, V−1, P] or None)
    from the gradient `grad` [B, n, G, P] of the output. `corrs` is read
    only for ∂w (it may be None without it)."""
    gs = grad / _weight_sum(weights)
    d_corrs = [gs * weights[:, v, None, None] for v in range(weights.shape[1])]
    if not need_weight_grad:
        return d_corrs, None
    out = view_aggregate_plain(corrs, weights)
    d_w = torch.stack([(gs * (c - out)).sum(dim=(1, 2)) for c in corrs], dim=1)
    return d_corrs, d_w


def _shape(corrs, weights):
    """(B, n·G, P) of the views; raises unless they share one shape
    [B, n, G, P] and the weights are [B, V−1, P]."""
    if not 1 <= len(corrs) <= MAX_VIEWS:
        raise ValueError(f"view_aggregate: needs 1 to {MAX_VIEWS} views, got {len(corrs)}")
    shape = tuple(corrs[0].shape)
    if len(shape) != 4 or any(tuple(c.shape) != shape for c in corrs):
        raise ValueError(f"view_aggregate: views must share one shape [B, n, G, P], got "
                         f"{[tuple(c.shape) for c in corrs]}")
    b, n, g, p = shape
    if tuple(weights.shape) != (b, len(corrs), p):
        raise ValueError(f"view_aggregate: weights {tuple(weights.shape)} != "
                         f"{(b, len(corrs), p)}")
    return b, n * g, p


def _batch_stride(corrs) -> int:
    """The views' one batch stride; raises unless each view's (n, G, P)
    is dense and the views share it."""
    b, n, g, p = corrs[0].shape
    strides = {tuple(c.stride()) for c in corrs}
    stride = corrs[0].stride(0) if b > 1 else n * g * p
    if any(s[1:] != (g * p, p, 1) or (b > 1 and s[0] != stride) for s in strides):
        raise ValueError(f"view_aggregate: each view's [n, G, P] must be dense, with one "
                         f"batch stride; got strides {sorted(strides)}")
    return stride


def _check(name, corrs, weights, *more) -> None:
    """Raise unless everything lies on one CUDA device in float32 and the
    weights (and `more`) are contiguous."""
    dev = weights.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    tensors = (*corrs, weights, *more)
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: inputs on different devices")
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError(f"{name}: needs float32 inputs")
    if any(not t.is_contiguous() for t in (weights, *more)):
        raise ValueError(f"{name}: the weights and gradients must be contiguous")


def _pointers(corrs):
    return (ctypes.c_void_p * len(corrs))(*(c.data_ptr() for c in corrs))


def view_aggregate_args(corrs, weights, out) -> tuple:
    """K11's C arguments for checked inputs, writing `out` [B, n, G, P]
    float32 on the current stream (the pointer array is one of them)."""
    b, rows, p = _shape(corrs, weights)
    return (_pointers(corrs), len(corrs), weights.data_ptr(), out.data_ptr(), b, rows, p,
            _batch_stride(corrs), torch.cuda.current_stream().cuda_stream)


def view_aggregate_grad_args(weights, grad, d_corr, corrs=None, out=None,
                             d_weights=None) -> tuple:
    """K12's C arguments for checked inputs, on the current stream: every
    ∂c_v into `d_corr` [V−1, B, n, G, P], and with `d_weights` [B, V−1,
    P] ∂w too, which reads `corrs` and K11's output `out`."""
    b, nv, p = weights.shape
    rows = grad[0].numel() // p
    if d_weights is None:
        views, stride, ptrs = None, 0, (None, None)
    else:
        views, stride = _pointers(corrs), _batch_stride(corrs)
        ptrs = (out.data_ptr(), d_weights.data_ptr())
    return (views, nv, weights.data_ptr(), grad.data_ptr(), ptrs[0], d_corr.data_ptr(),
            ptrs[1], b, rows, p, stride, torch.cuda.current_stream().cuda_stream)


def launch_view_aggregate(corrs, weights, out) -> None:
    """K11's bare launch (`view_aggregate_args`). Counts nothing (the
    wrapper does)."""
    kernels.check_launch("view_aggregate", kernels.function("view_aggregate")(
        *view_aggregate_args(corrs, weights, out)))


def launch_view_aggregate_grad(weights, grad, d_corr, corrs=None, out=None,
                               d_weights=None) -> None:
    """K12's bare launch (`view_aggregate_grad_args`). Counts nothing
    (the wrapper does)."""
    kernels.check_launch("view_aggregate_grad", kernels.function("view_aggregate_grad")(
        *view_aggregate_grad_args(weights, grad, d_corr, corrs, out, d_weights)))


def _forward(corrs, weights: torch.Tensor) -> torch.Tensor:
    """K11 (or its plain version on the CPU)."""
    b, rows, p = _shape(corrs, weights)
    if weights.device.type == "cpu":
        return view_aggregate_plain(corrs, weights)
    _check("view_aggregate", corrs, weights)
    if rows % ROWS_PER_THREAD:
        raise ValueError(f"view_aggregate: n·G = {rows} is not a multiple of "
                         f"{ROWS_PER_THREAD}")
    out = torch.empty(corrs[0].shape, dtype=torch.float32, device=weights.device)
    with torch.cuda.device(weights.device):
        launch_view_aggregate(corrs, weights, out)
    view_aggregate.launches += 1
    return out


def view_aggregate_grad(weights, grad, corrs=None, out=None):
    """K12 (or its plain version on the CPU): ([∂c_v], ∂w or None), ∂w
    where `corrs` and the forward's `out` are given."""
    if weights.device.type == "cpu":
        return view_aggregate_grad_plain(corrs, weights, grad, corrs is not None)
    grad = grad.contiguous()
    _check("view_aggregate_grad", corrs or (), weights, grad, *(() if out is None else (out,)))
    nv = weights.shape[1]
    d_corr = torch.empty((nv, *grad.shape), dtype=torch.float32, device=grad.device)
    d_weights = None if corrs is None else torch.empty_like(weights)
    with torch.cuda.device(weights.device):
        launch_view_aggregate_grad(weights, grad, d_corr, corrs, out, d_weights)
    view_aggregate_grad.launches += 1
    return list(d_corr.unbind(0)), d_weights


class ViewAggregate(torch.autograd.Function):
    """(Σ_v c_v · w_v) / (1e-5 + Σ_v w_v), differentiable in the weights
    and every view: K11 forward, K12 backward (their plain versions on
    the CPU). Saves the weights, and the views and the output only where
    the weights need a gradient (K12 reads them only for ∂w)."""

    @staticmethod
    def forward(ctx, weights, *corrs):
        out = _forward(corrs, weights)
        ctx.weight_grad = ctx.needs_input_grad[0]
        if ctx.weight_grad:
            ctx.save_for_backward(weights, out, *corrs)
        else:
            ctx.save_for_backward(weights)
        return out

    @staticmethod
    def backward(ctx, grad):
        weights, *saved = ctx.saved_tensors
        out, corrs = (saved[0], saved[1:]) if ctx.weight_grad else (None, None)
        d_corrs, d_weights = view_aggregate_grad(weights, grad, corrs, out)
        return (d_weights, *d_corrs)


def view_aggregate(corrs, weights: torch.Tensor) -> torch.Tensor:
    """The view-weighted aggregation [B, n, G, P] float32 of the V−1
    correlations `corrs` (each [B, n, G, P] float32, its [n, G, P] dense,
    one batch stride for all: views of one stacked tensor pass as they
    are) under the weights [B, V−1, P] float32. Differentiable in both
    (ViewAggregate)."""
    corrs = tuple(corrs)
    if torch.is_grad_enabled() and (weights.requires_grad
                                    or any(c.requires_grad for c in corrs)):
        return ViewAggregate.apply(weights, *corrs)
    return _forward(corrs, weights)


# Launches of K11 and K12 (float32 only: the correlation and the weights
# are float32 in both precisions).
view_aggregate.launches = 0
view_aggregate_grad.launches = 0
