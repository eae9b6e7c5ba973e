"""Kernels K6 `depth_readout` and K7 `depth_readout_grad`: the 256-bin
depth-head softmax and the windowed expectation, forward and backward.

Counterpart of `jax.nn.softmax` over the depth head's logits followed by
itermvs_tpu/models/itermvs.py `windowed_expectation`, on the port's NCHW
layout: logits [B, 256, H, W] in the compute dtype → normalized depth
[B, 1, H, W] float32 and, in training, the probability [B, 256, H, W]
float32. The argmax bin is held constant (stop-gradient), as in the JAX
package.

On a CUDA tensor `depth_readout` launches the hand-written kernels of the
logits' dtype (csrc/depth_readout.cu forward, csrc/depth_readout_grad.cu
backward, each with a float32 and a bfloat16 form) or raises; only a CPU
tensor takes the plain PyTorch versions beside them. K7 reads the
probability's gradient where it lies, dense NCHW (as the training loss
hands it back) or channels-last (`prob_grad_strides`). The backward's
plain version is the formula itself, not autograd of the plain forward:
with r, S and the argmax from the forward, the window weights w_k and
c = ∂L/∂d / (255 (1e-6 + S)),
    g_k      = ∂L/∂p_k + c · w_k (k − r)
    ∂L/∂l_k  = p_k (g_k − Σ_j p_j g_j).
"""
from __future__ import annotations

import torch

from itermvs_tpu_torch import kernels

NUM_BINS = 256          # output probability bins over normalized inverse depth
RADIUS = 4              # windowed-expectation half width

KERNELS = {torch.float32: ("depth_readout", "depth_readout_grad"),
           torch.bfloat16: ("depth_readout_bf16", "depth_readout_grad_bf16")}


def _wide(dtype: torch.dtype) -> torch.dtype:
    """The dtype the plain versions compute in: float32, or float64 for
    float64 logits (gradcheck)."""
    return torch.promote_types(dtype, torch.float32)


def window_weights(index: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """[B, NUM_BINS, H, W] weights of the ±RADIUS window around the argmax
    `index` [B, 1, H, W]. A window clipped at bin 0 (or NUM_BINS−1) counts
    that bin once per clipped tap, as the reference's `clip(argmax + k)`
    gather does: `max(0, RADIUS − argmax)` extra weight at bin 0,
    symmetric at the top bin."""
    idx = index.to(dtype)
    bins = torch.arange(NUM_BINS, dtype=dtype, device=index.device).reshape(1, -1, 1, 1)
    weight = ((bins - idx).abs() <= RADIUS).to(dtype)
    extra_lo = torch.clamp(RADIUS - idx, min=0.0)
    extra_hi = torch.clamp(idx + RADIUS - (NUM_BINS - 1), min=0.0)
    zero = torch.zeros((), dtype=dtype, device=index.device)
    return (weight
            + torch.where(bins == 0.0, extra_lo, zero)
            + torch.where(bins == float(NUM_BINS - 1), extra_hi, zero))


def readout_plain(probability: torch.Tensor):
    """(depth [B, 1, H, W], argmax [B, 1, H, W] int64, window mass S and
    expectation r [B, 1, H, W]) of a [B, NUM_BINS, H, W] distribution."""
    dt = probability.dtype
    index = probability.argmax(dim=1, keepdim=True)
    bins = torch.arange(NUM_BINS, dtype=dt, device=probability.device).reshape(1, -1, 1, 1)
    pw = probability * window_weights(index, dt)
    mass = pw.sum(dim=1, keepdim=True)
    regress = (pw * bins).sum(dim=1, keepdim=True) / (1e-6 + mass)
    return regress / (NUM_BINS - 1.0), index, mass, regress


def windowed_expectation(probability: torch.Tensor) -> torch.Tensor:
    """Normalized depth [B, 1, H, W] from a [B, NUM_BINS, H, W]
    distribution: the expectation over the ±RADIUS window around the
    argmax bin, normalized by the window's mass, over NUM_BINS − 1."""
    return readout_plain(probability)[0]


def depth_readout_plain(logits: torch.Tensor):
    """Plain PyTorch version of K6: (depth, probability, argmax, S, r) of
    `logits` [B, NUM_BINS, H, W], the softmax in float32 (float64 for
    float64 logits)."""
    probability = torch.softmax(logits.to(_wide(logits.dtype)), dim=1)
    depth, index, mass, regress = readout_plain(probability)
    return depth, probability, index, mass, regress


def depth_readout_grad_plain(probability, index, mass, regress, d_probability, d_depth,
                             dtype: torch.dtype) -> torch.Tensor:
    """Plain PyTorch version of K7: ∂L/∂logits [B, NUM_BINS, H, W] in
    `dtype` from the forward's probability, argmax, S and r and the
    gradients of the probability and the depth (either may be None: 0),
    in the probability's dtype, rounded once."""
    wt = probability.dtype
    bins = torch.arange(NUM_BINS, dtype=wt, device=probability.device).reshape(1, -1, 1, 1)
    g = torch.zeros_like(probability) if d_probability is None else d_probability.to(wt)
    if d_depth is not None:
        coef = d_depth.to(wt) / ((NUM_BINS - 1.0) * (1e-6 + mass.to(wt)))
        g = g + coef * window_weights(index, wt) * (bins - regress.to(wt))
    dot = (probability * g).sum(dim=1, keepdim=True)
    return (probability * (g - dot)).to(dtype)


def _check(name: str, tensors, dtype: torch.dtype) -> None:
    """Raise unless `tensors` lie on one CUDA device, are contiguous and
    the logits' dtype has a kernel."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: inputs on different devices")
    if dtype not in KERNELS:
        raise ValueError(f"{name}: needs float32 or bfloat16 logits, got {dtype}")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")


def _ptr(t):
    return None if t is None else t.data_ptr()


def launch_depth_readout(logits, depth, prob=None, index=None, mass=None,
                         regress=None) -> None:
    """K6's bare launch (the kernel of the logits' dtype) on the current
    stream, for checked inputs: `depth` [B, 1, H, W] float32 and, in
    training, `prob` [B, 256, H, W], `mass`, `regress` float32 and `index`
    int32 [B, 1, H, W] (all four, or none). Counts nothing (the wrapper
    does)."""
    b, _, h, w = logits.shape
    name = KERNELS[logits.dtype][0]
    kernels.check_launch(name, kernels.function(name)(
        logits.data_ptr(), depth.data_ptr(), _ptr(prob), _ptr(index), _ptr(mass),
        _ptr(regress), b, h * w, torch.cuda.current_stream().cuda_stream))


def prob_grad_strides(d_prob: torch.Tensor):
    """The (batch, bin, pixel) element strides under which K7 reads a
    probability gradient [B, 256, H, W] where it lies: dense NCHW (bin
    stride H·W, pixel stride 1) or channels-last (bin stride 1, pixel
    stride 256), H and W flattened into one pixel axis. None for any
    other layout (the wrapper copies it)."""
    b, _, h, w = d_prob.shape
    sb, sk, sh, sw = d_prob.stride()
    hw = h * w
    if h == 1 or w == 1:
        pixel = sw if h == 1 else sh
    elif sh == w * sw:
        pixel = sw
    else:
        return None
    batch = sb if b > 1 else NUM_BINS * hw
    if sk == hw and (pixel == 1 or hw == 1):
        return batch, hw, 1
    if sk == 1 and (pixel == NUM_BINS or hw == 1):
        return batch, 1, NUM_BINS
    return None


def kernel_prob_grad(d_prob: torch.Tensor) -> torch.Tensor:
    """The probability's gradient as K7 reads it: float32 (converted in
    its own layout), in place where `prob_grad_strides` takes its layout,
    else made contiguous once, counted on `depth_readout_grad.copies`.
    The training loss reads the probability NHWC, but its clamp's
    backward hands the gradient back dense NCHW, the probability's own
    layout."""
    d_prob = d_prob.float()
    if prob_grad_strides(d_prob) is None:
        d_prob = d_prob.contiguous()
        depth_readout_grad.copies += 1
    return d_prob


def launch_depth_readout_grad(prob, d_prob, d_depth, index, mass, regress, out) -> None:
    """K7's bare launch (the kernel of `out`'s dtype) into `out` [B, 256,
    H, W] on the current stream, for checked inputs (`d_prob`, `d_depth`
    may be None: 0; `d_prob` float32, dense or channels-last as
    `prob_grad_strides` takes it). Counts nothing (the wrapper does)."""
    b, _, h, w = prob.shape
    strides = (0, 0, 0) if d_prob is None else prob_grad_strides(d_prob)
    if strides is None:
        raise ValueError("depth_readout_grad: the probability's gradient must be dense "
                         f"NCHW or channels-last, got strides {d_prob.stride()}")
    name = KERNELS[out.dtype][1]
    kernels.check_launch(name, kernels.function(name)(
        prob.data_ptr(), _ptr(d_prob), _ptr(d_depth), index.data_ptr(), mass.data_ptr(),
        regress.data_ptr(), out.data_ptr(), b, h * w, *strides,
        torch.cuda.current_stream().cuda_stream))


def _forward(logits: torch.Tensor, keep: bool):
    """K6 (or its plain version on the CPU): (depth, probability, argmax,
    S, r), the last four None unless `keep`."""
    if logits.ndim != 4 or logits.shape[1] != NUM_BINS:
        raise ValueError(f"depth_readout: logits must be [B, {NUM_BINS}, H, W], "
                         f"got {tuple(logits.shape)}")
    if logits.device.type == "cpu":
        out = depth_readout_plain(logits)
        return out if keep else (out[0], None, None, None, None)
    _check("depth_readout", (logits,), logits.dtype)
    b, _, h, w = logits.shape
    f32 = dict(dtype=torch.float32, device=logits.device)
    depth = torch.empty((b, 1, h, w), **f32)
    prob = index = mass = regress = None
    if keep:
        prob = torch.empty((b, NUM_BINS, h, w), **f32)
        index = torch.empty((b, 1, h, w), dtype=torch.int32, device=logits.device)
        mass, regress = torch.empty_like(depth), torch.empty_like(depth)
    with torch.cuda.device(logits.device):
        launch_depth_readout(logits, depth, prob, index, mass, regress)
    if logits.dtype == torch.float32:
        depth_readout.launches += 1
    else:
        depth_readout.launches_bf16 += 1
    return depth, prob, index, mass, regress


def depth_readout_grad(prob, index, mass, regress, d_prob, d_depth,
                       dtype: torch.dtype) -> torch.Tensor:
    """K7 (or its plain version on the CPU): ∂L/∂logits in `dtype`."""
    if prob.device.type == "cpu":
        return depth_readout_grad_plain(prob, index, mass, regress, d_prob, d_depth, dtype)
    d_prob = None if d_prob is None else kernel_prob_grad(d_prob)
    d_depth = None if d_depth is None else d_depth.float().contiguous()
    _check("depth_readout_grad", [prob, index, mass, regress]
           + ([] if d_depth is None else [d_depth]), dtype)
    if d_prob is not None and (d_prob.device != prob.device or d_prob.shape != prob.shape):
        raise ValueError("depth_readout_grad: the probability's gradient must match the "
                         "probability's shape and device")
    if (index.dtype != torch.int32
            or any(t.dtype != torch.float32 for t in (prob, mass, regress))):
        raise ValueError("depth_readout_grad: needs K6's float32 probability, S and r "
                         "and int32 argmax")
    out = torch.empty(prob.shape, dtype=dtype, device=prob.device)
    with torch.cuda.device(prob.device):
        launch_depth_readout_grad(prob, d_prob, d_depth, index, mass, regress, out)
    if dtype == torch.float32:
        depth_readout_grad.launches += 1
    else:
        depth_readout_grad.launches_bf16 += 1
    return out


class DepthReadout(torch.autograd.Function):
    """(depth [B, 1, H, W], probability [B, 256, H, W]) of logits [B, 256,
    H, W], differentiable in the logits through both outputs: K6 forward,
    K7 backward (their plain versions on the CPU). Saves the probability,
    the argmax, S and r."""

    @staticmethod
    def forward(ctx, logits):
        depth, prob, index, mass, regress = _forward(logits, keep=True)
        ctx.set_materialize_grads(False)
        ctx.dtype = logits.dtype
        ctx.save_for_backward(prob, index, mass, regress)
        return depth, prob

    @staticmethod
    def backward(ctx, d_depth, d_prob):
        if d_depth is None and d_prob is None:
            return None
        prob, index, mass, regress = ctx.saved_tensors
        return depth_readout_grad(prob, index, mass, regress, d_prob, d_depth, ctx.dtype)


def depth_readout(logits: torch.Tensor, probability: bool = True):
    """Normalized depth [B, 1, H, W] float32 and (if `probability`) the
    256-bin probability [B, 256, H, W] float32 of depth-head logits [B,
    256, H, W] (float32 or bfloat16; on the card contiguous, never
    copied). Without `probability` nothing writes it (eval), and the
    second result is None. Differentiable in the logits (DepthReadout)."""
    if torch.is_grad_enabled() and logits.requires_grad:
        depth, prob = DepthReadout.apply(logits)
        return depth, (prob if probability else None)
    depth, prob, *_ = _forward(logits, keep=probability)
    return depth, prob


# Launches of the float32 and the bfloat16 kernels.
depth_readout.launches = 0
depth_readout.launches_bf16 = 0
depth_readout_grad.launches = 0
depth_readout_grad.launches_bf16 = 0
# Probability gradients that came in another layout than K7 reads and
# were copied first (the training path hands K7 none).
depth_readout_grad.copies = 0
