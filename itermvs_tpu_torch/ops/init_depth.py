"""The init sweep's depth in training (the counterpart of the XLA fusions at
itermvs_tpu/models/itermvs.py:257-266): kernels K32 `init_depth` and its
backward K33 `init_depth_grad`.

For the CorrNet score s [B, 32, h, w] float32 and the inverse depth
bounds idmin, idmax (B values, [B] or [B, 1, 1, 1]):
    p     = softmax(s) over the 32 samples
    e     = Σ_d d · p_d
    depth = depth_unnormalization(e / 31, idmin, idmax)
    out   = upsample_bilinear(depth, 2)        [B, 1, 2h, 2w] float32
K32 computes it in one launch, rounding where the eager chain
(`init_depth_plain`) rounds on the card, so that it is bit-equal to it
there: PyTorch's softmax, its order of the sum (four interleaved partial
sums), e / 31 as a product with the float reciprocal and 1 / x as a
quotient. Its backward K33 takes ∂out, gathers it onto s's plane as K29
does at ×2 (`upsample2x_grad_plain`: float64, rounded once to float32),
then evaluates, in float64 from that g on,
    ∂e   = −g · depth² · (idmin − idmax) / 31
    ∂s_d = p_d · ∂e · (d − Σ_k k · p_k)
and rounds once to float32 (`init_depth_grad_plain` is the same
evaluation in PyTorch). The bounds carry no gradient: `init_depth` raises
where they ask for one.

On a CUDA tensor the wrappers launch the hand-written kernels
(csrc/init_depth.cu, csrc/init_depth_grad.cu, sharing
csrc/sample_softmax.cuh) or raise; only a CPU tensor takes the plain
versions beside them. Everything is float32; s must be contiguous, and a
∂out that is not is copied once and counted on `init_depth_grad.copies`.
"""
from __future__ import annotations

import torch

from itermvs_tpu_torch.ops.depth_range import depth_unnormalization
from itermvs_tpu_torch.ops.resize import (
    _check, _stream, launch, upsample2x_grad_plain, upsample_bilinear)
from itermvs_tpu_torch.ops.view_weight import SAMPLES


def _bounds(score, idmin, idmax):
    """The bounds as [B, 1, 1, 1], checked against the score's batch."""
    b = score.shape[0]
    if idmin.numel() != b or idmax.numel() != b:
        raise ValueError(f"init_depth: needs {b} values of each bound, got "
                         f"{tuple(idmin.shape)} and {tuple(idmax.shape)}")
    return idmin.reshape(b, 1, 1, 1), idmax.reshape(b, 1, 1, 1)


def _samples(score):
    """Σ_d d · p_d [B, 1, h, w] and p [B, 32, h, w] of the score, as the
    eager chain computes them."""
    p = torch.softmax(score, dim=1)
    index = torch.arange(SAMPLES, dtype=torch.float32, device=score.device)
    return (index.reshape(1, SAMPLES, 1, 1) * p).sum(dim=1, keepdim=True), p


def init_depth_plain(score: torch.Tensor, idmin: torch.Tensor,
                     idmax: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K32: the init depth ×2 [B, 1, 2h, 2w]."""
    lo, hi = _bounds(score, idmin, idmax)
    e, _ = _samples(score)
    return upsample_bilinear(depth_unnormalization(e / (SAMPLES - 1.0), lo, hi), 2)


def init_depth_grad_plain(g: torch.Tensor, score: torch.Tensor, idmin: torch.Tensor,
                          idmax: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain PyTorch version of K33: ∂score [B, 32, h, w] from ∂out g [B, 1,
    2h, 2w], in float64 after the ×2 gather, rounded to `dtype` (the
    score's by default; a float64 score stays float64 throughout)."""
    lo, hi = _bounds(score, idmin, idmax)
    grad = upsample2x_grad_plain(g, tuple(score.shape[-2:])).double()
    e, p = _samples(score)
    diff = lo - hi
    depth = depth_unnormalization(e / (SAMPLES - 1.0), lo, hi).double()
    scale = (torch.ones((), dtype=score.dtype) / (SAMPLES - 1)).item()
    d_e = -grad * (depth * depth) * diff.double() * scale
    index = torch.arange(SAMPLES, dtype=torch.float64, device=score.device).reshape(1, -1, 1, 1)
    p = p.double()
    mean = (index * p).sum(dim=1, keepdim=True)
    return (p * (d_e * (index - mean))).to(dtype or score.dtype)


def _shapes(score, g=None) -> None:
    if score.dim() != 4 or score.shape[1] != SAMPLES:
        raise ValueError(f"init_depth: the score {tuple(score.shape)} must be "
                         f"[B, {SAMPLES}, h, w]")
    b, _, h, w = score.shape
    if g is not None and g.shape != (b, 1, 2 * h, 2 * w):
        raise ValueError(f"init_depth_grad: ∂out {tuple(g.shape)} must be "
                         f"[{b}, 1, {2 * h}, {2 * w}]")


def init_depth_args(score, idmin, idmax, out) -> tuple:
    """K32's C arguments for checked inputs (the bounds [B]), writing out."""
    b, _, h, w = score.shape
    return (score.data_ptr(), idmin.data_ptr(), idmax.data_ptr(), out.data_ptr(), b, h, w,
            _stream())


def init_depth_grad_args(g, score, idmin, idmax, d_score) -> tuple:
    """K33's C arguments for checked inputs (the bounds [B]), writing
    d_score."""
    b, _, h, w = score.shape
    return (g.data_ptr(), score.data_ptr(), idmin.data_ptr(), idmax.data_ptr(),
            d_score.data_ptr(), b, h, w, _stream())


def _device_bounds(name, score, idmin, idmax):
    """The bounds as contiguous [B], checked with the score for a launch:
    all float32."""
    b = score.shape[0]
    lo, hi = idmin.reshape(b), idmax.reshape(b)
    if any(t.dtype != torch.float32 for t in (score, lo, hi)):
        raise ValueError(f"{name}: needs float32, got {[score.dtype, lo.dtype, hi.dtype]}")
    _check(name, (score, lo, hi))
    return lo, hi


def init_depth_forward(score: torch.Tensor, idmin: torch.Tensor,
                       idmax: torch.Tensor) -> torch.Tensor:
    """K32 (or its plain version on the CPU): the init depth ×2 [B, 1, 2h,
    2w] from the score [B, 32, h, w] and the bounds. Not differentiable
    (`init_depth` is)."""
    _shapes(score)
    _bounds(score, idmin, idmax)
    if score.device.type == "cpu":
        return init_depth_plain(score, idmin, idmax)
    lo, hi = _device_bounds("init_depth", score, idmin, idmax)
    b, _, h, w = score.shape
    out = torch.empty(b, 1, 2 * h, 2 * w, dtype=torch.float32, device=score.device)
    with torch.cuda.device(score.device):
        launch("init_depth", torch.float32, init_depth_args(score, lo, hi, out))
    init_depth_forward.launches += 1
    return out


def init_depth_grad(g: torch.Tensor, score: torch.Tensor, idmin: torch.Tensor,
                    idmax: torch.Tensor) -> torch.Tensor:
    """K33 (or its plain version on the CPU): ∂score [B, 32, h, w] float32
    from ∂out g [B, 1, 2h, 2w]. A g that is not contiguous is copied once
    (`init_depth_grad.copies`)."""
    _shapes(score, g)
    _bounds(score, idmin, idmax)
    if score.device.type == "cpu":
        return init_depth_grad_plain(g, score, idmin, idmax)
    if not g.is_contiguous():
        g = g.contiguous()
        init_depth_grad.copies += 1
    lo, hi = _device_bounds("init_depth_grad", score, idmin, idmax)
    _check("init_depth_grad", (g, score))
    d_score = torch.empty_like(score)
    with torch.cuda.device(score.device):
        launch("init_depth_grad", torch.float32,
               init_depth_grad_args(g, score, lo, hi, d_score))
    init_depth_grad.launches += 1
    return d_score


class InitDepth(torch.autograd.Function):
    """K32 forward, K33 backward (their plain versions on the CPU). Saves
    the score and the bounds."""

    @staticmethod
    def forward(ctx, score, idmin, idmax):
        ctx.save_for_backward(score, idmin, idmax)
        return init_depth_forward(score, idmin, idmax)

    @staticmethod
    def backward(ctx, g):
        return init_depth_grad(g, *ctx.saved_tensors), None, None


def init_depth(score: torch.Tensor, idmin: torch.Tensor, idmax: torch.Tensor) -> torch.Tensor:
    """The init-sweep depth [B, 1, 2h, 2w]: the expectation of the sample
    index under the softmax of the score [B, 32, h, w], unnormalized by the
    bounds (B values each), ×2 upsampled. Differentiable in the score
    (InitDepth); the bounds may not ask for a gradient."""
    if idmin.requires_grad or idmax.requires_grad:
        raise ValueError("init_depth: the depth bounds carry no gradient")
    if torch.is_grad_enabled() and score.requires_grad:
        return InitDepth.apply(score, idmin, idmax)
    return init_depth_forward(score, idmin, idmax)


# Launches of K32 and K33 (float32 only), and K33's copies of a ∂out that
# was not contiguous.
init_depth_forward.launches = init_depth_grad.launches = 0
init_depth_grad.copies = 0
