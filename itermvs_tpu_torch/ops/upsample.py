"""Convex-combination ×4 upsampling (counterpart of itermvs_tpu/ops/upsample.py),
and kernels K9 `convex_upsample` and K10 `convex_upsample_grad`: the
9-tap softmax of the mask logits and the ×4 convex upsample, forward and
backward.

Each output sub-pixel is a softmax-weighted combination of the 3×3
neighbourhood of its parent coarse pixel, with EDGE (replicate) padding
at the border — `F.unfold`'s zero padding would differ there. Per coarse
pixel p and sub-pixel (i, j), with the mask logits l [B, 144, H, W]
(channel k·16 + i·4 + j, tap k = (dy+1)·3 + (dx+1)) and the clamped
neighbours t_k = x[clamp(p + (dy, dx))]:
    w_k       = softmax_k(l_k)                  (float32)
    up[4p+ij] = Σ_k w_k t_k.
The backward, with g = ∂L/∂up:
    ∂L/∂l_k  = g · w_k (t_k − up)
    ∂L/∂x[q] = Σ over every (p, k) whose clamped tap lands on q of
               Σ_(i,j) g · w_k,
so a border pixel also takes the taps that clamp onto it.

On a CUDA tensor `upsample_depth` launches the hand-written kernels of
the logits' dtype (csrc/convex_upsample.cu forward, csrc/
convex_upsample_grad.cu backward, each with a float32 and a bfloat16
form, sharing their softmax through csrc/upsample_taps.cuh) or raises;
only a CPU tensor takes the plain PyTorch versions beside them. The
backward's plain version is the formula itself, not autograd of the
plain forward.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from itermvs_tpu_torch import kernels

SCALE = 4
TAPS = 9
CHANNELS = TAPS * SCALE * SCALE        # mask logits per coarse pixel

KERNELS = {torch.float32: ("convex_upsample", "convex_upsample_grad"),
           torch.bfloat16: ("convex_upsample_bf16", "convex_upsample_grad_bf16")}


def neighbours(x: torch.Tensor) -> torch.Tensor:
    """The edge-padded 3×3 neighbourhood [B, 9, H, W] of [B, 1, H, W], tap
    order row-major over (dy, dx) ∈ {−1, 0, 1}²."""
    b, c, h, w = x.shape
    if c != 1:
        raise ValueError("convex_upsample expects a single-channel map")
    padded = F.pad(x, (1, 1, 1, 1), mode="replicate")[:, 0]     # [B,H+2,W+2]
    return torch.stack([padded[:, dy:dy + h, dx:dx + w]
                        for dy in range(3) for dx in range(3)], dim=1)


def convex_upsample(x: torch.Tensor, weights: torch.Tensor, scale: int = 4
                    ) -> torch.Tensor:
    """Upsample [B, 1, H, W] to [B, 1, scale·H, scale·W].

    `weights`: [B, 9, scale, scale, H, W], convex over the 9 taps, tap
    order row-major over (dy, dx) ∈ {−1, 0, 1}².
    """
    b, _, h, w = x.shape
    up = (neighbours(x)[:, :, None, None] * weights).sum(dim=1)  # [B,s,s,H,W]
    return up.permute(0, 3, 1, 4, 2).reshape(b, 1, h * scale, w * scale)


def _wide(dtype: torch.dtype) -> torch.dtype:
    """The dtype the plain versions compute in: float32, or float64 for
    float64 inputs (gradcheck)."""
    return torch.promote_types(dtype, torch.float32)


def _softmax(mask_logits: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The tap weights [B, 9, 4, 4, H, W] of mask logits [B, 144, H, W]."""
    b, _, h, w = mask_logits.shape
    return torch.softmax(mask_logits.to(dtype).reshape(b, TAPS, SCALE, SCALE, h, w), dim=1)


def convex_upsample_plain(x: torch.Tensor, mask_logits: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K9: [B, 1, 4H, 4W] from x [B, 1, H, W]
    and mask logits [B, 144, H, W], the softmax in float32 (float64 for
    float64 inputs)."""
    dt = torch.promote_types(_wide(mask_logits.dtype), x.dtype)
    return convex_upsample(x.to(dt), _softmax(mask_logits, dt), SCALE)


def fold_taps(partial: torch.Tensor) -> torch.Tensor:
    """∂L/∂x [B, 1, H, W] from the per-tap sums [B, 9, H, W] of g · w_k:
    the adjoint of the edge-padded 3×3 gather (each tap added onto its
    clamped neighbour)."""
    b, _, h, w = partial.shape
    padded = partial.new_zeros(b, h + 2, w + 2)
    for k in range(TAPS):
        dy, dx = divmod(k, 3)
        padded[:, dy:dy + h, dx:dx + w] += partial[:, k]
    # Replicate padding's adjoint: the pad ring folds onto the border.
    padded[:, 1] += padded[:, 0]
    padded[:, h] += padded[:, h + 1]
    padded[:, :, 1] += padded[:, :, 0]
    padded[:, :, w] += padded[:, :, w + 1]
    return padded[:, None, 1:h + 1, 1:w + 1]


def convex_upsample_grad_plain(x, mask_logits, grad, dtype: torch.dtype):
    """Plain PyTorch version of K10: (∂L/∂x [B, 1, H, W] in x's dtype,
    ∂L/∂logits [B, 144, H, W] in `dtype`, rounded once) from the gradient
    `grad` [B, 1, 4H, 4W] of the upsampled map."""
    b, _, h, w = x.shape
    wt = torch.promote_types(_wide(mask_logits.dtype), x.dtype)
    weights = _softmax(mask_logits, wt)                             # [B,9,4,4,H,W]
    taps = neighbours(x.to(wt))[:, :, None, None]
    g = grad.to(wt).reshape(b, h, SCALE, w, SCALE).permute(0, 2, 4, 1, 3)[:, None]
    up = (taps * weights).sum(dim=1, keepdim=True)
    d_logits = (g * weights * (taps - up)).reshape(b, CHANNELS, h, w)
    d_x = fold_taps((g * weights).sum(dim=(2, 3)))
    return d_x.to(x.dtype), d_logits.to(dtype)


def _check(name: str, x, mask_logits, *more) -> None:
    """Raise unless the inputs lie on one CUDA device, are contiguous,
    x (and `more`) is float32 and the logits' dtype has a kernel."""
    tensors = (x, mask_logits, *more)
    dev = mask_logits.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: inputs on different devices")
    if mask_logits.dtype not in KERNELS:
        raise ValueError(f"{name}: needs float32 or bfloat16 logits, got {mask_logits.dtype}")
    if any(t.dtype != torch.float32 for t in (x, *more)):
        raise ValueError(f"{name}: the map and its gradient must be float32")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")


def launch_convex_upsample(x, mask_logits, out) -> None:
    """K9's bare launch (the kernel of the logits' dtype) into `out` [B,
    1, 4H, 4W] float32 on the current stream, for checked inputs. Counts
    nothing (the wrapper does)."""
    b, _, h, w = x.shape
    name = KERNELS[mask_logits.dtype][0]
    kernels.check_launch(name, kernels.function(name)(
        mask_logits.data_ptr(), x.data_ptr(), out.data_ptr(), b, h, w,
        torch.cuda.current_stream().cuda_stream))


def launch_convex_upsample_grad(x, mask_logits, grad, d_x, d_logits, partial) -> None:
    """K10's bare launch (both of its kernels, for the logits' dtype) on
    the current stream, for checked inputs: ∂logits into `d_logits` [B,
    144, H, W] and ∂x into `d_x` [B, 1, H, W] float32, through the
    float32 scratch `partial` [B, 9, H, W]. Counts nothing (the wrapper
    does)."""
    b, _, h, w = x.shape
    name = KERNELS[mask_logits.dtype][1]
    kernels.check_launch(name, kernels.function(name)(
        mask_logits.data_ptr(), x.data_ptr(), grad.data_ptr(), d_logits.data_ptr(),
        partial.data_ptr(), d_x.data_ptr(), b, h, w,
        torch.cuda.current_stream().cuda_stream))


def fold_is_programmatic() -> bool:
    """Whether K10 launches its fold (and its first kernel) as a
    programmatic dependent launch, a choice compiled into
    csrc/convex_upsample_grad.cu. Needs nvcc."""
    return bool(kernels.function("convex_upsample_grad_programmatic")())


def _forward(x: torch.Tensor, mask_logits: torch.Tensor) -> torch.Tensor:
    """K9 (or its plain version on the CPU)."""
    b, c, h, w = x.shape
    if c != 1 or tuple(mask_logits.shape) != (b, CHANNELS, h, w):
        raise ValueError(f"upsample_depth: needs x [B, 1, H, W] and mask logits "
                         f"[B, {CHANNELS}, H, W], got {tuple(x.shape)} and "
                         f"{tuple(mask_logits.shape)}")
    if mask_logits.device.type == "cpu":
        return convex_upsample_plain(x, mask_logits)
    _check("upsample_depth", x, mask_logits)
    out = torch.empty((b, 1, SCALE * h, SCALE * w), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        launch_convex_upsample(x, mask_logits, out)
    if mask_logits.dtype == torch.float32:
        upsample_depth.launches += 1
    else:
        upsample_depth.launches_bf16 += 1
    return out


def convex_upsample_grad(x, mask_logits, grad):
    """K10 (or its plain version on the CPU): (∂L/∂x float32, ∂L/∂logits
    in the logits' dtype)."""
    if mask_logits.device.type == "cpu":
        return convex_upsample_grad_plain(x, mask_logits, grad, mask_logits.dtype)
    grad = grad.float().contiguous()
    if grad.data_ptr() % 16:            # K10 reads g as float4
        grad = grad.clone()
    _check("convex_upsample_grad", x, mask_logits, grad)
    b, _, h, w = x.shape
    d_x = torch.empty_like(x)
    d_logits = torch.empty_like(mask_logits)
    partial = torch.empty((b, TAPS, h, w), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        launch_convex_upsample_grad(x, mask_logits, grad, d_x, d_logits, partial)
    if mask_logits.dtype == torch.float32:
        convex_upsample_grad.launches += 1
    else:
        convex_upsample_grad.launches_bf16 += 1
    return d_x, d_logits


class ConvexUpsample(torch.autograd.Function):
    """[B, 1, 4H, 4W] of x [B, 1, H, W] and mask logits [B, 144, H, W],
    differentiable in both: K9 forward, K10 backward (their plain
    versions on the CPU). Saves its inputs; the softmax is recomputed."""

    @staticmethod
    def forward(ctx, x, mask_logits):
        ctx.save_for_backward(x, mask_logits)
        return _forward(x, mask_logits)

    @staticmethod
    def backward(ctx, grad):
        x, mask_logits = ctx.saved_tensors
        return convex_upsample_grad(x, mask_logits, grad)


def upsample_depth(x: torch.Tensor, mask_logits: torch.Tensor) -> torch.Tensor:
    """The ×4 convex upsample [B, 1, 4H, 4W] float32 of x [B, 1, H, W]
    float32 under the 9-tap softmax of mask logits [B, 144, H, W]
    (float32 or bfloat16; on the card contiguous, never copied).
    Differentiable in both (ConvexUpsample)."""
    if torch.is_grad_enabled() and (x.requires_grad or mask_logits.requires_grad):
        return ConvexUpsample.apply(x, mask_logits)
    return _forward(x, mask_logits)


# Launches of the float32 and the bfloat16 kernels.
upsample_depth.launches = 0
upsample_depth.launches_bf16 = 0
convex_upsample_grad.launches = 0
convex_upsample_grad.launches_bf16 = 0
