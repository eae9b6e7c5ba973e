"""The init sweep's view weights, the tail of `PixelViewWeight` (the
counterpart of the XLA fusions at itermvs_tpu/models/itermvs.py:154-155 and
its ×2 resize at :255): kernels K30 `view_weight` and its backward K31
`view_weight_grad`.

For the last convolution's logits x [N, 32, h, w] (N = batch · sources,
the 32 init samples on dim 1) in the compute dtype:
    p  = softmax(float(x)) over the samples
    w  = max_d p_d                  [N, h, w]     float32 (K11 aggregates with it)
    up = upsample_bilinear(w, 2)    [N, 2h, 2w]   float32 (the iterations read it)
K30 writes both in one launch, each bit-equal on the card to the eager
chain it replaces (`view_weight_plain`: `.float()`, torch.softmax, amax,
F.interpolate). Only w carries a gradient: the iterations read up
detached. K31 takes ∂w and the saved logits and gives
    ∂p_d = ∂w / k at the k samples where p_d equals the max, else 0
    ∂x_d = p_d · (∂p_d − Σ_e ∂p_e · p_e)
(amax's backward splits its gradient evenly over the ties, as PyTorch's
and JAX's max do, counted on the float32 p the forward took its max
over), in float64, rounded once to x's dtype; `view_weight_grad_plain`
is the same evaluation in PyTorch. Ties are common: where a source view
does not see a pixel its logits are equal at every sample, and ∂w splits
32 ways.

On a CUDA tensor the wrappers launch the hand-written kernels
(csrc/view_weight.cu, csrc/view_weight_grad.cu, sharing
csrc/sample_softmax.cuh) or raise; only a CPU tensor takes the plain
versions beside them. x must be contiguous NCHW in float32 or bfloat16;
a ∂w that is not contiguous is copied once and counted on
`view_weight_grad.copies`.
"""
from __future__ import annotations

import torch

from itermvs_tpu_torch.ops.resize import _check, _count, _stream, launch, upsample_bilinear

SAMPLES = 32


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """softmax over the samples in float32 (float64 stays float64)."""
    return x.to(torch.promote_types(x.dtype, torch.float32)).softmax(1)


def view_weight_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K30: (w [N, h, w], w ×2 [N, 2h, 2w]),
    float32, from the logits x [N, 32, h, w]."""
    w = _softmax(x).amax(1)
    return w, upsample_bilinear(w[:, None], 2)[:, 0]


def view_weight_grad_plain(d_w: torch.Tensor, x: torch.Tensor,
                           dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain PyTorch version of K31: ∂x [N, 32, h, w] from ∂w [N, h, w],
    evaluated in float64 on the float32 softmax of x, ∂w split evenly over
    the samples where it equals its max; rounded to `dtype` (x's by
    default)."""
    p = _softmax(x)
    tie = p == p.amax(1, keepdim=True)
    g = torch.where(tie, d_w[:, None].double() / tie.sum(1, keepdim=True), 0.0)
    p = p.double()
    return (p * (g - (g * p).sum(1, keepdim=True))).to(dtype or x.dtype)


def _shapes(x, d_w=None) -> None:
    if x.dim() != 4 or x.shape[1] != SAMPLES:
        raise ValueError(f"view_weight: logits {tuple(x.shape)} must be [N, {SAMPLES}, h, w]")
    if d_w is not None and d_w.shape != (x.shape[0], *x.shape[2:]):
        raise ValueError(f"view_weight_grad: ∂w {tuple(d_w.shape)} must be "
                         f"[{x.shape[0]}, {x.shape[2]}, {x.shape[3]}]")


def view_weight_args(x, w, up) -> tuple:
    """K30's C arguments for checked logits x, writing w and up."""
    n, _, h, wd = x.shape
    return x.data_ptr(), w.data_ptr(), up.data_ptr(), n, h, wd, _stream()


def view_weight_grad_args(d_w, x, d_x) -> tuple:
    """K31's C arguments for a checked ∂w and logits x, writing d_x."""
    n, _, h, wd = x.shape
    return d_w.data_ptr(), x.data_ptr(), d_x.data_ptr(), n, h, wd, _stream()


def view_weight_forward(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K30 (or its plain version on the CPU): (w [N, h, w], w ×2 [N, 2h,
    2w]), float32, from the logits x [N, 32, h, w]. Not differentiable
    (`view_weight` is)."""
    _shapes(x)
    if x.device.type == "cpu":
        return view_weight_plain(x)
    _check("view_weight", (x,))
    n, _, h, wd = x.shape
    w = torch.empty(n, h, wd, dtype=torch.float32, device=x.device)
    up = torch.empty(n, 2 * h, 2 * wd, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        launch("view_weight", x.dtype, view_weight_args(x, w, up))
    _count(view_weight_forward, x.dtype)
    return w, up


def view_weight_grad(d_w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """K31 (or its plain version on the CPU): ∂x [N, 32, h, w] in x's
    dtype from ∂w [N, h, w] float32 and the logits x. A ∂w that is not
    contiguous is copied once (`view_weight_grad.copies`)."""
    _shapes(x, d_w)
    if x.device.type == "cpu":
        return view_weight_grad_plain(d_w, x)
    if d_w.dtype != torch.float32:
        raise ValueError(f"view_weight_grad: needs a float32 ∂w, got {d_w.dtype}")
    if not d_w.is_contiguous():
        d_w = d_w.contiguous()
        view_weight_grad.copies += 1
    _check("view_weight_grad", (x,))
    _check("view_weight_grad", (d_w,))
    if d_w.device != x.device:
        raise ValueError(f"view_weight_grad: ∂w on {d_w.device}, the logits on {x.device}")
    d_x = torch.empty_like(x)
    with torch.cuda.device(x.device):
        launch("view_weight_grad", x.dtype, view_weight_grad_args(d_w, x, d_x))
    _count(view_weight_grad, x.dtype)
    return d_x


class ViewWeight(torch.autograd.Function):
    """K30 forward, K31 backward (their plain versions on the CPU). Saves
    the logits; the ×2 output is not differentiable."""

    @staticmethod
    def forward(ctx, x):
        w, up = view_weight_forward(x)
        ctx.save_for_backward(x)
        ctx.mark_non_differentiable(up)
        return w, up

    @staticmethod
    def backward(ctx, d_w, _):
        return view_weight_grad(d_w, ctx.saved_tensors[0])


def view_weight(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """PixelViewWeight's tail: (w [N, h, w], w ×2 [N, 2h, 2w]), float32,
    from the logits x [N, 32, h, w] (float32 or bfloat16), w
    differentiable in x (ViewWeight)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return ViewWeight.apply(x)
    return view_weight_forward(x)


# Launches of K30's and K31's float32 and bfloat16 forms, and K31's copies
# of a ∂w that was not contiguous.
view_weight_forward.launches = view_weight_forward.launches_bf16 = 0
view_weight_grad.launches = view_weight_grad.launches_bf16 = 0
view_weight_grad.copies = 0
