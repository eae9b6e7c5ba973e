"""Bilinear resizing, NCHW (counterpart of itermvs_tpu/ops/resize.py), and
FeatureNet's FPN top-down add: kernels K19 `upsample2x_add` and its
backward K20 `upsample2x_grad`.

The JAX package's half-pixel bilinear resize with an edge-clamped upper
neighbour (`src = max((dst + 0.5)·in/out − 0.5, 0)`) is exactly
`F.interpolate(mode="bilinear", align_corners=False)` given an output
size, which computes the scale as in/out.

The FPN add (the counterpart of the XLA fusion of the resize's two
contractions and the add at itermvs_tpu/models/feature_net.py:98-102)
is, for x [N, C, h, w] and the lateral l [N, C, 2h, 2w] in the compute
dtype (float32 or bfloat16),
    out = round(up2(x)) + l          (the add in float32, rounded)
with up2 the ×2 resize above: each output row 2i + a (and column) reads
two rows of x, (i − 1, i) with weights (¼, ¾) for a = 0 (row 0: (0, 1)
with weights (1, 0)) and (i, min(i + 1, h − 1)) with (¾, ¼) for a = 1.
K19 computes it with PyTorch's CUDA formula for the resize, so that it is
bit-equal to the plain version on the card. Its backward K20 gathers
each ∂x pixel from its 4×4 window of ∂out with the transposed, separable
weights (rows 2i − 1, 2i, 2i + 1, 2i + 2: ¼, ¾, ¾, ¼; at row 0 the first
drops and the second is 1, at row h − 1 the last drops and the third is
1), summed in float64 and rounded once: no atomics, within one unit in
the last place of the exact sum. ∂l is ∂out itself.

On a CUDA tensor the wrappers launch the hand-written kernels
(csrc/upsample2x_add.cu, csrc/upsample2x_grad.cu, sharing
csrc/upsample2x.cuh) or raise; only a CPU tensor takes the plain PyTorch
versions beside them. K19's inputs must be contiguous NCHW of one dtype;
a ∂out that is not contiguous is copied once and counted on
`upsample2x_grad.copies`.

The model's other resizes (models/itermvs.py: the init sweep's view
weights and depth ×2, the hidden state ×2 then tanh, the reference
features of levels 1 and 3 to the 1/4 grid, ×½ and ×2, the confidence
×4) run K28 `resize_bilinear` (`resize`; its plain version
`resize_plain`: F.interpolate, then torch.tanh where asked) and, where a
gradient flows, its backward K29 `resize_bilinear_grad` (`resize_grad`,
through `ResizeBilinear`): ×2 with K20's 4×4 gather in float64, ×½ as
¼·∂out spread onto the 2×2 pixels below it (exact), each after
tanh_backward for the tanh form; any other ratio raises there. K28 is
bit-equal to its plain version on the card; K29 lies within one unit in
the last place of the float64 sum (×2) or equals PyTorch's backward (×½).
K28 takes any output size but the input's own, in float32 or bfloat16;
each batch entry of its input must be contiguous NCHW (the batch may be
strided: the reference view's slice of FeatureNet's output is read where
it lies), and a ∂out that is not contiguous is copied once and counted
on `resize_grad.copies` (the reference features' ∂out arrives
channels-last from the sweep's NHWC flatten: 2 copies per step).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from itermvs_tpu_torch import kernels

DTYPES = (torch.float32, torch.bfloat16)


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of [N, C, H, W] maps to (H_out, W_out)."""
    if tuple(x.shape[-2:]) == tuple(out_hw):
        return x
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                         align_corners=False)


def upsample_bilinear(x: torch.Tensor, scale: int) -> torch.Tensor:
    """×scale bilinear upsample of [N, C, H, W] maps."""
    return resize_bilinear(x, (x.shape[-2] * scale, x.shape[-1] * scale))


def upsample2x_add_plain(x: torch.Tensor, lateral: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K19: upsample_bilinear(x, 2) + lateral."""
    return upsample_bilinear(x, 2) + lateral


def _fold_last(g: torch.Tensor) -> torch.Tensor:
    """The ×2 resize's transposed weights along the last dimension: g's
    2n entries summed onto n (see the module docstring)."""
    even, odd = g[..., 0::2], g[..., 1::2]
    out = 0.75 * even + 0.75 * odd
    out[..., 1:] += 0.25 * odd[..., :-1]
    out[..., :-1] += 0.25 * even[..., 1:]
    out[..., 0] += 0.25 * even[..., 0]
    out[..., -1] += 0.25 * odd[..., -1]
    return out


def upsample2x_grad_plain(g: torch.Tensor, in_hw: tuple[int, int]) -> torch.Tensor:
    """Plain PyTorch version of K20: ∂x [N, C, h, w] of upsample_bilinear(x,
    2) for ∂out `g` [N, C, 2h, 2w], summed in float64 and rounded once to
    g's dtype."""
    _grad_shapes(g, in_hw)
    rows = _fold_last(_fold_last(g.double()).transpose(-1, -2)).transpose(-1, -2)
    return rows.to(g.dtype).contiguous()


def _grad_shapes(g, in_hw) -> None:
    h, w = in_hw
    if g.dim() != 4 or tuple(g.shape[-2:]) != (2 * h, 2 * w):
        raise ValueError(f"upsample2x_grad: ∂out {tuple(g.shape)} must be [N, C, {2 * h}, "
                         f"{2 * w}]")


def _shapes(x, lateral) -> None:
    if x.dim() != 4:
        raise ValueError(f"upsample2x_add: x {tuple(x.shape)} must be [N, C, h, w]")
    n, c, h, w = x.shape
    if tuple(lateral.shape) != (n, c, 2 * h, 2 * w):
        raise ValueError(f"upsample2x_add: lateral {tuple(lateral.shape)} must be "
                         f"[{n}, {c}, {2 * h}, {2 * w}]")


def _check(name, tensors) -> None:
    """Raise unless the tensors are contiguous, of one dtype of DTYPES, on
    one CUDA device."""
    dtype, device = tensors[0].dtype, tensors[0].device
    if dtype not in DTYPES or any(t.dtype != dtype for t in tensors):
        raise ValueError(f"{name}: needs one dtype of {DTYPES}, got "
                         f"{[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: needs contiguous NCHW tensors")
    if device.type != "cuda" or any(t.device != device for t in tensors):
        raise ValueError(f"{name}: needs the inputs on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def upsample2x_add_args(x, lateral, out) -> tuple:
    """K19's C arguments for checked inputs, writing `out`."""
    n, c, h, w = x.shape
    return x.data_ptr(), lateral.data_ptr(), out.data_ptr(), n * c, h, w, _stream()


def upsample2x_grad_args(g, d_x) -> tuple:
    """K20's C arguments for a checked ∂out `g`, writing `d_x` [N, C, h, w]."""
    n, c, h, w = d_x.shape
    return g.data_ptr(), d_x.data_ptr(), n * c, h, w, _stream()


def launch(name: str, dtype: torch.dtype, args: tuple) -> None:
    """Kernel `name`'s bare launch in `dtype` on its C arguments
    (`*_args`). Counts nothing (the wrappers do)."""
    kname = f"{name}_bf16" if dtype == torch.bfloat16 else name
    kernels.check_launch(kname, kernels.function(kname)(*args))


def _count(fn, dtype) -> None:
    if dtype == torch.bfloat16:
        fn.launches_bf16 += 1
    else:
        fn.launches += 1


def _forward(x, lateral):
    """K19 (or its plain version on the CPU)."""
    _shapes(x, lateral)
    if x.device.type == "cpu":
        return upsample2x_add_plain(x, lateral)
    _check("upsample2x_add", (x, lateral))
    out = torch.empty_like(lateral)
    with torch.cuda.device(x.device):
        launch("upsample2x_add", x.dtype, upsample2x_add_args(x, lateral, out))
    _count(upsample2x_add, x.dtype)
    return out


def upsample2x_grad(g: torch.Tensor, in_hw: tuple[int, int]) -> torch.Tensor:
    """K20 (or its plain version on the CPU): ∂x [N, C, h, w] for ∂out
    `g` [N, C, 2h, 2w], in g's dtype. A g that is not contiguous is copied
    once (`upsample2x_grad.copies`)."""
    _grad_shapes(g, in_hw)
    if g.device.type == "cpu":
        return upsample2x_grad_plain(g, in_hw)
    if not g.is_contiguous():
        g = g.contiguous()
        upsample2x_grad.copies += 1
    _check("upsample2x_grad", (g,))
    d_x = torch.empty(*g.shape[:2], *in_hw, dtype=g.dtype, device=g.device)
    with torch.cuda.device(g.device):
        launch("upsample2x_grad", g.dtype, upsample2x_grad_args(g, d_x))
    _count(upsample2x_grad, g.dtype)
    return d_x


class Upsample2xAdd(torch.autograd.Function):
    """K19 forward, K20 backward (their plain versions on the CPU); ∂l is
    ∂out as it comes. Saves nothing but x's size."""

    @staticmethod
    def forward(ctx, x, lateral):
        ctx.in_hw = tuple(x.shape[-2:])
        return _forward(x, lateral)

    @staticmethod
    def backward(ctx, grad):
        d_x = upsample2x_grad(grad, ctx.in_hw) if ctx.needs_input_grad[0] else None
        return d_x, grad if ctx.needs_input_grad[1] else None


def upsample2x_add(x: torch.Tensor, lateral: torch.Tensor) -> torch.Tensor:
    """upsample_bilinear(x, 2) + lateral for x [N, C, h, w] and lateral
    [N, C, 2h, 2w] of one dtype (float32 or bfloat16). Differentiable in
    both (Upsample2xAdd)."""
    if torch.is_grad_enabled() and (x.requires_grad or lateral.requires_grad):
        return Upsample2xAdd.apply(x, lateral)
    return _forward(x, lateral)


# Launches of each kernel's float32 and bfloat16 forms, and K20's copies of
# a ∂out that was not contiguous.
upsample2x_add.launches = upsample2x_add.launches_bf16 = 0
upsample2x_grad.launches = upsample2x_grad.launches_bf16 = 0
upsample2x_grad.copies = 0


def resize_plain(x: torch.Tensor, out_hw: tuple[int, int], tanh: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K28: F.interpolate to `out_hw`, then
    torch.tanh where `tanh`."""
    y = resize_bilinear(x, out_hw)
    return torch.tanh(y) if tanh else y


def _ratio(in_hw, out_hw) -> str:
    """"up2" where out_hw is twice in_hw, "down2" where it is half, else
    raise: K29 takes no other ratio."""
    (h, w), (oh, ow) = in_hw, out_hw
    if (oh, ow) == (2 * h, 2 * w):
        return "up2"
    if (2 * oh, 2 * ow) == (h, w):
        return "down2"
    raise ValueError(f"resize_grad: no backward from {tuple(out_hw)} to {tuple(in_hw)}: "
                     f"only ×2 and ×½ carry a gradient")


def resize_grad_plain(g: torch.Tensor, in_hw: tuple[int, int],
                      y: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of K29: ∂x [N, C, *in_hw] of resize_plain
    for ∂out `g` (and, for the tanh form, its output `y`): tanh_backward
    first, then ×2's float64 gather (`upsample2x_grad_plain`) or ×½'s
    exact spread of ¼·∂out, in g's dtype."""
    ratio = _ratio(in_hw, g.shape[-2:])
    if y is not None:
        g = torch.ops.aten.tanh_backward(g, y)
    if ratio == "up2":
        return upsample2x_grad_plain(g, in_hw)
    # PyTorch's atomic backward adds ¼·∂out, rounded, onto zeros.
    quarter = g * 0.25 + 0.0
    return quarter.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1).contiguous()


def resize_args(x, out, tanh) -> tuple:
    """K28's C arguments for a checked x (`batch_stride`), writing `out`."""
    n, c, h, w = x.shape
    return (x.data_ptr(), out.data_ptr(), n, c, batch_stride(x), h, w, *out.shape[-2:],
            int(tanh), _stream())


def batch_stride(x) -> int:
    """The elements between x's batch entries, where each entry [C, H, W]
    is contiguous (as the reference view's slice of FeatureNet's [B, V,
    C, H, W] output is); raise otherwise."""
    if x.shape[0] == 0 or not x[0].is_contiguous():
        raise ValueError(f"resize_bilinear: needs each batch entry of x {tuple(x.shape)} "
                         f"contiguous NCHW, got strides {x.stride()}")
    return x.stride(0) if x.shape[0] > 1 else x[0].numel()


def resize_grad_args(g, y, d_x) -> tuple:
    """K29's C arguments for a checked ∂out `g` (and output `y`, or None),
    writing `d_x` [N, C, h, w]."""
    n, c, h, w = d_x.shape
    up = _ratio((h, w), g.shape[-2:]) == "up2"
    return (g.data_ptr(), 0 if y is None else y.data_ptr(), d_x.data_ptr(), n * c, h, w,
            int(up), int(y is not None), _stream())


def _resize_shapes(x, out_hw) -> None:
    if x.dim() != 4 or len(out_hw) != 2 or min(out_hw) < 1:
        raise ValueError(f"resize: x {tuple(x.shape)} must be [N, C, H, W] and the size "
                         f"{tuple(out_hw)} (H_out, W_out)")
    if tuple(out_hw) == tuple(x.shape[-2:]):
        raise ValueError(f"resize: the size {tuple(out_hw)} is x's own")


def resize_forward(x: torch.Tensor, out_hw: tuple[int, int], tanh: bool = False) -> torch.Tensor:
    """K28 (or its plain version on the CPU): x [N, C, H, W] resized to
    `out_hw`, then tanh where `tanh`, in x's dtype. Not differentiable
    (`resize` is)."""
    _resize_shapes(x, out_hw)
    if x.device.type == "cpu":
        return resize_plain(x, out_hw, tanh)
    batch_stride(x)
    _check("resize_bilinear", (x[0],))
    out = torch.empty(*x.shape[:2], *out_hw, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        launch("resize_bilinear", x.dtype, resize_args(x, out, tanh))
    _count(resize_forward, x.dtype)
    return out


def resize_grad(g: torch.Tensor, in_hw: tuple[int, int],
                y: torch.Tensor | None = None) -> torch.Tensor:
    """K29 (or its plain version on the CPU): ∂x [N, C, *in_hw] for ∂out
    `g` of a ×2 or ×½ resize, after tanh_backward with the saved output
    `y` where it is given. A g that is not contiguous is copied once
    (`resize_grad.copies`)."""
    if g.dim() != 4 or (y is not None and y.shape != g.shape):
        raise ValueError(f"resize_grad: ∂out {tuple(g.shape)} must be [N, C, H, W]"
                         + ("" if y is None else f" and the output {tuple(y.shape)} alike"))
    _ratio(in_hw, g.shape[-2:])
    if g.device.type == "cpu":
        return resize_grad_plain(g, in_hw, y)
    if not g.is_contiguous():
        g = g.contiguous()
        resize_grad.copies += 1
    _check("resize_bilinear_grad", (g,) if y is None else (g, y))
    d_x = torch.empty(*g.shape[:2], *in_hw, dtype=g.dtype, device=g.device)
    with torch.cuda.device(g.device):
        launch("resize_bilinear_grad", g.dtype, resize_grad_args(g, y, d_x))
    _count(resize_grad, g.dtype)
    return d_x


class ResizeBilinear(torch.autograd.Function):
    """K28 forward, K29 backward (their plain versions on the CPU). Saves
    the output for the tanh form, else only x's size."""

    @staticmethod
    def forward(ctx, x, out_hw, tanh):
        y = resize_forward(x, out_hw, tanh)
        ctx.in_hw, ctx.tanh = tuple(x.shape[-2:]), tanh
        if tanh:
            ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        y = ctx.saved_tensors[0] if ctx.tanh else None
        return resize_grad(grad, ctx.in_hw, y), None, None


def resize(x: torch.Tensor, out_hw: tuple[int, int], tanh: bool = False) -> torch.Tensor:
    """Bilinear resize of x [N, C, H, W] (float32 or bfloat16) to
    `out_hw`, F.interpolate's (align_corners=False), then tanh where
    `tanh`. Differentiable in x for ×2 and ×½ (ResizeBilinear)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return ResizeBilinear.apply(x, tuple(out_hw), tanh)
    return resize_forward(x, out_hw, tanh)


# Launches of K28's and K29's float32 and bfloat16 forms, and K29's copies
# of a ∂out that was not contiguous.
resize_forward.launches = resize_forward.launches_bf16 = 0
resize_grad.launches = resize_grad.launches_bf16 = 0
resize_grad.copies = 0
