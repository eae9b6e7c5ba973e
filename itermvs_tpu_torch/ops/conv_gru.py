"""The ConvGRU's elementwise work (the counterpart of the XLA fusions at
itermvs_tpu/models/blocks.py:176-183), and kernels K13 `gru_reset`, K14
`gru_update` and their backwards K15 `gru_update_grad`, K16
`gru_reset_grad`. The convolutions convz, convr and convq stay in cuDNN.

With hx = [h, x] [B, C, H, W] (h the hidden state [B, hidden, H, W])
and the logits z_l, r_l, q_l of convz(hx), convr(hx) and convq(rh_x):
    K13  rh_x = [σ(r_l) · h, x]                      (convq's input)
    K14  h'   = (1 − σ(z_l)) · h + σ(z_l) · tanh(q_l)
and, from g = ∂h' and G = ∂rh_x, with z, r and q recomputed from the
saved logits:
    K15  ∂z_l = σ'(g·q − g·h, z), ∂q_l = tanh'(g·z, q), ∂h = g·(1 − z)
    K16  ∂r_l = σ'(G[:hidden]·h, r), ∂hx = [G[:hidden]·r, G[hidden:]]
(σ' and tanh' are PyTorch's sigmoid_backward and tanh_backward).

Every intermediate is rounded to the compute dtype, float32 or bfloat16,
in the order eager PyTorch rounds it; so the kernels are bit-equal to the
plain versions here in float32 and in bfloat16.

On a CUDA tensor the wrappers launch the hand-written kernels
(csrc/gru_reset.cu, csrc/gru_update.cu, csrc/gru_update_grad.cu,
csrc/gru_reset_grad.cu, sharing csrc/conv_gru.cuh) or raise; only a CPU
tensor takes the plain PyTorch versions beside them. A kernel's inputs
must be contiguous NCHW of one dtype: nothing is copied.
"""
from __future__ import annotations

import torch

from itermvs_tpu_torch import kernels

DTYPES = (torch.float32, torch.bfloat16)


def gru_reset_plain(r_l: torch.Tensor, hx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K13: [σ(r_l) · h, x] [B, C, H, W]."""
    hidden = r_l.shape[1]
    return torch.cat([torch.sigmoid(r_l) * hx[:, :hidden], hx[:, hidden:]], dim=1)


def gru_update_plain(z_l: torch.Tensor, q_l: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K14: (1 − σ(z_l)) · h + σ(z_l) · tanh(q_l)."""
    z = torch.sigmoid(z_l)
    return (1.0 - z) * h + z * torch.tanh(q_l)


def gru_update_grad_plain(grad, z_l, q_l, h):
    """Plain PyTorch version of K15: (∂z_l, ∂q_l, ∂h) from ∂h' `grad`,
    as autograd computes them through gru_update_plain: ∂z's terms from
    z · q and from 1 − z, summed once."""
    z = torch.sigmoid(z_l)
    q = torch.tanh(q_l)
    d_z = grad * q + -(grad * h)
    return (torch.ops.aten.sigmoid_backward(d_z, z),
            torch.ops.aten.tanh_backward(grad * z, q), grad * (1.0 - z))


def gru_reset_grad_plain(grad, r_l, hx):
    """Plain PyTorch version of K16: (∂r_l, ∂hx) from ∂rh_x `grad`, as
    autograd computes them through gru_reset_plain."""
    hidden = r_l.shape[1]
    r = torch.sigmoid(r_l)
    g = grad[:, :hidden]
    d_r_l = torch.ops.aten.sigmoid_backward(g * hx[:, :hidden], r)
    return d_r_l, torch.cat([g * r, grad[:, hidden:]], dim=1)


def _shapes(name, tensors, shapes) -> None:
    got = [tuple(t.shape) for t in tensors]
    if got != [tuple(s) for s in shapes]:
        raise ValueError(f"{name}: shapes {got}, want {[tuple(s) for s in shapes]}")


def _check(name, tensors) -> None:
    """Raise unless the tensors are contiguous, of one dtype of DTYPES,
    on one CUDA device."""
    dtype, device = tensors[0].dtype, tensors[0].device
    if dtype not in DTYPES or any(t.dtype != dtype for t in tensors):
        raise ValueError(f"{name}: needs one dtype of {DTYPES}, got "
                         f"{[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: needs contiguous NCHW inputs")
    if device.type != "cuda" or any(t.device != device for t in tensors):
        raise ValueError(f"{name}: needs the inputs on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")


def _kernel(name: str, dtype: torch.dtype) -> str:
    return f"{name}_bf16" if dtype == torch.bfloat16 else name


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _reset_shapes(name, r_l, hx):
    """(B, hidden, C, H·W) of K13/K16; raises unless r_l is [B, hidden,
    H, W] and hx [B, C, H, W] with hidden < C."""
    if r_l.dim() != 4 or hx.dim() != 4 or r_l.shape[1] >= hx.shape[1] or (
            r_l.shape[0] != hx.shape[0] or r_l.shape[2:] != hx.shape[2:]):
        raise ValueError(f"{name}: r_l {tuple(r_l.shape)} must be [B, hidden, H, W] and "
                         f"hx {tuple(hx.shape)} [B, C, H, W] with hidden < C")
    b, hidden, h, w = r_l.shape
    return b, hidden, hx.shape[1], h * w


def gru_reset_args(r_l, hx, out) -> tuple:
    """K13's C arguments for checked inputs, writing `out`."""
    b, hidden, c, p = _reset_shapes("gru_reset", r_l, hx)
    return (r_l.data_ptr(), hx.data_ptr(), out.data_ptr(), b, hidden, c, p, _stream())


def gru_update_args(z_l, q_l, h, out) -> tuple:
    """K14's C arguments for checked inputs, writing `out`."""
    return (z_l.data_ptr(), q_l.data_ptr(), h.data_ptr(), out.data_ptr(), h.numel(),
            _stream())


def gru_update_grad_args(grad, z_l, q_l, h, d_z_l, d_q_l, d_h) -> tuple:
    """K15's C arguments for checked inputs, writing the three gradients."""
    return (grad.data_ptr(), z_l.data_ptr(), q_l.data_ptr(), h.data_ptr(), d_z_l.data_ptr(),
            d_q_l.data_ptr(), d_h.data_ptr(), h.numel(), _stream())


def gru_reset_grad_args(grad, r_l, hx, d_r_l, d_hx) -> tuple:
    """K16's C arguments for checked inputs, writing ∂r_l and ∂hx."""
    b, hidden, c, p = _reset_shapes("gru_reset_grad", r_l, hx)
    return (grad.data_ptr(), r_l.data_ptr(), hx.data_ptr(), d_r_l.data_ptr(),
            d_hx.data_ptr(), b, hidden, c, p, _stream())


def launch(name: str, dtype: torch.dtype, args: tuple) -> None:
    """Kernel `name`'s bare launch in `dtype` on its C arguments
    (`*_args`). Counts nothing (the wrappers do)."""
    kname = _kernel(name, dtype)
    kernels.check_launch(kname, kernels.function(kname)(*args))


def _count(fn, dtype) -> None:
    if dtype == torch.bfloat16:
        fn.launches_bf16 += 1
    else:
        fn.launches += 1


def _reset_forward(r_l, hx):
    """K13 (or its plain version on the CPU)."""
    _reset_shapes("gru_reset", r_l, hx)
    if r_l.device.type == "cpu":
        return gru_reset_plain(r_l, hx)
    _check("gru_reset", (r_l, hx))
    out = torch.empty_like(hx)
    with torch.cuda.device(r_l.device):
        launch("gru_reset", r_l.dtype, gru_reset_args(r_l, hx, out))
    _count(gru_reset, r_l.dtype)
    return out


def _update_forward(z_l, q_l, h):
    """K14 (or its plain version on the CPU)."""
    _shapes("gru_update", (z_l, q_l, h), (h.shape,) * 3)
    if h.device.type == "cpu":
        return gru_update_plain(z_l, q_l, h)
    _check("gru_update", (z_l, q_l, h))
    out = torch.empty_like(h)
    with torch.cuda.device(h.device):
        launch("gru_update", h.dtype, gru_update_args(z_l, q_l, h, out))
    _count(gru_update, h.dtype)
    return out


def gru_update_grad(grad, z_l, q_l, h):
    """K15 (or its plain version on the CPU): (∂z_l, ∂q_l, ∂h)."""
    _shapes("gru_update_grad", (grad, z_l, q_l, h), (h.shape,) * 4)
    if h.device.type == "cpu":
        return gru_update_grad_plain(grad, z_l, q_l, h)
    _check("gru_update_grad", (grad, z_l, q_l, h))
    outs = [torch.empty_like(h) for _ in range(3)]
    with torch.cuda.device(h.device):
        launch("gru_update_grad", h.dtype, gru_update_grad_args(grad, z_l, q_l, h, *outs))
    _count(gru_update_grad, h.dtype)
    return tuple(outs)


def gru_reset_grad(grad, r_l, hx):
    """K16 (or its plain version on the CPU): (∂r_l, ∂hx)."""
    _reset_shapes("gru_reset_grad", r_l, hx)
    _shapes("gru_reset_grad", (grad,), (hx.shape,))
    if hx.device.type == "cpu":
        return gru_reset_grad_plain(grad, r_l, hx)
    _check("gru_reset_grad", (grad, r_l, hx))
    d_r_l, d_hx = torch.empty_like(r_l), torch.empty_like(hx)
    with torch.cuda.device(hx.device):
        launch("gru_reset_grad", hx.dtype, gru_reset_grad_args(grad, r_l, hx, d_r_l, d_hx))
    _count(gru_reset_grad, hx.dtype)
    return d_r_l, d_hx


class GruReset(torch.autograd.Function):
    """[σ(r_l) · h, x] from r_l and hx = [h, x]: K13 forward, K16
    backward (their plain versions on the CPU). Saves r_l and hx (which
    convz and convr keep for their own backward)."""

    @staticmethod
    def forward(ctx, r_l, hx):
        ctx.save_for_backward(r_l, hx)
        return _reset_forward(r_l, hx)

    @staticmethod
    def backward(ctx, grad):
        return gru_reset_grad(grad, *ctx.saved_tensors)


class GruUpdate(torch.autograd.Function):
    """(1 − σ(z_l)) · h + σ(z_l) · tanh(q_l): K14 forward, K15 backward
    (their plain versions on the CPU). Saves the logits and h, no z or
    q."""

    @staticmethod
    def forward(ctx, z_l, q_l, h):
        ctx.save_for_backward(z_l, q_l, h)
        return _update_forward(z_l, q_l, h)

    @staticmethod
    def backward(ctx, grad):
        return gru_update_grad(grad, *ctx.saved_tensors)


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def gru_reset(r_l: torch.Tensor, hx: torch.Tensor) -> torch.Tensor:
    """convq's input [σ(r_l) · h, x] [B, C, H, W] from convr's logits
    `r_l` [B, hidden, H, W] and `hx` = [h, x] [B, C, H, W], in their dtype
    (float32 or bfloat16). Differentiable in both (GruReset)."""
    if _needs_grad(r_l, hx):
        return GruReset.apply(r_l, hx)
    return _reset_forward(r_l, hx)


def gru_update(z_l: torch.Tensor, q_l: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """The GRU's new hidden state (1 − σ(z_l)) · h + σ(z_l) · tanh(q_l)
    [B, hidden, H, W] from convz's and convq's logits and the hidden state
    `h`, all [B, hidden, H, W] of one dtype. Differentiable in all three
    (GruUpdate)."""
    if _needs_grad(z_l, q_l, h):
        return GruUpdate.apply(z_l, q_l, h)
    return _update_forward(z_l, q_l, h)


# Launches of each kernel's float32 and bfloat16 forms.
gru_reset.launches = gru_reset.launches_bf16 = 0
gru_update.launches = gru_update.launches_bf16 = 0
gru_update_grad.launches = gru_update_grad.launches_bf16 = 0
gru_reset_grad.launches = gru_reset_grad.launches_bf16 = 0
