"""The plane sweep as an autograd function: forward K2 `sweep_premul` →
K1 `corr_epilogue`, backward K4 `sweep_grad_ref` and K5 `sweep_grad_src`.

The JAX package differentiates `chunked_warp_corr` (itermvs_tpu/models/
itermvs.py: `gather_corners` of the `pack_bilinear` table, then
`group_corr`) with XLA's autodiff: a gather-multiply-reduce for the
reference features and a scatter-add for the source features. The
sampling coordinates are stop-gradient there (ops/warping.py
`fused_sweep_taps`), so base indices and taps get no gradient here.

With g' = grad_corr[b, s, grp(ch), pix] / (C/G), the transpose of the
group mean:
    d_ref[b, pix, ch]       = Σ_s Σ_k tap_k[b, s, pix] · src[b, y_k, x_k, ch] · g'
    d_src[b, y_k, x_k, ch] += tap_k[b, s, pix] · ref[b, pix, ch] · g'
A +1 corner past the edge read the zero fill in the forward pass and
gets no gradient.

`SweepCorr` saves only its inputs (src, ref, and the contiguous base and
taps), never the premultiplied block: at 640×512, batch 4, the init
sweep's block is 503 MB per view in f32. On CUDA tensors the backward
launches the hand-written kernels of the features' dtype
(csrc/sweep_grad_ref.cu, csrc/sweep_grad_src.cu; for bfloat16 features
and taps csrc/sweep_grad_ref_bf16.cu, csrc/sweep_grad_src_bf16.cu) or
raises; only CPU tensors take the plain versions beside them. grad_corr
is float32 in both modes, as the correlation is; d_src and d_ref come out
in the dtype of src and ref, summed in float32 and rounded once.
"""
from __future__ import annotations

import torch

from itermvs_tpu_torch import kernels
from itermvs_tpu_torch.ops.sweep import (
    pack_corners_plain, sample_chunks, sweep_premul, table_rows)
from itermvs_tpu_torch.ops.sweep_epilogue import corr_epilogue

# Per features' dtype: (K4's kernel, K5's kernel, channel multiple: one
# 16-byte vector lane).
KERNELS = {torch.float32: ("sweep_grad_ref", "sweep_grad_src", 4),
           torch.bfloat16: ("sweep_grad_ref_bf16", "sweep_grad_src_bf16", 8)}


def _wide(dtype: torch.dtype) -> torch.dtype:
    """The dtype the plain versions sum in: float32, or float64 for float64."""
    return torch.promote_types(dtype, torch.float32)


def _channel_grad(grad: torch.Tensor, c: int) -> torch.Tensor:
    """[B, n, G, HW] → g' per channel, [B, n, HW, C]."""
    groups = grad.shape[2]
    cg = c // groups
    return (grad / cg).permute(0, 1, 3, 2).repeat_interleave(cg, dim=-1)


def sweep_grad_ref_plain(src: torch.Tensor, base: torch.Tensor,
                         taps: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K4: corner rows by `index_select`, the tap
    sum, then g' and the sum over samples, in float32 (float64 for float64
    inputs), rounded once to src's dtype. [B, HW, C]."""
    b, h1, w1, c = src.shape
    n, hw = grad.shape[1], grad.shape[3]
    wide = _wide(src.dtype)
    vals = pack_corners_plain(src.to(wide)).index_select(
        0, table_rows(base, h1 * w1)).reshape(b, n, hw, 4, c)
    t = taps.to(wide).permute(1, 2, 0).reshape(b, n, hw, 4, 1)
    d_ref = ((vals * t).sum(dim=3) * _channel_grad(grad.to(wide), c)).sum(dim=1)
    return d_ref.to(src.dtype)


def sweep_grad_src_plain(ref: torch.Tensor, base: torch.Tensor,
                         taps: torch.Tensor, grad: torch.Tensor,
                         h1: int, w1: int) -> torch.Tensor:
    """Plain PyTorch version of K5: the corner products `index_add_`-ed
    into the zero-filled 4-corner table, which is then unpacked onto the
    source grid (entries of +1 corners past the edge dropped), in float32
    (float64 for float64 inputs), rounded once to ref's dtype.
    [B, H1, W1, C]."""
    b, hw, c = ref.shape
    n = grad.shape[1]
    wide = _wide(ref.dtype)
    t = taps.to(wide).permute(1, 2, 0).reshape(b, n, hw, 4, 1)
    rg = (ref.to(wide).reshape(b, 1, hw, c) * _channel_grad(grad.to(wide), c)
          ).reshape(b, n, hw, 1, c)
    table = torch.zeros(b * h1 * w1, 4 * c, dtype=wide, device=ref.device)
    table.index_add_(0, table_rows(base, h1 * w1), (t * rg).reshape(-1, 4 * c))
    table = table.reshape(b, h1, w1, 4, c)
    d_src = table[..., 0, :].clone()
    d_src[:, :, 1:] += table[:, :, :-1, 1]
    d_src[:, 1:, :] += table[:, :-1, :, 2]
    d_src[:, 1:, 1:] += table[:, :-1, :-1, 3]
    return d_src.to(ref.dtype)


def _check(name, tensors, c, groups):
    """Raise unless (features, base, taps, grad) suit the kernels: on one
    CUDA device, contiguous, float32 or bfloat16 features with taps of
    their dtype, int32 base, float32 grad, C a multiple of the vector
    lane."""
    feats, base, taps, grad = tensors
    dev = feats.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: inputs on different devices")
    if (feats.dtype not in KERNELS or taps.dtype != feats.dtype
            or base.dtype != torch.int32 or grad.dtype != torch.float32):
        raise ValueError(f"{name}: needs float32 or bfloat16 features with taps of "
                         "their dtype, int32 base, float32 grad")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")
    lane = KERNELS[feats.dtype][2]
    if c % lane or c > 1024 or c % groups or feats.data_ptr() % 16:
        raise ValueError(f"{name}: needs C % {lane} == 0, C <= 1024, C % G == 0 and "
                         "16-byte aligned features")


def _shapes(name, base, taps, grad, b, hw):
    n = grad.shape[1]
    if (grad.ndim != 4 or grad.shape[0] != b or grad.shape[3] != hw
            or tuple(base.shape) != (b, n * hw) or tuple(taps.shape) != (4, b, n * hw)):
        raise ValueError(f"{name}: shapes base {tuple(base.shape)}, taps "
                         f"{tuple(taps.shape)}, grad {tuple(grad.shape)} do not "
                         f"agree for batch {b}, HW {hw}")


def launch_sweep_grad_ref(src, base, taps, grad, out) -> None:
    """K4's bare launch (the kernel of src's dtype) into `out` [B, HW, C]
    on the current stream, for checked inputs; counts nothing (the
    wrapper does)."""
    b, h1, w1, c = src.shape
    n, groups, hw = grad.shape[1], grad.shape[2], grad.shape[3]
    name = KERNELS[src.dtype][0]
    kernels.check_launch(name, kernels.function(name)(
        src.data_ptr(), base.data_ptr(), taps.data_ptr(), grad.data_ptr(),
        out.data_ptr(), b, n, hw, h1, w1, c, groups,
        torch.cuda.current_stream().cuda_stream))


def launch_sweep_grad_src(ref, base, taps, grad, out, scratch=None) -> None:
    """K5's bare launch (the kernel of ref's dtype) into `out` [B, H1, W1,
    C] on the current stream, for checked inputs: its zero fill and its
    kernel. The bfloat16 kernel sums into `scratch`, a float32 tensor of
    out's shape, and rounds it into `out` once. Counts nothing (the
    wrapper does)."""
    b, hw, c = ref.shape
    h1, w1 = out.shape[1], out.shape[2]
    n, groups = grad.shape[1], grad.shape[2]
    name = KERNELS[ref.dtype][1]
    stream = torch.cuda.current_stream().cuda_stream
    args = (ref.data_ptr(), base.data_ptr(), taps.data_ptr(), grad.data_ptr())
    if ref.dtype == torch.float32:
        status = kernels.function(name)(*args, out.data_ptr(), b, n, hw, h1, w1, c,
                                        groups, stream)
    else:
        if (scratch is None or scratch.dtype != torch.float32
                or scratch.shape != out.shape or not scratch.is_contiguous()):
            raise ValueError(f"{name}: needs a contiguous float32 scratch of the "
                             "output's shape")
        status = kernels.function(name)(*args, scratch.data_ptr(), out.data_ptr(), b, n,
                                        hw, h1, w1, c, groups, stream)
    kernels.check_launch(name, status)


def sweep_grad_ref(src: torch.Tensor, base: torch.Tensor, taps: torch.Tensor,
                   grad: torch.Tensor) -> torch.Tensor:
    """K4: d_ref [B, HW, C] in src's dtype from src [B, H1, W1, C], base
    [B, n·HW] int32, taps [4, B, n·HW] in src's dtype and float32
    grad_corr [B, n, G, HW]."""
    b, h1, w1, c = src.shape
    _shapes("sweep_grad_ref", base, taps, grad, b, grad.shape[-1])
    if src.device.type == "cpu":
        return sweep_grad_ref_plain(src, base, taps, grad)
    _check("sweep_grad_ref", (src, base, taps, grad), c, grad.shape[2])
    out = torch.empty((b, grad.shape[3], c), dtype=src.dtype, device=src.device)
    with torch.cuda.device(src.device):
        launch_sweep_grad_ref(src, base, taps, grad, out)
    if src.dtype == torch.float32:
        sweep_grad_ref.launches += 1
    else:
        sweep_grad_ref.launches_bf16 += 1
    return out


def sweep_grad_src(ref: torch.Tensor, base: torch.Tensor, taps: torch.Tensor,
                   grad: torch.Tensor, h1: int, w1: int) -> torch.Tensor:
    """K5: d_src [B, H1, W1, C] in ref's dtype from ref [B, HW, C], base
    [B, n·HW] int32, taps [4, B, n·HW] in ref's dtype and float32
    grad_corr [B, n, G, HW]. On the card the sum runs in float32 float4
    atomics (for bfloat16, into a float32 scratch rounded once at the
    end), so its last bits change from run to run."""
    b, hw, c = ref.shape
    _shapes("sweep_grad_src", base, taps, grad, b, hw)
    if ref.device.type == "cpu":
        return sweep_grad_src_plain(ref, base, taps, grad, h1, w1)
    _check("sweep_grad_src", (ref, base, taps, grad), c, grad.shape[2])
    out = torch.empty((b, h1, w1, c), dtype=ref.dtype, device=ref.device)
    scratch = (None if ref.dtype == torch.float32
               else torch.empty(out.shape, dtype=torch.float32, device=ref.device))
    with torch.cuda.device(ref.device):
        launch_sweep_grad_src(ref, base, taps, grad, out, scratch)
    if ref.dtype == torch.float32:
        sweep_grad_src.launches += 1
    else:
        sweep_grad_src.launches_bf16 += 1
    return out


# Launches of the float32 and the bfloat16 kernels.
sweep_grad_ref.launches = 0
sweep_grad_ref.launches_bf16 = 0
sweep_grad_src.launches = 0
sweep_grad_src.launches_bf16 = 0


class SweepCorr(torch.autograd.Function):
    """Group correlation of one (view, level) sweep, [B, n, G, HW].

    forward(src [B, H1, W1, C], ref [B, HW, C], flat_idx [B, n, HW] int32,
    taps [4, B, n, HW], groups), features and taps of one dtype (float32
    or bfloat16), corr float32: K2 → K1, split on sample boundaries only
    where the premul block would exceed `ops.sweep.PREMUL_BUDGET_BYTES`.
    backward: K4 for d_ref and K5 for d_src over all samples at once (they
    keep no premul block); no gradient for the indices and taps."""

    @staticmethod
    def forward(ctx, src, ref, flat_idx, taps, groups):
        b, n, hw = flat_idx.shape
        c = src.shape[-1]
        base = flat_idx.reshape(b, n * hw).contiguous()
        taps = taps.reshape(4, b, n * hw).contiguous()
        outs = []
        for s0, s1 in sample_chunks(b, n, hw, c, itemsize=src.element_size()):
            m = s1 - s0
            premul = sweep_premul(src, base[:, s0 * hw:s1 * hw].contiguous(),
                                  taps[:, :, s0 * hw:s1 * hw].contiguous(), ref, m)
            corr = corr_epilogue(premul.reshape(b * m * hw, 4 * c), b * m, groups)
            outs.append(corr.reshape(groups, b, m, hw))
        corr = outs[0] if len(outs) == 1 else torch.cat(outs, dim=2)
        ctx.save_for_backward(src, ref, base, taps)
        return corr.permute(1, 2, 0, 3).contiguous()

    @staticmethod
    def backward(ctx, grad):
        src, ref, base, taps = ctx.saved_tensors
        grad = grad.contiguous()
        d_src = d_ref = None
        if ctx.needs_input_grad[0]:
            d_src = sweep_grad_src(ref, base, taps, grad, src.shape[1], src.shape[2])
        if ctx.needs_input_grad[1]:
            d_ref = sweep_grad_ref(src, base, taps, grad)
        return d_src, d_ref, None, None, None
