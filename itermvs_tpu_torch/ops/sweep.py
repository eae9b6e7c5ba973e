"""Kernel K2, `sweep_premul`: the plane sweep's bilinear corner gather,
premultiplied by the tap weights and the reference features.

Counterpart of the JAX chain `gather_corners` (itermvs_tpu/ops/
grid_sample.py, flat 4-corner table) followed by `premultiply`
(itermvs_tpu/ops/sweep_epilogue.py). It reads the unpacked NHWC source
at (base, base+1) on each axis; a +1 corner past the edge reads 0, the
zero fill of `pack_corners`. The output `[B, P, 4C]` (corner order
(y, x), (y, x+1), (y+1, x), (y+1, x+1)) feeds K1 `corr_epilogue`, which
turns it into the group correlation.

Sources, taps, references and premul share one dtype: float32, or
bfloat16 (the JAX package's bf16 mode, whose gather and premultiply run
in the table dtype). On a CUDA tensor the wrapper launches the
hand-written kernel of that dtype (csrc/sweep_premul.cu,
csrc/sweep_premul_bf16.cu) or raises; only CPU tensors take the plain
PyTorch version beside it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from itermvs_tpu_torch import kernels

# Largest premul block one (view, level) sweep writes before it is split
# on sample boundaries. The biggest block of the model at 1600x1152 (the
# init sweep, [921600, 192] per view) is 708 MB in f32 and 354 MB in
# bf16, so that size runs unsplit: 52 launches of each kernel per depth
# map with 5 views.
PREMUL_BUDGET_BYTES = 1 << 30
# Per dtype: (kernel name, channel multiple: one 16-byte vector lane).
KERNELS = {torch.float32: ("sweep_premul", 4), torch.bfloat16: ("sweep_premul_bf16", 8)}


def sample_chunks(batch: int, n: int, hw: int, c: int, budget: int | None = None,
                  itemsize: int = 4) -> list[tuple[int, int]]:
    """Sample ranges [s0, s1) whose premul block ([batch, (s1-s0)*hw, 4c]
    of `itemsize`-byte elements: 4 for f32, 2 for bf16) stays within
    `budget` bytes (default `PREMUL_BUDGET_BYTES`); one sample is the
    least a chunk holds."""
    if budget is None:
        budget = PREMUL_BUDGET_BYTES
    per_sample = batch * hw * 4 * c * itemsize
    chunk = max(1, min(n, budget // per_sample))
    return [(s0, min(s0 + chunk, n)) for s0 in range(0, n, chunk)]


def pack_corners_plain(src: torch.Tensor) -> torch.Tensor:
    """The zero-filled 4-corner table [B·H1·W1, 4C] of an NHWC source:
    row (b, y, x) holds src at (y, x), (y, x+1), (y+1, x), (y+1, x+1)."""
    b, h1, w1, c = src.shape
    sx = F.pad(src[:, :, 1:], (0, 0, 0, 1))
    sy = F.pad(src[:, 1:], (0, 0, 0, 0, 0, 1))
    sxy = F.pad(src[:, 1:, 1:], (0, 0, 0, 1, 0, 1))
    return torch.cat([src, sx, sy, sxy], dim=-1).reshape(b * h1 * w1, 4 * c)


def table_rows(base: torch.Tensor, cells: int) -> torch.Tensor:
    """Flat rows into a batch of `cells`-row tables for [B, P] base indices."""
    offs = torch.arange(base.shape[0], device=base.device).reshape(-1, 1) * cells
    return (base.long() + offs).reshape(-1)


def sweep_premul_plain(src: torch.Tensor, base: torch.Tensor,
                       taps: torch.Tensor, ref: torch.Tensor, n: int
                       ) -> torch.Tensor:
    """Plain PyTorch version: zero-filled corner pack, row `index_select`,
    then the tap and reference products (in that order), each rounded to
    the inputs' dtype."""
    b, h1, w1, c = src.shape
    hw = ref.shape[1]
    packed = pack_corners_plain(src)
    vals = packed.index_select(0, table_rows(base, h1 * w1)).reshape(b, n, hw, 4, c)
    t = taps.permute(1, 2, 0).reshape(b, n, hw, 4, 1)
    r = ref.reshape(b, 1, hw, 1, c)
    return (vals * t * r).reshape(b, n * hw, 4 * c)


def sweep_premul(src: torch.Tensor, base: torch.Tensor, taps: torch.Tensor,
                 ref: torch.Tensor, n: int) -> torch.Tensor:
    """Gather + premultiply for one (view, level) sweep.

    Args:
      src: [B, H1, W1, C] NHWC source features, float32 (C % 4 == 0) or
        bfloat16 (C % 8 == 0).
      base: [B, P] int32 base-corner indices `by*W1 + bx`, P = n*HW,
        rows sample-major.
      taps: [4, B, P] bilinear tap weights, corner-major, src's dtype.
      ref: [B, HW, C] reference features, src's dtype.
      n: sample count.

    Returns premul [B, P, 4C] in src's dtype.
    """
    b, h1, w1, c = src.shape
    hw = ref.shape[1]
    p = n * hw
    if (tuple(base.shape) != (b, p) or tuple(taps.shape) != (4, b, p)
            or tuple(ref.shape) != (b, hw, c)):
        raise ValueError(
            f"sweep_premul: shapes src {tuple(src.shape)}, base "
            f"{tuple(base.shape)}, taps {tuple(taps.shape)}, ref "
            f"{tuple(ref.shape)} do not agree for n={n}")
    if src.device.type == "cpu":
        return sweep_premul_plain(src, base, taps, ref, n)
    if src.device.type != "cuda":
        raise ValueError(f"sweep_premul: unsupported device {src.device}")
    tensors = (src, base, taps, ref)
    if any(t.device != src.device for t in tensors):
        raise ValueError("sweep_premul: inputs on different devices")
    if (src.dtype not in KERNELS or base.dtype != torch.int32
            or taps.dtype != src.dtype or ref.dtype != src.dtype):
        raise ValueError("sweep_premul: needs float32 or bfloat16 src/taps/ref of "
                         "one dtype, int32 base")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("sweep_premul: inputs must be contiguous")
    name, lane = KERNELS[src.dtype]
    if c % lane or c > 256 or src.data_ptr() % 16 or ref.data_ptr() % 16:
        raise ValueError(f"sweep_premul: needs C % {lane} == 0, C <= 256 and "
                         "16-byte aligned src/ref")
    out = torch.empty((b, p, 4 * c), dtype=src.dtype, device=src.device)
    fn = kernels.function(name)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        kernels.check_launch(name, fn(
            src.data_ptr(), base.data_ptr(), taps.data_ptr(), ref.data_ptr(),
            out.data_ptr(), b, p, hw, h1, w1, c, stream))
    if src.dtype == torch.float32:
        sweep_premul.launches += 1
    else:
        sweep_premul.launches_bf16 += 1
    return out


# Launches of the float32 and the bfloat16 kernel.
sweep_premul.launches = 0
sweep_premul.launches_bf16 = 0
