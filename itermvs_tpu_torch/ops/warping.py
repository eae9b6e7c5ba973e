"""Plane-sweep geometry (counterpart of itermvs_tpu/ops/warping.py).

`fused_sweep_taps` computes, for every (view, sample, pixel) of a sweep,
the clamped base-corner row index into the source feature map and the 4
bilinear tap weights; `sweep_premul` (ops/sweep.py) and `corr_epilogue`
(ops/sweep_epilogue.py) consume them. On a CUDA tensor it launches kernel
K8 `sweep_taps` (csrc/sweep_taps.cu, a float32 and a bfloat16 form) or
raises; only a CPU tensor takes the plain version,
`fused_sweep_taps_plain`, to which K8 is bit-equal. All of it is float32
arithmetic written out elementwise, so no product here goes through TF32
tensor cores whatever the backend flags say: projective coordinates
rounded to TF32 would cost sub-pixel accuracy. Only the taps are cast at
the end, to the gather table's dtype.

Semantics kept from the JAX package:
* the reference pixel grid is scaled into SOURCE-pixel units,
  `arange(w)·(w1/w)`, so level-1 sources at H/2 are sampled from the
  H/4 grid;
* behind-camera samples (z ≤ 1e-2) are remapped to the DEPTH-grid
  pixel (w, h) with z = 1;
* the clamped-base two-tap rule of `axis_taps`: the base is clamped into
  [0, size−1] and the weights move to the surviving in-bounds corner (or
  vanish), the +1 corner past the edge reading the zero fill.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from itermvs_tpu_torch import kernels

# K8's kernel per table dtype, and the samples its per-sample table holds.
TAPS_KERNELS = {torch.float32: "sweep_taps", torch.bfloat16: "sweep_taps_bf16"}
MAX_SAMPLES = 32


def device_constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """`torch.tensor(values, dtype=dtype)` on `device` without a host sync.

    `torch.tensor(..., device=cuda)` copies from pageable memory and then
    waits for the stream, which would stall the host in the middle of a
    forward (the eval loop dispatches the next map while the card still
    runs this one). On CUDA the values go through page-locked memory with
    a non-blocking copy instead; on the CPU this is `torch.tensor`."""
    host = torch.tensor(values, dtype=dtype)
    if torch.device(device).type == "cuda":
        host = host.pin_memory()
    return host.to(device, non_blocking=True)


def invert_projection(proj: torch.Tensor) -> torch.Tensor:
    """Analytic inverse of [..., 4, 4] projections with last row [0,0,0,1].

    `P = [[M, t], [0, 1]]`, `P⁻¹ = [[M⁻¹, −M⁻¹t], [0, 1]]` with M⁻¹ from
    the 3×3 adjugate — better conditioned in f32 than a generic 4×4 LU.
    """
    m = proj[..., :3, :3]
    t = proj[..., :3, 3]
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co_a = e * i - f * h
    co_b = c * h - b * i
    co_c = b * f - c * e
    co_d = f * g - d * i
    co_e = a * i - c * g
    co_f = c * d - a * f
    co_g = d * h - e * g
    co_h = b * g - a * h
    co_i = a * e - b * d
    det = a * co_a + b * co_d + c * co_g
    adj = torch.stack([
        torch.stack([co_a, co_b, co_c], dim=-1),
        torch.stack([co_d, co_e, co_f], dim=-1),
        torch.stack([co_g, co_h, co_i], dim=-1),
    ], dim=-2)
    m_inv = adj / det[..., None, None]
    t_inv = -(m_inv * t[..., None, :]).sum(dim=-1)
    top = torch.cat([m_inv, t_inv[..., None]], dim=-1)               # [..., 3, 4]
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def relative_projection(src_proj: torch.Tensor, ref_proj: torch.Tensor
                        ) -> torch.Tensor:
    """`src_proj @ inv(ref_proj)` for [..., 4, 4] stacks (broadcasting),
    as an elementwise f32 product-sum."""
    inv = invert_projection(ref_proj)
    return (src_proj[..., :, :, None] * inv[..., None, :, :]).sum(dim=-2)


def axis_taps(p: torch.Tensor, size: torch.Tensor):
    """Clamped gather base + 2-tap weights along one axis.

    For coordinate `p` the true corners are floor(p) (weight 1−frac) and
    floor(p)+1 (weight frac). The base is clamped into [0, size−1]:
      floor(p) in range  -> (1−frac, frac)
      floor(p) == −1     -> (frac, 0)   [only corner 0 is inside]
      both outside       -> (0, 0)
    A NaN or infinite coordinate (fusion projects depths of 0) gets zero
    weights and a valid base (`fmax` drops a NaN: NaN -> 0), so a gather
    at the base reads a real cell. `size` is a tensor broadcasting
    against `p`.
    """
    p0 = torch.floor(p)
    base = torch.minimum(torch.fmax(p0, p0.new_zeros(())), size - 1.0)
    frac = p - p0
    at_base = p0 == base
    zero = torch.zeros_like(p)
    w_a = torch.where(at_base, 1.0 - frac,
                      torch.where(p0 + 1.0 == base, frac, zero))
    w_b = torch.where(at_base, frac, zero)
    return base.to(torch.int32), w_a, w_b


def fused_sweep_taps_plain(rel_projs: torch.Tensor, depth_samples: torch.Tensor,
                           level_of_sample, src_hws,
                           table_dtype: torch.dtype = torch.float32):
    """Plain PyTorch version of K8: base-corner indices + bilinear taps for
    a multi-level, multi-view sweep, as one elementwise chain over
    [B, V, N, H·W].

    Args:
      rel_projs: [B, V, L, 4, 4] relative projections per (view, level).
      depth_samples: [B, N, H, W] depths, per-level stacks concatenated
        along the sample axis.
      level_of_sample: length-N sequence mapping sample → level index.
      src_hws: per-level (H_l, W_l) source-feature sizes.
      table_dtype: dtype of the gather tables (the source features). The
        taps are computed in float32 and cast to it, as the JAX package
        casts them, so that the gather's products stay in that dtype.

    Returns (flat_idx [B, V, N, H·W] int32 `by·W_l + bx`,
    taps [4, B, V, N, H·W] in `table_dtype`, in corner order
    (y, x), (y, x+1), (y+1, x), (y+1, x+1)).
    """
    b, n, h, w = depth_samples.shape
    dev = depth_samples.device
    f32 = torch.float32
    rot = rel_projs[..., :3, :3]                                  # [B,V,L,3,3]
    trans = rel_projs[..., :3, 3]                                 # [B,V,L,3]

    # Per-level reference grids in source-pixel units [L, HW].
    gxs, gys = [], []
    for h1, w1 in src_hws:
        xs = torch.arange(w, dtype=f32, device=dev) * (w1 / w)
        ys = torch.arange(h, dtype=f32, device=dev) * (h1 / h)
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        gxs.append(gx.reshape(h * w))
        gys.append(gy.reshape(h * w))
    gx = torch.stack(gxs)[None, None, :, :, None]                 # [1,1,L,HW,1]
    gy = torch.stack(gys)[None, None, :, :, None]
    # rot · (x, y, 1) per pixel, [B, V, L, HW, 3].
    rot_xyz = (rot[..., None, :, 0] * gx + rot[..., None, :, 1] * gy
               + rot[..., None, :, 2])

    level = device_constant(list(level_of_sample), torch.int64, dev)
    rot_s = rot_xyz[:, :, level]                                  # [B,V,N,HW,3]
    trans_s = trans[:, :, level][:, :, :, None, :]                # [B,V,N,1,3]
    proj_xyz = rot_s * depth_samples.reshape(b, 1, n, h * w, 1) + trans_s

    z = proj_xyz[..., 2]
    valid = z > 1e-2
    # Behind-camera samples land on (w, h) of the depth grid with z = 1.
    px = torch.where(valid, proj_xyz[..., 0], torch.full_like(z, float(w)))
    py = torch.where(valid, proj_xyz[..., 1], torch.full_like(z, float(h)))
    pz = torch.where(valid, z, torch.ones_like(z))
    # Stop-gradient, as in the JAX package: no gradient reaches the
    # sampling coordinates (nor the depths and projections behind them).
    px = (px / pz).detach()                                       # [B,V,N,HW]
    py = (py / pz).detach()

    sizes = device_constant([src_hws[l] for l in level_of_sample],
                            f32, dev)                             # [N, 2]
    size_y = sizes[:, 0].reshape(1, 1, n, 1)
    size_x = sizes[:, 1].reshape(1, 1, n, 1)
    bx, wx_a, wx_b = axis_taps(px, size_x)
    by, wy_a, wy_b = axis_taps(py, size_y)
    flat_idx = by * size_x.to(torch.int32) + bx
    taps = torch.stack([wy_a * wx_a, wy_a * wx_b, wy_b * wx_a, wy_b * wx_b])
    return flat_idx, taps.to(table_dtype)


class SampleTable(ctypes.Structure):
    """K8's per-sample table, passed to the kernel by value: each sample's
    level index, source size (H_l, W_l) and grid scales, the float32
    values of W_l / W and H_l / H (csrc/sweep_taps.cu `SampleTable`)."""
    _fields_ = [("level", ctypes.c_int * MAX_SAMPLES),
                ("height", ctypes.c_int * MAX_SAMPLES),
                ("width", ctypes.c_int * MAX_SAMPLES),
                ("scale_y", ctypes.c_float * MAX_SAMPLES),
                ("scale_x", ctypes.c_float * MAX_SAMPLES)]


def sample_table(level_of_sample, src_hws, h: int, w: int) -> SampleTable:
    """The SampleTable of a sweep over an h × w grid: the grid scales are
    the Python quotients the plain version multiplies by, which the
    c_float fields round to float32 as PyTorch rounds a scalar operand.
    Built once per sweep geometry and then shared: the kernel takes it by
    value, and nothing writes to it after it is built."""
    return _sample_table(tuple(level_of_sample), tuple(map(tuple, src_hws)), h, w)


@functools.lru_cache(maxsize=64)
def _sample_table(level_of_sample, src_hws, h: int, w: int) -> SampleTable:
    n = len(level_of_sample)
    if not 0 < n <= MAX_SAMPLES:
        raise ValueError(f"fused_sweep_taps: 1..{MAX_SAMPLES} samples, got {n}")
    table = SampleTable()
    for s, lvl in enumerate(level_of_sample):
        h1, w1 = src_hws[lvl]
        table.level[s], table.height[s], table.width[s] = lvl, h1, w1
        table.scale_y[s], table.scale_x[s] = h1 / h, w1 / w
    return table


def launch_sweep_taps(rel_projs, depth_samples, table: SampleTable, flat_idx, taps) -> None:
    """K8's bare launch (the kernel of `taps`' dtype) into `flat_idx` [B,
    V, N, H·W] int32 and `taps` [4, B, V, N, H·W] on the current stream,
    for checked inputs (`rel_projs` contiguous; `depth_samples` [B, N, H,
    W] of any strides). Counts nothing (the wrapper does)."""
    b, v, levels = rel_projs.shape[:3]
    n, h, w = depth_samples.shape[1:]
    name = TAPS_KERNELS[taps.dtype]
    kernels.check_launch(name, kernels.function(name)(
        rel_projs.data_ptr(), depth_samples.data_ptr(), flat_idx.data_ptr(),
        taps.data_ptr(), ctypes.byref(table), b, v, levels, n, h, w,
        *depth_samples.stride(), torch.cuda.current_stream().cuda_stream))


def fused_sweep_taps(rel_projs: torch.Tensor, depth_samples: torch.Tensor,
                     level_of_sample, src_hws, table_dtype: torch.dtype = torch.float32):
    """Base-corner indices + bilinear taps for a multi-level, multi-view
    sweep (`fused_sweep_taps_plain` gives the arguments and results): K8
    on a CUDA tensor, one launch per sweep; the plain version on the
    CPU. No gradient reaches the results."""
    dev = depth_samples.device
    if dev.type == "cpu":
        return fused_sweep_taps_plain(rel_projs, depth_samples, level_of_sample, src_hws,
                                      table_dtype)
    if dev.type != "cuda":
        raise ValueError(f"fused_sweep_taps: unsupported device {dev}")
    b, n, h, w = depth_samples.shape
    if (rel_projs.device != dev or rel_projs.dtype != torch.float32
            or depth_samples.dtype != torch.float32 or table_dtype not in TAPS_KERNELS):
        raise ValueError("fused_sweep_taps: needs float32 projections and depths on one "
                         "device and a float32 or bfloat16 table dtype")
    if (rel_projs.ndim != 5 or rel_projs.shape[0] != b or rel_projs.shape[3:] != (4, 4)
            or len(level_of_sample) != n or len(src_hws) != rel_projs.shape[2]):
        raise ValueError(f"fused_sweep_taps: projections {tuple(rel_projs.shape)}, "
                         f"{len(level_of_sample)} sample levels and {len(src_hws)} "
                         f"source sizes do not agree with depths {tuple(depth_samples.shape)}")
    strides = depth_samples.stride()
    reach = sum((size - 1) * st for size, st in zip((n, h, w), strides[1:]))
    if n * h * w >= 2 ** 31 or reach >= 2 ** 31:
        raise ValueError("fused_sweep_taps: a (batch, view) plane must have fewer than "
                         "2^31 outputs and depths within 2^31 elements")
    table = sample_table(level_of_sample, src_hws, h, w)
    v = rel_projs.shape[1]
    flat_idx = torch.empty((b, v, n, h * w), dtype=torch.int32, device=dev)
    taps = torch.empty((4, b, v, n, h * w), dtype=table_dtype, device=dev)
    with torch.cuda.device(dev):
        launch_sweep_taps(rel_projs.detach().contiguous(), depth_samples.detach(), table,
                          flat_idx, taps)
    if table_dtype == torch.float32:
        fused_sweep_taps.launches += 1
    else:
        fused_sweep_taps.launches_bf16 += 1
    return flat_idx, taps


# Launches of the float32 and the bfloat16 kernel.
fused_sweep_taps.launches = 0
fused_sweep_taps.launches_bf16 = 0
