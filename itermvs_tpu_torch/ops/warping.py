"""Plane-sweep geometry (counterpart of itermvs_tpu/ops/warping.py).

`fused_sweep_taps` computes, for every (view, sample, pixel) of a sweep,
the clamped base-corner row index into the source feature map and the 4
bilinear tap weights; `sweep_premul` (ops/sweep.py) and `corr_epilogue`
(ops/sweep_epilogue.py) consume them. All of it is float32 arithmetic
written out elementwise, so no product here goes through TF32 tensor
cores whatever the backend flags say: projective coordinates rounded to
TF32 would cost sub-pixel accuracy.

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

import torch


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


def fused_sweep_taps(rel_projs: torch.Tensor, depth_samples: torch.Tensor,
                     level_of_sample, src_hws):
    """Base-corner indices + bilinear taps for a multi-level, multi-view
    sweep, as one elementwise chain over [B, V, N, H·W].

    Args:
      rel_projs: [B, V, L, 4, 4] relative projections per (view, level).
      depth_samples: [B, N, H, W] depths, per-level stacks concatenated
        along the sample axis.
      level_of_sample: length-N sequence mapping sample → level index.
      src_hws: per-level (H_l, W_l) source-feature sizes.

    Returns (flat_idx [B, V, N, H·W] int32 `by·W_l + bx`,
    taps [4, B, V, N, H·W] float32 in corner order
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

    level = torch.as_tensor(list(level_of_sample), device=dev)
    rot_s = rot_xyz[:, :, level]                                  # [B,V,N,HW,3]
    trans_s = trans[:, :, level][:, :, :, None, :]                # [B,V,N,1,3]
    proj_xyz = rot_s * depth_samples.reshape(b, 1, n, h * w, 1) + trans_s

    z = proj_xyz[..., 2]
    valid = z > 1e-2
    # Behind-camera samples land on (w, h) of the depth grid with z = 1.
    px = torch.where(valid, proj_xyz[..., 0], torch.full_like(z, float(w)))
    py = torch.where(valid, proj_xyz[..., 1], torch.full_like(z, float(h)))
    pz = torch.where(valid, z, torch.ones_like(z))
    px = px / pz                                                  # [B,V,N,HW]
    py = py / pz

    sizes = torch.as_tensor([src_hws[l] for l in level_of_sample],
                            dtype=f32, device=dev)                # [N, 2]
    size_y = sizes[:, 0].reshape(1, 1, n, 1)
    size_x = sizes[:, 1].reshape(1, 1, n, 1)
    bx, wx_a, wx_b = axis_taps(px, size_x)
    by, wy_a, wy_b = axis_taps(py, size_y)
    flat_idx = by * size_x.to(torch.int32) + bx
    taps = torch.stack([wy_a * wx_a, wy_a * wx_b, wy_b * wx_a, wy_b * wx_b])
    return flat_idx, taps
