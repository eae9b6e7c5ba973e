"""Kernel K3, `fusion_consistency`: the geometric and photometric check of
one reference depth map against its source depth maps.

Counterpart of the jitted XLA chain `itermvs_tpu/fusion.py::
_consistency_kernel`, with its arguments (less `src_valid`: the port
passes the real source count S, so there is no padded slot to mask) and
its results, split as the card runs them: `consistency` returns the
averaged depth [H, W] f32 and the mask bits [H, W] u8 (bit0 photo, bit1
geo, bit2 final); `quantize_depth` then rounds the map to uint16 against
its own [lo, hi] with torch ops (eval.py's result wire rounds with it too).

On a CUDA tensor the wrapper packs the matrices into the kernel's record
(`record`), uploads it without waiting for the stream, and launches the
hand-written kernel (csrc/fusion_consistency.cu, `launch_consistency`)
or raises; only CPU tensors take the plain PyTorch version beside it.
The plain version is written elementwise, as `ops/warping.py::
fused_sweep_taps` is, so no matmul (and no TF32) touches the projective
geometry; it sums the sources in order, as the kernel does.
"""
from __future__ import annotations

import torch

from itermvs_tpu_torch import kernels
from itermvs_tpu_torch.ops.warping import axis_taps

# The kernel's record of matrices (see `record`), staged in shared memory
# by each block: a head of K_ref and K_ref^-1, then one padded block per
# source.
HEAD_FLOATS = 24
SOURCE_FLOATS = 48
MAX_SOURCES = 256


def sample_bilinear_zeros(maps: torch.Tensor, px: torch.Tensor,
                          py: torch.Tensor) -> torch.Tensor:
    """Zero-padded bilinear sample of maps [S, H, W] at [S, P] pixel
    coordinates: the values of JAX `gather_bilinear(pack_corners(...))`
    (corners (y, x), (y, x+1), (y+1, x), (y+1, x+1) summed in that order,
    a +1 corner past the edge reading 0). A NaN or infinite coordinate
    (a depth of 0 projects to one) samples 0. Returns [S, P]."""
    s, h, w = maps.shape
    bx, wx_a, wx_b = axis_taps(px, px.new_tensor(float(w)))
    by, wy_a, wy_b = axis_taps(py, py.new_tensor(float(h)))
    padded = torch.nn.functional.pad(maps, (0, 1, 0, 1)).reshape(s, (h + 1) * (w + 1))
    idx = by.long() * (w + 1) + bx.long()

    def corner(off):
        return torch.gather(padded, 1, idx + off)

    return (corner(0) * (wy_a * wx_a) + corner(1) * (wy_a * wx_b)
            + corner(w + 1) * (wy_b * wx_a) + corner(w + 2) * (wy_b * wx_b))


def _rows(m: torch.Tensor, row: int, *vec):
    """Row `row` of the [S, 3, k] matrices times a vector, summed left to
    right: m[:, row, 0]*v0 + m[:, row, 1]*v1 + ... (each [S, 1] * [.., P])."""
    out = None
    for j, v in enumerate(vec):
        term = m[:, row, j, None] * v
        out = term if out is None else out + term
    return out


def consistency_plain(ref_depth, confidence, src_depths, rel_ref_to_src,
                      rel_src_to_ref, k_ref, k_ref_inv, k_srcs, k_srcs_inv,
                      geo_pixel_thres, geo_depth_thres, photo_thres,
                      geo_mask_thres):
    """Plain PyTorch version of K3: the JAX chain's math, elementwise f32,
    sources accumulated in order. Returns (depth_avg [H, W] f32, bits
    [H, W] u8)."""
    h, w = ref_depth.shape
    s = src_depths.shape[0]
    dev = ref_depth.device
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    gx, gy = gx.reshape(1, -1), gy.reshape(1, -1)
    d = ref_depth.reshape(1, -1)
    kri = k_ref_inv[None]
    xyz_ref = [_rows(kri, i, gx, gy) + kri[:, i, 2, None] for i in range(3)]
    xyz_ref = [c * d for c in xyz_ref]                              # [1, P]

    r2s = rel_ref_to_src[:, :3]
    xyz_src = [_rows(r2s, i, *xyz_ref) + r2s[:, i, 3, None] for i in range(3)]
    k_xyz = [_rows(k_srcs, i, *xyz_src) for i in range(3)]          # [S, P]
    px = k_xyz[0] / k_xyz[2]                # no epsilon (fusion.py:112)
    py = k_xyz[1] / k_xyz[2]
    sampled = sample_bilinear_zeros(src_depths, px, py)

    xyz2 = [(_rows(k_srcs_inv, i, px, py) + k_srcs_inv[:, i, 2, None]) * sampled
            for i in range(3)]
    s2r = rel_src_to_ref[:, :3]
    xyz_rep = [_rows(s2r, i, *xyz2) + s2r[:, i, 3, None] for i in range(3)]
    kr = k_ref[None]
    k_rep = [_rows(kr, i, *xyz_rep) for i in range(3)]
    z_rep = k_rep[2] + 1e-6                 # (fusion.py:130)
    dx = k_rep[0] / z_rep - gx
    dy = k_rep[1] / z_rep - gy
    dist = torch.sqrt(dx * dx + dy * dy)
    relative = torch.abs(xyz_rep[2] - d) / d
    mask = (dist < geo_pixel_thres) & (relative < geo_depth_thres)  # [S, P]

    count = torch.zeros_like(d, dtype=torch.int32)
    total = torch.zeros_like(d)
    for v in range(s):
        count = count + mask[v].int()
        total = total + torch.where(mask[v], xyz_rep[2][v], 0.0)
    depth_avg = ((total + d) / (count + 1).float()).reshape(h, w)
    photo = confidence > photo_thres
    geo = (count >= geo_mask_thres).reshape(h, w)
    bits = (photo.to(torch.uint8) | (geo.to(torch.uint8) << 1)
            | ((photo & geo).to(torch.uint8) << 2))
    return depth_avg, bits


def shared_bytes(sources: int) -> int:
    """Bytes of the record (`record`) for `sources` sources, which each
    block of the kernel stages in shared memory: 4 * (24 + 48 S), above
    48 KB (S >= 256) by the kernel's opt-in. Raises past MAX_SOURCES."""
    if not 0 <= sources <= MAX_SOURCES:
        raise ValueError(f"consistency: {sources} sources, at most {MAX_SOURCES}")
    return 4 * (HEAD_FLOATS + SOURCE_FLOATS * sources)


def record(k_ref, k_ref_inv, rel_ref_to_src, k_srcs, k_srcs_inv,
           rel_src_to_ref) -> torch.Tensor:
    """The kernel's matrices as one flat f32 tensor of 24 + 48 S floats on
    the matrices' device, every part 16-byte aligned so that the kernel
    reads it in float4s: K_ref and K_ref^-1 row-major, 6 zeros; then per
    source R|t ref->src (3x4), R|t src->ref (3x4), K_src, K_src^-1, 6
    zeros."""
    s = k_srcs.shape[0]
    shared_bytes(s)                         # raises past MAX_SOURCES
    pad = torch.zeros((s + 1, 6), dtype=torch.float32, device=k_ref.device)
    head = torch.cat([k_ref.reshape(9), k_ref_inv.reshape(9), pad[s]])
    per_src = torch.cat([rel_ref_to_src[:, :3, :4].reshape(s, 12),
                         rel_src_to_ref[:, :3, :4].reshape(s, 12),
                         k_srcs.reshape(s, 9), k_srcs_inv.reshape(s, 9), pad[:s]], dim=1)
    return torch.cat([head, per_src.reshape(-1)]).to(torch.float32)


def consistency(ref_depth, confidence, src_depths, rel_ref_to_src,
                rel_src_to_ref, k_ref, k_ref_inv, k_srcs, k_srcs_inv,
                geo_pixel_thres: float, geo_depth_thres: float,
                photo_thres: float, geo_mask_thres: int):
    """Geometric + photometric filtering of one reference view.

    Args:
      ref_depth, confidence: [H, W] float32.
      src_depths: [S, H, W] float32 (S may be 0: every geo count is 0).
      rel_ref_to_src: [S, 4, 4] `E_src @ inv(E_ref)`; rel_src_to_ref:
        [S, 4, 4] `E_ref @ inv(E_src)`.
      k_ref, k_ref_inv: [3, 3]; k_srcs, k_srcs_inv: [S, 3, 3].
      The maps decide the device; the matrices (small) may lie anywhere
      and are moved with them. Inverses and products of the matrices are
      the caller's, in f64, cast to f32.

    Returns (depth_avg [H, W] float32, bits [H, W] uint8).
    """
    h, w = ref_depth.shape
    s = src_depths.shape[0]
    if (tuple(confidence.shape) != (h, w) or tuple(src_depths.shape) != (s, h, w)
            or tuple(rel_ref_to_src.shape) != (s, 4, 4)
            or tuple(rel_src_to_ref.shape) != (s, 4, 4)
            or tuple(k_srcs.shape) != (s, 3, 3) or tuple(k_srcs_inv.shape) != (s, 3, 3)
            or tuple(k_ref.shape) != (3, 3) or tuple(k_ref_inv.shape) != (3, 3)):
        raise ValueError(
            f"consistency: shapes ref {tuple(ref_depth.shape)}, confidence "
            f"{tuple(confidence.shape)}, sources {tuple(src_depths.shape)} and "
            "the matrices do not agree")
    shared_bytes(s)                         # raises past MAX_SOURCES
    if max(s, 1) * h * w >= 2 ** 31:
        raise ValueError(f"consistency: S*H*W = {s * h * w} needs 64-bit offsets "
                         "(the kernel takes < 2^31)")
    args = (ref_depth, confidence, src_depths, rel_ref_to_src, rel_src_to_ref,
            k_ref, k_ref_inv, k_srcs, k_srcs_inv)
    if ref_depth.device.type == "cpu":
        dev = ref_depth.device
        return consistency_plain(*(t.to(dev) for t in args), geo_pixel_thres,
                                 geo_depth_thres, photo_thres, geo_mask_thres)
    if ref_depth.device.type != "cuda":
        raise ValueError(f"consistency: unsupported device {ref_depth.device}")
    # Matrices on the host (as fusion passes them) give a record in pageable
    # memory, uploaded without waiting for the stream: the driver stages its
    # few KB before the call returns. On an H100 this ran faster than a
    # blocking upload and than a pinned one (tools/time_consistency.py).
    params = record(k_ref, k_ref_inv, rel_ref_to_src, k_srcs, k_srcs_inv,
                    rel_src_to_ref).to(ref_depth.device, non_blocking=True)
    return launch_consistency(ref_depth, confidence, src_depths, params, geo_pixel_thres,
                              geo_depth_thres, photo_thres, geo_mask_thres)


def launch_consistency(ref_depth, confidence, src_depths, params,
                       geo_pixel_thres: float, geo_depth_thres: float,
                       photo_thres: float, geo_mask_thres: int):
    """Launch K3 on CUDA maps (shapes as `consistency`) and the `record`
    `params` already on their device. Counts one launch in
    `consistency.launches`. Returns (depth_avg, bits)."""
    h, w = ref_depth.shape
    s = src_depths.shape[0]
    maps = (ref_depth, confidence, src_depths, params)
    if any(t.device != ref_depth.device or t.device.type != "cuda" for t in maps):
        raise ValueError("consistency: maps and record must be on one CUDA device")
    if any(t.dtype != torch.float32 or not t.is_contiguous() for t in maps):
        raise ValueError("consistency: maps and record must be contiguous float32")
    if 4 * params.numel() != shared_bytes(s) or params.data_ptr() % 16:
        raise ValueError(f"consistency: the record of {s} sources is "
                         f"{shared_bytes(s) // 4} floats, 16-byte aligned")
    depth_avg = torch.empty((h, w), dtype=torch.float32, device=ref_depth.device)
    bits = torch.empty((h, w), dtype=torch.uint8, device=ref_depth.device)
    fn = kernels.function("fusion_consistency")
    with torch.cuda.device(ref_depth.device):
        stream = torch.cuda.current_stream().cuda_stream
        kernels.check_launch("fusion_consistency", fn(
            ref_depth.data_ptr(), confidence.data_ptr(), src_depths.data_ptr(),
            params.data_ptr(), depth_avg.data_ptr(), bits.data_ptr(), s, h, w,
            float(geo_pixel_thres), float(geo_depth_thres), float(photo_thres),
            int(geo_mask_thres), stream))
    consistency.launches += 1
    return depth_avg, bits


consistency.launches = 0


def quantize_depth(depth: torch.Tensor):
    """uint16 result wire of depth maps [..., H, W], each against its own
    range: (depth_q [..., H, W] u16, lo [...], hi [...]) with depth ~ lo +
    depth_q * (hi - lo) / 65535, round-to-nearest. The math of the JAX
    chain's tail (fusion.py:147-151) and of eval.py's result wire."""
    lo = depth.amin(dim=(-2, -1))
    hi = depth.amax(dim=(-2, -1))
    span = torch.clamp(hi - lo, min=1e-6)[..., None, None]
    depth_q = torch.clamp(torch.round((depth - lo[..., None, None]) * (65535.0 / span)),
                          0, 65535).to(torch.uint16)
    return depth_q, lo, hi
