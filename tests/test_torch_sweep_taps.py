"""Kernel K8 `sweep_taps` (ops/warping.py `fused_sweep_taps`): its
arithmetic, emulated in numpy float32, against the plain version, bit for
bit; its per-sample table; its wrapper on the CPU and off it.

The CUDA kernel cannot run here. Its source rounds once per operation
(`__fmul_rn`, `__fadd_rn`, `__fdiv_rn`: nvcc never fuses those into an
FMA) in the plain version's order, so `_k8_emulated` below does the same
operations in the same order on numpy float32 arrays, which also round
once per operation; it must equal the plain version bit for bit on the
edge cases of tests/test_torch_ops.py (floor = -1, fully outside, behind
the camera) and on a NaN depth. chip_smoke.py holds the kernel itself
against the plain version on the card, bit for bit.
"""
import ctypes

import numpy as np
import pytest
import torch

from itermvs_tpu_torch.ops import warping
from itermvs_tpu_torch.ops.warping import (
    MAX_SAMPLES, SampleTable, fused_sweep_taps, fused_sweep_taps_plain, sample_table)
from tests.test_torch_ops import _camera

F = np.float32


def _axis_taps(p, size):
    """csrc/sweep_taps.cu `axis_taps`, elementwise in float32."""
    p0 = np.floor(p)
    base = np.fmin(np.fmax(p0, F(0)), size - F(1))
    frac = p - p0
    at_base = p0 == base
    w_a = np.where(at_base, F(1) - frac, np.where(p0 + F(1) == base, frac, F(0)))
    w_b = np.where(at_base, frac, F(0))
    return base.astype(np.int32), w_a.astype(F), w_b.astype(F)


def _k8_emulated(rel, depth, level_of_sample, src_hws, group=4):
    """K8's per-element arithmetic, one float32 rounding per operation in
    the kernel's order and with its reuse: the samples in groups of
    `group` (one grid z index), each pixel's grid point and rot . (gx, gy,
    1) computed at the first sample of a group and again wherever the
    level changes inside it, and reused for the group's later samples of
    that level. (flat_idx [B, V, N, HW] int32, taps [4, B, V, N, HW]
    float32)."""
    b, n, h, w = depth.shape
    v = rel.shape[1]
    table = sample_table(level_of_sample, src_hws, h, w)
    y, x = np.divmod(np.arange(h * w), w)
    flat_idx = np.empty((b, v, n, h * w), np.int32)
    taps = np.empty((4, b, v, n, h * w), F)
    with np.errstate(invalid="ignore", over="ignore"):
        for s in range(n):
            m = rel[:, :, table.level[s]]                         # [B, V, 4, 4]
            if s % group == 0 or table.level[s] != table.level[s - 1]:
                gx = x.astype(F) * F(table.scale_x[s])
                gy = y.astype(F) * F(table.scale_y[s])
                rot = [(m[:, :, i, 0, None] * gx + m[:, :, i, 1, None] * gy)
                       + m[:, :, i, 2, None] for i in range(3)]
            d = depth[:, s].reshape(b, 1, h * w)
            xyz = [rot[i] * d + m[:, :, i, 3, None] for i in range(3)]
            valid = xyz[2] > F(1e-2)
            pz = np.where(valid, xyz[2], F(1))
            px = np.where(valid, xyz[0], F(w)) / pz
            py = np.where(valid, xyz[1], F(h)) / pz
            bx, wxa, wxb = _axis_taps(px, F(table.width[s]))
            by, wya, wyb = _axis_taps(py, F(table.height[s]))
            flat_idx[:, :, s] = by * np.int32(table.width[s]) + bx
            for k, (a, c) in enumerate(((wya, wxa), (wya, wxb), (wyb, wxa), (wyb, wxb))):
                taps[k, :, :, s] = a * c
    return flat_idx, taps


def _bf16_bits(x):
    """float32 → bfloat16 bits, round to nearest even (no NaN here)."""
    u = x.view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def _edge_inputs(rng):
    """The sweep of tests/test_torch_ops.py's edge-case test (a random
    camera pair; translations that put depth-1 samples at x = -1, -0.5,
    on the last row and column and past the far edge; samples behind the
    camera and at z <= 1e-2), plus a NaN depth and a third level."""
    b, h, w = 2, 5, 7
    src_hws = ((10, 14), (5, 7), (3, 4))
    level_of_sample = (0, 0, 1, 1, 0, 2)
    n = len(level_of_sample)
    rel = np.zeros((b, 4, 3, 4, 4), np.float32)
    for bi in range(b):
        for lv in range(3):
            rel[bi, 0, lv] = (_camera(rng, 14, 10, 0.5)
                              @ np.linalg.inv(_camera(rng, 14, 10, 0.0)))
            for vi, (tx, ty) in enumerate(((-1.0, -1.0), (-0.5, 1.25),
                                           (src_hws[lv][1] - 7.0, src_hws[lv][0] - 3.5)),
                                          start=1):
                rel[bi, vi, lv] = np.eye(4, dtype=np.float32)
                rel[bi, vi, lv, 0, 3] = tx
                rel[bi, vi, lv, 1, 3] = ty
    depth = rng.uniform(2.0, 10.0, (b, n, h, w)).astype(np.float32)
    depth[:, 0] = 1.0
    depth[:, 1, :2] = -2.0
    depth[:, 1, 2, :3] = 0.005
    depth[:, 2] = 1.0
    depth[:, 3, 0, 0] = np.nan
    return rel, depth, level_of_sample, src_hws


@pytest.mark.parametrize("table_dtype", [torch.float32, torch.bfloat16])
def test_k8_arithmetic_is_bit_equal_to_the_plain_version(rng, table_dtype):
    rel, depth, level_of_sample, src_hws = _edge_inputs(rng)
    want_idx, want_taps = fused_sweep_taps_plain(
        torch.from_numpy(rel), torch.from_numpy(depth), level_of_sample, src_hws, table_dtype)
    got_idx, got_taps = _k8_emulated(rel, depth, level_of_sample, src_hws)
    assert np.array_equal(got_idx, want_idx.numpy())
    if table_dtype == torch.float32:
        assert np.array_equal(got_taps.view(np.uint32), want_taps.numpy().view(np.uint32))
    else:
        assert np.array_equal(_bf16_bits(got_taps), want_taps.view(torch.int16).numpy()
                              .view(np.uint16))
    # The edge cases were reached: all taps zero (outside), partial taps
    # (floor = -1 or the last row or column); a NaN depth fails z > 1e-2
    # and lands where a sample behind the camera does, on (W, H) of the
    # depth grid: past level 1's (5, 7) map, zero taps on its last cell.
    t = got_taps.sum(axis=0)
    assert (t == 0).any() and ((t > 0) & (t < 0.999)).any()
    assert (got_taps[:, :, :, 3, 0] == 0).all() and (got_idx[:, :, 3, 0] == 4 * 7 + 6).all()


def test_k8_arithmetic_on_a_real_sweep(rng):
    """A random camera pair over three levels, every sample in front:
    bit-equal with no planted edge."""
    b, h, w, v = 1, 6, 8, 3
    src_hws = ((12, 16), (6, 8), (3, 4))
    level_of_sample = (0, 0, 0, 0, 1, 1, 1, 1, 2, 2)
    rel = np.stack([np.stack([_camera(rng, 16, 12, 0.3) @ np.linalg.inv(_camera(rng, 16, 12, 0.0))
                              for _ in range(3)]) for _ in range(v)])[None].astype(np.float32)
    depth = rng.uniform(2.0, 10.0, (b, len(level_of_sample), h, w)).astype(np.float32)
    want_idx, want_taps = fused_sweep_taps_plain(torch.from_numpy(rel), torch.from_numpy(depth),
                                                 level_of_sample, src_hws)
    got_idx, got_taps = _k8_emulated(rel, depth, level_of_sample, src_hws)
    assert np.array_equal(got_idx, want_idx.numpy())
    assert np.array_equal(got_taps.view(np.uint32), want_taps.numpy().view(np.uint32))


def test_sample_table_packs_the_kernels_struct():
    """Five arrays of MAX_SAMPLES 4-byte fields, in csrc/sweep_taps.cu's
    order; the grid scales are the float32 values of the Python quotients
    the plain version multiplies by."""
    assert ctypes.sizeof(SampleTable) == 5 * MAX_SAMPLES * 4
    assert [name for name, _ in SampleTable._fields_] == [
        "level", "height", "width", "scale_y", "scale_x"]
    assert SampleTable.scale_x.offset == 4 * MAX_SAMPLES * 4
    src_hws = ((576, 800), (288, 400), (144, 200))
    table = sample_table((0, 0, 1, 2), src_hws, 288, 400)
    assert list(table.level[:4]) == [0, 0, 1, 2]
    assert list(table.height[:4]) == [576, 576, 288, 144]
    assert list(table.width[:4]) == [800, 800, 400, 200]
    assert table.scale_x[3] == np.float32(200 / 400) and table.scale_y[0] == 2.0
    odd = sample_table((0,), ((10, 14),), 3, 7)
    assert odd.scale_y[0] == float(np.float32(10 / 3)) != 10 / 3
    with pytest.raises(ValueError, match="samples"):
        sample_table((0,) * (MAX_SAMPLES + 1), src_hws, 8, 8)


def test_wrapper_is_the_plain_version_on_the_cpu(rng):
    rel, depth, level_of_sample, src_hws = _edge_inputs(rng)
    args = (torch.from_numpy(rel), torch.from_numpy(depth), level_of_sample, src_hws)
    before = (fused_sweep_taps.launches, fused_sweep_taps.launches_bf16)
    for dtype in (torch.float32, torch.bfloat16):
        got, want = fused_sweep_taps(*args, dtype), fused_sweep_taps_plain(*args, dtype)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (fused_sweep_taps.launches, fused_sweep_taps.launches_bf16) == before


def test_wrapper_never_falls_back_off_the_cpu():
    """A tensor on another device than the CPU or a card raises; nothing
    falls back to the plain version."""
    before = (fused_sweep_taps.launches, fused_sweep_taps.launches_bf16)
    rel = torch.empty(1, 2, 1, 4, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_sweep_taps(rel, torch.empty(1, 3, 4, 5, device="meta"), (0, 0, 0), ((4, 5),))
    assert (fused_sweep_taps.launches, fused_sweep_taps.launches_bf16) == before
    assert warping.TAPS_KERNELS == {torch.float32: "sweep_taps",
                                    torch.bfloat16: "sweep_taps_bf16"}


@pytest.mark.parametrize("shape", range(5))
def test_k8_arithmetic_at_the_edge_sweeps(shape):
    """chip_smoke's K8 edge sweeps (`TAPS_EDGE_SHAPES`: one column, odd
    widths, so that a thread's last pixel pair is ragged; one sample; 32
    samples from a broadcast depth; the levels interleaved, level 2 with
    a single sample in a group), emulated and bit-equal to the plain
    version in both table dtypes."""
    import chip_smoke
    b, n, h, w, broadcast = chip_smoke.TAPS_EDGE_SHAPES[shape]
    gen = torch.Generator().manual_seed(shape)
    rel, depth, levels, srcs = chip_smoke.taps_edge_inputs(b, n, h, w, broadcast, gen, "cpu")
    got_idx, got_taps = _k8_emulated(rel.numpy(), depth.contiguous().numpy(), levels, srcs)
    for dtype in (torch.float32, torch.bfloat16):
        want_idx, want_taps = fused_sweep_taps_plain(rel, depth, levels, srcs, dtype)
        assert np.array_equal(got_idx, want_idx.numpy())
        if dtype == torch.float32:
            assert np.array_equal(got_taps.view(np.uint32), want_taps.numpy().view(np.uint32))
        else:
            assert np.array_equal(_bf16_bits(got_taps),
                                  want_taps.view(torch.int16).numpy().view(np.uint16))
    t = got_taps.sum(axis=0)
    assert (t == 0).any() and ((t > 0) & (t < 0.999)).any()


def test_sample_table_is_built_once_per_geometry():
    """The wrapper's table is cached by (levels, source sizes, h, w): the
    same geometry, in lists or tuples, gives the same table; another
    gives another."""
    src_hws = [(576, 800), (288, 400), (144, 200)]
    a = sample_table([0, 0, 1, 2], src_hws, 288, 400)
    assert sample_table((0, 0, 1, 2), tuple(src_hws), 288, 400) is a
    assert sample_table((0, 0, 1, 2), src_hws, 144, 200) is not a
    assert list(a.level[:4]) == [0, 0, 1, 2]
