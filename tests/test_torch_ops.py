"""The port's plain-torch ops against their JAX counterparts.

Inputs come from a numpy seed; JAX runs on the CPU. JAX ops are NHWC,
the port's NCHW, so maps are transposed before comparing. Tolerance:
1e-5 × max|x| of the JAX output — the ops are the same f32 arithmetic,
differing only in summation order (and XLA's matmul form of the resize).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from itermvs_tpu.models import itermvs as jax_itermvs
from itermvs_tpu.ops import depth_range as jax_depth_range
from itermvs_tpu.ops import resize as jax_resize
from itermvs_tpu.ops.upsample import convex_upsample as jax_convex_upsample
from itermvs_tpu.ops import warping as jax_warping
from itermvs_tpu_torch.models import itermvs as port_itermvs
from itermvs_tpu_torch.ops import depth_range, resize, warping
from itermvs_tpu_torch.ops.upsample import convex_upsample


def _close(got, want, scale=1e-5):
    want = np.asarray(want)
    got = np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=scale * max(np.abs(want).max(), 1e-30))


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def test_depth_unnormalization_matches_jax(rng):
    norm = rng.rand(2, 1, 5, 7).astype(np.float32)
    idmin = np.float32(1 / 2.0)
    idmax = np.float32(1 / 10.0)
    _close(depth_range.depth_unnormalization(torch.from_numpy(norm), idmin, idmax),
           jax_depth_range.depth_unnormalization(jnp.asarray(norm), idmin, idmax))


@pytest.mark.parametrize("in_hw,out_hw", [((12, 16), (6, 8)), ((6, 8), (12, 16)),
                                          ((13, 7), (5, 11)), ((9, 10), (9, 10))])
def test_resize_bilinear_matches_jax(rng, in_hw, out_hw):
    x = rng.rand(2, *in_hw, 5).astype(np.float32) * 2 - 1
    want = jax_resize.resize_bilinear(jnp.asarray(x), out_hw)
    _close(_nhwc(resize.resize_bilinear(_nchw(x), out_hw)), want)


@pytest.mark.parametrize("scale", [2, 4])
def test_upsample_bilinear_matches_jax(rng, scale):
    x = rng.rand(1, 6, 9, 3).astype(np.float32)
    want = jax_resize.upsample_bilinear(jnp.asarray(x), scale)
    _close(_nhwc(resize.upsample_bilinear(_nchw(x), scale)), want)


def test_convex_upsample_matches_jax(rng):
    b, h, w = 2, 5, 7
    x = rng.uniform(0, 1, (b, h, w, 1)).astype(np.float32)
    logits = rng.randn(b, h, w, 9, 4, 4).astype(np.float32)
    weights = np.exp(logits) / np.exp(logits).sum(axis=3, keepdims=True)
    want = jax_convex_upsample(jnp.asarray(x), jnp.asarray(weights), scale=4)
    got = convex_upsample(_nchw(x), torch.from_numpy(
        np.ascontiguousarray(weights.transpose(0, 3, 4, 5, 1, 2))), scale=4)
    _close(_nhwc(got), want)


def _camera(rng, w, h, tz):
    K = np.array([[w * 1.2, 0, w / 2], [0, w * 1.2, h / 2], [0, 0, 1]], np.float32)
    angle = rng.uniform(-0.05, 0.05, 3)
    cx, cy, cz = np.cos(angle)
    sx, sy, sz = np.sin(angle)
    R = (np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
         @ np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
         @ np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]]))
    E = np.eye(4, dtype=np.float32)
    E[:3, :3] = R
    E[:3, 3] = [rng.uniform(-0.3, 0.3), rng.uniform(-0.3, 0.3), tz]
    P = np.eye(4, dtype=np.float32)
    P[:3, :4] = K @ E[:3, :4]
    return P


def test_relative_projection_matches_jax(rng):
    src = np.stack([[_camera(rng, 96, 64, rng.uniform(-1, 1)) for _ in range(4)]
                    for _ in range(2)])                         # [2, 4, 4, 4]
    ref = np.stack([[_camera(rng, 96, 64, 0.0)] for _ in range(2)])  # [2, 1, 4, 4]
    want = jax_warping.relative_projection(jnp.asarray(src), jnp.asarray(ref))
    got = warping.relative_projection(torch.from_numpy(src), torch.from_numpy(ref))
    _close(got.numpy(), want, scale=1e-5)
    _close(warping.invert_projection(torch.from_numpy(ref)).numpy(),
           jax_warping.invert_projection(jnp.asarray(ref)))


def _sampled_values(tables, flat_idx, taps, level_of_sample):
    """Σ_k tap_k · corner_k of zero-filled packed tables, in float64.

    tables: per level [B, V, H1, W1, C]; flat_idx [B, V, N, P];
    taps [4, B, V, N, P]. Returns [B, V, N, P, C]."""
    b, v, n, p = flat_idx.shape
    out = np.zeros((b, v, n, p, tables[0].shape[-1]))
    for s, lvl in enumerate(level_of_sample):
        t = tables[lvl].astype(np.float64)
        h1, w1 = t.shape[2:4]
        pad = np.zeros((b, v, h1 + 1, w1 + 1, t.shape[-1]))
        pad[:, :, :h1, :w1] = t
        y, x = np.divmod(flat_idx[:, :, s].astype(np.int64), w1)
        bi, vi = np.meshgrid(np.arange(b), np.arange(v), indexing="ij")
        bi, vi = bi[..., None], vi[..., None]
        for k, (dy, dx) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
            out[:, :, s] += taps[k, :, :, s][..., None] * pad[bi, vi, y + dy, x + dx]
    return out


def test_fused_sweep_taps_matches_jax_on_edge_cases(rng):
    b, h, w = 2, 5, 7
    src_hws = ((10, 14), (5, 7))
    level_of_sample = (0, 0, 1, 1, 0)
    n = len(level_of_sample)
    # Per (view, level) projections: a random camera pair, and pure
    # translations that put depth-1 samples at x = -1 (floor -1), -0.5,
    # on the last row/column and past the far edge.
    rel = np.zeros((b, 4, 2, 4, 4), np.float32)
    for bi in range(b):
        for lv in range(2):
            rel[bi, 0, lv] = (_camera(rng, 14, 10, 0.5)
                              @ np.linalg.inv(_camera(rng, 14, 10, 0.0)))
            for vi, (tx, ty) in enumerate(((-1.0, -1.0), (-0.5, 1.25),
                                           (src_hws[lv][1] - 7.0, src_hws[lv][0] - 3.5)),
                                          start=1):
                rel[bi, vi, lv] = np.eye(4, dtype=np.float32)
                rel[bi, vi, lv, 0, 3] = tx
                rel[bi, vi, lv, 1, 3] = ty
    depth = rng.uniform(2.0, 10.0, (b, n, h, w)).astype(np.float32)
    depth[:, 0] = 1.0                        # exact translations
    depth[:, 1, :2] = -2.0                   # behind the camera
    depth[:, 1, 2, :3] = 0.005               # z <= 1e-2: behind as well
    depth[:, 2] = 1.0
    want_idx, want_taps = jax_warping.fused_sweep_taps(
        jnp.asarray(rel), jnp.asarray(depth), level_of_sample, src_hws,
        jnp.float32)
    got_idx, got_taps = warping.fused_sweep_taps(
        torch.from_numpy(rel), torch.from_numpy(depth), level_of_sample, src_hws)
    assert got_idx.dtype == torch.int32 and got_idx.shape == (b, 4, n, h * w)
    assert got_taps.shape == (4, b, 4, n, h * w)

    tables = [rng.rand(b, 4, hh, ww, 3).astype(np.float32) * 2 - 1
              for hh, ww in src_hws]
    want = _sampled_values(tables, np.asarray(want_idx).reshape(b, 4, n, h * w),
                           np.stack([np.asarray(t).reshape(b, 4, n, h * w)
                                     for t in want_taps]), level_of_sample)
    got = _sampled_values(tables, got_idx.numpy(), got_taps.numpy(), level_of_sample)
    _close(got, want)
    # The edge cases were reached: taps at floor = -1, fully outside
    # samples, and behind-camera samples remapped inside level 0.
    t = got_taps.numpy()
    assert (t.sum(axis=0) == 0).any()
    assert ((t.sum(axis=0) > 0) & (t.sum(axis=0) < 0.999)).any()


def test_windowed_expectation_matches_jax_at_the_edges(rng):
    logits = rng.randn(2, 6, 8, 256).astype(np.float32)
    logits[0, 0, :, 1] += 20.0               # argmax near bin 0
    logits[0, 1, :, 254] += 20.0             # argmax near the top bin
    logits[1, 2, :, 0] += 20.0
    prob = np.exp(logits - logits.max(-1, keepdims=True))
    prob /= prob.sum(-1, keepdims=True)
    want = jax_itermvs.windowed_expectation(jnp.asarray(prob))
    got = port_itermvs.windowed_expectation(_nchw(prob))
    _close(_nhwc(got), want)


def test_initial_depth_samples_match_jax():
    idmin = np.array([0.5, 0.25], np.float32)
    idmax = np.array([0.1, 0.05], np.float32)
    want = jax_itermvs.initial_depth_samples(jnp.asarray(idmin), jnp.asarray(idmax), 3, 4)
    got = port_itermvs.initial_depth_samples(torch.from_numpy(idmin),
                                             torch.from_numpy(idmax), 3, 4)
    _close(got.numpy(), want)
