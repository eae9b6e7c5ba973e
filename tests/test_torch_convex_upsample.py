"""Kernels K9 `convex_upsample` and K10 `convex_upsample_grad`
(ops/upsample.py): their plain versions, which the wrappers run on the
CPU, against the JAX package.

Forward: the port's `upsample_depth` (and `convex_upsample_plain`)
against `jax.nn.softmax` of the mask logits over the 9 taps followed by
`itermvs_tpu.ops.upsample.convex_upsample`, on the same numpy inputs,
float32 and the bfloat16 mask conv's logits (rounded to bfloat16, then
cast to float32 before the softmax in both packages). The borders are
held on maps of 1 and 2 rows or columns, at batch 2, with large logits
on the taps that clamp there.

Backward: the plain formula against `jax.vjp` of the same two JAX
functions, for the gradients of the logits and of the coarse map, in
float64 (JAX's x64 mode) and float32, and against
`torch.autograd.gradcheck` in float64.

Tolerance: 1e-5 of the largest magnitude of the JAX result, forward and
gradients (the same float32 arithmetic, summed in another order); on a
1x1 map, where every tap is the pixel itself and ∂logits vanishes,
1e-5 of 1 for ∂logits.
chip_smoke.py holds the CUDA kernels against these plain versions on the
card.

The kernels' own arithmetic, which cannot run here, is emulated in numpy
float32 (`_k9_k10_emulated`): the softmax of csrc/upsample_taps.cuh (one
reciprocal of the sum, then a product per weight), K10's per-tap sums in
its order (the 4 sub-columns of a sub-row, then the 4 sub-rows in
order) and its fold, on chip_smoke's planted inputs, held under the
gates chip_smoke applies on the card; and the kernels' mapping of
threads to pixel pairs, with a one-pixel pair at the end of a row of
odd width.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke

from itermvs_tpu.ops.upsample import convex_upsample as jax_convex_upsample
from itermvs_tpu_torch.ops.upsample import (
    CHANNELS, ConvexUpsample, convex_upsample_grad, convex_upsample_grad_plain,
    convex_upsample_plain, upsample_depth)

TOL = 1e-5
SHAPES = [(2, 1, 3), (1, 2, 5), (2, 4, 1), (2, 3, 2), (1, 1, 1)]


def _inputs(rng, b, h, w, edge=30.0):
    """x [B, H, W, 1] in [0, 1) and mask logits [B, H, W, 144] (channel
    k·16 + i·4 + j, tap k = (dy+1)·3 + (dx+1)), N(0, 4), with `edge` added
    on rows 0 and H−1 and columns 0 and W−1 to the taps that clamp there,
    on every sub-pixel."""
    x = rng.uniform(0, 1, (b, h, w, 1)).astype(np.float32)
    logits = (rng.randn(b, h, w, 9, 16) * 2.0).astype(np.float32)
    logits[:, 0, :, 0:3] += edge                       # dy = −1
    logits[:, h - 1, :, 6:9] += edge                   # dy = +1
    logits[:, :, 0, 0::3] += edge                      # dx = −1
    logits[:, :, w - 1, 2::3] += edge                  # dx = +1
    return x, logits.reshape(b, h, w, CHANNELS)


def _jax_up(x, logits):
    b, h, w, _ = logits.shape
    weights = jax.nn.softmax(logits.reshape(b, h, w, 9, 4, 4), axis=3)
    return jax_convex_upsample(x, weights, scale=4)


def _nchw(x, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))).to(dtype)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).double().numpy()


def _close(got, want, floor=1e-30):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * max(np.abs(want).max(), floor))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_matches_jax(rng, shape, dtype):
    x, logits = _inputs(rng, *shape)
    mask = _nchw(logits, dtype)
    # The JAX side reads the same (for bf16: rounded) values, in float32.
    want = _jax_up(jnp.asarray(x), jnp.asarray(_nhwc(mask).astype(np.float32)))
    got = upsample_depth(_nchw(x), mask)
    assert got.dtype == torch.float32 and got.shape == (shape[0], 1, 4 * shape[1],
                                                        4 * shape[2])
    _close(_nhwc(got), want)
    assert torch.equal(got, convex_upsample_plain(_nchw(x), mask))


def test_border_sub_pixels_take_the_clamped_neighbours(rng):
    """With +30 on the clamping taps, a corner's 16 sub-pixels take the
    corner's own value (the doubly clamped tap lands on it), and those of
    a pixel on the first row lie within its row's three neighbours."""
    x, logits = _inputs(rng, 1, 3, 4)
    up = upsample_depth(_nchw(x), _nchw(logits))[0, 0].numpy()
    assert np.allclose(up[:4, :4], x[0, 0, 0, 0], atol=1e-6)
    assert np.allclose(up[-4:, -4:], x[0, -1, -1, 0], atol=1e-6)
    row = up[:4, 4:8]                                  # coarse pixel (0, 1)
    assert row.min() >= x[0, 0, 0:3, 0].min() - 1e-6
    assert row.max() <= x[0, 0, 0:3, 0].max() + 1e-6


@jax.jit
def _jax_grads(x, logits, grad):
    return jax.vjp(_jax_up, x, logits)[1](grad)


def _jax_vjp(x, logits, grad, dtype):
    d_x, d_logits = _jax_grads(*(jnp.asarray(a, dtype) for a in (x, logits, grad)))
    return np.asarray(d_x), np.asarray(d_logits)


@pytest.mark.parametrize("shape", SHAPES)
def test_backward_formula_matches_jax_vjp(rng, shape):
    """∂logits and ∂x of the plain formula against JAX's vjp, both sides in
    float64 and both in float32; autograd through the wrapper's Function
    (as training runs it) gives the float32 formula."""
    b, h, w = shape
    floor = 1.0 if h == w == 1 else 1e-30
    x, logits = _inputs(rng, b, h, w, edge=3.0)
    grad = rng.randn(b, 4 * h, 4 * w, 1).astype(np.float32)
    with jax.enable_x64(True):
        want_x, want_l = _jax_vjp(x, logits, grad, jnp.float64)
    d_x, d_l = convex_upsample_grad_plain(_nchw(x).double(), _nchw(logits).double(),
                                          _nchw(grad).double(), torch.float64)
    _close(_nhwc(d_x), want_x)
    _close(_nhwc(d_l), want_l, floor)
    want_x, want_l = _jax_vjp(x, logits, grad, jnp.float32)
    xt = _nchw(x).requires_grad_()
    lt = _nchw(logits).requires_grad_()
    upsample_depth(xt, lt).backward(_nchw(grad))
    _close(_nhwc(xt.grad), want_x)
    _close(_nhwc(lt.grad), want_l, floor)


def test_backward_in_bfloat16_is_the_cast_gradient(rng):
    """bf16 logits: ∂logits comes back in bf16, the float32 formula rounded
    once, as autograd of the float32 cast rounds it: within one bf16 step
    of autograd through the plain chain plus 1e-5 of the largest value."""
    x, logits = _inputs(rng, 2, 3, 4, edge=3.0)
    grad = _nchw(rng.randn(2, 12, 16, 1).astype(np.float32))
    mask = _nchw(logits, torch.bfloat16)
    a = mask.clone().requires_grad_()
    upsample_depth(_nchw(x), a).backward(grad)
    b = mask.clone().requires_grad_()
    convex_upsample_plain(_nchw(x), b.float()).backward(grad)
    assert a.grad.dtype == torch.bfloat16
    want = b.grad.float()
    bound = 1e-5 * want.abs().max() + torch.finfo(torch.bfloat16).eps * want.abs()
    assert ((a.grad.float() - want).abs() <= bound).all()


@pytest.mark.parametrize("shape", [(2, 1, 2), (1, 3, 2)])
def test_backward_passes_gradcheck_in_float64(rng, shape):
    """The explicit backward against finite differences, and against
    autograd of the plain forward, in float64."""
    x, logits = _inputs(rng, *shape, edge=2.0)
    xt = _nchw(x, torch.float64).requires_grad_()
    lt = _nchw(logits, torch.float64).requires_grad_()
    assert torch.autograd.gradcheck(lambda a, c: ConvexUpsample.apply(a, c), (xt, lt))
    grad = torch.randn(shape[0], 1, 4 * shape[1], 4 * shape[2], dtype=torch.float64,
                       generator=torch.Generator().manual_seed(0))
    want = torch.autograd.grad(convex_upsample_plain(xt, lt), (xt, lt), grad)
    got = torch.autograd.grad(upsample_depth(xt, lt), (xt, lt), grad)
    for g, w in zip(got, want):
        assert torch.allclose(g, w, rtol=0, atol=1e-12)


def test_wrappers_are_the_plain_versions_on_the_cpu(rng):
    x, logits = _inputs(rng, 2, 3, 4)
    xt, lt = _nchw(x), _nchw(logits)
    grad = torch.randn(2, 1, 12, 16, generator=torch.Generator().manual_seed(1))
    before = (upsample_depth.launches, upsample_depth.launches_bf16,
              convex_upsample_grad.launches, convex_upsample_grad.launches_bf16)
    assert torch.equal(upsample_depth(xt, lt), convex_upsample_plain(xt, lt))
    for got, want in zip(convex_upsample_grad(xt, lt, grad),
                         convex_upsample_grad_plain(xt, lt, grad, torch.float32)):
        assert torch.equal(got, want)
    assert (upsample_depth.launches, upsample_depth.launches_bf16,
            convex_upsample_grad.launches, convex_upsample_grad.launches_bf16) == before


def test_new_wrappers_never_fall_back_off_the_cpu():
    """Tensors on another device than the CPU or a card raise; nothing
    falls back to the plain versions."""
    before = (upsample_depth.launches, convex_upsample_grad.launches)
    meta = dict(device="meta")
    x, logits = torch.empty(1, 1, 2, 3, **meta), torch.empty(1, CHANNELS, 2, 3, **meta)
    with pytest.raises(ValueError, match="unsupported device"):
        upsample_depth(x, logits)
    with pytest.raises(ValueError, match="unsupported device"):
        convex_upsample_grad(x, logits, torch.empty(1, 1, 8, 12, **meta))
    with pytest.raises(ValueError, match="needs x"):
        upsample_depth(torch.zeros(1, 1, 2, 3), torch.zeros(1, 16, 2, 3))
    assert (upsample_depth.launches, convex_upsample_grad.launches) == before


F = np.float32


def _softmax9_emulated(l):
    """csrc/upsample_taps.cuh `softmax9` over the last axis (9 taps) of
    float32 logits: the maximum, the sum of exp(l - max) in tap order,
    then each exp times the sum's reciprocal, one rounding per step."""
    m = l[..., 0]
    for k in range(1, 9):
        m = np.fmax(m, l[..., k])
    e = np.empty_like(l)
    s = np.zeros_like(m)
    for k in range(9):
        e[..., k] = np.exp(l[..., k] - m)
        s = s + e[..., k]
    r = F(1) / s
    return e * r[..., None]


def _tap_range(q, d, n):
    """csrc/convex_upsample_grad.cu `tap_range`."""
    return max(0 if q == 0 else q - d, 0), min(n - 1 if q == n - 1 else q - d, n - 1)


def _k9_k10_emulated(x, logits, grad):
    """K9's output [B, 1, 4H, 4W] and K10's (∂x [B, 1, H, W], ∂logits
    [B, 144, H, W]) float32, each operation rounded once, in the kernels'
    order. x, grad float32 and logits (float32 values) as numpy arrays."""
    b, _, h, w = x.shape
    ys, xs = np.arange(h), np.arange(w)
    t = np.stack([x[:, 0][:, np.clip(ys + dy, 0, h - 1)][:, :, np.clip(xs + dx, 0, w - 1)]
                  for dy in (-1, 0, 1) for dx in (-1, 0, 1)], axis=-1)   # [B, H, W, 9]
    # [B, i, j, H, W, 9]: tap last.
    wt = _softmax9_emulated(logits.reshape(b, 9, 4, 4, h, w).transpose(0, 2, 3, 4, 5, 1))
    t = t[:, None, None]
    up = np.zeros(wt.shape[:-1], F)
    for k in range(9):
        up = up + wt[..., k] * t[..., k]
    out = up.transpose(0, 3, 1, 4, 2).reshape(b, 1, 4 * h, 4 * w)
    g = grad.reshape(b, h, 4, w, 4).transpose(0, 2, 4, 1, 3)[..., None]  # [B, i, j, H, W, 1]
    gw = g * wt
    d_logits = gw * (t - up[..., None])
    rows = np.zeros((b, 4) + wt.shape[3:], F)                      # [B, i, H, W, 9]
    for j in range(4):
        rows = rows + gw[:, :, j]
    part = rows[:, 0]
    for i in range(1, 4):
        part = part + rows[:, i]                                   # [B, H, W, 9]
    d_x = np.zeros((b, 1, h, w), F)
    for bb, y, xc in np.ndindex(b, h, w):
        acc = F(0)
        for k in range(9):
            y0, y1 = _tap_range(y, k // 3 - 1, h)
            x0, x1 = _tap_range(xc, k % 3 - 1, w)
            for py in range(y0, y1 + 1):
                for px in range(x0, x1 + 1):
                    acc = F(acc + part[bb, py, px, k])
        d_x[bb, 0, y, xc] = acc
    return out, d_x, d_logits.transpose(0, 5, 1, 2, 3, 4).reshape(b, 144, h, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 5, 6), (1, 3, 7)])
def test_kernel_arithmetic_holds_chip_smokes_gates(shape, dtype):
    """The emulated kernels on chip_smoke's planted inputs: K9 within
    UPSAMPLE_TOL of the plain version; K10's ∂logits (rounded once to the
    logits' dtype) and ∂x within 1e-5 of max|float64 plain|, plus one
    bf16 step of |plain| for bf16 ∂logits (`hold_grad`'s bounds)."""
    b, h, w = shape
    gen = torch.Generator().manual_seed(0)
    x, logits = chip_smoke.upsample_inputs(b, h, w, gen, dtype, dev="cpu")
    grad = torch.randn(b, 1, 4 * h, 4 * w, generator=gen)
    with np.errstate(over="ignore", under="ignore"):
        out, d_x, d_l = _k9_k10_emulated(x.numpy(), logits.float().numpy(), grad.numpy())
    assert np.abs(out - convex_upsample_plain(x, logits).numpy()).max() <= \
        chip_smoke.UPSAMPLE_TOL
    exact_x, exact_l = convex_upsample_grad_plain(x.double(), logits.double(), grad.double(),
                                                  torch.float64)
    step = chip_smoke.BF16_STEP if dtype == torch.bfloat16 else 0.0
    for got, want, s in ((torch.from_numpy(d_l).to(dtype), exact_l.to(dtype), step),
                         (torch.from_numpy(d_x), exact_x.float(), 0.0)):
        want = want.float()
        bound = 1e-5 * want.abs().max() + s * want.abs()
        assert bool(((got.float() - want).abs() <= bound).all())


def _pairs(b, h, w):
    """The kernels' pixel pairs (csrc/upsample_taps.cuh `Pair`), in
    thread order: (batch, row, first column, two pixels)."""
    per_row = (w + 1) // 2
    out = []
    for gq in range(b * h * per_row):
        r, x0 = divmod(gq, per_row)
        out.append((r // h, r % h, 2 * x0, 2 * x0 + 1 < w))
    return out


@pytest.mark.parametrize("w", [1, 2, 3, 66])
def test_pair_mapping_covers_every_pixel_once(w):
    """Pairs never straddle a row; at odd W a row ends in a one-pixel
    pair; at even W every pair holds two pixels and every plane's pair
    starts on an even element (the paired path's 2-element alignment), so
    that a block's 32 pairs may end inside a row (W = 66) or span rows."""
    b, h = 2, 3
    seen = []
    for bb, y, x0, two in _pairs(b, h, w):
        seen += [(bb, y, x0)] + ([(bb, y, x0 + 1)] if two else [])
        assert x0 + two < w
        if w % 2 == 0:
            assert two and (y * w + x0) % 2 == 0 and (h * w) % 2 == 0
    assert sorted(seen) == [(bb, y, xc) for bb in range(b) for y in range(h)
                            for xc in range(w)]
    assert len(seen) == len(set(seen))
