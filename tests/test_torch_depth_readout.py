"""Kernels K6 `depth_readout` and K7 `depth_readout_grad`
(ops/depth_readout.py): their plain versions, which the wrappers run on
the CPU, against the JAX package.

Forward: the port's `depth_readout` against `jax.nn.softmax` +
`windowed_expectation` on the same logits, float32 and the bfloat16 depth
head's logits (cast to float32 before the softmax in both packages), with
the argmax at the edge bins and with exact ties. Tolerance 1e-6 absolute
on the depth (in [0, 1]) and the probability: the same float32
arithmetic, summed in another order.

Backward: the plain formula against `jax.vjp` with cotangents on both
outputs, to 1e-5 of max|want| (float32 sums in another order), and
against `torch.autograd.gradcheck` in float64. chip_smoke.py holds the
CUDA kernels against these plain versions on the card.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from itermvs_tpu.models import itermvs as jax_itermvs
from itermvs_tpu_torch.models.itermvs import Update
from itermvs_tpu_torch.ops import depth_readout as dr
from itermvs_tpu_torch.ops.depth_readout import (
    NUM_BINS, DepthReadout, depth_readout, depth_readout_grad, depth_readout_grad_plain,
    depth_readout_plain, windowed_expectation)

TOL = 1e-6


def _logits(rng, case, b=2, h=4, w=6, edge=30.0):
    """[B, H, W, 256] float32 logits: a peak per pixel over noise, and
    per case the argmax planted at bins 0-4 and 251-255 (`edge` above the
    rest), or exact ties (every bin equal on some pixels, two equal peaks
    on others)."""
    x = (rng.randn(b, h, w, NUM_BINS) * 1.5).astype(np.float32)
    x[np.arange(b)[:, None, None], np.arange(h)[None, :, None], np.arange(w)[None, None, :],
      rng.randint(0, NUM_BINS, (b, h, w))] += 8.0
    if case == "edges":
        bins = np.array([0, 1, 2, 3, 4, 251, 252, 253, 254, 255])
        flat = x.reshape(-1, NUM_BINS)
        flat[np.arange(flat.shape[0]), bins[np.arange(flat.shape[0]) % len(bins)]] += edge
    elif case == "ties":
        x[0, 0] = 0.0                                   # every bin ties
        x[0, 1, :, 7] = x[0, 1, :, 200] = 40.0          # two equal peaks
        x[1, 2, :, 0] = x[1, 2, :, 255] = 40.0
    return x


def _jax_readout(logits_nhwc, dtype=jnp.float32):
    p = jax.nn.softmax(jnp.asarray(logits_nhwc).astype(dtype), axis=-1)
    return jax_itermvs.windowed_expectation(p), p


def _jax_vjp(x, d_depth, d_prob, dtype=jnp.float32):
    _, vjp = jax.vjp(lambda l: _jax_readout(l, dtype), jnp.asarray(x, dtype))
    return np.asarray(vjp((jnp.asarray(d_depth, dtype), jnp.asarray(d_prob, dtype)))[0])


def _nchw(x, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))).to(dtype)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).float().numpy()


def _close(got, want, tol):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["random", "edges", "ties"])
def test_depth_readout_matches_jax(rng, dtype, case):
    x = _logits(rng, case)
    logits = _nchw(x, dtype)
    # The JAX side reads the same (for bf16: rounded) values.
    want_depth, want_p = _jax_readout(_nhwc(logits))
    depth, prob = depth_readout(logits)
    assert depth.dtype == prob.dtype == torch.float32
    _close(_nhwc(depth), want_depth, TOL)
    _close(_nhwc(prob), want_p, TOL)
    want_idx = np.asarray(jnp.argmax(want_p, axis=-1))
    assert np.array_equal(depth_readout_plain(logits)[2][:, 0].numpy(), want_idx)
    if case == "edges":
        assert set(want_idx.ravel()) <= {0, 1, 2, 3, 4, 251, 252, 253, 254, 255}
    if case == "ties":
        assert want_idx[0, 0].tolist() == [0] * 6 and want_idx[0, 1].tolist() == [7] * 6
        assert want_idx[1, 2].tolist() == [0] * 6


def test_windowed_expectation_is_the_readout_of_a_probability(rng):
    p = torch.softmax(_nchw(_logits(rng, "edges")), dim=1)
    depth, index, mass, regress = dr.readout_plain(p)
    assert torch.equal(windowed_expectation(p), depth)
    assert torch.equal(index, p.argmax(dim=1, keepdim=True))
    assert torch.allclose(depth * 255.0, regress) and (mass > 0).all()


def _vjp_inputs(rng, b=2, h=3, w=5):
    """Logits whose probabilities spread over several bins (an edge peak
    of +30 puts p at 1 - 1e-12, where every gradient is a float32
    cancellation), cotangents of both outputs."""
    x = _logits(rng, "edges", b, h, w, edge=6.0)
    x[1] = _logits(rng, "random", 1, h, w)[0]
    d_depth = rng.randn(b, h, w, 1).astype(np.float32)
    d_prob = rng.randn(b, h, w, NUM_BINS).astype(np.float32)
    return x, d_depth, d_prob


@pytest.mark.parametrize("cotangents", ["both", "depth", "probability"])
def test_backward_formula_matches_jax_vjp(rng, cotangents):
    """The formula against JAX's vjp, both sides in float64 (JAX's x64
    mode) for every cotangent, and with both cotangents also both sides
    in float32, through the formula and through autograd. A float32 run
    of the depth's cotangent alone is not held to 1e-5: its r carries
    float32's rounding of a value near 255 (1.5e-5), which moves
    w_k (k - r) by ~1e-4 of its spread where k is near r, in either
    package."""
    x, d_depth, d_prob = _vjp_inputs(rng)
    if cotangents == "probability":
        d_depth = np.zeros_like(d_depth)
    if cotangents == "depth":
        d_prob = np.zeros_like(d_prob)
    given = lambda t: (None if cotangents == "depth" else _nchw(d_prob).to(t),
                       None if cotangents == "probability" else _nchw(d_depth).to(t))
    with jax.enable_x64(True):
        want = _jax_vjp(x, d_depth, d_prob, jnp.float64)
    _, *saved = depth_readout_plain(_nchw(x).double())
    got = depth_readout_grad_plain(*saved, *given(torch.float64), torch.float64)
    _close(_nhwc(got), want, 1e-5 * np.abs(want).max())
    if cotangents != "both":
        return
    want = _jax_vjp(x, d_depth, d_prob)
    _, *saved = depth_readout_plain(_nchw(x))
    got = depth_readout_grad_plain(*saved, *given(torch.float32), torch.float32)
    _close(_nhwc(got), want, 1e-5 * np.abs(want).max())
    # The same through autograd (the wrappers' Function, as training runs it).
    logits = _nchw(x).requires_grad_()
    depth, prob = depth_readout(logits)
    torch.autograd.backward((depth, prob), (_nchw(d_depth), _nchw(d_prob)))
    _close(_nhwc(logits.grad), want, 1e-5 * np.abs(want).max())


def test_backward_passes_gradcheck_in_float64(rng):
    """Logits with a clear peak per pixel (no argmax flips under
    gradcheck's 1e-6 steps), both outputs differentiated."""
    x = _logits(rng, "edges", 1, 2, 3).astype(np.float64)
    logits = _nchw(x, torch.float64).requires_grad_()
    assert torch.autograd.gradcheck(lambda l: DepthReadout.apply(l), (logits,))


def test_backward_in_bfloat16_is_the_cast_gradient(rng):
    """bf16 logits: the gradient comes back in bf16, the float32 formula
    rounded once, as autograd of the float32 cast rounds it: within one
    bf16 step of autograd through the plain chain (the two float32 sums
    may round apart) plus 1e-5 of the largest value."""
    x, d_depth, d_prob = _vjp_inputs(rng)
    logits = _nchw(x, torch.bfloat16)
    a = logits.clone().requires_grad_()
    depth, prob = depth_readout(a)
    torch.autograd.backward((depth, prob), (_nchw(d_depth), _nchw(d_prob)))
    b = logits.clone().requires_grad_()
    p = torch.softmax(b.float(), dim=1)
    torch.autograd.backward((windowed_expectation(p), p), (_nchw(d_depth), _nchw(d_prob)))
    assert a.grad.dtype == torch.bfloat16
    want = b.grad.float()
    bound = 1e-5 * want.abs().max() + torch.finfo(torch.bfloat16).eps * want.abs()
    assert ((a.grad.float() - want).abs() <= bound).all()


def test_test_mode_returns_no_probability(rng):
    logits = _nchw(_logits(rng, "random"))
    depth, prob = depth_readout(logits, probability=False)
    assert prob is None and torch.equal(depth, depth_readout(logits)[0])
    # Differentiable all the same: the depth's gradient still flows.
    leaf = logits.clone().requires_grad_()
    depth, prob = depth_readout(leaf, probability=False)
    assert prob is None
    depth.sum().backward()
    assert leaf.grad is not None and torch.isfinite(leaf.grad).all()
    # The model's test mode asks for none.
    update = Update(hidden_dim=8)
    hidden = torch.randn(1, 8, 4, 5)
    with torch.no_grad():
        depth, prob = update.depth(hidden, False)
        assert prob is None and depth.shape == (1, 1, 4, 5)
        assert update.depth(hidden)[1].shape == (1, NUM_BINS, 4, 5)


def test_wrappers_are_the_plain_versions_on_the_cpu(rng):
    logits = _nchw(_logits(rng, "edges"))
    before = (depth_readout.launches, depth_readout.launches_bf16,
              depth_readout_grad.launches, depth_readout_grad.launches_bf16)
    depth, prob, index, mass, regress = depth_readout_plain(logits)
    got = depth_readout(logits)
    assert torch.equal(got[0], depth) and torch.equal(got[1], prob)
    grad = torch.randn(prob.shape)
    assert torch.equal(depth_readout_grad(prob, index, mass, regress, grad, None, torch.float32),
                       depth_readout_grad_plain(prob, index, mass, regress, grad, None,
                                                torch.float32))
    assert (depth_readout.launches, depth_readout.launches_bf16, depth_readout_grad.launches,
            depth_readout_grad.launches_bf16) == before


def test_new_wrappers_never_fall_back_off_the_cpu():
    """Tensors on another device than the CPU or a card raise; nothing
    falls back to the plain versions."""
    before = (depth_readout.launches, depth_readout_grad.launches)
    with pytest.raises(ValueError, match="unsupported device"):
        depth_readout(torch.empty(1, NUM_BINS, 2, 3, device="meta"))
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        depth_readout_grad(torch.empty(1, NUM_BINS, 2, 3, **meta),
                           torch.empty(1, 1, 2, 3, dtype=torch.int32, **meta),
                           torch.empty(1, 1, 2, 3, **meta), torch.empty(1, 1, 2, 3, **meta),
                           None, torch.empty(1, 1, 2, 3, **meta), torch.float32)
    with pytest.raises(ValueError, match="must be"):
        depth_readout(torch.zeros(1, 8, 2, 3))
    assert (depth_readout.launches, depth_readout_grad.launches) == before


def _layouts(b=2, h=3, w=5):
    """{name: [b, 256, h, w] float32 gradient}: dense NCHW, the loss's
    channels-last view, and an odd permutation (bins last, H and W
    swapped), all of the same values."""
    dense = torch.randn(b, NUM_BINS, h, w)
    return {"dense": dense,
            "channels_last": dense.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2),
            "odd": dense.permute(0, 3, 2, 1).contiguous().permute(0, 3, 2, 1)}


@pytest.mark.parametrize("layout, want", [("dense", (NUM_BINS * 15, 15, 1)),
                                          ("channels_last", (NUM_BINS * 15, 1, NUM_BINS)),
                                          ("odd", None)])
def test_k7_reads_dense_and_channels_last_in_place_and_copies_the_rest(layout, want):
    """The wrapper's layout decision (`kernel_prob_grad`), made on the
    CPU: dense NCHW and the loss's channels-last view reach K7 as they
    are, under their (batch, bin, pixel) strides; any other layout is
    copied to dense NCHW once, and counted."""
    d_prob = _layouts()[layout]
    assert dr.prob_grad_strides(d_prob) == want
    copies = depth_readout_grad.copies
    got = dr.kernel_prob_grad(d_prob)
    assert torch.equal(got, d_prob)
    if want is None:
        assert depth_readout_grad.copies == copies + 1
        assert got.is_contiguous() and dr.prob_grad_strides(got) == (NUM_BINS * 15, 15, 1)
    else:
        assert depth_readout_grad.copies == copies and got is d_prob


def test_k7_layouts_of_one_row_column_or_batch_and_of_bf16():
    """Size-1 axes flatten whatever their strides; a lone batch entry
    gets the dense batch stride; a bf16 gradient is converted to float32
    in its own layout, not copied."""
    one_row = torch.randn(1, 1, 7, NUM_BINS).permute(0, 3, 1, 2)
    assert dr.prob_grad_strides(one_row) == (NUM_BINS * 7, 1, NUM_BINS)
    one_col = torch.randn(3, 6, 1, NUM_BINS).permute(0, 3, 1, 2)
    assert dr.prob_grad_strides(one_col) == (NUM_BINS * 6, 1, NUM_BINS)
    assert dr.prob_grad_strides(torch.randn(2, NUM_BINS, 1, 1)) == (NUM_BINS, 1, 1)
    sliced = torch.randn(3, NUM_BINS, 4, 6)[:, :, :, :5]           # rows do not flatten
    assert dr.prob_grad_strides(sliced) is None
    copies = depth_readout_grad.copies
    bf16 = _layouts()["channels_last"].bfloat16()
    got = dr.kernel_prob_grad(bf16)
    assert got.dtype == torch.float32 and torch.equal(got, bf16.float())
    assert dr.prob_grad_strides(got) == (NUM_BINS * 15, 1, NUM_BINS)
    assert depth_readout_grad.copies == copies


def test_training_loss_hands_k7_a_gradient_it_reads_in_place():
    """A small CPU training forward and loss (models/losses.py reads each
    probability NHWC): every probability gradient that reaches
    `depth_readout_grad`, one per prediction, is in a layout K7 reads in
    place, so training copies none. It arrives dense NCHW, not
    channels-last: the loss's clamp backward, `where(p >= 1e-5, grad,
    0)`, takes the layout of its condition, the probability's NCHW
    storage, though the cross-entropy's gradient before it is NHWC."""
    import chip_smoke
    from itermvs_tpu_torch.engine.train_loop import init_weights, to_device_batch
    from itermvs_tpu_torch.models import Pipeline

    iteration = 2
    model = init_weights(Pipeline(iteration=iteration, test=False), 0)
    batch = to_device_batch(chip_smoke.train_sample(64, 64, 3, 2, 0), "cpu")
    backward = DepthReadout.backward
    seen = chip_smoke.prob_grad_layouts(model, batch)
    assert DepthReadout.backward is backward and len(seen) == 1 + iteration
    for rec in seen:
        assert rec == {"layout": "dense", "strides": [NUM_BINS * 16 * 16, 16 * 16, 16, 1]}
    assert all(p.grad is None for p in model.parameters())


@pytest.mark.parametrize("cotangents", ["both", "probability"])
def test_plain_k7_on_channels_last_equals_it_on_the_dense_copy(rng, cotangents):
    """The plain version reads the loss's channels-last gradient as it
    lies and gives the dense copy's result bit for bit."""
    x, d_depth, d_prob = _vjp_inputs(rng)
    _, *saved = depth_readout_plain(_nchw(x))
    last = torch.from_numpy(d_prob).permute(0, 3, 1, 2)
    assert dr.prob_grad_strides(last)[1:] == (1, NUM_BINS)
    dd = _nchw(d_depth) if cotangents == "both" else None
    got = depth_readout_grad_plain(*saved, last, dd, torch.float32)
    want = depth_readout_grad_plain(*saved, last.contiguous(), dd, torch.float32)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
