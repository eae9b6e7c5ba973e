"""The plane sweep's backward (`ops/sweep_grad.py`: `SweepCorr`, and the
plain versions of K4 `sweep_grad_ref` and K5 `sweep_grad_src`) against
JAX's autodiff of `chunked_warp_corr`, against torch autograd of the
plain forward, and by `gradcheck`; and the flax-statistics BatchNorm.

On the CPU the wrappers run their plain versions (the CUDA kernels are
held against those same versions on the card by chip_smoke.py).

Tolerances: gradients 1e-5 × max|want| (f32 sums over samples and
corners in another order than XLA's scatter and reduce); gradcheck in
float64 at its defaults; BatchNorm output and running statistics
1e-5 × max|want| (two-pass against flax's one-pass variance).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from itermvs_tpu.models.blocks import BatchNorm as JaxBatchNorm
from itermvs_tpu.models.itermvs import chunked_warp_corr as jax_chunked_warp_corr
from itermvs_tpu.ops.warping import pack_bilinear
from itermvs_tpu_torch.models.blocks import BatchNorm
from itermvs_tpu_torch.models.itermvs import GROUPS
from itermvs_tpu_torch.ops import sweep
from itermvs_tpu_torch.ops.sweep import sample_chunks, sweep_premul_plain
from itermvs_tpu_torch.ops.sweep_epilogue import corr_epilogue_plain
from itermvs_tpu_torch.ops.sweep_grad import (
    SweepCorr, sweep_grad_ref, sweep_grad_ref_plain, sweep_grad_src,
    sweep_grad_src_plain)
from tests.test_torch_sweep import _sweep_inputs


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def _port_grads(src, ref, idx, taps, cot):
    """SweepCorr's (d_src, d_ref) for the cotangent `cot` [B, n, G, HW]."""
    b, h, w, c = ref.shape
    s = torch.from_numpy(src).requires_grad_()
    r = torch.from_numpy(ref.reshape(b, h * w, c)).requires_grad_()
    corr = SweepCorr.apply(s, r, torch.from_numpy(idx), torch.from_numpy(taps), GROUPS)
    corr.backward(torch.from_numpy(cot))
    return s.grad.numpy(), r.grad.reshape(b, h, w, c).numpy()


# The three levels' channel counts, the init sweep's 32 samples at C = 48,
# and a pile-up (every row of batch 0 on one source cell, the largest
# bucket K5 can meet); one sample per chunk forced.
@pytest.mark.parametrize("b,n,c,h1,w1,pile_up", [
    (2, 4, 16, 12, 16, False), (2, 4, 32, 6, 8, False), (1, 5, 48, 3, 4, False),
    (2, 32, 48, 6, 8, False), (2, 32, 48, 6, 8, True), (2, 4, 16, 12, 16, True)])
def test_sweep_backward_matches_jax_vjp(rng, monkeypatch, b, n, c, h1, w1, pile_up):
    h, w = 6, 8
    monkeypatch.setattr(sweep, "PREMUL_BUDGET_BYTES", 1)
    assert len(sample_chunks(b, n, h * w, c)) == n
    src, ref, idx, taps = _sweep_inputs(rng, b, n, h, w, h1, w1, c)
    if pile_up:
        idx[0] = (h1 // 2) * w1 + w1 // 2
    cot = rng.randn(b, n, h, w, GROUPS).astype(np.float32)

    def f(s, r):
        return jax_chunked_warp_corr(pack_bilinear(s), r, jnp.asarray(idx),
                                     [jnp.asarray(t) for t in taps], (n, h, w, c), GROUPS)

    _, vjp = jax.vjp(f, jnp.asarray(src), jnp.asarray(ref))
    want_src, want_ref = vjp(jnp.asarray(cot))
    got_src, got_ref = _port_grads(
        src, ref, idx, taps, cot.reshape(b, n, h * w, GROUPS).transpose(0, 1, 3, 2).copy())
    _close(got_src, want_src)
    _close(got_ref, want_ref)


@pytest.mark.parametrize("c", [16, 48])
def test_sweep_backward_matches_autograd_of_plain_forward(rng, c):
    b, n, h, w, h1, w1 = 2, 3, 5, 7, 6, 9
    src, ref, idx, taps = _sweep_inputs(rng, b, n, h, w, h1, w1, c)
    cot = rng.randn(b, n, GROUPS, h * w).astype(np.float32)
    s = torch.from_numpy(src).requires_grad_()
    r = torch.from_numpy(ref.reshape(b, h * w, c)).requires_grad_()
    premul = sweep_premul_plain(s, torch.from_numpy(idx.reshape(b, -1)),
                                torch.from_numpy(taps.reshape(4, b, -1)), r, n)
    corr = corr_epilogue_plain(premul.reshape(b * n * h * w, 4 * c), b * n, GROUPS)
    corr.reshape(GROUPS, b, n, h * w).permute(1, 2, 0, 3).backward(torch.from_numpy(cot))
    got_src, got_ref = _port_grads(src, ref, idx, taps, cot)
    _close(got_src, s.grad.numpy())
    _close(got_ref, r.grad.reshape(b, h, w, c).numpy())


def test_sweep_backward_gradcheck_float64(rng):
    b, n, h, w, h1, w1, c = 1, 2, 2, 3, 3, 4, 16
    src, ref, idx, taps = _sweep_inputs(rng, b, n, h, w, h1, w1, c)
    s = torch.from_numpy(src.astype(np.float64)).requires_grad_()
    r = torch.from_numpy(ref.reshape(b, h * w, c).astype(np.float64)).requires_grad_()
    t = torch.from_numpy(taps.astype(np.float64))
    assert torch.autograd.gradcheck(
        lambda s_, r_: SweepCorr.apply(s_, r_, torch.from_numpy(idx), t, GROUPS), (s, r))


def test_backward_drops_corners_past_the_edge():
    """Bases in the last column, one in the last row: only the corners
    on the map get gradient."""
    b, h1, w1, c = 1, 4, 4, 16
    base = torch.tensor([[(h1 - 1) * w1 + w1 - 1, 2 * w1 - 1]], dtype=torch.int32)  # n=1, HW=2
    taps = torch.ones(4, 1, 2)
    ref = torch.arange(2 * c, dtype=torch.float32).reshape(1, 2, c)
    grad = torch.ones(1, 1, GROUPS, 2)
    d_src = sweep_grad_src(ref, base, taps, grad, h1, w1)
    cg = c // GROUPS
    want = torch.zeros(1, h1, w1, c)
    want[0, h1 - 1, w1 - 1] = ref[0, 0] / cg
    want[0, 1, w1 - 1] = ref[0, 1] / cg
    want[0, 2, w1 - 1] = ref[0, 1] / cg                     # (y+1, x) of the second
    assert torch.equal(d_src, want)
    src = torch.ones(1, h1, w1, c)
    d_ref = sweep_grad_ref(src, base, taps, grad)
    assert torch.equal(d_ref, torch.tensor([1.0, 2.0]).reshape(1, 2, 1).expand(1, 2, c) / cg)


def test_new_wrappers_never_fall_back_off_the_cpu():
    args = (torch.empty(1, 8, dtype=torch.int32, device="meta"),
            torch.empty(4, 1, 8, device="meta"), torch.empty(1, 2, GROUPS, 4, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        sweep_grad_ref(torch.empty(1, 4, 4, 16, device="meta"), *args)
    with pytest.raises(ValueError, match="unsupported device"):
        sweep_grad_src(torch.empty(1, 4, 16, device="meta"), *args, 4, 4)
    with pytest.raises(ValueError, match="do not agree"):
        sweep_grad_ref(torch.zeros(1, 4, 4, 16), torch.zeros(1, 7, dtype=torch.int32),
                       torch.zeros(4, 1, 8), torch.zeros(1, 2, GROUPS, 4))


def test_plain_versions_are_the_wrappers_on_the_cpu(rng):
    b, n, h, w, h1, w1, c = 1, 2, 3, 4, 5, 6, 32
    src, ref, idx, taps = _sweep_inputs(rng, b, n, h, w, h1, w1, c)
    args = (torch.from_numpy(idx.reshape(b, -1)), torch.from_numpy(taps.reshape(4, b, -1)),
            torch.from_numpy(rng.randn(b, n, GROUPS, h * w).astype(np.float32)))
    before = (sweep_grad_ref.launches, sweep_grad_src.launches)
    assert torch.equal(sweep_grad_ref(torch.from_numpy(src), *args),
                       sweep_grad_ref_plain(torch.from_numpy(src), *args))
    r = torch.from_numpy(ref.reshape(b, h * w, c))
    assert torch.equal(sweep_grad_src(r, *args, h1, w1), sweep_grad_src_plain(r, *args, h1, w1))
    assert (sweep_grad_ref.launches, sweep_grad_src.launches) == before


def test_batchnorm_train_mode_matches_flax(rng):
    """Output and updated running statistics against flax's BatchNorm, on
    a B·V = 6 fold at 8×12 (576 values per channel: torch's unbiased
    running variance would be 0.17% off, beyond the tolerance)."""
    c = 16
    x = (rng.randn(6, 8, 12, c) * 1.7 + 0.6).astype(np.float32)
    scale, bias = rng.rand(c).astype(np.float32) + 0.5, rng.randn(c).astype(np.float32)
    mean, var = rng.randn(c).astype(np.float32), rng.rand(c).astype(np.float32) + 0.5
    variables = {"params": {"bn": {"scale": scale, "bias": bias}},
                 "batch_stats": {"bn": {"mean": mean, "var": var}}}
    want, mutated = JaxBatchNorm().apply(variables, jnp.asarray(x), True,
                                         mutable=["batch_stats"])
    bn = BatchNorm(c)
    with torch.no_grad():
        for t, v in ((bn.weight, scale), (bn.bias, bias), (bn.running_mean, mean),
                     (bn.running_var, var)):
            t.copy_(torch.from_numpy(v))
    bn.train()
    got = bn(torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(got.detach().permute(0, 2, 3, 1).numpy(), want)
    stats = mutated["batch_stats"]["bn"]
    _close(bn.running_mean.numpy(), stats["mean"])
    _close(bn.running_var.numpy(), stats["var"])
    assert int(bn.num_batches_tracked) == 1
    # Eval mode normalizes with the running statistics, as flax does.
    bn.eval()
    want_eval = JaxBatchNorm().apply({"params": variables["params"], "batch_stats": mutated[
        "batch_stats"]}, jnp.asarray(x), False)
    _close(bn(torch.from_numpy(x).permute(0, 3, 1, 2)).detach().permute(0, 2, 3, 1).numpy(),
           want_eval)
