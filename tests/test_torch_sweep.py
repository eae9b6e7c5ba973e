"""The plane-sweep kernels' plain versions against the JAX package.

On the CPU the wrappers of K1 `corr_epilogue` and K2 `sweep_premul`
run their plain PyTorch versions (the CUDA kernels are held against
those same versions on the card by chip_smoke.py). JAX's Pallas kernel
runs in interpret mode, with the fixture of tests/test_sweep_epilogue.py.

Tolerances: K1 5e-6 × max|want| (as tests/test_sweep_epilogue.py: a
4·C/G-term f32 sum in another order); K2 1e-6 × max|want| (the same
three-float products); the K2 → K1 chain against `chunked_warp_corr`
1e-5 × max|want| (the JAX chain sums corners before multiplying by the
reference feature, the port after).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from itermvs_tpu.models.itermvs import chunked_warp_corr as jax_chunked_warp_corr
from itermvs_tpu.ops import sweep_epilogue as jax_sweep_epilogue
from itermvs_tpu.ops.grid_sample import pack_corners
from itermvs_tpu.ops.warping import pack_bilinear
from itermvs_tpu_torch.models.itermvs import GROUPS, chunked_warp_corr
from itermvs_tpu_torch.ops import sweep
from itermvs_tpu_torch.ops import sweep_epilogue
from itermvs_tpu_torch.ops.sweep import sample_chunks, sweep_premul
from itermvs_tpu_torch.ops.sweep_epilogue import corr_epilogue


@pytest.fixture
def interpret_mode(monkeypatch):
    """Force pallas_call to interpret mode on the CPU test platform."""
    from jax.experimental import pallas as pl

    real = pl.pallas_call

    def fake(*args, **kwargs):
        kwargs["interpret"] = True
        return real(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", fake)
    jax_sweep_epilogue._epilogue_call.clear_cache()
    yield
    jax_sweep_epilogue._epilogue_call.clear_cache()


@pytest.mark.parametrize("n,hw,c", [(4, 1536, 16), (2, 1536, 48), (8, 512, 32)])
def test_corr_epilogue_matches_pallas_kernel(interpret_mode, n, hw, c, rng):
    premul = rng.rand(n * hw, 4 * c).astype(np.float32) * 2 - 1
    want = np.asarray(jax_sweep_epilogue.corr_epilogue(jnp.asarray(premul), n, GROUPS))
    oracle = np.asarray(jax_sweep_epilogue.corr_epilogue_reference(
        jnp.asarray(premul), n, GROUPS))
    got = corr_epilogue(torch.from_numpy(premul), n, GROUPS).numpy()
    assert got.shape == want.shape == (GROUPS, n, hw) and got.dtype == np.float32
    tol = 5e-6 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    np.testing.assert_allclose(got, oracle, rtol=0, atol=tol)


def _sweep_inputs(rng, b, n, h, w, h1, w1, c):
    src = rng.rand(b, h1, w1, c).astype(np.float32) * 2 - 1
    ref = rng.rand(b, h, w, c).astype(np.float32) * 2 - 1
    # Base indices over the whole table, the last row and column included.
    idx = rng.randint(0, h1 * w1, (b, n, h * w)).astype(np.int32)
    idx[:, 0, :w1] = (h1 - 1) * w1 + np.arange(min(w1, h * w))[:w1]
    idx[:, -1, :h1] = np.arange(h1)[: h * w] * w1 + (w1 - 1)
    taps = rng.rand(4, b, n, h * w).astype(np.float32)
    return src, ref, idx, taps


@pytest.mark.parametrize("b", [1, 2])
def test_sweep_premul_matches_jax_gather_premultiply(rng, b):
    n, h, w, h1, w1, c = 3, 5, 7, 6, 9, 16
    src, ref, idx, taps = _sweep_inputs(rng, b, n, h, w, h1, w1, c)
    got = sweep_premul(torch.from_numpy(src), torch.from_numpy(idx.reshape(b, -1)),
                       torch.from_numpy(taps.reshape(4, b, -1)),
                       torch.from_numpy(ref.reshape(b, h * w, c)), n).numpy()
    assert got.shape == (b, n * h * w, 4 * c)
    table = pack_corners(jnp.asarray(src)).data          # [B, H1, W1, 4C]
    for i in range(b):
        vals = jnp.take(table[i].reshape(h1 * w1, 4 * c),
                        jnp.asarray(idx[i].reshape(-1)), axis=0)
        want = np.asarray(jax_sweep_epilogue.premultiply(
            vals, [jnp.asarray(t[i].reshape(-1)) for t in taps],
            jnp.asarray(ref[i].reshape(h * w, c)), n))
        np.testing.assert_allclose(got[i], want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("b,n,c,budget", [(1, 4, 16, None), (2, 3, 32, None),
                                          (1, 5, 48, 1)])
def test_chain_matches_jax_chunked_warp_corr(rng, monkeypatch, b, n, c, budget):
    h, w, h1, w1 = 6, 8, 12, 16
    if budget is not None:        # one sample per chunk
        monkeypatch.setattr(sweep, "PREMUL_BUDGET_BYTES", budget)
        assert len(sample_chunks(b, n, h * w, c)) == n
    src, ref, idx, taps = _sweep_inputs(rng, b, n, h, w, h1, w1, c)
    want = np.asarray(jax_chunked_warp_corr(
        pack_bilinear(jnp.asarray(src)), jnp.asarray(ref), jnp.asarray(idx),
        [jnp.asarray(t) for t in taps], (n, h, w, c), GROUPS))   # [B,N,H,W,G]
    got = chunked_warp_corr(torch.from_numpy(src),
                            torch.from_numpy(ref.reshape(b, h * w, c)),
                            torch.from_numpy(idx), torch.from_numpy(taps))
    assert got.shape == (b, n, GROUPS, h * w)
    got = got.reshape(b, n, GROUPS, h, w).permute(0, 1, 3, 4, 2).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_sample_chunks_plan():
    # 1600x1152: the init sweep (32 samples, 144x200, C=48) is 708 MB and
    # runs unsplit, as do the iteration sweeps.
    assert sample_chunks(1, 32, 144 * 200, 48) == [(0, 32)]
    assert sample_chunks(1, 4, 288 * 400, 16) == [(0, 4)]
    assert sample_chunks(1, 5, 10, 4, budget=2 * 10 * 16 * 4) == [(0, 2), (2, 4), (4, 5)]


def test_wrappers_never_fall_back_off_the_cpu():
    premul = torch.empty(64, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        corr_epilogue(premul, 4, GROUPS)
    src = torch.empty(1, 4, 4, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sweep_premul(src, torch.empty(1, 8, dtype=torch.int32, device="meta"),
                     torch.empty(4, 1, 8, device="meta"),
                     torch.empty(1, 4, 16, device="meta"), 2)


def test_wrappers_reject_bad_shapes():
    with pytest.raises(ValueError):
        corr_epilogue(torch.zeros(10, 64), 4, GROUPS)        # P % n != 0
    with pytest.raises(ValueError):
        sweep_premul(torch.zeros(1, 4, 4, 16), torch.zeros(1, 8, dtype=torch.int32),
                     torch.zeros(4, 1, 7), torch.zeros(1, 4, 16), 2)


BF16 = torch.bfloat16


def _misaligned(shape, dtype):
    """A contiguous tensor of `shape` whose data starts 2 bytes past a
    16-byte boundary."""
    flat = torch.zeros(int(np.prod(shape)) + 8, dtype=dtype)
    return flat[1:1 + int(np.prod(shape))].view(shape)


@pytest.mark.parametrize("c,groups,dtype,ok", [
    (16, 8, BF16, True), (32, 8, BF16, True), (48, 8, BF16, True), (8, 8, BF16, True),
    (256, 8, BF16, True), (96, 8, BF16, True),
    (20, 4, BF16, False),        # C % 8
    (40, 8, BF16, False),        # cg = 5: lcm(8, 5) > 32 channels a thread
    (80, 8, BF16, False),        # cg = 10
    (16, 8, torch.float16, False),
    (20, 4, torch.float32, True), (40, 8, torch.float32, True)])
def test_corr_epilogue_kernel_refuses_what_it_does_not_take(c, groups, dtype, ok):
    """The checks the wrapper makes before a CUDA launch (no fallback):
    the bf16 kernel takes C % 8 == 0 and lcm(8, C/G) <= 32 (every C the
    model uses at G = 8), the f32 kernel any C that G divides."""
    premul = torch.zeros(6, 4 * c, dtype=dtype)
    if ok:
        sweep_epilogue.check_kernel_input(premul, groups)
    else:
        with pytest.raises(ValueError):
            sweep_epilogue.check_kernel_input(premul, groups)


def test_kernels_refuse_misaligned_or_strided_bf16():
    with pytest.raises(ValueError, match="16-byte"):
        sweep_epilogue.check_kernel_input(_misaligned((6, 64), BF16), GROUPS)
    with pytest.raises(ValueError, match="contiguous"):
        sweep_epilogue.check_kernel_input(torch.zeros(64, 6, dtype=BF16).T, GROUPS)
    with pytest.raises(ValueError, match="groups"):
        sweep_epilogue.check_kernel_input(torch.zeros(6, 64 * 8, dtype=BF16), 64)
    base = torch.zeros(1, 8, dtype=torch.int32)
    taps = torch.zeros(4, 1, 8, dtype=BF16)
    ref = torch.zeros(1, 4, 16, dtype=BF16)
    with pytest.raises(ValueError, match="16-byte"):
        sweep.check_kernel_input(_misaligned((1, 4, 4, 16), BF16), base, taps, ref)
    with pytest.raises(ValueError, match="16-byte"):
        sweep.check_kernel_input(torch.zeros(1, 4, 4, 16, dtype=BF16), base, taps,
                                 _misaligned((1, 4, 16), BF16))


@pytest.mark.parametrize("c,dtype,ok", [
    (8, BF16, True), (16, BF16, True), (48, BF16, True), (256, BF16, True),
    (12, BF16, False), (264, BF16, False), (4, torch.float32, True), (6, torch.float32, False)])
def test_sweep_premul_kernel_refuses_what_it_does_not_take(c, dtype, ok):
    src = torch.zeros(2, 3, 5, c, dtype=dtype)
    args = (src, torch.zeros(2, 8, dtype=torch.int32), torch.zeros(4, 2, 8, dtype=dtype),
            torch.zeros(2, 4, c, dtype=dtype))
    if ok:
        sweep.check_kernel_input(*args)
    else:
        with pytest.raises(ValueError):
            sweep.check_kernel_input(*args)


def test_sweep_premul_bf16_kernel_needs_32_bit_offsets():
    """The bf16 kernel offsets each batch's source map in 32 bits."""
    def inputs(h1, dtype):
        return (torch.empty(1, h1, 2 ** 14, 8, dtype=dtype, device="meta"),
                torch.empty(1, 8, dtype=torch.int32, device="meta"),
                torch.empty(4, 1, 8, dtype=dtype, device="meta"),
                torch.empty(1, 4, 8, dtype=dtype, device="meta"))
    sweep.check_kernel_input(*inputs(2 ** 14 - 1, BF16))
    sweep.check_kernel_input(*inputs(2 ** 14, torch.float32))
    with pytest.raises(ValueError, match="2\\^31"):
        sweep.check_kernel_input(*inputs(2 ** 14, BF16))
