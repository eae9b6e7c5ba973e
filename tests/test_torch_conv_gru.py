"""The ConvGRU's gates (K13 `gru_reset`, K14 `gru_update` and their
backwards K15 `gru_update_grad`, K16 `gru_reset_grad`) on the CPU, where
the port runs their plain versions: the port's `ConvGRU` with the DTU
weights carried over by `weights.py` against the JAX package's `ConvGRU`
(itermvs_tpu/models/blocks.py:168-183) on the same numpy inputs, forward
in float32 and bfloat16 and gradients in float32 against `jax.vjp`; the
Functions' plain backwards against autograd of the plain forwards and
of the eager chain they replace; the wrappers' errors.

Tolerances: float32 forward 1e-5 absolute (the convolutions sum in
another order in the two frameworks); bfloat16 forward MODULE_TOL, 2e-2
relative L2 on the hidden state, as tests/test_torch_bf16.py holds every
bf16 module against JAX (bf16 rounds at other places in XLA:CPU and in
torch; measured here 3.0e-3, the GRU's figure in that file), and the
port's forward bit-equal to the eager chain it replaced in both dtypes;
gradients 1e-5 relative L2. Each Function's backward is
bit-equal to autograd of its plain forward (the same operations and
roundings), and so are the convolutions' gradients through the module;
the module's ∂h and ∂x sum their three and two terms in another order
than the eager chain's autograd, so within 1e-6 relative L2 there (2^-7
in bfloat16, which rounds each partial sum; measured 3.0e-3).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from itermvs_tpu.engine.checkpoint import load_npz_variables
from itermvs_tpu.models.blocks import ConvGRU as JaxConvGRU
from itermvs_tpu_torch.models.blocks import ConvGRU
from itermvs_tpu_torch.ops.conv_gru import (
    GruReset, GruUpdate, gru_reset, gru_reset_grad, gru_reset_plain, gru_update,
    gru_update_grad, gru_update_plain)
from itermvs_tpu_torch.weights import flax_tree, npz_state_dict, pretrained_path

CKPT = pretrained_path("dtu")
PREFIX = "iter_mvs.update.gru."
BATCH, HEIGHT, WIDTH, HIDDEN, INPUT = 2, 12, 16, 32, 11
BF16 = torch.bfloat16
MODULE_TOL = 2e-2       # tests/test_torch_bf16.py's bound for a bf16 module against JAX


def _rl2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _nchw(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2))).to(dtype)


@pytest.fixture(scope="module")
def jax_params():
    return {"params": load_npz_variables(CKPT)["params"]["iter_mvs"]["update"]["gru"]}


@pytest.fixture(scope="module")
def port_grus():
    """{dtype: the port's ConvGRU with the DTU weights}."""
    state = {k[len(PREFIX):]: v for k, v in npz_state_dict(CKPT).items()
             if k.startswith(PREFIX)}
    out = {}
    for dt in (torch.float32, BF16):
        gru = ConvGRU(HIDDEN, INPUT, dt)
        gru.load_state_dict(state)
        out[dt] = gru
    return out


@pytest.fixture(scope="module")
def inputs():
    """Seeded NHWC float32 (hidden state in (-1, 1), x, cotangent of h')."""
    rng = np.random.RandomState(21)
    h = np.tanh(rng.randn(BATCH, HEIGHT, WIDTH, HIDDEN)).astype(np.float32)
    x = np.concatenate([rng.rand(BATCH, HEIGHT, WIDTH, 1),
                        0.5 * rng.randn(BATCH, HEIGHT, WIDTH, INPUT - 1)], -1)
    g = rng.randn(BATCH, HEIGHT, WIDTH, HIDDEN).astype(np.float32)
    return h, x.astype(np.float32), g


def eager_gru(gru, h, x):
    """The chain the kernels replaced, as eager PyTorch ran it."""
    x = x.to(h.dtype)
    hx = torch.cat([h, x], dim=1)
    z = torch.sigmoid(gru.convz(hx))
    r = torch.sigmoid(gru.convr(hx))
    q = torch.tanh(gru.convq(torch.cat([r * h, x], dim=1)))
    return (1.0 - z) * h + z * q


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(jax_params, port_grus, inputs, dtype):
    h, x, _ = inputs
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, BF16)
    h_j = jnp.asarray(h).astype(jdt)
    want = JaxConvGRU(HIDDEN, dtype=jdt).apply(jax_params, h_j, jnp.asarray(x))
    gru = port_grus[tdt]
    with torch.no_grad():
        got = gru(_nchw(_np(h_j), tdt), _nchw(x))
        eager = eager_gru(gru, _nchw(_np(h_j), tdt), _nchw(x))
    assert got.dtype == tdt and want.dtype == jdt
    assert torch.equal(got, eager)
    got = _np(got).transpose(0, 2, 3, 1)
    if dtype == "float32":
        assert np.abs(got - _np(want)).max() <= 1e-5
    else:
        assert _rl2(got, _np(want)) <= MODULE_TOL


def test_gradients_match_jax_vjp(jax_params, port_grus, inputs):
    """∂h, ∂x and ∂ of each convolution's weights and bias, float32:
    autograd through GruReset and GruUpdate (their plain backwards)
    against jax.vjp of the JAX ConvGRU."""
    h, x, g = inputs
    jax_gru = JaxConvGRU(HIDDEN)
    _, vjp = jax.vjp(lambda p, a, b: jax_gru.apply(p, a, b), jax_params, jnp.asarray(h),
                     jnp.asarray(x))
    d_params, d_h, d_x = vjp(jnp.asarray(g))

    gru = port_grus[torch.float32]
    gru.zero_grad()
    h_t = _nchw(h).requires_grad_()
    x_t = _nchw(x).requires_grad_()
    gru(h_t, x_t).backward(_nchw(g))
    assert _rl2(_np(h_t.grad).transpose(0, 2, 3, 1), _np(d_h)) <= 1e-5
    assert _rl2(_np(x_t.grad).transpose(0, 2, 3, 1), _np(d_x)) <= 1e-5
    port = flax_tree({PREFIX + k: p.grad for k, p in gru.named_parameters()})
    port = port["params"]["iter_mvs"]["update"]["gru"]
    for gate in ("convz", "convr", "convq"):
        for name in ("kernel", "bias"):
            assert _rl2(port[gate]["conv"][name], _np(d_params["params"][gate]["conv"][name])
                        ) <= 1e-5, (gate, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_backwards_equal_autograd(port_grus, inputs, dtype):
    """Each Function's backward bit-equal to autograd of its plain
    forward; through the module, the convolutions' gradients bit-equal to
    autograd of the eager chain, and ∂h, ∂x within 1e-6 (bfloat16: 2^-7)
    relative L2 of it."""
    tdt = torch.float32 if dtype == "float32" else BF16
    rng = np.random.RandomState(7)
    draw = lambda c: torch.from_numpy(rng.randn(BATCH, c, HEIGHT, WIDTH).astype(np.float32)
                                      ).to(tdt)
    z_l, q_l, h, g = (draw(HIDDEN) for _ in range(4))
    r_l, hx, big_g = draw(HIDDEN), draw(HIDDEN + INPUT), draw(HIDDEN + INPUT)
    for fn, plain, args, grad in ((GruUpdate, gru_update_plain, (z_l, q_l, h), g),
                                  (GruReset, gru_reset_plain, (r_l, hx), big_g)):
        leaves = [a.clone().requires_grad_() for a in args]
        fn.apply(*leaves).backward(grad)
        want = [a.clone().requires_grad_() for a in args]
        plain(*want).backward(grad)
        for got_leaf, want_leaf in zip(leaves, want):
            assert torch.equal(got_leaf.grad, want_leaf.grad), fn.__name__

    gru = port_grus[tdt]
    h0, x, cot = inputs
    grads = []
    for forward in (gru.forward, lambda a, b: eager_gru(gru, a, b)):
        gru.zero_grad()
        h_t = _nchw(h0, tdt).requires_grad_()
        x_t = _nchw(x).requires_grad_()
        forward(h_t, x_t).backward(_nchw(cot, tdt))
        grads.append([h_t.grad, x_t.grad] + [p.grad for p in gru.parameters()])
    # ∂h and ∂x: another order of their sums' terms; bf16 rounds each
    # partial sum, up to 2^-8 relative, so two bf16 steps there.
    tol = 1e-6 if dtype == "float32" else 2.0 ** -7
    for got, want in zip(grads[0][:2], grads[1][:2]):
        assert _rl2(_np(got), _np(want)) <= tol
    for got, want in zip(grads[0][2:], grads[1][2:]):
        assert torch.equal(got, want)


def test_functions_pass_gradcheck():
    """GruReset and GruUpdate in float64 (their plain versions) under
    torch.autograd.gradcheck."""
    gen = torch.Generator().manual_seed(3)
    draw = lambda c: torch.randn(1, c, 3, 5, dtype=torch.float64,
                                 generator=gen).requires_grad_()
    assert torch.autograd.gradcheck(GruUpdate.apply, (draw(4), draw(4), draw(4)))
    assert torch.autograd.gradcheck(GruReset.apply, (draw(4), draw(6)))


def test_wrappers_check_shapes_and_layouts():
    """Shapes are checked on every device; a kernel's inputs (any device
    but the CPU) must be contiguous, of one dtype of float32 and bfloat16,
    and on a CUDA device."""
    cpu = lambda *s: torch.zeros(*s)
    with pytest.raises(ValueError, match="gru_update: shapes"):
        gru_update(cpu(1, 4, 3, 5), cpu(1, 4, 3, 5), cpu(1, 4, 3, 6))
    with pytest.raises(ValueError, match="gru_update_grad: shapes"):
        gru_update_grad(cpu(1, 4, 3, 5), cpu(1, 4, 3, 5), cpu(1, 4, 3, 5), cpu(2, 4, 3, 5))
    with pytest.raises(ValueError, match="hidden < C"):
        gru_reset(cpu(1, 4, 3, 5), cpu(1, 4, 3, 5))
    with pytest.raises(ValueError, match="hidden < C"):
        gru_reset(cpu(1, 4, 3, 5), cpu(1, 6, 5, 3))
    with pytest.raises(ValueError, match="gru_reset_grad: shapes"):
        gru_reset_grad(cpu(1, 4, 3, 5), cpu(1, 4, 3, 5), cpu(1, 6, 3, 5))

    meta = lambda *s, dtype=torch.float32: torch.empty(*s, device="meta", dtype=dtype)
    strided = meta(1, 5, 4, 3).permute(0, 3, 1, 2)          # [1, 3, 5, 4], not contiguous
    with pytest.raises(ValueError, match="gru_update: needs contiguous"):
        gru_update(meta(1, 3, 5, 4), meta(1, 3, 5, 4), strided)
    with pytest.raises(ValueError, match="gru_reset: needs contiguous"):
        gru_reset(meta(1, 2, 5, 4), meta(1, 5, 4, 5).transpose(2, 3))
    with pytest.raises(ValueError, match="gru_reset_grad: needs one dtype"):
        gru_reset_grad(meta(1, 6, 3, 5, dtype=BF16), meta(1, 4, 3, 5), meta(1, 6, 3, 5))
    with pytest.raises(ValueError, match="gru_update_grad: needs one dtype"):
        gru_update_grad(*(meta(1, 4, 3, 5, dtype=torch.float64),) * 4)
    with pytest.raises(ValueError, match="on one CUDA device"):
        gru_update(*(meta(1, 4, 3, 5),) * 3)
