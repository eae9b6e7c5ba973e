"""FeatureNet's FPN top-down add (K19 `upsample2x_add` and its backward
K20 `upsample2x_grad`) on the CPU, where the port runs their plain
versions: the forward against the JAX package's
`upsample_bilinear(x, 2) + l` (itermvs_tpu/ops/resize.py, the matrix form
FeatureNet uses at itermvs_tpu/models/feature_net.py:98-102), ∂x against
`jax.vjp` of the same, `Upsample2xAdd`'s backward against autograd of the
plain chain and gradcheck, at h, w of 1, 2, odd and FeatureNet's own
(level 3 of a 64x80 image) with C = 48; FeatureNet's two
calls; chip_smoke's helpers for the card's check.

Tolerances: float32 1e-5 of max|JAX| (tests/test_torch_ops.py's: the
same arithmetic, XLA's in the matrix form); bfloat16 2e-2 relative L2
(tests/test_torch_bf16.py's MODULE_TOL: bf16 rounds at other places in
XLA:CPU and in torch). The plain ∂x sums in float64 and rounds once, so
it lies within one unit in the last place of the exact float64 sum in
both dtypes, and within 1e-6 of max (float32) of autograd through
F.interpolate, which sums in float32; ∂l is ∂out itself.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from itermvs_tpu.ops.resize import upsample_bilinear as jax_upsample_bilinear
from itermvs_tpu_torch.ops.resize import (
    Upsample2xAdd, upsample2x_add, upsample2x_add_plain, upsample2x_grad,
    upsample2x_grad_plain)

BF16 = torch.bfloat16
MODULE_TOL = 2e-2       # tests/test_torch_bf16.py's bound for a bf16 module against JAX
CHANNELS = 48
# (h, w) of x: one pixel, 2x2, a column, odd, FeatureNet's level 3 of a
# 64x80 image.
SHAPES = ((1, 1), (2, 2), (7, 1), (5, 7), (8, 10))
JNP = {torch.float32: jnp.float32, BF16: jnp.bfloat16}


def _inputs(h, w, seed=0, batch=2):
    rng = np.random.RandomState(seed)
    x = rng.randn(batch, CHANNELS, h, w).astype(np.float32)
    lat = rng.randn(batch, CHANNELS, 2 * h, 2 * w).astype(np.float32)
    g = rng.randn(batch, CHANNELS, 2 * h, 2 * w).astype(np.float32)
    return x, lat, g


def _jax_chain(dtype):
    """The JAX FPN add on NCHW numpy input, in `dtype`."""
    def chain(x, lat):
        up = jax_upsample_bilinear(jnp.transpose(x, (0, 2, 3, 1)), 2)
        return jnp.transpose(up, (0, 3, 1, 2)) + lat
    return chain


def _np(t):
    return np.asarray(jnp.asarray(t).astype(jnp.float32)) if not isinstance(t, torch.Tensor) \
        else t.detach().float().numpy()


def _hold(got, want, dtype):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    else:
        rl2 = np.linalg.norm(got.astype(np.float64) - want) / np.linalg.norm(want)
        assert rl2 <= MODULE_TOL, rl2


def _ulps(got, exact, dtype):
    return chip_smoke.ulps(got, exact, dtype).max().item()


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("hw", SHAPES, ids=[f"{h}x{w}" for h, w in SHAPES])
def test_plain_forward_and_grad_match_jax(hw, dtype):
    """upsample2x_add_plain against JAX's resize + add, and
    upsample2x_grad_plain against jax.vjp of it (∂x; ∂l is ∂out)."""
    x, lat, g = _inputs(*hw)
    jt = JNP[dtype]
    jx, jl, jg = (jnp.asarray(a).astype(jt) for a in (x, lat, g))
    want, vjp = jax.vjp(_jax_chain(dtype), jx, jl)
    want_dx, want_dl = vjp(jg)
    tx, tl, tg = (torch.from_numpy(a).to(dtype) for a in (x, lat, g))
    out = upsample2x_add_plain(tx, tl)
    assert out.dtype == dtype
    _hold(out, want, dtype)
    d_x = upsample2x_grad_plain(tg, hw)
    assert d_x.dtype == dtype and d_x.is_contiguous()
    _hold(d_x, want_dx, dtype)
    np.testing.assert_array_equal(_np(want_dl), _np(tg))
    # Rounded once from the float64 sum.
    assert _ulps(d_x, upsample2x_grad_plain(tg.double(), hw), dtype) <= 0.5


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("hw", SHAPES, ids=[f"{h}x{w}" for h, w in SHAPES])
def test_function_backward_matches_autograd_of_the_plain_chain(hw, dtype):
    """Upsample2xAdd (the plain versions on the CPU): the output equals
    the plain chain's bit for bit, ∂l is ∂out, ∂x agrees with autograd
    through F.interpolate and lies within one unit in the last place of
    the float64 sum where autograd's float32 sum may not."""
    x, lat, g = (torch.from_numpy(a).to(dtype) for a in _inputs(*hw, seed=1))
    xa, la = x.clone().requires_grad_(), lat.clone().requires_grad_()
    out = upsample2x_add(xa, la)
    assert out.grad_fn is not None and type(out.grad_fn).__name__ == "Upsample2xAddBackward"
    d_x, d_l = torch.autograd.grad(out, (xa, la), g)
    xp, lp = x.clone().requires_grad_(), lat.clone().requires_grad_()
    plain = upsample2x_add_plain(xp, lp)
    want_x, want_l = torch.autograd.grad(plain, (xp, lp), g)
    assert torch.equal(out.detach(), plain.detach())
    assert torch.equal(d_l, want_l) and torch.equal(d_l, g)
    exact = upsample2x_grad_plain(g.double(), hw)
    assert _ulps(d_x, exact, dtype) <= 0.5
    if dtype == torch.float32:
        np.testing.assert_allclose(d_x.numpy(), want_x.numpy(), rtol=0,
                                   atol=1e-6 * want_x.abs().max().item())
    else:
        _hold(d_x, want_x, dtype)


def test_gradcheck():
    """Upsample2xAdd in float64 at the edges: one-pixel, one-row and odd
    maps."""
    gen = torch.Generator().manual_seed(2)
    for h, w in ((1, 1), (1, 3), (3, 2)):
        x = torch.randn(1, 2, h, w, dtype=torch.float64, generator=gen, requires_grad=True)
        lat = torch.randn(1, 2, 2 * h, 2 * w, dtype=torch.float64, generator=gen,
                          requires_grad=True)
        assert torch.autograd.gradcheck(Upsample2xAdd.apply, (x, lat))


def test_no_grad_runs_the_forward_alone():
    x, lat, _ = (torch.from_numpy(a) for a in _inputs(2, 3))
    with torch.no_grad():
        out = upsample2x_add(x.requires_grad_(), lat)
    assert out.grad_fn is None and torch.equal(out, upsample2x_add_plain(x.detach(), lat))


def test_the_wrappers_raise_on_what_the_kernels_do_not_take():
    """Shapes anywhere; dtype, layout and device before any launch
    (meta tensors: no CPU plain version, no card). K20 copies a ∂out that
    is not contiguous once and counts it."""
    x = torch.empty(2, 3, 4, 5, device="meta")
    lat = torch.empty(2, 3, 8, 10, device="meta")
    with pytest.raises(ValueError, match="lateral"):
        upsample2x_add(torch.zeros(2, 3, 4, 5), torch.zeros(2, 3, 8, 9))
    with pytest.raises(ValueError, match="must be"):
        upsample2x_add(torch.zeros(3, 4, 5), torch.zeros(3, 8, 10))
    with pytest.raises(ValueError, match="dtype"):
        upsample2x_add(x.half(), lat.half())
    with pytest.raises(ValueError, match="dtype"):
        upsample2x_add(x, lat.to(BF16))
    with pytest.raises(ValueError, match="contiguous"):
        upsample2x_add(x, torch.empty(2, 3, 10, 8, device="meta").transpose(2, 3))
    with pytest.raises(ValueError, match="CUDA"):
        upsample2x_add(x, lat)
    with pytest.raises(ValueError, match="∂out"):
        upsample2x_grad(torch.zeros(2, 3, 8, 9), (4, 5))
    upsample2x_grad.copies = 0
    with pytest.raises(ValueError, match="CUDA"):
        upsample2x_grad(torch.empty(2, 8, 10, 3, device="meta").permute(0, 3, 1, 2), (4, 5))
    assert upsample2x_grad.copies == 1
    chip_smoke.reset_launch_counts()
    assert upsample2x_grad.copies == 0
    with pytest.raises(ValueError, match="dtype"):
        upsample2x_grad(lat.double(), (4, 5))


def test_featurenet_runs_its_two_fpn_adds_through_the_wrapper(monkeypatch):
    """FeatureNet calls upsample2x_add once per FPN add (chip_smoke's
    FPN_CALLS: 48 channels from 1/8 and from 1/4), under the `fpn_add`
    label, and a training backward goes through Upsample2xAdd twice."""
    from torch.profiler import ProfilerActivity, profile

    from itermvs_tpu_torch.models import feature_net
    from itermvs_tpu_torch.models.feature_net import FeatureNet

    seen, backwards = [], []
    plain = feature_net.upsample2x_add

    def record(x, lat):
        seen.append((x.shape[1], 64 // x.shape[2]))
        return plain(x, lat)

    monkeypatch.setattr(feature_net, "upsample2x_add", record)
    backward = Upsample2xAdd.backward

    def capture(ctx, grad):
        backwards.append(tuple(grad.shape))
        return backward(ctx, grad)

    monkeypatch.setattr(Upsample2xAdd, "backward", staticmethod(capture))
    net = FeatureNet().train()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = net(torch.zeros(1, 3, 64, 96))
    assert seen == list(chip_smoke.FPN_CALLS)
    assert sum(e.name == "fpn_add" for e in prof.events()) == 2
    sum(v.float().sum() for v in out.values()).backward()
    assert backwards == [(1, 48, 32, 48), (1, 48, 16, 24)]


def test_up2_work_counts_each_input_and_output_once():
    """K19 reads x and the lateral and writes the output (1 + 4 + 4
    elements per element of x); K20 reads ∂out and writes ∂x (4 + 1). The
    map's 2 calls on one 1600x1152 image: 0.074 ms in float32 and 0.037
    in bfloat16; K20 over a training step's 20 images at 640x512: 0.147
    and 0.073 ms."""
    e = 2 * 3 * 4 * 5
    assert chip_smoke.up2_work(2, 3, 4, 5, 4) == (4 * 9 * e, 40 * e, chip_smoke.PEAK_F32_PER_S)
    assert chip_smoke.up2_work(2, 3, 4, 5, 2, grad=True) == (
        2 * 5 * e, 32 * e, chip_smoke.PEAK_F64_PER_S)
    bounds = chip_smoke.chain_bound_ms(1600, 1152, 5, 4)
    assert bounds["fpn_add"] == pytest.approx(0.074, abs=1e-3)
    assert chip_smoke.chain_bound_ms(1600, 1152, 5, 4, itemsize=2)["fpn_add"] == \
        pytest.approx(0.037, abs=1e-3)
    step = chip_smoke.chain_bound_ms(640, 512, 5, 4, 4, train=True)["fpn_add"]
    assert step == pytest.approx(20 * 1e3 * chip_smoke.up2_image_bytes(640, 512, 4)
                                 / chip_smoke.PEAK_BYTES_PER_S)
    grad = sum(chip_smoke.bound_ms(*chip_smoke.up2_work(20, c, 512 // s, 640 // s, it,
                                                        grad=True))[0]
               for c, s in chip_smoke.FPN_CALLS for it in (4, 2))
    assert grad == pytest.approx(0.147 + 0.073, abs=2e-3)
    assert "fpn_add" in chip_smoke.CHAINS


def test_ulps_counts_units_in_the_last_place():
    one = torch.tensor([1.0, -2.0, 0.0], dtype=torch.float64)
    step32 = torch.tensor([1.0 + 2.0 ** -23, -2.0 - 2.0 ** -22, 2.0 ** -149])
    assert chip_smoke.ulps(step32, one, torch.float32).tolist() == [1.0, 1.0, 1.0]
    step16 = torch.tensor([1.0 + 2.0 ** -7, -2.0, 0.0]).to(BF16)
    assert chip_smoke.ulps(step16, one, BF16).tolist() == [1.0, 0.0, 0.0]


def test_up2_inputs_and_edge_shapes():
    """chip_smoke's K19/K20 inputs, made on the CPU: the right shapes and
    dtype, exponents spread over 16 octaves; the edge shapes cover h and w
    of 1, 2 and odd (the scalar path) and small maps whose w is a multiple
    of 4 (the run path)."""
    gen = torch.Generator().manual_seed(0)
    for dtype in (torch.float32, BF16):
        t = chip_smoke.up2_inputs(2, 3, 5, 8, dtype, gen, dev="cpu")
        assert t["x"].shape == (2, 3, 5, 8) and t["lateral"].shape == t["g"].shape == (
            2, 3, 10, 16)
        assert all(v.dtype == dtype for v in t.values())
        octaves = torch.log2(t["g"].float().abs()).floor()
        assert octaves.max() - octaves.min() >= 12
    shapes = chip_smoke.UP2_EDGE_SHAPES
    for size in (1, 2):
        assert any(s[2] == size for s in shapes) and any(s[3] == size for s in shapes)
    assert any(s[2] % 2 and s[3] % 2 and s[3] > 1 for s in shapes)
    assert any(s[3] % 4 == 0 for s in shapes) and any(s[3] % 4 for s in shapes)


def test_profile_categories_name_k19_and_k20():
    cat = chip_smoke._category
    assert cat("void (anonymous namespace)::upsample2x_add_kernel<float, 4>(float const*, "
               "float const*, float*, long long, int, int)") == "upsample2x_add"
    assert cat("void (anonymous namespace)::upsample2x_add_kernel<__nv_bfloat16, 1>("
               "__nv_bfloat16 const*)") == "upsample2x_add_bf16"
    assert cat("void (anonymous namespace)::upsample2x_grad_kernel<float, 1>(float "
               "const*)") == "upsample2x_grad"
    assert cat("void (anonymous namespace)::upsample2x_grad_kernel<__nv_bfloat16, 4>("
               "__nv_bfloat16 const*)") == "upsample2x_grad_bf16"
    assert cat("void at::native::(anonymous namespace)::upsample_bilinear2d_out_frame<float, "
               "float>(int, float, float, bool)") == "other"


def test_kernels_are_registered_with_both_forms():
    """One templated source each, both dtype forms in its library, in the
    `kernels` line with the source and the JAX lines they replace."""
    from itermvs_tpu_torch import kernels

    sources = chip_smoke.kernel_sources()
    for name in ("upsample2x_add", "upsample2x_grad"):
        assert name in kernels.SOURCES
        assert kernels.SIGNATURES[f"{name}_bf16"][2] == name
        assert sources[name] == sources[f"{name}_bf16"] == (
            f"itermvs_tpu_torch/csrc/{name}.cu", "itermvs_tpu/models/feature_net.py:98")
    assert "upsample2x_add" in chip_smoke.REPORT_PER_MAP
    assert "upsample2x_grad_bf16" in chip_smoke.REPORT_PER_STEP


def test_ab_profile_script_needs_a_card():
    """Without a CUDA device the parent-and-change profile script exits
    non-zero and starts no run."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = os.path.join(root, "itermvs_tpu_torch", "tools", "ab_profile.py")
    out = subprocess.run([sys.executable, script, "--tree", root], capture_output=True,
                         text=True, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and "no CUDA device" in out.stderr
    assert '"run"' not in out.stdout
