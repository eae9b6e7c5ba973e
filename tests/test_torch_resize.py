"""The model's bilinear resizes (K28 `resize_bilinear` and its backward K29
`resize_bilinear_grad`) on the CPU, where the port runs their plain
versions: the forward against the JAX package's `resize_bilinear` /
`upsample_bilinear` (itermvs_tpu/ops/resize.py) at ×2, ×4 and ×½ on odd
and edge shapes, the tanh form against the JAX `Update.hidden_init` with
the DTU weights, the backward against float64 autograd through
F.interpolate, against F.interpolate's own backward (×½) and against
`jax.vjp`; `ResizeBilinear`'s gradcheck; the wrappers' refusals; the six
call sites of a training forward (five in test mode) under the `resize`
label; chip_smoke's helpers for the card's check.

Tolerances: the forward in float32 within 1e-6 of JAX (absolute, on
N(0, 1) inputs), in bfloat16 within one bfloat16 unit in the last place
at the map's largest value (JAX rounds to bfloat16 after each of its two
contractions, PyTorch once); the tanh form, whose convolutions sum in
another order, within 1e-5 of max (float32) and 2e-2 relative L2
(bfloat16, tests/test_torch_bf16.py's module bound). K29's plain ×2 sums
in float64 and rounds once, so it lies within one unit in the last place
of the exact sum; its ×½ spread is exact. Against float64 autograd of
tanh(F.interpolate(·)) and against `jax.vjp` the saved output's rounding
enters: 1e-5 of max (float32), 2e-2 relative L2 (bfloat16).
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

import chip_smoke
from itermvs_tpu.ops.resize import resize_bilinear as jax_resize_bilinear
from itermvs_tpu_torch.ops import resize as resize_ops
from itermvs_tpu_torch.ops.resize import (
    ResizeBilinear, resize, resize_forward, resize_grad, resize_grad_plain, resize_plain)

BF16 = torch.bfloat16
JNP = {torch.float32: jnp.float32, BF16: jnp.bfloat16}
MODULE_TOL = 2e-2       # tests/test_torch_bf16.py's bound for a bf16 module against JAX
# (input, output) sizes: ×2 on an odd map, ×½ to an odd one, ×4, a pixel,
# a row ×4, ×½ to a pixel.
RESIZES = (((5, 7), (10, 14)), ((10, 14), (5, 7)), ((3, 4), (12, 16)), ((1, 1), (2, 2)),
           ((1, 3), (4, 12)), ((2, 2), (1, 1)))
GRAD_RESIZES = tuple(r for r in RESIZES if r[1] in ((2 * r[0][0], 2 * r[0][1]),
                                                   (r[0][0] // 2, r[0][1] // 2)))
DTYPES = pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])


def _ids(cases):
    return [f"{a}x{b}_to_{c}x{d}" for (a, b), (c, d) in cases]


def _draw(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _jax_resize(x, out_hw, dtype, tanh=False):
    """The JAX resize (and tanh) of NCHW numpy x in `dtype`, NCHW."""
    def fn(v):
        up = jax_resize_bilinear(jnp.transpose(v, (0, 2, 3, 1)), out_hw)
        up = jnp.tanh(up) if tanh else up
        return jnp.transpose(up, (0, 3, 1, 2))
    return fn, jnp.asarray(x).astype(JNP[dtype])


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().double().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32)).astype(np.float64)


def _rel_l2(got, want):
    got, want = _np(got), _np(want)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _ulps(got, exact, dtype):
    return chip_smoke.ulps(got, exact, dtype).max().item()


@DTYPES
@pytest.mark.parametrize("sizes", RESIZES, ids=_ids(RESIZES))
def test_plain_forward_matches_jax(sizes, dtype):
    """K28's plain version (F.interpolate) against the JAX resize."""
    (ih, iw), out_hw = sizes
    x = _draw(2, 3, ih, iw)
    fn, jx = _jax_resize(x, out_hw, dtype)
    want = _np(fn(jx))
    got = resize_plain(torch.from_numpy(x).to(dtype), out_hw)
    assert got.dtype == dtype and got.shape == (2, 3, *out_hw)
    if dtype == torch.float32:
        np.testing.assert_allclose(_np(got), want, rtol=0, atol=1e-6)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        np.testing.assert_allclose(_np(got), want, rtol=0, atol=ulp)


@DTYPES
def test_tanh_form_matches_jax_hidden_init(dtype):
    """The hidden state's init: the port's `Update.hidden_init` (the head's
    convolutions, then K28's ×2 with tanh) against the JAX
    `Update.hidden_init` on the DTU weights."""
    from itermvs_tpu.engine.checkpoint import load_npz_variables
    from itermvs_tpu.models.itermvs import Update as JaxUpdate
    from itermvs_tpu_torch.models.itermvs import Update
    from itermvs_tpu_torch.weights import load_npz_weights, pretrained_path
    from itermvs_tpu_torch.models import Pipeline

    params = load_npz_variables(pretrained_path("dtu"))["params"]["iter_mvs"]["update"]
    score = _draw(2, 5, 7, 32, seed=3)                      # NHWC, level 3
    want = JaxUpdate(32, dtype=JNP[dtype]).apply({"params": params}, jnp.asarray(score),
                                                 method=JaxUpdate.hidden_init)
    update = load_npz_weights(Pipeline(iteration=1, dtype=dtype),
                              pretrained_path("dtu")).iter_mvs.update
    assert isinstance(update, Update)
    with torch.no_grad():
        got = update.hidden_init(torch.from_numpy(score).permute(0, 3, 1, 2).to(dtype))
    assert got.dtype == dtype and got.shape == (2, 32, 10, 14)
    want = np.transpose(_np(want), (0, 3, 1, 2))
    if dtype == torch.float32:
        np.testing.assert_allclose(_np(got), want, rtol=0, atol=1e-5 * np.abs(want).max())
    else:
        assert _rel_l2(got, want) <= MODULE_TOL


@DTYPES
@pytest.mark.parametrize("tanh", [False, True], ids=["plain", "tanh"])
@pytest.mark.parametrize("sizes", GRAD_RESIZES, ids=_ids(GRAD_RESIZES))
def test_plain_grad(sizes, tanh, dtype):
    """K29's plain version: ×2 within one unit in the last place of float64
    autograd through F.interpolate (of tanh_backward's ∂pre for the tanh
    form), ×½ bit-equal to F.interpolate's own backward; the tanh form
    against float64 autograd of tanh(F.interpolate(·)) and, at ×2 (the
    hidden state's ratio), against `jax.vjp` of the JAX resize and tanh;
    ResizeBilinear's backward is the plain version."""
    (ih, iw), out_hw = sizes
    x = torch.from_numpy(_draw(2, 3, ih, iw, seed=1)).to(dtype)
    g = torch.from_numpy(_draw(2, 3, *out_hw, seed=2)).to(dtype)
    y = resize_plain(x, out_hw, tanh) if tanh else None
    d_x = resize_grad_plain(g, (ih, iw), y)
    assert d_x.dtype == dtype and d_x.shape == x.shape and d_x.is_contiguous()

    xa = x.clone().requires_grad_()
    out = resize(xa, out_hw, tanh)
    assert type(out.grad_fn).__name__ == "ResizeBilinearBackward"
    assert torch.equal(out.detach(), resize_plain(x, out_hw, tanh))
    assert torch.equal(torch.autograd.grad(out, xa, g)[0], d_x)

    pre = torch.ops.aten.tanh_backward(g, y) if tanh else g
    x64 = x.double().requires_grad_()
    exact = torch.autograd.grad(F.interpolate(x64, size=out_hw, mode="bilinear",
                                              align_corners=False), x64, pre.double())[0]
    if out_hw == (2 * ih, 2 * iw):
        assert _ulps(d_x, exact, dtype) <= 1.0
    else:
        xr = x.clone().requires_grad_()
        library = torch.autograd.grad(F.interpolate(xr, size=out_hw, mode="bilinear",
                                                    align_corners=False), xr, pre)[0]
        assert torch.equal(chip_smoke.bits(d_x), chip_smoke.bits(library))
    if not tanh:
        return
    x64 = x.double().requires_grad_()
    y64 = torch.tanh(F.interpolate(x64, size=out_hw, mode="bilinear", align_corners=False))
    wants = [torch.autograd.grad(y64, x64, g.double())[0]]
    if out_hw == (2 * ih, 2 * iw):
        fn, jx = _jax_resize(_np(x).astype(np.float32), out_hw, dtype, tanh=True)
        _, vjp = jax.vjp(fn, jx)
        wants.append(vjp(jnp.asarray(_np(g).astype(np.float32)).astype(JNP[dtype]))[0])
    for want in wants:
        if dtype == torch.float32:
            np.testing.assert_allclose(_np(d_x), _np(want), rtol=0,
                                       atol=1e-5 * np.abs(_np(want)).max())
        else:
            assert _rel_l2(d_x, want) <= MODULE_TOL


def test_gradcheck():
    """ResizeBilinear in float64 at the edges: a pixel, a row, odd maps,
    ×2 with and without tanh, ×½."""
    gen = torch.Generator().manual_seed(4)
    for (h, w), out_hw, tanh in (((1, 1), (2, 2), True), ((1, 3), (2, 6), False),
                                 ((3, 2), (6, 4), True), ((4, 6), (2, 3), False),
                                 ((2, 4), (1, 2), True)):
        x = torch.randn(1, 2, h, w, dtype=torch.float64, generator=gen, requires_grad=True)
        assert torch.autograd.gradcheck(lambda v: ResizeBilinear.apply(v, out_hw, tanh), (x,))


def test_no_grad_runs_the_forward_alone():
    x = torch.from_numpy(_draw(1, 2, 3, 4)).requires_grad_()
    with torch.no_grad():
        out = resize(x, (6, 8), True)
    assert out.grad_fn is None and torch.equal(out, resize_plain(x.detach(), (6, 8), True))


def test_the_wrappers_raise_on_what_the_kernels_do_not_take():
    """K29 refuses every ratio but ×2 and ×½ (on the CPU too); K28 refuses
    the input's own size; dtype, layout and device before any launch
    (meta tensors: no CPU plain version, no card); K29 copies a ∂out that
    is not contiguous once and counts it."""
    x = torch.from_numpy(_draw(1, 2, 3, 4)).requires_grad_()
    out = resize(x, (12, 16))                                  # ×4: no backward
    with pytest.raises(ValueError, match="only ×2 and ×½"):
        out.sum().backward()
    for in_hw, g_hw in (((3, 4), (12, 16)), ((3, 4), (5, 6)), ((5, 7), (2, 3))):
        with pytest.raises(ValueError, match="only ×2 and ×½"):
            resize_grad(torch.zeros(1, 2, *g_hw), in_hw)
    with pytest.raises(ValueError, match="x's own"):
        resize_forward(torch.zeros(1, 2, 3, 4), (3, 4))
    with pytest.raises(ValueError, match="must be"):
        resize_forward(torch.zeros(2, 3, 4), (6, 8))
    with pytest.raises(ValueError, match="alike"):
        resize_grad(torch.zeros(1, 2, 6, 8), (3, 4), torch.zeros(1, 2, 6, 7))
    meta = torch.empty(1, 2, 3, 4, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        resize_forward(meta, (6, 8))
    with pytest.raises(ValueError, match="dtype"):
        resize_forward(meta.half(), (6, 8))
    with pytest.raises(ValueError, match="contiguous"):
        resize_forward(torch.empty(1, 3, 4, 2, device="meta").permute(0, 3, 1, 2), (6, 8))
    resize_grad.copies = 0
    with pytest.raises(ValueError, match="CUDA"):
        resize_grad(torch.empty(1, 6, 8, 2, device="meta").permute(0, 3, 1, 2), (3, 4))
    assert resize_grad.copies == 1
    chip_smoke.reset_launch_counts()
    assert resize_grad.copies == 0
    with pytest.raises(ValueError, match="dtype"):
        resize_grad(torch.empty(1, 2, 6, 8, device="meta"), (3, 4),
                    torch.empty(1, 2, 6, 8, device="meta", dtype=BF16))


def test_k28_reads_a_batch_strided_input(monkeypatch):
    """A view's slice of [B, V, C, H, W] passes with its batch stride;
    a batch entry that is not contiguous NCHW raises; one image needs no
    stride."""
    monkeypatch.setattr(resize_ops, "_stream", lambda: 0)
    stacked = torch.zeros(2, 5, 3, 4, 6)
    assert resize_ops.batch_stride(stacked[:, 0]) == 5 * 3 * 4 * 6
    assert resize_ops.batch_stride(stacked[:1, 2]) == 3 * 4 * 6
    with pytest.raises(ValueError, match="contiguous"):
        resize_ops.batch_stride(stacked[:, :, 0])
    with pytest.raises(ValueError, match="contiguous"):
        resize_ops.batch_stride(torch.zeros(2, 4, 6, 3).permute(0, 3, 1, 2))
    args = resize_ops.resize_args(stacked[:, 1], torch.zeros(2, 3, 8, 12), True)
    assert args[2:10] == (2, 3, 5 * 3 * 4 * 6, 4, 6, 8, 12, 1)


def test_the_model_resizes_through_k28_under_its_label(monkeypatch):
    """A training forward calls K28's wrapper at the six sites of
    chip_smoke's RESIZE_SITES (in float32 or the compute dtype as listed,
    tanh at the hidden state), each under the `resize` label, and its
    backward calls K29 at the four that carry a gradient; a test-mode
    forward calls the five that are not training-only."""
    from torch.profiler import ProfilerActivity, profile

    from itermvs_tpu_torch.engine.train_loop import forward_loss, init_weights, to_device_batch
    from itermvs_tpu_torch.models import Pipeline
    from itermvs_tpu_torch.models import itermvs as itermvs_model

    calls, backwards = [], []
    plain = itermvs_model.resize

    def record(x, out_hw, tanh=False):
        calls.append((tuple(x.shape[1:]), tuple(out_hw), x.dtype, tanh))
        return plain(x, out_hw, tanh)

    def record_grad(g, in_hw, y=None):
        backwards.append((tuple(g.shape[1:]), in_hw, y is not None))
        return grad(g, in_hw, y)

    grad = resize_ops.resize_grad
    monkeypatch.setattr(itermvs_model, "resize", record)
    monkeypatch.setattr(resize_ops, "resize_grad", record_grad)
    width, height, views = 96, 64, 3
    batch = to_device_batch(chip_smoke.train_sample(width, height, views, 1, 0), "cpu")

    def want(train):
        return [((c, ih, iw), (oh, ow), dt, tanh) for _, _, c, ih, iw, oh, ow, dt, tanh, _ in
                chip_smoke.resize_sites(width, height, views, 1, torch.float32, train)]

    model = init_weights(Pipeline(iteration=1, test=False), 0).train()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        loss, _ = forward_loss(model, batch, True)
    assert sorted(calls, key=str) == sorted(want(True), key=str)
    assert sum(e.name == "resize" for e in prof.events()) == 6
    loss.backward()
    sites = chip_smoke.resize_sites(width, height, views, 1, torch.float32, train=True)
    assert sorted(backwards, key=str) == sorted(
        [((c, oh, ow), (ih, iw), tanh) for _, _, c, ih, iw, oh, ow, _, tanh, grad in sites
         if grad], key=str)

    calls.clear()
    test_model = init_weights(Pipeline(iteration=1, test=True), 0).eval()
    with torch.no_grad():
        test_model(batch["imgs"], batch["proj_matrices"], batch["depth_min"],
                   batch["depth_max"])
    assert sorted(calls, key=str) == sorted(want(False), key=str)


def test_resize_work_counts_each_input_and_output_once():
    """K28 reads x and writes the output; K29 reads ∂out (and the output,
    for tanh) and writes ∂x. A map's 5 resizes at 1600x1152: ≈ 93 MB in
    float32, 0.028 ms at 3.35 TB/s, ≈ 52 MB in bfloat16; a training
    forward's 6 at 640x512, batch 4: ≈ 67 MB."""
    assert chip_smoke.resize_work(2, 3, 4, 5, 8, 10, 4) == (
        4 * 2 * 3 * (20 + 80), 9 * 2 * 3 * 80, chip_smoke.PEAK_F32_PER_S)
    assert chip_smoke.resize_work(2, 3, 4, 5, 8, 10, 2, tanh=True, grad=True) == (
        2 * 2 * 3 * (20 + 2 * 80), 32 * 2 * 3 * 20 + 3 * 2 * 3 * 80, chip_smoke.PEAK_F64_PER_S)
    assert chip_smoke.resize_work(1, 1, 8, 10, 4, 5, 4, grad=True)[1:] == (
        2 * 80, chip_smoke.PEAK_F32_PER_S)
    f32 = chip_smoke.resize_bytes(1600, 1152, 5, 1, torch.float32)
    assert f32 == pytest.approx(93e6, rel=0.01)
    assert chip_smoke.resize_bytes(1600, 1152, 5, 1, BF16) == pytest.approx(52e6, rel=0.01)
    assert chip_smoke.resize_bytes(640, 512, 5, 4, torch.float32, train=True) == \
        pytest.approx(67e6, rel=0.01)
    bounds = chip_smoke.chain_bound_ms(1600, 1152, 5, 4)
    assert bounds["resize"] == pytest.approx(1e3 * f32 / chip_smoke.PEAK_BYTES_PER_S)
    assert bounds["resize"] == pytest.approx(0.028, abs=1e-3)
    assert "resize" in chip_smoke.CHAINS


def test_resize_sites_and_edge_cases():
    """Five resizes per map (2 in float32, 3 in the compute dtype), six per
    training forward, four with a gradient (1 in float32); the edge cases
    hold ×2, ×½, ×4, tanh, odd maps and ratios that are not powers of
    two."""
    sites = chip_smoke.resize_sites(1600, 1152, 5, 1, BF16)
    assert [s[0] for s in sites] == ["ref_level1", "ref_level3", "view_weights", "hidden",
                                     "confidence"]
    assert [s[7] for s in sites].count(BF16) == 3
    step = chip_smoke.resize_sites(640, 512, 5, 4, BF16, train=True)
    assert len(step) == 6 and [s[0] for s in step if s[9]] == [
        "ref_level1", "ref_level3", "hidden", "init_depth"]
    assert ("ref_level1", 4, 16, 256, 320, 128, 160, BF16, False, True) in step
    assert ("confidence", 4, 1, 128, 160, 512, 640, torch.float32, False, False) in step
    edges = chip_smoke.RESIZE_EDGE_CASES
    assert any(t for *_, t in edges) and any(not t for *_, t in edges)
    ratios = {(oh / ih, ow / iw) for _, _, ih, iw, oh, ow, _ in edges}
    assert {(2.0, 2.0), (0.5, 0.5), (4.0, 4.0)} <= ratios
    assert any(r[0] not in (0.5, 2.0, 4.0) for r in ratios)
    assert any(iw % 2 for _, _, ih, iw, *_ in edges)


def test_resize_inputs_spread_their_exponents():
    gen = torch.Generator().manual_seed(0)
    for dtype in (torch.float32, BF16):
        t = chip_smoke.resize_inputs(2, 3, 5, 8, 10, 16, dtype, gen, dev="cpu")
        assert t["x"].shape == (2, 3, 5, 8) and t["g"].shape == (2, 3, 10, 16)
        assert all(v.dtype == dtype for v in t.values())
        octaves = torch.log2(t["g"].float().abs()).floor()
        assert octaves.max() - octaves.min() >= 12


def test_resize_op_events_name_the_eager_chain():
    """chip_smoke's gate finds PyTorch's resize and tanh, forward and
    backward, host and device, and not K28's or K29's kernels."""
    class Event:
        def __init__(self, name):
            self.name = name

    names = ["aten::upsample_bilinear2d", "UpsampleBilinear2DBackward0",
             "aten::upsample_bilinear2d_backward",
             "void at::native::(anonymous namespace)::upsample_bilinear2d_out_frame<float, "
             "float>(int)", "aten::tanh", "TanhBackward0", "aten::tanh_backward",
             "void at::native::vectorized_elementwise_kernel<4, at::native::tanh_kernel_cuda"]
    mine = ["void (anonymous namespace)::resize_bilinear_kernel<float, 4, false, true>("
            "float const*)", "void (anonymous namespace)::resize_bilinear_grad_up2_kernel<"
            "__nv_bfloat16, 4, true>(__nv_bfloat16 const*)", "resize"]
    found = chip_smoke.resize_op_events([Event(n) for n in names + mine])
    assert sorted(found) == sorted(n[:90] for n in names)


def test_profile_categories_name_k28_and_k29():
    cat = chip_smoke._category
    assert cat("void (anonymous namespace)::resize_bilinear_kernel<float, 4, true, false>("
               "float const*, float*, long long)") == "resize_bilinear"
    assert cat("void (anonymous namespace)::resize_bilinear_kernel<__nv_bfloat16, 1, false, "
               "true>(__nv_bfloat16 const*)") == "resize_bilinear_bf16"
    assert cat("void (anonymous namespace)::resize_bilinear_up2_kernel<__nv_bfloat16, 4, "
               "true>(__nv_bfloat16 const*)") == "resize_bilinear_bf16"
    assert cat("void (anonymous namespace)::resize_bilinear_grad_up2_kernel<float, 4, "
               "false>(float const*)") == "resize_bilinear_grad"
    assert cat("void (anonymous namespace)::resize_bilinear_grad_down2_kernel<"
               "__nv_bfloat16, 4, false>(__nv_bfloat16 const*)") == "resize_bilinear_grad_bf16"


def test_kernels_are_registered_with_both_forms():
    """One templated source each, both dtype forms in its library, in the
    `kernels` line with the source and the JAX line they replace; the
    model's label and the launch counters."""
    from itermvs_tpu_torch import kernels

    sources = chip_smoke.kernel_sources()
    for name in ("resize_bilinear", "resize_bilinear_grad"):
        assert name in kernels.SOURCES
        assert kernels.SIGNATURES[f"{name}_bf16"][2] == name
        assert sources[name] == sources[f"{name}_bf16"] == (
            f"itermvs_tpu_torch/csrc/{name}.cu", "itermvs_tpu/ops/resize.py:41")
        assert name in chip_smoke.launch_counts()
    assert {"resize_bilinear", "resize_bilinear_bf16"} <= set(chip_smoke.REPORT_PER_MAP)
    assert {"resize_bilinear_grad", "resize_bilinear_grad_bf16"} <= set(
        chip_smoke.REPORT_PER_STEP)
