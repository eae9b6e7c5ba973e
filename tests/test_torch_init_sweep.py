"""The init sweep's two softmax tails on the CPU, where the port runs the
plain versions of K30 `view_weight`, K31 `view_weight_grad`, K32
`init_depth` and K33 `init_depth_grad`: the port's `PixelViewWeight`
against the JAX package's (itermvs_tpu/models/itermvs.py:142-156, the DTU
weights) with its ×2 resize (:255), the view weights' softmax-max and the
init depth's softmax expectation, unnormalization and ×2 (:257-266)
against the same chains written with the JAX package's ops, forward and
backward (`jax.vjp`), with exact ties planted (all 32 samples equal, as
where a source view does not see a pixel, and two equal maxima); the
backward also against float64 autograd of the eager chain; both
Functions under gradcheck; the wrappers' refusals; the model's calls
under their labels; chip_smoke's helpers for the card's check.

Tolerances: the forward within 1e-6 (absolute: the weights lie in [1/32,
1]) in float32 and 1e-6 relative for the depth; in bfloat16 the module
within tests/test_torch_bf16.py's bound for a bf16 module (2e-2, relative
L2: the convolutions round to bfloat16 at other points in the two
frameworks). The backward within 1e-5 of max|∂| of JAX's float32 vjp and
of float64 autograd (the kernels' float64 evaluation starts from the
float32 softmax), in bfloat16 2e-2 relative L2.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from itermvs_tpu.engine.checkpoint import load_npz_variables
from itermvs_tpu.models.itermvs import PixelViewWeight as JaxPixelViewWeight
from itermvs_tpu.ops.depth_range import depth_unnormalization as jax_unnormalization
from itermvs_tpu.ops.resize import upsample_bilinear as jax_upsample_bilinear
from itermvs_tpu_torch.models.itermvs import PixelViewWeight
from itermvs_tpu_torch.ops import init_depth as init_depth_ops
from itermvs_tpu_torch.ops import view_weight as view_weight_ops
from itermvs_tpu_torch.ops.init_depth import (
    InitDepth, init_depth, init_depth_forward, init_depth_grad, init_depth_grad_plain,
    init_depth_plain)
from itermvs_tpu_torch.ops.view_weight import (
    ViewWeight, view_weight, view_weight_forward, view_weight_grad, view_weight_grad_plain,
    view_weight_plain)
from itermvs_tpu_torch.weights import npz_state_dict, pretrained_path

BF16 = torch.bfloat16
JNP = {torch.float32: jnp.float32, BF16: jnp.bfloat16}
MODULE_TOL = 2e-2       # tests/test_torch_bf16.py's bound for a bf16 module against JAX
GRAD_REL = 1e-5
SAMPLES, GROUPS = 32, 8
PLANES, H, W = 3, 5, 7
DTYPES = pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
TIES = pytest.mark.parametrize("ties", ["none", "all", "two_way"])
PREFIX = "iter_mvs.evaluation.pixel_view_weight."


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().double().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32)).astype(np.float64)


def _rel_l2(got, want):
    got, want = _np(got), _np(want)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _close_to_max(got, want, rel=GRAD_REL):
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def logits(ties, seed=0, n=PLANES, h=H, w=W):
    """Seeded logits [n, 32, h, w] (N(0, 3), float32) with `ties` planted:
    "all" makes every sample equal at pixel (0, 0) and at the last pixel;
    "two_way" makes samples 3 and 17 the equal maxima at those pixels."""
    x = np.random.RandomState(seed).randn(n, SAMPLES, h, w).astype(np.float32) * 3
    for i, j in ((0, 0), (h - 1, w - 1)):
        if ties == "all":
            x[:, :, i, j] = 0.25
        elif ties == "two_way":
            x[:, 3, i, j] = x[:, 17, i, j] = x[:, :, i, j].max(axis=1) + 1
    return x


def jax_view_weight(x):
    """PixelViewWeight's tail (itermvs_tpu/models/itermvs.py:153-155) on
    NCHW logits: the max over the samples of their softmax, [n, h, w]."""
    return jnp.max(jax.nn.softmax(x.astype(jnp.float32), axis=1), axis=1)


def jax_init_depth(score, idmin, idmax):
    """The init depth of itermvs_tpu/models/itermvs.py:257-266 on the score
    [B, 32, h, w]: [B, 2h, 2w, 1]."""
    n = score.shape[1]
    probability = jax.nn.softmax(score, axis=1)
    index = jnp.arange(n, dtype=jnp.float32).reshape(1, n, 1, 1)
    normalized = (jnp.sum(index * probability, axis=1) / (n - 1.0))[..., None]
    depth = jax_unnormalization(normalized, idmin.reshape(-1, 1, 1, 1),
                                idmax.reshape(-1, 1, 1, 1))
    return jax_upsample_bilinear(depth, 2)


def bounds(n=PLANES, seed=1):
    rng = np.random.RandomState(seed)
    return ((rng.rand(n) + 1.0).astype(np.float32),
            (rng.rand(n) * 0.2 + 0.1).astype(np.float32))


@pytest.fixture(scope="module")
def pixel_view_weights():
    """(the JAX PixelViewWeight's params, {dtype: the port's PixelViewWeight})
    from the DTU weights."""
    params = load_npz_variables(pretrained_path("dtu"))["params"]["iter_mvs"]["evaluation"][
        "pixel_view_weight"]
    state = {k[len(PREFIX):]: v for k, v in npz_state_dict(pretrained_path("dtu")).items()
             if k.startswith(PREFIX)}
    ports = {}
    for dtype in (torch.float32, BF16):
        ports[dtype] = PixelViewWeight(dtype)
        ports[dtype].load_state_dict(state)
    return params, ports


def corr_volume(seed=2):
    """Seeded correlation [PLANES, 32, H, W, G] (NHWC per sample, JAX's
    layout) with a source view that does not see a 3x3 corner: zero at
    every sample there, so its logits tie at all 32."""
    corr = np.random.RandomState(seed).randn(PLANES, SAMPLES, H, W, GROUPS).astype(np.float32)
    corr[:, :, :3, :3] = 0.0
    return corr


@DTYPES
def test_pixel_view_weight_matches_jax(pixel_view_weights, dtype):
    """PixelViewWeight (the convolutions, then K30's plain version) and
    its ×2 against the JAX module and `upsample_bilinear`; the corner a
    source view does not see weighs 1/32."""
    params, ports = pixel_view_weights
    corr = corr_volume()
    want = JaxPixelViewWeight(dtype=JNP[dtype]).apply({"params": params}, jnp.asarray(corr))
    want_up = jax_upsample_bilinear(want, 2)[..., 0]
    with torch.no_grad():
        w, up = ports[dtype](torch.from_numpy(corr).permute(0, 1, 4, 2, 3))
    assert w.dtype == up.dtype == torch.float32
    assert w.shape == (PLANES, H, W) and up.shape == (PLANES, 2 * H, 2 * W)
    assert torch.all(w[:, 1, 1] == 1.0 / 32)
    if dtype == torch.float32:
        np.testing.assert_allclose(_np(w), _np(want[..., 0]), rtol=0, atol=1e-6)
        np.testing.assert_allclose(_np(up), _np(want_up), rtol=0, atol=1e-6)
    else:
        assert _rel_l2(w, want[..., 0]) <= MODULE_TOL
        assert _rel_l2(up, want_up) <= MODULE_TOL


def test_pixel_view_weight_grad_matches_jax(pixel_view_weights):
    """The correlation's gradient through PixelViewWeight (K31's plain
    version, then the convolutions' backward) against `jax.vjp` of the JAX
    module, for the same ∂w."""
    params, ports = pixel_view_weights
    corr = corr_volume()
    d_w = np.random.RandomState(3).randn(PLANES, H, W).astype(np.float32)
    module = JaxPixelViewWeight(dtype=jnp.float32)
    _, vjp = jax.vjp(lambda c: module.apply({"params": params}, c), jnp.asarray(corr))
    want = vjp(jnp.asarray(d_w)[..., None])[0]
    x = torch.from_numpy(corr).permute(0, 1, 4, 2, 3).requires_grad_()
    w, up = ports[torch.float32](x)
    assert type(w.grad_fn).__name__ == "ViewWeightBackward" and not up.requires_grad
    got = torch.autograd.grad(w, x, torch.from_numpy(d_w))[0].permute(0, 1, 3, 4, 2)
    _close_to_max(got, want)


@DTYPES
@TIES
def test_view_weight_against_jax_and_float64(ties, dtype):
    """K30's plain version against JAX's softmax-max and ×2, K31's against
    `jax.vjp` of it and (float32) against float64 autograd of the eager
    chain; ties split evenly as JAX's and PyTorch's max split them; the
    Function's backward is the plain version."""
    x = logits(ties)
    d_w = np.random.RandomState(4).randn(PLANES, H, W).astype(np.float32)
    jx = jnp.asarray(x).astype(JNP[dtype])
    want, vjp = jax.vjp(jax_view_weight, jx)
    want_grad = vjp(jnp.asarray(d_w))[0]
    xt = torch.from_numpy(x).to(dtype)
    w, up = view_weight_plain(xt)
    np.testing.assert_allclose(_np(w), _np(want), rtol=0, atol=1e-6)
    np.testing.assert_allclose(_np(up), _np(jax_upsample_bilinear(want[..., None], 2)[..., 0]),
                               rtol=0, atol=1e-6)

    d_x = view_weight_grad_plain(torch.from_numpy(d_w), xt)
    assert d_x.dtype == dtype and d_x.shape == xt.shape
    xa = xt.clone().requires_grad_()
    wa, _ = view_weight(xa)
    assert torch.equal(torch.autograd.grad(wa, xa, torch.from_numpy(d_w))[0], d_x)
    if dtype == BF16:
        assert _rel_l2(d_x, want_grad) <= MODULE_TOL
        return
    _close_to_max(d_x, want_grad)
    x64 = xt.double().requires_grad_()
    exact = torch.autograd.grad(x64.softmax(1).amax(1), x64, torch.from_numpy(d_w).double())[0]
    _close_to_max(d_x, exact)
    if ties == "all":                   # p = 1/32 everywhere: the softmax's Σ cancels ∂w
        assert torch.all(d_x[:, :, 0, 0] == 0) and torch.all(w[:, 0, 0] == 1.0 / 32)
    if ties == "two_way":               # split evenly between the two maxima
        assert torch.equal(d_x[:, 3, 0, 0], d_x[:, 17, 0, 0])
        assert torch.all(d_x[:, 3, 0, 0] != 0)


@TIES
def test_init_depth_against_jax_and_float64(ties):
    """K32's plain version against the JAX chain (relative 1e-6), K33's
    against `jax.vjp` of it and against float64 autograd of the eager
    chain; the Function's backward is the plain version."""
    s = logits(ties, seed=5, n=2)
    lo, hi = bounds(2)
    g = np.random.RandomState(6).randn(2, 1, 2 * H, 2 * W).astype(np.float32)
    want, vjp = jax.vjp(lambda v: jax_init_depth(v, jnp.asarray(lo), jnp.asarray(hi)),
                        jnp.asarray(s))
    want_grad = vjp(jnp.asarray(g).transpose(0, 2, 3, 1))[0]
    st, lot, hit = (torch.from_numpy(v) for v in (s, lo, hi))
    out = init_depth_plain(st, lot, hit)
    assert out.shape == (2, 1, 2 * H, 2 * W) and out.dtype == torch.float32
    np.testing.assert_allclose(_np(out), _np(want).transpose(0, 3, 1, 2), rtol=1e-6, atol=0)

    d_s = init_depth_grad_plain(torch.from_numpy(g), st, lot, hit)
    assert d_s.dtype == torch.float32 and d_s.shape == st.shape
    sa = st.clone().requires_grad_()
    assert torch.equal(torch.autograd.grad(init_depth(sa, lot, hit), sa,
                                           torch.from_numpy(g))[0], d_s)
    _close_to_max(d_s, want_grad)
    s64 = st.double().requires_grad_()
    exact = torch.autograd.grad(init_depth_plain(s64, lot.double(), hit.double()), s64,
                                torch.from_numpy(g).double())[0]
    _close_to_max(d_s, exact)
    if ties == "all":                   # p = 1/32: the expectation is the middle sample
        depth = 1.0 / (hi + 0.5 * (lo - hi))
        np.testing.assert_allclose(_np(out[:, 0, 0, 0]), depth, rtol=1e-6)


@pytest.mark.parametrize("fn", ["view_weight", "init_depth"])
def test_gradcheck(fn):
    """Both Functions in float64 at tiny sizes: a pixel, a row and odd
    maps (no ties: amax's split is no derivative); gradcheck's fast mode
    (random projections of the Jacobian)."""
    gen = torch.Generator().manual_seed(7)
    for h, w in ((1, 1), (1, 3), (3, 2)):
        x = torch.randn(2, SAMPLES, h, w, dtype=torch.float64, generator=gen,
                        requires_grad=True)
        if fn == "view_weight":
            assert torch.autograd.gradcheck(lambda v: ViewWeight.apply(v)[0], (x,),
                                            fast_mode=True)
        else:
            lo = torch.tensor([2.0, 1.5], dtype=torch.float64)
            hi = torch.tensor([0.2, 0.25], dtype=torch.float64)
            assert torch.autograd.gradcheck(lambda v: InitDepth.apply(v, lo, hi), (x,),
                                            fast_mode=True)


def test_no_grad_runs_the_forwards_alone():
    x = torch.from_numpy(logits("none")).requires_grad_()
    lo, hi = (torch.from_numpy(v) for v in bounds())
    with torch.no_grad():
        w, up = view_weight(x)
        depth = init_depth(x, lo, hi)
    assert w.grad_fn is None and up.grad_fn is None and depth.grad_fn is None
    assert torch.equal(w, view_weight_plain(x.detach())[0])
    assert torch.equal(depth, init_depth_plain(x.detach(), lo, hi))


def test_the_wrappers_raise_on_what_the_kernels_do_not_take():
    """Shapes on the CPU too; dtype, layout and device before any launch
    (meta tensors: no CPU plain version, no card); a bound that asks for
    a gradient; K31 and K33 copy a gradient that is not contiguous once and
    count it."""
    x = torch.zeros(2, SAMPLES, 3, 4)
    with pytest.raises(ValueError, match="must be"):
        view_weight_forward(torch.zeros(2, 31, 3, 4))
    with pytest.raises(ValueError, match="must be"):
        view_weight_grad(torch.zeros(2, 3, 5), x)
    with pytest.raises(ValueError, match="must be"):
        init_depth_forward(torch.zeros(2, SAMPLES, 3), torch.ones(2), torch.ones(2))
    with pytest.raises(ValueError, match="values of each bound"):
        init_depth_forward(x, torch.ones(3), torch.ones(2))
    with pytest.raises(ValueError, match="must be"):
        init_depth_grad(torch.zeros(2, 1, 6, 7), x, torch.ones(2), torch.ones(2))
    with pytest.raises(ValueError, match="no gradient"):
        init_depth(x, torch.ones(2, requires_grad=True), torch.ones(2))
    meta = torch.empty(2, SAMPLES, 3, 4, device="meta")
    bound = torch.empty(2, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        view_weight_forward(meta)
    with pytest.raises(ValueError, match="dtype"):
        view_weight_forward(meta.half())
    with pytest.raises(ValueError, match="contiguous"):
        view_weight_forward(torch.empty(2, 3, 4, SAMPLES, device="meta").permute(0, 3, 1, 2))
    with pytest.raises(ValueError, match="float32"):
        view_weight_grad(torch.empty(2, 3, 4, device="meta", dtype=BF16), meta)
    with pytest.raises(ValueError, match="CUDA"):
        init_depth_forward(meta, bound, bound)
    with pytest.raises(ValueError, match="float32"):
        init_depth_forward(meta.to(BF16), bound, bound)
    chip_smoke.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        view_weight_grad(torch.empty(3, 4, 2, device="meta").permute(2, 0, 1), meta)
    with pytest.raises(ValueError, match="CUDA"):
        init_depth_grad(torch.empty(2, 1, 8, 6, device="meta").transpose(2, 3), meta,
                        bound, bound)
    assert view_weight_ops.view_weight_grad.copies == init_depth_ops.init_depth_grad.copies == 1
    chip_smoke.reset_launch_counts()
    assert view_weight_ops.view_weight_grad.copies == init_depth_ops.init_depth_grad.copies == 0


def test_the_model_runs_k30_and_k32_under_their_labels(monkeypatch):
    """A training forward runs PixelViewWeight's tail through K30's
    wrapper once, under `view_weight`, and the init depth through K32's
    once, under `init_depth`; its backward K31 and K33 once each; a
    test-mode forward K30 alone."""
    from torch.profiler import ProfilerActivity, profile

    from itermvs_tpu_torch.engine.train_loop import forward_loss, init_weights, to_device_batch
    from itermvs_tpu_torch.models import Pipeline

    calls = []
    for mod, name in ((view_weight_ops, "view_weight_forward"),
                      (view_weight_ops, "view_weight_grad"),
                      (init_depth_ops, "init_depth_forward"),
                      (init_depth_ops, "init_depth_grad")):
        def record(*args, _fn=getattr(mod, name), _name=name):
            calls.append(_name)
            return _fn(*args)
        monkeypatch.setattr(mod, name, record)
    batch = to_device_batch(chip_smoke.train_sample(96, 64, 3, 1, 0), "cpu")
    model = init_weights(Pipeline(iteration=1, test=False), 0).train()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        loss, _ = forward_loss(model, batch, True)
    names = [e.name for e in prof.events()]
    assert names.count("view_weight") == 1 and names.count("init_depth") == 1
    assert sorted(calls) == ["init_depth_forward", "view_weight_forward"]
    loss.backward()
    assert sorted(calls) == ["init_depth_forward", "init_depth_grad", "view_weight_forward",
                             "view_weight_grad"]
    calls.clear()
    test_model = init_weights(Pipeline(iteration=1, test=True), 0).eval()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        test_model(batch["imgs"], batch["proj_matrices"], batch["depth_min"],
                   batch["depth_max"])
    assert calls == ["view_weight_forward"]
    assert [e.name for e in prof.events()].count("view_weight") == 1


def test_softmax_work_counts_each_input_and_output_once():
    """K30 reads the logits and writes w and its ×2; K31 reads ∂w and the
    logits and writes ∂x; K32 reads the score and the bounds and writes the
    ×2 depth; K33 reads ∂out, the score and the bounds and writes ∂score. A
    map's K30 at 1600x1152 (4 sources at 144x200): ≈ 17 MB in float32,
    0.0051 ms at 3.35 TB/s; the `view_weight` and `init_depth` chains'
    bounds are K30's and K32's."""
    p = 2 * 3 * 5
    assert chip_smoke.softmax_work("view_weight", 2, 3, 5, 2) == (
        p * (64 + 20), p * 228)
    assert chip_smoke.softmax_work("view_weight_grad", 2, 3, 5, 4)[0] == p * (4 + 256)
    assert chip_smoke.softmax_work("init_depth", 2, 3, 5)[0] == p * (128 + 16) + 16
    nbytes, ops = chip_smoke.softmax_work("init_depth_grad", 2, 3, 5)
    assert nbytes == p * (16 + 256) + 16
    assert ops == pytest.approx(p * (228 + 153 * chip_smoke.PEAK_F32_PER_S
                                     / chip_smoke.PEAK_F64_PER_S))
    k30 = chip_smoke.softmax_work("view_weight", 4, 144, 200)[0]
    assert k30 == pytest.approx(17.05e6, rel=0.01)
    bounds_map = chip_smoke.chain_bound_ms(1600, 1152, 5, 4)
    assert bounds_map["view_weight"] == pytest.approx(1e3 * k30 / chip_smoke.PEAK_BYTES_PER_S)
    assert bounds_map["view_weight"] == pytest.approx(0.0051, abs=1e-4)
    assert bounds_map["init_depth"] == 0
    step = chip_smoke.chain_bound_ms(640, 512, 5, 4, 4, itemsize=2, train=True)
    assert step["view_weight"] == pytest.approx(1e3 * chip_smoke.softmax_work(
        "view_weight", 16, 64, 80, 2)[0] / chip_smoke.PEAK_BYTES_PER_S)
    assert step["init_depth"] == pytest.approx(1e3 * chip_smoke.softmax_work(
        "init_depth", 4, 64, 80)[0] / chip_smoke.PEAK_BYTES_PER_S)
    assert {"view_weight", "init_depth"} <= set(chip_smoke.CHAINS)


def test_softmax_inputs_plant_their_ties():
    gen = torch.Generator().manual_seed(0)
    for dtype in (torch.float32, BF16):
        t = chip_smoke.softmax_inputs(2, 7, 11, dtype, gen, dev="cpu")
        x = t["x"].float()
        assert t["x"].dtype == dtype and t["d_w"].shape == (2, 7, 11)
        assert t["g"].shape == (2, 1, 14, 22) and t["idmin"].shape == (2,)
        p = x.softmax(1)
        ties = (p == p.amax(1, keepdim=True)).sum(1)
        assert torch.all(ties[:, ::3, ::5] == 32) and torch.all(ties[:, 1::3, 2::5] == 2)
        assert torch.all(t["idmin"] > t["idmax"])
    assert chip_smoke.SOFTMAX_EDGE_SHAPES[0] == (1, 1, 1)
    assert any(h % 6 and w % 30 for _, h, w in chip_smoke.SOFTMAX_EDGE_SHAPES)


def test_softmax_op_events_name_the_eager_chain():
    class Event:
        def __init__(self, name):
            self.name = name

    names = ["aten::softmax", "aten::_softmax", "SoftmaxBackward0",
             "aten::_softmax_backward_data",
             "void (anonymous namespace)::cunn_SpatialSoftMaxForward<float, float, float, "
             "at::native::(anonymous namespace)::SoftMaxForwardEpilogue>(float*)",
             "void (anonymous namespace)::cunn_SoftMaxForward<4, float>(float*)"]
    mine = ["void (anonymous namespace)::view_weight_kernel<float>(float const*)",
            "void (anonymous namespace)::init_depth_grad_kernel(float const*)", "view_weight",
            "init_depth"]
    found = chip_smoke.softmax_op_events([Event(n) for n in names + mine])
    assert sorted(found) == sorted(n[:90] for n in names)


def test_profile_categories_name_k30_to_k33():
    cat = chip_smoke._category
    assert cat("void (anonymous namespace)::view_weight_kernel<float>(float const*, float*, "
               "float*, int, int)") == "view_weight"
    assert cat("void (anonymous namespace)::view_weight_kernel<__nv_bfloat16>("
               "__nv_bfloat16 const*)") == "view_weight_bf16"
    assert cat("void (anonymous namespace)::view_weight_grad_kernel<float>(float const*)") \
        == "view_weight_grad"
    assert cat("void (anonymous namespace)::view_weight_grad_kernel<__nv_bfloat16>("
               "float const*)") == "view_weight_grad_bf16"
    assert cat("(anonymous namespace)::init_depth_kernel(float const*, float const*)") == \
        "init_depth"
    assert cat("(anonymous namespace)::init_depth_grad_kernel(float const*)") == \
        "init_depth_grad"


def test_kernels_are_registered():
    """K30 and K31 one templated source each, both dtype forms in its
    library; K32 and K33 float32 only; all in the `kernels` line with the
    source and the JAX line they replace, in the launch counters and in
    the launch plans (one each per map or step)."""
    from itermvs_tpu_torch import kernels

    sources = chip_smoke.kernel_sources()
    for name in ("view_weight", "view_weight_grad"):
        assert kernels.SIGNATURES[f"{name}_bf16"][2] == name
        assert sources[name] == sources[f"{name}_bf16"] == (
            f"itermvs_tpu_torch/csrc/{name}.cu", "itermvs_tpu/models/itermvs.py:154")
    for name in ("init_depth", "init_depth_grad"):
        assert f"{name}_bf16" not in kernels.SIGNATURES
        assert sources[name] == (f"itermvs_tpu_torch/csrc/{name}.cu",
                                 "itermvs_tpu/models/itermvs.py:257")
    for name in ("view_weight", "view_weight_grad", "init_depth", "init_depth_grad"):
        assert name in kernels.SOURCES and name in chip_smoke.launch_counts()
    assert {"view_weight", "view_weight_bf16"} <= set(chip_smoke.REPORT_PER_MAP)
    assert {"view_weight_grad", "view_weight_grad_bf16", "init_depth",
            "init_depth_grad"} <= set(chip_smoke.REPORT_PER_STEP)
    with open(kernels.CSRC_DIR + "/sample_softmax.cuh") as f:
        header = f.read()
    assert f"constexpr int kSamples = {view_weight_ops.SAMPLES};" in header
