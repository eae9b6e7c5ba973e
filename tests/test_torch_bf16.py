"""The port's bfloat16 mode against the JAX package's, on the CPU.

The same seeded numpy inputs go through the JAX function with
`dtype=jnp.bfloat16` and the port with `dtype=torch.bfloat16` (on the
CPU, so the sweep kernels' plain versions run; the CUDA kernels are held
against those same versions on the card by chip_smoke.py). Each module
is also run in the port's float32 on the same inputs: a cast in the
wrong place shows there as a gap far above bf16's rounding noise.

bf16 rounds at other places in XLA:CPU and in torch, so equal bits are
not the aim (the premultiply of K2 happens to be bit-equal). Tolerances,
relative L2 unless said otherwise:
* 2e-2 for every module against JAX bf16 and against the port's f32
  (measured: FeatureNet 3-4e-3, the sweep forward 3.4e-3 and backward
  8e-3, CorrNet 2-3e-3, the GRU's hidden state 3e-3), but 4e-2 for the
  sweep's d_src on a pile-up against JAX (see the test: JAX sums in bf16);
* the normalized depth that `Update` reads out of its 256-bin softmax:
  the windowed expectation sits on an argmax, and where two bins nearly
  tie, bf16 noise moves the window by a bin and that pixel's depth by
  its width; so ≥ 90% of pixels within 2 bins (2/255), not a norm;
* K1's plain version against JAX's f32-accumulated group mean 5e-6 of
  max (the same f32 sums in another order); against the Pallas call at
  C = 48 3e-3 of max, because the Pallas call's mean matrix rounds 1/6
  to bf16 (2e-3 relative) where the JAX main path's mean and the port
  divide in f32;
* the whole test-mode pipeline on the textured plane scene (384×288, 4
  views, the DTU weights): depth within 2e-2, and against the analytic
  plane the bound of tests/test_bf16_mode.py; against JAX bf16 depths a
  median relative difference ≤ 1e-2 and ≥ 90% of pixels within 1e-2
  relative (measured: median 1.2e-4, 99.95% within 1e-2, relative L2
  4.9e-4; bf16 error 0.04141 against f32's 0.04141);
* training (tests/test_train.py's batch, 2 iterations): the bounds of
  tests/test_train.py::test_bf16_training_tracks_f32, and the first bf16
  loss within 2% of JAX bf16's from the same weights.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke

from itermvs_tpu.data import find_dataset_def
from itermvs_tpu.engine.checkpoint import load_npz_variables
from itermvs_tpu.models import Pipeline as JaxPipeline
from itermvs_tpu.models.itermvs import CorrNet as JaxCorrNet
from itermvs_tpu.models.itermvs import Update as JaxUpdate
from itermvs_tpu.models.itermvs import chunked_warp_corr as jax_chunked_warp_corr
from itermvs_tpu.models.losses import full_loss as jax_full_loss
from itermvs_tpu.ops import sweep_epilogue as jax_sweep_epilogue
from itermvs_tpu.ops import warping as jax_warping
from itermvs_tpu.ops.grid_sample import pack_corners
from itermvs_tpu.ops.warping import pack_bilinear
from itermvs_tpu_torch.engine.train_loop import init_weights, make_optimizer, train_step
from itermvs_tpu_torch.models import Pipeline
from itermvs_tpu_torch.models.itermvs import GROUPS, NUM_BINS
from itermvs_tpu_torch.ops import warping
from itermvs_tpu_torch.ops.sweep import sample_chunks, sweep_premul
from itermvs_tpu_torch.ops.sweep_epilogue import corr_epilogue
from itermvs_tpu_torch.ops.sweep_grad import (
    SweepCorr, sweep_grad_ref, sweep_grad_ref_plain, sweep_grad_src, sweep_grad_src_plain)
from itermvs_tpu_torch.weights import flax_tree, load_npz_weights, load_state
from itermvs_tpu_torch.weights import pretrained_path
from tests.synthetic_scene import build_scene_dir, make_cameras, render_view
from tests.test_torch_ops import _camera
from tests.test_torch_sweep import _sweep_inputs, interpret_mode  # noqa: F401
from tests.test_train import _make_batch

CKPT = pretrained_path("dtu")
BF16 = torch.bfloat16
MODULE_TOL = 2e-2


def _rl2(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _np(x):
    """A JAX or torch array as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _bf16(x):
    """numpy f32 → (the same values rounded to bf16 as JAX, as torch)."""
    j = jnp.asarray(x).astype(jnp.bfloat16)
    return j, torch.from_numpy(np.array(_np(j))).to(BF16)


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    """Two torch threads: the suite runs six workers on the CPU's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jax_variables():
    return load_npz_variables(CKPT)


@pytest.fixture(scope="module")
def port_models():
    """{dtype: test-mode Pipeline with the DTU weights}."""
    return {dt: load_npz_weights(Pipeline(iteration=4, dtype=dt), CKPT)
            for dt in (torch.float32, BF16)}


# ------------------------------------------------------------- the sweep
def test_fused_sweep_taps_take_the_table_dtype(rng):
    """Indices as in f32; taps computed in f32 and cast to bf16, as JAX
    casts them (equal bits but where the two f32 products differ in the
    last place across a rounding boundary: one bf16 step)."""
    b, h, w, src_hws, level_of_sample = 2, 5, 7, ((10, 14), (5, 7)), (0, 1, 1, 0)
    rel = np.stack([np.stack([_camera(rng, 14, 10, 0.4) @ np.linalg.inv(
        _camera(rng, 14, 10, 0.0)) for _ in range(2)]) for _ in range(3)])[None]
    rel = np.repeat(rel, b, axis=0).astype(np.float32)                # [B,V,L,4,4]
    depth = rng.uniform(2.0, 10.0, (b, len(level_of_sample), h, w)).astype(np.float32)
    want_idx, want_taps = jax_warping.fused_sweep_taps(
        jnp.asarray(rel), jnp.asarray(depth), level_of_sample, src_hws, jnp.bfloat16)
    got_idx, got_taps = warping.fused_sweep_taps(
        torch.from_numpy(rel), torch.from_numpy(depth), level_of_sample, src_hws, BF16)
    assert all(t.dtype == jnp.bfloat16 for t in want_taps) and got_taps.dtype == BF16
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx).reshape(got_idx.shape))
    want = np.stack([_np(t).reshape(got_idx.shape) for t in want_taps])
    step = torch.finfo(BF16).eps * np.abs(want)
    assert (np.abs(_np(got_taps) - want) <= step).all()
    f32 = warping.fused_sweep_taps(torch.from_numpy(rel), torch.from_numpy(depth),
                                   level_of_sample, src_hws)[1]
    assert torch.equal(f32.to(BF16), got_taps)


@pytest.mark.parametrize("c", [16, 32, 48])
def test_sweep_premul_bf16_equals_jax_premultiply(rng, c):
    """K2's plain version in bf16: (value · tap) rounded, then · ref
    rounded; XLA's `gather_corners` table + `premultiply` in bf16 give
    the same bits."""
    b, n, h, w, h1, w1 = 2, 3, 5, 7, 6, 9
    src, ref, idx, taps = _sweep_inputs(rng, b, n, h, w, h1, w1, c)
    (src_j, src_t), (ref_j, ref_t), (taps_j, taps_t) = map(_bf16, (src, ref, taps))
    got = sweep_premul(src_t, torch.from_numpy(idx.reshape(b, -1)),
                       taps_t.reshape(4, b, -1), ref_t.reshape(b, h * w, c), n)
    assert got.dtype == BF16 and got.shape == (b, n * h * w, 4 * c)
    table = pack_corners(src_j).data
    for i in range(b):
        vals = jnp.take(table[i].reshape(h1 * w1, 4 * c), jnp.asarray(idx[i].reshape(-1)),
                        axis=0)
        want = jax_sweep_epilogue.premultiply(
            vals, [t[i].reshape(-1) for t in taps_j], ref_j[i].reshape(h * w, c), n)
        assert want.dtype == jnp.bfloat16
        np.testing.assert_array_equal(_np(got[i]), _np(want))


@pytest.mark.parametrize("c", [16, 32, 48])
def test_corr_epilogue_bf16_sums_in_float32(interpret_mode, rng, c):  # noqa: F811
    n, hw = 4, 256
    premul_j, premul_t = _bf16(rng.rand(n * hw, 4 * c).astype(np.float32) * 2 - 1)
    got = corr_epilogue(premul_t, n, GROUPS)
    assert got.dtype == torch.float32 and got.shape == (GROUPS, n, hw)
    oracle = _np(jax_sweep_epilogue.corr_epilogue_reference(premul_j, n, GROUPS))
    scale = np.abs(oracle).max()
    np.testing.assert_allclose(_np(got), oracle, rtol=0, atol=5e-6 * scale)
    pallas = _np(jax_sweep_epilogue.corr_epilogue(premul_j, n, GROUPS))
    tol = 5e-6 if (c // GROUPS) in (2, 4) else 3e-3         # 1/6 rounded to bf16
    np.testing.assert_allclose(_np(got), pallas, rtol=0, atol=tol * scale)


# The three levels' channel counts, the init sweep's 32 samples, a
# pile-up (every row of batch 0 on one cell), one sample per chunk.
@pytest.mark.parametrize("b,n,c,h1,w1,pile_up", [
    (2, 4, 16, 12, 16, False), (2, 4, 32, 6, 8, False), (1, 5, 48, 3, 4, False),
    (2, 32, 48, 6, 8, True)])
def test_sweep_corr_bf16_matches_jax_forward_and_backward(rng, b, n, c, h1, w1, pile_up):
    h, w = 6, 8
    src, ref, idx, taps = _sweep_inputs(rng, b, n, h, w, h1, w1, c)
    if pile_up:
        idx[0] = (h1 // 2) * w1 + w1 // 2
    cot = rng.randn(b, n, h, w, GROUPS).astype(np.float32)
    (src_j, src_t), (ref_j, ref_t), (taps_j, taps_t) = map(_bf16, (src, ref, taps))

    def f(s, r):
        return jax_chunked_warp_corr(pack_bilinear(s), r, jnp.asarray(idx), list(taps_j),
                                     (n, h, w, c), GROUPS)

    want, vjp = jax.vjp(f, src_j, ref_j)
    want_src, want_ref = vjp(jnp.asarray(cot))
    cot_t = torch.from_numpy(cot.reshape(b, n, h * w, GROUPS).transpose(0, 1, 3, 2).copy())

    def port(s, r, t):
        s = s.clone().requires_grad_()
        r = r.reshape(b, h * w, c).clone().requires_grad_()
        corr = SweepCorr.apply(s, r, torch.from_numpy(idx), t, GROUPS)
        corr.backward(cot_t)
        return (corr.detach().reshape(b, n, GROUPS, h, w).permute(0, 1, 3, 4, 2),
                s.grad, r.grad.reshape(b, h, w, c))

    got = port(src_t, ref_t, taps_t)
    f32 = port(*(torch.from_numpy(x) for x in (src, ref, taps)))
    assert want.dtype == jnp.float32 and want_src.dtype == want_ref.dtype == jnp.bfloat16
    assert [t.dtype for t in got] == [torch.float32, BF16, BF16]
    tols = [MODULE_TOL] * 3
    if pile_up:
        # JAX's scatter-add sums the 1,536 rows piled on one cell in bf16:
        # its d_src is 3.0e-2 from the float64 sum of the same bf16 inputs,
        # the port's (f32 sums, one rounding) 1.6e-3.
        exact = port(*(t.double() for t in (src_t, ref_t, taps_t)))[1]
        assert _rl2(_np(got[1]), exact.numpy()) <= 5e-3
        tols[1] = 4e-2
    for g, j, g32, tol in zip(got, (want, want_src, want_ref), f32, tols):
        assert _rl2(_np(g), _np(j)) <= tol
        assert _rl2(_np(g), _np(g32)) <= MODULE_TOL


def test_plain_backward_sums_in_float32_and_rounds_once(rng):
    b, n, h, w, h1, w1, c = 2, 3, 4, 5, 6, 7, 16
    src, ref, idx, taps = _sweep_inputs(rng, b, n, h, w, h1, w1, c)
    base = torch.from_numpy(idx.reshape(b, -1))
    grad = torch.from_numpy(rng.randn(b, n, GROUPS, h * w).astype(np.float32))
    s16, r16 = (torch.from_numpy(x).to(BF16) for x in (src, ref.reshape(b, h * w, c)))
    t16 = torch.from_numpy(taps.reshape(4, b, -1)).to(BF16)
    d_ref = sweep_grad_ref(s16, base, t16, grad)
    d_src = sweep_grad_src(r16, base, t16, grad, h1, w1)
    assert d_ref.dtype == d_src.dtype == BF16
    assert torch.equal(d_ref, sweep_grad_ref_plain(s16.float(), base, t16.float(), grad).to(BF16))
    assert torch.equal(d_src, sweep_grad_src_plain(r16.float(), base, t16.float(), grad,
                                                   h1, w1).to(BF16))


def test_sample_chunks_count_the_element_size():
    """A bf16 premul block is half an f32 one: at a budget of 2 f32
    samples, 4 bf16 samples fit."""
    budget = 2 * 10 * 16 * 4
    assert sample_chunks(1, 5, 10, 4, budget=budget) == [(0, 2), (2, 4), (4, 5)]
    assert sample_chunks(1, 5, 10, 4, budget=budget, itemsize=2) == [(0, 4), (4, 5)]


# The bf16 forward kernels' edge cases on the card (chip_smoke
# check_fwd_edge_cases), with the same inputs made on the CPU: the plain
# versions the card holds the kernels against, against the JAX package.
# (Bases off the map are the card's own case: JAX clamps them, the port
# writes NaN, and the plain version refuses them.)
_RUN16, _RUN48 = (chip_smoke.bf16_fwd_tiles(c)[0] for c in (16, 48))


@pytest.mark.parametrize("b,n,hw,c,bases", [
    (2, 2, 1, 16, "random"), (2, 2, _RUN16 - 1, 16, "random"), (2, 2, _RUN16 + 1, 16, "random"),
    (2, 2, _RUN48 - 1, 48, "random"), (2, 2, _RUN48 + 1, 48, "random"),
    (2, 3, 300, 16, "edges"), (2, 3, 300, 48, "edges"),
    (2, 3, 300, 8, "random"), (1, 2, 300, 256, "edges")])
def test_sweep_premul_bf16_edge_cases_equal_jax(b, n, hw, c, bases):
    gen = torch.Generator().manual_seed(c + hw)
    src, base, taps, ref = chip_smoke.fwd_edge_inputs(b, n, hw, c, gen, bases, dev="cpu")
    h1, w1 = chip_smoke.FWD_EDGE_MAP
    if bases == "edges":
        on_edge = (base // w1 == h1 - 1) | (base % w1 == w1 - 1)
        assert bool(on_edge.all())
    got = sweep_premul(src, base, taps, ref, n)
    table = pack_corners(jnp.asarray(_np(src)).astype(jnp.bfloat16)).data
    for i in range(b):
        vals = jnp.take(table[i].reshape(h1 * w1, 4 * c), jnp.asarray(base[i].numpy()), axis=0)
        want = jax_sweep_epilogue.premultiply(
            vals, [jnp.asarray(_np(t[i])).astype(jnp.bfloat16) for t in taps],
            jnp.asarray(_np(ref[i])).astype(jnp.bfloat16), n)
        np.testing.assert_array_equal(_np(got[i]), _np(want))


@pytest.mark.parametrize("c,rows", [
    (c, rows) for c in (16, 32, 48)
    for rows in (1, chip_smoke.bf16_fwd_tiles(c)[1] - 1, chip_smoke.bf16_fwd_tiles(c)[1] + 1)
] + [(8, 256), (256, 256)])
def test_corr_epilogue_bf16_edge_rows_match_jax(interpret_mode, rng, c, rows):  # noqa: F811
    """Ragged row counts against the JAX oracle (the Pallas call blocks
    only whole 128-row tiles), and C = 8 and 256 (cg = 1 and 32, whose
    1/cg the Pallas call's bf16 mean matrix holds exactly) against both."""
    premul_j, premul_t = _bf16(rng.rand(rows, 4 * c).astype(np.float32) * 2 - 1)
    got = _np(corr_epilogue(premul_t, 1, GROUPS))
    oracle = _np(jax_sweep_epilogue.corr_epilogue_reference(premul_j, 1, GROUPS))
    tol = 5e-6 * np.abs(oracle).max()
    np.testing.assert_allclose(got, oracle, rtol=0, atol=tol)
    if jax_sweep_epilogue.supports(rows):
        pallas = _np(jax_sweep_epilogue.corr_epilogue(premul_j, 1, GROUPS))
        np.testing.assert_allclose(got, pallas, rtol=0, atol=tol)


# ---------------------------------------------------------------- models
def test_feature_net_bf16_matches_jax(jax_variables, port_models, rng):
    imgs = rng.rand(2, 64, 96, 3).astype(np.float32) * 2 - 1
    want = JaxPipeline(test=True, dtype=jnp.bfloat16).apply(
        jax_variables, jnp.asarray(imgs), method=JaxPipeline.extract)
    with torch.no_grad():
        got = {dt: m.extract(torch.from_numpy(imgs)) for dt, m in port_models.items()}
    for key in ("level1", "level2", "level3"):
        assert want[key].dtype == jnp.bfloat16 and got[BF16][key].dtype == BF16
        g = _np(got[BF16][key].permute(0, 2, 3, 1))
        assert _rl2(g, _np(want[key])) <= MODULE_TOL
        assert _rl2(g, _np(got[torch.float32][key].permute(0, 2, 3, 1))) <= MODULE_TOL


def test_corr_net_bf16_matches_jax(jax_variables, port_models, rng):
    corr = (rng.randn(2, 3, 16, 24, GROUPS) * 0.3).astype(np.float32)     # [B,N,H,W,G]
    want = JaxCorrNet(dtype=jnp.bfloat16).apply(
        {"params": jax_variables["params"]["iter_mvs"]["evaluation"]["corr_net1"]},
        jnp.asarray(corr))
    x = torch.from_numpy(corr).permute(0, 1, 4, 2, 3).contiguous()
    with torch.no_grad():
        got = {dt: m.iter_mvs.evaluation.corr_conv1[0](x) for dt, m in port_models.items()}
    assert want.dtype == jnp.float32 and got[BF16].dtype == torch.float32
    assert _rl2(_np(got[BF16]), _np(want)) <= MODULE_TOL
    assert _rl2(_np(got[BF16]), _np(got[torch.float32])) <= MODULE_TOL


def test_update_bf16_matches_jax(jax_variables, port_models, rng):
    """One GRU step and both heads: hidden state in bf16, the normalized
    depth, the 256-bin probability and the confidence logits in f32."""
    hidden = np.tanh(rng.randn(2, 16, 24, 32)).astype(np.float32)
    depth = rng.rand(2, 16, 24, 1).astype(np.float32)
    corr = (rng.randn(2, 16, 24, 10) * 0.5).astype(np.float32)
    hidden_j, hidden_t = _bf16(hidden)
    h1, nd, prob, _, logits = JaxUpdate(32, dtype=jnp.bfloat16).apply(
        {"params": jax_variables["params"]["iter_mvs"]["update"]}, hidden_j,
        jnp.asarray(depth), jnp.asarray(corr), confidence_flag=True)
    want = [h1, nd, prob, logits]
    got = {}
    with torch.no_grad():
        for dt, model in port_models.items():
            update = model.iter_mvs.update
            h = update(hidden_t.permute(0, 3, 1, 2).to(dt),
                       torch.from_numpy(depth).permute(0, 3, 1, 2),
                       torch.from_numpy(corr).permute(0, 3, 1, 2))
            got[dt] = [h, *update.depth(h), update.confidence(h)]
    assert [x.dtype for x in want] == [jnp.bfloat16] + [jnp.float32] * 3
    assert [x.dtype for x in got[BF16]] == [BF16] + [torch.float32] * 3
    nhwc = [_np(x.permute(0, 2, 3, 1)) for x in got[BF16]]
    f32 = [_np(x.permute(0, 2, 3, 1)) for x in got[torch.float32]]
    for i in (0, 2, 3):
        assert _rl2(nhwc[i], _np(want[i])) <= MODULE_TOL, i
        assert _rl2(nhwc[i], f32[i]) <= MODULE_TOL, i
    for other in (_np(want[1]), f32[1]):
        assert np.mean(np.abs(nhwc[1] - other) <= 2.0 / (NUM_BINS - 1)) >= 0.9


# ------------------------------------------------- the slice as a whole
SCENE = dict(num_views=4, width=384, height=288)


@pytest.fixture(scope="module")
def plane_scene(tmp_path_factory, jax_variables, port_models):
    """The textured plane of tests/test_bf16_mode.py through JAX bf16 and
    the port in both precisions: (analytic depth, {name: outputs})."""
    scene = str(tmp_path_factory.mktemp("plane"))
    build_scene_dir(scene, write_gt_depth=False, **SCENE)
    w, h, v = SCENE["width"], SCENE["height"], SCENE["num_views"]
    sample = find_dataset_def("custom")(scene, v, (w, h))[0]
    imgs = {k: np.asarray(x)[None] for k, x in sample["imgs"].items()}
    projs = {k: np.asarray(x)[None] for k, x in sample["proj_matrices"].items()}
    dmin = np.asarray([sample["depth_min"]], np.float32)
    dmax = np.asarray([sample["depth_max"]], np.float32)
    outs = {"jax_bf16": JaxPipeline(iteration=4, test=True, dtype=jnp.bfloat16).apply(
        jax_variables, {k: jnp.asarray(x) for k, x in imgs.items()},
        {k: jnp.asarray(x) for k, x in projs.items()}, jnp.asarray(dmin), jnp.asarray(dmax))}
    with torch.no_grad():
        for dt, name in ((torch.float32, "port_f32"), (BF16, "port_bf16")):
            outs[name] = port_models[dt](
                {k: torch.from_numpy(x) for k, x in imgs.items()},
                {k: torch.from_numpy(x) for k, x in projs.items()},
                torch.from_numpy(dmin), torch.from_numpy(dmax))
    K, E = make_cameras(v, w, h, np.random.RandomState(0))[0]
    return render_view(K, E, w, h)[1], outs


def test_pipeline_bf16_outputs_are_float32_and_match_jax(plane_scene):
    _, outs = plane_scene
    keys = ("depth", "depths_upsampled", "confidence", "confidence_upsampled")
    for key in keys:
        assert outs["jax_bf16"][key].dtype == jnp.float32
        assert outs["port_bf16"][key].dtype == torch.float32
        got = _np(outs["port_bf16"][key])
        assert got.shape == np.asarray(outs["jax_bf16"][key]).shape
        assert _rl2(got, _np(outs["jax_bf16"][key])) <= MODULE_TOL, key
        assert _rl2(got, _np(outs["port_f32"][key])) <= MODULE_TOL, key


def test_bf16_depth_on_the_plane_tracks_f32_and_jax(plane_scene):
    gt, outs = plane_scene
    depth = {k: _np(v["depths_upsampled"])[0, ..., 0] for k, v in outs.items()}
    err = {k: np.median(np.abs(d - gt)) for k, d in depth.items()}
    assert err["port_f32"] < 0.12, err
    assert err["port_bf16"] < max(1.15 * err["port_f32"], err["port_f32"] + 0.01), err
    rel = np.abs(depth["port_bf16"] - depth["jax_bf16"]) / np.abs(depth["jax_bf16"])
    assert np.median(rel) <= 1e-2 and np.mean(rel <= 1e-2) >= 0.9


# -------------------------------------------------------------- training
def test_bf16_training_tracks_f32_and_jax():
    """tests/test_train.py::test_bf16_training_tracks_f32 for the port (6
    steps, regress, from a fresh seeded init), plus: parameters and
    gradients stay f32, and the first bf16 loss is JAX bf16's from the
    same weights and batch."""
    batch = _make_batch(np.random.RandomState(0))
    port_batch = jax.tree.map(lambda x: torch.from_numpy(np.array(x)), batch)
    init = init_weights(Pipeline(iteration=2, test=False), 0).state_dict()
    losses = {}
    for dt in (torch.float32, BF16):
        model = Pipeline(iteration=2, test=False, dtype=dt)
        load_state(model, {k: v.clone() for k, v in init.items()}, "fresh init")
        optimizer = make_optimizer(model)
        run = []
        for _ in range(6):
            run.append(float(train_step(model, optimizer, port_batch, 1e-3, True, 2)["loss"]))
        assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
                   for p in model.parameters())
        assert all(t.dtype == torch.float32 for t in model.state_dict().values()
                   if t.is_floating_point())
        losses[dt] = run
    f32, bf16 = losses[torch.float32], losses[BF16]
    assert all(np.isfinite(bf16)) and bf16[-1] < bf16[0], bf16
    assert abs(f32[0] - bf16[0]) / f32[0] < 0.02
    assert abs(np.mean(f32[-2:]) - np.mean(bf16[-2:])) / np.mean(f32[-2:]) < 0.15, losses

    outputs, _ = JaxPipeline(iteration=2, test=False, dtype=jnp.bfloat16).apply(
        flax_tree(init), batch["imgs"], batch["proj_matrices"], batch["depth_min"],
        batch["depth_max"], train=True, mutable=["batch_stats"])
    jax_loss = float(jax_full_loss(outputs, batch["depth"], batch["mask"],
                                   batch["depth_min"], batch["depth_max"], True))
    assert abs(bf16[0] - jax_loss) / jax_loss < 0.02, (bf16[0], jax_loss)


def test_checkpoint_weights_load_in_either_precision(port_models):
    """One float32 state dict serves both modes: loading it leaves every
    parameter and buffer float32."""
    state = port_models[torch.float32].state_dict()
    model = Pipeline(iteration=4, dtype=BF16)
    load_state(model, {k: v.clone() for k, v in state.items()}, "f32 model")
    for k, v in model.state_dict().items():
        assert v.dtype == state[k].dtype and torch.equal(v, state[k]), k
