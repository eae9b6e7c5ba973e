"""The view-weighted correlation aggregation (K11 `view_aggregate`, K12
`view_aggregate_grad`) on the CPU, where the port runs their plain
versions: the port's `Evaluation.init_sweep` and `iter_sweep`, which
aggregate through it, against the JAX package's `Evaluation` branches
(itermvs_tpu/models/itermvs.py:246-252, 297-349) on the same numpy
inputs and the DTU weights carried over by `weights.py`, in float32;
and `ViewAggregate`'s backward against autograd of the plain forward and
under gradcheck.

Tolerances: the branches' outputs within 1e-5 of the largest value (the
sweep, the convolutions and the aggregation sum in another order in the
two frameworks, as in tests/test_torch_models.py). The backward: ∂c_v
bit-equal to autograd of the plain forward (the same two roundings), ∂w
within 1e-6 (relative L2; its sum over n·G runs in another order than
autograd's).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from itermvs_tpu.engine.checkpoint import load_npz_variables
from itermvs_tpu.models.itermvs import Evaluation as JaxEvaluation
from itermvs_tpu.ops.warping import pack_bilinear
from itermvs_tpu_torch.models.itermvs import (
    CORR_INTERVALS, GROUPS, INTERVAL_SCALE, LEVELS, Evaluation, initial_depth_samples)
from itermvs_tpu_torch.ops.depth_range import depth_unnormalization
from itermvs_tpu_torch.ops.view_aggregate import (
    ViewAggregate, _batch_stride, view_aggregate, view_aggregate_grad,
    view_aggregate_grad_plain, view_aggregate_plain)
from itermvs_tpu_torch.ops.warping import relative_projection
from itermvs_tpu_torch.weights import npz_state_dict, pretrained_path

CKPT = pretrained_path("dtu")
BATCH, HEIGHT, WIDTH = 2, 96, 128          # the 1/8 grid 12x16, the 1/4 grid 24x32
CHANNELS = {"level1": 16, "level2": 32, "level3": 48}
PREFIX = "iter_mvs.evaluation."


@pytest.fixture(scope="module")
def evaluations():
    """(JAX Evaluation's variables, the port's Evaluation) from the DTU
    weights."""
    variables = load_npz_variables(CKPT)
    jax_vars = {"params": variables["params"]["iter_mvs"]["evaluation"]}
    model = Evaluation()
    model.load_state_dict({k[len(PREFIX):]: v for k, v in npz_state_dict(CKPT).items()
                           if k.startswith(PREFIX)})
    return jax_vars, model.eval()


def scene(views, rng):
    """Seeded inputs of both branches at BATCH x HEIGHT x WIDTH: NHWC
    features per level (the reference's already on the 1/4 grid for the
    iterations), relative projections per level from the plane scene's
    cameras (batch entry b with view b as its reference), the init
    sweep's samples, the iterations' samples around a random normalized
    depth, and frozen view weights in [1/(V−1), 1]."""
    cams = chip_smoke.make_cameras(views, WIDTH, HEIGHT, rng)
    pyrs = [chip_smoke.projection_pyramid(k, e) for k, e in cams]
    rel = {}
    for i, key in enumerate(LEVELS):
        proj = torch.from_numpy(np.stack([
            np.stack([pyrs[v][f"level_{i + 1}"] for v in [b] + [u for u in range(views)
                                                              if u != b]])
            for b in range(BATCH)]))
        rel[key] = relative_projection(proj[:, 1:], proj[:, :1]).numpy()
    h4, w4 = HEIGHT // 4, WIDTH // 4
    src = {key: [rng.randn(BATCH, HEIGHT >> (i + 1), WIDTH >> (i + 1), CHANNELS[key])
                 .astype(np.float32) for _ in range(views - 1)]
           for i, key in enumerate(LEVELS)}
    ref_init = rng.randn(BATCH, h4 // 2, w4 // 2, 48).astype(np.float32)
    ref_iter = {key: rng.randn(BATCH, h4, w4, CHANNELS[key]).astype(np.float32)
                for key in LEVELS}
    idmin = torch.full((BATCH,), 1.0 / chip_smoke.DEPTH_MIN)
    idmax = torch.full((BATCH,), 1.0 / chip_smoke.DEPTH_MAX)
    init = initial_depth_samples(idmin, idmax, h4 // 2, w4 // 2).contiguous().numpy()
    intervals = torch.tensor(sum((CORR_INTERVALS[k] for k in LEVELS), ())).reshape(
        1, -1, 1, 1) * INTERVAL_SCALE
    norm = torch.from_numpy(rng.rand(BATCH, 1, h4, w4).astype(np.float32))
    samples = depth_unnormalization(torch.clamp(norm + intervals, 0.0, 1.0),
                                    idmin.reshape(-1, 1, 1, 1), idmax.reshape(-1, 1, 1, 1))
    weights = (1.0 / (views - 1) + (1 - 1.0 / (views - 1))
               * rng.rand(BATCH, views - 1, h4, w4)).astype(np.float32)
    return dict(rel=rel, src=src, ref_init=ref_init, ref_iter=ref_iter, idmin=idmin.numpy(),
                idmax=idmax.numpy(), init=init, samples=samples.numpy(), weights=weights)


def assert_close(got, want):
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("sources", [3, 5])
def test_sweep_branches_match_jax(evaluations, sources):
    """init_sweep's view weights and score volume, and iter_sweep's
    scores, of the port (aggregating through view_aggregate's plain
    version) against the JAX branches at 3 and 5 sources."""
    jax_vars, model = evaluations
    s = scene(sources + 1, np.random.RandomState(sources))
    packed = {k: [pack_bilinear(jnp.asarray(x)) for x in v] for k, v in s["src"].items()}
    # Jitted: one compile per branch is cheaper than eager op-by-op here.
    init_sweep = jax.jit(lambda *a: JaxEvaluation().apply(
        jax_vars, *a, method=JaxEvaluation.init_sweep))
    iter_sweep = jax.jit(lambda *a: JaxEvaluation().apply(
        jax_vars, *a, method=JaxEvaluation.iter_sweep))
    weights_j, score_j, _ = init_sweep(
        jnp.asarray(s["ref_init"]), packed["level3"], jnp.asarray(s["rel"]["level3"]),
        jnp.asarray(s["init"]), jnp.asarray(s["idmin"]), jnp.asarray(s["idmax"]))
    corr_j = iter_sweep(
        {k: jnp.asarray(v) for k, v in s["ref_iter"].items()}, packed,
        {k: jnp.asarray(v) for k, v in s["rel"].items()}, jnp.asarray(s["samples"]),
        jnp.asarray(s["weights"][..., None]))

    def flat(x):
        return torch.from_numpy(x).reshape(x.shape[0], -1, x.shape[-1])

    src = {k: [torch.from_numpy(x) for x in v] for k, v in s["src"].items()}
    rel = {k: torch.from_numpy(v) for k, v in s["rel"].items()}
    with torch.no_grad():
        weights, score = model.init_sweep(flat(s["ref_init"]), src["level3"], rel["level3"],
                                          torch.from_numpy(s["init"]))
        corr = model.iter_sweep({k: flat(v) for k, v in s["ref_iter"].items()}, src, rel,
                                torch.from_numpy(s["samples"]),
                                torch.from_numpy(s["weights"]))
    assert_close(weights.numpy(), np.asarray(weights_j)[..., 0])
    assert_close(score.permute(0, 2, 3, 1).numpy(), np.asarray(score_j))
    assert_close(corr.permute(0, 2, 3, 1).numpy(), np.asarray(corr_j))


def _inputs(views, stacked, dtype, seed=0, b=2, n=4, p=12 * 16):
    gen = torch.Generator().manual_seed(seed)
    if stacked:
        corrs = torch.randn(b, views, n, GROUPS, p, generator=gen, dtype=dtype).unbind(1)
    else:
        corrs = [torch.randn(b, n, GROUPS, p, generator=gen, dtype=dtype)
                 for _ in range(views)]
    weights = 1.0 / views + (1 - 1.0 / views) * torch.rand(b, views, p, generator=gen,
                                                           dtype=dtype)
    return list(corrs), weights


@pytest.mark.parametrize("views,stacked", [(3, True), (5, False)])
def test_backward_matches_autograd_of_the_plain_forward(views, stacked):
    """ViewAggregate's CPU forward and backward (the plain versions)
    against torch.autograd through view_aggregate_plain, with ∂w and with
    the weights frozen (the iteration branch)."""
    corrs, weights = _inputs(views, stacked, torch.float32)
    grad = torch.randn(corrs[0].shape, generator=torch.Generator().manual_seed(1))
    for weight_grad in (True, False):
        leaves = [c.detach().clone().requires_grad_() for c in corrs]
        w = weights.detach().clone().requires_grad_(weight_grad)
        out = view_aggregate(leaves, w)
        out.backward(grad)
        ref = [c.detach().clone().requires_grad_() for c in corrs]
        w_ref = weights.detach().clone().requires_grad_(weight_grad)
        want = view_aggregate_plain(ref, w_ref)
        want.backward(grad)
        assert torch.equal(out, want)
        assert all(torch.equal(a.grad, z.grad) for a, z in zip(leaves, ref))
        if weight_grad:
            rel = (w.grad - w_ref.grad).norm() / w_ref.grad.norm()
            assert rel <= 1e-6
        else:
            assert w.grad is None


@pytest.mark.parametrize("weight_grad", [True, False])
def test_gradcheck(weight_grad):
    """torch.autograd.gradcheck of ViewAggregate in float64, with the
    weights' gradient (the init branch) and without (the iterations)."""
    corrs, weights = _inputs(3, True, torch.float64, b=2, n=1, p=5)
    corrs = [c.detach().clone().requires_grad_() for c in corrs]
    weights = weights.detach().requires_grad_(weight_grad)
    assert torch.autograd.gradcheck(lambda w, *c: ViewAggregate.apply(w, *c),
                                    (weights, *corrs))


def test_the_plain_versions_fold_in_view_order():
    """The plain forward is the explicit fold ((c0·w0 + c1·w1) + c2·w2) /
    (1e-5 + ((w0 + w1) + w2)), rounded as written; ∂c_v = (g / S)·w_v;
    the backward without ∂w needs no views."""
    corrs, weights = _inputs(3, False, torch.float32)
    w = [weights[:, v, None, None] for v in range(3)]
    num = (corrs[0] * w[0] + corrs[1] * w[1]) + corrs[2] * w[2]
    s = (1e-5 + ((weights[:, 0] + weights[:, 1]) + weights[:, 2]))[:, None, None]
    assert torch.equal(view_aggregate_plain(corrs, weights), num / s)
    grad = torch.randn(corrs[0].shape, generator=torch.Generator().manual_seed(2))
    d_corrs, d_w = view_aggregate_grad_plain(None, weights, grad, False)
    assert d_w is None
    assert all(torch.equal(d, (grad / s) * w[v]) for v, d in enumerate(d_corrs))
    before = (view_aggregate.launches, view_aggregate_grad.launches)
    got, got_w = view_aggregate_grad(weights, grad, corrs, view_aggregate(corrs, weights))
    assert got_w.shape == weights.shape and len(got) == 3
    assert (view_aggregate.launches, view_aggregate_grad.launches) == before   # CPU: plain


def test_views_pass_as_they_lie():
    """The launcher's one batch stride: slices of a stacked tensor give
    its stride, views of their own their size; views whose [n, G, P] is
    not dense, or with two batch strides, are refused; shapes are
    checked on every device."""
    stacked, _ = _inputs(4, True, torch.float32, b=3)
    assert _batch_stride(stacked) == 4 * 4 * GROUPS * 12 * 16
    own, weights = _inputs(4, False, torch.float32, b=3)
    assert _batch_stride(own) == 4 * GROUPS * 12 * 16
    with pytest.raises(ValueError, match="one batch stride"):
        _batch_stride([stacked[0], own[1]])
    with pytest.raises(ValueError, match="dense"):
        _batch_stride([c.transpose(1, 2).contiguous().transpose(1, 2) for c in own])
    with pytest.raises(ValueError, match="weights"):
        view_aggregate(own, weights[:, :3])
    with pytest.raises(ValueError, match="one shape"):
        view_aggregate([own[0], own[1][:, :2]], weights[:, :2])
