"""The port's training step against the JAX package's, on the CPU.

One JAX computation per stage, shared by the module: `jax.value_and_grad`
of the JAX train loss (tests/test_train.py's batch, 64×96, B = 2, V = 3,
iteration 2) from JAX's own fresh `model.init`, carried into the port by
`weights.flax_state_dict`; the port's gradients go back to the flax tree
through `weights.flax_tree`.

Tolerances: loss rel 1e-5; the whole gradient rel L2 1e-4 and every
gradient tensor rel L2 2e-4; BN running statistics after the step 1e-5
of max|want| (f32 noise of two frameworks; the gradient of CorrNet 3,
reached through the 32-sample init sweep and both GRU iterations, came
within 0.5e-4 of 1e-4 in one of five runs of this test, hence a margin
for single tensors). The batch and init use seed 2: an argmax over the 256 depth
bins or the view-weight maximum over the 32 init samples whose top two
are within f32 noise of each other routes the gradient of that pixel to
another bin or sample in each framework, and one such pixel moves the
feature gradients by ~1e-3 while the loss moves by 1e-7. The batches of
seeds 0 and 1 hold such near-ties; seed 2's do not. The view-weight
head's last bias gets no gradient in exact arithmetic (a shift of every
sample's logit leaves their softmax unchanged), so its two f32 noises are
compared against 1e-6 of the global gradient norm instead.
Loss and metrics on fabricated predictions: rel 1e-6. Optimizer update
fed JAX's own gradients against optax's: abs 1e-7.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from itermvs_tpu.engine import metrics as jax_metrics
from itermvs_tpu.engine.train_loop import make_optimizer as jax_make_optimizer
from itermvs_tpu.models import Pipeline as JaxPipeline
from itermvs_tpu.models.losses import full_loss as jax_full_loss
from itermvs_tpu_torch.engine import metrics
from itermvs_tpu_torch.engine.train_loop import (
    clip_by_global_norm_, forward_loss, init_weights, lr_for_epoch, make_optimizer,
    parse_lrepochs, train_step, val_step)
from itermvs_tpu_torch.models import Pipeline
from itermvs_tpu_torch.models.losses import full_loss
from itermvs_tpu_torch.weights import flax_state_dict, flax_tree, load_state
from tests.test_loss_parity import _fabricate
from tests.test_train import _make_batch

SEED = 2
ITERATION = 2
ZERO_GRAD = "iter_mvs/evaluation/pixel_view_weight/conv1/conv/bias"


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    """Two torch threads for this module: the suite runs six workers on
    the CPU's cores, and eight threads each only contend."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def setup():
    batch = _make_batch(np.random.RandomState(SEED))
    model = JaxPipeline(iteration=ITERATION, test=False)
    variables = model.init(jax.random.PRNGKey(SEED), batch["imgs"], batch["proj_matrices"],
                           batch["depth_min"], batch["depth_max"], train=False)
    return model, jax.tree.map(np.asarray, variables), batch


@pytest.fixture(scope="module")
def jax_steps(setup):
    """{regress: (loss, grads, updated batch_stats)} of JAX's train loss."""
    model, variables, batch = setup

    def losses(params):
        outputs, mutated = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            batch["imgs"], batch["proj_matrices"], batch["depth_min"],
            batch["depth_max"], train=True, mutable=["batch_stats"])
        return jnp.stack([jax_full_loss(outputs, batch["depth"], batch["mask"],
                                        batch["depth_min"], batch["depth_max"], regress)
                          for regress in (True, False)]), mutated["batch_stats"]

    @jax.jit
    def both(params):                       # one compile for both stages
        values, vjp, stats = jax.vjp(losses, params, has_aux=True)
        grads = [vjp(jnp.eye(2, dtype=jnp.float32)[i])[0] for i in range(2)]
        return values, grads, stats

    values, grads, stats = both(variables["params"])
    stats = jax.tree.map(np.asarray, stats)
    return {regress: (float(values[i]), jax.tree.map(np.asarray, grads[i]), stats)
            for i, regress in enumerate((True, False))}


def _port_model(variables):
    model = Pipeline(iteration=ITERATION, test=False)
    load_state(model, flax_state_dict(variables), "JAX init")
    return model.train()


@pytest.mark.parametrize("regress", [True, False])
def test_train_step_loss_grads_and_bn_stats_match_jax(setup, jax_steps, regress):
    _, variables, batch = setup
    want_loss, want_grads, want_stats = jax_steps[regress]
    model = _port_model(variables)
    loss, _ = forward_loss(model, _torch(batch), regress)
    loss.backward()
    assert abs(loss.item() - want_loss) <= 1e-5 * abs(want_loss)

    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in model.named_parameters()}
    got, want = _flat(flax_tree(grads)["params"]), _flat(want_grads)
    assert set(got) == set(want)
    total = np.sqrt(sum(np.sum(w.astype(np.float64) ** 2) for w in want.values()))
    diff = np.sqrt(sum(np.sum((got[k] - w).astype(np.float64) ** 2) for k, w in want.items()))
    assert diff <= 1e-4 * total
    for key, w in want.items():
        err = np.linalg.norm(got[key] - w)
        if key == ZERO_GRAD:
            assert err <= 1e-6 * total, key
        else:
            assert err <= 2e-4 * np.linalg.norm(w), (key, err / np.linalg.norm(w))

    got_stats = _flat(flax_tree(dict(model.named_buffers()))["batch_stats"])
    for key, w in _flat(want_stats).items():
        np.testing.assert_allclose(got_stats[key], w, rtol=0, atol=1e-5 * np.abs(w).max(),
                                   err_msg=key)


def test_fresh_init_matches_flax_initializers(setup):
    """Per-tensor standard deviation within 10% of JAX `model.init`'s on
    tensors with ≥ 1000 elements; biases and BN exactly flax's."""
    _, variables, _ = setup
    want = _flat(variables)
    got = _flat(flax_tree(init_weights(Pipeline(iteration=ITERATION, test=False), 5)
                          .state_dict()))
    assert set(got) == set(want)
    checked = 0
    for key, w in want.items():
        g = got[key]
        assert g.shape == w.shape, key
        if key.endswith(("/bias", "/mean")) or key.endswith("/scale") or key.endswith("/var"):
            assert np.array_equal(g, w), key
        elif w.size >= 1000:
            assert abs(g.std() / w.std() - 1) <= 0.1, (key, g.std(), w.std())
            checked += 1
    assert checked >= 40


def test_weights_round_trip_through_the_flax_tree(setup):
    _, variables, _ = setup
    back = _flat(flax_tree(flax_state_dict(variables)))
    want = _flat(variables)
    assert set(back) == set(want)
    for key, w in want.items():
        assert np.array_equal(back[key], w), key


@pytest.mark.parametrize("scale,wd", [(1.0, 0.0), (1e-3, 0.0), (0.0, 1e-2)])
def test_optimizer_update_matches_optax(setup, jax_steps, scale, wd):
    """Clip (engaged at scale 1: the global norm is far above 2; not at
    1e-3), then Adam, fed JAX's own gradients; and the decay alone (zero
    gradients). Decay on top of real gradients is held on a small tree
    below: here, elements where wd·param cancels the gradient to about
    Adam's eps would turn f32 noise into 1e-6 of update."""
    _, variables, _ = setup
    grads = jax.tree.map(lambda g: g * np.float32(scale), jax_steps[True][1])
    params = jax.tree.map(jnp.asarray, variables["params"])
    norm = float(np.sqrt(sum(np.sum(g.astype(np.float64) ** 2)
                             for g in _flat(grads).values())))
    assert (norm > 2.0) == (scale == 1.0)
    tx = jax_make_optimizer(wd)
    state = tx.init(params)
    state.hyperparams["learning_rate"] = jnp.float32(1e-3)
    updates, _ = tx.update(jax.tree.map(jnp.asarray, grads), state, params)

    model = _port_model(variables)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    port_grads = flax_state_dict({"params": grads, "batch_stats": variables["batch_stats"]})
    for k, p in model.named_parameters():
        p.grad = port_grads[k].clone()
    optimizer = make_optimizer(model, wd)
    clip_by_global_norm_(list(model.parameters()))
    optimizer.step()
    got = _flat(flax_tree({k: p.detach() - before[k] for k, p in model.named_parameters()}))
    for key, w in _flat(jax.tree.map(np.asarray, updates)).items():
        np.testing.assert_allclose(got[f"params/{key}"], w, rtol=0, atol=1e-7, err_msg=key)


def test_optimizer_decays_after_the_clip_as_optax():
    """optax chains clip → add_decayed_weights → adam: the clip sees the
    raw gradients only, and the decay is added after it. Two steps on a
    small tree with the clip engaged; no element near cancellation."""
    rng = np.random.RandomState(3)
    params = {"a": rng.uniform(0.05, 0.15, (6, 5)).astype(np.float32),
              "b": rng.uniform(-0.15, -0.05, (7,)).astype(np.float32)}
    grads = [{k: (rng.uniform(1.0, 3.0, v.shape) * np.sign(v)).astype(np.float32)
              for k, v in params.items()} for _ in range(2)]
    wd = 0.1
    tx = jax_make_optimizer(wd)
    state = tx.init(jax.tree.map(jnp.asarray, params))
    state.hyperparams["learning_rate"] = jnp.float32(1e-3)
    p_jax = jax.tree.map(jnp.asarray, params)

    module = torch.nn.ParameterDict({k: torch.nn.Parameter(torch.from_numpy(v.copy()))
                                     for k, v in params.items()})
    optimizer = make_optimizer(module, wd)
    for g in grads:
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state, p_jax)
        p_jax = jax.tree.map(lambda p, u: p + u, p_jax, updates)
        for k, p in module.items():
            p.grad = torch.from_numpy(g[k].copy())
        assert float(clip_by_global_norm_(list(module.values()))) > 2.0
        optimizer.step()
    for k, p in module.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(p_jax[k]), rtol=0, atol=1e-7)


@pytest.mark.parametrize("regress", [True, False])
def test_train_steps_lower_the_loss(setup, regress):
    """4 steps on one batch lower the loss (as tests/test_train.py asserts
    for JAX); stage 1 (no --regress) trains too; validation runs BN in
    eval mode and leaves the running statistics alone."""
    _, variables, batch = setup
    model = _port_model(variables)
    optimizer = make_optimizer(model)
    tb = _torch(batch)
    losses = []
    for _ in range(4):
        scalars = train_step(model, optimizer, tb, 1e-3, regress, ITERATION)
        losses.append(float(scalars["loss"]))
        assert np.isfinite(losses[-1])
    assert losses[-1] < losses[0], losses
    assert "abs_error_final_full" in scalars and "thres1mm_gru_2" in scalars
    stats = {k: v.clone() for k, v in model.named_buffers()}
    val = val_step(model, tb, regress, ITERATION)
    assert np.isfinite(float(val["loss"])) and model.training
    assert all(torch.equal(v, stats[k]) for k, v in model.named_buffers())


def _fabricated(f):
    nhwc = lambda x: np.ascontiguousarray(np.moveaxis(x, -3, -1))
    outputs = {
        "depths": {"probability": [nhwc(p) for p in f["prob"]],
                   "combine": [nhwc(c) for c in f["combine"]],
                   "initial": [nhwc(f["initial"])]},
        "confidences": [nhwc(c) for c in f["conf"]],
        "depths_upsampled": [nhwc(f["upsampled"])],
    }
    gt = {"level_0": nhwc(f["gt_0"]), "level_2": nhwc(f["gt_2"])}
    masks = {"level_0": nhwc(f["mask_0"]), "level_2": nhwc(f["mask_2"])}
    return outputs, gt, masks


@pytest.mark.parametrize("regress", [True, False])
@pytest.mark.parametrize("empty", [False, True])
def test_full_loss_matches_jax(rng, regress, empty):
    f = _fabricate(rng)
    if empty:                       # the empty-mask guards
        f["mask_2"][:] = 0.0
    outputs, gt, masks = _fabricated(f)
    want = float(jax_full_loss(jax.tree.map(jnp.asarray, outputs),
                               jax.tree.map(jnp.asarray, gt), jax.tree.map(jnp.asarray, masks),
                               jnp.asarray(f["depth_min"]), jnp.asarray(f["depth_max"]),
                               regress=regress))
    got = float(full_loss(_torch(outputs), _torch(gt), _torch(masks),
                          torch.from_numpy(f["depth_min"]), torch.from_numpy(f["depth_max"]),
                          regress=regress))
    assert np.isfinite(got) and got == pytest.approx(want, rel=1e-6)


def test_depth_metrics_and_meter_match_jax(rng):
    f = _fabricate(rng)
    f["mask_2"][1] = 0.0            # an image with an empty mask counts for nothing
    outputs, gt, masks = _fabricated(f)
    combine = outputs["depths"]["combine"]
    up = outputs["depths_upsampled"][0]
    want = jax_metrics.depth_metrics([jnp.asarray(c) for c in combine], jnp.asarray(up),
                                     jax.tree.map(jnp.asarray, gt),
                                     jax.tree.map(jnp.asarray, masks), 2)
    got = metrics.depth_metrics([torch.from_numpy(c) for c in combine], torch.from_numpy(up),
                                _torch(gt), _torch(masks), 2)
    assert set(got) == set(want)
    for key in want:
        assert float(got[key]) == pytest.approx(float(want[key]), rel=1e-6, abs=1e-7), key
    meters = [jax_metrics.DictAverageMeter(), metrics.DictAverageMeter()]
    for m, src in zip(meters, (want, got)):
        m.update(src)
        m.update({k: 2 * float(v) for k, v in src.items()}, n=3)
    for key in want:
        assert meters[1].mean()[key] == pytest.approx(meters[0].mean()[key], rel=1e-6, abs=1e-7)


def test_lr_schedule_matches_jax():
    from itermvs_tpu.engine import train_loop as jax_train_loop

    for spec in ("4,8,12:2", "10,12,14:2", "3:10"):
        assert parse_lrepochs(spec) == jax_train_loop.parse_lrepochs(spec)
        for epoch in range(16):
            assert lr_for_epoch(1e-3, epoch, spec) == jax_train_loop.lr_for_epoch(
                1e-3, epoch, spec)
