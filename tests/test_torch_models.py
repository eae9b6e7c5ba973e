"""The port's models against the JAX package, with the vendored DTU weights.

Same numpy inputs go through JAX (on the CPU, as conftest pins it) and
the port (on the CPU, so its kernels' plain versions run), in float32.

Tolerances:
* FeatureNet: 1e-5 × max|x| per level — the same convolutions in two
  frameworks differ only by f32 summation order.
* Full test-mode pipeline: median relative depth error ≤ 1e-4 and at
  least 99.5% of pixels within 1e-3 relative; confidence within 1e-3 on
  at least 99.5% of pixels. The windowed expectation reads a window
  around an argmax over 256 bins: where two bins nearly tie, f32 noise
  can move the window by one bin and change that pixel's depth, so the
  bound is a fraction of pixels, not a maximum.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from itermvs_tpu.engine.checkpoint import load_npz_variables
from itermvs_tpu.models import Pipeline as JaxPipeline
from itermvs_tpu_torch.models import Pipeline
from itermvs_tpu_torch.weights import load_npz_weights, pretrained_path

CKPT = pretrained_path("dtu")


def make_scene(rng, batch=1, views=3, height=64, width=96):
    """Random images + slightly perturbed cameras (the scene of
    tests/test_model_parity.py)."""
    def camera(tz):
        K = np.array([[width * 1.1, 0, width / 2],
                      [0, width * 1.1, height / 2],
                      [0, 0, 1]], np.float32)
        angle = rng.uniform(-0.03, 0.03, 3)
        cx, cy, cz = np.cos(angle)
        sx, sy, sz = np.sin(angle)
        Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
        Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
        E = np.eye(4, dtype=np.float32)
        E[:3, :3] = (Rx @ Ry @ Rz).astype(np.float32)
        E[:3, 3] = [rng.uniform(-0.2, 0.2), rng.uniform(-0.2, 0.2), tz]
        return K, E

    imgs = {}
    for lvl in range(4):
        h, w = height >> lvl, width >> lvl
        imgs[f"level_{lvl}"] = rng.rand(batch, views, h, w, 3).astype(np.float32) * 2 - 1
    cams = [camera(0.0 if v == 0 else rng.uniform(0.1, 0.3)) for v in range(views)]
    projs = {}
    for lvl in range(4):
        mats = []
        for K, E in cams:
            Kl = K.copy()
            Kl[:2] *= 0.5 ** lvl
            P = E.copy()
            P[:3, :4] = Kl @ E[:3, :4]
            mats.append(P)
        projs[f"level_{lvl}"] = np.tile(np.stack(mats)[None], (batch, 1, 1, 1))
    depth_min = np.full((batch,), 2.0, np.float32)
    depth_max = np.full((batch,), 10.0, np.float32)
    return imgs, projs, depth_min, depth_max


@pytest.fixture(scope="module")
def jax_variables():
    return load_npz_variables(CKPT)


@pytest.fixture(scope="module")
def port_model():
    return load_npz_weights(Pipeline(iteration=4), CKPT)


def test_feature_net_matches_jax(jax_variables, port_model):
    rng = np.random.RandomState(0)
    imgs = rng.rand(2, 64, 96, 3).astype(np.float32) * 2 - 1
    want = JaxPipeline(test=True).apply(jax_variables, jnp.asarray(imgs),
                                        method=JaxPipeline.extract)
    with torch.no_grad():
        got = port_model.extract(torch.from_numpy(imgs))
    for key, shape in (("level1", (2, 32, 48, 16)), ("level2", (2, 16, 24, 32)),
                       ("level3", (2, 8, 12, 48))):
        w = np.asarray(want[key])
        g = got[key].permute(0, 2, 3, 1).numpy()
        assert g.shape == w.shape == shape
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max())


def _depth_agreement(got, want):
    rel = np.abs(got - want) / np.abs(want)
    return np.median(rel), np.mean(rel <= 1e-3)


@pytest.mark.parametrize("iteration", [4])
def test_pipeline_test_mode_matches_jax(jax_variables, port_model, iteration):
    rng = np.random.RandomState(0)
    imgs, projs, dmin, dmax = make_scene(rng)
    want = JaxPipeline(iteration=iteration, test=True).apply(
        jax_variables, {k: jnp.asarray(v) for k, v in imgs.items()},
        {k: jnp.asarray(v) for k, v in projs.items()},
        jnp.asarray(dmin), jnp.asarray(dmax))
    with torch.no_grad():
        got = port_model({k: torch.from_numpy(v) for k, v in imgs.items()},
                         {k: torch.from_numpy(v) for k, v in projs.items()},
                         torch.from_numpy(dmin), torch.from_numpy(dmax))
    for key in ("depth", "depths_upsampled"):
        w = np.asarray(want[key])
        g = got[key].numpy()
        assert g.shape == w.shape and np.isfinite(g).all()
        median, within = _depth_agreement(g, w)
        assert median <= 1e-4, f"{key}: median rel err {median}"
        assert within >= 0.995, f"{key}: {within:.4f} of pixels within 1e-3"
    for key in ("confidence", "confidence_upsampled"):
        w = np.asarray(want[key])
        g = got[key].numpy()
        assert g.shape == w.shape
        assert np.mean(np.abs(g - w) <= 1e-3) >= 0.995, key


def test_pipeline_feature_cache_forms_agree(port_model):
    """match() on per-view feature dicts (the eval feature cache's form)
    equals the monolithic forward, up to f32 noise of convolutions run at
    another batch size (1e-6 relative)."""
    rng = np.random.RandomState(1)
    imgs, projs, dmin, dmax = make_scene(rng)
    t_projs = {k: torch.from_numpy(v) for k, v in projs.items()}
    with torch.no_grad():
        whole = port_model({k: torch.from_numpy(v) for k, v in imgs.items()},
                           t_projs, torch.from_numpy(dmin), torch.from_numpy(dmax))
        per_view = [port_model.extract(torch.from_numpy(imgs["level_0"][:, i]))
                    for i in range(imgs["level_0"].shape[1])]
        cached = port_model.match(per_view, t_projs, torch.from_numpy(dmin),
                                  torch.from_numpy(dmax))
    for key in ("depths_upsampled", "confidence_upsampled"):
        np.testing.assert_allclose(cached[key].numpy(), whole[key].numpy(),
                                   rtol=1e-6, atol=1e-6)
