"""`--input_uint8` in the port, as tests/test_uint8_input.py holds it in
the JAX package: the loader leaves level_0 raw uint8, the model scales it
with the loader's own expression `2·x/255 − 1` (Pipeline._normalize), and
when no resize is needed that is bit-identical to the float32 plane, so
depth and confidence must be exactly equal (128x96, 3 views, the
vendored DTU weights, on the CPU).
"""
import os

import numpy as np
import pytest
import torch

from tests.synthetic_scene import build_scene_dir

from itermvs_tpu.data import find_dataset_def as jax_dataset_def
from itermvs_tpu_torch import eval as port_eval
from itermvs_tpu_torch.data import find_dataset_def
from itermvs_tpu_torch.models import Pipeline
from itermvs_tpu_torch.weights import load_npz_weights, pretrained_path

VIEWS, W, H = 3, 128, 96


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scene"))
    build_scene_dir(root, num_views=VIEWS, width=W, height=H, write_gt_depth=False)
    return root


@pytest.fixture(scope="module")
def samples(scene):
    make = find_dataset_def("custom")
    return make(scene, VIEWS, (W, H))[0], make(scene, VIEWS, (W, H), uint8_level0=True)[0]


def test_uint8_level0_equals_the_jax_loaders(scene, samples):
    want = jax_dataset_def("custom")(scene, VIEWS, (W, H), uint8_level0=True)[0]
    got = samples[1]["imgs"]["level_0"]
    assert got.dtype == want["imgs"]["level_0"].dtype == np.uint8
    np.testing.assert_array_equal(got, want["imgs"]["level_0"])


def test_normalised_uint8_plane_equals_the_float32_plane(samples):
    s_f32, s_u8 = samples
    lvl0 = s_u8["imgs"]["level_0"]
    np.testing.assert_array_equal(2.0 * lvl0.astype(np.float32) / 255.0 - 1.0,
                                  s_f32["imgs"]["level_0"])
    got = Pipeline._normalize(torch.from_numpy(lvl0))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), s_f32["imgs"]["level_0"])
    every = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(Pipeline._normalize(torch.from_numpy(every)).numpy(),
                                  2.0 * every.astype(np.float32) / 255.0 - 1.0)


def test_pipeline_outputs_are_bit_equal_from_uint8(samples):
    s_f32, s_u8 = samples
    model = load_npz_weights(Pipeline(iteration=2), pretrained_path("dtu"))
    projs = {k: torch.from_numpy(v)[None] for k, v in s_f32["proj_matrices"].items()}
    dmin = torch.tensor([s_f32["depth_min"]])
    dmax = torch.tensor([s_f32["depth_max"]])
    with torch.inference_mode():
        outs = [model({"level_0": torch.from_numpy(s["imgs"]["level_0"])[None]},
                      projs, dmin, dmax) for s in (s_f32, s_u8)]
    for key in ("depths_upsampled", "confidence_upsampled"):
        assert torch.equal(outs[0][key], outs[1][key]), key


def test_eval_main_writes_the_same_pfms_from_uint8(tmp_path, scene):
    common = ["--dataset=custom", "--batch_size=1", "--n_views", str(VIEWS),
              "--img_wh", str(W), str(H), f"--testpath={scene}", "--iteration", "2",
              "--device", "cpu"]
    port_eval.main([*common, f"--outdir={tmp_path / 'f32'}"])
    port_eval.main([*common, f"--outdir={tmp_path / 'u8'}", "--input_uint8"])
    for v in range(VIEWS):
        for kind in ("depth_est", "confidence"):
            name = os.path.join(kind, f"{v:08d}.pfm")
            assert (tmp_path / "u8" / name).read_bytes() == \
                (tmp_path / "f32" / name).read_bytes(), name
