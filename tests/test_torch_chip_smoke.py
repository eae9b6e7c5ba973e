"""chip_smoke.py's CPU-checkable parts: its scene copy, its launch plan,
and its in-memory samples through the port's eval core loop.

The scene copy must equal tests/synthetic_scene.py exactly (same numpy
arithmetic); the depth check uses the same 0.05 bar as the JAX
package's verify recipe.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from tests import synthetic_scene
from itermvs_tpu_torch.eval import run_depth
from itermvs_tpu_torch.io import read_pfm
from itermvs_tpu_torch.models import Pipeline
from itermvs_tpu_torch.weights import load_npz_weights, pretrained_path


def test_scene_copy_equals_the_test_scene():
    cams = chip_smoke.make_cameras(3, 64, 48, np.random.RandomState(0))
    want = synthetic_scene.make_cameras(3, 64, 48, np.random.RandomState(0))
    for (k, e), (kw, ew) in zip(cams, want):
        assert np.array_equal(k, kw) and np.array_equal(e, ew)
        rgb, depth = chip_smoke.render_view(k, e, 64, 48)
        rgb_w, depth_w = synthetic_scene.render_view(kw, ew, 64, 48)
        assert np.array_equal(rgb, rgb_w) and np.array_equal(depth, depth_w)


def test_launch_plan_is_52_per_map_at_1600x1152():
    shapes = chip_smoke.sweep_shapes(1600, 1152, 5, 4)
    assert [s[-1] for s in shapes] == [4, 16, 16, 16]
    assert [s[:8] for s in shapes] == [
        ("init", 1, 32, 144, 200, 144, 200, 48),
        ("iter_level1", 1, 4, 288, 400, 576, 800, 16),
        ("iter_level2", 1, 4, 288, 400, 288, 400, 32),
        ("iter_level3", 1, 2, 288, 400, 144, 200, 48)]


@pytest.mark.parametrize("cache", [True, False])
def test_in_memory_samples_through_run_depth(tmp_path, cache):
    cams, images, gts = chip_smoke.render_scene(512, 384, 3, 0)
    samples = chip_smoke.samples_of(cams, images)
    assert samples[0]["imgs"]["level_0"].shape == (1, 3, 384, 512, 3)
    model = load_npz_weights(Pipeline(iteration=4), pretrained_path("dtu"))
    secs = run_depth(model, samples, str(tmp_path), torch.device("cpu"),
                     feature_cache=cache, log=lambda *_: None)
    assert len(secs) == 3
    depth, _ = read_pfm(os.path.join(tmp_path, "depth_est", "00000000.pfm"))
    assert depth.shape == (384, 512, 1) and np.isfinite(depth).all()
    assert np.median(np.abs(depth[..., 0] - gts[0])) < 0.05


def test_fusion_core_on_the_analytic_plane(tmp_path):
    """chip_smoke's in-memory fusion of exact depths with unit confidence:
    most pixels survive and the cloud lies on the plane (the bar of
    tests/test_data_fusion.py::test_fusion_on_exact_depth)."""
    cams, images, depths = chip_smoke.render_scene(128, 96, 5, 0)
    before = chip_smoke.consistency.launches
    rec = chip_smoke.fuse_scene(
        chip_smoke.fusion_views(cams, depths, [np.ones_like(d) for d in depths], images),
        str(tmp_path), torch.device("cpu"))
    assert chip_smoke.consistency.launches == before      # CPU: the plain version
    assert rec["views"] == 5 and rec["pixel_share"] > 0.5
    assert rec["max_abs_z_minus_z0"] < 0.02
    assert set(rec["phases_thread_s"]) >= {"dispatch", "mask_png", "backproject",
                                           "ply_write"}


def test_consistency_inputs_plant_their_cases():
    ref, conf, src, r2s, s2r, k_ref, k_ref_inv, k_srcs, k_srcs_inv = \
        chip_smoke.consistency_inputs(160, 120, 3, 0, "cpu")
    assert src.shape == (3, 120, 160) and r2s.shape == (3, 4, 4)
    assert (ref == 0).any() and (ref < 0).any() and (ref == 1e-6).any()
    assert (conf == 0.3).any() and (conf < 0.3).any() and (conf > 0.3).any()
    fusion = dict(chip_smoke.FUSION, geo_mask_thres=1)
    # The moved source: no reference pixel projects into it.
    avg, bits = chip_smoke.consistency_plain(
        ref, conf, src[-1:], r2s[-1:], s2r[-1:], k_ref, k_ref_inv, k_srcs[-1:],
        k_srcs_inv[-1:], **fusion)
    assert not (bits & 2).any() and torch.equal(avg, ref)
    got = chip_smoke.consistency_plain(ref, conf, src, r2s, s2r, k_ref, k_ref_inv,
                                       k_srcs, k_srcs_inv, **fusion)
    assert ((got[1] & 2) > 0).float().mean() > 0.9
    assert chip_smoke.compare_consistency(got, got)[:2] == (1.0, 0.0)


def test_k3_instruction_count():
    """116 FMA-fused f32 instructions per (pixel, source) and 20 per pixel
    with each divide at 7 and the sqrt at 5; 136 and 23 as issued (10 each)."""
    assert chip_smoke.k3_instructions(1, 1, 0) == 20
    assert chip_smoke.k3_instructions(1, 1, 1) - 20 == 116
    assert chip_smoke.k3_instructions(
        2, 3, 4, chip_smoke.K3_DIV_INSTR_ISSUED, chip_smoke.K3_SQRT_INSTR_ISSUED) == 6 * (
        4 * 136 + 23)


def test_k3_timing_script_needs_a_card():
    """Without a CUDA device the A/B timing script exits non-zero and
    prints no timing line."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = os.path.join(root, "itermvs_tpu_torch", "tools", "time_consistency.py")
    out = subprocess.run([sys.executable, script, "--tree", root], capture_output=True,
                         text=True, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and "kernel_ms" not in out.stdout
