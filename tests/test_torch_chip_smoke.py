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
from itermvs_tpu_torch import kernels
from itermvs_tpu_torch.eval import run_depth
from itermvs_tpu_torch.io import read_pfm
from itermvs_tpu_torch.models import Pipeline
from itermvs_tpu_torch.ops.sweep_grad import sweep_grad_src_plain
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


def test_training_plan_is_52_launches_of_each_sweep_kernel_per_step():
    """At 640x512, batch 4, 5 views, 4 iterations, the init sweep's premul
    block (503 MB per view) runs unsplit: 52 forward and 52 backward
    launches per step."""
    shapes = chip_smoke.sweep_shapes(640, 512, 5, 4, 4)
    assert [s[:8] for s in shapes] == [
        ("init", 4, 32, 64, 80, 64, 80, 48),
        ("iter_level1", 4, 4, 128, 160, 256, 320, 16),
        ("iter_level2", 4, 4, 128, 160, 128, 160, 32),
        ("iter_level3", 4, 2, 128, 160, 64, 80, 48)]
    assert [s[-1] for s in shapes] == [4, 16, 16, 16]
    assert all(len(chip_smoke.sample_chunks(*s[1:3], s[3] * s[4], s[7])) == 1 for s in shapes)


def test_train_sample_and_step_on_the_cpu():
    """chip_smoke's in-memory training batch has the loader's layout, and
    its CPU train step (the side the card is held against) runs."""
    sample = chip_smoke.train_sample(160, 128, 3, 2, 0)
    assert sample["imgs"]["level_0"].shape == (2, 3, 128, 160, 3)
    assert sample["proj_matrices"]["level_3"].shape == (2, 3, 4, 4)
    assert sample["depth"]["level_2"].shape == (2, 32, 40, 1)
    assert (sample["mask"]["level_0"] == 1).all()
    _, _, depths = chip_smoke.render_scene(160, 128, 3, 0)
    assert np.array_equal(sample["depth"]["level_0"][1, ..., 0], depths[1])
    loss, grads = chip_smoke.step_gradients("cpu", sample, 2)
    assert np.isfinite(loss) and len(grads) == 100
    assert all(torch.isfinite(g).all() for g in grads.values())
    base = torch.tensor([[0, 3, 4 * 5 - 1, 3 * 5]], dtype=torch.int32)    # 4x5 map
    assert chip_smoke.valid_corners(base, 4, 5).tolist() == [[4, 4, 1, 2]]


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


def test_k4_k5_timing_script_needs_a_card():
    """Without a CUDA device the K4/K5 A/B timing script exits non-zero
    and prints no timing line."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = os.path.join(root, "itermvs_tpu_torch", "tools", "time_sweep_grad.py")
    out = subprocess.run([sys.executable, script, "--tree", root], capture_output=True,
                         text=True, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and "ms_per_step" not in out.stdout
    assert '"ms"' not in out.stdout


def test_k1_k2_timing_script_needs_a_card():
    """Without a CUDA device the K1/K2 A/B timing script exits non-zero
    and prints no timing line."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = os.path.join(root, "itermvs_tpu_torch", "tools", "time_sweep_fwd.py")
    out = subprocess.run([sys.executable, script, "--tree", root], capture_output=True,
                         text=True, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and "no CUDA device" in out.stderr
    assert '"ms"' not in out.stdout and "ms_per_" not in out.stdout


def test_bf16_forward_edge_inputs_plant_their_cases():
    """chip_smoke's bf16 forward edge cases: bases on the last row or
    column, every 5th row below the map and every 5th past it, and block
    sizes that match the kernels' launch shapes."""
    gen = torch.Generator().manual_seed(0)
    h1, w1 = chip_smoke.FWD_EDGE_MAP
    _, base, taps, ref = chip_smoke.fwd_edge_inputs(2, 3, 40, 16, gen, "edges", dev="cpu")
    assert base.dtype == torch.int32 and base.shape == (2, 120) and base.is_contiguous()
    assert taps.dtype == ref.dtype == torch.bfloat16 and taps.shape == (4, 2, 120)
    assert bool(((base // w1 == h1 - 1) | (base % w1 == w1 - 1)).all())
    _, base, _, _ = chip_smoke.fwd_edge_inputs(2, 3, 40, 16, gen, "off_map", dev="cpu")
    off = (base < 0) | (base >= h1 * w1)
    assert off.sum().item() == 2 * 2 * 24 and bool(off[:, ::5].all() & off[:, 1::5].all())
    assert [chip_smoke.bf16_fwd_tiles(c) for c in (8, 16, 32, 48, 256)] == [
        (256, 256), (128, 128), (64, 64), (42, 128), (8, 32)]


def test_grad_cases_plant_their_cases():
    """The harder backward inputs: batch 0 piled on one cell, every base on
    the last row or column, batch 0 in the last 8x8 cells; the rest as
    the sweep has it; and the plain versions agree with float64 there."""
    b, n, h, w, h1, w1, c = 2, 32, 4, 5, 10, 12, 16
    gen = torch.Generator()
    gen.manual_seed(0)
    src0, base0, taps0, ref0 = chip_smoke.sweep_inputs(b, n, h, w, h1, w1, c, gen, "cpu")
    gen.manual_seed(0)
    cases = chip_smoke.grad_cases(b, n, h, w, h1, w1, c, gen, "cpu")
    assert tuple(cases) == chip_smoke.GRAD_CASES
    pile, edges, corner = (cases[k][1] for k in chip_smoke.GRAD_CASES)
    assert all(t.dtype == torch.int32 and t.shape == base0.shape for t in (pile, edges, corner))
    assert (pile[0] == (h1 // 2) * w1 + w1 // 2).all() and torch.equal(pile[1], base0[1])
    y, x = edges // w1, edges % w1
    assert ((y == h1 - 1) | (x == w1 - 1)).all() and (edges >= 0).all()
    assert (y == h1 - 1).any() and (x == w1 - 1).any() and (y < h1 - 1).any()
    y, x = corner[0] // w1, corner[0] % w1
    k = chip_smoke.CORNER_CELLS
    assert (y >= h1 - k).all() and (x >= w1 - k).all() and torch.equal(corner[1], base0[1])
    assert len(torch.unique(corner[0])) <= k * k < h1 * w1
    for src, base, taps, ref, grad in cases.values():
        assert torch.equal(src, src0) and torch.equal(taps, taps0) and torch.equal(ref, ref0)
        assert grad.shape == (b, n, chip_smoke.GROUPS, h * w)
        got = sweep_grad_src_plain(ref, base, taps, grad, h1, w1)
        exact = sweep_grad_src_plain(ref.double(), base, taps.double(), grad.double(), h1, w1)
        assert (got - exact).abs().max() <= 1e-5 * exact.abs().max()


def test_kernel_library_name_follows_its_shared_headers(tmp_path, monkeypatch):
    """A kernel is rebuilt when a header in csrc/ changes, not only its
    own source."""
    monkeypatch.setattr(kernels, "CSRC_DIR", str(tmp_path))
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    first = kernels.library_path("k")
    assert kernels.library_path("k") == first
    (tmp_path / "h.cuh").write_text("// two\n")
    assert kernels.library_path("k") != first


def test_bf16_plans_launch_as_many_kernels():
    """bf16 halves the premul blocks; at these sizes nothing was split in
    f32, so the plans (52 per map and per step) are the same."""
    for args in ((1600, 1152, 5, 4), (640, 512, 5, 4, 4)):
        assert chip_smoke.sweep_shapes(*args, itemsize=2) == chip_smoke.sweep_shapes(*args)


def test_launch_counts_name_all_nine_kernels():
    chip_smoke.reset_launch_counts()
    counts = chip_smoke.launch_counts()
    assert tuple(counts) == chip_smoke.KERNEL_NAMES and len(counts) == 9
    assert counts == chip_smoke.planned_counts()
    assert chip_smoke.planned_counts(sweep_premul_bf16=3)["sweep_premul_bf16"] == 3
    for name in counts:
        assert chip_smoke.kernel_name(name.removesuffix("_bf16"), torch.bfloat16) in (
            name, name + "_bf16")


def test_profile_categories_keep_the_bf16_forms_apart():
    cat = chip_smoke._category
    assert cat("void (anonymous namespace)::sweep_premul_bf16_kernel(uint4 const*)") == \
        "sweep_premul_bf16"
    assert cat("void (anonymous namespace)::sweep_premul_kernel(float4 const*)") == \
        "sweep_premul"
    assert cat("void (anonymous namespace)::round_to_bf16_kernel(float4 const*)") == \
        "sweep_grad_src_bf16"
    assert cat("void (anonymous namespace)::corr_epilogue_bf16_kernel(uint4 const*)") == \
        "corr_epilogue_bf16"


def test_hold_grad_allows_one_bf16_step_and_no_more():
    """bf16 results may differ from their plain version by one bf16 step
    of |plain| plus 1e-5 of max|plain|; f32 results by the 1e-5 alone."""
    want = torch.tensor([1.0, -3.0, 0.5, 200.0]).to(torch.bfloat16)

    def ulps(k):                 # each value k bf16 steps further from 0
        return (want.view(torch.int16) + k).view(torch.bfloat16)

    assert chip_smoke.hold_grad("k", ulps(1), want, "one step")[0] > 0
    with pytest.raises(SystemExit):
        chip_smoke.hold_grad("k", ulps(3), want, "three steps")
    want32 = want.float()
    chip_smoke.hold_grad("k", want32 + 0.9e-5 * 200, want32, "f32 within")
    with pytest.raises(SystemExit):
        chip_smoke.hold_grad("k", want32 + 1.1e-5 * 200, want32, "f32 beyond")


def test_bf16_sweep_inputs_round_the_f32_draws():
    gen = torch.Generator()
    gen.manual_seed(0)
    f32 = chip_smoke.sweep_inputs(2, 3, 4, 5, 6, 7, 16, gen, "cpu")
    gen.manual_seed(0)
    bf16 = chip_smoke.sweep_inputs(2, 3, 4, 5, 6, 7, 16, gen, "cpu", torch.bfloat16)
    assert [t.dtype for t in bf16] == [torch.bfloat16, torch.int32, torch.bfloat16,
                                       torch.bfloat16]
    for a, b in zip(f32, bf16):
        assert torch.equal(a.to(b.dtype), b)


def test_in_memory_samples_through_run_depth_in_bf16(tmp_path):
    """chip_smoke's bf16 depth phase on the CPU: the same scene, weights
    and bar as the f32 run."""
    cams, images, gts = chip_smoke.render_scene(512, 384, 3, 0)
    model = load_npz_weights(Pipeline(iteration=4, dtype=torch.bfloat16), pretrained_path("dtu"))
    run_depth(model, chip_smoke.samples_of(cams, images)[:1], str(tmp_path),
              torch.device("cpu"), log=lambda *_: None)
    depth, _ = read_pfm(os.path.join(tmp_path, "depth_est", "00000000.pfm"))
    assert depth.dtype == np.float32 and depth.shape == (384, 512, 1)
    assert np.median(np.abs(depth[..., 0] - gts[0])) < 0.05


def test_sass_tool_needs_the_cuda_toolkit():
    """Without nvcc the SASS comparison exits non-zero and prints no
    comparison line."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = os.path.join(root, "itermvs_tpu_torch", "tools", "compare_sass.py")
    out = subprocess.run([sys.executable, script, "--tree", root], capture_output=True,
                         text=True, env=dict(os.environ, CUDA_HOME="/nonexistent",
                                             PATH="/usr/bin:/bin"))
    assert out.returncode != 0 and "differing_lines" not in out.stdout
    assert "nvcc" in out.stderr
