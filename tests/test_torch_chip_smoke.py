"""chip_smoke.py's CPU-checkable parts: its scene copy, its launch plan,
and its in-memory samples through the port's eval core loop.

The scene copy must equal tests/synthetic_scene.py exactly (same numpy
arithmetic); the depth check uses the same 0.05 bar as the JAX
package's verify recipe.
"""
import gc
import os
import subprocess
import sys
import tempfile
import weakref

import numpy as np
import pytest
import torch

import chip_smoke
from tests import synthetic_scene
from itermvs_tpu_torch import entry as port_entry
from itermvs_tpu_torch import kernels
from itermvs_tpu_torch.eval import run_depth
from itermvs_tpu_torch.io import read_pfm
from itermvs_tpu_torch.models import Pipeline
from itermvs_tpu_torch.ops.sweep_grad import sweep_grad_src_plain
from itermvs_tpu_torch.weights import load_npz_weights, pretrained_path

BF16 = torch.bfloat16


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k4_k5_timing_script_needs_a_card(dtype):
    """Without a CUDA device the K4/K5 A/B timing script exits non-zero
    and prints no timing line, in either dtype."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = os.path.join(root, "itermvs_tpu_torch", "tools", "time_sweep_grad.py")
    out = subprocess.run([sys.executable, script, "--tree", root, "--dtype", dtype],
                         capture_output=True, text=True,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
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
    """All fifty report names since K6-K29 joined the nine: the
    sweep and fusion kernels, the depth readout forward and backward, the
    sweep taps, the convex upsample forward and backward, the ConvGRU's
    gates forward and backward, the BN epilogue forward and backward, the
    FPN add forward and backward, BN's training statistics forward and
    backward and the model's resizes forward and backward, each but
    fusion_consistency in both dtypes, and the view
    aggregation and the training loss forward and backward, the
    optimizer update's norm and step and the metrics (float32 only)."""
    chip_smoke.reset_launch_counts()
    counts = chip_smoke.launch_counts()
    assert tuple(counts) == chip_smoke.KERNEL_NAMES and len(counts) == 50
    assert {"depth_readout", "depth_readout_grad_bf16", "sweep_taps_bf16", "convex_upsample",
            "convex_upsample_grad_bf16", "view_aggregate", "view_aggregate_grad",
            "gru_reset", "gru_update", "gru_update_grad", "gru_reset_grad", "gru_reset_bf16",
            "gru_update_bf16", "gru_update_grad_bf16", "gru_reset_grad_bf16", "bn_act",
            "bn_act_grad", "bn_act_bf16", "bn_act_grad_bf16", "upsample2x_add",
            "upsample2x_grad", "upsample2x_add_bf16", "upsample2x_grad_bf16", "bn_stats",
            "bn_stats_grad", "bn_stats_bf16", "bn_stats_grad_bf16", "resize_bilinear",
            "resize_bilinear_grad", "resize_bilinear_bf16",
            "resize_bilinear_grad_bf16"} <= set(counts)
    assert {"full_loss", "full_loss_grad", "grad_norm", "clip_adam", "depth_metrics"} <= \
        set(counts)
    assert not {"view_aggregate_bf16", "view_aggregate_grad_bf16", "full_loss_bf16",
                "full_loss_grad_bf16", "grad_norm_bf16", "clip_adam_bf16",
                "depth_metrics_bf16"} & set(counts)
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


def test_profile_categories_name_the_templated_kernels():
    """K6, K7 and K8 are one templated source each: the template argument
    tells the dtype, and K6's name is a prefix of K7's."""
    cat = chip_smoke._category
    assert cat("void (anonymous namespace)::depth_readout_kernel<float>(float const*, "
               "float*, float*, int*, float*, float*, int, long long)") == "depth_readout"
    assert cat("void (anonymous namespace)::depth_readout_kernel<__nv_bfloat16>("
               "__nv_bfloat16 const*, float*)") == "depth_readout_bf16"
    assert cat("void (anonymous namespace)::depth_readout_grad_kernel<float>(float const*)") \
        == "depth_readout_grad"
    assert cat("void (anonymous namespace)::depth_readout_grad_kernel<__nv_bfloat16>("
               "float const*, __nv_bfloat16*)") == "depth_readout_grad_bf16"
    assert cat("void (anonymous namespace)::sweep_taps_kernel<__nv_bfloat16>(float const*, "
               "float const*, int*, __nv_bfloat16*)") == "sweep_taps_bf16"
    assert cat("void (anonymous namespace)::sweep_taps_kernel<float>(float const*)") == \
        "sweep_taps"
    # K6's tile form, K9, and K10's two kernels (the fold named by its form).
    assert cat("void (anonymous namespace)::depth_readout_kernel<__nv_bfloat16, true>("
               "__nv_bfloat16 const*, float*)") == "depth_readout_bf16"
    assert cat("void (anonymous namespace)::depth_readout_kernel<float, false>("
               "float const*)") == "depth_readout"
    assert cat("void (anonymous namespace)::convex_upsample_kernel<float>(float const*, "
               "float const*, float*, int, int, int)") == "convex_upsample"
    assert cat("void (anonymous namespace)::convex_upsample_kernel<__nv_bfloat16>("
               "__nv_bfloat16 const*)") == "convex_upsample_bf16"
    assert cat("void (anonymous namespace)::convex_upsample_grad_kernel<float>("
               "float const*)") == "convex_upsample_grad"
    assert cat("void (anonymous namespace)::convex_upsample_grad_fold_kernel<__nv_bfloat16>("
               "float const*, float*, int, int, int)") == "convex_upsample_grad_bf16"
    # K13-K16: K13's name is a prefix of K16's, K14's of K15's.
    for name in ("gru_reset", "gru_update", "gru_update_grad", "gru_reset_grad"):
        assert cat(f"void (anonymous namespace)::{name}_kernel<float, 4>(float const*, "
                   "float*, long long)") == name
        assert cat(f"void (anonymous namespace)::{name}_kernel<__nv_bfloat16, 1>("
                   "__nv_bfloat16 const*)") == f"{name}_bf16"


def test_map_plan_counts_k6_and_k8_per_prediction_and_sweep():
    shapes = chip_smoke.sweep_shapes(1600, 1152, 5, 4)
    plan = chip_smoke.planned_map_counts(shapes, torch.float32, maps=5)
    assert plan == chip_smoke.planned_counts(sweep_premul=260, corr_epilogue=260,
                                             depth_readout=25, sweep_taps=25,
                                             convex_upsample=5, view_aggregate=65,
                                             gru_reset=20, gru_update=20, bn_act=65,
                                             upsample2x_add=10, resize_bilinear=25)
    plan16 = chip_smoke.planned_map_counts(shapes, torch.bfloat16)
    assert plan16 == chip_smoke.planned_counts(sweep_premul_bf16=52, corr_epilogue_bf16=52,
                                               depth_readout_bf16=5, sweep_taps_bf16=5,
                                               convex_upsample_bf16=1, view_aggregate=13,
                                               gru_reset_bf16=4, gru_update_bf16=4,
                                               bn_act_bf16=13, upsample2x_add_bf16=2,
                                               resize_bilinear=2, resize_bilinear_bf16=3)


def test_readout_logits_plant_their_cases():
    """chip_smoke's K6 inputs, made on the CPU: the argmax at the
    edge bins in row 0, exact ties in row 1, and in row 2 near-ties whose
    exp(l - max) is 1 in float32 though the later bin's logit is larger
    on even columns."""
    for dtype in (torch.float32, torch.bfloat16):
        gen = torch.Generator().manual_seed(0)
        x = chip_smoke.readout_logits(2, 4, 12, gen, dtype, dev="cpu")
        assert x.dtype == dtype and x.shape == (2, 256, 4, 12) and x.is_contiguous()
        p = torch.softmax(x.float(), dim=1)
        idx = p.argmax(dim=1)
        assert idx[:, 0, :10].tolist() == [[0, 1, 2, 3, 4, 251, 252, 253, 254, 255]] * 2
        assert (idx[:, 1, 0::2] == 0).all() and (idx[:, 1, 1::2] == 7).all()
        assert (idx[:, 2] == 30).all()
        xf = x.float()
        assert (xf[:, 40, 2, 0::2] > xf[:, 30, 2, 0::2]).all()
        assert (torch.exp(xf[:, 30, 2] - xf[:, 40, 2]) == 1).all()


def test_upsample_inputs_plant_their_cases():
    """chip_smoke's K9/K10 inputs, made on the CPU: on the border rows and
    columns the taps that clamp there carry almost all of each sub-pixel's
    weight, so the border sub-pixels read the edge-padded neighbours; a
    corner's 16 are the corner's own value."""
    from itermvs_tpu_torch.ops.upsample import convex_upsample_plain

    for dtype in (torch.float32, torch.bfloat16):
        gen = torch.Generator().manual_seed(0)
        x, logits = chip_smoke.upsample_inputs(2, 3, 5, gen, dtype, dev="cpu")
        assert x.shape == (2, 1, 3, 5) and ((x >= 0) & (x < 1)).all()
        assert logits.dtype == dtype and logits.shape == (2, 144, 3, 5)
        assert logits.is_contiguous()
        w = torch.softmax(logits.float().reshape(2, 9, 16, 3, 5), dim=1)
        assert (w[:, 0:3, :, 0].sum(dim=1) > 0.999).all()        # row 0: dy = -1
        assert (w[:, 6:9, :, -1].sum(dim=1) > 0.999).all()       # last row: dy = +1
        assert (w[:, 0::3, :, :, 0].sum(dim=1) > 0.999).all()    # column 0: dx = -1
        assert (w[:, 2::3, :, :, -1].sum(dim=1) > 0.999).all()   # last column: dx = +1
        up = convex_upsample_plain(x, logits)
        assert torch.allclose(up[:, 0, :4, :4], x[:, :, 0, 0, None], atol=1e-6)
        assert torch.allclose(up[:, 0, -4:, -4:], x[:, :, -1, -1, None], atol=1e-6)


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


def test_ddp_sample_keeps_another_share_in_each_sample():
    """chip_smoke's data-parallel batch: 4 distinct references whose masks
    keep 100/87.5/75/62.5% of the rows at every level, each level the
    loader's every 2^l-th pixel of level 0; a batch needs as many views."""
    sample = chip_smoke.ddp_sample(160, 128, 5, 4, 0)
    m0 = sample["mask"]["level_0"]
    assert m0.shape == (4, 128, 160, 1)
    assert (m0.mean(axis=(1, 2, 3)) == [1.0, 0.875, 0.75, 0.625]).all()
    for l in range(1, 4):
        assert np.array_equal(sample["mask"][f"level_{l}"], m0[:, ::2 ** l, ::2 ** l])
    imgs = sample["imgs"]["level_0"]
    assert not any(np.array_equal(imgs[i, 0], imgs[j, 0]) for i in range(4) for j in range(i))
    with pytest.raises(ValueError, match="needs 4 views"):
        chip_smoke.train_sample(160, 128, 3, 4, 0)


def test_ddp_plan_is_52_launches_per_rank_per_step():
    """52 of each sweep kernel, 5 (one per prediction, one per sweep)
    of K6, K7 and K8, one of K9 and K10, 13 (one per aggregation) of
    K11 and K12, float32 in both precisions, 4 (one per GRU call) of
    K13-K16, 13 (one per BN epilogue) of K17, K18 and K22, 16 (one per
    BN) of K21, 2 (one per FPN add) of K19 and K20, one of K23, K24,
    K25, K26 and K27, float32 in both precisions, and 6 of K28 and 4 of
    K29 (one per resize, the gradient's where it flows; 3 and 1 of them
    float32 in both precisions) per rank per step."""
    for dtype in (torch.float32, torch.bfloat16):
        shapes = chip_smoke.sweep_shapes(640, 512, 5, 4, 2, itemsize=dtype.itemsize)
        plan = chip_smoke.planned_step_counts(shapes, dtype)
        names = [chip_smoke.kernel_name(k, dtype) for k in
                 ("sweep_premul", "corr_epilogue", "sweep_grad_ref", "sweep_grad_src")]
        heads = [chip_smoke.kernel_name(k, dtype) for k in
                 ("depth_readout", "depth_readout_grad", "sweep_taps")]
        upsample = [chip_smoke.kernel_name(k, dtype) for k in
                    ("convex_upsample", "convex_upsample_grad")]
        gru = [chip_smoke.kernel_name(k, dtype) for k in
               ("gru_reset", "gru_update", "gru_update_grad", "gru_reset_grad")]
        bn = [chip_smoke.kernel_name(k, dtype) for k in ("bn_act", "bn_act_grad")]
        fpn = [chip_smoke.kernel_name(k, dtype) for k in ("upsample2x_add", "upsample2x_grad")]
        resize = ({"resize_bilinear": 6, "resize_bilinear_grad": 4} if dtype == torch.float32
                  else {"resize_bilinear": 3, "resize_bilinear_bf16": 3,
                        "resize_bilinear_grad": 1, "resize_bilinear_grad_bf16": 3})
        assert plan == chip_smoke.planned_counts(**{k: 52 for k in names},
                                                 **{k: 5 for k in heads},
                                                 **{k: 1 for k in upsample},
                                                 **{k: 4 for k in gru},
                                                 **{k: 13 for k in bn},
                                                 **{k: 2 for k in fpn},
                                                 **{chip_smoke.kernel_name("bn_stats", dtype): 16,
                                                    chip_smoke.kernel_name("bn_stats_grad",
                                                                           dtype): 13},
                                                 view_aggregate=13, view_aggregate_grad=13,
                                                 full_loss=1, full_loss_grad=1, grad_norm=1,
                                                 clip_adam=1, depth_metrics=1, **resize)


def _record(loss, value, launches=None, copies=0, loss_copies=0, metric_all_reduces=1):
    """One step's record as `run_steps` writes it (in a process group)."""
    state = {"w": torch.full((3,), value), "bn.running_mean": torch.ones(2)}
    return {"loss": loss, "ms": 1.0, "launches": launches or chip_smoke.planned_counts(),
            "copies": copies, "loss_copies": loss_copies,
            "metric_all_reduces": metric_all_reduces, "state": state,
            "grads": {"w": torch.ones(3)}}


def test_hold_ddp_gates():
    single = {"runs": [[_record(10.0, 1.0)]]}
    ranks = [{"runs": [[_record(10.0, 1.0)]]} for _ in range(2)]
    rec = chip_smoke.hold_ddp("t", ranks, single, chip_smoke.planned_counts())
    assert rec["ranks_bit_equal"] and rec["loss_rel"] == 0 == rec["params_rel_l2"]
    for bad in ([_record(10.01, 1.0)], [_record(10.0, 1.01)]):
        with pytest.raises(SystemExit, match="disagrees with one process"):
            chip_smoke.hold_ddp("t", [{"runs": [bad]}] * 2, single,
                                chip_smoke.planned_counts())
    ranks[1] = {"runs": [[_record(10.0, 1.0 + 1e-7)]]}
    with pytest.raises(SystemExit, match="ranks' parameters"):
        chip_smoke.hold_ddp("t", ranks, single, chip_smoke.planned_counts())
    with pytest.raises(SystemExit, match="launches per rank"):
        chip_smoke.hold_ddp("t", [single, single], single,
                            chip_smoke.planned_counts(sweep_premul=52))
    copied = {"runs": [[_record(10.0, 1.0, copies=1)]]}
    with pytest.raises(SystemExit, match="copied the probability's gradient"):
        chip_smoke.hold_ddp("t", [copied, copied], single, chip_smoke.planned_counts())
    per_metric = {"runs": [[_record(10.0, 1.0, metric_all_reduces=15)]]}
    with pytest.raises(SystemExit, match="the metrics' all-reduces per rank per step != 1"):
        chip_smoke.hold_ddp("t", [per_metric, per_metric], single, chip_smoke.planned_counts())


def test_world_one_group_comes_and_goes(monkeypatch):
    """chip_smoke's in-process group (the NCCL phase's, here over gloo):
    joined inside, gone after, torchrun's variables as they were."""
    from itermvs_tpu_torch.parallel import mesh

    monkeypatch.setenv("MASTER_ADDR", "before")
    monkeypatch.delenv("RANK", raising=False)
    with chip_smoke.process_group("gloo", "cpu"):
        assert mesh.is_initialized() and mesh.world_size() == 1
        assert os.environ["MASTER_ADDR"] == "127.0.0.1"
    assert not mesh.is_initialized()
    assert os.environ["MASTER_ADDR"] == "before" and "RANK" not in os.environ


def test_a_failing_rank_stops_the_run():
    job = {"dtype": "no_such_dtype"}
    with pytest.raises(SystemExit, match=r"gloo rank \d of 2 failed"):
        chip_smoke.run_ranks(job, 2, "gloo", "cpu", timeout=300,
                             env=dict(os.environ, OMP_NUM_THREADS="1"))


def test_debug_nans_phase_on_the_cpu(tmp_path):
    """chip_smoke's --debug_nans phase at 512x384: clean on the plane
    scene's first map, and the image with one NaN pixel is caught."""
    cams, images, gts = chip_smoke.render_scene(512, 384, 3, 0)
    sample = chip_smoke.samples_of(cams, images)[0]
    bad = chip_smoke.nan_image(sample)
    assert np.isnan(bad["imgs"]["level_0"]).sum() == 1
    assert not np.isnan(sample["imgs"]["level_0"]).any()
    model = load_npz_weights(Pipeline(iteration=4), pretrained_path("dtu"))
    counts, rec = chip_smoke.debug_nans_phase(model, sample, gts[0], str(tmp_path), "cpu")
    assert counts == chip_smoke.planned_counts()          # CPU: the plain versions
    assert rec["clean_median_abs_err"] < 0.05
    assert rec["nan_raised"].startswith("NaN in the output of module feature_net.")


def test_hold_ddp_outside_strict_gates_the_statistics_only():
    """bf16 (`strict=False`): loss and parameters printed, not gated; the
    BN statistics and finite losses still gated."""
    single = {"runs": [[_record(10.0, 1.0)]]}
    off = {"runs": [[_record(11.0, 1.1)]]}
    assert not chip_smoke.hold_ddp("t", [off], single, chip_smoke.planned_counts(),
                                   strict=False)["strict"]
    stats = _record(10.0, 1.0)
    stats["state"]["bn.running_mean"] = torch.full((2,), 1.001)
    with pytest.raises(SystemExit, match="BN statistics or losses off"):
        chip_smoke.hold_ddp("t", [{"runs": [[stats]]}], single, chip_smoke.planned_counts(),
                            strict=False)
    with pytest.raises(SystemExit, match="BN statistics or losses off"):
        chip_smoke.hold_ddp("t", [{"runs": [[_record(float("nan"), 1.0)]]}], single,
                            chip_smoke.planned_counts(), strict=False)


def test_perturbed_job_scales_the_weights_only():
    state = {"w": torch.ones(1000), "n": torch.tensor(3)}
    got = chip_smoke.perturbed_job({"state": state, "x": 1}, 0)
    assert got["x"] == 1 and torch.equal(got["state"]["n"], state["n"])
    rel = got["state"]["w"] - 1
    assert 0 < rel.abs().max() < 1e-6 and 0.5e-7 < rel.std() < 2e-7


def _window_loop(base, taps, b, n, hw, pt, h1, w1):
    """Window cells per block, one row at a time."""
    out = []
    for bb in range(b):
        for p0 in range(0, hw, pt):
            ys, xs = [], []
            for s in range(n):
                for p in range(p0, min(p0 + pt, hw)):
                    row = s * hw + p
                    idx = int(base[bb, row])
                    if not 0 <= idx < h1 * w1:
                        continue
                    if taps is not None and not any(float(taps[k, bb, row]) != 0
                                                    for k in range(4)):
                        continue
                    ys.append(idx // w1)
                    xs.append(idx % w1)
            if not ys:
                out.append(0)
                continue
            h = min(max(ys) + 1, h1 - 1) - min(ys) + 1
            w = min(max(xs) + 1, w1 - 1) - min(xs) + 1
            out.append(h * w)
    return out


@pytest.mark.parametrize("with_taps", [False, True])
def test_block_windows_match_a_loop(with_taps):
    """chip_smoke.block_windows, the plain mirror of the kernels' window,
    agrees with a loop over rows: clustered and scattered bases, bases
    off the map, taps all zero on some rows, a ragged last block."""
    gen = torch.Generator().manual_seed(5)
    b, n, hw, pt, h1, w1 = 3, 5, 37, 8, 9, 11
    base = torch.randint(-3, h1 * w1 + 3, (b, n * hw), generator=gen).to(torch.int32)
    base[1] = (4 * w1 + 5 + torch.randint(0, 3, (n * hw,), generator=gen)).to(torch.int32)
    base[2, :hw] = h1 * w1 - 1                    # the last cell: both +1 corners clipped
    taps = torch.rand(4, b, n * hw, generator=gen)
    taps[:, torch.rand(b, n * hw, generator=gen) < 0.3] = 0
    taps[0, 0, 3] = float("nan")                  # a NaN tap adds
    taps = taps if with_taps else None
    got = chip_smoke.block_windows(base, b, n, hw, pt, h1, w1, taps)
    assert got.tolist() == _window_loop(base, taps, b, n, hw, pt, h1, w1)
    assert got.shape == (b * 5,) and 0 < got.max() <= h1 * w1


def test_record_pixels_follow_the_kernels_block_shape():
    """chip_smoke's copy of the backward kernels' block width (RecordTiles
    and RowTiles): 32 pixels where 32 fit in 256 threads of C/lane lanes,
    else 16."""
    assert [chip_smoke.record_pixels(c, 4) for c in (16, 32, 48)] == [32, 32, 16]
    assert [chip_smoke.record_pixels(c, 8) for c in (16, 32, 48)] == [32, 32, 32]
    assert set(chip_smoke.WINDOW_LANES) == {"sweep_grad_ref_bf16", "sweep_grad_src_bf16"}


@pytest.mark.parametrize("shape", [0, 1])
def test_grad_cases_span_small_and_large_windows(shape):
    """At the training step's init and level-1 shapes, pile_up and
    one_corner keep every block of batch 0 within a 32 KB source window
    for both bf16 backward kernels and edges none; the sweep's own inputs
    fit as well, but for K4's blocks that straddle two reference rows at
    init."""
    name, b, n, h, w, h1, w1, c, _ = chip_smoke.sweep_shapes(640, 512, 5, 4, 4)[shape]
    gen = torch.Generator().manual_seed(0)
    cases = chip_smoke.grad_cases(b, n, h, w, h1, w1, c, gen, "cpu", torch.bfloat16)
    want = {"pile_up": 1.0, "one_corner": 1.0, "edges": 0.0}
    for case, (_, base, taps, _, _) in cases.items():
        shares = chip_smoke.window_fit_shares(base[:1], taps[:, :1], 1, n, h * w, h1, w1, c)
        assert set(shares) == set(chip_smoke.WINDOW_LANES)
        assert all(v == want[case] for v in shares.values()), (name, case, shares)
    _, base, taps, _ = chip_smoke.sweep_inputs(b, n, h, w, h1, w1, c, gen, "cpu",
                                               torch.bfloat16)
    shares = chip_smoke.window_fit_shares(base, taps, b, n, h * w, h1, w1, c)
    assert shares["sweep_grad_src_bf16"] == 1.0 and shares["sweep_grad_ref_bf16"] > 0.75


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_capture_sweeps_returns_one_tuple_per_sweep(dtype):
    """chip_smoke.capture_sweeps on the small training step: one (src,
    ref, base, taps, grad_corr) per sweep, as many of each shape as
    sweep_shapes plans, in the kernels' dtypes; SweepCorr is restored."""
    from itermvs_tpu_torch.engine.train_loop import init_weights, to_device_batch
    from itermvs_tpu_torch.models import itermvs
    from itermvs_tpu_torch.ops.sweep_grad import SweepCorr
    cfg = chip_smoke.SMALL_TRAIN
    sample = chip_smoke.train_sample(cfg["width"], cfg["height"], cfg["views"],
                                     cfg["batch"], 0)
    model = init_weights(Pipeline(iteration=cfg["iteration"], test=False, dtype=dtype), 0)
    caps = chip_smoke.capture_sweeps(model, to_device_batch(sample, "cpu"),
                                     cfg["iteration"])
    assert itermvs.SweepCorr is SweepCorr
    assert all(p.grad is None for p in model.parameters())
    shapes = chip_smoke.sweep_shapes(cfg["width"], cfg["height"], cfg["views"],
                                     cfg["iteration"], cfg["batch"],
                                     itemsize=torch.tensor([], dtype=dtype).element_size())
    planned = chip_smoke.sweeps_of(shapes, dtype)
    assert len(caps) == sum(planned.values()) == 14
    for name, b, n, h, w, h1, w1, c, _ in shapes:
        mine = [t for t in caps if tuple(t[4].shape) == (b, n, chip_smoke.GROUPS, h * w)
                and tuple(t[0].shape) == (b, h1, w1, c)]
        assert len(mine) == planned[name], name
        for src, ref, base, taps, grad in mine:
            assert ref.shape == (b, h * w, c) and base.shape == (b, n * h * w)
            assert taps.shape == (4, b, n * h * w)
            assert src.dtype == ref.dtype == taps.dtype == dtype
            assert base.dtype == torch.int32 and grad.dtype == torch.float32
            assert all(t.is_contiguous() for t in (src, ref, base, taps, grad))
            assert bool(torch.isfinite(grad).all()) and bool(grad.abs().sum() > 0)
    # The captures go with the returned list, without waiting for the
    # garbage collector (else they count in the next phase's peak memory).
    gc.disable()
    try:
        kept = weakref.ref(caps[0][4])
        del caps, mine, src, ref, base, taps, grad
        assert kept() is None
    finally:
        gc.enable()


def test_uint8_samples_normalise_to_the_float32_samples_plane():
    """chip_smoke's `input_uint8` samples: raw level_0 planes that
    Pipeline._normalize turns into the float32 samples' planes bit for
    bit, at a quarter of their host→device bytes."""
    cams, images, _ = chip_smoke.render_scene(64, 48, 3, 0)
    f32 = chip_smoke.samples_of(cams, images)
    u8 = chip_smoke.samples_of(cams, images, uint8=True)
    for a, b in zip(f32, u8):
        assert b["imgs"]["level_0"].dtype == np.uint8
        got = Pipeline._normalize(torch.from_numpy(b["imgs"]["level_0"]))
        assert np.array_equal(got.numpy(), a["imgs"]["level_0"])
        assert all(np.array_equal(a["proj_matrices"][k], b["proj_matrices"][k])
                   for k in a["proj_matrices"])
    image = 64 * 48 * 3
    other = sum(v.nbytes for k, v in f32[0]["proj_matrices"].items() if k != "level_0") + 8
    assert chip_smoke.h2d_bytes_per_map(f32) == image * 4 + other      # 3 views, 3 maps
    assert chip_smoke.h2d_bytes_per_map(u8) == image + other
    assert chip_smoke.h2d_bytes_per_map(u8, feature_cache=False) == 3 * image + other


def test_pfm_diff_counts_a_planted_difference(tmp_path):
    from itermvs_tpu_torch.io import save_pfm

    rng = np.random.RandomState(0)
    for run in ("a", "b"):
        for kind in ("depth_est", "confidence"):
            os.makedirs(tmp_path / run / kind)
    for v in range(2):
        depth, conf = rng.rand(6, 5).astype(np.float32), rng.rand(6, 5).astype(np.float32)
        for run in ("a", "b"):
            if run == "b" and v == 1:
                depth[2, 3] += 0.25
                conf[0, 0] += 0.5
                conf[2, 3] += 0.125
            save_pfm(str(tmp_path / run / "depth_est" / f"{v:08d}.pfm"), depth)
            save_pfm(str(tmp_path / run / "confidence" / f"{v:08d}.pfm"), conf)
    same, planted = chip_smoke.pfm_diff(str(tmp_path / "b"), str(tmp_path / "a"), 2)
    assert same == {"view": 0, "max_abs_ddepth": 0.0, "max_abs_dconfidence": 0.0,
                    "differing_pixels": 0}
    assert planted["differing_pixels"] == 2
    assert planted["max_abs_ddepth"] == pytest.approx(0.25, abs=1e-6)
    assert planted["max_abs_dconfidence"] == pytest.approx(0.5, abs=1e-6)


class _Event:
    """The fields of a torch.profiler event that chip_smoke reads."""

    class _Range:
        def __init__(self, start, end):
            self.start, self.end = start, end

        def elapsed_us(self):
            return self.end - self.start

    def __init__(self, name, start, end, device="cuda", annotation=False):
        from torch.autograd import DeviceType

        self.name, self.is_user_annotation = name, annotation
        self.device_type = DeviceType.CUDA if device == "cuda" else DeviceType.CPU
        self.time_range = self._Range(start, end)


def test_chain_time_takes_the_kernels_inside_each_labelled_range():
    """Kernels inside a label's device-side span count for it; the spans
    themselves (and the host-side ranges) are no device work."""
    events = [
        _Event("fused_sweep_taps", 0, 50, "cpu", annotation=True),
        _Event("depth_readout", 0, 50, "cpu", annotation=True),
        _Event("fused_sweep_taps", 10, 30),                # device span
        _Event("elementwise_a", 10, 20), _Event("elementwise_b", 22, 30),
        _Event("Memcpy HtoD (Pinned -> Device)", 12, 13),
        _Event("conv_xmma", 31, 60),
        _Event("depth_readout", 61, 70), _Event("softmax", 61, 70),
        _Event("depth_readout", 80, 90), _Event("softmax", 80, 85),
    ]
    chains = chip_smoke.chain_time(events)
    assert chains == {"depth_readout": {"device_ms": 0.014, "launches": 2},
                      "fused_sweep_taps": {"device_ms": 0.018, "launches": 2},
                      "convex_upsample": {"device_ms": 0.0, "launches": 0},
                      "view_aggregate": {"device_ms": 0.0, "launches": 0},
                      "conv_gru": {"device_ms": 0.0, "launches": 0},
                      "bn_act": {"device_ms": 0.0, "launches": 0},
                      "fpn_add": {"device_ms": 0.0, "launches": 0},
                      "bn_stats": {"device_ms": 0.0, "launches": 0},
                      "full_loss": {"device_ms": 0.0, "launches": 0},
                      "clip_adam": {"device_ms": 0.0, "launches": 0},
                      "depth_metrics": {"device_ms": 0.0, "launches": 0},
                      "resize": {"device_ms": 0.0, "launches": 0}}
    by_name, by_cat, busy = chip_smoke.device_summary(events)
    assert "fused_sweep_taps" not in by_name and "depth_readout" not in by_name
    assert busy == pytest.approx((10 + 8 + 1 + 29 + 9 + 5) / 1e3)
    assert by_cat["convolution"] == 29 and by_cat["memcpy"] == 1


def test_chain_bounds_count_each_input_and_output_once():
    bounds = chip_smoke.chain_bound_ms(1600, 1152, 5, 4)
    p4 = 288 * 400
    assert bounds["depth_readout"] == pytest.approx(
        1e3 * 5 * p4 * (256 * 4 + 4) / chip_smoke.PEAK_BYTES_PER_S)
    assert bounds["convex_upsample"] == pytest.approx(
        1e3 * p4 * (144 * 4 + 4 + 16 * 4) / chip_smoke.PEAK_BYTES_PER_S)
    train = chip_smoke.chain_bound_ms(640, 512, 5, 4, 4, itemsize=2, train=True)
    assert train["depth_readout"] == pytest.approx(
        1e3 * 5 * 4 * 128 * 160 * (256 * 2 + 4 + 256 * 4) / chip_smoke.PEAK_BYTES_PER_S)
    # conv_gru: K13 reads r_l (32 channels) and hx (43), writes rh_x (43);
    # K14 reads z_l, q_l, h and writes h' (32 each); 4 calls.
    assert bounds["conv_gru"] == pytest.approx(
        1e3 * 4 * p4 * 4 * (32 + 43 + 43 + 4 * 32) / chip_smoke.PEAK_BYTES_PER_S)
    assert train["conv_gru"] == pytest.approx(
        1e3 * 4 * 4 * 128 * 160 * 2 * (32 + 43 + 43 + 4 * 32) / chip_smoke.PEAK_BYTES_PER_S)


def test_bn_stats_work_reads_y_once():
    """K21's bound counts one read of y and the two vectors it writes
    (its mean and variance need one pass); K22's reads ∂y and y and
    writes ∂y per BN. Over a training step's 20 images at 640x512 K21
    reads 273.6 M elements, and the `bn_stats` chain's bound is theirs."""
    n, c, p = 3, 5, 7 * 9
    e = n * c * p
    assert chip_smoke.bn_stats_work(n, c, p, 4) == (4 * e + 8 * c, 4 * e)
    assert chip_smoke.bn_stats_work(n, c, p, 2, grad=True, bns=2) == (
        2 * (3 * 2 * e + 12 * c), 2 * 4 * e)
    elements = 20 * sum(ch * (512 // s) * (640 // s) for ch, s in chip_smoke.BN_INPUTS)
    assert elements == 273_612_800
    step = chip_smoke.chain_bound_ms(640, 512, 5, 4, 4, train=True)["bn_stats"]
    assert step == pytest.approx(1e3 * (4 * elements + 20 * 8 * sum(
        ch for ch, _ in chip_smoke.BN_INPUTS)) / chip_smoke.PEAK_BYTES_PER_S)
    assert chip_smoke.chain_bound_ms(1600, 1152, 5, 4)["bn_stats"] == 0


def test_gru_plans_launch_k13_to_k16_once_per_gru_call():
    """The GRU runs once per iteration: K13 and K14 4 times per map (also
    under entry(), 128x160), K13-K16 4 times per training step and twice
    per step of the dry run (2 iterations), in the kernels of the step's
    dtype."""
    gru = ("gru_reset", "gru_update", "gru_update_grad", "gru_reset_grad")
    for dtype in (torch.float32, torch.bfloat16):
        names = [chip_smoke.kernel_name(k, dtype) for k in gru]
        for size in ((1600, 1152), (160, 128)):
            plan = chip_smoke.planned_map_counts(chip_smoke.sweep_shapes(*size, 5, 4), dtype)
            assert [plan[k] for k in names] == [4, 4, 0, 0]
        plan = chip_smoke.planned_step_counts(
            chip_smoke.sweep_shapes(640, 512, 5, 4, 4, itemsize=dtype.itemsize), dtype)
        assert [plan[k] for k in names] == [4, 4, 4, 4]
        other = [chip_smoke.kernel_name(k, torch.float32 if dtype != torch.float32 else BF16)
                 for k in gru]
        assert [plan[k] for k in other] == [0, 0, 0, 0]
    plan = chip_smoke.planned_step_counts(chip_smoke.sweep_shapes(
        port_entry.DRYRUN_WIDTH, port_entry.DRYRUN_HEIGHT, port_entry.DRYRUN_VIEWS,
        port_entry.DRYRUN_ITERATION), torch.float32, iteration=port_entry.DRYRUN_ITERATION)
    assert port_entry.DRYRUN_ITERATION == 2 and [plan[k] for k in gru] == [2, 2, 2, 2]


def test_readout_timing_script_needs_a_card():
    """Without a CUDA device the K6 A/B timing script exits non-zero and
    prints no timing line."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = os.path.join(root, "itermvs_tpu_torch", "tools", "time_readout.py")
    out = subprocess.run([sys.executable, script, "--tree", root], capture_output=True,
                         text=True, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and "no CUDA device" in out.stderr
    assert "versions" not in out.stdout


def test_eval_timing_script_needs_a_card():
    """Without a CUDA device the eval A/B timing script exits non-zero
    and prints no timing line."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = os.path.join(root, "itermvs_tpu_torch", "tools", "time_eval.py")
    out = subprocess.run([sys.executable, script, "--tree", root], capture_output=True,
                         text=True, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and "no CUDA device" in out.stderr
    assert "maps_per_s" not in out.stdout


def test_k8_timing_script_needs_a_card():
    """Without a CUDA device the K8 A/B timing script exits non-zero and
    prints no timing line."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = os.path.join(root, "itermvs_tpu_torch", "tools", "time_sweep_taps.py")
    out = subprocess.run([sys.executable, script, "--tree", root], capture_output=True,
                         text=True, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and "no CUDA device" in out.stderr
    assert "versions" not in out.stdout and "sass_instructions" not in out.stdout


def test_launch_count_reset_clears_k7_copies():
    """The training phases gate `depth_readout_grad.copies` at 0 from
    each reset on."""
    chip_smoke.depth_readout_grad.copies = 3
    chip_smoke.reset_launch_counts()
    assert chip_smoke.depth_readout_grad.copies == 0


def test_upsample_timing_script_needs_a_card():
    """Without a CUDA device the K9/K10 A/B timing script exits non-zero
    and prints no timing line."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = os.path.join(root, "itermvs_tpu_torch", "tools", "time_upsample.py")
    out = subprocess.run([sys.executable, script, "--tree", root], capture_output=True,
                         text=True, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and "no CUDA device" in out.stderr
    assert "versions" not in out.stdout and "sass_instructions" not in out.stdout


def test_view_aggregate_timing_script_needs_a_card():
    """Without a CUDA device the K11/K12 A/B timing script exits non-zero
    and prints no timing line."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = os.path.join(root, "itermvs_tpu_torch", "tools", "time_view_aggregate.py")
    out = subprocess.run([sys.executable, script, "--tree", root], capture_output=True,
                         text=True, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and "no CUDA device" in out.stderr
    assert "versions" not in out.stdout and "totals" not in out.stdout


def test_feature_net_timing_script_needs_a_card():
    """Without a CUDA device FeatureNet's host and device A/B timing
    script exits non-zero and prints no timing line."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = os.path.join(root, "itermvs_tpu_torch", "tools", "time_feature_net.py")
    out = subprocess.run([sys.executable, script, "--tree", root], capture_output=True,
                         text=True, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and "no CUDA device" in out.stderr
    assert "enqueue_ms" not in out.stdout and "summary" not in out.stdout


def test_upsample_work_counts_each_input_and_output_once():
    """K9: 144 logits, the pixel's depth and its 16 sub-pixels; K10: the
    logits read and their gradient written, g's 16 values, the depth and
    its gradient. The edge shapes hold both of the kernels' paths: odd
    widths, and even widths crossing a block's 32 pairs and of one
    pair."""
    assert chip_smoke.upsample_work(1, 288, 400, torch.bfloat16, grad=False) == (
        288 * 400 * (144 * 2 + 4 + 64), 62 * 16 * 288 * 400)
    assert chip_smoke.upsample_work(4, 128, 160, torch.float32, grad=True) == (
        4 * 128 * 160 * (2 * 144 * 4 + 72), 98 * 16 * 4 * 128 * 160)
    widths = {w for _, _, w in chip_smoke.UPSAMPLE_EDGE_SHAPES}
    assert any(w % 2 for w in widths) and 2 in widths
    assert any(w % 2 == 0 and w // 2 > 32 for w in widths)


def test_ptxas_registers_are_read_per_kernel(tmp_path):
    from itermvs_tpu_torch.tools import other_tree

    log = tmp_path / "lib.so.log"
    log.write_text(
        "ptxas info    : Compiling entry function '_Z1av' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z1av\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 40 registers, used 1 barriers, 9216 bytes smem\n"
        "ptxas info    : Compiling entry function '_Z1bv' for 'sm_90a'\n"
        "ptxas info    : Used 26 registers, used 0 barriers\n")
    assert other_tree.registers(str(tmp_path / "lib.so")) == {"_Z1av": 40, "_Z1bv": 26}


def test_rank_batches_slice_the_padded_global_batches():
    """eval_ddp_2rank's rows: the 5 maps at batch 2 make global batches
    [0, 1], [2, 3], [4, 4]; rank 0 gets 0, 2, 4 and rank 1 gets 1, 3 and
    the padded 4, which it does not write. Side by side, the ranks' rows
    are the padded global batch that one rank gets at world 1."""
    cams, images, _ = chip_smoke.render_scene(64, 48, 5, 0)
    samples = chip_smoke.samples_of(cams, images)
    ranks = [chip_smoke.rank_batches(samples, 2, r, 2) for r in range(2)]
    whole = chip_smoke.rank_batches(samples, 2, 0, 1)
    assert [n for _, n in whole] == [2, 2, 1]
    assert [[n for _, n in b] for b in ranks] == [[1, 1, 1], [1, 1, 0]]
    assert [chip_smoke.real_views(5, 2, r, 2) for r in range(2)] == [[0, 2, 4], [1, 3]]
    assert chip_smoke.real_views(5, 2, 0, 1) == [0, 1, 2, 3, 4]
    for (a, _), (b, _), (g, _) in zip(*ranks, whole):
        assert a["imgs"]["level_0"].shape == (1, 5, 48, 64, 3)
        assert a["filename"] + b["filename"] == g["filename"]
        assert a["scan"] + b["scan"] == g["scan"]
        for key in ("depth_min", "depth_max", "view_ids"):
            assert np.array_equal(np.concatenate([a[key], b[key]]), g[key])
        for group in ("imgs", "proj_matrices"):
            for k in g[group]:
                assert np.array_equal(np.concatenate([a[group][k], b[group][k]]), g[group][k])
    last = whole[-1][0]
    assert last["filename"] == [samples[4]["filename"][0]] * 2
    assert np.array_equal(last["imgs"]["level_0"][1], samples[4]["imgs"]["level_0"][0])


def test_merge_rank_outputs_links_each_map_once(tmp_path):
    """Each rank's maps are linked into one directory; a map that two
    ranks wrote, or a depth map without its confidence, raises."""
    from itermvs_tpu_torch.io import save_pfm

    def write(root, rank, views, kinds=("depth_est", "confidence")):
        for kind in kinds:
            os.makedirs(root / f"rank{rank}" / kind, exist_ok=True)
            for v in views:
                save_pfm(str(root / f"rank{rank}" / kind / f"{v:08d}.pfm"),
                         np.full((2, 3), v, np.float32))

    write(tmp_path / "ok", 0, [0, 2, 4])
    write(tmp_path / "ok", 1, [1, 3])
    assert chip_smoke.merge_rank_outputs(str(tmp_path / "ok"), 3) == {
        0: [0, 2, 4], 1: [1, 3], 2: []}
    for v in range(5):
        depth, _ = read_pfm(str(tmp_path / "ok" / "all" / "depth_est" / f"{v:08d}.pfm"))
        assert (depth == v).all()
    write(tmp_path / "twice", 0, [0, 2, 4])
    write(tmp_path / "twice", 1, [1, 3, 4])
    with pytest.raises(SystemExit, match="00000004.pfm written by two ranks"):
        chip_smoke.merge_rank_outputs(str(tmp_path / "twice"), 2)
    write(tmp_path / "half", 0, [0])
    write(tmp_path / "half", 0, [1], kinds=("depth_est",))
    with pytest.raises(SystemExit, match=r"rank 0 wrote depth maps \[0, 1\] but confidence"):
        chip_smoke.merge_rank_outputs(str(tmp_path / "half"), 1)


def test_eval_rank_on_two_cpu_ranks():
    """eval_ddp_2rank's ranks on the CPU over gloo (3 maps at 128x96,
    iteration 1, batch 2): each rank runs every EVAL_DDP_RUNS form on its
    rows, rank 0 alone merges (each rank wrote its real views only) and
    fuses after the barrier."""
    with tempfile.TemporaryDirectory() as tmp:
        job = {"width": 128, "height": 96, "views": 3, "seed": 0, "iteration": 1,
               "batch": 2, "out": tmp}
        ranks = chip_smoke.run_ranks(job, 2, "gloo", "cpu", timeout=300,
                                     env=dict(os.environ, OMP_NUM_THREADS="2"),
                                     work="eval_rank")
    assert [r["rows"] for r in ranks] == [[1, 1], [1, 1]]
    assert [r["n_real"] for r in ranks] == [[1, 1], [1, 0]]
    assert ranks[1]["rank0"] is None
    rank0 = ranks[0]["rank0"]
    assert rank0["written"] == {f"{d}_{w}": {0: [0, 2], 1: [1]}
                                for d, w in chip_smoke.EVAL_DDP_RUNS}
    assert rank0["fused"]["views"] == 3 and rank0["fused"]["points"] >= 0
    for r in ranks:        # CPU: the plain versions, no kernel launched
        assert set(r["launches"]) == {f"{d}_{w}" for d, w in chip_smoke.EVAL_DDP_RUNS}
        assert all(c == chip_smoke.planned_counts() for c in r["launches"].values())


def test_entry_plan_is_52_per_call_at_128x160():
    """entry()'s forward (128x160, 5 views, 4 iterations): 52 launches of
    K1 and K2, 5 of K6 and K8, one of K9, 13 of K11, 4 of K13 and K14, 13
    of K17, 2 of K19 (one FeatureNet call over the 5 views) and 5 of K28
    (one per resize)."""
    shapes = chip_smoke.sweep_shapes(chip_smoke.ENTRY_WIDTH, chip_smoke.ENTRY_HEIGHT,
                                     chip_smoke.ENTRY_VIEWS, chip_smoke.ITERATION)
    assert [s[:8] for s in shapes] == [
        ("init", 1, 32, 16, 20, 16, 20, 48),
        ("iter_level1", 1, 4, 32, 40, 64, 80, 16),
        ("iter_level2", 1, 4, 32, 40, 32, 40, 32),
        ("iter_level3", 1, 2, 32, 40, 16, 20, 48)]
    assert chip_smoke.planned_map_counts(shapes, torch.float32) == chip_smoke.planned_counts(
        sweep_premul=52, corr_epilogue=52, depth_readout=5, sweep_taps=5, convex_upsample=1,
        view_aggregate=13, gru_reset=4, gru_update=4, bn_act=13, upsample2x_add=2,
        resize_bilinear=5)


def test_dryrun_plan_per_rank_per_step():
    """The dry run's step on one rank (64x96, 3 views, 2 iterations, batch
    1): 2 + 2·2·3 = 14 launches of each sweep kernel, forward and
    backward, 3 of K6, K7 and K8, one of K9 and K10, 1 + 3·2 = 7 of K11
    and K12, 2 of K13-K16, 13 of K17, K18 and K22, 16 of K21, 2 of K19 and
    K20, one of K23, K24, K25, K26 and K27, 6 of K28 and 4 of K29."""
    shapes = chip_smoke.sweep_shapes(port_entry.DRYRUN_WIDTH, port_entry.DRYRUN_HEIGHT,
                                     port_entry.DRYRUN_VIEWS, port_entry.DRYRUN_ITERATION)
    plan = chip_smoke.planned_step_counts(shapes, torch.float32,
                                          iteration=port_entry.DRYRUN_ITERATION)
    assert plan == chip_smoke.planned_counts(
        sweep_premul=14, corr_epilogue=14, sweep_grad_ref=14, sweep_grad_src=14,
        depth_readout=3, depth_readout_grad=3, sweep_taps=3, convex_upsample=1,
        convex_upsample_grad=1, view_aggregate=7, view_aggregate_grad=7, gru_reset=2,
        gru_update=2, gru_update_grad=2, gru_reset_grad=2, bn_act=13, bn_act_grad=13,
        upsample2x_add=2, upsample2x_grad=2, bn_stats=16, bn_stats_grad=13, full_loss=1,
        full_loss_grad=1, grad_norm=1, clip_adam=1, depth_metrics=1, resize_bilinear=6,
        resize_bilinear_grad=4)


def test_largest_patch_finds_the_biggest_connected_block():
    bad = np.zeros((12, 16), bool)
    bad[2:4, 3:6] = True                  # 6 pixels
    bad[7:11, 9:12] = True                # 12 pixels
    bad[6, 8] = True                      # touches the block diagonally
    assert chip_smoke.largest_patch(bad) == (13, [6, 10, 8, 11])
    assert chip_smoke.largest_patch(np.zeros((3, 3), bool)) == (0, None)


def _entry_outputs(depth, conf=None):
    depth = torch.as_tensor(depth, dtype=torch.float32).reshape(1, 128, 160, 1)
    return depth, torch.full_like(depth, 0.5) if conf is None else conf


def test_hold_entry_gates():
    """entry_dryrun's first gate: the card's maps against the CPU's (median
    rel 1e-4, under 1% of pixels beyond 1e-3), shape, finite, launches."""
    want = _entry_outputs(np.linspace(2, 10, 128 * 160))
    plan = chip_smoke.planned_counts(sweep_premul=52)
    near = _entry_outputs(want[0] * (1 + 5e-5))
    rec = chip_smoke.hold_entry(near, want, plan, plan)
    assert rec["share_beyond_1e-3"] == 0 and rec["largest_patch_pixels"] == 0
    patch = want[0].clone()
    patch[0, 40:45, 60:68] *= 1.01                        # 40 pixels: 0.2%
    rec = chip_smoke.hold_entry(_entry_outputs(patch), want, plan, plan)
    assert rec["largest_patch_pixels"] == 40 and rec["largest_patch_box_y0_y1_x0_x1"] == [
        40, 44, 60, 67]
    wide = want[0].clone()
    wide[0, :2] *= 1.01                                   # 320 pixels: 1.6%
    nan = want[0].clone()
    nan[0, 0, 0] = float("nan")
    for got, match in ((_entry_outputs(want[0] * 1.001), "disagrees with the CPU"),
                       (_entry_outputs(wide), "disagrees with the CPU"),
                       (_entry_outputs(nan), "not finite"),
                       ((want[0][..., 0], want[1][..., 0]), "of another shape")):
        with pytest.raises(SystemExit, match=match):
            chip_smoke.hold_entry(got, want, plan, plan)
    with pytest.raises(SystemExit, match="launches"):
        chip_smoke.hold_entry(want, want, chip_smoke.planned_counts(), plan)


def test_hold_dryrun_gates():
    plan = chip_smoke.planned_counts(sweep_grad_ref=14)
    rec = {"loss": 164.77, "live": 99.889, "restored": 99.889, "restored_bit_equal": True,
           "ranks_bit_equal": True, "launches": [[plan] * 4] * 2}
    out = chip_smoke.hold_dryrun(rec, plan, 164.77 * (1 + 5e-5))
    assert out["resume_rel"] == 0 and out["loss_rel"] < 1e-4
    for bad, match in (({"restored": 99.889 * (1 + 2e-6)}, "resume or the ranks"),
                       ({"ranks_bit_equal": False}, "resume or the ranks"),
                       ({"restored_bit_equal": False}, "resume or the ranks"),
                       ({"launches": [[plan] * 4, [plan] * 3 + [chip_smoke.planned_counts()]]},
                        "launches per rank per step"),
                       ({"loss": 164.77 * (1 + 2e-4)}, "step 1 disagrees")):
        with pytest.raises(SystemExit, match=match):
            chip_smoke.hold_dryrun({**rec, **bad}, plan, 164.77)


def test_view_aggregate_chain_is_labelled_and_bounded():
    """K11's label is one of the profiled chains; its bound over a map is
    each source's correlation and the weights read once and the aggregate
    written once, at the init sweep (32 samples on the 1/8 grid) and the 3
    levels of each of 4 iterations (10 samples on the 1/4 grid): ≈ 0.91
    GB, 0.271 ms."""
    assert "view_aggregate" in chip_smoke.CHAINS
    p8, p4 = 144 * 200, 288 * 400
    nbytes = 4 * ((5 * 32 * 8 * p8 + 4 * p8) + 4 * (5 * 10 * 8 * p4 + 3 * 4 * p4))
    bounds = chip_smoke.chain_bound_ms(1600, 1152, 5, 4)
    assert bounds["view_aggregate"] == pytest.approx(
        1e3 * nbytes / chip_smoke.PEAK_BYTES_PER_S)
    assert bounds["view_aggregate"] == pytest.approx(0.271, abs=1e-3)
    # float32 in both precisions: the itemsize does not enter it.
    assert chip_smoke.chain_bound_ms(640, 512, 5, 4, 4, itemsize=2, train=True)[
        "view_aggregate"] == pytest.approx(chip_smoke.chain_bound_ms(640, 512, 5, 4, 4)[
            "view_aggregate"])


def test_profile_categories_name_the_view_aggregate_kernels():
    """K11's name is a prefix of K12's; neither has a bf16 form."""
    cat = chip_smoke._category
    assert cat("void (anonymous namespace)::view_aggregate_kernel<4>((anonymous "
               "namespace)::Views, float const*, float*, int, int, int, long long)") == \
        "view_aggregate"
    assert cat("void (anonymous namespace)::view_aggregate_grad_kernel<1, true>((anonymous "
               "namespace)::Views, float const*)") == "view_aggregate_grad"
    assert cat("void (anonymous namespace)::view_aggregate_grad_kernel<4, false>(float "
               "const*)") == "view_aggregate_grad"


def test_view_aggregate_work_counts_each_input_and_output_once():
    """K11: every view's correlation and weight read, the output written;
    K12: the weights and the gradient read, every view's ∂c written, and
    with ∂w the views and the output read and ∂w written too."""
    e, px = 4 * 256 * 5120, 4 * 5120
    assert chip_smoke.view_aggregate_work(4, 4, 256, 5120, grad=False) == (
        4 * (4 * e + 4 * px + e), 8 * e + 4 * px)
    assert chip_smoke.view_aggregate_work(4, 4, 256, 5120, grad=True) == (
        4 * (4 * px + e + 4 * e), 4 * px + 8 * e)
    assert chip_smoke.view_aggregate_work(4, 4, 256, 5120, grad=True, weight_grad=True) == (
        4 * (4 * px + e + 4 * e + 4 * e + e + 4 * px), 4 * px + 20 * e)


def test_view_aggregate_inputs_and_cases():
    """chip_smoke's K11/K12 inputs, made on the CPU: stacked views are
    slices of one tensor (strided by the batch, no copy), weights lie in
    a softmax maximum's range [1/V, 1]; the edge cases hold an odd P and
    6 sources, and the main path's shapes keep n·G a multiple of K11's 8
    rows per thread."""
    gen = torch.Generator().manual_seed(0)
    corrs, weights, grad = chip_smoke.view_aggregate_inputs(4, 3, 2, 10, True, gen, "cpu")
    assert len(corrs) == 3 and corrs[0].shape == grad.shape == (4, 2, 8, 10)
    assert corrs[0].stride() == (3 * 2 * 8 * 10, 80, 10, 1)
    assert corrs[1].data_ptr() - corrs[0].data_ptr() == 2 * 8 * 10 * 4
    assert weights.shape == (4, 3, 10) and (weights >= 1 / 3).all() and (weights <= 1).all()
    corrs, _, _ = chip_smoke.view_aggregate_inputs(1, 6, 4, 7, False, gen, "cpu")
    assert len(corrs) == 6 and all(c.is_contiguous() for c in corrs)
    cases = {c[0]: c for c in chip_smoke.VIEW_EDGE_CASES}
    assert cases["odd_p"][4] % 2 == 1 and cases["odd_p"][5]
    assert cases["six_sources"][2] == 6
    # K12's row splits: 24 rows on the init's stacked layout, 8 rows, one view.
    assert cases["rows_24"][3] * chip_smoke.GROUPS == 24 and cases["rows_24"][5]
    assert cases["one_sample"][3] * chip_smoke.GROUPS == 8
    assert cases["one_view"][2] == 1
    for args in ((1600, 1152, 5, 4), (640, 512, 5, 4, 4)):
        assert all(s[2] * chip_smoke.GROUPS % 8 == 0 for s in chip_smoke.sweep_shapes(*args))


def test_kernels_line_names_every_kernel_once():
    """The `kernels` line reports K11 per depth map and K12 per training
    step, every other kernel as before (fusion_consistency in its own
    entry), each with a source in the repo and the file:line it
    replaces."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert "view_aggregate" in chip_smoke.REPORT_PER_MAP
    assert "view_aggregate_grad" in chip_smoke.REPORT_PER_STEP
    named = chip_smoke.REPORT_PER_MAP + chip_smoke.REPORT_PER_STEP + ("fusion_consistency",)
    assert sorted(named) == sorted(chip_smoke.KERNEL_NAMES)
    sources = chip_smoke.kernel_sources()
    assert set(sources) == set(chip_smoke.KERNEL_NAMES)
    assert sources["view_aggregate"][0] == "itermvs_tpu_torch/csrc/view_aggregate.cu"
    for source, replaces in sources.values():
        assert os.path.exists(os.path.join(root, source))
        path, line = replaces.split(":")
        with open(os.path.join(root, path)) as f:
            assert int(line) <= len(f.readlines())


def test_device_us_takes_one_more_capture_then_raises(monkeypatch):
    """An empty profiler capture is taken once more after a pause; a
    second empty one raises naming the phase, and no timing comes back
    from nothing."""
    captures = []

    def fake(results):
        def device_time(fn):
            fn()
            captures.append(1)
            return results.pop(0)
        return device_time

    monkeypatch.setattr(chip_smoke, "CAPTURE_PAUSE_S", 0.0)
    full = ({"void (anonymous namespace)::k_kernel<float, 4>(float const*)": (20, 40.0)},
            {}, 0.04)
    monkeypatch.setattr(chip_smoke, "device_time", fake([({}, {}, 0.0), full]))
    assert chip_smoke.device_us(lambda: None, phase="p") == {"k_kernel<float, 4>": 2.0}
    assert len(captures) == 2
    monkeypatch.setattr(chip_smoke, "device_time", fake([({}, {}, 0.0), ({}, {}, 0.0)]))
    with pytest.raises(SystemExit, match="gru_update_bf16 at map_call: the profiler"):
        chip_smoke.device_us(lambda: None, phase="gru_update_bf16 at map_call")
    monkeypatch.setattr(chip_smoke, "device_time", fake([({}, {}, 0.0), full]))
    assert chip_smoke.device_capture(lambda: None, "q")[2] == 0.04


def test_bn_calls_are_featurenets_bn_epilogues(monkeypatch):
    """BN_CALLS lists the K17 calls of one FeatureNet image in order:
    their form, channels and plane scale, recorded from the port's
    FeatureNet on the CPU (train mode: every BN takes batch statistics,
    and the epilogues go through `bn_train`); BN_INPUTS lists the inputs
    whose statistics K21 takes, in the same order."""
    from itermvs_tpu_torch.models import blocks
    from itermvs_tpu_torch.models.feature_net import FeatureNet

    seen, inputs = [], []
    plain, stats = blocks.bn_train, blocks.bn_batch_stats

    def record(y, *args, skip=None, skip_bn=None, relu=True):
        form = "plain" if skip is None else "residual" if skip_bn is None else "downsample"
        seen.append((form, y.shape[1], 64 // y.shape[2], relu))
        return plain(y, *args, skip=skip, skip_bn=skip_bn, relu=relu)

    def record_stats(y):
        inputs.append((y.shape[1], 64 // y.shape[2]))
        return stats(y)

    monkeypatch.setattr(blocks, "bn_train", record)
    monkeypatch.setattr(blocks, "bn_batch_stats", record_stats)
    FeatureNet().train()(torch.zeros(1, 3, 64, 96))
    assert seen == [(*call, True) for call in chip_smoke.BN_CALLS]
    assert inputs == list(chip_smoke.BN_INPUTS) and len(inputs) == 16


def test_bn_work_counts_each_input_and_output_once():
    """K17 reads y (and the skip) and writes the output; K18 reads g, the
    output, y (and xd) and writes ∂y (and ∂skip), reads 3 per-channel
    float32 vectors per BN and writes 5 rows per BN (K17 reads 4). The map's 13 calls on one
    1600x1152 image: ≈ 154 M elements, 0.184 ms in float32."""
    n, c, p = 2, 16, 100
    e = n * c * p
    assert chip_smoke.bn_work("plain", n, c, p, 4) == (4 * 2 * e + 16 * c, 4 * e)
    assert chip_smoke.bn_work("residual", n, c, p, 2) == (2 * 3 * e + 16 * c, 5 * e)
    assert chip_smoke.bn_work("downsample", n, c, p, 4) == (4 * 3 * e + 32 * c, 8 * e)
    assert chip_smoke.bn_work("plain", n, c, p, 4, grad=True) == (4 * 4 * e + 32 * c, 6 * e)
    assert chip_smoke.bn_work("plain", n, c, p, 4, grad=True, relu=False)[0] == \
        4 * 3 * e + 32 * c
    assert chip_smoke.bn_work("residual", n, c, p, 2, grad=True) == (2 * 5 * e + 32 * c, 6 * e)
    assert chip_smoke.bn_work("downsample", n, c, p, 4, grad=True) == (
        4 * 6 * e + 64 * c, 10 * e)
    elements = sum({"plain": 2, "residual": 3, "downsample": 3}[f] * ch
                   * (1152 // s) * (1600 // s) for f, ch, s in chip_smoke.BN_CALLS)
    assert elements == pytest.approx(154e6, rel=2e-3)
    bounds = chip_smoke.chain_bound_ms(1600, 1152, 5, 4)
    assert bounds["bn_act"] == pytest.approx(0.184, abs=1e-3)
    assert chip_smoke.chain_bound_ms(1600, 1152, 5, 4, itemsize=2)["bn_act"] == \
        pytest.approx(0.092, abs=1e-3)
    # A training step's forward: the batch's 4 x 5 images at 640x512.
    step = chip_smoke.chain_bound_ms(640, 512, 5, 4, 4, train=True)["bn_act"]
    assert step == pytest.approx(20 * 1e3 * chip_smoke.bn_image_bytes(640, 512, 4)
                                 / chip_smoke.PEAK_BYTES_PER_S)
    assert "bn_act" in chip_smoke.CHAINS


def test_profile_categories_keep_k17_and_k18_out_of_batch_norm():
    """K17's name is a prefix of K18's, and both hold "bn_", which files
    cuDNN's batch norm: each is its own kernel, f32 or bf16 by its
    template's first argument (K18's fold kernel too)."""
    cat = chip_smoke._category
    assert cat("void (anonymous namespace)::bn_act_kernel<float, 2, true, 4>((anonymous "
               "namespace)::Channel)") == "bn_act"
    assert cat("void (anonymous namespace)::bn_act_kernel<__nv_bfloat16, 0, true, 8>("
               "__nv_bfloat16 const*)") == "bn_act_bf16"
    assert cat("void (anonymous namespace)::bn_act_grad_kernel<float, 1, true, 1>(float "
               "const*)") == "bn_act_grad"
    assert cat("void (anonymous namespace)::bn_act_grad_fold_kernel<__nv_bfloat16, 3>(float "
               "const*, float*, int, int, int)") == "bn_act_grad_bf16"
    assert cat("void cudnn::bn_fw_inf_1C11_kernel_NCHW<float, float, true, 1>(float)") == \
        "batch_norm"


def test_bn_inputs_plant_the_relu_edge_and_signed_scales():
    """chip_smoke's K17/K18 inputs, made on the CPU: every 37th element of
    channel 0 equals its mean (bn = 0 there in form a: the ReLU's edge),
    the scales alternate in sign, the variances are positive, and form c
    has a second BN."""
    gen = torch.Generator().manual_seed(0)
    for dtype in (torch.float32, BF16):
        t = chip_smoke.bn_inputs("downsample", 3, 5, 7, 9, dtype, gen, dev="cpu")
        w, b, mean, var = t["bn"]
        assert t["y"].dtype == t["skip"].dtype == t["g"].dtype == dtype
        assert (t["y"][:, 0].reshape(3, -1)[:, ::37].float() == mean[0]).all()
        assert b[0] == 0 and (w[::2] > 0).all() and (w[1::2] < 0).all() and (var > 0).all()
        assert t["skip_bn"] is not None and t["skip_bn"][0].shape == (5,)
        out = chip_smoke.bn_ops.bn_act(t["y"], *t["bn"])
        assert (out[:, 0].reshape(3, -1)[:, ::37] == 0).all()
    cases = {c[0]: c for c in chip_smoke.BN_EDGE_CASES}
    assert cases["odd_hw"][5] * cases["odd_hw"][6] % 8 and cases["odd_hw"][3] * 5 % 2
    assert cases["one_pixel"][5:] == (1, 1)
    assert chip_smoke.bn_ops.spans_of(cases["two_spans_scalar"][5] * 71) == 2
    assert chip_smoke.bn_ops.spans_of(40 * 123) == 2 and 40 * 123 % 8 == 0
    assert not cases["lone_bn"][2]


def test_profile_categories_file_cudnn_outside_other():
    """"other" holds eager PyTorch kernels only: cuDNN's FFT convolution
    (its transforms and complex GEMM) and anything in its namespaces file
    as "convolution", its layout transposes as "conv_layout" (names as a
    profiled training step prints them, cut at 90 characters), its batch
    norm as "batch_norm"; K25 and K26 are their own kernels before
    "optimizer" (K26's name holds "adam"), which keeps torch.optim.Adam's
    foreach kernels."""
    cat = chip_smoke._category
    for name in ("void fft2d_r2c_32x32<float, false, 0u, false>(float2*, float const*, int, "
                 "int, int, int, i",
                 "void fft2d_c2r_32x32<float, false, false, 0u, false, false>(float*, float2 "
                 "const*, int, in",
                 "void internal::region_transform_ABC_val<int, 32, 32, false, "
                 "internal::TransformParamsABC<f",
                 "sm80_xmma_gemm_cf32cf32_f32f32_cf32_nt_n_tilesize32x32x8_stage3_warpsize2x2x1_"
                 "ffma_aligna8",
                 "void cudnn::detail::dgrad_engine<float, 512, 6, 5, 3, 3, 3, false>(int, int, "
                 "int, float co",
                 "void wgrad_alg0_engine<float, 128, 5, 5, 3, 3, 3, false, 512>(int, int, int, "
                 "float const*,",
                 "_ZN17cutlass__5x_cudnn6KernelINS_4conv6kernel23ImplicitGemmConvolutionINS1_11thr"
                 "eadblock22"):
        assert cat(name) == "convolution", name
    for name in ("void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16, "
                 "__nv_bfloat16, float, fal",
                 "void cudnn::engines_precompiled::nhwcToNchwKernel<__nv_bfloat16, "
                 "__nv_bfloat16, float, tru"):
        assert cat(name) == "conv_layout", name
    assert cat("void cudnn::bn_fw_tr_1C11_kernel_NCHW<float, float, int, 512, true, 1>(") == \
        "batch_norm"
    assert cat("void (anonymous namespace)::clip_adam_kernel((anonymous namespace)::Table, "
               "double const*, (anonymous namespace)::Hyper)") == "clip_adam"
    assert cat("void (anonymous namespace)::grad_norm_partial_kernel((anonymous namespace)::"
               "Table, double*)") == "grad_norm"
    assert cat("(anonymous namespace)::grad_norm_fold_kernel(double const*, int, double*)") \
        == "grad_norm"
    assert cat("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<at::native::"
               "(anonymous namespace)::TensorListMetadata<4>, at::native::(anonymous namespace)"
               "::FusedAdamMathFunctor<float, 4, (at::native::ADAM_MODE)0, false>>") == \
        "optimizer"
    assert cat("void at::native::vectorized_elementwise_kernel<4, at::native::"
               "CUDAFunctor_add<float>, std:") == "other"


def _captured(**calls):
    """A capture's `by_name` holding `calls` device kernels of each named
    hand-written kernel (under a name `_category` files as it)."""
    names = {"grad_norm": "(anonymous namespace)::grad_norm_partial_kernel(Table, double*)",
             "clip_adam": "(anonymous namespace)::clip_adam_kernel(Table)",
             "full_loss": "(anonymous namespace)::full_loss_kernel(Planes)",
             "sweep_premul": "(anonymous namespace)::sweep_premul_kernel(float4 const*)"}
    out = {names[k]: (n, 1.0) for k, n in calls.items()}
    out["void at::native::vectorized_elementwise_kernel<4>"] = (7, 1.0)
    return out


def test_captures_are_held_against_the_launch_plan(monkeypatch):
    """Each hand-written kernel's device kernels in a capture against its
    planned launches times KERNELS_PER_LAUNCH (K25 and K23: a kernel and a
    fold each): an empty or short capture is retaken after a pause, three
    captures in all, and a third miss raises naming the phase."""
    plan = chip_smoke.planned_counts(grad_norm=1, clip_adam=1, full_loss=1, sweep_premul=52)
    assert set(chip_smoke.KERNELS_PER_LAUNCH) <= set(chip_smoke.KERNEL_NAMES)
    full = _captured(grad_norm=2, clip_adam=1, full_loss=2, sweep_premul=52)
    assert chip_smoke.plan_misses(full, plan) == {}
    assert chip_smoke.plan_counts(full)["grad_norm"] == 2
    assert chip_smoke.plan_misses(_captured(grad_norm=2, clip_adam=1, full_loss=1,
                                            sweep_premul=50), plan) == {
        "full_loss": [1, 2], "sweep_premul": [50, 52]}
    events = {"full": [_Event(k, 0, 1) for k, (n, _) in full.items() for _ in range(n)],
              "short": [_Event(k, 0, 1) for k, (n, _) in full.items() for _ in range(n)][1:],
              "empty": []}
    taken = []

    def trace(order):
        def fake(fn):
            fn()
            taken.append(1)
            return events[order.pop(0)]
        return fake

    monkeypatch.setattr(chip_smoke, "CAPTURE_PAUSE_S", 0.0)
    monkeypatch.setattr(chip_smoke, "trace_events", trace(["empty", "short", "full"]))
    by_name, _, busy, got = chip_smoke.device_capture(lambda: None, "step", plan)
    assert len(taken) == 3 and got == events["full"] and busy > 0
    assert chip_smoke.plan_counts(by_name)["sweep_premul"] == 52
    monkeypatch.setattr(chip_smoke, "trace_events", trace(["short", "empty", "short"]))
    with pytest.raises(SystemExit, match="train_full_width f32: 3 captures missed"):
        chip_smoke.device_capture(lambda: None, "train_full_width f32", plan)


def test_update_events_find_the_eager_update_only():
    """The profiled step's eager update: a kernel under the `clip_adam`
    label other than K25's and K26's, or a foreach kernel anywhere; K25
    and K26 alone under the label, and eager kernels outside it, are
    none."""
    k25 = "(anonymous namespace)::grad_norm_partial_kernel(Table, double*)"
    fold = "(anonymous namespace)::grad_norm_fold_kernel(double const*, int, double*)"
    k26 = "(anonymous namespace)::clip_adam_kernel(Table, double const*, Hyper)"
    where = "void at::native::elementwise_kernel<128, 2, where_kernel_impl>"
    foreach = "void at::native::multi_tensor_apply_kernel<FusedAdamMathFunctor>"
    clean = [_Event("clip_adam", 0, 100, "cpu", annotation=True), _Event("clip_adam", 10, 40),
             _Event(k25, 10, 15), _Event(fold, 16, 20), _Event(k26, 21, 30),
             _Event(where, 50, 60)]
    assert chip_smoke.update_op_events(clean) == {}
    dirty = clean + [_Event("clip_adam", 70, 90), _Event(where, 71, 75),
                     _Event(foreach, 95, 99)]
    assert chip_smoke.update_op_events(dirty) == {where[:90]: 1, foreach[:90]: 1}
    assert chip_smoke.chain_time(clean)["clip_adam"] == {"device_ms": 0.018, "launches": 3}


def test_metric_events_find_the_eager_metrics_only():
    """The profiled step's eager metrics: a kernel under the
    `depth_metrics` label other than K27's two; K27's alone under the
    label, and eager kernels outside it, are none."""
    pixel = "(anonymous namespace)::depth_metrics_pixel_kernel(Planes, int)"
    fold = "(anonymous namespace)::depth_metrics_fold_kernel(double const*, float*)"
    where = "void at::native::elementwise_kernel<128, 2, where_kernel_impl>"
    clean = [_Event("depth_metrics", 0, 100, "cpu", annotation=True),
             _Event("depth_metrics", 10, 40), _Event(pixel, 10, 15), _Event(fold, 16, 20),
             _Event(where, 50, 60)]
    assert chip_smoke.metric_op_events(clean) == {}
    dirty = clean + [_Event("depth_metrics", 70, 90), _Event(where, 71, 75)]
    assert chip_smoke.metric_op_events(dirty) == {where[:90]: 1}
    assert chip_smoke.chain_time(clean)["depth_metrics"] == {"device_ms": 0.009, "launches": 2}


def test_update_work_and_bound_count_the_model_parameters():
    """The training model has 100 parameters, 341,333 elements; K25 reads
    each gradient once (1.37 MB), K26 reads g, p, m, v and writes p, m, v
    (9.56 MB), which is the `clip_adam` label's bound in training and 0 in
    eval."""
    shapes = chip_smoke.model_param_shapes()
    numel = sum(int(np.prod(s)) for s in shapes)
    assert len(shapes) == 100 and numel == 341333
    assert chip_smoke.update_work(numel, "grad_norm")[0] == 1365332
    assert chip_smoke.update_work(numel, "clip_adam")[0] == 9557324
    train = chip_smoke.chain_bound_ms(640, 512, 5, 4, 4, train=True)
    assert train["clip_adam"] == pytest.approx(1e3 * 9557324 / chip_smoke.PEAK_BYTES_PER_S)
    assert chip_smoke.chain_bound_ms(1600, 1152, 5, 4)["clip_adam"] == 0


def test_clip_adam_case_and_ulps():
    """`check_clip_adam`'s inputs on the CPU: the seeded model's
    parameters and each step's gradients at the asked global norm, above
    and below the clip; `ulps_apart` counts float32 steps across zero."""
    gen = torch.Generator().manual_seed(0)
    params, steps = chip_smoke.clip_adam_case(10.0, 2, gen, dev="cpu")
    assert [tuple(p.shape) for p in params] == list(chip_smoke.model_param_shapes())
    for grads in steps:
        assert float(chip_smoke.clip_ops.grad_norm_plain(grads)[1]) == pytest.approx(10.0,
                                                                                     rel=1e-5)
    assert not torch.equal(steps[0][0], steps[1][0])
    one = torch.tensor([1.0])
    assert chip_smoke.ulps_apart([one], [one]) == 0
    assert chip_smoke.ulps_apart([torch.nextafter(one, torch.tensor([2.0]))], [one]) == 1
    tiny = torch.tensor([torch.finfo(torch.float32).tiny * 2 ** -23])
    assert chip_smoke.ulps_apart([tiny], [-tiny]) == 2
    assert [c[0] for c in chip_smoke.CLIP_CASES] == ["clip", "no_clip", "clip_wd",
                                                     "no_clip_wd"]
