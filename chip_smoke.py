#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Checks for a CUDA device and prints its name and power limit.
2. Builds the port's CUDA kernels from itermvs_tpu_torch/csrc with nvcc.
3. Holds each kernel against its plain PyTorch version on the card at
   the 1600x1152 shapes of the depth path (sweep_premul, corr_epilogue)
   and of fusion (fusion_consistency, bit for bit: with 10 sources as
   DTU's pair lists give, with the 4 of the fusion run below, which the
   report line carries, and at the K3_EDGE_CASES), and times kernel
   (`ms`: sweep_premul and corr_epilogue launched bare into outputs
   allocated beforehand, `call_ms` through their wrappers), plain version
   and (for corr_epilogue) one PyTorch call of the same function.
4. Runs the port's eval core loop (`itermvs_tpu_torch.eval.run_depth`)
   with the vendored DTU weights and the feature cache on a 5-view
   textured-plane scene made in memory at 1600x1152, one depth map per
   reference view, float32, 4 GRU iterations; reads the PFMs back and
   checks them against the scene's analytic depth; checks that each
   kernel launched as often as the chunk plan predicts.
5. Fuses those 5 depth maps (`itermvs_tpu_torch.fusion.fuse_views`,
   each view against the other 4) into a PLY, reads it back and checks
   it against the plane, checks the mask PNGs and that
   fusion_consistency launched once per reference view; then fuses the
   scene's analytic depth maps, where most pixels must survive.
6. Two more timed depth passes over the same maps (maps/s), then
   profiles them once more with torch.profiler: device time by kernel
   and by kind, and the device's idle share.
7. Holds the sweep kernels, forward (sweep_premul, corr_epilogue) and
   backward (sweep_grad_ref, sweep_grad_src), against their plain
   versions on the card at the four sweep shapes of a training step at
   640x512, batch 4, 5 views, and times them (the backward kernels bare
   and through their wrappers); holds the backward kernels on pile-up,
   edge and one-corner bases too, and K4 bit for bit against a second
   launch; checks that a base index outside the source map shows as NaN
   in both.
8. One train step of the port (`engine.train_loop`) on the card against
   the same step on the CPU (plain versions) at 160x128, batch 2, 3
   views, 2 iterations, the DTU weights: loss and gradients.
9. The training path at full width: 10 steps at 640x512, batch 4, 5
   views, 4 GRU iterations, stage 2 (regress), from a fresh seeded init,
   on one in-memory DTU-layout batch of the plane scene: the loss must
   fall, and each of the four sweep kernels must launch 52 times per
   step; ms per step, steps/s, peak memory and one profiled step's
   device time by kind and idle share; then a validation step and a
   checkpoint saved and restored on the card; then the backward kernels
   on that step's own sweeps (`capture_sweeps`: every (view, level)
   sweep's src, ref, base, taps and grad_corr), 10 launches each held
   against the float64 plain versions, K4 bit-equal launch to launch,
   their bare ms per shape printed beside the `sweep_inputs` times.

10. Data-parallel training (`parallel/mesh.py`), train_dtu.sh's stage-2
   step at full width from the DTU weights (`ddp_job` says why not a
   fresh init) on 4 distinct samples whose
   masks keep 100/87.5/75/62.5% of the rows: `train_ddp_2rank` runs 3
   steps on two processes on the one card, joined over gloo (NCCL
   refuses two ranks on one device), 2 samples each, beside the
   one-process step on all 4: the first loss within 1e-4 (relative), the
   parameters after the first step within 1e-3 (relative L2), the two
   ranks' parameters and BN statistics bit-equal after every step, 52
   launches of K1, K2, K4, K5 per rank per step; ms per step of the two
   processes sharing the card. `train_ddp_nccl` runs the synced path
   (global BN statistics, global loss and metric denominators, summed
   gradients) as one NCCL rank against the plain step from the same
   init, 5 steps each, in f32 with the same gates and in bf16, where
   the loss and parameter bounds lie below bf16's own noise: there the
   BN statistics (1e-4, relative L2), the launches and finite losses are
   gated, and the first loss and parameters are printed beside two plain
   bf16 steps from the init perturbed by 1e-7; ms per step of both forms
   and one profiled step each (device time by kind).
11. `--debug_nans` (`engine/profiling.py`): one 1600x1152 depth map with
   the checks on runs clean (median error < 0.05, 52 launches of K1 and
   K2), and the same map with a NaN put into one input image raises
   FloatingPointError naming a module.

bfloat16 (`Pipeline(dtype=torch.bfloat16)`, eval's and train's
`--precision bfloat16`) runs the bf16 forms of the four sweep kernels:
after step 6 they are held against their plain versions at the depth
path's shapes (sweep_premul_bf16 bit for bit, corr_epilogue_bf16 within
1e-6 of max|plain|, timed beside a bf16 torch.matmul; each line with the
share of the bound and, for K1, its time over the matmul's) and at their
edges (`check_fwd_edge_cases`: ragged row counts, bases on the map's
last row or column and off it, where both write NaN, C = 8 and 256),
then the same 5 depth maps run in bf16 (each map's median error < 0.05
and within max(1.15 f32, f32 + 0.01) of the f32 run's; 52 launches of
each forward form per map; maps/s, device time by kind, idle share);
after step 7 all four are held at the training step's shapes and on the
pile-up, edge and one-corner bases (sweep_grad_ref_bf16 and
sweep_grad_src_bf16 within one bf16 step of |plain| plus 1e-5 of
max|plain|, 10 launches each; each line with the share of their blocks
whose source window would fit a shared-memory budget,
`window_fit_share`); after step 9 the same 10 training steps run in
bf16 (loss finite and falling, the first within 2% of the f32
run's, the mean of the last two no more than 15% above f32's, each
dtype's averaged over its run and two runs from the init perturbed by
1e-6; 52 launches of each bf16 form per step; the bf16 loss on an f32
run's weights before each step is printed).

The last line is `{"ok": true, "device": {...}}`; any failed phase
exits non-zero before it. Without a CUDA device, or outside the repo,
the script exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from itermvs_tpu_torch import kernels
from itermvs_tpu_torch.engine.checkpoint import restore_checkpoint, save_checkpoint
from itermvs_tpu_torch.engine.profiling import maybe_enable_nan_debugging
from itermvs_tpu_torch.engine.train_loop import (
    forward_loss, init_weights, make_optimizer, to_device_batch, train_step, val_step)
from itermvs_tpu_torch.eval import run_depth
from itermvs_tpu_torch.fusion import MemoryViews, consistency_matrices, fuse_views
from itermvs_tpu_torch.io import read_pfm, read_ply
from itermvs_tpu_torch.models import Pipeline
from itermvs_tpu_torch.models import itermvs as itermvs_model
from itermvs_tpu_torch.models.itermvs import (
    CORR_INTERVALS, GROUPS, LEVELS, NUM_INIT_SAMPLES)
from itermvs_tpu_torch.ops.consistency import (
    MAX_SOURCES, consistency, consistency_plain, launch_consistency, record)
from itermvs_tpu_torch.ops.sweep import (
    launch_sweep_premul, sample_chunks, sweep_premul, sweep_premul_plain)
from itermvs_tpu_torch.ops.sweep_epilogue import (
    corr_epilogue, corr_epilogue_plain, launch_corr_epilogue)
from itermvs_tpu_torch.ops.sweep_grad import (
    SweepCorr, launch_sweep_grad_ref, launch_sweep_grad_src, sweep_grad_ref,
    sweep_grad_ref_plain, sweep_grad_src, sweep_grad_src_plain)
from itermvs_tpu_torch.parallel import mesh
from itermvs_tpu_torch.weights import (
    load_npz_weights, load_state, npz_state_dict, pretrained_path)

WIDTH, HEIGHT = 1600, 1152
VIEWS = 5
ITERATION = 4
DTU_SOURCES = 10        # sources per reference view in DTU's pair lists
SEED = 0
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and
# float32 rate outside the tensor cores. The bf16 forms of the sweep
# kernels compute in float32 too, from converted values.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
BF16 = torch.bfloat16
# One bf16 step relative to a value (2^-7): the bf16 backward kernels and
# their plain versions each round one float32 sum, summed in another
# order, so the two may land one step apart.
BF16_STEP = torch.finfo(BF16).eps
FEATURE_CHANNELS = {"level1": 16, "level2": 32, "level3": 48}
# The training step of train_dtu.sh's recipe: 640x512 crops, batch 4,
# 5 views, 4 GRU iterations, float32, stage 2 (--regress).
TRAIN_WIDTH, TRAIN_HEIGHT = 640, 512
TRAIN_BATCH, TRAIN_VIEWS, TRAIN_ITERATION = 4, 5, 4
TRAIN_STEPS = 10
TRAIN_LR = 1e-3
# The train step held on the card against the CPU.
SMALL_TRAIN = dict(width=160, height=128, batch=2, views=3, iteration=2)
# The spread of the training loss after TRAIN_STEPS steps, in each dtype:
# TRAIN_NOISE_RUNS more runs from the same init with every weight scaled by
# (1 + TRAIN_NOISE * N(0, 1)). Adam's first steps move each weight by about
# the learning rate whatever its gradient's size (m/sqrt(v) ~ +-1), so
# where a gradient is near 0 any noise flips that move, and f32 runs from
# inits 1e-6 apart end 10 steps tens of percent apart: the bf16 endpoint
# is held against f32's as the means over these runs.
TRAIN_NOISE, TRAIN_NOISE_RUNS = 1e-6, 2

# ---------------------------------------------------------------- scene
# The port's own copy of the textured-plane scene of
# tests/synthetic_scene.py (make_cameras, render_view for scene="plane"),
# without PIL: a world plane z = Z0 seen by a reference camera at the
# origin and slightly moved sources, with exact per-view depth.
Z0 = 5.0
DEPTH_MIN, DEPTH_MAX = 2.0, 10.0
_NOISE_RES = 512
_NOISE = np.random.RandomState(1234).rand(3, _NOISE_RES, _NOISE_RES).astype(np.float64)


def _value_noise(channel, u, v):
    grid = _NOISE[channel]
    u = np.clip(u, 0, _NOISE_RES - 1.001)
    v = np.clip(v, 0, _NOISE_RES - 1.001)
    u0 = np.floor(u).astype(np.int64)
    v0 = np.floor(v).astype(np.int64)
    fu = u - u0
    fv = v - v0
    return ((grid[v0, u0] * (1 - fu) + grid[v0, u0 + 1] * fu) * (1 - fv)
            + (grid[v0 + 1, u0] * (1 - fu) + grid[v0 + 1, u0 + 1] * fu) * fv)


def _texture(x, y):
    out = []
    for c in range(3):
        out.append(0.5 * _value_noise(c, 8 * x + 77, 8 * y + 77)
                   + 0.3 * _value_noise(c, 24 * x + 200, 24 * y + 150)
                   + 0.2 * _value_noise(c, 64 * x + 300, 64 * y + 350))
    return np.clip(np.stack(out, axis=-1), 0.0, 1.0)


def make_cameras(num_views, width, height, rng):
    K = np.array([[width * 1.2, 0, width / 2],
                  [0, width * 1.2, height / 2],
                  [0, 0, 1]], np.float32)
    cams = []
    for v in range(num_views):
        if v == 0:
            E = np.eye(4, dtype=np.float32)
        else:
            angle = rng.uniform(-0.02, 0.02, 3)
            cx, cy, cz = np.cos(angle)
            sx, sy, sz = np.sin(angle)
            Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
            Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
            Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
            E = np.eye(4, dtype=np.float32)
            E[:3, :3] = (Rx @ Ry @ Rz).astype(np.float32)
            E[:3, 3] = [rng.uniform(0.15, 0.4) * (-1) ** v,
                        rng.uniform(-0.1, 0.1), rng.uniform(-0.05, 0.05)]
        cams.append((K.copy(), E))
    return cams


def _plane_hit(K, E, width, height):
    """(world hit points [H,W,3], depth [H,W]) of the plane z = Z0."""
    xs, ys = np.meshgrid(np.arange(width, dtype=np.float64),
                         np.arange(height, dtype=np.float64))
    pix = np.stack([xs, ys, np.ones_like(xs)], axis=-1)
    dirs = pix @ np.linalg.inv(K.astype(np.float64)).T
    R = E[:3, :3].astype(np.float64)
    t = E[:3, 3].astype(np.float64)
    cam_center = -R.T @ t
    dirs_world = dirs @ R
    s_hit = (Z0 - cam_center[2]) / dirs_world[..., 2]
    pw = cam_center + s_hit[..., None] * dirs_world
    return pw, (s_hit * dirs[..., 2]).astype(np.float32)


def render_view(K, E, width, height):
    """(rgb [H,W,3] in [0,1], depth [H,W]) of the plane z = Z0."""
    pw, depth = _plane_hit(K, E, width, height)
    return _texture(pw[..., 0], pw[..., 1]).astype(np.float32), depth


def render_scene(width, height, views, seed):
    """(cameras [(K, E)], images uint8 [H,W,3], analytic depths [H,W]) of
    the plane scene."""
    cams = make_cameras(views, width, height, np.random.RandomState(seed))
    images, depths = [], []
    for K, E in cams:
        rgb, depth = render_view(K, E, width, height)
        images.append((rgb * 255).astype(np.uint8))
        depths.append(depth)
    return cams, images, depths


def samples_of(cams, images):
    """One batch-1 sample per reference view of a rendered scene, in the
    loader's layout (uint8 images scaled to [-1, 1] as the loader does;
    only level_0 images, which is all the model reads)."""
    views = len(cams)
    imgs, projs = [], []
    for (K, E), u8 in zip(cams, images):
        imgs.append(2.0 * u8.astype(np.float32) / 255.0 - 1.0)
        pyr = {}
        for level in range(4):
            k = K.copy()
            k[:2] *= 0.5 ** level
            p = E.copy()
            p[:3, :4] = k @ E[:3, :4]
            pyr[f"level_{level}"] = p
        projs.append(pyr)
    samples = []
    for ref in range(views):
        vids = [ref] + [v for v in range(views) if v != ref]
        samples.append({
            "imgs": {"level_0": np.stack([imgs[v] for v in vids])[None]},
            "proj_matrices": {k: np.stack([projs[v][k] for v in vids])[None]
                              for k in projs[0]},
            "depth_min": np.array([DEPTH_MIN], np.float32),
            "depth_max": np.array([DEPTH_MAX], np.float32),
            "filename": ["{}/" + f"{ref:0>8}" + "{}"],
            "scan": ["synthetic"],
            "view_ids": np.array([vids], np.int32),
        })
    return samples


# --------------------------------------------------------------- kernels
def sweep_shapes(width, height, views, iteration, batch=1, itemsize=4):
    """Per sweep shape of one forward pass: (name, batch, n, H, W, H1, W1,
    C, launches of each forward kernel, from the chunk plan for features
    of `itemsize` bytes). The backward kernels launch once per (view,
    level) sweep, whatever the chunks."""
    h4, w4 = height // 4, width // 4
    src = {"level1": (height // 2, width // 2), "level2": (h4, w4),
           "level3": (height // 8, width // 8)}

    def chunks(n, hw, c):
        return len(sample_chunks(batch, n, hw, c, itemsize=itemsize))

    out = [("init", batch, NUM_INIT_SAMPLES, h4 // 2, w4 // 2, *src["level3"], 48,
            (views - 1) * chunks(NUM_INIT_SAMPLES, h4 * w4 // 4, 48))]
    for key in LEVELS:
        n, c = len(CORR_INTERVALS[key]), FEATURE_CHANNELS[key]
        out.append((f"iter_{key}", batch, n, h4, w4, *src[key], c,
                    iteration * (views - 1) * chunks(n, h4 * w4, c)))
    return out


def sweep_inputs(b, n, h, w, h1, w1, c, gen, dev="cuda", dtype=torch.float32):
    """K2 inputs with the access pattern of a real sweep: each sample is
    the reference grid, scaled to the source size and shifted by a
    per-sample sub-pixel-to-several-pixel disparity. Features and taps in
    `dtype` (bf16: the float32 draws rounded)."""
    ys = torch.arange(h, device=dev, dtype=torch.float32).reshape(1, h, 1) * (h1 / h)
    xs = torch.arange(w, device=dev, dtype=torch.float32).reshape(1, 1, w) * (w1 / w)
    shift = torch.linspace(-6.0, 6.0, n, device=dev).reshape(n, 1, 1)
    px = (xs + shift + 0.37).expand(n, h, w)
    py = (ys + 0.21 * shift).expand(n, h, w)
    bx = px.floor().clamp(0, w1 - 1)
    by = py.floor().clamp(0, h1 - 1)
    base = (by * w1 + bx).to(torch.int32).reshape(1, -1).repeat(b, 1).contiguous()
    taps = torch.rand(4, b, n * h * w, device=dev, generator=gen)
    src = torch.rand(b, h1, w1, c, device=dev, generator=gen) * 2 - 1
    ref = torch.rand(b, h * w, c, device=dev, generator=gen) * 2 - 1
    return src.to(dtype), base, taps.to(dtype), ref.to(dtype)


# The harder inputs K4 and K5 are held at besides the sweep's own, each
# launched GRAD_CASE_LAUNCHES times: K5's reductions land in another order
# every launch, and so does its rounding.
GRAD_CASES = ("pile_up", "edges", "one_corner")
# one_corner: batch 0's bases in the last 8x8 cells (1.25% of the init
# sweep's cells). On 3x3, its rows alternate among 9 cells, so K5 sums no
# runs and ~73,000 float4 reductions meet on one element: float32 rounding
# alone then spreads its error up to 0.9 of the 1e-5 limit.
CORNER_CELLS = 8
GRAD_CASE_LAUNCHES = 10


def grad_cases(b, n, h, w, h1, w1, c, gen, dev="cuda", dtype=torch.float32):
    """{case: (src, base, taps, ref, grad)} for the backward kernels, from
    `sweep_inputs` and a seeded grad_corr, with the bases replaced:
    pile_up, every row of batch 0 on one cell (the map's centre: the most
    rows that can meet on a cell); edges, every base on the last row or
    the last column, so that +1 corners fall off the map; one_corner,
    batch 0's bases all in the last CORNER_CELLS x CORNER_CELLS cells, so
    that most of its cells get nothing (the other batches as the sweep
    has them). Features and taps in `dtype`."""
    src, base, taps, ref = sweep_inputs(b, n, h, w, h1, w1, c, gen, dev, dtype)
    grad = torch.randn(b, n, GROUPS, h * w, device=dev, generator=gen)
    pile = base.clone()
    pile[0] = (h1 // 2) * w1 + w1 // 2
    r = torch.randint(0, w1 + h1 - 1, base.shape, device=dev, generator=gen)
    edges = torch.where(r < w1, (h1 - 1) * w1 + r, (r - w1) * w1 + w1 - 1).to(torch.int32)
    corner = base.clone()
    dy, dx = (torch.randint(0, CORNER_CELLS, base[0].shape, device=dev, generator=gen)
              for _ in range(2))
    corner[0] = ((h1 - 1 - dy).clamp(min=0) * w1 + (w1 - 1 - dx).clamp(min=0)).to(torch.int32)
    return {name: (src, bases, taps, ref, grad)
            for name, bases in zip(GRAD_CASES, (pile, edges, corner))}


def time_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes, ops, ops_per_s=PEAK_F32_PER_S):
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def kernel_name(name, dtype):
    """A sweep kernel's report name: `name`, or `name_bf16` for its
    bfloat16 form."""
    return name if dtype == torch.float32 else f"{name}_bf16"


def check_kernels(shapes, per="map", dtype=torch.float32):
    """Each forward kernel of `dtype` against its plain version at every
    sweep shape; per shape one JSON line, and per kernel the totals of one
    depth map (or training step, `per`). Keyed by report name. `ms` times
    the bare launch into an output allocated beforehand (a small launch
    through the wrapper waits on the host: `call_ms`)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    k1, k2 = kernel_name("corr_epilogue", dtype), kernel_name("sweep_premul", dtype)
    per_map = {k: {"ms": 0.0, "call_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                   "max_abs_err": 0.0, "library_ms": 0.0, "bytes": 0.0, "ops": 0.0}
               for k in (k2, k1)}
    for name, b, n, h, w, h1, w1, c, launches in shapes:
        hw = h * w
        p = n * hw
        src, base, taps, ref = sweep_inputs(b, n, h, w, h1, w1, c, gen, dtype=dtype)
        size = src.element_size()

        # K2 sweep_premul: products of the same floats in the same order
        # (f32: the tolerance is 1e-6 of the largest value; bf16: each
        # product rounded as the plain version rounds it, so bit for bit).
        got = sweep_premul(src, base, taps, ref, n)
        want = sweep_premul_plain(src, base, taps, ref, n)
        err2 = (got.float() - want.float()).abs().max().item()
        tol2 = 1e-6 * want.abs().max().item() if dtype == torch.float32 else 0.0
        if dtype == BF16 and not torch.equal(got.view(torch.int16), want.view(torch.int16)):
            raise SystemExit(f"{k2} at {name}: bits differ from its plain version")
        nbytes2 = (size * (src.numel() + taps.numel() + ref.numel() + got.numel())
                   + 4 * base.numel())
        ops2 = 2 * got.numel()
        k2 = {"ms": time_ms(lambda: launch_sweep_premul(src, base, taps, ref, got)),
              "call_ms": time_ms(lambda: sweep_premul(src, base, taps, ref, n)),
              "plain_ms": time_ms(lambda: sweep_premul_plain(src, base, taps, ref, n)),
              "library_ms": None}
        k2["bound_ms"], k2["bound_by"] = bound_ms(nbytes2, ops2)

        # K1 corr_epilogue on the real K2 output: a float32 sum of 4*C/G
        # terms in another order than the plain version, so 1e-5 of the
        # largest value in f32 and 1e-6 in bf16 (whose terms are exact in
        # float32). The library call: one matmul in premul's dtype.
        premul = got.reshape(b * p, 4 * c)
        del want
        got1 = corr_epilogue(premul, b * n, GROUPS)
        want1 = corr_epilogue_plain(premul, b * n, GROUPS)
        err1 = (got1 - want1).abs().max().item()
        tol1 = (1e-5 if dtype == torch.float32 else 1e-6) * want1.abs().max().item()
        cg = c // GROUPS
        m4 = torch.from_numpy(np.tile(np.repeat(np.eye(GROUPS), cg, axis=0) / cg,
                                      (4, 1)).T.astype(np.float32)).cuda().to(dtype)
        lib = torch.matmul(premul, m4.T)                       # [P, G]
        err_lib = (lib.T.reshape(GROUPS, b * n, hw).float() - want1).abs().max().item()
        nbytes1 = size * premul.numel() + 4 * got1.numel()
        ops1 = premul.numel() + got1.numel()
        k1 = {"ms": time_ms(lambda: launch_corr_epilogue(premul, got1)),
              "call_ms": time_ms(lambda: corr_epilogue(premul, b * n, GROUPS)),
              "plain_ms": time_ms(lambda: corr_epilogue_plain(premul, b * n, GROUPS)),
              "library_ms": time_ms(lambda: torch.matmul(premul, m4.T))}
        k1["bound_ms"], k1["bound_by"] = bound_ms(nbytes1, ops1)

        for kname, rec, err, tol, nbytes, ops in (
                (kernel_name("sweep_premul", dtype), k2, err2, tol2, nbytes2, ops2),
                (kernel_name("corr_epilogue", dtype), k1, err1, tol1, nbytes1, ops1)):
            line = {"kernel": kname, "shape": name, "batch": b, "n": n, "hw": hw,
                    "src_hw": [h1, w1], "c": c, f"launches_per_{per}": launches,
                    "max_abs_err": err, "tol": tol, **rec,
                    "share": rec["bound_ms"] / rec["ms"]}
            if kname.startswith("corr_epilogue"):
                line["library_max_abs_err"] = err_lib
                line["vs_library"] = rec["ms"] / rec["library_ms"]
            print(json.dumps(line))
            if not err <= tol:
                raise SystemExit(f"{kname} at {name}: max |kernel - plain| {err} > {tol}")
            tot = per_map[kname]
            for key in ("ms", "call_ms", "plain_ms", "bound_ms"):
                tot[key] += launches * rec[key]
            if rec["library_ms"] is None:
                tot["library_ms"] = None
            else:
                tot["library_ms"] += launches * rec["library_ms"]
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
            tot["bytes"] += launches * nbytes
            tot["ops"] += launches * ops
        del src, base, taps, ref, got, premul, got1, want1, lib
        torch.cuda.empty_cache()
    return per_map


# The bf16 forward kernels' edge cases, on a small source map.
FWD_EDGE_MAP = (7, 9)


def bf16_fwd_tiles(c, groups=GROUPS):
    """Rows per block at C channels: K2 bf16 (pixels of one sample, 256
    threads of C/8 lanes) and K1 bf16 (256 threads of lcm(8, C/G)
    channels)."""
    return 256 // (c // 8), 256 * math.lcm(8, c // groups) // c


def fwd_edge_inputs(b, n, hw, c, gen, bases="random", dev="cuda"):
    """bf16 K2 inputs on a FWD_EDGE_MAP source: bases drawn over the map
    ("random"), on its last row or column ("edges": +1 corners fall off
    it), or random with every 5th row below 0 and every 5th one past the
    map ("off_map")."""
    h1, w1 = FWD_EDGE_MAP
    src = (torch.rand(b, h1, w1, c, device=dev, generator=gen) * 2 - 1).to(BF16)
    ref = (torch.rand(b, hw, c, device=dev, generator=gen) * 2 - 1).to(BF16)
    taps = torch.rand(4, b, n * hw, device=dev, generator=gen).to(BF16)
    base = torch.randint(0, h1 * w1, (b, n * hw), device=dev, generator=gen)
    if bases == "edges":
        r = torch.randint(0, w1 + h1 - 1, base.shape, device=dev, generator=gen)
        base = torch.where(r < w1, (h1 - 1) * w1 + r, (r - w1) * w1 + w1 - 1)
    elif bases == "off_map":
        base[:, ::5] = -1
        base[:, 1::5] = h1 * w1
    return src, base.to(torch.int32).contiguous(), taps, ref


def hold_fwd_edge(label, src, base, taps, ref, n):
    """K2 bf16, then K1 bf16 on its output, against their plain versions:
    K2 bit for bit, NaN in every row whose base is off the map (the plain
    version runs on those rows' bases moved onto the map); K1 within 1e-6
    of max|plain|, NaN where its row is. Prints one JSON line."""
    b, h1, w1, c = src.shape
    off = (base < 0) | (base >= h1 * w1)
    got = sweep_premul(src, base, taps, ref, n)
    want = sweep_premul_plain(src, torch.where(off, 0, base), taps, ref, n)
    rows_nan = got.float().isnan()
    if not (torch.equal(rows_nan.all(-1), off) and not rows_nan[~off].any()):
        raise SystemExit(f"sweep_premul_bf16 at {label}: NaN rows are not the off-map rows")
    if not torch.equal(got[~off].view(torch.int16), want[~off].view(torch.int16)):
        raise SystemExit(f"sweep_premul_bf16 at {label}: bits differ from its plain version")
    premul = got.reshape(-1, 4 * c)
    got1 = corr_epilogue(premul, b * n, GROUPS)
    want1 = corr_epilogue_plain(premul, b * n, GROUPS)
    nan1 = want1.isnan()
    err = (got1 - want1)[~nan1].abs().max().item()
    tol = 1e-6 * want1[~nan1].abs().max().item()
    if not (torch.equal(got1.isnan(), nan1) and err <= tol):
        raise SystemExit(f"corr_epilogue_bf16 at {label}: max |kernel - plain| {err} > {tol} "
                         "or NaN elsewhere than the plain version's")
    print(json.dumps({"edge_case": label, "batch": b, "n": n, "hw": ref.shape[1], "c": c,
                      "off_map_rows": int(off.sum()), "sweep_premul_bf16": "bit-equal",
                      "corr_epilogue_bf16_max_abs_err": err, "tol": tol}))


def check_fwd_edge_cases():
    """K2 bf16 and K1 bf16 at their edges, small and cheap: K2 at one
    pixel per sample, one past a whole block and one short of one, at C =
    16 and 48; every base on the map's last row or column; bases off the
    map; C = 8 and 256, the wrapper's limits; then K1 alone at one row,
    one past a whole block and one short of one, at C = 16, 32 and 48."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 2)
    cases = []
    for c in (16, 48):
        run = bf16_fwd_tiles(c)[0]
        for hw in (1, run - 1, run + 1):
            cases.append((f"ragged C={c} hw={hw}", 2, 2, hw, c, "random"))
        cases.append((f"edges C={c}", 2, 3, 300, c, "edges"))
        cases.append((f"off_map C={c}", 2, 3, 300, c, "off_map"))
    for c in (8, 256):
        cases.append((f"C={c}", 2, 3, 300, c, "random"))
        cases.append((f"edges C={c}", 1, 2, 300, c, "edges"))
    for label, b, n, hw, c, bases in cases:
        hold_fwd_edge(label, *fwd_edge_inputs(b, n, hw, c, gen, bases), n)
    for c in (16, 32, 48):
        tile = bf16_fwd_tiles(c)[1]
        for rows in (1, tile - 1, tile + 1):
            premul = (torch.rand(rows, 4 * c, device="cuda", generator=gen) * 2 - 1).to(BF16)
            got = corr_epilogue(premul, 1, GROUPS)
            want = corr_epilogue_plain(premul, 1, GROUPS)
            err = (got - want).abs().max().item()
            tol = 1e-6 * want.abs().max().item()
            print(json.dumps({"edge_case": f"K1 ragged C={c} rows={rows}", "c": c,
                              "corr_epilogue_bf16_max_abs_err": err, "tol": tol}))
            if not err <= tol:
                raise SystemExit(f"corr_epilogue_bf16 at {rows} rows, C={c}: {err} > {tol}")


def valid_corners(base, h1, w1):
    """Per row, the count of its 4 corners that lie on the source map."""
    y, x = base // w1, base % w1
    return 1 + (x + 1 < w1).int() + (y + 1 < h1).int() + ((x + 1 < w1) & (y + 1 < h1)).int()


def hold_grad(kname, got, want, label):
    """(max |err|, max|plain|) of a backward kernel's result, or SystemExit
    where |err| exceeds 1e-5 of max|plain| (the kernels sum the same
    products in another order than the plain versions) plus, for a bf16
    result, one bf16 step of |plain| (each side rounds its float32 sum
    once, so the two may round apart)."""
    diff = (got.float() - want.float()).abs()
    scale = want.abs().max().item()
    step = BF16_STEP if got.dtype == BF16 else 0.0
    bound = 1e-5 * scale + step * want.float().abs()
    if not bool((diff <= bound).all()):
        worst = (diff - bound).argmax()
        raise SystemExit(f"{kname} at {label}: |kernel - plain| {diff.flatten()[worst]} > "
                         f"1e-5 * {scale} + {step} * |plain| at flat index {int(worst)}")
    return diff.max().item(), scale


def grad_launchers(src, base, taps, ref, grad, d_ref, d_src, scratch=None):
    """{kernel: bare launch of K4 / K5 into the preallocated d_ref / d_src}
    (bf16 K5: summing into the float32 `scratch`)."""
    return {"sweep_grad_ref": lambda: launch_sweep_grad_ref(src, base, taps, grad, d_ref),
            "sweep_grad_src": lambda: launch_sweep_grad_src(ref, base, taps, grad, d_src,
                                                            scratch)}


def repeats_equal(launch, out):
    """Whether two launches on the same inputs write the same bits."""
    launch()
    first = out.clone()
    launch()
    torch.cuda.synchronize()
    return torch.equal(first, out)


# The source window a block of a bf16 backward kernel would keep in shared
# memory: a block's source cells, copied in (K4) or summed into (K5) there.
# Both forms measured slower than the kernels as they are (PERF.md §6), so
# neither kernel has one; chip_smoke prints what such windows would span on
# every input. Per kernel: the channels of a thread's lane and the bytes a
# window cell takes per channel; the budget they were measured at.
WINDOW_LANES = {"sweep_grad_ref_bf16": (8, 2), "sweep_grad_src_bf16": (4, 4)}
WINDOW_BUDGET = 32 * 1024


def record_pixels(c, lane):
    """The pixels of a block of the backward kernels (RecordTiles in
    csrc/sweep_records.cuh, RowTiles in csrc/grad_rows.cuh): a power of
    two, at most 32, with at most 256 threads of C/lane lanes."""
    pt = 1
    while 2 * pt <= 32 and 2 * pt * (c // lane) <= 256:
        pt *= 2
    return pt


def block_windows(base, b, n, hw, pt, h1, w1, taps=None):
    """Window cells per block [b * ceil(hw / pt)]: the box of the base
    cells (y, x) of the block's rows (samples 0..n-1 of pixels
    pt*t..pt*t+pt-1 of one batch) whose base lies on the map and, where
    `taps` [4, b, n*hw] is given, with a tap that is not zero (a row whose
    taps are all zero adds nothing: the sweep clamps off-image samples to
    an edge cell with zero taps), grown by one row and one column for the
    +1 corners, clipped to the map; 0 for a block without such rows."""
    tiles = -(-hw // pt)
    base = base.reshape(b, n, hw).long()
    keep = (base >= 0) & (base < h1 * w1)
    if taps is not None:
        keep &= (taps.reshape(4, b, n, hw) != 0).any(dim=0)
    pad = tiles * pt - hw
    base = torch.nn.functional.pad(base, (0, pad)).reshape(b, n, tiles, pt)
    keep = torch.nn.functional.pad(keep, (0, pad)).reshape(b, n, tiles, pt)
    y, x = base // w1, base % w1
    big = h1 * w1

    def lo(v):
        return torch.where(keep, v, big).amin(dim=(1, 3))

    def hi(v):
        return torch.where(keep, v, -1).amax(dim=(1, 3))

    y0, x0, y1, x1 = lo(y), lo(x), hi(y), hi(x)
    h = (y1 + 1).clamp(max=h1 - 1) - y0 + 1
    w = (x1 + 1).clamp(max=w1 - 1) - x0 + 1
    return torch.where(y1 >= 0, h * w, 0).reshape(-1)


def window_fit_shares(base, taps, b, n, hw, h1, w1, c):
    """{bf16 backward kernel: the share of its blocks whose window has rows
    and fits WINDOW_BUDGET} for one set of inputs."""
    out = {}
    for kname, (lane, nbytes) in WINDOW_LANES.items():
        cells = block_windows(base, b, n, hw, record_pixels(c, lane), h1, w1, taps)
        out[kname] = float(((cells > 0) & (cells * c * nbytes <= WINDOW_BUDGET)).float().mean())
    return out


def check_grad_kernels(shapes, rounds=5, reps=20, dtype=torch.float32):
    """K4 sweep_grad_ref and K5 sweep_grad_src (their forms for features
    of `dtype`; keyed by report name) against their plain versions at
    every sweep shape, with seeded taps and indices (edge corners
    included) and a seeded grad_corr, through the wrappers and through
    their bare launches. One JSON line per (kernel, shape): `ms` the
    kernel's device time, the median of `rounds` rounds of `reps` bare
    launches (K5's zero fill included, outputs allocated beforehand),
    `call_ms` the wrapper's; per kernel the totals of one step (each
    shape's line times its launches). K4 sums in a fixed order and must
    repeat bit for bit; K5's float4 reductions land in an order that
    changes, and its line says whether two launches agreed. Then the
    GRAD_CASES (pile-up, edges, one corner) at the init and level-1
    shapes, GRAD_CASE_LAUNCHES launches each, every one held against the
    plain versions in float64 (the float32 plain version's own sum of the
    pile-up's 163,840 rows on one cell is ~1.4e-5 of the largest value off
    the exact one: its line gives that control beside the kernels' largest
    and smallest error; for bf16, the float64 sums rounded once to bf16),
    and a base index outside the source map must give NaN in d_ref (K4)
    and in d_src (K5)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 1)
    names = {k: kernel_name(k, dtype) for k in ("sweep_grad_ref", "sweep_grad_src")}
    per_step = {names[k]: {"ms": 0.0, "call_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                           "max_rel_err": 0.0, "max_abs_err": 0.0, "bytes": 0.0,
                           "ops": 0.0, "launches": 0}
                for k in ("sweep_grad_ref", "sweep_grad_src")}

    def hold_repeats(kname, run, out, label):
        equal = repeats_equal(run, out)
        if kname == "sweep_grad_ref" and not equal:
            raise SystemExit(f"{names[kname]} at {label}: two launches on the same inputs "
                             "differ")
        return equal

    def outputs(b, hw, h1, w1, c):
        """(d_ref, d_src, K5's float32 scratch or None), preallocated."""
        return (torch.empty(b, hw, c, device="cuda", dtype=dtype),
                torch.empty(b, h1, w1, c, device="cuda", dtype=dtype),
                None if dtype == torch.float32
                else torch.empty(b, h1, w1, c, device="cuda"))

    for name, b, n, h, w, h1, w1, c, launches in shapes:
        size = torch.tensor([], dtype=dtype).element_size()
        launches = launches // len(sample_chunks(b, n, h * w, c, itemsize=size))  # per sweep
        src, base, taps, ref = sweep_inputs(b, n, h, w, h1, w1, c, gen, dtype=dtype)
        grad = torch.randn(b, n, GROUPS, h * w, device="cuda", generator=gen)
        d_ref, d_src, scratch = outputs(b, h * w, h1, w1, c)
        outs = {"sweep_grad_ref": d_ref, "sweep_grad_src": d_src}
        bare = grad_launchers(src, base, taps, ref, grad, d_ref, d_src, scratch)
        # 1 + 2 flops per valid corner and channel (the tap products and
        # their sum, the g' product and the accumulation), per row.
        ops = float(c * (1 + 2 * valid_corners(base, h1, w1).sum().item()))
        nbytes = (4 * (base.numel() + grad.numel())
                  + size * (taps.numel() + src.numel() + ref.numel()))
        for kname, call, plain in (
                ("sweep_grad_ref", lambda: sweep_grad_ref(src, base, taps, grad),
                 lambda: sweep_grad_ref_plain(src, base, taps, grad)),
                ("sweep_grad_src", lambda: sweep_grad_src(ref, base, taps, grad, h1, w1),
                 lambda: sweep_grad_src_plain(ref, base, taps, grad, h1, w1))):
            want = plain()
            err, scale = hold_grad(kname, call(), want, name)
            bare[kname]()
            hold_grad(kname, outs[kname], want, f"{name}, bare launch")
            del want
            ms, ms_min, ms_max = median_ms(bare[kname], rounds, reps)
            rec = {"ms": ms, "ms_min": ms_min, "ms_max": ms_max,
                   "call_ms": median_ms(call, rounds, reps)[0],
                   "plain_ms": time_ms(plain, reps=3), "library_ms": None,
                   "repeats_bit_equal": hold_repeats(kname, bare[kname], outs[kname], name)}
            rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes, ops)
            line = {"kernel": names[kname], "shape": name, "batch": b, "n": n, "hw": h * w,
                    "src_hw": [h1, w1], "c": c, "launches_per_step": launches,
                    "max_abs_err": err, "max_rel_err": err / scale, "tol_rel": 1e-5,
                    "share_of_bound": rec["bound_ms"] / rec["ms"], **rec}
            if names[kname] in WINDOW_LANES:
                line["window_fit_share"] = window_fit_shares(base, taps, b, n, h * w, h1, w1,
                                                             c)[names[kname]]
            print(json.dumps(line))
            tot = per_step[names[kname]]
            tot.setdefault("ms_by_shape", {})[name] = rec["ms"]
            for key in ("ms", "call_ms", "plain_ms", "bound_ms"):
                tot[key] += launches * rec[key]
            tot["max_rel_err"] = max(tot["max_rel_err"], err / scale)
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
            tot["bytes"] += launches * nbytes
            tot["ops"] += launches * ops
            tot["launches"] += launches
        del src, base, taps, ref, grad, outs, bare, d_ref, d_src, scratch
        torch.cuda.empty_cache()

    # The harder inputs, at the init sweep's shape (n = 32) and level 1's.
    for name, b, n, h, w, h1, w1, c, _ in shapes[:2]:
        for case, (src, base, taps, ref, grad) in grad_cases(
                b, n, h, w, h1, w1, c, gen, dtype=dtype).items():
            d_ref, d_src, scratch = outputs(b, h * w, h1, w1, c)
            outs = {"sweep_grad_ref": d_ref, "sweep_grad_src": d_src}
            bare = grad_launchers(src, base, taps, ref, grad, d_ref, d_src, scratch)
            exact = {"sweep_grad_ref": sweep_grad_ref_plain(
                         src.double(), base, taps.double(), grad.double()).to(dtype),
                     "sweep_grad_src": sweep_grad_src_plain(
                         ref.double(), base, taps.double(), grad.double(), h1, w1).to(dtype)}
            plain = {"sweep_grad_ref": lambda: sweep_grad_ref_plain(src, base, taps, grad),
                     "sweep_grad_src": lambda: sweep_grad_src_plain(ref, base, taps, grad,
                                                                    h1, w1)}
            rec = {"grad_case": case, "dtype": str(dtype), "shape": name,
                   "most_rows_on_a_cell": int(
                torch.unique(base[0], return_counts=True)[1].max()),
                "launches": GRAD_CASE_LAUNCHES, "max_rel_err": {}, "min_rel_err": {},
                "plain_f32_rel_err": {}, "ms": {}, "repeats_bit_equal": {}}
            if dtype == BF16:
                rec["window_fit_share"] = window_fit_shares(base, taps, b, n, h * w, h1, w1, c)
            for kname, run in bare.items():
                errs = []
                for _ in range(GRAD_CASE_LAUNCHES):
                    run()
                    err, scale = hold_grad(kname, outs[kname], exact[kname], f"{name}, {case}")
                    errs.append(err / scale)
                rec["max_rel_err"][kname], rec["min_rel_err"][kname] = max(errs), min(errs)
                # The control: the plain version (float32 sums) against float64.
                rec["plain_f32_rel_err"][kname] = (
                    plain[kname]().float() - exact[kname].float()).abs().max().item() / scale
                rec["repeats_bit_equal"][kname] = hold_repeats(
                    kname, run, outs[kname], f"{name}, {case}")
                rec["ms"][kname] = time_ms(run, reps=3)
            print(json.dumps(rec))
            del src, base, taps, ref, grad, outs, bare, exact, plain, d_ref, d_src, scratch
        torch.cuda.empty_cache()

    # An upstream fault must show, not be skipped.
    src, base, taps, ref = sweep_inputs(1, 2, 8, 8, 8, 8, 16, gen, dtype=dtype)
    grad = torch.randn(1, 2, GROUPS, 64, device="cuda", generator=gen)
    base[0, 5] = 64
    faults = {"d_ref_nan": bool(sweep_grad_ref(src, base, taps, grad).isnan().any()),
              "d_src_nan": bool(sweep_grad_src(ref, base, taps, grad, 8, 8).isnan().any())}
    print(json.dumps({"sweep_grad_fault_check": faults, "dtype": str(dtype)}))
    if not all(faults.values()):
        raise SystemExit(f"a base index outside the source map did not show: {faults}")
    return per_step


# ---------------------------------------------------------------- fusion
# The settings eval.py fuses a custom scene with.
FUSION = dict(geo_pixel_thres=1.0, geo_depth_thres=0.01, photo_thres=0.3,
              geo_mask_thres=3)
# f32 instructions the function of K3 needs, counted from
# csrc/fusion_consistency.cu with each a*b+c as one FMA (the kernel itself
# keeps them apart to match its plain version's rounding). No card divides
# or takes a root in one instruction: an IEEE divide or sqrt counts at the
# arithmetic of its fast path in the kernel's sm_90a SASS (cuobjdump -sass
# of the built library, nvcc 12.8). A divide, 7: MUFU.RCP, 5 FFMA
# (reciprocal refined, quotient, remainder, corrected quotient), FCHK. A
# sqrt, 5: MUFU.RSQ, 2 FMUL, 2 FFMA. The kernel issues 10 for each: the
# branch around the slow path adds BSSY, the branch and BSYNC, and the
# sqrt's range check IADD3 + ISETP; that is the kernel's control flow, not
# the function's work, so `bound_ms` leaves it out and `bound_ms_issued`
# counts it. Per (pixel, source), besides 5 divides and 1 sqrt: ref->src
# 9, K_src 9, axis taps 12 + corner weights 4 + corner sum 4, K_src^-1
# times the sample 9, src->ref 9, K_ref + 1e-6 10, dist 4, relative 2,
# tests and sums 4. Per pixel, besides 1 divide: the back-projection 9,
# the average 2, the bits 2. They issue at the FMA rate, half the FLOP
# rate.
K3_DIV_INSTR, K3_DIV_INSTR_ISSUED = 7, 10
K3_SQRT_INSTR, K3_SQRT_INSTR_ISSUED = 5, 10
PEAK_F32_INSTR_PER_S = PEAK_F32_PER_S / 2
# K3 is also held at no source, one source, a size whose width is no
# multiple of a block, and the most sources, whose record needs more than
# 48 KB of shared memory: (width, height, S).
K3_EDGE_CASES = ((WIDTH, HEIGHT, 0), (WIDTH, HEIGHT, 1),
                 (WIDTH - 1, HEIGHT - 1, VIEWS - 1), (160, 120, MAX_SOURCES))


def k3_instructions(width, height, sources, div=K3_DIV_INSTR, sqrt=K3_SQRT_INSTR):
    """f32 instructions of K3's function on one view (see K3_DIV_INSTR)."""
    return width * height * (sources * (76 + 5 * div + sqrt) + 13 + div)


def consistency_inputs(width, height, sources, seed, device):
    """K3's arguments for reference view 0 of the plane scene
    (`make_cameras(sources + 1, ...)`, analytic depths) with planted cases:
    reference pixels of depth 0, -1 and 1e-6 (a reprojected z near the
    1e-6 of the second divide); the last source moved 50 units sideways,
    so that every projection into it leaves the image; a seeded
    confidence in [0, 0.6) with some pixels exactly at the 0.3 threshold."""
    rng = np.random.RandomState(seed)
    cams = make_cameras(sources + 1, width, height, rng)
    depths = [_plane_hit(K, E, width, height)[1] for K, E in cams]
    ref = depths[0].copy()
    ref[:8, :8] = 0.0
    ref[height // 2, width // 4:width // 4 + 16] = -1.0
    ref[height // 3, width // 3:width // 3 + 16] = 1e-6
    conf = rng.uniform(0.0, 0.6, (height, width)).astype(np.float32)
    conf[::97, ::89] = np.float32(FUSION["photo_thres"])
    src_cams = [(K, E.copy()) for K, E in cams[1:]]
    if sources:
        src_cams[-1][1][0, 3] += 50.0
    mats = consistency_matrices(cams[0][0], cams[0][1], [K for K, _ in src_cams],
                                [E for _, E in src_cams])
    maps = (torch.from_numpy(ref), torch.from_numpy(conf),
            torch.from_numpy(np.array(depths[1:], np.float32).reshape(sources, height, width)))
    return tuple(t.to(device) for t in maps + mats)


def compare_consistency(got, want):
    """(share of pixels with equal bits, max |depth_avg diff| over them)."""
    equal = got[1] == want[1]
    share = equal.float().mean().item()
    err = (got[0] - want[0]).abs()[equal].max().item() if share else float("inf")
    return share, err


def host_matrices(inputs):
    """K3's arguments with the matrices moved to the host, where fusion
    (`fuse_views`) has them."""
    return inputs[:3] + tuple(m.cpu() for m in inputs[3:])


def hold_consistency(inputs, want, label):
    """K3 through the wrapper (matrices on the host, as in fusion) and
    launched on a record built on the card, each bit-equal to the plain
    version's `want` or SystemExit (the kernel repeats the plain version's
    IEEE operations in its order). Returns (the wrapper's result, the
    device record, the wrapper's (bits equal share, max |err|))."""
    ref, conf, src, r2s, s2r, k_ref, k_ref_inv, k_srcs, k_srcs_inv = inputs
    got = consistency(*host_matrices(inputs), **FUSION)
    params = record(k_ref, k_ref_inv, r2s, k_srcs, k_srcs_inv, s2r)
    checks = {"wrapper": compare_consistency(got, want),
              "device record": compare_consistency(
                  launch_consistency(ref, conf, src, params, **FUSION), want)}
    bad = {k: v for k, v in checks.items() if v != (1.0, 0.0)}
    if bad:
        raise SystemExit(f"fusion_consistency at {label}: (bits equal share, max |err|) "
                         f"{bad}, want (1.0, 0.0)")
    return got, params, checks["wrapper"]


def median_ms(fn, rounds, reps):
    """(median, min, max) over `rounds` rounds of `time_ms(fn, reps)`."""
    times = sorted(time_ms(fn, reps=reps) for _ in range(rounds))
    return times[rounds // 2], times[0], times[-1]


def check_consistency(width, height, sources_list, rounds=7, reps=100):
    """K3 against its plain version on the card, bit for bit: first at
    K3_EDGE_CASES, then at width x height for each source count, one JSON
    line each. `ms` is the kernel's time, the median of `rounds` rounds of
    `reps` launches on a record already on the card (the spread of the
    rounds is in the line); `call_ms` times the wrapper the same way, with
    the matrices on the host as fusion passes them, so record build and
    upload included. Returns {sources: record}."""
    for w, h, sources in K3_EDGE_CASES:
        inputs = consistency_inputs(w, h, sources, SEED, "cuda")
        _, _, (share, err) = hold_consistency(
            inputs, consistency_plain(*inputs, **FUSION), f"{w}x{h}, {sources} sources")
        print(json.dumps({"kernel": "fusion_consistency", "size": [w, h],
                          "sources": sources, "bits_equal_share": share,
                          "max_abs_err": err}))
        del inputs
    records = {}
    for sources in sources_list:
        inputs = consistency_inputs(width, height, sources, SEED, "cuda")
        host = host_matrices(inputs)
        want = consistency_plain(*inputs, **FUSION)
        got, params, (share, err) = hold_consistency(
            inputs, want, f"{width}x{height}, {sources} sources")
        p = width * height
        nbytes = 4 * (2 * p + sources * p + p) + p
        instr = k3_instructions(width, height, sources)
        ms, ms_min, ms_max = median_ms(
            lambda: launch_consistency(*inputs[:3], params, **FUSION), rounds, reps)
        rec = {"kernel": "fusion_consistency", "size": [width, height],
               "sources": sources, "bits_equal_share": share, "max_abs_err": err,
               "geo_share": ((got[1] & 2) > 0).float().mean().item(),
               "ms": ms, "ms_min": ms_min, "ms_max": ms_max, "rounds": rounds,
               "reps": reps,
               "call_ms": median_ms(lambda: consistency(*host, **FUSION), rounds, reps)[0],
               "plain_ms": time_ms(lambda: consistency_plain(*inputs, **FUSION), reps=5),
               "library_ms": None, "bytes": nbytes, "f32_instructions": instr}
        rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes, instr, PEAK_F32_INSTR_PER_S)
        rec["share_of_bound"] = rec["bound_ms"] / ms
        rec["bound_ms_issued"] = bound_ms(nbytes, k3_instructions(
            width, height, sources, K3_DIV_INSTR_ISSUED, K3_SQRT_INSTR_ISSUED),
            PEAK_F32_INSTR_PER_S)[0]
        print(json.dumps(rec))
        records[sources] = rec
        del inputs, host, got, want, params
        torch.cuda.empty_cache()
    return records


def fusion_views(cams, depths, confidences, images):
    """`MemoryViews` of a rendered scene: uint8 images become [0,1] RGB."""
    return MemoryViews({v: dict(K=K, E=E, depth=d, confidence=c,
                                image=img.astype(np.float32) / np.float32(255.0))
                        for v, ((K, E), d, c, img)
                        in enumerate(zip(cams, depths, confidences, images))})


def fuse_scene(views, outdir, device):
    """Fuse every view of `views` against all the others with `FUSION`;
    reads the PLY back and checks the mask files. Returns a record with
    the points, the wall and per-phase seconds and |z - Z0| of the cloud."""
    vids = sorted(views.views)
    pairs = [(v, [s for s in vids if s != v]) for v in vids]
    ply = os.path.join(outdir, "fused.ply")
    n, secs, phases = fuse_views(views, pairs, outdir, ply, **FUSION,
                                 verbose=False, device=device)
    xyz, rgb = read_ply(ply)
    if xyz.shape[0] != n or rgb is None:
        raise SystemExit(f"{ply}: {xyz.shape[0]} vertices read, {n} written")
    missing = [f"{v:0>8}_{k}.png" for v in vids for k in ("photo", "geo", "final")
               if not os.path.exists(os.path.join(outdir, "mask", f"{v:0>8}_{k}.png"))]
    if missing:
        raise SystemExit(f"fusion wrote no mask files {missing}")
    h, w = views.views[vids[0]]["depth"].shape
    dz = np.abs(xyz[:, 2] - Z0)
    return {"views": len(vids), "points": n, "pixel_share": n / (len(vids) * h * w),
            "median_abs_z_minus_z0": float(np.median(dz)) if n else None,
            "max_abs_z_minus_z0": float(dz.max()) if n else None,
            "seconds": secs, "phases_thread_s": phases}


# ------------------------------------------------------------ end to end
SWEEP_KERNELS = (sweep_premul, corr_epilogue, sweep_grad_ref, sweep_grad_src)
# Every kernel's report name, float32 forms first.
KERNEL_NAMES = ("sweep_premul", "corr_epilogue", "fusion_consistency", "sweep_grad_ref",
                "sweep_grad_src", "sweep_premul_bf16", "corr_epilogue_bf16",
                "sweep_grad_ref_bf16", "sweep_grad_src_bf16")


def launch_counts():
    """{report name: launches} of all nine kernels."""
    counts = {"fusion_consistency": consistency.launches}
    for fn in SWEEP_KERNELS:
        counts[fn.__name__] = fn.launches
        counts[f"{fn.__name__}_bf16"] = fn.launches_bf16
    return {k: counts[k] for k in KERNEL_NAMES}


def planned_counts(**launches):
    """`launches` for the named kernels, 0 for every other."""
    return {k: launches.get(k, 0) for k in KERNEL_NAMES}


def reset_launch_counts():
    consistency.launches = 0
    for fn in SWEEP_KERNELS:
        fn.launches = fn.launches_bf16 = 0


def _category(name):
    if "round_to_bf16" in name:           # sweep_grad_src_bf16's rounding pass
        return "sweep_grad_src_bf16"
    for fn in SWEEP_KERNELS:
        if f"{fn.__name__}_bf16" in name:
            return f"{fn.__name__}_bf16"
    for fn in SWEEP_KERNELS:
        if fn.__name__ in name:
            return fn.__name__
    if "Memcpy" in name or "Memset" in name:
        return "memcpy"
    if "bn_" in name or "batch_norm" in name:
        return "batch_norm"
    if any(s in name for s in ("conv", "xmma", "gemm", "wgrad", "dgrad")):
        return "convolution"
    if any(s in name for s in ("multi_tensor", "foreach", "adam", "Adam")):
        return "optimizer"
    return "other"


def device_time(fn):
    """Run `fn` under torch.profiler: ({kernel name: (calls, us)},
    {category: us}, busy ms) of the device events (kernels and copies)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name, by_cat = {}, {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        calls, total = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (calls + 1, total + us)
        cat = _category(e.name)
        by_cat[cat] = by_cat.get(cat, 0.0) + us
    return by_name, by_cat, sum(by_cat.values()) / 1e3


def profile_maps(model, samples, outdir, unprofiled_wall):
    """Device time by kernel over the same maps as the timed run
    (torch.profiler, kernel and copy events only). The idle share is
    taken against the timed run's own wall time, since tracing slows the
    host."""
    by_name, by_cat, busy_ms = device_time(
        lambda: run_depth(model, samples, outdir, "cuda", log=lambda *_: None))
    if not busy_ms:
        print(json.dumps({"profile": "device time not measured"}))
        return
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    maps = len(samples)
    print(json.dumps({
        "profile_maps": maps, "dtype": str(model.compute_dtype),
        "device_busy_ms_per_map": busy_ms / maps,
        "wall_ms_per_map_unprofiled": unprofiled_wall * 1e3 / maps,
        "device_idle_share": max(0.0, 1 - busy_ms / (unprofiled_wall * 1e3)),
        "by_category_ms_per_map": {k: v / 1e3 / maps for k, v in
                                   sorted(by_cat.items(), key=lambda kv: -kv[1])},
        "top_ms_per_map": [{"name": k[:90], "calls_per_map": c / maps,
                            "device_ms": t / 1e3 / maps} for k, (c, t) in top]}))


# -------------------------------------------------------------- training
def train_sample(width, height, views, batch, seed):
    """One collated batch of the training loader's layout, made in memory
    from the plane scene: reference views 0..batch-1, each with all other
    views as sources; GT depth the analytic depth (every 2^l-th pixel at
    level l, the loader's INTER_NEAREST pyramid), masks all valid, depth
    range [DEPTH_MIN, DEPTH_MAX]."""
    if batch > views:
        raise ValueError(f"a batch of {batch} distinct references needs {batch} views")
    cams, images, depths = render_scene(width, height, views, seed)
    refs = samples_of(cams, images)[:batch]
    gt = np.stack(depths[:batch])
    return {
        "imgs": {"level_0": np.concatenate([r["imgs"]["level_0"] for r in refs])},
        "proj_matrices": {k: np.concatenate([r["proj_matrices"][k] for r in refs])
                          for k in refs[0]["proj_matrices"]},
        "depth": {f"level_{l}": gt[:, ::2 ** l, ::2 ** l, None] for l in range(4)},
        "mask": {f"level_{l}": np.ones_like(gt[:, ::2 ** l, ::2 ** l, None])
                 for l in range(4)},
        "depth_min": np.full(batch, DEPTH_MIN, np.float32),
        "depth_max": np.full(batch, DEPTH_MAX, np.float32),
    }


def step_gradients(device, sample, iteration):
    """(loss, {name: gradient on the host}) of one stage-2 training forward
    and backward on `device`, from the DTU weights."""
    model = load_npz_weights(Pipeline(iteration=iteration, test=False),
                             pretrained_path("dtu")).to(device)
    model.train()
    loss, _ = forward_loss(model, to_device_batch(sample, device), True)
    loss.backward()
    return loss.item(), {k: p.grad.cpu() for k, p in model.named_parameters()
                         if p.grad is not None}


def compare_train_step():
    """The train step on the card (K1, K2, K4, K5, cuDNN) against the
    same step on the CPU (plain versions): loss within 1e-4 relative,
    the gradient of all parameters within 1e-3 relative L2 (cuDNN and the
    atomics sum in other orders; a near-tie of an argmax or of the
    view-weight maximum, flipped by that noise, moves a gradient further
    than the loss)."""
    cfg = SMALL_TRAIN
    sample = train_sample(cfg["width"], cfg["height"], cfg["views"], cfg["batch"], SEED)
    loss_cpu, g_cpu = step_gradients("cpu", sample, cfg["iteration"])
    loss_gpu, g_gpu = step_gradients("cuda", sample, cfg["iteration"])
    if set(g_cpu) != set(g_gpu):
        raise SystemExit(f"train step: parameters with gradients differ: "
                         f"{sorted(set(g_cpu) ^ set(g_gpu))}")
    diff2 = sum(float((g_gpu[k] - g_cpu[k]).pow(2).sum()) for k in g_cpu)
    norm2 = sum(float(g.pow(2).sum()) for g in g_cpu.values())
    per_tensor = sorted(((float((g_gpu[k] - g_cpu[k]).norm() / g_cpu[k].norm()), k)
                         for k in g_cpu if float(g_cpu[k].norm()) > 1e-6 * norm2 ** 0.5),
                        reverse=True)
    rec = {"train_step_card_vs_cpu": {**cfg, "loss_cpu": loss_cpu, "loss_gpu": loss_gpu,
                                      "loss_rel": abs(loss_gpu - loss_cpu) / abs(loss_cpu),
                                      "grad_rel_l2": (diff2 / norm2) ** 0.5,
                                      "worst_tensors_rel_l2": per_tensor[:3]}}
    print(json.dumps(rec))
    r = rec["train_step_card_vs_cpu"]
    if not (r["loss_rel"] <= 1e-4 and r["grad_rel_l2"] <= 1e-3):
        raise SystemExit(f"train step on the card disagrees with the CPU: {r}")


def sweeps_of(shapes, dtype):
    """{shape name: its sweeps in one pass} for sweep kernels of `dtype`
    (a shape's forward kernels launch once per chunk of a sweep)."""
    size = torch.tensor([], dtype=dtype).element_size()
    return {s[0]: s[-1] // len(sample_chunks(*s[1:3], s[3] * s[4], s[7], itemsize=size))
            for s in shapes}


def planned_step_counts(shapes, dtype):
    """Launches of each kernel in one training step at `shapes` (the
    sweep kernels of `dtype`: one forward pair per chunk, one backward
    pair per sweep)."""
    forward = sum(s[-1] for s in shapes)
    sweeps = sum(sweeps_of(shapes, dtype).values())
    return planned_counts(**{kernel_name(k, dtype): n for k, n in (
        ("sweep_premul", forward), ("corr_epilogue", forward), ("sweep_grad_ref", sweeps),
        ("sweep_grad_src", sweeps))})


def capture_sweeps(model, batch, iteration):
    """One stage-2 training forward and backward of `model` on the device
    batch `batch` (no optimizer step; the parameters' gradients are
    cleared after it), with every sweep's backward inputs captured: a list
    in call order of (src, ref, base [B, n*HW], taps [4, B, n*HW],
    grad_corr [B, n, G, HW]) as `SweepCorr` hands them to K4 and K5.
    `SweepCorr.apply` is wrapped for this call only."""
    captured = []

    class Capture:
        @staticmethod
        def apply(src, ref, flat_idx, taps, groups):
            out = SweepCorr.apply(src, ref, flat_idx, taps, groups)
            b, n, hw = flat_idx.shape
            rec = [src.detach(), ref.detach(), flat_idx.reshape(b, n * hw).contiguous(),
                   taps.reshape(4, b, n * hw).contiguous(), None]
            out.register_hook(lambda g: rec.__setitem__(4, g.detach().contiguous()))
            captured.append(rec)
            return out

    model.train()
    itermvs_model.SweepCorr = Capture
    try:
        loss, _ = forward_loss(model, batch, True)
        loss.backward()
    finally:
        itermvs_model.SweepCorr = SweepCorr
    model.zero_grad(set_to_none=True)
    if any(r[4] is None for r in captured):
        raise SystemExit("a captured sweep got no gradient")
    return [tuple(r) for r in captured]


def check_real_sweeps(captures, shapes, dtype, synthetic_ms=None):
    """K4 and K5 of `dtype` on the sweeps of one training step
    (`capture_sweeps`), grouped by the sweep shapes of `shapes`: per
    capture GRAD_CASE_LAUNCHES bare launches of each kernel, every one
    held against the plain version in float64 (rounded once to `dtype`),
    K4 bit-equal launch to launch. One JSON line per shape: the captures,
    the largest error, each kernel's bare ms (mean over the captures of 5
    launches each) beside `synthetic_ms` ({kernel: {shape: ms}} on
    `sweep_inputs`) and, in bf16, `window_fit_shares`. Returns {shape:
    that line}."""
    names = {k: kernel_name(k, dtype) for k in ("sweep_grad_ref", "sweep_grad_src")}
    out = {}
    for name, b, n, h, w, h1, w1, c, _ in shapes:
        hw = h * w
        mine = [t for t in captures if tuple(t[0].shape) == (b, h1, w1, c)
                and tuple(t[4].shape) == (b, n, GROUPS, hw)]
        rec = {"real_sweeps": name, "dtype": str(dtype), "captures": len(mine),
               "launches_each": GRAD_CASE_LAUNCHES, "max_rel_err": {}, "ms": {},
               "sweep_inputs_ms": {}}
        ms = {k: [] for k in names}
        shares = []
        for src, ref, base, taps, grad in mine:
            d_ref = torch.empty(b, hw, c, device=src.device, dtype=dtype)
            d_src = torch.empty(b, h1, w1, c, device=src.device, dtype=dtype)
            scratch = None if dtype == torch.float32 else torch.empty(d_src.shape,
                                                                      device=src.device)
            outs = {"sweep_grad_ref": d_ref, "sweep_grad_src": d_src}
            bare = grad_launchers(src, base, taps, ref, grad, d_ref, d_src, scratch)
            exact = {"sweep_grad_ref": sweep_grad_ref_plain(
                         src.double(), base, taps.double(), grad.double()).to(dtype),
                     "sweep_grad_src": sweep_grad_src_plain(
                         ref.double(), base, taps.double(), grad.double(), h1, w1).to(dtype)}
            for kname, run in bare.items():
                for _ in range(GRAD_CASE_LAUNCHES):
                    run()
                    err, scale = hold_grad(kname, outs[kname], exact[kname],
                                           f"{name}, real sweep")
                    rec["max_rel_err"][kname] = max(rec["max_rel_err"].get(kname, 0.0),
                                                    err / max(scale, 1e-30))
                if kname == "sweep_grad_ref" and not repeats_equal(run, d_ref):
                    raise SystemExit(f"{names[kname]} at {name}, real sweep: two launches "
                                     "on the same inputs differ")
                ms[kname].append(time_ms(run, reps=5))
            if dtype == BF16:
                shares.append(window_fit_shares(base, taps, b, n, hw, h1, w1, c))
            del d_ref, d_src, scratch, outs, bare, exact
        for kname in names:
            rec["ms"][names[kname]] = sum(ms[kname]) / max(len(ms[kname]), 1)
            if synthetic_ms is not None:
                rec["sweep_inputs_ms"][names[kname]] = synthetic_ms[names[kname]].get(name)
        if shares:
            rec["window_fit_share"] = {k: sum(sh[k] for sh in shares) / len(shares)
                                       for k in WINDOW_LANES}
        print(json.dumps(rec))
        out[name] = rec
    torch.cuda.empty_cache()
    return out


def train_full_width(shapes, dtype=torch.float32, synthetic_ms=None):
    """The training path at full width (see TRAIN_*) in `dtype`:
    TRAIN_STEPS steps on one batch from a fresh seeded init; the loss must
    be finite and fall and each sweep kernel of `dtype` launch 52 times
    per step. Then one profiled step, a validation step, a checkpoint
    round trip on the card and `check_real_sweeps` on one more step's
    sweeps (`synthetic_ms`: the `sweep_inputs` times printed beside).
    Returns (launch counts of the timed steps, record)."""
    t0 = time.perf_counter()
    sample = train_sample(TRAIN_WIDTH, TRAIN_HEIGHT, TRAIN_VIEWS, TRAIN_BATCH, SEED)
    batch = to_device_batch(sample, "cuda")
    setup_s = time.perf_counter() - t0
    model = init_weights(Pipeline(iteration=TRAIN_ITERATION, test=False, dtype=dtype),
                         SEED).cuda()
    optimizer = make_optimizer(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, step_s = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        scalars = train_step(model, optimizer, batch, TRAIN_LR, True, TRAIN_ITERATION)
        losses.append(scalars["loss"].item())
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    planned = {k: n * TRAIN_STEPS for k, n in planned_step_counts(shapes, dtype).items()}
    last = step_s[-5:]
    rec = {"size": [TRAIN_WIDTH, TRAIN_HEIGHT], "batch": TRAIN_BATCH, "views": TRAIN_VIEWS,
           "iteration": TRAIN_ITERATION, "dtype": str(dtype), "regress": True,
           "steps": TRAIN_STEPS,
           "losses": losses, "step_s": step_s, "ms_per_step_last5": 1e3 * sum(last) / len(last),
           "steps_per_s_last5": len(last) / sum(last), "peak_mem_gib": peak / 2 ** 30,
           "batch_setup_s": setup_s, "launches": counts, "planned_launches": planned}

    by_name, by_cat, busy_ms = device_time(
        lambda: train_step(model, optimizer, batch, TRAIN_LR, True, TRAIN_ITERATION))
    wall_ms = 1e3 * sorted(last)[len(last) // 2]
    if busy_ms:
        rec["profile_step"] = {
            "device_busy_ms": busy_ms, "wall_ms_unprofiled_median": wall_ms,
            "device_idle_share": max(0.0, 1 - busy_ms / wall_ms),
            "by_category_ms": {k: v / 1e3 for k, v in
                               sorted(by_cat.items(), key=lambda kv: -kv[1])},
            "top_ms": [{"name": k[:90], "calls": c, "device_ms": t / 1e3} for k, (c, t)
                       in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]]}
    else:
        rec["profile_step"] = "device time not measured"

    val = {k: float(v) for k, v in val_step(model, batch, True, TRAIN_ITERATION).items()}
    rec["val_scalars"] = val
    with tempfile.TemporaryDirectory() as tmp:
        path = save_checkpoint(tmp, 0, model, optimizer, step=TRAIN_STEPS)
        restored = Pipeline(iteration=TRAIN_ITERATION, test=False, dtype=dtype).cuda()
        restored_opt = make_optimizer(restored)
        position = restore_checkpoint(path, restored, restored_opt)
    same_model = all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                       restored.state_dict().values()))
    opt_a, opt_b = optimizer.state_dict()["state"], restored_opt.state_dict()["state"]
    same_opt = opt_a.keys() == opt_b.keys() and all(
        torch.equal(opt_a[i][k], opt_b[i][k]) for i in opt_a for k in opt_a[i])
    rec["checkpoint"] = {"position": list(position), "model_equal": same_model,
                         "optimizer_equal": same_opt}
    print(json.dumps({"train": rec}))

    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise SystemExit(f"training loss did not fall: {losses}")
    if counts != planned:
        raise SystemExit(f"training launch counts {counts} != planned {planned}")
    if not all(np.isfinite(list(val.values()))):
        raise SystemExit(f"validation step not finite: {val}")
    if position != (0, TRAIN_STEPS) or not (same_model and same_opt):
        raise SystemExit(f"checkpoint round trip failed: {rec['checkpoint']}")

    # K4 and K5 on this step's own sweeps.
    captures = capture_sweeps(model, batch, TRAIN_ITERATION)
    want = sweeps_of(shapes, dtype)
    rec["real_sweeps"] = check_real_sweeps(captures, shapes, dtype, synthetic_ms)
    got = {k: v["captures"] for k, v in rec["real_sweeps"].items()}
    if got != want or len(captures) != sum(want.values()):
        raise SystemExit(f"captured sweeps {got} of {len(captures)} != planned {want}")
    return counts, rec


def perturbed_losses(batch, seed, dtype):
    """TRAIN_STEPS training losses in `dtype` from the seeded init with
    every weight scaled by (1 + TRAIN_NOISE * N(0, 1)), N drawn from
    `seed`."""
    model = init_weights(Pipeline(iteration=TRAIN_ITERATION, test=False, dtype=dtype),
                         SEED).cuda()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(1 + TRAIN_NOISE * torch.randn(p.shape, device="cuda", generator=gen))
    optimizer = make_optimizer(model)
    return [train_step(model, optimizer, batch, TRAIN_LR, True, TRAIN_ITERATION)["loss"].item()
            for _ in range(TRAIN_STEPS)]


def bf16_tracks_f32(losses32, losses16):
    """The bf16 training run against the f32 one (same init and batch).
    Gates: the first loss within 2%; the mean of the last two losses no
    more than 15% above f32's, each dtype's averaged over its run and
    TRAIN_NOISE_RUNS runs from the init perturbed by TRAIN_NOISE. Below
    f32's is no fault: the bf16 policy lowers the upsampled depth's L1,
    in the JAX package's bf16 mode too, most where training has made the
    convex-upsample weights sharp. Printed beside: the two-sided
    differences, and along an f32 run from the same init the bf16 loss on
    its weights before each step (the same term takes it several percent
    below f32's there). SystemExit on a miss."""
    batch = to_device_batch(
        train_sample(TRAIN_WIDTH, TRAIN_HEIGHT, TRAIN_VIEWS, TRAIN_BATCH, SEED), "cuda")
    model = init_weights(Pipeline(iteration=TRAIN_ITERATION, test=False), SEED).cuda()
    optimizer = make_optimizer(model)
    probe = Pipeline(iteration=TRAIN_ITERATION, test=False, dtype=BF16).cuda().train()
    along = []
    for _ in range(TRAIN_STEPS):
        probe.load_state_dict(model.state_dict())
        with torch.no_grad():
            loss16 = forward_loss(probe, batch, True)[0].item()
        loss32 = train_step(model, optimizer, batch, TRAIN_LR, True, TRAIN_ITERATION)["loss"]
        along.append((loss32.item(), loss16))
    ends, perturbed = {}, {}
    for name, dtype, losses in (("f32", torch.float32, losses32), ("bf16", BF16, losses16)):
        perturbed[name] = [perturbed_losses(batch, SEED + 10 + i, dtype)
                           for i in range(TRAIN_NOISE_RUNS)]
        ends[name] = [float(np.mean(r[-2:])) for r in [losses] + perturbed[name]]
    mean32, mean16 = float(np.mean(ends["f32"])), float(np.mean(ends["bf16"]))
    rec = {"first_rel": abs(losses16[0] - losses32[0]) / losses32[0],
           "along_f32_losses": along,
           "along_f32_max_rel": max(abs(b - a) / a for a, b in along),
           "last2_rel_one_run": abs(ends["bf16"][0] - ends["f32"][0]) / ends["f32"][0],
           "last2_per_run": ends, "last2_mean_rel": abs(mean16 - mean32) / mean32,
           "last2_mean_excess": mean16 / mean32 - 1.0,
           "perturbed_runs_losses": perturbed}
    print(json.dumps({"train_bf16_vs_f32": rec}))
    if not (rec["first_rel"] < 0.02 and rec["last2_mean_excess"] < 0.15):
        raise SystemExit(f"bf16 training does not track f32: {rec}")
    return rec


# --------------------------------------------------------- data parallel
# train_ddp_2rank: train_dtu.sh's stage-2 step over two processes on the
# one card, joined over gloo (NCCL refuses two ranks on one device).
DDP_WORLD, DDP_STEPS = 2, 3
# train_ddp_nccl: one rank over NCCL against the plain step, f32 and bf16.
NCCL_STEPS = 5
# Gates of a data-parallel step against the one-process step on the
# whole batch: the first loss, and the parameters after the first step
# (relative L2; K5's float4 reductions and the ranks' partial sums move
# the last bits, and Adam's first step turns a gradient's sign into
# ±lr); the BN running statistics after it (relative L2), which the
# first forward alone sets.
DDP_LOSS_REL, DDP_PARAM_REL, DDP_BN_REL = 1e-4, 1e-3, 1e-4
# bf16's own noise: the plain bf16 step from the init with every weight
# scaled by (1 + BF16_NOISE * N(0, 1)), BF16_NOISE_RUNS times.
BF16_NOISE, BF16_NOISE_RUNS = 1e-7, 2


def ddp_sample(width, height, views, batch, seed):
    """`train_sample` with another valid share in each sample: sample i
    keeps the rows above (1 − i/(2·batch)) of the height at every level,
    so each rank's mask count differs from the global batch's."""
    sample = train_sample(width, height, views, batch, seed)
    rows = np.arange(height)[None, :, None, None]
    keep = rows < (height * (1 - np.arange(batch) / (2 * batch)))[:, None, None, None]
    mask0 = np.broadcast_to(keep, (batch, height, width, 1)).astype(np.float32)
    sample["mask"] = {f"level_{l}": np.ascontiguousarray(mask0[:, ::2 ** l, ::2 ** l])
                      for l in range(4)}
    return sample


def tensor_tree(x):
    """numpy leaves → torch tensors (a job file holds tensors only)."""
    if isinstance(x, dict):
        return {k: tensor_tree(v) for k, v in x.items()}
    return torch.from_numpy(np.array(x))


def slice_batch(x, start, n):
    if isinstance(x, dict):
        return {k: slice_batch(v, start, n) for k, v in x.items()}
    return x[start:start + n]


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_steps(job, rank=0, world=1, device="cuda"):
    """The training runs of `job` on this rank's consecutive slice of its
    global batch (the whole batch at world 1), each from the job's
    `state` (rank 0's, broadcast in a process group) with a new Adam;
    `job["val"]` adds one val step of the first run's model before its
    steps, `job["profile"]` one more step of each run under
    torch.profiler after them (`device_time`: busy ms and ms by kind).
    Records per step: the loss, ms (host clock to a sync), the launch
    counts, the state_dict and the gradients after the step (on the
    host)."""
    dtype = getattr(torch, job["dtype"])
    per = job["batch"] // world
    batch = to_device_batch(slice_batch(job["sample"], rank * per, per), device)
    out = {"runs": []}
    for run in job["runs"]:
        model = load_state(Pipeline(iteration=job["iteration"], test=False, dtype=dtype),
                           job["state"], "job").to(device)
        if mesh.is_initialized():
            mesh.broadcast_state_(model)
        optimizer = make_optimizer(model)
        if job.get("val") and not out["runs"]:
            out["val"] = {k: float(v) for k, v in
                          val_step(model, batch, True, job["iteration"]).items()}
        steps = []
        for _ in range(run["steps"]):
            _sync(device)
            reset_launch_counts()
            t0 = time.perf_counter()
            loss = train_step(model, optimizer, batch, job["lr"], run["regress"],
                              job["iteration"])["loss"].item()
            _sync(device)
            steps.append({"loss": loss, "ms": 1e3 * (time.perf_counter() - t0),
                          "launches": launch_counts(),
                          "state": {k: v.detach().cpu().clone()
                                    for k, v in model.state_dict().items()},
                          "grads": {k: p.grad.detach().cpu().clone()
                                    for k, p in model.named_parameters()}})
        out["runs"].append(steps)
        if job.get("profile"):
            _, by_cat, busy = device_time(lambda: train_step(
                model, optimizer, batch, job["lr"], run["regress"], job["iteration"]))
            out["profile"] = {"device_busy_ms": busy, "by_category_ms": {
                k: v / 1e3 for k, v in sorted(by_cat.items(), key=lambda kv: -kv[1])}}
    return out


def ddp_rank(rank, world, port, backend, device, job_path):
    """One rank of `run_ranks`, in a process of its own: joins the group
    through torchrun's variables (every rank on `device`), runs
    `run_steps` and saves its records beside the job file."""
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK="0")
    job = torch.load(job_path, weights_only=True)
    mesh.initialize_distributed("on", backend=backend, device=device)
    try:
        out = run_steps(job, int(rank), int(world), device)
    finally:
        torch.distributed.destroy_process_group()
    torch.save(out, f"{job_path}.rank{rank}")


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(job, world, backend, device, timeout=900, env=None):
    """`run_steps` of `job` on `world` ranks, each a Python process of its
    own (`ddp_rank`) on `device`, joined over `backend` on localhost.
    Returns each rank's records; a rank that fails stops all and raises
    with its output."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "job.pt")
        torch.save(job, path)
        port = free_port()
        code = "import sys, chip_smoke; chip_smoke.ddp_rank(*sys.argv[1:])"
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+") for r in range(world)]
        procs = [subprocess.Popen(
            [sys.executable, "-c", code, str(r), str(world), str(port), backend, str(device),
             path], cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
            stdout=logs[r], stderr=subprocess.STDOUT) for r in range(world)]
        deadline = time.monotonic() + timeout
        try:
            while any(p.poll() is None for p in procs):
                if any(p.poll() not in (None, 0) for p in procs) or time.monotonic() > deadline:
                    break
                time.sleep(0.1)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            for f in logs:
                f.seek(0)
            outputs = [f.read() for f in logs]
            for f in logs:
                f.close()
        failed = [r for r, p in enumerate(procs) if p.returncode != 0]
        if failed:
            raise SystemExit("\n".join(
                f"{backend} rank {r} of {world} failed ({procs[r].returncode}):\n"
                f"{outputs[r][-3000:]}" for r in failed))
        return [torch.load(f"{path}.rank{r}", weights_only=True) for r in range(world)]


def rel_l2(got, want, keys):
    """‖got − want‖ / ‖want‖ over the tensors `keys` of two state dicts."""
    diff = sum(float((got[k].double() - want[k].double()).pow(2).sum()) for k in keys)
    norm = sum(float(want[k].double().pow(2).sum()) for k in keys)
    return (diff / norm) ** 0.5


def hold_ddp(name, ranks, single, planned, strict=True, extra=None):
    """Rank records of a data-parallel run (`run_ranks` or `run_steps` in
    a group) against the one-process run of the same job (`single`):
    with `strict`, the first loss within DDP_LOSS_REL and the parameters
    after the first step within DDP_PARAM_REL (relative L2); always the
    BN running statistics after it within DDP_BN_REL, every rank
    bit-equal to rank 0 (parameters, BN statistics) after every step,
    finite losses and `planned` launches per rank per step. Prints one
    JSON line (with `extra`); SystemExit on a miss."""
    steps = [r["runs"][0] for r in ranks]
    want = single["runs"][0]
    params = [k for k in want[0]["grads"]]
    rec = {"ranks": len(ranks), "steps": len(steps[0]), "strict": strict, **(extra or {}),
           "loss_per_step": [s["loss"] for s in steps[0]],
           "single_process_loss": want[0]["loss"],
           "loss_rel": abs(steps[0][0]["loss"] - want[0]["loss"]) / abs(want[0]["loss"]),
           "params_rel_l2": rel_l2(steps[0][0]["state"], want[0]["state"], params),
           "bn_stats_rel_l2": rel_l2(steps[0][0]["state"], want[0]["state"],
                                     [k for k in want[0]["state"] if "running" in k]),
           "ranks_bit_equal": all(
               torch.equal(s[i]["state"][k], steps[0][i]["state"][k])
               for s in steps[1:] for i in range(len(s)) for k in s[i]["state"]),
           "ms_per_step_per_rank": [[s["ms"] for s in r] for r in steps],
           "launches_per_rank_per_step": [[s["launches"] for s in r] for r in steps],
           "planned_per_step": planned}
    print(json.dumps({name: rec}))
    if strict and not (rec["loss_rel"] <= DDP_LOSS_REL
                       and rec["params_rel_l2"] <= DDP_PARAM_REL):
        raise SystemExit(f"{name}: the data-parallel step disagrees with one process: {rec}")
    if not (rec["bn_stats_rel_l2"] <= DDP_BN_REL and np.isfinite(rec["loss_per_step"]).all()):
        raise SystemExit(f"{name}: BN statistics or losses off: {rec}")
    if not rec["ranks_bit_equal"]:
        raise SystemExit(f"{name}: the ranks' parameters or BN statistics differ")
    if any(s["launches"] != planned for r in steps for s in r):
        raise SystemExit(f"{name}: launches per rank per step != {planned}")
    return rec


def ddp_job(sample, dtype, steps, val=False):
    """A job for `run_steps`: the stage-2 step at TRAIN_*, from the
    released DTU weights. Not from a fresh init: there the one-process
    step does not repeat itself on the card to the gates' bounds (two
    plain f32 runs from seed 0's init 1.1e-3 apart in parameters, 5.4e-5
    in loss: near-uniform depth probabilities put argmax ties at the
    mercy of the plain ops' run-to-run noise); from the trained weights
    two plain runs are 1e-5 apart."""
    state = npz_state_dict(pretrained_path("dtu"))
    return {"state": state, "sample": tensor_tree(sample), "batch": TRAIN_BATCH,
            "iteration": TRAIN_ITERATION, "dtype": str(dtype).removeprefix("torch."),
            "lr": TRAIN_LR, "runs": [{"regress": True, "steps": steps}], "val": val}


def train_ddp_2rank():
    """train_dtu.sh's stage-2 step over DDP_WORLD processes on the card
    (gloo), DDP_STEPS steps on 4 distinct samples with different mask
    counts, against the one-process step on all 4 (`hold_ddp`)."""
    sample = ddp_sample(TRAIN_WIDTH, TRAIN_HEIGHT, TRAIN_VIEWS, TRAIN_BATCH, SEED)
    job = ddp_job(sample, torch.float32, DDP_STEPS)
    t0 = time.perf_counter()
    ranks = run_ranks(job, DDP_WORLD, "gloo", "cuda:0")
    wall = time.perf_counter() - t0
    single = run_steps(dict(job, runs=[{"regress": True, "steps": 1}]), device="cuda")
    planned = planned_step_counts(sweep_shapes(
        TRAIN_WIDTH, TRAIN_HEIGHT, TRAIN_VIEWS, TRAIN_ITERATION, TRAIN_BATCH // DDP_WORLD),
        torch.float32)
    return hold_ddp("train_ddp_2rank", ranks, single, planned, extra={
        "timing_note": "two processes sharing one card over gloo: not a scaling figure",
        "single_process_ms_first_step": single["runs"][0][0]["ms"],
        "wall_s_with_process_start": wall})


@contextlib.contextmanager
def process_group(backend, device):
    """A world-1 group in this process, joined as torchrun's rank 0 would."""
    saved = {k: os.environ.get(k) for k in ("MASTER_ADDR", "MASTER_PORT", "RANK",
                                            "WORLD_SIZE", "LOCAL_RANK")}
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()), RANK="0",
                      WORLD_SIZE="1", LOCAL_RANK="0")
    try:
        mesh.initialize_distributed("on", backend=backend, device=device)
        yield
    finally:
        if mesh.is_initialized():
            torch.distributed.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def perturbed_job(job, seed):
    """`job` from its state with every weight scaled by
    (1 + BF16_NOISE * N(0, 1)), N drawn from `seed`."""
    gen = torch.Generator().manual_seed(seed)
    state = {k: v * (1 + BF16_NOISE * torch.randn(v.shape, generator=gen))
             if v.is_floating_point() else v for k, v in job["state"].items()}
    return dict(job, state=state)


def train_ddp_nccl():
    """The synced path (global BN statistics, global loss and metric
    denominators, summed gradients) through NCCL on the card: one rank
    (world 1) against the plain step from the same init, NCCL_STEPS
    steps each, in f32 with `hold_ddp`'s gates and in bf16, where its
    loss and parameter bounds lie below bf16's own noise: the same BN
    arithmetic in another f32 order flips the rounding of some bf16
    activations, and the argmax windows and the view weights' maximum
    turn that into changes of the loss. In bf16 the BN statistics,
    the launches and finite losses are gated, and the first loss and
    parameters are printed beside the spread of BF16_NOISE_RUNS plain
    steps from the init perturbed by BF16_NOISE. Prints ms per step of
    both forms (the mean after the first) and the device time by kind of
    one profiled step of each: the synced BN's cost."""
    sample = ddp_sample(TRAIN_WIDTH, TRAIN_HEIGHT, TRAIN_VIEWS, TRAIN_BATCH, SEED)
    recs = {}
    for dtype in (torch.float32, BF16):
        job = dict(ddp_job(sample, dtype, NCCL_STEPS), profile=True)
        plain = run_steps(job, device="cuda")
        with process_group("nccl", "cuda"):
            synced = run_steps(job, device="cuda")
        planned = planned_step_counts(sweep_shapes(
            TRAIN_WIDTH, TRAIN_HEIGHT, TRAIN_VIEWS, TRAIN_ITERATION, TRAIN_BATCH,
            itemsize=dtype.itemsize), dtype)
        if any(s["launches"] != planned for s in plain["runs"][0]):
            raise SystemExit(f"train_ddp_nccl: plain launches per step != {planned}")
        ms = {name: float(np.mean([s["ms"] for s in r["runs"][0][1:]]))
              for name, r in (("synced", synced), ("plain", plain))}
        extra = {"dtype": str(dtype), "ms_per_step_synced_bn_nccl": ms["synced"],
                 "ms_per_step_plain": ms["plain"],
                 "synced_minus_plain_ms": ms["synced"] - ms["plain"],
                 "ms_steps_averaged": NCCL_STEPS - 1,
                 "profile_step": {"synced": synced.get("profile"),
                                  "plain": plain.get("profile")}}
        if dtype == BF16:
            want = plain["runs"][0][0]
            params = list(want["grads"])
            noise = []
            for i in range(BF16_NOISE_RUNS):
                got = run_steps(dict(perturbed_job(job, SEED + 20 + i), profile=False,
                                     runs=[{"regress": True, "steps": 1}]),
                                device="cuda")["runs"][0][0]
                noise.append({"loss_rel": abs(got["loss"] - want["loss"]) / abs(want["loss"]),
                              "params_rel_l2": rel_l2(got["state"], want["state"], params)})
            extra["plain_perturbed_by_1e-7"] = noise
        recs[str(dtype)] = hold_ddp(f"train_ddp_nccl_{str(dtype).removeprefix('torch.')}",
                                    [synced], plain, planned, strict=dtype == torch.float32,
                                    extra=extra)
    return recs


def nan_image(sample, view=1):
    """`sample` with one pixel of one input image set to NaN."""
    imgs = np.array(sample["imgs"]["level_0"], copy=True)
    imgs[0, view, imgs.shape[2] // 2, imgs.shape[3] // 2, 0] = np.nan
    return dict(sample, imgs={"level_0": imgs})


def debug_nans_phase(model, sample, gt_depth, outdir, device="cuda"):
    """`--debug_nans` (engine/profiling.py) on one depth map: clean on the
    real map (its median error below 0.05, the kernels launched as
    planned), then a NaN put into one input image must raise, naming a
    module. Returns (launch counts of the clean map, record)."""
    reset_launch_counts()
    t0 = time.perf_counter()
    with maybe_enable_nan_debugging(model, True):
        run_depth(model, [sample], os.path.join(outdir, "clean"), device, log=lambda *_: None)
    _sync(device)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    depth, _ = read_pfm(os.path.join(outdir, "clean", "depth_est", "00000000.pfm"))
    err = float(np.median(np.abs(depth[..., 0] - gt_depth)))
    raised = None
    try:
        with maybe_enable_nan_debugging(model, True):
            run_depth(model, [nan_image(sample)], os.path.join(outdir, "nan"), device,
                      log=lambda *_: None)
    except FloatingPointError as e:
        raised = str(e)
    rec = {"clean_median_abs_err": err, "clean_finite": bool(np.isfinite(depth).all()),
           "clean_wall_s": wall, "launches": counts, "nan_raised": raised}
    print(json.dumps({"debug_nans": rec}))
    if not (rec["clean_finite"] and err < 0.05):
        raise SystemExit(f"debug_nans: the clean map failed: {rec}")
    if raised is None or "module" not in raised:
        raise SystemExit(f"debug_nans: an injected NaN was not caught: {rec}")
    return counts, rec


def depth_run(model, samples, gt_depths, outdir, tmp, dtype):
    """The eval core loop (`run_depth`) over `samples` after one warm-up
    map, timed, its launches counted; reads the PFMs back and holds each
    map's median error against the analytic depth below 0.05. Prints one
    JSON line; returns (launch counts, per-view records, wall seconds)."""
    warm = run_depth(model, samples[:1], os.path.join(tmp, f"warm_{dtype}"), "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    secs = run_depth(model, samples, outdir, "cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    errs = []
    for v, gt in enumerate(gt_depths):
        depth, _ = read_pfm(os.path.join(outdir, "depth_est", f"{v:08d}.pfm"))
        conf, _ = read_pfm(os.path.join(outdir, "confidence", f"{v:08d}.pfm"))
        if depth.shape != (HEIGHT, WIDTH, 1) or conf.shape != depth.shape:
            raise SystemExit(f"view {v}: PFM shape {depth.shape}")
        if not (np.isfinite(depth).all() and np.isfinite(conf).all()):
            raise SystemExit(f"view {v}: non-finite output")
        errs.append({"view": v,
                     "median_abs_err_vs_gt": float(np.median(np.abs(depth[..., 0] - gt))),
                     "median_abs_depth_minus_z0": float(np.median(np.abs(depth - Z0))),
                     "median_confidence": float(np.median(conf))})
    print(json.dumps({"dtype": str(dtype), "maps": len(samples), "wall_s": wall,
                      "maps_per_s": len(samples) / wall, "per_map_s": secs,
                      "warmup_s": warm, "peak_mem_gib": peak / 2 ** 30,
                      "launches": counts, "depth_check": errs}))
    bad = [e for e in errs if not e["median_abs_err_vs_gt"] < 0.05]
    if bad:
        raise SystemExit(f"depth check failed ({dtype}): {bad}")
    return counts, errs, wall


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; the port's "
              "kernels need an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "device": torch.cuda.get_device_name(0)}))

    build_s = kernels.build_all()
    print(json.dumps({"build_seconds": build_s}))
    for name in kernels.SOURCES:
        with open(kernels.library_path(name) + ".log") as f:
            regs = [ln.strip() for ln in f
                    if any(k in ln for k in ("entry function", "registers", "spill"))]
        print(f"{name}: " + " | ".join(regs))

    model = load_npz_weights(Pipeline(iteration=ITERATION), pretrained_path("dtu")).cuda()
    shapes = sweep_shapes(WIDTH, HEIGHT, VIEWS, ITERATION)
    per_map = check_kernels(shapes)
    # K3 at DTU's 10 sources, and at the 4 of the main path's fusion (the
    # shape its reported time and bound are taken at).
    k3 = check_consistency(WIDTH, HEIGHT, (DTU_SOURCES, VIEWS - 1))[VIEWS - 1]

    t0 = time.perf_counter()
    cams, images, gt_depths = render_scene(WIDTH, HEIGHT, VIEWS, SEED)
    samples = samples_of(cams, images)
    print(json.dumps({"scene_seconds": time.perf_counter() - t0,
                      "size": [WIDTH, HEIGHT], "views": VIEWS}))
    expected = sum(s[-1] for s in shapes) * len(samples)

    with tempfile.TemporaryDirectory() as tmp:
        outdir = os.path.join(tmp, "out")
        counts, errs, wall = depth_run(model, samples, gt_depths, outdir, tmp, torch.float32)
        planned = planned_counts(sweep_premul=expected, corr_epilogue=expected)
        if counts != planned:
            raise SystemExit(f"launch counts {counts} != planned {planned}")

        # Fusion of this pass's depth maps, then of the analytic ones.
        learned = []
        for v in range(VIEWS):
            depth, _ = read_pfm(os.path.join(outdir, "depth_est", f"{v:08d}.pfm"))
            conf, _ = read_pfm(os.path.join(outdir, "confidence", f"{v:08d}.pfm"))
            learned.append((depth[..., 0], conf[..., 0]))
        reset_launch_counts()
        fused = fuse_scene(fusion_views(cams, *zip(*learned), images),
                           os.path.join(tmp, "fused"), "cuda")
        torch.cuda.synchronize()
        fusion_counts = launch_counts()
        fused.update(scene="learned depth", launches=fusion_counts)
        print(json.dumps({"fusion": fused}))
        if fusion_counts != planned_counts(fusion_consistency=VIEWS):
            raise SystemExit(f"fusion launch counts {fusion_counts}: "
                             f"want {VIEWS} of fusion_consistency only")
        if not (fused["pixel_share"] >= 0.05 and fused["median_abs_z_minus_z0"] < 0.05):
            raise SystemExit(f"fused cloud of the learned depth failed: {fused}")
        exact = fuse_scene(
            fusion_views(cams, gt_depths, [np.ones_like(d) for d in gt_depths], images),
            os.path.join(tmp, "fused_exact"), "cuda")
        exact["scene"] = "analytic depth, unit confidence"
        print(json.dumps({"fusion": exact}))
        if not (exact["pixel_share"] > 0.5 and exact["max_abs_z_minus_z0"] < 0.02):
            raise SystemExit(f"fused cloud of the analytic depth failed: {exact}")

        # Two more timed passes over the same maps: the run-to-run spread.
        repeats = []
        for i in range(2):
            t0 = time.perf_counter()
            run_depth(model, samples, os.path.join(tmp, f"repeat{i}"), "cuda",
                      log=lambda *_: None)
            torch.cuda.synchronize()
            repeats.append(len(samples) / (time.perf_counter() - t0))
        print(json.dumps({"repeat_maps_per_s": repeats}))

        profile_maps(model, samples, os.path.join(tmp, "prof"), wall)
        del model
        torch.cuda.empty_cache()

        # bf16: the forward forms at the same shapes, then the same maps
        # with the same weights in bf16, held against the f32 run's error.
        shapes16 = sweep_shapes(WIDTH, HEIGHT, VIEWS, ITERATION, itemsize=2)
        per_map.update(check_kernels(shapes16, dtype=BF16))
        check_fwd_edge_cases()
        model16 = load_npz_weights(Pipeline(iteration=ITERATION, dtype=BF16),
                                   pretrained_path("dtu")).cuda()
        counts16, errs16, wall16 = depth_run(model16, samples, gt_depths,
                                             os.path.join(tmp, "out_bf16"), tmp, BF16)
        expected16 = sum(s[-1] for s in shapes16) * len(samples)
        planned = planned_counts(sweep_premul_bf16=expected16, corr_epilogue_bf16=expected16)
        if counts16 != planned:
            raise SystemExit(f"bf16 launch counts {counts16} != planned {planned}")
        bad = [(e16, e32) for e16, e32 in zip(errs16, errs)
               if not e16["median_abs_err_vs_gt"] < max(1.15 * e32["median_abs_err_vs_gt"],
                                                        e32["median_abs_err_vs_gt"] + 0.01)]
        if bad:
            raise SystemExit(f"bf16 depth error beyond max(1.15 f32, f32 + 0.01): {bad}")
        profile_maps(model16, samples, os.path.join(tmp, "prof_bf16"), wall16)
        del model16
        torch.cuda.empty_cache()
    counts.update({k: counts16[k] for k in ("sweep_premul_bf16", "corr_epilogue_bf16")})

    # Training: the backward kernels at the step's shapes, a small step
    # against the CPU, then the full-width run, in f32 and in bf16.
    train_shapes = sweep_shapes(TRAIN_WIDTH, TRAIN_HEIGHT, TRAIN_VIEWS, TRAIN_ITERATION,
                                TRAIN_BATCH)
    train_shapes16 = sweep_shapes(TRAIN_WIDTH, TRAIN_HEIGHT, TRAIN_VIEWS, TRAIN_ITERATION,
                                  TRAIN_BATCH, itemsize=2)
    check_kernels(train_shapes, per="step")
    check_kernels(train_shapes16, per="step", dtype=BF16)
    per_step = check_grad_kernels(train_shapes)
    per_step.update(check_grad_kernels(train_shapes16, dtype=BF16))
    compare_train_step()
    synthetic_ms = {k: v["ms_by_shape"] for k, v in per_step.items()}
    train_counts, train32 = train_full_width(train_shapes, synthetic_ms=synthetic_ms)
    train_counts16, train16 = train_full_width(train_shapes16, BF16, synthetic_ms)
    bf16_tracks_f32(train32["losses"], train16["losses"])
    train_counts.update({k: train_counts16[k] for k in ("sweep_grad_ref_bf16",
                                                        "sweep_grad_src_bf16")})

    # Data-parallel training (two gloo ranks on the card; one NCCL rank in
    # bf16), then --debug_nans on one depth map.
    train_ddp_2rank()
    train_ddp_nccl()
    model = load_npz_weights(Pipeline(iteration=ITERATION), pretrained_path("dtu")).cuda()
    with tempfile.TemporaryDirectory() as tmp:
        debug_counts, _ = debug_nans_phase(model, samples[0], gt_depths[0], tmp)
    per_map_launches = sum(s[-1] for s in shapes)
    planned = planned_counts(sweep_premul=per_map_launches, corr_epilogue=per_map_launches)
    if debug_counts != planned:
        raise SystemExit(f"debug_nans launch counts {debug_counts} != planned {planned}")
    del model

    sources = {"corr_epilogue": ("itermvs_tpu_torch/csrc/corr_epilogue.cu",
                                 "itermvs_tpu/ops/sweep_epilogue.py:61"),
               "sweep_premul": ("itermvs_tpu_torch/csrc/sweep_premul.cu",
                                "itermvs_tpu/ops/grid_sample.py:472"),
               "fusion_consistency": ("itermvs_tpu_torch/csrc/fusion_consistency.cu",
                                      "itermvs_tpu/fusion.py:57"),
               "sweep_grad_ref": ("itermvs_tpu_torch/csrc/sweep_grad_ref.cu",
                                  "itermvs_tpu/models/itermvs.py:106"),
               "sweep_grad_src": ("itermvs_tpu_torch/csrc/sweep_grad_src.cu",
                                  "itermvs_tpu/models/itermvs.py:106")}
    for name in ("corr_epilogue", "sweep_premul", "sweep_grad_ref", "sweep_grad_src"):
        source, replaces = sources[name]
        sources[f"{name}_bf16"] = (source.replace(".cu", "_bf16.cu"), replaces)
    report = []
    for name in ("corr_epilogue", "sweep_premul", "corr_epilogue_bf16", "sweep_premul_bf16"):
        tot = per_map[name]
        t_bytes, t_ops = tot["bytes"] / PEAK_BYTES_PER_S, tot["ops"] / PEAK_F32_PER_S
        report.append({
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": counts[name],
            "max_abs_err": tot["max_abs_err"], "ms": tot["ms"], "call_ms": tot["call_ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": tot["library_ms"], "per": "one depth map"})
    report.append({
        "name": "fusion_consistency", "route": "cuda",
        "source": sources["fusion_consistency"][0],
        "replaces": sources["fusion_consistency"][1],
        "launches": fusion_counts["fusion_consistency"],
        "max_abs_err": k3["max_abs_err"], "ms": k3["ms"], "call_ms": k3["call_ms"],
        "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
        "bound_by": k3["bound_by"], "library_ms": None,
        "per": f"one {WIDTH}x{HEIGHT} reference view, {VIEWS - 1} sources"})
    for name in ("sweep_grad_ref", "sweep_grad_src", "sweep_grad_ref_bf16",
                 "sweep_grad_src_bf16"):
        tot = per_step[name]
        t_bytes, t_ops = tot["bytes"] / PEAK_BYTES_PER_S, tot["ops"] / PEAK_F32_PER_S
        report.append({
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": train_counts[name],
            "max_abs_err": tot["max_abs_err"], "max_rel_err": tot["max_rel_err"],
            "ms": tot["ms"], "call_ms": tot["call_ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"],
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "launches_per_step": tot["launches"],
            "per": f"one training step, {TRAIN_WIDTH}x{TRAIN_HEIGHT}, batch {TRAIN_BATCH}, "
                   f"{TRAIN_VIEWS} views, {TRAIN_ITERATION} iterations"})
    print(json.dumps({"kernels": report}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
