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
   and (for corr_epilogue) one PyTorch call of the same function. Then
   K8 sweep_taps at the map's two sweeps (the init sweep at 200x144 with
   32 samples, the iteration sweep at 400x288 with 10 samples over 3
   levels, and that sweep with planted edges: behind the camera, NaN and
   huge depths, a source moved off the map), bit for bit against
   fused_sweep_taps' plain version, K6 depth_readout on seeded
   [1, 256, 288, 400] logits with planted edge bins, exact ties and
   near-ties: the same argmax on every pixel, depth and probability within
   1e-6, and K9 convex_upsample on seeded [1, 144, 288, 400] mask logits
   whose border taps are planted to dominate: within 1e-6
   (`check_sweep_taps`, `check_readout`, `check_upsample`; bare `ms`,
   wrapper `call_ms`, plain ms, bound and share per kernel). Then
   `check_view_aggregate`: K11 view_aggregate at each of a map's 13
   view aggregations (the init sweep's 4 views of [1, 32, 8, 144*200] as
   slices of one stacked tensor, each iteration level's n = 4, 4, 2 at
   288*400) and of a training step's (640x512, batch 4: the init sweep's
   slices strided by the batch), and K12 view_aggregate_grad there (with
   the weights' gradient at the init sweeps), then both, K12 with and
   without the weights' gradient, at VIEW_EDGE_CASES (an odd P, 6
   sources, 24 rows, one sample, one view): the output and every view's
   gradient bit for bit against the plain versions, the weights'
   gradient within 1e-5 (relative L2), two K12 launches bit-equal; bare
   ms against the byte bound, the profiler's device µs per kernel
   function, the plain chain's ms and device ms. Then `check_conv_gru`:
   the ConvGRU's gates K13 gru_reset, K14 gru_update and their
   backwards K15 gru_update_grad, K16 gru_reset_grad, in float32 and
   bfloat16, at a map's GRU call [1, ·, 288, 400], a training step's
   [4, ·, 128, 160] and GRU_EDGE_SHAPES (H·W not a multiple of the
   vector word at B = 3 and B = 1, a small map at B = 2), on seeded
   logits with saturating and tiny values planted: every output bit for
   bit against the plain versions, two launches bit-equal; bare ms,
   device ms, bound and share, the plain version's ms. Then
   `check_bn_act`: FeatureNet's BN epilogue K17 bn_act and its backward
   K18 bn_act_grad, in float32 and bfloat16, at each of the 13 BN
   epilogues of a 1600x1152 image (`BN_CALLS`: the ReLU form, the
   identity skip, the downsample's BN) and of a training step's 20
   images at 640x512, then at BN_EDGE_CASES (odd H·W and N·C, a 1x1
   plane, planes of two spans, a lone BN without the ReLU), on seeded
   inputs with signed scales and ReLU inputs planted at exactly 0: K17's
   output and K18's ∂y and ∂skip bit for bit against the plain versions,
   K18's per-channel sums and vector gradients within 1e-5 of float64
   (scaled by the absolute terms), two launches
   bit-equal; bare ms, device ms, bound and share, the plain version's
   ms and cuDNN's batch norm on the float32 tensor (the call K17 and K18
   replaced; it computes the normalise only). Then `check_bn_stats`:
   BatchNorm's training statistics K21 bn_stats (one read of y: the
   mean and the biased variance, spans merged by Chan's rule, and the
   process group's sums) at each of FeatureNet's 16 BN
   inputs (`BN_INPUTS`) and their backward K22 bn_stats_grad (their term
   added in place to K18's ∂y, and ∂skip in form c) at each of its 13
   epilogues, on a training step's 20 images at 640x512, in float32 and
   bfloat16, then at BN_EDGE_CASES: K21 within 1e-6 of float64
   (relative), K22 bit for bit against its plain version, two launches
   bit-equal; the whole input gradient's error against float64 beside
   that of the composition it replaced (var_mean's autograd backward
   cast and added); bare ms, device ms, bound and share, the plain
   version's ms and the library's (`torch.var_mean`; var_mean's backward
   plus the add). Then `check_upsample2x`:
   FeatureNet's FPN top-down add K19 upsample2x_add (bilinear x2 of x
   plus the lateral) and its backward K20 upsample2x_grad, in float32
   and bfloat16, at both FPN adds of a 1600x1152 image ([1, 48, 144,
   200] and [1, 48, 288, 400]) and of a training step's 20 images at
   640x512, then at UP2_EDGE_SHAPES (h or w of 1, 2 and odd, small maps
   on the vector path), on seeded inputs whose exponents spread over
   16 octaves: K19 bit for bit against its plain version, K20 within one
   unit in the last place of the float64 sum of the same terms, two
   launches bit-equal; bare ms, device ms, bound and share, the plain
   version's ms and the library's (F.interpolate + add; F.interpolate's
   autograd backward). Then `check_resize`: the model's six other
   bilinear resizes (`RESIZE_SITES`: the reference features of levels 1
   and 3 to the 1/4 grid, ×½ and ×2, the init sweep's view weights and
   depth ×2, the hidden state ×2 with its tanh, the confidence ×4), K28
   resize_bilinear and, where a gradient flows, its backward K29
   resize_bilinear_grad, in float32 and, at the sites of the compute
   dtype, bfloat16, on a 1600x1152 map and on a training step's batch of
   4 at 640x512 (the reference features as view slices), then at
   RESIZE_EDGE_CASES (odd maps, one pixel, ×4, tanh, two ratios that are
   not powers of two) and on a view slice: K28 bit for bit against
   F.interpolate (then torch.tanh), K29 within one unit in the last
   place of the float64 sum (×2) or bit for bit against F.interpolate's
   backward (×½), two launches bit-equal; bare ms, device ms, bound and
   share, the plain version's ms and the library's (F.interpolate +
   tanh; their autograd backward). Then `check_full_loss`: the training loss K23
   full_loss (one read of each probability: every term's sum and count)
   and its backward K24 full_loss_grad (the dense ∂p K7 reads, the
   depths' and logits' gradients) at the training step's loss (batch 4,
   128x160, level 0 512x640, 5 predictions) with planted edges (GT bins
   0 and 255, argmaxes 4 and 5 bins off, p at and below 1e-5 at the GT
   bin, |δ| = 0 with a logit of 0, NaN and infinite bins), on one real
   step's outputs, then at LOSS_EDGE_CASES (stage 1, an empty mask,
   7x9, one and sixteen predictions): K23's sums within 1e-6 of float64,
   its counts, GT bins, argmax windows and argmaxes exact, K24 within
   1e-6 of float64's max, two launches of each bit-equal; bare ms,
   device ms, bound and share, the eager loss's forward and backward ms.
   Then `check_clip_adam`: the optimizer update, K25 grad_norm (Σg² in
   float64 over every gradient, folded in a fixed order) and K26
   clip_adam (optax's clip, decay and Adam in place on p, m and v), at
   the training model's 100 parameter shapes from the seeded init with
   gradients drawn from the seed, at a global norm above and below 2.0,
   weight decay 0 and 1e-4, three steps each (t = 1, 2, 3): K25 within
   1e-12 of the float64 sum, K26 bit for bit against its plain version,
   two launches of each bit-equal, `clip_adam_step_` on a
   torch.optim.Adam bit-equal to the bare launches; bare ms, device ms,
   bound, share and the launch floor (the same C calls over one
   element), the plain versions' ms, the eager update's
   (`clip_by_global_norm_` + `torch.optim.Adam.step`) and, as the
   library's, `clip_grad_norm_(foreach=True)` + `Adam(fused=True).step`
   (a near function). Then `check_depth_metrics`: the training metrics,
   K27 depth_metrics (the 15 batch means and their (n, total) rows from
   one read of each prediction, GT and mask), at the training step's
   metrics (batch 4, 5 predictions at 128x160, the upsampled depth at
   512x640) with empty level-2 and level-0 images, errors of exactly 1,
   2, 4 and 8 and masks of exactly 0.5 planted, then with NaN and
   infinite estimates at masked-out and valid pixels, with every mask
   empty, and at METRIC_EDGE_CASES (one and sixteen predictions, 7x9):
   the outlier rates within 1 ulp of the plain version, the mean errors
   within 1e-6 of its float64 run (NaN where it is NaN), two launches
   bit-equal; bare ms, device ms, bound, share and the launch floor, the
   plain version's ms, and the host ms per call of the wrapper, of the
   step's entry and of the eager chain.
4. Runs the port's eval core loop (`itermvs_tpu_torch.eval.run_depth`)
   with the vendored DTU weights and the feature cache on a 5-view
   textured-plane scene made in memory at 1600x1152, one depth map per
   reference view, float32, 4 GRU iterations, fed as page-locked tensors
   (as save_depth's loader delivers them on a card); reads the PFMs back
   and checks them against the scene's analytic depth; checks that each
   kernel launched as often as the chunk plan predicts (K6 and K8 5 times
   per map, K9 once, K11 13 times, K13 and K14 4 times, K28 5 times, K17
   13 times and K19 twice per image the feature cache extracts); prints
   per map
   the host ms of run_depth's `dispatch` (uploads and eager launches)
   and `finalize` (wait, dequantization, writer handoff).
5. Fuses those 5 depth maps (`itermvs_tpu_torch.fusion.fuse_views`,
   each view against the other 4) into a PLY, reads it back and checks
   it against the plane, checks the mask PNGs and that
   fusion_consistency launched once per reference view; then fuses the
   scene's analytic depth maps, where most pixels must survive.
6. Two more timed depth passes over the same maps (maps/s), then
   profiles them once more with torch.profiler: device time by kernel
   and by kind, kernels launched per map, the device's idle share, and
   the device time and launches per map of the model's labelled
   plain-torch chains (`CHAINS`) beside their byte bounds; the capture
   must hold each hand-written kernel's device kernels as the launch plan
   says (`device_capture`: an empty or short capture is retaken, three
   in all, then the phase fails) and no bilinear resize or tanh of
   PyTorch's (`resize_op_events`). Then
   `eval_pipeline`: the 5 maps through one run_depth call against one
   call per map, twice (differing pixels no more than between the two
   one-per-call runs), all with cuDNN's deterministic algorithms (two
   more one-per-call runs show the default algorithms' run-to-run
   spread), and `match` and the forward run under torch's sync debug
   mode, which raises at any host sync; and `input_uint8`:
   raw uint8 level_0 planes, normalised on the card, equal to the host's
   float32 planes bit for bit, and the maps from them held against the
   float32 input's under the same rule (maps/s and host→device bytes per
   map of both forms).
7. Holds the sweep kernels, forward (sweep_premul, corr_epilogue) and
   backward (sweep_grad_ref, sweep_grad_src), against their plain
   versions on the card at the four sweep shapes of a training step at
   640x512, batch 4, 5 views, and times them (the backward kernels bare
   and through their wrappers); holds the backward kernels on pile-up,
   edge and one-corner bases too, and K4 bit for bit against a second
   launch; checks that a base index outside the source map shows as NaN
   in both. Then K8 at the step's two sweeps and K6 (training form, which
   writes the probability) and K7 depth_readout_grad at [4, 256, 128,
   160], in both dtypes: K7 on K6's own outputs with seeded gradients of
   the probability (dense, as the loss hands it back, and channels-last) and
   the depth (and of each alone), against the plain formula in float64
   (1e-5 of max, bf16 plus one bf16 step), two launches and the two
   layouts bit-equal, the wrapper copying nothing; K9
   and K10 convex_upsample_grad at [4, 144, 128, 160] in both dtypes, K10
   with a seeded gradient of the upsampled map against the plain formula
   in float64 (the same bounds), two launches bit-equal.
8. One train step of the port (`engine.train_loop`) on the card against
   the same step on the CPU (plain versions) at 160x128, batch 2, 3
   views, 2 iterations, the DTU weights: loss and gradients.
9. The training path at full width: 10 steps at 640x512, batch 4, 5
   views, 4 GRU iterations, stage 2 (regress), from a fresh seeded init,
   on one in-memory DTU-layout batch of the plane scene: the loss must
   fall, and each of the four sweep kernels must launch 52 times per
   step, K6, K7 and K8 5 times each, K9 and K10 once, K11 and K12 13
   times each, K13-K16 4 times each, K17, K18 and K22 13 times each,
   K21 16 times, K19 and K20 twice each, K23, K24, K25, K26 and K27
   once, K28 6 times and K29 4 times, no var_mean op or kernel, no
   bilinear resize or tanh of PyTorch's, no gather or argmax of the
   eager loss, no kernel of the eager update (a foreach kernel, or anything but K25
   and K26 under the `clip_adam` label; "optimizer" 0 ms) and nothing but
   K27 under the `depth_metrics` label may run in the profiled step,
   which is held against the launch plan as in step 6, K23's wrapper
   must copy no input and K7's and K20's no gradient (K7 reads K24's
   dense ∂p in place; so in steps 10 and 11 too, `hold_loss_path`), and
   the layout of each one K7 and K20 get is
   printed (`prob_grad_layouts`, `fpn_grad_layouts`; K7's all dense);
   ms per step, steps/s, peak memory and one
   profiled step's device time by kind, idle share and the labelled
   chains' forward device time and launches; then a validation step and a
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
   launches of K1, K2, K4, K5 and one all-reduce of the metrics' table
   per rank per step; ms per step of the two
   processes sharing the card. `train_ddp_nccl` runs the synced path
   (global BN statistics, global loss and metric denominators, summed
   gradients) as one NCCL rank against the plain step from the same
   init, 5 steps each, in f32 with the same gates and in bf16, where
   the loss and parameter bounds lie below bf16's own noise: there the
   BN statistics (1e-4, relative L2), the launches and finite losses are
   gated, and the first loss and parameters are printed beside two plain
   bf16 steps from the init perturbed by 1e-7; ms per step of both forms
   and one profiled step each (device time by kind).
11. The entry points (`itermvs_tpu_torch/entry.py`, `entry_dryrun`):
   `entry()`'s forward (a fresh seed-0 init, 128x160, 5 views, 4
   iterations) on the card, launching K1 and K2 52 times, K6 and K8 5
   times and K9 once, its depth held against `entry(device="cpu")`'s
   (median relative difference at most 1e-4, fewer than 1% of the pixels
   beyond 1e-3; the share and the largest such patch printed), ms per
   call; then `dryrun_multichip(2)`: two gloo processes sharing the card
   take the JAX dry run's steps at 64x96, 3 views, 2 iterations, one
   sample each, with a checkpoint after step 2 restored into a fresh
   model and optimizer; the restored step's loss within 1e-6 of the
   live one's, the ranks bit-equal after it, each rank's launches in
   each step as planned (14 of K1, K2, K4, K5, 3 of K6, K7, K8, one of
   K9, K10), and step 1's loss within 1e-4 of one process's step over
   both samples; the dry run's wall seconds.
12. `--debug_nans` (`engine/profiling.py`): one 1600x1152 depth map with
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
then K6 (training form) with K7 on both gradient layouts, K9 and K10
in both dtypes at small shapes (`check_edge_shapes`: K6's and K7's
ragged tiles, aligned or not; maps of one row, one column, 2x3, and
even widths of 66 and 2, where K9/K10 take their paired path) and K8
bit for bit on small sweeps (one column, odd widths, 1 and 32 samples,
a broadcast depth),
then the same 5 depth maps run in bf16 (each map's median error < 0.05
and within max(1.15 f32, f32 + 0.01) of the f32 run's; 52 launches of
each forward form per map; maps/s, device time by kind, idle share, the
chains) and `eval_pipeline` in bf16;
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

After the bf16 maps, `eval_ddp_2rank` runs the eval CLI's data-parallel
mode on the same 5 maps at `--batch_size 2`: two processes share the
card over gloo, each joined before it calls the port. Each renders the
scene from the seed, takes its rows of the 3 global batches through
`data.loader.eval_batches` (the last batch padded: rank 1's last row is
padding) and runs `run_depth` with their `n_real`, the feature cache
off, in f32 on the uint16 and the float32 wire and in bf16 on the uint16
wire, under deterministic cuDNN, each rank into a directory of its own;
after the barrier of `eval.fuse_once`, as the CLI's main, rank 0 links
the ranks' maps into one directory (a map two ranks wrote fails) and
fuses the f32 maps. Held: each rank wrote the maps of its real rows and
no other, the maps equal one process's at batch 1 with the cache off
bit for bit, each rank launched each kernel as planned for its 3 rows,
and the fused cloud passes step 5's gate with K3 launched once per view.

The last line is `{"ok": true, "device": {...}}`; any failed phase
exits non-zero before it. Without a CUDA device, or outside the repo,
the script exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

from itermvs_tpu_torch import entry as entry_points
from itermvs_tpu_torch import kernels
from itermvs_tpu_torch.engine import metrics as engine_metrics
from itermvs_tpu_torch.engine import train_loop
from itermvs_tpu_torch.engine.checkpoint import restore_checkpoint, save_checkpoint
from itermvs_tpu_torch.engine.profiling import maybe_enable_nan_debugging
from itermvs_tpu_torch.engine.train_loop import (
    forward_loss, init_weights, make_optimizer, to_device_batch, train_step, val_step)
from itermvs_tpu_torch.data.loader import eval_batches, slice_batch
from itermvs_tpu_torch.eval import fuse_once, run_depth
from itermvs_tpu_torch.fusion import MemoryViews, consistency_matrices, fuse_views
from itermvs_tpu_torch.io import read_pfm, read_ply
from itermvs_tpu_torch.models import Pipeline
from itermvs_tpu_torch.models import itermvs as itermvs_model
from itermvs_tpu_torch.models.itermvs import (
    CORR_INTERVALS, GROUPS, HIDDEN_DIM, INTERVAL_SCALE, LEVELS, NUM_INIT_SAMPLES,
    initial_depth_samples)
from itermvs_tpu_torch.ops import bn_act as bn_ops
from itermvs_tpu_torch.ops import bn_stats as stats_ops
from itermvs_tpu_torch.ops import clip_adam as clip_ops
from itermvs_tpu_torch.ops import conv_gru
from itermvs_tpu_torch.ops import depth_metrics as metric_ops
from itermvs_tpu_torch.ops import full_loss as full_loss_ops
from itermvs_tpu_torch.ops import resize as resize_ops
from itermvs_tpu_torch.ops.consistency import (
    MAX_SOURCES, consistency, consistency_plain, launch_consistency, record)
from itermvs_tpu_torch.ops.counts import KERNEL_NAMES, launch_counts, reset_launch_counts
from itermvs_tpu_torch.ops.depth_range import depth_unnormalization
from itermvs_tpu_torch.ops.depth_readout import (
    NUM_BINS, DepthReadout, depth_readout, depth_readout_grad, depth_readout_grad_plain,
    depth_readout_plain, launch_depth_readout, launch_depth_readout_grad, prob_grad_strides)
from itermvs_tpu_torch.ops.sweep import (
    launch_sweep_premul, sample_chunks, sweep_premul, sweep_premul_plain)
from itermvs_tpu_torch.ops.sweep_epilogue import (
    corr_epilogue, corr_epilogue_plain, launch_corr_epilogue)
from itermvs_tpu_torch.ops.sweep_grad import (
    SweepCorr, launch_sweep_grad_ref, launch_sweep_grad_src, sweep_grad_ref,
    sweep_grad_ref_plain, sweep_grad_src, sweep_grad_src_plain)
from itermvs_tpu_torch.ops.upsample import (
    CHANNELS, convex_upsample_grad, convex_upsample_grad_plain, convex_upsample_plain,
    fold_is_programmatic, launch_convex_upsample, launch_convex_upsample_grad,
    upsample_depth)
from itermvs_tpu_torch.ops.view_aggregate import (
    view_aggregate, view_aggregate_args, view_aggregate_grad, view_aggregate_grad_args,
    view_aggregate_grad_plain, view_aggregate_plain)
from itermvs_tpu_torch.ops.warping import (
    fused_sweep_taps, fused_sweep_taps_plain, launch_sweep_taps, relative_projection,
    sample_table)
from itermvs_tpu_torch.parallel import launch, mesh
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


def projection_pyramid(K, E):
    """{"level_l": K_l·E} for l = 0..3, K's first two rows scaled by
    0.5^l, as the loader makes them."""
    pyr = {}
    for level in range(4):
        k = K.copy()
        k[:2] *= 0.5 ** level
        p = E.copy()
        p[:3, :4] = k @ E[:3, :4]
        pyr[f"level_{level}"] = p
    return pyr


def samples_of(cams, images, uint8=False):
    """One batch-1 sample per reference view of a rendered scene, in the
    loader's layout (uint8 images scaled to [-1, 1] as the loader does,
    or with `uint8` left raw, as its `uint8_level0=True` gives them; only
    level_0 images, which is all the model reads)."""
    views = len(cams)
    imgs = [u8 if uint8 else 2.0 * u8.astype(np.float32) / 255.0 - 1.0 for u8 in images]
    projs = [projection_pyramid(K, E) for K, E in cams]
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


def pinned(samples):
    """`samples` as save_depth's loader delivers them on a card: every
    array the model reads a page-locked tensor, so that run_depth's
    uploads are asynchronous."""
    def pin(x):
        return torch.from_numpy(np.ascontiguousarray(x)).pin_memory()

    return [dict(s, imgs={k: pin(v) for k, v in s["imgs"].items()},
                 proj_matrices={k: pin(v) for k, v in s["proj_matrices"].items()},
                 depth_min=pin(s["depth_min"]), depth_max=pin(s["depth_max"]))
            for s in samples]


def h2d_bytes_per_map(samples, feature_cache=True):
    """Host→device bytes per map of run_depth over `samples`: the level-1..3
    projections and depth range of every map, and the level_0 image of
    each view the first time it is met (every view of every map without
    the feature cache)."""
    seen, total = set(), 0
    for s in samples:
        level0 = s["imgs"]["level_0"]
        per_view = level0[0, 0].nbytes
        for i, vid in enumerate(np.asarray(s["view_ids"]).reshape(-1)):
            if not feature_cache or (s["scan"][0], int(vid)) not in seen:
                seen.add((s["scan"][0], int(vid)))
                total += per_view
        total += sum(v.nbytes for k, v in s["proj_matrices"].items() if k != "level_0")
        total += s["depth_min"].nbytes + s["depth_max"].nbytes
    return total / len(samples)


def pfm_diff(got_dir, want_dir, views):
    """Per view, the largest |Δ| of depth and of confidence between two
    runs' PFMs and the count of pixels where either differs."""
    recs = []
    for v in range(views):
        maps = {}
        for kind in ("depth_est", "confidence"):
            got, _ = read_pfm(os.path.join(got_dir, kind, f"{v:08d}.pfm"))
            want, _ = read_pfm(os.path.join(want_dir, kind, f"{v:08d}.pfm"))
            if got.shape != want.shape:
                raise SystemExit(f"view {v} {kind}: shapes {got.shape} != {want.shape}")
            maps[kind] = (got, want)
        differs = np.zeros(maps["depth_est"][0].shape, bool)
        rec = {"view": v}
        for kind, (got, want) in maps.items():
            delta = np.abs(got.astype(np.float64) - want)
            rec[f"max_abs_d{kind.split('_')[0]}"] = float(np.nanmax(delta))
            differs |= got != want
        rec["differing_pixels"] = int(differs.sum())
        recs.append(rec)
    return recs


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


# ------------------------------------------ K6, K7, K8: readout and taps
# The plain versions of K6 and K8 run on the card as PyTorch runs them:
# K8 must be bit-equal (flat_idx and taps), K6 must pick the same argmax
# on every pixel and come within READOUT_TOL of the depth and the
# probability (it sums exp(l - max) in PyTorch's order; the window's 9
# terms may be summed in another order than torch's reduction).
READOUT_TOL = 1e-6
# Operations per element, as the plain versions count them: K6 per bin
# the max compare, subtract, exp and sum (3 more for p in training); K7
# per bin g_k, its product with p and the sum, then p (g - dot); K8 per
# (view, sample, pixel) the grid scale, rot . (x, y, 1), the projection,
# the divides, both axes' taps and the 4 products.
K6_OPS_PER_BIN, K6_TRAIN_OPS_PER_BIN, K7_OPS_PER_BIN, K8_OPS = 4, 7, 6, 45


def level_projections(cams, batch, level):
    """[batch, V, 4, 4] projections at pyramid level `level`
    (`projection_pyramid`), each batch entry with its own reference view
    b first, then the others."""
    pyrs = [projection_pyramid(K, E) for K, E in cams]
    order = [[ref] + [v for v in range(len(cams)) if v != ref] for ref in range(batch)]
    return torch.from_numpy(np.stack([np.stack([pyrs[v][f"level_{level}"] for v in vids])
                                      for vids in order])).cuda()


def taps_cases(width, height, views, batch, gen):
    """K8's inputs at the two sweeps of one forward pass at width x
    height, from the plane scene's cameras: (name, rel_projs [B, V-1, L,
    4, 4], depth samples [B, N, h, w], level_of_sample, src_hws, launches
    per pass). `init`: 32 inverse-depth samples (a broadcast view, as the
    model passes them) on the 1/8 grid over level 3; `iter`: 10 samples
    around a seeded normalized depth on the 1/4 grid over levels 1-3;
    `edges`: `iter` with planted samples behind the camera (z < 0 and
    0 < z <= 1e-2), NaN and huge depths, and the second source moved 50
    times as far, so that samples land off the map and at floor = -1."""
    cams = make_cameras(views, width, height, np.random.RandomState(SEED))
    rel = {l: relative_projection(p[:, 1:], p[:, :1]) for l in (1, 2, 3)
           for p in (level_projections(cams, batch, l),)}
    idmin = torch.full((batch,), 1.0 / DEPTH_MIN, device="cuda")
    idmax = torch.full((batch,), 1.0 / DEPTH_MAX, device="cuda")
    h4, w4 = height // 4, width // 4
    init = initial_depth_samples(idmin, idmax, h4 // 2, w4 // 2)
    intervals = torch.tensor(sum((CORR_INTERVALS[k] for k in LEVELS), ()),
                             device="cuda").reshape(1, -1, 1, 1) * INTERVAL_SCALE
    norm = torch.rand(batch, 1, h4, w4, device="cuda", generator=gen)
    samples = depth_unnormalization(torch.clamp(norm + intervals, 0.0, 1.0),
                                    idmin.reshape(-1, 1, 1, 1), idmax.reshape(-1, 1, 1, 1))
    edges = samples.clone()
    edges[:, :, 0] = -1.0
    edges[:, :, 1, : w4 // 2] = 0.005
    edges[:, :, 2, 0] = float("nan")
    edges[:, :, 3, 0] = 1e30
    rel_edges = torch.stack([rel[l] for l in (1, 2, 3)], dim=2).clone()
    rel_edges[:, 1, :, :3, 3] *= 50.0
    srcs = ((height // 2, width // 2), (h4, w4), (height // 8, width // 8))
    counts = [len(CORR_INTERVALS[k]) for k in LEVELS]
    level_of_sample = tuple(sum(([i] * c for i, c in enumerate(counts)), []))
    iteration_rel = torch.stack([rel[l] for l in (1, 2, 3)], dim=2)
    return [("init", rel[3][:, :, None].contiguous(), init, (0,) * NUM_INIT_SAMPLES,
             (srcs[2],), 1),
            ("iter", iteration_rel, samples, level_of_sample, srcs, None),
            ("edges", rel_edges, edges, level_of_sample, srcs, 0)]


def bits(t):
    """The bits of a float tensor, as integers of its width."""
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def check_sweep_taps(width, height, views, batch, iteration, dtype, per):
    """K8 (the form for tables of `dtype`) against its plain version on the
    card, bit for bit, on `taps_cases` at width x height; times the bare
    launch (`ms`, outputs allocated beforehand), the wrapper (`call_ms`)
    and the plain version, with the byte bound. One JSON line per case;
    returns the totals of one pass ({report name: ...}, `iteration`
    launches of the `iter` case and one of `init`)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 2)
    kname = kernel_name("sweep_taps", dtype)
    size = torch.tensor([], dtype=dtype).element_size()
    tot = {"ms": 0.0, "call_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0,
           "library_ms": None, "bytes": 0.0, "ops": 0.0}
    for name, rel, depth, levels, srcs, launches in taps_cases(width, height, views, batch,
                                                               gen):
        launches = iteration if launches is None else launches
        b, n, h, w = depth.shape
        v = rel.shape[1]
        want_idx, want_taps = fused_sweep_taps_plain(rel, depth, levels, srcs, dtype)
        got_idx, got_taps = fused_sweep_taps(rel, depth, levels, srcs, dtype)
        if not (torch.equal(got_idx, want_idx) and torch.equal(bits(got_taps), bits(want_taps))):
            bad = int((got_idx != want_idx).sum()) + int((bits(got_taps) != bits(want_taps)).sum())
            raise SystemExit(f"{kname} at {name}: {bad} values differ from its plain version")
        table = sample_table(levels, srcs, h, w)
        wsum = want_taps.float().sum(dim=0)
        # The init sweep's samples are a broadcast view: its storage is read.
        nbytes = (depth.untyped_storage().nbytes() + 4 * rel.numel()
                  + want_idx.numel() * (4 + 4 * size))
        ops = K8_OPS * want_idx.numel()
        rec = {"ms": time_ms(lambda: launch_sweep_taps(rel, depth, table, got_idx, got_taps)),
               "call_ms": time_ms(lambda: fused_sweep_taps(rel, depth, levels, srcs, dtype)),
               "plain_ms": time_ms(lambda: fused_sweep_taps_plain(rel, depth, levels, srcs,
                                                                  dtype)),
               "library_ms": None}
        rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes, ops)
        print(json.dumps({"kernel": kname, "shape": name, "batch": b, "views": v, "n": n,
                          "hw": [h, w], "src_hw": list(srcs), f"launches_per_{per}": launches,
                          "bit_equal": True, "outputs_all_taps_zero": int((wsum == 0).sum()),
                          "outputs_partial_taps": int(((wsum > 0) & (wsum < 0.999)).sum()),
                          **rec, "share": rec["bound_ms"] / rec["ms"]}))
        for key in ("ms", "call_ms", "plain_ms", "bound_ms"):
            tot[key] += launches * rec[key]
        tot["bytes"] += launches * nbytes
        tot["ops"] += launches * ops
        del want_idx, want_taps, got_idx, got_taps
    torch.cuda.empty_cache()
    return {kname: tot}


# Per dtype the near-tie pair of logits: exp(lo - hi) rounds to 1 in
# float32, so both bins reach p's maximum, though hi > lo.
NEAR_TIES = {torch.float32: (0.125, 0.125 + 2.0 ** -26),
             torch.bfloat16: (2.0 ** -20, 2.0 ** -20 * (1 + 2.0 ** -7))}


def readout_logits(b, h, w, gen, dtype, dev="cuda"):
    """Seeded depth-head logits [b, 256, h, w] in `dtype`: noise plus a
    peak at a random bin per pixel, with planted rows: row 0 the argmax at
    bins 0-4 and 251-255 (clipped windows), row 1 exact ties of the
    maximum (every bin equal on even columns, bins 7 and 200 equal on odd
    ones), row 2 near-ties (NEAR_TIES at bins 30 and 40 over -5
    elsewhere; on even columns the larger logit at the later bin, where
    the first bin wins on p)."""
    k = torch.arange(NUM_BINS, device=dev, dtype=torch.float32).reshape(1, -1, 1, 1)
    centre = torch.rand(b, 1, h, w, device=dev, generator=gen) * (NUM_BINS - 1)
    x = (torch.randn(b, NUM_BINS, h, w, device=dev, generator=gen) * 1.5
         + 10.0 * torch.exp(-(k - centre) ** 2 / 18.0))
    cols = torch.arange(w, device=dev)
    edge = torch.tensor([0, 1, 2, 3, 4, 251, 252, 253, 254, 255], device=dev)[cols % 10]
    row0 = x[:, :, 0, :]
    row0.scatter_add_(1, edge.reshape(1, 1, w).expand(b, 1, w),
                      torch.full((b, 1, w), 40.0, device=dev))
    x[:, :, 1, 0::2] = 0.0
    x[:, 7, 1, 1::2] = 50.0
    x[:, 200, 1, 1::2] = 50.0
    lo, hi = NEAR_TIES[dtype]
    x[:, :, 2, :] = -5.0
    x[:, 30, 2, 0::2], x[:, 40, 2, 0::2] = lo, hi
    x[:, 30, 2, 1::2], x[:, 40, 2, 1::2] = hi, lo
    return x.to(dtype).contiguous()


def check_readout(b, h, w, dtype, launches, per, train):
    """K6 (and, with `train`, K7) of `dtype`'s logits against their plain
    versions on the card at [b, 256, h, w] on `readout_logits`: K6 the
    same argmax on every pixel and READOUT_TOL on the depth and the
    probability; the eval form (no probability) the same depth bits as
    the training form. K7 on K6's own outputs with a seeded gradient of
    the probability (dense, as the training loss hands it back, and
    channels-last) and of the depth, with the depth's alone and with the
    probability's alone, against the plain formula in float64
    (`hold_grad`: 1e-5 of max|plain|, for bf16 plus one bf16 step of
    |plain|); two launches bit-equal, and the two layouts' results too.
    Times the bare launches (`ms`; K7's on the dense gradient, the
    training loss's layout, and `ms_channels_last`), the wrappers
    (`call_ms`, K7's on both layouts, neither of which it may copy) and
    the plain versions; one JSON line per kernel, whose totals (times
    `launches`) it returns."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 3)
    size = torch.tensor([], dtype=dtype).element_size()
    pixels = b * h * w
    logits = readout_logits(b, h, w, gen, dtype)
    f32 = dict(device="cuda", dtype=torch.float32)
    depth, prob = torch.empty(b, 1, h, w, **f32), torch.empty(b, NUM_BINS, h, w, **f32)
    index = torch.empty(b, 1, h, w, device="cuda", dtype=torch.int32)
    mass, regress = torch.empty_like(depth), torch.empty_like(depth)
    launch_depth_readout(logits, depth, prob, index, mass, regress)
    want = depth_readout_plain(logits)
    d_err = (depth - want[0]).abs().max().item()
    p_err = (prob - want[1]).abs().max().item()
    same_argmax = torch.equal(index.long(), want[2])
    eval_depth = torch.empty_like(depth)
    launch_depth_readout(logits, eval_depth)
    torch.cuda.synchronize()
    planted = {"row0_argmax": index[:, 0, 0, :10].tolist(),
               "row2_near_tie_argmax": index[0, 0, 2, :2].tolist()}
    kname = kernel_name("depth_readout", dtype)
    ops = (K6_TRAIN_OPS_PER_BIN if train else K6_OPS_PER_BIN) * NUM_BINS * pixels
    nbytes = pixels * (NUM_BINS * size + 4 + ((NUM_BINS * 4 + 12) if train else 0))
    if train:
        run = lambda: launch_depth_readout(logits, depth, prob, index, mass, regress)
    else:
        run = lambda: launch_depth_readout(logits, eval_depth)
    k6 = {"ms": time_ms(run),
          "call_ms": time_ms(lambda: depth_readout(logits, train)),
          "plain_ms": time_ms(lambda: depth_readout_plain(logits)), "library_ms": None}
    k6["bound_ms"], k6["bound_by"] = bound_ms(nbytes, ops)
    print(json.dumps({"kernel": kname, "shape": [b, NUM_BINS, h, w], "form":
                      "training (writes p)" if train else "eval (no p)",
                      f"launches_per_{per}": launches, "same_argmax": same_argmax,
                      "max_abs_err": d_err, "prob_max_abs_err": p_err, "tol": READOUT_TOL,
                      "eval_form_depth_bit_equal": torch.equal(bits(eval_depth), bits(depth)),
                      **planted, **k6, "share": k6["bound_ms"] / k6["ms"]}))
    if not same_argmax:
        raise SystemExit(f"{kname}: argmax differs from the plain version at "
                         f"{int((index.long() != want[2]).sum())} pixels")
    if not (d_err <= READOUT_TOL and p_err <= READOUT_TOL):
        raise SystemExit(f"{kname}: |depth| err {d_err}, |p| err {p_err} > {READOUT_TOL}")
    if not torch.equal(bits(eval_depth), bits(depth)):
        raise SystemExit(f"{kname}: the eval form's depth differs from the training form's")
    out = {kname: {**{key: launches * k6[key] for key in ("ms", "call_ms", "plain_ms",
                                                          "bound_ms")},
                   "max_abs_err": max(d_err, p_err), "library_ms": None,
                   "bytes": launches * nbytes, "ops": launches * ops}}
    if not train:
        return out

    gname = kernel_name("depth_readout_grad", dtype)
    # The probability's gradient channels-last (the layout the loss reads
    # the probability in) and dense (the layout the loss's backward hands
    # back, `prob_grad_layouts`): K7 reads both where they lie.
    d_prob = torch.randn(b, h, w, NUM_BINS, device="cuda", generator=gen).permute(0, 3, 1, 2)
    d_depth = torch.randn(b, 1, h, w, device="cuda", generator=gen)
    d_logits = torch.empty(b, NUM_BINS, h, w, device="cuda", dtype=dtype)
    dense = d_prob.contiguous()
    errs, abs_errs, results = [], [], {}
    for label, dp, dd in (("both gradients, channels-last", d_prob, d_depth),
                          ("both gradients, dense", dense, d_depth),
                          ("depth gradient only", None, d_depth),
                          ("probability gradient only, channels-last", d_prob, None),
                          ("probability gradient only, dense", dense, None)):
        if not repeats_equal(lambda: launch_depth_readout_grad(prob, dp, dd, index, mass,
                                                               regress, d_logits), d_logits):
            raise SystemExit(f"{gname} at {label}: two launches differ")
        exact = depth_readout_grad_plain(
            prob.double(), index, mass.double(), regress.double(),
            None if dp is None else dp.double(), None if dd is None else dd.double(),
            torch.float64).to(dtype)
        err, scale = hold_grad(gname, d_logits, exact, label)
        abs_errs.append(err)
        errs.append(err / max(scale, 1e-30))
        results[label] = d_logits.clone()
        del exact
    layouts_equal = all(torch.equal(bits(results[f"{g}, channels-last"]),
                                    bits(results[f"{g}, dense"]))
                        for g in ("both gradients", "probability gradient only"))
    if not layouts_equal:
        raise SystemExit(f"{gname}: the channels-last and the dense gradient's results differ")
    nbytes = pixels * (NUM_BINS * (8 + size) + 16)
    ops = K7_OPS_PER_BIN * NUM_BINS * pixels
    copies = depth_readout_grad.copies
    k7 = {"ms": time_ms(lambda: launch_depth_readout_grad(prob, dense, d_depth, index, mass,
                                                          regress, d_logits)),
          "ms_channels_last": time_ms(lambda: launch_depth_readout_grad(
              prob, d_prob, d_depth, index, mass, regress, d_logits)),
          "call_ms": time_ms(lambda: depth_readout_grad(prob, index, mass, regress, dense,
                                                        d_depth, dtype)),
          "call_ms_channels_last": time_ms(lambda: depth_readout_grad(
              prob, index, mass, regress, d_prob, d_depth, dtype)),
          "plain_ms": time_ms(lambda: depth_readout_grad_plain(
              prob, index, mass, regress, d_prob, d_depth, dtype)), "library_ms": None}
    if depth_readout_grad.copies != copies:
        raise SystemExit(f"{gname}: the wrapper copied a dense or channels-last gradient")
    k7["bound_ms"], k7["bound_by"] = bound_ms(nbytes, ops)
    print(json.dumps({"kernel": gname, "shape": [b, NUM_BINS, h, w],
                      f"launches_per_{per}": launches, "max_rel_err": errs,
                      "repeat_bit_equal": True, "layouts_bit_equal": layouts_equal,
                      "ms_layout": "dense (the loss's)", **k7,
                      "share": k7["bound_ms"] / k7["ms"]}))
    out[gname] = {**{key: launches * k7[key] for key in (
                      "ms", "ms_channels_last", "call_ms", "call_ms_channels_last", "plain_ms",
                      "bound_ms")},
                  "max_abs_err": max(abs_errs), "max_rel_err": max(errs), "library_ms": None,
                  "bytes": launches * nbytes, "ops": launches * ops, "launches": launches}
    del logits, prob, d_prob, dense, d_logits, results
    torch.cuda.empty_cache()
    return out


# K9 against its plain version: |up| <= 1 (a convex combination of
# normalized depths), and the kernel computes the same float32 softmax and
# 9-term sum, summed in another order than torch's reduction.
UPSAMPLE_TOL = 1e-6
# Operations per sub-pixel, as the plain versions count them: K9 the
# softmax's 8 maxima, 9 subtracts, exps, adds and divides, then 9 products
# and adds; K10 that again plus per tap g * w, t - up, its product and the
# sum over the sub-pixels (the fold's few adds per pixel not counted).
K9_OPS, K10_OPS = 62, 98


def upsample_work(b, h, w, dtype, grad):
    """(bytes, operations) of K9 (or, with `grad`, K10) at [b, 144, h, w]:
    each input read once, each output written once (K10's scratch P not
    counted), and the operations per sub-pixel above."""
    size = torch.tensor([], dtype=dtype).element_size()
    pixels = b * h * w
    if grad:
        return pixels * (2 * CHANNELS * size + 4 + 64 + 4), K10_OPS * 16 * pixels
    return pixels * (CHANNELS * size + 4 + 64), K9_OPS * 16 * pixels


def upsample_inputs(b, h, w, gen, dtype, dev="cuda"):
    """Seeded K9/K10 inputs: a normalized depth x [b, 1, h, w] in [0, 1)
    and mask logits [b, 144, h, w] in `dtype`, N(0, 4), with planted
    borders: on rows 0 and h-1 and columns 0 and w-1 the three taps that
    clamp there (dy = -1, dy = +1, dx = -1, dx = +1) get +30 on every
    sub-pixel, so that the edge-padded neighbours carry almost all the
    weight (at a corner the doubly clamped tap, +60, all of it)."""
    x = torch.rand(b, 1, h, w, device=dev, generator=gen)
    logits = torch.randn(b, CHANNELS, h, w, device=dev, generator=gen) * 2.0
    taps = logits.view(b, 9, 16, h, w)
    taps[:, 0:3, :, 0] += 30.0                  # dy = -1
    taps[:, 6:9, :, h - 1] += 30.0              # dy = +1
    taps[:, 0::3, :, :, 0] += 30.0              # dx = -1
    taps[:, 2::3, :, :, w - 1] += 30.0          # dx = +1
    return x, logits.to(dtype).contiguous()


def check_upsample(b, h, w, dtype, launches, per, train):
    """K9 (and, with `train`, K10) of `dtype`'s mask logits against their
    plain versions on the card at [b, 144, h, w] on `upsample_inputs`: K9
    within UPSAMPLE_TOL, its wrapper's output equal to the bare launch's;
    K10 against the plain formula in float64 (`hold_grad`: 1e-5 of
    max|plain|, bf16 logits' gradient plus one bf16 step of |plain|),
    two launches bit-equal. Times the bare launches (`ms`, outputs
    allocated beforehand), the wrappers (`call_ms`) and the plain
    versions; one JSON line per kernel (K10's says whether its fold was a
    programmatic dependent launch), whose totals (times `launches`) it
    returns."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 4)
    x, logits = upsample_inputs(b, h, w, gen, dtype)
    up = torch.empty(b, 1, 4 * h, 4 * w, device="cuda")
    launch_convex_upsample(x, logits, up)
    want = convex_upsample_plain(x, logits)
    err = (up - want).abs().max().item()
    same_wrapper = torch.equal(upsample_depth(x, logits), up)
    kname = kernel_name("convex_upsample", dtype)
    nbytes, ops = upsample_work(b, h, w, dtype, grad=False)
    k9 = {"ms": time_ms(lambda: launch_convex_upsample(x, logits, up)),
          "call_ms": time_ms(lambda: upsample_depth(x, logits)),
          "plain_ms": time_ms(lambda: convex_upsample_plain(x, logits)), "library_ms": None}
    k9["bound_ms"], k9["bound_by"] = bound_ms(nbytes, ops)
    print(json.dumps({"kernel": kname, "shape": [b, CHANNELS, h, w],
                      f"launches_per_{per}": launches, "max_abs_err": err,
                      "tol": UPSAMPLE_TOL, "wrapper_equal": same_wrapper,
                      "border_max_abs_err": max(
                          (up - want)[..., rows, cols].abs().max().item()
                          for rows, cols in ((slice(0, 4), slice(None)),
                                             (slice(-4, None), slice(None)),
                                             (slice(None), slice(0, 4)),
                                             (slice(None), slice(-4, None)))),
                      **k9, "share": k9["bound_ms"] / k9["ms"]}))
    if not err <= UPSAMPLE_TOL:
        raise SystemExit(f"{kname}: max |kernel - plain| {err} > {UPSAMPLE_TOL}")
    if not same_wrapper:
        raise SystemExit(f"{kname}: the wrapper's output differs from the bare launch's")
    out = {kname: {**{key: launches * k9[key] for key in ("ms", "call_ms", "plain_ms",
                                                          "bound_ms")},
                   "max_abs_err": err, "library_ms": None,
                   "bytes": launches * nbytes, "ops": launches * ops}}
    if not train:
        return out

    gname = kernel_name("convex_upsample_grad", dtype)
    grad = torch.randn(b, 1, 4 * h, 4 * w, device="cuda", generator=gen)
    d_x = torch.empty_like(x)
    d_logits = torch.empty_like(logits)
    partial = torch.empty(b, 9, h, w, device="cuda")
    run = lambda: launch_convex_upsample_grad(x, logits, grad, d_x, d_logits, partial)
    run()
    exact_x, exact_l = convex_upsample_grad_plain(x.double(), logits.double(), grad.double(),
                                                  torch.float64)
    errs = {}
    for label, got, exact in (("d_logits", d_logits, exact_l.to(dtype)),
                              ("d_x", d_x, exact_x.float())):
        e, scale = hold_grad(gname, got, exact, label)
        errs[label] = (e, e / max(scale, 1e-30))
    del exact_x, exact_l
    first_x, first_l = d_x.clone(), d_logits.clone()
    run()
    torch.cuda.synchronize()
    repeats = torch.equal(first_x, d_x) and torch.equal(bits(first_l), bits(d_logits))
    nbytes, ops = upsample_work(b, h, w, dtype, grad=True)
    k10 = {"ms": time_ms(run),
           "call_ms": time_ms(lambda: convex_upsample_grad(x, logits, grad)),
           "plain_ms": time_ms(lambda: convex_upsample_grad_plain(x, logits, grad, dtype)),
           "library_ms": None}
    k10["bound_ms"], k10["bound_by"] = bound_ms(nbytes, ops)
    print(json.dumps({"kernel": gname, "shape": [b, CHANNELS, h, w],
                      f"launches_per_{per}": launches,
                      "max_abs_err": {k: v[0] for k, v in errs.items()},
                      "max_rel_err": {k: v[1] for k, v in errs.items()},
                      "two_launches_bit_equal": repeats,
                      "fold_programmatic": fold_is_programmatic(),
                      **k10, "share": k10["bound_ms"] / k10["ms"]}))
    if not repeats:
        raise SystemExit(f"{gname}: two launches on the same inputs differ")
    out[gname] = {**{key: launches * k10[key] for key in ("ms", "call_ms", "plain_ms",
                                                          "bound_ms")},
                  "max_abs_err": max(v[0] for v in errs.values()),
                  "max_rel_err": max(v[1] for v in errs.values()), "library_ms": None,
                  "bytes": launches * nbytes, "ops": launches * ops, "launches": launches}
    del x, logits, up, grad, d_x, d_logits, partial, first_x, first_l
    torch.cuda.empty_cache()
    return out


# Small shapes for the kernels' edges: K6 with ragged last tiles (H*W
# not a multiple of its 64-pixel tile), once with rows that are not
# 16-byte aligned (77 pixels: the element-wise copy) and once with rows
# that are (120); K9/K10 on maps of one row, one column and 2x3 (not
# 2x2: there every pixel is a corner, whose doubly clamped tap, +60 in
# `upsample_inputs`, takes all the weight, so that dlogits vanishes,
# max 4.6e-11, and 1e-5 of it lies below float32's rounding), where odd
# widths take the kernels' scalar path with a one-pixel pair at each
# row's end, and at the even widths 66 (a row of 33 pairs, so that a
# block's 32 pairs end inside a row) and 2 (one pair a row) on their
# paired path. K6's maps keep H*W above 64: at 64 positions or fewer
# PyTorch's softmax on the card splits each position's sum over several
# threads, so the plain version's p is then no longer summed in bin
# order (at 7x9 it lies 1.01e-6 from K6's, beyond READOUT_TOL).
READOUT_EDGE_SHAPES = ((3, 7, 11), (2, 10, 12))
UPSAMPLE_EDGE_SHAPES = ((2, 1, 3), (1, 5, 1), (3, 2, 3), (2, 3, 66), (1, 4, 2))
# K8's edge sweeps (batch, samples, h, w, broadcast depth): a one-column
# grid, odd widths (a thread's last pair ragged, scalar stores), one
# sample, and 32 samples (every sample group full) from a broadcast view
# as the init sweep passes them.
TAPS_EDGE_SHAPES = ((2, 3, 5, 1, False), (1, 10, 4, 7, False), (2, 1, 3, 6, False),
                    (1, 32, 3, 5, True), (2, 32, 4, 9, False))


def taps_edge_inputs(b, n, h, w, broadcast, gen, dev="cuda"):
    """K8's inputs on a small sweep: (rel_projs [b, 3, 3, 4, 4],
    depth [b, n, h, w], level_of_sample, src_hws). The projections are the
    identity perturbed by ~1e-2 with translations of up to 3 pixels, so
    that samples fall inside the source maps, on their last row and
    column and past every edge; the levels cycle (0, 0, 1, 2, 1, ...), so
    that a level's samples are not all together; the depths lie in [0.5,
    4] with planted ones behind the camera (z < 0 and 0 < z <= 1e-2), a
    NaN and a huge one (the last three only without `broadcast`, whose
    samples are one depth per (batch, sample))."""
    rel = torch.eye(4, device=dev).repeat(b, 3, 3, 1, 1)
    rel[..., :3, :3] += 1e-2 * torch.randn(b, 3, 3, 3, 3, device=dev, generator=gen)
    rel[..., :2, 3] = 3.0 * (2 * torch.rand(b, 3, 3, 2, device=dev, generator=gen) - 1)
    levels = tuple((0, 0, 1, 2, 1)[s % 5] for s in range(n))
    src_hws = ((2 * h, 2 * w), (h, w), ((h + 1) // 2, (w + 1) // 2))
    if broadcast:
        depth = (0.5 + 3.5 * torch.rand(b, n, 1, 1, device=dev, generator=gen))
        depth[:, 0] = -1.0
        return rel, depth.expand(b, n, h, w), levels, src_hws
    depth = 0.5 + 3.5 * torch.rand(b, n, h, w, device=dev, generator=gen)
    depth[:, 0, 0] = -1.0
    depth[:, -1, -1, :] = 0.005
    depth[0, n // 2, h // 2, 0] = float("nan")
    depth[-1, n // 2, 0, w - 1] = 1e30
    return rel, depth, levels, src_hws


def check_taps_edges():
    """K8, both forms, bit for bit against its plain version on
    `TAPS_EDGE_SHAPES`; one JSON line per form."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 5)
    for dtype in (torch.float32, BF16):
        kname = kernel_name("sweep_taps", dtype)
        for b, n, h, w, broadcast in TAPS_EDGE_SHAPES:
            rel, depth, levels, srcs = taps_edge_inputs(b, n, h, w, broadcast, gen)
            want_idx, want_taps = fused_sweep_taps_plain(rel, depth, levels, srcs, dtype)
            got_idx, got_taps = fused_sweep_taps(rel, depth, levels, srcs, dtype)
            torch.cuda.synchronize()
            if not (torch.equal(got_idx, want_idx)
                    and torch.equal(bits(got_taps), bits(want_taps))):
                raise SystemExit(f"{kname} at edge sweep {(b, n, h, w, broadcast)}: differs "
                                 f"from its plain version")
        print(json.dumps({"kernel": kname, "edge_case": "sweeps",
                          "shapes": [list(c) for c in TAPS_EDGE_SHAPES], "bit_equal": True}))


def check_edge_shapes():
    """K6 (training form) with K7 on both of the probability gradient's
    layouts, K9/K10 and K8 in both dtypes at the edge shapes, under the
    same gates as at the main path's shapes."""
    for dtype in (torch.float32, BF16):
        for b, h, w in READOUT_EDGE_SHAPES:
            check_readout(b, h, w, dtype, 1, "edge_case", train=True)
        for b, h, w in UPSAMPLE_EDGE_SHAPES:
            check_upsample(b, h, w, dtype, 1, "edge_case", train=True)
    check_taps_edges()


# K12's ∂w sums the n·G rows in another order than the plain version's
# reduction: relative L2 within this. K11 and ∂c_v are bit for bit.
VIEW_GRAD_REL = 1e-5
# K11/K12 beside the main path's shapes (label, batch, views, samples n,
# P, stacked): an odd P (the scalar path) on strided views at batch 2,
# 6 sources (eval_tanks.sh's --n_views 7; two of K12's view groups) at
# the map's iteration P, and the rows K12's blocks split: 3 samples (24
# rows: a part-filled block of 32 rows without ∂w, 3 rows per thread
# with it) at the training init's stacked layout, one sample (8 rows)
# and one view.
VIEW_EDGE_CASES = (("odd_p", 2, 3, 4, 7 * 11, True),
                   ("six_sources", 1, 6, 4, 288 * 400, False),
                   ("rows_24", 4, 4, 3, 64 * 80, True),
                   ("one_sample", 2, 4, 1, 128 * 160, False),
                   ("one_view", 2, 1, 4, 128 * 160, False))


def view_aggregate_work(b, nv, rows, p, grad, weight_grad=False):
    """(bytes, operations) of K11 (or, with `grad`, K12) on nv views of
    [b, rows, p]: each input read once, each output written once. K11 per
    element nv products, nv − 1 sums and a divide, per pixel nv adds of
    the weight sum; K12 per view and element a divide and a product, with
    ∂w a subtract, a product and a sum more."""
    e, px = b * rows * p, b * p
    if not grad:
        return 4 * (nv * e + nv * px + e), 2 * nv * e + nv * px
    nbytes, ops = 4 * (nv * px + e + nv * e), nv * px + 2 * nv * e
    if weight_grad:
        nbytes, ops = nbytes + 4 * (nv * e + e + nv * px), ops + 3 * nv * e
    return nbytes, ops


def view_aggregate_inputs(b, nv, n, p, stacked, gen, dev="cuda"):
    """Seeded K11/K12 inputs: nv correlations [b, n, G, p], N(0, 1) (with
    `stacked` the views of one [b, nv, n, G, p] tensor, as the init branch
    passes them), weights [b, nv, p] in [1/nv, 1] (the range of a
    softmax's maximum) and a gradient of the output, N(0, 1)."""
    if stacked:
        corrs = torch.randn(b, nv, n, GROUPS, p, device=dev, generator=gen).unbind(1)
    else:
        corrs = tuple(torch.randn(b, n, GROUPS, p, device=dev, generator=gen)
                      for _ in range(nv))
    weights = 1.0 / nv + (1.0 - 1.0 / nv) * torch.rand(b, nv, p, device=dev, generator=gen)
    grad = torch.randn(b, n, GROUPS, p, device=dev, generator=gen)
    return corrs, weights, grad


def bare_launch(name, args):
    """A call of kernel `name`'s C launcher on `args`, built once."""
    fn = kernels.function(name)
    return lambda: kernels.check_launch(name, fn(*args))


# The profiler now and then records no device event, or only some, for
# the captures of about 0.1 s that start every ten seconds or so (seen
# on the card: 3 of 640 short captures empty, runs of one to three);
# a capture taken after this pause has held every event.
CAPTURE_PAUSE_S = 1.0


# Captures of a profiled map or step against its launch plan, at most.
PLAN_CAPTURES = 3


def plan_counts(by_name):
    """{report name: device kernels} of every hand-written kernel in a
    capture (`by_name`, as `device_summary` gives it)."""
    got = dict.fromkeys(KERNEL_NAMES, 0)
    for name, (calls, _) in by_name.items():
        cat = _category(name)
        if cat in got:
            got[cat] += calls
    return got


def plan_misses(by_name, planned):
    """{report name: [device kernels captured, planned]} of each
    hand-written kernel whose device kernels in a capture are not its
    planned launches times KERNELS_PER_LAUNCH; empty where the capture
    holds them all."""
    got = plan_counts(by_name)
    want = {k: n * KERNELS_PER_LAUNCH.get(k, 1) for k, n in planned.items()}
    return {k: [got[k], n] for k, n in want.items() if got[k] != n}


def device_capture(fn, phase, planned=None):
    """`device_time(fn)`, taken once more after CAPTURE_PAUSE_S where it
    holds no device event; raises naming `phase` if that one is empty
    too, so that no timing line prints from nothing. With `planned` ({report
    name: launches in one call of fn}): up to PLAN_CAPTURES captures, each
    after a pause, until one holds no miss of the plan (`plan_misses`: an
    empty or short capture), else SystemExit naming `phase`; returns
    (by_name, by_category, busy ms, the capture's events)."""
    attempts = 2 if planned is None else PLAN_CAPTURES
    for attempt in range(attempts):
        if planned is None:
            got = device_time(fn)
            miss = None if got[0] else "no device event"
        else:
            events = trace_events(fn)
            got = (*device_summary(events), events)
            miss = plan_misses(got[0], planned) if got[0] else "no device event"
        if not miss:
            return got
        print(json.dumps({"empty_capture" if planned is None else "short_capture": phase,
                          "attempt": attempt + 1, "misses": miss}))
        time.sleep(CAPTURE_PAUSE_S)
    if planned is None:
        raise SystemExit(f"{phase}: the profiler recorded no device event in two captures")
    raise SystemExit(f"{phase}: {attempts} captures missed the launch plan: {miss}")


def device_us(fn, reps=20, phase="device_us"):
    """{kernel function: the profiler's device µs per launch} over `reps`
    calls of `fn`, after one call outside the profile (`device_capture`).
    A programmatic dependent launch counts from its blocks' start, so its
    wait for the kernel before it is included."""
    fn()
    by_name = device_capture(lambda: [fn() for _ in range(reps)], phase)[0]
    short = lambda name: name.removeprefix("void ").replace(
        "(anonymous namespace)::", "").split("(")[0]
    return {short(name): us / calls for name, (calls, us) in by_name.items()}


def hold_view_grad(run, d_corr, d_w, want_c, want_w):
    """K12's gates on one launcher `run` writing `d_corr` (and `d_w`, or
    None): launched twice, (every ∂c_v bit-equal to `want_c`, the two
    launches bit-equal, ∂w's max |err| and relative L2 against `want_w`)."""
    run()
    same = all(torch.equal(bits(d_corr[v]), bits(want_c[v])) for v in range(len(want_c)))
    first = [d_corr.clone()] + ([] if d_w is None else [d_w.clone()])
    run()
    torch.cuda.synchronize()
    repeats = all(torch.equal(bits(a), bits(z)) for a, z in zip(first, (d_corr, d_w)))
    if d_w is None:
        return same, repeats, 0.0, 0.0
    return (same, repeats, (d_w - want_w).abs().max().item(),
            ((d_w - want_w).norm() / want_w.norm()).item())


def hold_view_aggregate(label, corrs, weights, grad, weight_grad, launches, per):
    """K11 and K12 (with ∂w where `weight_grad`) against their plain
    versions at one shape: K11's output and every ∂c_v bit for bit, the
    wrappers' outputs equal to the bare launches', ∂w within
    VIEW_GRAD_REL (relative L2), two K12 launches bit-equal. Times the
    bare launches (`ms`: the C launcher called with its arguments built
    once, outputs allocated beforehand, so that the host's Python does not
    pace the ~25 µs calls; `device_ms`: the profiler's kernel time per
    launch, for K12 also `device_us` per kernel function), the wrappers
    (`call_ms`) and the plain versions (`plain_ms`, and `plain_device_ms`
    from the profiler). One JSON line per kernel; returns both records."""
    b, n, g, p = corrs[0].shape
    nv = len(corrs)
    out = torch.empty(b, n, g, p, device="cuda")
    bare = bare_launch("view_aggregate", view_aggregate_args(corrs, weights, out))
    bare()
    want = view_aggregate_plain(corrs, weights)
    same = torch.equal(bits(out), bits(want))
    wrapper = torch.equal(bits(view_aggregate(corrs, weights)), bits(out))
    nbytes, ops = view_aggregate_work(b, nv, n * g, p, grad=False)
    k11 = {"ms": time_ms(bare),
           "device_ms": sum(device_us(bare, phase=f"view_aggregate at {label}").values()) / 1e3,
           "call_ms": time_ms(lambda: view_aggregate(corrs, weights)),
           "plain_ms": time_ms(lambda: view_aggregate_plain(corrs, weights)),
           "plain_device_ms": device_capture(lambda: view_aggregate_plain(corrs, weights),
                                             f"view_aggregate_plain at {label}")[2],
           "library_ms": None, "bytes": nbytes, "ops": ops}
    k11["bound_ms"], k11["bound_by"] = bound_ms(nbytes, ops)
    print(json.dumps({"kernel": "view_aggregate", "shape": label, "batch": b, "views": nv,
                      "n": n, "p": p, "batch_stride": corrs[0].stride(0),
                      f"launches_per_{per}": launches, "bit_equal": same,
                      "wrapper_equal": wrapper, "max_abs_err": (out - want).abs().max().item(),
                      **k11, "share": k11["bound_ms"] / k11["ms"]}))
    if not (same and wrapper):
        raise SystemExit(f"view_aggregate at {label}: differs from its plain version "
                         f"({same}) or the wrapper from the bare launch ({wrapper})")

    d_corr = torch.empty(nv, b, n, g, p, device="cuda")
    d_w = torch.empty_like(weights) if weight_grad else None
    more = dict(corrs=corrs, out=out, d_weights=d_w) if weight_grad else {}
    bare = bare_launch("view_aggregate_grad",
                       view_aggregate_grad_args(weights, grad, d_corr, **more))
    want_c, want_w = view_aggregate_grad_plain(corrs, weights, grad, weight_grad)
    same, repeats, err, rel = hold_view_grad(bare, d_corr, d_w, want_c, want_w)
    call = lambda: view_aggregate_grad(weights, grad, *((corrs, out) if weight_grad else ()))
    got_c, got_w = call()
    wrapper = all(torch.equal(bits(a), bits(z)) for a, z in zip(got_c, d_corr)) and (
        not weight_grad or torch.equal(bits(got_w), bits(d_w)))
    nbytes, ops = view_aggregate_work(b, nv, n * g, p, grad=True, weight_grad=weight_grad)
    plain = lambda: view_aggregate_grad_plain(corrs, weights, grad, weight_grad)
    us = device_us(bare, phase=f"view_aggregate_grad at {label}")
    k12 = {"ms": time_ms(bare), "device_ms": sum(us.values()) / 1e3, "device_us": us,
           "call_ms": time_ms(call), "plain_ms": time_ms(plain),
           "plain_device_ms": device_capture(plain, f"view_aggregate_grad_plain at {label}")[2],
           "library_ms": None,
           "bytes": nbytes, "ops": ops, "max_abs_err": err, "max_rel_err": rel}
    k12["bound_ms"], k12["bound_by"] = bound_ms(nbytes, ops)
    print(json.dumps({"kernel": "view_aggregate_grad", "shape": label, "batch": b,
                      "views": nv, "n": n, "p": p, "weight_grad": weight_grad,
                      f"launches_per_{per}": launches if per != "map" else 0,
                      "d_corr_bit_equal": same, "two_launches_bit_equal": repeats,
                      "wrapper_equal": wrapper, "tol_rel_l2": VIEW_GRAD_REL,
                      **k12, "share": k12["bound_ms"] / k12["ms"]}))
    if not (same and repeats and wrapper and rel <= VIEW_GRAD_REL):
        raise SystemExit(f"view_aggregate_grad at {label}: ∂c bit-equal {same}, launches "
                         f"bit-equal {repeats}, wrapper equal {wrapper}, ∂w rel L2 {rel} "
                         f"(tolerance {VIEW_GRAD_REL})")
    return k11, k12


def check_view_aggregate():
    """K11 and K12 against their plain versions on the card
    (`hold_view_aggregate`) at each aggregation of a 1600x1152 map (the
    init sweep's 4 views of [1, 32, 8, 144·200], slices of one stacked
    tensor as the init branch passes them; each iteration level's n = 4,
    4, 2 at 288·400, views of their own) and of a 640x512 batch-4 training
    step (the init sweep's slices strided by the batch), K12 with ∂w at
    the init sweeps (where the weights take a gradient), then at
    VIEW_EDGE_CASES with and without ∂w. Returns the per-map totals of
    K11 and the per-step totals of K11 and K12 (each shape times its
    launches; K12's `device_us` per kernel function)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 6)
    per_map, per_step = {}, {}
    plans = (("map", sweep_shapes(WIDTH, HEIGHT, VIEWS, ITERATION), VIEWS, ITERATION, per_map),
             ("step", sweep_shapes(TRAIN_WIDTH, TRAIN_HEIGHT, TRAIN_VIEWS, TRAIN_ITERATION,
                                   TRAIN_BATCH), TRAIN_VIEWS, TRAIN_ITERATION, per_step))
    for per, shapes, views, iteration, totals in plans:
        for name, b, n, h, w, *_ in shapes:
            init = name == "init"
            launches = 1 if init else iteration
            corrs, weights, grad = view_aggregate_inputs(b, views - 1, n, h * w, init, gen)
            recs = hold_view_aggregate(f"{per}_{name}", corrs, weights, grad, init,
                                       launches, per)
            for kname, rec in zip(("view_aggregate", "view_aggregate_grad"), recs):
                if per == "map" and kname == "view_aggregate_grad":
                    continue
                tot = totals.setdefault(kname, {"max_abs_err": 0.0, "max_rel_err": 0.0,
                                                "library_ms": None, "launches": 0})
                for key in ("ms", "device_ms", "call_ms", "plain_ms", "plain_device_ms",
                            "bound_ms", "bytes", "ops"):
                    tot[key] = tot.get(key, 0.0) + launches * rec[key]
                for key in ("max_abs_err", "max_rel_err"):
                    tot[key] = max(tot[key], rec.get(key, 0.0))
                for fn, us in rec.get("device_us", {}).items():
                    fns = tot.setdefault("device_us", {})
                    fns[fn] = fns.get(fn, 0.0) + launches * us
                tot["launches"] += launches
            del corrs, weights, grad
            torch.cuda.empty_cache()
    print(json.dumps({"view_aggregate_totals": {"per_map": per_map, "per_step": per_step}}))
    for label, b, nv, n, p, stacked in VIEW_EDGE_CASES:
        corrs, weights, grad = view_aggregate_inputs(b, nv, n, p, stacked, gen)
        for weight_grad in (True, False):
            hold_view_aggregate(label, corrs, weights, grad, weight_grad, 0, "edge_case")
    return per_map, per_step


# The ConvGRU's input channels: the normalized depth and the correlation
# of every level's intervals (models/itermvs.py `Update.forward`).
GRU_INPUT = 1 + sum(len(v) for v in CORR_INTERVALS.values())
GRU_CHANNELS = HIDDEN_DIM + GRU_INPUT
# K13-K16 beside the main path's shapes (batch, H, W): H·W = 1961, not a
# multiple of either dtype's word (the one-element path), at B = 3 and
# B = 1, and a small map whose H·W = 96 takes the word path at B = 2.
GRU_EDGE_SHAPES = ((3, 37, 53), (1, 37, 53), (2, 8, 12))
# Logits planted at every 97th element of z_l, r_l and q_l: σ and tanh
# saturated both ways, zero and tiny magnitudes.
GRU_PLANTED = (-100.0, -30.0, -1e-8, 0.0, 1e-8, 30.0, 100.0)
# Operations per hidden element (σ counts 4: a negation, expf, an add
# and a divide; tanhf 1): K13 σ and a product; K14 σ, tanh, 1 − z, two
# products and the sum; K15 σ, tanh, the 3 of ∂z's two terms, 3 of
# sigmoid_backward, g·z, 3 of tanh_backward, 1 − z and g·(1 − z); K16 σ,
# G·h, 3 of sigmoid_backward and G·r.
GRU_OPS = {"gru_reset": 5, "gru_update": 9, "gru_update_grad": 17, "gru_reset_grad": 9}


def gru_work(name, b, p, itemsize):
    """(bytes, operations) of K13-K16 on [b, ·, p]: each input read once,
    each output written once (elements of hidden and of hidden + input
    channels: K13 reads r_l and hx and writes rh_x, K14 reads z_l, q_l, h
    and writes h', K15 reads g, z_l, q_l, h and writes 3 gradients, K16
    reads G, r_l, h and writes ∂r_l, ∂hx)."""
    hid, ch = HIDDEN_DIM, GRU_CHANNELS
    elements = {"gru_reset": hid + 2 * ch, "gru_update": 4 * hid, "gru_update_grad": 7 * hid,
                "gru_reset_grad": 3 * hid + 2 * ch}[name]
    return itemsize * b * p * elements, GRU_OPS[name] * b * p * hid


def gru_inputs(b, h, w, dtype, gen, dev="cuda"):
    """Seeded K13-K16 inputs in `dtype` (drawn in float32, then rounded):
    logits z_l, r_l, q_l [b, hidden, h, w] N(0, 4) with GRU_PLANTED, the
    hidden state tanh(N(0, 1)), hx = [h, x] with x N(0, 1), and the
    gradients g [b, hidden, h, w] and G [b, hidden + input, h, w] N(0,
    1)."""
    draw = lambda c, scale=1.0: scale * torch.randn(b, c, h, w, device=dev, generator=gen)
    logits = []
    for _ in range(3):
        t = draw(HIDDEN_DIM, 2.0).flatten()
        plant = torch.tensor(GRU_PLANTED, device=dev).repeat(t.numel() // 97 // 7 + 1)
        t[::97] = plant[:t[::97].numel()]
        logits.append(t.view(b, HIDDEN_DIM, h, w).to(dtype))
    z_l, r_l, q_l = logits
    hidden = torch.tanh(draw(HIDDEN_DIM)).to(dtype)
    hx = torch.cat([hidden, draw(GRU_INPUT).to(dtype)], dim=1)
    return dict(z_l=z_l, r_l=r_l, q_l=q_l, h=hidden, hx=hx, g=draw(HIDDEN_DIM).to(dtype),
                big_g=draw(GRU_CHANNELS).to(dtype))


def gru_cases(t):
    """{kernel: (its inputs, its outputs allocated, the function of its C
    arguments, its plain version, its wrapper)} of K13-K16 on the inputs
    `t` (`gru_inputs`)."""
    return {
        "gru_reset": ((t["r_l"], t["hx"]), [torch.empty_like(t["hx"])],
                      conv_gru.gru_reset_args, conv_gru.gru_reset_plain, conv_gru.gru_reset),
        "gru_update": ((t["z_l"], t["q_l"], t["h"]), [torch.empty_like(t["h"])],
                       conv_gru.gru_update_args, conv_gru.gru_update_plain,
                       conv_gru.gru_update),
        "gru_update_grad": ((t["g"], t["z_l"], t["q_l"], t["h"]),
                            [torch.empty_like(t["h"]) for _ in range(3)],
                            conv_gru.gru_update_grad_args, conv_gru.gru_update_grad_plain,
                            conv_gru.gru_update_grad),
        "gru_reset_grad": ((t["big_g"], t["r_l"], t["hx"]),
                           [torch.empty_like(t["r_l"]), torch.empty_like(t["hx"])],
                           conv_gru.gru_reset_grad_args, conv_gru.gru_reset_grad_plain,
                           conv_gru.gru_reset_grad)}


def hold_gru(label, b, h, w, dtype, launches, gen):
    """K13-K16 in `dtype` against their plain versions at [b, ·, h, w]:
    every output bit for bit (the kernels round each operation to the
    compute dtype in the plain version's order), the wrapper's equal to
    the bare launch's, two launches bit-equal. Times the bare launch
    (`ms`: the C launcher on arguments built once, outputs allocated
    beforehand; `device_ms` the profiler's), the wrapper (`call_ms`) and
    the plain version (`plain_ms`, `plain_device_ms`). One JSON line per
    kernel; returns {report name: record}."""
    inp = gru_inputs(b, h, w, dtype, gen)
    itemsize = torch.finfo(dtype).bits // 8
    recs = {}
    for name, (ins, outs, args, plain, wrapper) in gru_cases(inp).items():
        kname = kernel_name(name, dtype)
        bare = bare_launch(kname, args(*ins, *outs))
        bare()
        want = plain(*ins)
        want = want if isinstance(want, tuple) else (want,)
        same = all(torch.equal(bits(o), bits(v)) for o, v in zip(outs, want))
        err = max((o.float() - v.float()).abs().max().item() for o, v in zip(outs, want))
        first = [o.clone() for o in outs]
        bare()
        torch.cuda.synchronize()
        repeats = all(torch.equal(bits(a), bits(z)) for a, z in zip(first, outs))
        got = wrapper(*ins)
        got = got if isinstance(got, tuple) else (got,)
        wrapper_equal = all(torch.equal(bits(a), bits(z)) for a, z in zip(got, outs))
        nbytes, ops = gru_work(name, b, h * w, itemsize)
        rec = {"ms": time_ms(bare),
               "device_ms": sum(device_us(bare, phase=f"{kname} at {label}").values()) / 1e3,
               "call_ms": time_ms(lambda: wrapper(*ins)),
               "plain_ms": time_ms(lambda: plain(*ins)),
               "plain_device_ms": device_capture(lambda: plain(*ins),
                                                 f"{kname} plain at {label}")[2],
               "library_ms": None, "bytes": nbytes, "ops": ops, "max_abs_err": err,
               "max_rel_err": 0.0}
        rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes, ops)
        print(json.dumps({"kernel": kname, "shape": label, "batch": b, "h": h, "w": w,
                          "launches": launches, "bit_equal": same,
                          "two_launches_bit_equal": repeats, "wrapper_equal": wrapper_equal,
                          "tolerance": "bit-equal", **rec,
                          "share": rec["bound_ms"] / rec["ms"]}))
        if not (same and repeats and wrapper_equal):
            raise SystemExit(f"{kname} at {label}: bit-equal to its plain version {same} "
                             f"(max |err| {err}), launches bit-equal {repeats}, wrapper "
                             f"equal {wrapper_equal}")
        recs[kname] = rec
    return recs


def check_conv_gru():
    """K13-K16 against their plain versions on the card (`hold_gru`), in
    float32 and bfloat16, at a 1600x1152 map's GRU call ([1, ·, 288,
    400], 4 calls per map), at a 640x512 batch-4 training step's ([4, ·,
    128, 160], 4 calls per step), then at GRU_EDGE_SHAPES. Returns the
    per-map totals of K13 and K14 and the per-step totals of K15 and K16
    in both dtypes (each call times its launches)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 7)
    per_map, per_step = {}, {}
    plans = (("map", 1, HEIGHT // 4, WIDTH // 4, ITERATION, per_map,
              ("gru_reset", "gru_update")),
             ("step", TRAIN_BATCH, TRAIN_HEIGHT // 4, TRAIN_WIDTH // 4, TRAIN_ITERATION,
              per_step, ("gru_update_grad", "gru_reset_grad")))
    for dtype in (torch.float32, BF16):
        for per, b, h, w, calls, totals, names in plans:
            recs = hold_gru(f"{per}_call", b, h, w, dtype, calls, gen)
            for name in names:
                rec = recs[kernel_name(name, dtype)]
                tot = {k: calls * rec[k] for k in ("ms", "device_ms", "call_ms", "plain_ms",
                                                   "plain_device_ms", "bound_ms", "bytes",
                                                   "ops")}
                tot.update(max_abs_err=rec["max_abs_err"], max_rel_err=rec["max_rel_err"],
                           library_ms=None, launches=calls)
                totals[kernel_name(name, dtype)] = tot
            torch.cuda.empty_cache()
        for b, h, w in GRU_EDGE_SHAPES:
            hold_gru(f"edge_{b}x{h}x{w}", b, h, w, dtype, 0, gen)
    print(json.dumps({"conv_gru_totals": {"per_map": per_map, "per_step": per_step}}))
    return per_map, per_step


# FeatureNet's BN epilogues per image, in the order it runs them (K17
# launches; models/feature_net.py, models/blocks.py): (form, channels,
# the scale s of its H/s x W/s plane), all with the ReLU. The stem's
# ConvBnReLU, then per stage a stride-2 ResidualBlock (conv1's ReLU form;
# conv2's BN + the downsample's BN) and a stride-1 one (conv1's; conv2's
# BN + the identity skip).
BN_CALLS = (("plain", 8, 1),
            *((form, c, s) for c, s in ((16, 2), (32, 4), (48, 8))
              for form in ("plain", "downsample", "plain", "residual")))
BN_FORMS = {"plain": bn_ops.PLAIN, "residual": bn_ops.RESIDUAL,
            "downsample": bn_ops.DOWNSAMPLE}
# K17/K18 beside the main path's shapes, (label, form, relu, n, c, h, w):
# H·W not a multiple of either dtype's word (the one-element path), N·C
# odd, a 1x1 plane, planes of 2 spans (ragged on the word path too), and a
# lone BN (no ReLU).
BN_EDGE_CASES = (("odd_hw", "downsample", True, 3, 5, 7, 9),
                 ("one_pixel", "residual", True, 1, 3, 1, 1),
                 ("two_spans_scalar", "residual", True, 1, 3, 67, 71),
                 ("two_spans_words", "plain", True, 3, 3, 40, 123),
                 ("lone_bn", "plain", False, 2, 7, 5, 13),
                 ("lone_bn_words", "downsample", False, 2, 3, 16, 16))
# K18's per-channel rows (its sums and the vectors' gradients) against
# float64: |err| <= BN_ROWS_REL times the row's formula on |terms|.
BN_ROWS_REL = 1e-5
# Operations per element: K17 the normalise (3), the ReLU, the add, a
# second normalise; K18 the mask, ∂y, Σg', Σg'·(y − mean) (3), and in
# form c ∂xd and the third sum (3).
BN_OPS = {"plain": (4, 6), "residual": (5, 6), "downsample": (8, 10)}


def bn_work(form, n, c, p, itemsize, grad=False, relu=True):
    """(bytes, operations) of K17 (or K18, `grad`) on [n, c, p] in `form`:
    each input read once, each output written once. K17 reads y (and the
    skip) and writes the output; K18 reads g, the output (for the ReLU's
    mask), y (and xd) and writes ∂y (and ∂skip); plus the float32
    per-channel vectors (K17 reads 4 per BN; K18 reads 3 and writes 5 rows
    per BN)."""
    bns = 2 if form == "downsample" else 1
    if grad:
        tensors = 3 + relu + (form == "downsample") + (form != "plain")
        vectors = 8 * bns
    else:
        tensors = 2 + (form != "plain")
        vectors = 4 * bns
    return (itemsize * n * c * p * tensors + 4 * c * vectors,
            BN_OPS[form][grad] * n * c * p)


def bn_image_bytes(width, height, itemsize):
    """K17's bytes over one image's 13 launches (`BN_CALLS`)."""
    return sum(bn_work(form, 1, c, (height // s) * (width // s), itemsize)[0]
               for form, c, s in BN_CALLS)


def bn_inputs(form, n, c, h, w, dtype, gen, dev="cuda"):
    """Seeded K17/K18 inputs: y and the skip N(0.3, 1.5) in `dtype`
    (drawn in float32, rounded); per BN float32 w in ±[0.5, 1.5] (odd
    channels negative), b N(0, 0.5) with channel 0's 0, mean N(0, 1), var
    in [0.1, 2.1]; every 37th element of channel 0 of y set to its mean
    (so bn(y) there is exactly 0 in form a: the ReLU's edge); the
    gradient g N(0, 1)."""
    draw = lambda: (0.3 + 1.5 * torch.randn(n, c, h, w, device=dev, generator=gen)).to(dtype)

    def vectors():
        sign = torch.tensor([1.0, -1.0], device=dev).repeat(c)[:c]
        wv = sign * (0.5 + torch.rand(c, device=dev, generator=gen))
        b = 0.5 * torch.randn(c, device=dev, generator=gen)
        b[0] = 0.0
        mean = torch.randn(c, device=dev, generator=gen).to(dtype).float()
        var = 0.1 + 2.0 * torch.rand(c, device=dev, generator=gen)
        return wv, b, mean, var

    y = draw()
    first = vectors()
    y[:, 0].view(n, -1)[:, ::37] = first[2][0].to(dtype)
    skip = None if form == "plain" else draw()
    skip_bn = vectors() if form == "downsample" else None
    return dict(y=y, bn=first, skip=skip, skip_bn=skip_bn,
                g=torch.randn(n, c, h, w, device=dev, generator=gen).to(dtype))


def hold_bn_rows(got, t, out, form, relu):
    """K18's rows [5·B, C] (per BN: Σg', Σg'·(x − mean), ∂w, ∂mean, ∂var)
    against the float64 plain version's: the largest |err| / scale, each
    row's scale its formula on absolute terms (Σ|g'|, Σ|g'·(x − mean)|,
    |w|); and the same of the float32 plain version, as a control."""
    f64 = {k: (v.double() if isinstance(v, torch.Tensor) else
               tuple(x.double() for x in v) if v is not None else None) for k, v in t.items()}
    code = BN_FORMS[form]
    xd = f64["skip"] if code == bn_ops.DOWNSAMPLE else None
    want = bn_ops.bn_act_grad_plain(f64["g"], f64["y"], out.double(), f64["bn"][0],
                                    f64["bn"][2], f64["bn"][3], code, xd, f64["skip_bn"],
                                    relu)[2]
    masked = torch.ops.aten.threshold_backward(f64["g"], out.double(), 0) if relu else f64["g"]
    scales = []
    for x, (w, _, mean, var) in [(f64["y"], f64["bn"])] + (
            [(xd, f64["skip_bn"])] if xd is not None else []):
        centred = masked * (x - mean.view(1, -1, 1, 1))
        scales += bn_ops.bn_vector_rows(masked.abs().sum((0, 2, 3)),
                                        centred.abs().sum((0, 2, 3)), w.abs(), var)
    scale = torch.stack(scales).abs() + 1e-30
    plain = bn_ops.bn_act_grad_plain(t["g"], t["y"], out, t["bn"][0], t["bn"][2], t["bn"][3],
                                     code, t["skip"] if xd is not None else None,
                                     t["skip_bn"], relu)[2]
    return (((got.double() - want).abs() / scale).max().item(),
            ((plain.double() - want).abs() / scale).max().item())


def hold_bn_act(label, form, relu, n, c, h, w, dtype, gen, timed=True):
    """K17 and K18 in `dtype` and `form` against their plain versions at
    [n, c, h, w]: K17's output, K18's ∂y and ∂skip bit for bit, K18's
    rows within BN_ROWS_REL of float64 (`hold_bn_rows`), two launches
    bit-equal, the wrappers' outputs equal to the bare launches'. Where
    `timed`: the bare launch (`ms`: the C launcher on arguments built
    once, outputs allocated beforehand; `device_ms` the profiler's), the
    wrapper (`call_ms`), the plain version (`plain_ms`) and cuDNN's batch
    norm on the float32 tensor, as the port ran it before K17
    (`library_ms`; it computes the normalise only: eval mode for K17, the
    training backward for K18). One JSON line per kernel; returns {report
    name: record}."""
    import torch.nn.functional as F

    t = bn_inputs(form, n, c, h, w, dtype, gen)
    y, (wv, b, mean, var), skip, skip_bn = t["y"], t["bn"], t["skip"], t["skip_bn"]
    code = BN_FORMS[form]
    xd = skip if code == bn_ops.DOWNSAMPLE else None
    itemsize = torch.finfo(dtype).bits // 8
    out = torch.empty_like(y)
    k17 = kernel_name("bn_act", dtype)
    fwd = bare_launch(k17, bn_ops.bn_act_args(y, wv, b, mean, var, skip, skip_bn, relu, out))
    fwd()
    want = bn_ops.bn_act_plain(y, wv, b, mean, var, skip, skip_bn, relu)
    same = torch.equal(bits(out), bits(want))
    err = (out.float() - want.float()).abs().max().item()
    first = out.clone()
    fwd()
    torch.cuda.synchronize()
    repeats = torch.equal(bits(first), bits(out))
    wrapper_equal = torch.equal(bits(bn_ops.bn_act(y, wv, b, mean, var, skip, skip_bn, relu)),
                                bits(out))
    recs, lines = {}, []
    nbytes, ops = bn_work(form, n, c, h * w, itemsize, relu=relu)
    rec = {"max_abs_err": err, "max_rel_err": 0.0, "bytes": nbytes, "ops": ops,
           "library_ms": None}
    if timed:
        yf = y.float()
        rec.update(ms=time_ms(fwd),
                   device_ms=sum(device_us(fwd, phase=f"{k17} at {label}").values()) / 1e3,
                   call_ms=time_ms(lambda: bn_ops.bn_act(y, wv, b, mean, var, skip, skip_bn,
                                                         relu)),
                   plain_ms=time_ms(lambda: bn_ops.bn_act_plain(y, wv, b, mean, var, skip,
                                                                skip_bn, relu)),
                   library_ms=time_ms(lambda: F.batch_norm(yf, mean, var, wv, b, False, 0.0,
                                                           bn_ops.EPS)))
    rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes, ops)
    lines.append((k17, rec, {"bit_equal": same, "two_launches_bit_equal": repeats,
                             "wrapper_equal": wrapper_equal, "tolerance": "bit-equal"}))
    ok = same and repeats and wrapper_equal

    k18 = kernel_name("bn_act_grad", dtype)
    g = t["g"]
    d_y, d_skip, rows, partials = bn_ops.grad_buffers(y, code)
    bwd = bare_launch(k18, bn_ops.bn_act_grad_args(g, y, out, wv, mean, var, code, xd, skip_bn,
                                                   relu, d_y, d_skip, rows, partials))
    bwd()
    want_y, want_skip, _ = bn_ops.bn_act_grad_plain(g, y, out, wv, mean, var, code, xd, skip_bn,
                                                    relu)
    grads, wants = [d_y] + ([d_skip] if d_skip is not None else []), [want_y, want_skip]
    same = all(torch.equal(bits(a), bits(z)) for a, z in zip(grads, wants))
    err = max((a.float() - z.float()).abs().max().item() for a, z in zip(grads, wants))
    rows_rel, plain_rel = hold_bn_rows(rows, t, out, form, relu)
    first = [x.clone() for x in (*grads, rows)]
    bwd()
    torch.cuda.synchronize()
    repeats = all(torch.equal(bits(a), bits(z)) for a, z in zip(first, (*grads, rows)))
    got = bn_ops.bn_act_grad(g, y, out, wv, mean, var, code, xd, skip_bn, relu)
    wrapper_equal = all(torch.equal(bits(a), bits(z)) for a, z in
                        zip([x for x in got if x is not None], (*grads, rows)))
    nbytes, ops = bn_work(form, n, c, h * w, itemsize, grad=True, relu=relu)
    rec = {"max_abs_err": err, "max_rel_err": rows_rel, "bytes": nbytes, "ops": ops,
           "library_ms": None}
    if timed:
        yf = y.float().requires_grad_()
        wl, bl = wv.clone().requires_grad_(), b.clone().requires_grad_()
        lib_out = F.batch_norm(yf, None, None, wl, bl, True, 0.0, bn_ops.EPS)
        gf = g.float()
        rec.update(ms=time_ms(bwd),
                   device_ms=sum(device_us(bwd, phase=f"{k18} at {label}").values()) / 1e3,
                   call_ms=time_ms(lambda: bn_ops.bn_act_grad(g, y, out, wv, mean, var, code,
                                                              xd, skip_bn, relu)),
                   plain_ms=time_ms(lambda: bn_ops.bn_act_grad_plain(
                       g, y, out, wv, mean, var, code, xd, skip_bn, relu)),
                   library_ms=time_ms(lambda: torch.autograd.grad(
                       lib_out, (yf, wl, bl), gf, retain_graph=True)))
    rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes, ops)
    lines.append((k18, rec, {"bit_equal": same, "two_launches_bit_equal": repeats,
                             "wrapper_equal": wrapper_equal, "rows_rel_err": rows_rel,
                             "plain_rows_rel_err": plain_rel,
                             "tolerance": f"bit-equal; rows {BN_ROWS_REL} of |terms|"}))
    for kname, rec, gates in lines:
        extra = {"share": rec["bound_ms"] / rec["ms"]} if timed else {}
        print(json.dumps({"kernel": kname, "shape": label, "form": form, "relu": relu,
                          "n": n, "c": c, "h": h, "w": w, **gates, **rec, **extra}))
        recs[kname] = rec
    if not (ok and same and repeats and wrapper_equal and rows_rel <= BN_ROWS_REL):
        raise SystemExit(f"bn_act/bn_act_grad {dtype} at {label}: {lines}")
    return recs


def check_bn_act():
    """K17 and K18 against their plain versions on the card
    (`hold_bn_act`), in float32 and bfloat16, at every BN call of
    FeatureNet (`BN_CALLS`) on a 1600x1152 image (K17: one image per map,
    the feature cache on) and on a 640x512 training step's batch-4 x
    5-view fold (K17 and K18), then at BN_EDGE_CASES. Returns the per-map
    totals of K17 and the per-step totals of K18 in both dtypes (each
    shape times its calls)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 8)
    calls = {}
    for call in BN_CALLS:
        calls[call] = calls.get(call, 0) + 1
    per_map, per_step = {}, {}
    plans = (("map", 1, HEIGHT, WIDTH, per_map, "bn_act"),
             ("step", TRAIN_BATCH * TRAIN_VIEWS, TRAIN_HEIGHT, TRAIN_WIDTH, per_step,
              "bn_act_grad"))
    keys = ("ms", "device_ms", "call_ms", "plain_ms", "library_ms", "bound_ms", "bytes", "ops")
    for dtype in (torch.float32, BF16):
        for per, n, height, width, totals, name in plans:
            kname = kernel_name(name, dtype)
            tot = dict.fromkeys(keys, 0.0)
            tot.update(max_abs_err=0.0, max_rel_err=0.0, launches=0)
            for (form, c, s), k in calls.items():
                rec = hold_bn_act(f"{per}_{form}_{c}", form, True, n, c, height // s,
                                  width // s, dtype, gen)[kname]
                for key in keys:
                    tot[key] += k * rec[key]
                tot["max_abs_err"] = max(tot["max_abs_err"], rec["max_abs_err"])
                tot["max_rel_err"] = max(tot["max_rel_err"], rec["max_rel_err"])
                tot["launches"] += k
                torch.cuda.empty_cache()
            totals[kname] = tot
        for label, form, relu, n, c, h, w in BN_EDGE_CASES:
            hold_bn_act(f"edge_{label}", form, relu, n, c, h, w, dtype, gen, timed=False)
    print(json.dumps({"bn_act_totals": {"per_map": per_map, "per_step": per_step}}))
    return per_map, per_step


# FeatureNet's BN inputs per image (K21 reads each once), in
# the order its epilogues (`BN_CALLS`) take them: (channels, the scale s
# of the H/s x W/s plane); form c's epilogue has two, y and the
# downsample's xd.
BN_INPUTS = tuple((c, s) for form, c, s in BN_CALLS
                  for _ in range(2 if form == "downsample" else 1))
# K21's mean and variance against float64: |err| / |exact| (bounded by a
# few float32 roundings: float32 sums of at most 16 terms per thread,
# float64 after); its group sums likewise, Σy relative to Σ|y|.
BN_STATS_REL = 1e-6
# Operations per element: K21 the sum (1), then the deviation and its
# square's fused add (3); K22 the deviation, the product, two adds (4).
BN_STATS_OPS, BN_STATS_GRAD_OPS = 4, 4


def bn_stats_work(n, c, p, itemsize, grad=False, bns=1):
    """(bytes, operations) of K21 on y [n, c, p] (or of K22 for `bns`
    BNs, `grad`): K21 reads y once and writes the mean and the variance;
    K22 reads ∂y and y and writes ∂y, and reads the mean, ∂mean and ∂var,
    per BN."""
    e = n * c * p
    if grad:
        return bns * (3 * itemsize * e + 12 * c), bns * BN_STATS_GRAD_OPS * e
    return itemsize * e + 8 * c, BN_STATS_OPS * e


def bn_stats_image_bytes(width, height, itemsize):
    """K21's bytes over one image's 16 BN inputs (`BN_INPUTS`)."""
    return sum(bn_stats_work(1, c, (height // s) * (width // s), itemsize)[0]
               for c, s in BN_INPUTS)


def hold_bn_stats(label, n, c, h, w, dtype, gen, timed=True):
    """K21 on y [n, c, h, w] N(0.3, 1.5) in `dtype`, one read of y: the
    mean and the biased variance within BN_STATS_REL of float64, and with
    a divisor of 1 the process group's float64 sums (Σy relative to Σ|y|,
    the squares about y's own mean relative), two launches bit-equal, the
    wrappers (`bn_batch_stats`, `bn_sums`) equal to the bare launches; the
    plain version's (var_mean of the float32 y) error against float64
    printed as a control. Where `timed`: the bare launch (`ms`;
    `device_ms` the profiler's), the wrapper (`call_ms`), the plain
    version (`plain_ms`) and `torch.var_mean` on y in its own dtype
    (`library_ms`). One JSON line; returns the record."""
    y = (0.3 + 1.5 * torch.randn(n, c, h, w, device="cuda", generator=gen)).to(dtype)
    count = n * h * w
    kname = kernel_name("bn_stats", dtype)
    (out, part), (sums, part2) = stats_ops.stats_buffers(y), stats_ops.stats_buffers(y, True)
    run = bare_launch(kname, stats_ops.bn_stats_args(y, out, part, count))
    run_sums = bare_launch(kname, stats_ops.bn_stats_args(y, sums, part2, 1))
    run()
    run_sums()
    yd = y.double()
    m64 = yd.mean((0, 2, 3))
    q64 = (yd - m64.view(1, -1, 1, 1)).square().sum((0, 2, 3))
    s64, a64 = yd.sum((0, 2, 3)), yd.abs().sum((0, 2, 3))
    v64 = q64 / count
    del yd
    rel = lambda got, want, scale=None: ((got.double() - want).abs() / (
        want.abs() if scale is None else scale).clamp_min(1e-300)).max().item()
    plain = stats_ops.bn_batch_stats_plain(y)
    mean, var = out
    errs = {"mean_rel_err": rel(mean, m64), "var_rel_err": rel(var, v64),
            "sums_rel_err": max(rel(sums[0], s64, a64), rel(sums[1], q64)),
            "plain_mean_rel_err": rel(plain[0], m64), "plain_var_rel_err": rel(plain[1], v64)}
    first = (out.clone(), sums.clone())
    run()
    run_sums()
    torch.cuda.synchronize()
    repeats = torch.equal(bits(first[0]), bits(out)) and torch.equal(bits(first[1]), bits(sums))
    wrapper_equal = (all(torch.equal(bits(a), bits(b))
                         for a, b in zip(stats_ops.bn_batch_stats(y), out))
                     and torch.equal(bits(stats_ops.bn_sums(y)), bits(sums)))
    err = max((a - b).abs().max().item() for a, b in zip(out, plain))
    nbytes, ops = bn_stats_work(n, c, h * w, dtype.itemsize)
    rec = {"max_abs_err": err,
           "max_rel_err": max(errs["mean_rel_err"], errs["var_rel_err"], errs["sums_rel_err"]),
           "bytes": nbytes, "ops": ops, "library_ms": None}
    if timed:
        rec.update(ms=time_ms(run),
                   device_ms=sum(device_us(run, phase=f"{kname} at {label}").values()) / 1e3,
                   call_ms=time_ms(lambda: stats_ops.bn_batch_stats(y)),
                   plain_ms=time_ms(lambda: stats_ops.bn_batch_stats_plain(y)),
                   library_ms=time_ms(lambda: torch.var_mean(y, dim=(0, 2, 3), unbiased=False)))
    rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes, ops)
    extra = {"share": rec["bound_ms"] / rec["ms"]} if timed else {}
    line = {"kernel": kname, "shape": label, "y": [n, c, h, w], **errs,
            "two_launches_bit_equal": repeats, "wrapper_equal": wrapper_equal,
            "tolerance": f"{BN_STATS_REL} of float64, relative", **rec, **extra}
    print(json.dumps(line))
    if not (rec["max_rel_err"] <= BN_STATS_REL and repeats and wrapper_equal):
        raise SystemExit(f"bn_stats {dtype} at {label}: {line}")
    return rec


def bn_full_grad_exact(t, out, count, form, relu):
    """The float64 input gradient of a training epilogue on `bn_inputs`
    `t` whose statistics are its vectors (K18's plain version then K22's
    on float64): (∂y, ∂skip or None)."""
    f64 = lambda v: None if v is None else v.double()
    code = BN_FORMS[form]
    xd = f64(t["skip"]) if code == bn_ops.DOWNSAMPLE else None
    skip_bn = None if t["skip_bn"] is None else tuple(map(f64, t["skip_bn"]))
    w, _, mean, var = map(f64, t["bn"])
    y = f64(t["y"])
    d_y, d_skip, rows = bn_ops.bn_act_grad_plain(f64(t["g"]), y, f64(out), w, mean, var, code,
                                                 xd, skip_bn, relu)
    d_y = stats_ops.bn_stats_grad_plain(d_y, y, mean, rows[3], rows[4], count)
    if xd is not None:
        d_skip = stats_ops.bn_stats_grad_plain(d_skip, xd, skip_bn[2], rows[8], rows[9], count)
    return d_y, d_skip


def grad_errors(got, exact, scale):
    """(max |got − exact| / max |exact|, relative L2) over the tensors of
    `got`; where the exact gradient is 0 (a one-element batch, where the
    statistics' term cancels K18's) relative to the tensors `scale`
    (K18's outputs) instead."""
    refs = [b for _, b in zip(got, exact)]
    diffs = [a.double() - b for a, b in zip(got, refs)]
    if not any(b.any() for b in refs):
        refs = [t.double() for t in scale]
    top = max(b.abs().max().item() for b in refs)
    norm = sum(float(b.square().sum()) for b in refs)
    return (max(d.abs().max().item() for d in diffs) / top,
            (sum(float(d.square().sum()) for d in diffs) / norm) ** 0.5)


def hold_bn_stats_grad(label, form, relu, n, c, h, w, dtype, gen, timed=True):
    """K22 in `dtype` and `form` on K18's ∂y (and ∂skip) of a training
    epilogue on `bn_inputs` whose mean and variance are K21's (so y's
    own): bit for bit against its plain version, two launches (each on a
    fresh copy of K18's outputs) bit-equal, the wrapper (`bn_stats_grad_`)
    equal to the bare launch. The error of the whole input gradient
    against float64 (`bn_full_grad_exact`) is printed for K18 + K22 and
    for the composition the port ran before (autograd of var_mean on the
    float32 y with K18's ∂mean and ∂var, cast to `dtype`, added to K18's
    ∂y). Where `timed`: the bare launch in place (`ms`, `device_ms`), the
    wrapper (`call_ms`), the plain version (`plain_ms`) and that
    composition's var_mean backward and add (`library_ms`). One JSON
    line; returns the record."""
    t = bn_inputs(form, n, c, h, w, dtype, gen)
    code = BN_FORMS[form]
    count = n * h * w
    t["bn"] = (*t["bn"][:2], *stats_ops.bn_batch_stats(t["y"]))
    xd = t["skip"] if code == bn_ops.DOWNSAMPLE else None
    if xd is not None:
        t["skip_bn"] = (*t["skip_bn"][:2], *stats_ops.bn_batch_stats(xd))
    wv, b, mean, var = t["bn"]
    out = bn_ops.bn_act(t["y"], wv, b, mean, var, t["skip"], t["skip_bn"], relu)
    d_y0, d_skip0, rows = bn_ops.bn_act_grad(t["g"], t["y"], out, wv, mean, var, code, xd,
                                             t["skip_bn"], relu)
    second = None if xd is None else (t["skip_bn"][2], rows[8], rows[9])
    d_y, d_skip = d_y0.clone(), None if xd is None else d_skip0.clone()
    kname = kernel_name("bn_stats_grad", dtype)
    launch = bare_launch(kname, stats_ops.bn_stats_grad_args(
        d_y, t["y"], mean, rows[3], rows[4], count,
        None if xd is None else (d_skip, xd, *second)))
    outputs = [d_y] + ([] if xd is None else [d_skip])

    def fresh():
        d_y.copy_(d_y0)
        if d_skip is not None:
            d_skip.copy_(d_skip0)

    launch()
    want = [stats_ops.bn_stats_grad_plain(d_y0, t["y"], mean, rows[3], rows[4], count)]
    if xd is not None:
        want.append(stats_ops.bn_stats_grad_plain(d_skip0, xd, *second, count))
    same = all(torch.equal(bits(a), bits(z)) for a, z in zip(outputs, want))
    err = max((a.float() - z.float()).abs().max().item() for a, z in zip(outputs, want))
    first = [x.clone() for x in outputs]
    fresh()
    launch()
    torch.cuda.synchronize()
    repeats = all(torch.equal(bits(a), bits(z)) for a, z in zip(first, outputs))
    got = [d_y0.clone()] + ([] if xd is None else [d_skip0.clone()])
    stats_ops.bn_stats_grad_(got[0], t["y"], mean, rows[3], rows[4], count,
                             None if xd is None else (got[1], xd, *second))
    wrapper_equal = all(torch.equal(bits(a), bits(z)) for a, z in zip(got, first))
    exact = bn_full_grad_exact(t, out, count, form, relu)
    # The composition the port ran before: var_mean with grad on float32
    # copies, its backward cast to the compute dtype and added.
    ins = [t["y"]] + ([] if xd is None else [xd])
    vectors = [(rows[3], rows[4])] + ([] if xd is None else [(rows[8], rows[9])])
    leaves = [x.float().detach().requires_grad_() for x in ins]
    graphs = [torch.var_mean(x, dim=(0, 2, 3), unbiased=False) for x in leaves]

    def library():
        return [k + torch.autograd.grad(graph, leaf, (d_var, d_mean), retain_graph=True)[0]
                .to(dtype) for k, leaf, graph, (d_mean, d_var)
                in zip((d_y0, d_skip0), leaves, graphs, vectors)]

    k18 = [d_y0] + ([] if xd is None else [d_skip0])
    rel_max, rel_l2 = grad_errors(first, exact, k18)
    before_max, before_l2 = grad_errors(library(), exact, k18)
    nbytes, ops = bn_stats_work(n, c, h * w, dtype.itemsize, grad=True, bns=len(outputs))
    rec = {"max_abs_err": err, "max_rel_err": rel_max, "bytes": nbytes, "ops": ops,
           "library_ms": None}
    if timed:
        rec.update(ms=time_ms(launch),
                   device_ms=sum(device_us(launch, phase=f"{kname} at {label}").values()) / 1e3,
                   call_ms=time_ms(lambda: stats_ops.bn_stats_grad_(
                       d_y, t["y"], mean, rows[3], rows[4], count,
                       None if xd is None else (d_skip, xd, *second))),
                   plain_ms=time_ms(lambda: [stats_ops.bn_stats_grad_plain(
                       d_y0, t["y"], mean, rows[3], rows[4], count)] + (
                       [] if xd is None else [stats_ops.bn_stats_grad_plain(
                           d_skip0, xd, *second, count)])),
                   library_ms=time_ms(library))
    rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes, ops)
    extra = {"share": rec["bound_ms"] / rec["ms"]} if timed else {}
    line = {"kernel": kname, "shape": label, "form": form, "relu": relu, "n": n, "c": c,
            "h": h, "w": w, "bit_equal": same, "two_launches_bit_equal": repeats,
            "wrapper_equal": wrapper_equal, "tolerance": "bit-equal",
            "grad_vs_float64_max_rel": rel_max, "grad_vs_float64_rel_l2": rel_l2,
            "before_vs_float64_max_rel": before_max, "before_vs_float64_rel_l2": before_l2,
            **rec, **extra}
    print(json.dumps(line))
    if not (same and repeats and wrapper_equal):
        raise SystemExit(f"bn_stats_grad {dtype} at {label}: {line}")
    return rec


def check_bn_stats():
    """K21 (`hold_bn_stats`) at each of FeatureNet's 16 BN inputs
    (`BN_INPUTS`) and K22 (`hold_bn_stats_grad`) at each of its 13 BN
    epilogues (`BN_CALLS`) on a 640x512 training step's batch-4 x 5-view
    fold, in float32 and bfloat16, then both at BN_EDGE_CASES. Returns
    the per-step totals of both kernels in both dtypes (each shape times
    its calls)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 10)
    n, per_step = TRAIN_BATCH * TRAIN_VIEWS, {}
    keys = ("ms", "device_ms", "call_ms", "plain_ms", "library_ms", "bound_ms", "bytes", "ops")
    for dtype in (torch.float32, BF16):
        plans = (("bn_stats", BN_INPUTS, 1,
                  lambda c, s: hold_bn_stats(f"step_{c}x{s}", n, c, TRAIN_HEIGHT // s,
                                             TRAIN_WIDTH // s, dtype, gen)),
                 ("bn_stats_grad", BN_CALLS, 1,
                  lambda form, c, s: hold_bn_stats_grad(
                      f"step_{form}_{c}", form, True, n, c, TRAIN_HEIGHT // s,
                      TRAIN_WIDTH // s, dtype, gen)))
        for name, calls, launches, hold in plans:
            tot = dict.fromkeys(keys, 0.0)
            tot.update(max_abs_err=0.0, max_rel_err=0.0, launches=launches * len(calls))
            for call in dict.fromkeys(calls):
                k = calls.count(call)
                rec = hold(*call)
                for key in keys:
                    tot[key] += k * rec[key]
                for key in ("max_abs_err", "max_rel_err"):
                    tot[key] = max(tot[key], rec[key])
                torch.cuda.empty_cache()
            per_step[kernel_name(name, dtype)] = tot
        for label, form, relu, en, c, h, w in BN_EDGE_CASES:
            hold_bn_stats(f"edge_{label}", en, c, h, w, dtype, gen, timed=False)
            hold_bn_stats_grad(f"edge_{label}", form, relu, en, c, h, w, dtype, gen, timed=False)
    print(json.dumps({"bn_stats_totals": {"per_step": per_step}}))
    return per_step


# FeatureNet's FPN top-down adds per image, in the order it runs them
# (K19 launches; models/feature_net.py): (channels, the scale s of x's
# H/s x W/s plane). fea3 at 1/8 goes up to 1/4, that sum up to 1/2.
FPN_CALLS = ((48, 8), (48, 4))
# K19/K20 beside the main path's shapes, [n, c, h, w] of x: h or w of 1,
# 2 and odd, where they take their scalar path, and small maps on their
# run path (w a multiple of 4): one row, a 5x8 map and an odd row count
# at w = 4 · 5.
UP2_EDGE_SHAPES = ((2, 3, 1, 1), (1, 5, 1, 7), (3, 2, 5, 2), (2, 4, 7, 9), (1, 2, 2, 1),
                   (1, 3, 3, 66), (1, 2, 1, 4), (2, 3, 5, 8), (1, 2, 7, 20))
# Operations: K19 per output the resize's 6 products and 3 sums and the
# add; K20 per ∂x element 16 multiply-adds in float64, over the card's
# float64 rate outside the tensor cores (NVIDIA data sheet, H100 SXM).
K19_OPS, K20_OPS = 10, 32
PEAK_F64_PER_S = 34e12


def up2_work(n, c, h, w, itemsize, grad=False):
    """(bytes, operations, operations per second) of K19 (or K20, `grad`)
    for x [n, c, h, w]: K19 reads x and the lateral and writes the output
    (1 + 4 + 4 elements per element of x), K20 reads ∂out and writes ∂x
    (4 + 1), each once."""
    e = n * c * h * w
    if grad:
        return itemsize * 5 * e, K20_OPS * e, PEAK_F64_PER_S
    return itemsize * 9 * e, K19_OPS * 4 * e, PEAK_F32_PER_S


def up2_image_bytes(width, height, itemsize):
    """K19's bytes over one image's 2 launches (`FPN_CALLS`)."""
    return sum(up2_work(1, c, height // s, width // s, itemsize)[0] for c, s in FPN_CALLS)


def up2_inputs(n, c, h, w, dtype, gen, dev="cuda"):
    """Seeded K19/K20 inputs in `dtype` (drawn in float32, rounded): x and
    ∂out N(0, 1) scaled by 2^k, k uniform in [-8, 8) per element (so that
    neighbours differ in exponent and every rounding of the formula
    shows), the lateral N(0, 1)."""
    def spread(*shape):
        k = torch.randint(-8, 8, shape, device=dev, generator=gen).float()
        return (torch.randn(*shape, device=dev, generator=gen) * torch.exp2(k)).to(dtype)

    return dict(x=spread(n, c, h, w),
                lateral=torch.randn(n, c, 2 * h, 2 * w, device=dev, generator=gen).to(dtype),
                g=spread(n, c, 2 * h, 2 * w))


def ulps(got, exact, dtype):
    """|got − exact| in units in the last place of `dtype` at each exact
    (float64) value; subnormal spacing below the smallest normal."""
    info = torch.finfo(dtype)
    mant = {torch.float32: 23, BF16: 7}[dtype]
    mag = exact.abs().clamp_min(info.tiny)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - mant)
    return ((got.double() - exact).abs() / ulp)


def hold_upsample2x(label, n, c, h, w, dtype, gen, timed=True):
    """K19 and K20 in `dtype` for x [n, c, h, w] on `up2_inputs`: K19 bit
    for bit against its plain version (F.interpolate + add on the card),
    K20 within one unit in the last place of `dtype` of the float64 sum of
    the same terms (the plain version on float64 ∂out), each launched
    twice bit-equal, the wrappers' outputs equal to the bare launches'.
    Where `timed`: the bare launch (`ms`: the C launcher on arguments built
    once, outputs allocated beforehand; `device_ms` the profiler's), the
    wrapper (`call_ms`), the plain version (`plain_ms`) and the library
    (`library_ms`: F.interpolate + add, which is K19's plain version; for
    K20 F.interpolate's autograd backward, PyTorch's atomic
    upsample_bilinear2d_backward). One JSON line per kernel; returns
    {report name: record}."""
    import torch.nn.functional as F

    t = up2_inputs(n, c, h, w, dtype, gen)
    x, lat, g = t["x"], t["lateral"], t["g"]
    size = (2 * h, 2 * w)
    itemsize = torch.finfo(dtype).bits // 8
    recs, lines = {}, []

    k19 = kernel_name("upsample2x_add", dtype)
    out = torch.empty_like(lat)
    fwd = bare_launch(k19, resize_ops.upsample2x_add_args(x, lat, out))
    fwd()
    want = resize_ops.upsample2x_add_plain(x, lat)
    same = torch.equal(bits(out), bits(want))
    err = (out.float() - want.float()).abs().max().item()
    first = out.clone()
    fwd()
    torch.cuda.synchronize()
    repeats = torch.equal(bits(first), bits(out))
    wrapper_equal = torch.equal(bits(resize_ops.upsample2x_add(x, lat)), bits(out))
    nbytes, ops, rate = up2_work(n, c, h, w, itemsize)
    rec = {"max_abs_err": err, "max_rel_err": 0.0, "bytes": nbytes, "ops": ops,
           "library_ms": None}
    if timed:
        rec.update(ms=time_ms(fwd),
                   device_ms=sum(device_us(fwd, phase=f"{k19} at {label}").values()) / 1e3,
                   call_ms=time_ms(lambda: resize_ops.upsample2x_add(x, lat)),
                   plain_ms=time_ms(lambda: resize_ops.upsample2x_add_plain(x, lat)),
                   library_ms=time_ms(lambda: F.interpolate(
                       x, size=size, mode="bilinear", align_corners=False) + lat))
    rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes, ops, rate)
    lines.append((k19, rec, {"bit_equal": same, "two_launches_bit_equal": repeats,
                             "wrapper_equal": wrapper_equal, "tolerance": "bit-equal"}))
    ok = same and repeats and wrapper_equal

    k20 = kernel_name("upsample2x_grad", dtype)
    d_x = torch.empty_like(x)
    bwd = bare_launch(k20, resize_ops.upsample2x_grad_args(g, d_x))
    bwd()
    exact = resize_ops.upsample2x_grad_plain(g.double(), (h, w))
    err_ulps = ulps(d_x, exact, dtype).max().item()
    plain = resize_ops.upsample2x_grad_plain(g, (h, w))
    differ = (bits(d_x) != bits(plain)).sum().item()
    err = (d_x.double() - exact).abs().max().item()
    rel = err / max(exact.abs().max().item(), 1e-30)
    first = d_x.clone()
    bwd()
    torch.cuda.synchronize()
    repeats = torch.equal(bits(first), bits(d_x))
    wrapper_equal = torch.equal(bits(resize_ops.upsample2x_grad(g, (h, w))), bits(d_x))
    xr = x.detach().requires_grad_()
    up = F.interpolate(xr, size=size, mode="bilinear", align_corners=False)
    library_grad = lambda: torch.autograd.grad(up, xr, g, retain_graph=True)[0]
    library_ulps = ulps(library_grad(), exact, dtype).max().item()
    del exact
    nbytes, ops, rate = up2_work(n, c, h, w, itemsize, grad=True)
    rec = {"max_abs_err": err, "max_rel_err": rel, "bytes": nbytes, "ops": ops,
           "library_ms": None}
    if timed:
        rec.update(ms=time_ms(bwd),
                   device_ms=sum(device_us(bwd, phase=f"{k20} at {label}").values()) / 1e3,
                   call_ms=time_ms(lambda: resize_ops.upsample2x_grad(g, (h, w))),
                   plain_ms=time_ms(lambda: resize_ops.upsample2x_grad_plain(g, (h, w))),
                   library_ms=time_ms(library_grad))
    rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes, ops, rate)
    lines.append((k20, rec, {"max_ulps": err_ulps, "library_max_ulps": library_ulps,
                             "differ_from_plain": differ, "two_launches_bit_equal": repeats,
                             "wrapper_equal": wrapper_equal,
                             "tolerance": "1 ulp of the float64 sum"}))
    for kname, rec, gates in lines:
        extra = {"share": rec["bound_ms"] / rec["ms"]} if timed else {}
        print(json.dumps({"kernel": kname, "shape": label, "x": [n, c, h, w], **gates, **rec,
                          **extra}))
        recs[kname] = rec
    if not (ok and repeats and wrapper_equal and err_ulps <= 1.0):
        raise SystemExit(f"upsample2x_add/upsample2x_grad {dtype} at {label}: {lines}")
    return recs


def check_upsample2x():
    """K19 and K20 against their plain versions on the card
    (`hold_upsample2x`), in float32 and bfloat16, at FeatureNet's two FPN
    adds (`FPN_CALLS`) on a 1600x1152 image (K19: one image per map, the
    feature cache on) and on a 640x512 training step's batch-4 x 5-view
    fold (K19 and K20), then at UP2_EDGE_SHAPES. Returns the per-map
    totals of K19 and the per-step totals of K20 in both dtypes."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 9)
    per_map, per_step = {}, {}
    plans = (("map", 1, HEIGHT, WIDTH, per_map, "upsample2x_add"),
             ("step", TRAIN_BATCH * TRAIN_VIEWS, TRAIN_HEIGHT, TRAIN_WIDTH, per_step,
              "upsample2x_grad"))
    keys = ("ms", "device_ms", "call_ms", "plain_ms", "library_ms", "bound_ms", "bytes", "ops")
    for dtype in (torch.float32, BF16):
        for per, n, height, width, totals, name in plans:
            kname = kernel_name(name, dtype)
            tot = dict.fromkeys(keys, 0.0)
            tot.update(max_abs_err=0.0, max_rel_err=0.0, launches=len(FPN_CALLS))
            for c, s in FPN_CALLS:
                h, w = height // s, width // s
                rec = hold_upsample2x(f"{per}_{n}x{c}x{h}x{w}", n, c, h, w, dtype, gen)[kname]
                for key in keys:
                    tot[key] += rec[key]
                for key in ("max_abs_err", "max_rel_err"):
                    tot[key] = max(tot[key], rec[key])
                torch.cuda.empty_cache()
            totals[kname] = tot
        for n, c, h, w in UP2_EDGE_SHAPES:
            hold_upsample2x(f"edge_{n}x{c}x{h}x{w}", n, c, h, w, dtype, gen, timed=False)
    print(json.dumps({"upsample2x_totals": {"per_map": per_map, "per_step": per_step}}))
    return per_map, per_step


# ---------------------------------------------------------- the resizes
# The model's bilinear resizes outside FeatureNet (K28 launches, K29 where
# a gradient flows; models/itermvs.py `bilinear`), in the order it runs
# them: (site, channels (None: the sources, views − 1), the scale s of the
# input's H/s x W/s plane, that of the output, whether it runs in the
# compute dtype (else float32), tanh after it, whether it runs in training
# only, whether a gradient flows back through it).
RESIZE_SITES = (("ref_level1", FEATURE_CHANNELS["level1"], 2, 4, True, False, False, True),
                ("ref_level3", FEATURE_CHANNELS["level3"], 8, 4, True, False, False, True),
                ("view_weights", None, 8, 4, False, False, False, False),
                ("hidden", HIDDEN_DIM, 8, 4, True, True, False, True),
                ("init_depth", 1, 8, 4, False, False, True, True),
                ("confidence", 1, 4, 1, False, False, False, False))
# K28/K29 beside the main path's shapes, [n, c, ih, iw, oh, ow, tanh]:
# ×2 and ×½ on odd maps (the scalar path), a one-pixel map, ×4 on the run
# path, ×2 on its own run path (an odd row count with tanh, one row),
# ×½ on the run path with its word loads, and two ratios that are not
# powers of two (a float scale that is not exact).
RESIZE_EDGE_CASES = ((2, 3, 5, 7, 10, 14, True), (2, 3, 10, 14, 5, 7, False),
                     (1, 2, 1, 1, 2, 2, True), (1, 2, 3, 4, 12, 16, False),
                     (1, 3, 5, 8, 10, 16, True), (2, 2, 1, 4, 2, 8, False),
                     (2, 3, 8, 16, 4, 8, False), (1, 2, 7, 9, 5, 4, False),
                     (1, 2, 3, 5, 7, 11, True))
# Operations: K28 per output the formula's 6 products and 3 sums (tanhf
# one more); K29 per ∂x element ×2's 16 multiply-adds in float64 (as K20),
# ×½'s product and add, and tanh_backward's 3 per ∂out element.
K28_OPS, K29_UP2_OPS, K29_DOWN2_OPS, TANH_GRAD_OPS = 9, 32, 2, 3


def resize_sites(width, height, views, batch, dtype, train=False):
    """The resizes of one map (or, `train`, one training step's forward)
    at `width` x `height`: [(site, n, c, ih, iw, oh, ow, dtype, tanh,
    gradient)] (`RESIZE_SITES`)."""
    return [(site, batch, views - 1 if c is None else c, height // s_in, width // s_in,
             height // s_out, width // s_out, dtype if compute else torch.float32, tanh,
             grad and train)
            for site, c, s_in, s_out, compute, tanh, train_only, grad in RESIZE_SITES
            if train or not train_only]


def resize_work(n, c, ih, iw, oh, ow, itemsize, tanh=False, grad=False):
    """(bytes, operations, operations per second) of K28 (or K29, `grad`)
    for x [n, c, ih, iw] resized to (oh, ow): K28 reads x and writes the
    output, K29 reads ∂out (and the output, for tanh) and writes ∂x, each
    once."""
    small, big = n * c * ih * iw, n * c * oh * ow
    if not grad:
        return itemsize * (small + big), (K28_OPS + tanh) * big, PEAK_F32_PER_S
    pre = TANH_GRAD_OPS * big if tanh else 0
    nbytes = itemsize * (small + (2 if tanh else 1) * big)
    if (oh, ow) == (2 * ih, 2 * iw):
        return nbytes, K29_UP2_OPS * small + pre, PEAK_F64_PER_S
    return nbytes, K29_DOWN2_OPS * small + pre, PEAK_F32_PER_S


def resize_bytes(width, height, views, batch, dtype, train=False):
    """K28's bytes over the resizes of one map (or training forward) in
    the compute dtype `dtype` (`resize_sites`)."""
    return sum(resize_work(n, c, ih, iw, oh, ow, torch.finfo(dt).bits // 8, tanh)[0]
               for _, n, c, ih, iw, oh, ow, dt, tanh, _ in resize_sites(
                   width, height, views, batch, dtype, train))


def resize_inputs(n, c, ih, iw, oh, ow, dtype, gen, dev="cuda", views=1):
    """Seeded K28/K29 inputs in `dtype`, exponents spread as `up2_inputs`
    spreads them: x [n, c, ih, iw] (with `views` > 1 view 0 of [n, views,
    c, ih, iw], batch-strided as the model's reference features are) and
    ∂out [n, c, oh, ow]."""
    def spread(*shape):
        k = torch.randint(-8, 8, shape, device=dev, generator=gen).float()
        return (torch.randn(*shape, device=dev, generator=gen) * torch.exp2(k)).to(dtype)

    x = spread(n, views, c, ih, iw)[:, 0] if views > 1 else spread(n, c, ih, iw)
    return dict(x=x, g=spread(n, c, oh, ow))


def resize_library_grad(x, size, tanh, g):
    """A callable giving ∂x of F.interpolate (then torch.tanh) at x for
    ∂out g through autograd: PyTorch's upsample_bilinear2d_backward (a zero
    fill and atomic adds), after tanh_backward for the tanh form."""
    import torch.nn.functional as F

    xr = x.detach().requires_grad_()
    up = F.interpolate(xr, size=size, mode="bilinear", align_corners=False)
    if tanh:
        up = torch.tanh(up)
    return lambda: torch.autograd.grad(up, xr, g, retain_graph=True)[0]


def hold_resize(label, n, c, ih, iw, oh, ow, dtype, tanh, grad, gen, timed=True, views=1):
    """K28 in `dtype` for x [n, c, ih, iw] resized to (oh, ow) (then
    tanh) on `resize_inputs`, bit for bit against its plain version
    (F.interpolate, then torch.tanh, on the card), and where `grad` K29
    against the float64 sum of the same terms (∂pre = the card's
    tanh_backward for tanh, then ×2's 4x4 gather): within one unit in
    the last place for ×2, and for ×½ bit-equal to F.interpolate's
    autograd backward; each launched twice bit-equal, the wrappers'
    outputs equal to the bare launches'. Where `timed`: bare ms, device
    ms, the wrapper's (`call_ms`), the plain version's and the library's
    (`library_ms`: F.interpolate + tanh, K28's plain version; for K29
    their autograd backward). `views` > 1 reads x as a view's slice
    (`resize_inputs`). One JSON line per kernel; returns {report name:
    record}."""
    t = resize_inputs(n, c, ih, iw, oh, ow, dtype, gen, views=views)
    x, g = t["x"], t["g"]
    size = (oh, ow)
    itemsize = torch.finfo(dtype).bits // 8
    recs, lines = {}, []

    k28 = kernel_name("resize_bilinear", dtype)
    out = torch.empty(n, c, oh, ow, dtype=dtype, device="cuda")
    fwd = bare_launch(k28, resize_ops.resize_args(x, out, tanh))
    fwd()
    want = resize_ops.resize_plain(x, size, tanh)
    same = torch.equal(bits(out), bits(want))
    differ = (bits(out) != bits(want)).sum().item()
    err = (out.float() - want.float()).abs().max().item()
    first = out.clone()
    fwd()
    torch.cuda.synchronize()
    repeats = torch.equal(bits(first), bits(out))
    wrapper_equal = torch.equal(bits(resize_ops.resize_forward(x, size, tanh)), bits(out))
    nbytes, ops, rate = resize_work(n, c, ih, iw, oh, ow, itemsize, tanh)
    rec = {"max_abs_err": err, "max_rel_err": 0.0, "bytes": nbytes, "ops": ops,
           "library_ms": None}
    if timed:
        rec.update(ms=time_ms(fwd),
                   device_ms=sum(device_us(fwd, phase=f"{k28} at {label}").values()) / 1e3,
                   call_ms=time_ms(lambda: resize_ops.resize_forward(x, size, tanh)),
                   plain_ms=time_ms(lambda: resize_ops.resize_plain(x, size, tanh)))
        rec["library_ms"] = rec["plain_ms"]
    rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes, ops, rate)
    lines.append((k28, rec, {"bit_equal": same, "differ_from_plain": differ,
                             "two_launches_bit_equal": repeats,
                             "wrapper_equal": wrapper_equal, "tolerance": "bit-equal"}))
    ok = same and repeats and wrapper_equal

    if grad:
        k29 = kernel_name("resize_bilinear_grad", dtype)
        y = out if tanh else None
        d_x = torch.empty_like(x)
        bwd = bare_launch(k29, resize_ops.resize_grad_args(g, y, d_x))
        bwd()
        pre = torch.ops.aten.tanh_backward(g, y) if tanh else g
        up = size == (2 * ih, 2 * iw)
        library_grad = resize_library_grad(x, size, tanh, g)
        if up:
            exact = resize_ops.upsample2x_grad_plain(pre.double(), (ih, iw))
            err_ulps = ulps(d_x, exact, dtype).max().item()
            library_ulps = ulps(library_grad(), exact, dtype).max().item()
        else:
            exact = resize_ops.resize_grad_plain(pre.double(), (ih, iw))
            library = library_grad()
            err_ulps = 0.0 if torch.equal(bits(d_x), bits(library)) else math.inf
            library_ulps = 0.0
        err = (d_x.double() - exact).abs().max().item()
        rel = err / max(exact.abs().max().item(), 1e-30)
        del exact
        first = d_x.clone()
        bwd()
        torch.cuda.synchronize()
        repeats = torch.equal(bits(first), bits(d_x))
        wrapper_equal = torch.equal(
            bits(resize_ops.resize_grad(g, (ih, iw), y)), bits(d_x))
        nbytes, ops, rate = resize_work(n, c, ih, iw, oh, ow, itemsize, tanh, grad=True)
        rec = {"max_abs_err": err, "max_rel_err": rel, "bytes": nbytes, "ops": ops,
               "library_ms": None}
        if timed:
            rec.update(ms=time_ms(bwd),
                       device_ms=sum(device_us(bwd, phase=f"{k29} at {label}").values()) / 1e3,
                       call_ms=time_ms(lambda: resize_ops.resize_grad(g, (ih, iw), y)),
                       plain_ms=time_ms(lambda: resize_ops.resize_grad_plain(g, (ih, iw), y)),
                       library_ms=time_ms(library_grad))
        rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes, ops, rate)
        lines.append((k29, rec, {"max_ulps": err_ulps, "library_max_ulps": library_ulps,
                                 "two_launches_bit_equal": repeats,
                                 "wrapper_equal": wrapper_equal,
                                 "tolerance": "1 ulp of the float64 sum" if up else
                                 "bit-equal to F.interpolate's backward"}))
        ok = ok and repeats and wrapper_equal and err_ulps <= 1.0
    for kname, rec, gates in lines:
        extra = {"share": rec["bound_ms"] / rec["ms"]} if timed else {}
        print(json.dumps({"kernel": kname, "shape": label, "x": [n, c, ih, iw],
                          "x_strides": list(x.stride()), "out": [oh, ow], "tanh": tanh,
                          **gates, **rec, **extra}))
        recs[kname] = rec
    if not ok:
        raise SystemExit(f"resize_bilinear/resize_bilinear_grad {dtype} at {label}: {lines}")
    return recs


def check_resize():
    """K28 and K29 against their plain versions on the card
    (`hold_resize`) at every site of `RESIZE_SITES`, on a 1600x1152 map
    and on a 640x512 training step's batch of 4 (K29 there; the reference
    features as view 0 of the step's 5 views), the sites of the compute
    dtype in float32 and bfloat16, then at RESIZE_EDGE_CASES, the odd ×½
    one also on a view's slice.
    Returns the per-map totals of K28 (the 5 resizes a map runs) and the
    per-step totals of K29, in both dtypes, keyed by report name."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 12)
    per_map, per_step = {}, {}
    keys = ("ms", "device_ms", "call_ms", "plain_ms", "library_ms", "bound_ms", "bytes", "ops")
    plans = (("map", 1, HEIGHT, WIDTH, per_map, "resize_bilinear"),
             ("step", TRAIN_BATCH, TRAIN_HEIGHT, TRAIN_WIDTH, per_step, "resize_bilinear_grad"))
    for per, batch, height, width, totals, name in plans:
        in_eval = {s[0] for s in resize_sites(width, height, VIEWS, batch, torch.float32)}
        for dtype in (torch.float32, BF16):
            for site, n, c, ih, iw, oh, ow, dt, tanh, grad in resize_sites(
                    width, height, VIEWS, batch, dtype, train=True):
                if dt != dtype:             # a float32 site: held in the float32 round
                    continue
                views = TRAIN_VIEWS if per == "step" and site.startswith("ref_") else 1
                recs = hold_resize(f"{per}_{site}_{n}x{c}x{ih}x{iw}", n, c, ih, iw, oh, ow,
                                   dt, tanh, grad and per == "step", gen, views=views)
                kname = kernel_name(name, dt)
                if kname in recs and (per == "step" or site in in_eval):
                    tot = totals.setdefault(kname, dict.fromkeys(keys, 0.0) | dict(
                        max_abs_err=0.0, max_rel_err=0.0, launches=0))
                    for key in keys:
                        tot[key] += recs[kname][key]
                    for key in ("max_abs_err", "max_rel_err"):
                        tot[key] = max(tot[key], recs[kname][key])
                    tot["launches"] += 1
                torch.cuda.empty_cache()
    for dtype in (torch.float32, BF16):
        for n, c, ih, iw, oh, ow, tanh in RESIZE_EDGE_CASES:
            grad = (oh, ow) == (2 * ih, 2 * iw) or (ih, iw) == (2 * oh, 2 * ow)
            hold_resize(f"edge_{n}x{c}x{ih}x{iw}_to_{oh}x{ow}", n, c, ih, iw, oh, ow, dtype,
                        tanh, grad, gen, timed=False)
        hold_resize("edge_view_slice_2x3x10x14_to_5x7", 2, 3, 10, 14, 5, 7, dtype, False,
                    True, gen, timed=False, views=3)
    print(json.dumps({"resize_totals": {"per_map": per_map, "per_step": per_step}}))
    return per_map, per_step


def resize_op_events(events):
    """{name: calls} of the host ops and device kernels among `events` that
    belong to the eager resizes K28 and K29 replaced: PyTorch's bilinear
    resize and its backward (`aten::upsample_bilinear2d*`, autograd's
    `UpsampleBilinear2DBackward*`, their `upsample_bilinear2d*` kernels)
    and tanh (`aten::tanh`, `TanhBackward0`, `aten::tanh_backward` and
    their kernels); the model runs no other tanh on the card."""
    found = {}
    for e in events:
        low = e.name.lower()
        if "upsample_bilinear2d" in low or "upsamplebilinear2d" in low or "tanh" in low:
            found[e.name[:90]] = found.get(e.name[:90], 0) + 1
    return found


# ------------------------------------------------------------- the loss
# K23's sums against the plain forward evaluated in float64 (relative, per
# term: each pixel's term is float32 in K23, its float64 value in the
# reference, from the same float32 normalisation and decisions); K24's
# outputs against its plain formula in float64 (relative to each output's
# largest element).
LOSS_SUM_REL, LOSS_GRAD_REL = 1e-6, 1e-6
# K23/K24 beside the training step's shapes: (label, batch, h, w,
# predictions, regress, empty mask, upstream gradient). 7x9 takes K24's
# one-pixel stores (H·W not a multiple of 4); 16 predictions fill the
# kernels' pointer arrays.
LOSS_EDGE_CASES = (("stage1", TRAIN_BATCH, 128, 160, 1 + TRAIN_ITERATION, False, False, 1.0),
                   ("empty_mask", 2, 16, 20, 3, True, True, 1.0),
                   ("odd_7x9", 3, 7, 9, 2, True, False, 0.37),
                   ("one_prediction", 1, 8, 12, 1, True, False, -2.0),
                   ("sixteen", 2, 4, 8, 16, True, False, 1.0))
# Operations per (pixel, prediction) of each kernel besides its per-bin
# work (the normalisations, the terms, their gradients), per level-0
# pixel, and per bin (K23: a clamp and a comparison; K24: a select).
LOSS_OPS_PER_PIXEL, LOSS_OPS_PER_PIXEL0, LOSS_OPS_PER_BIN = 40, 20, 2


def loss_work(n, pixels, pixels0, regress, grad=False):
    """(bytes, operations) of K23 (or K24, `grad`) for n predictions over
    `pixels` level-2 and `pixels0` level-0 pixels: each input read once,
    each output written once. K23 reads every bin of each probability in
    stage 2 and only the GT bin's in stage 1, the level-2 GT, mask and
    initial depth, each combine and confidence (stage 2), the level-0
    GT, mask and upsampled depth, and writes p at the GT bin and the
    flags (its sums are a few bytes); K24 reads those (not the
    probabilities) and writes the dense ∂p, ∂initial, each ∂combine and
    ∂confidence, and ∂up."""
    per = n if regress else 0
    level = 12 * pixels + 8 * per * pixels + 12 * pixels0
    saved = 4 * n * pixels + (n + 1) * pixels
    bins = NUM_BINS if regress or grad else 1
    if grad:
        nbytes = level + saved + 4 * NUM_BINS * n * pixels + 4 * (1 + 2 * per) * pixels
        nbytes += 4 * pixels0
    else:
        nbytes = level + saved + 4 * bins * n * pixels
    ops = LOSS_OPS_PER_BIN * bins * n * pixels
    return nbytes, ops + LOSS_OPS_PER_PIXEL * n * pixels + LOSS_OPS_PER_PIXEL0 * pixels0


def inputs_work(inp, regress, grad=False):
    """`loss_work` of `LossInputs`."""
    return loss_work(len(inp.probs), inp.gt2.numel(), inp.gt0.numel(), regress, grad)


def loss_case(b, h, w, n, gen, regress=True, empty=False, dev="cuda"):
    """models/losses.py's arguments as the model hands them (each
    probability a [B, H, W, 256] view of NCHW storage, the depths and
    logits [B, H, W, 1] views of [B, 1, H, W]), seeded, depth range about
    2..12 per image, with, on image 0's first row (where it is 9 wide):
    GT bins 0 and 255, argmaxes at GT + 4, − 4, + 5, − 5, p at the GT
    bin below 1e-5 and exactly 1e-5, a combine equal to its GT (|δ| = 0)
    with a confidence logit of exactly 0, and (where 11 wide) a NaN bin
    and a column with +inf and −inf bins; where `empty`, no valid pixel
    at level 2."""
    u = lambda *s: torch.rand(*s, device=dev, generator=gen)
    dmin, dmax = 2.0 + u(b), 10.0 + 2.0 * u(b)
    lo, hi = (0.9 * dmin).view(b, 1, 1), (1.1 * dmax).view(b, 1, 1)
    gt2 = lo + u(b, h, w) * (hi - lo)
    m2 = (u(b, h, w) > 0.25).float()
    gt0 = lo + u(b, 4 * h, 4 * w) * (hi - lo)
    m0 = (u(b, 4 * h, 4 * w) > 0.25).float()
    logits = 3.0 * u(n, b, NUM_BINS, h, w)
    combine = lo[None] + u(n, b, h, w) * (hi - lo)[None]
    conf = 4.0 * u(n, b, h, w) - 2.0
    plant = w >= 9
    if plant:
        gt2[0, 0, :2] = torch.stack([1.5 * dmax[0], 0.7 * dmin[0]])
        gt2[0, 0, 2:9] = torch.linspace(1.5, 0.7, 7, device=dev) * dmin[0] + torch.linspace(
            0.0, 0.3, 7, device=dev) * dmax[0]
        m2[0, 0, :9] = 1.0
        combine[:, 0, 0, 8] = gt2[0, 0, 8]
        conf[:, 0, 0, 8] = 0.0
    if empty:
        m2.zero_()
    gt = full_loss_ops._decisions(full_loss_ops.LossInputs(
        dmin, dmax, gt2, m2, gt0, m0, gt2, gt0, (), (), ()))[-1]
    if plant:
        for col, off in zip(range(2, 6), (4, -4, 5, -5)):
            logits[:, 0, (gt[0, 0, col] + off).clamp(0, NUM_BINS - 1), 0, col] = 12.0
        logits[:, 0, gt[0, 0, 6], 0, 6] = -30.0
    prob = torch.softmax(logits, dim=2)
    if plant:
        prob[:, 0, gt[0, 0, 7], 0, 7] = full_loss_ops.P_MIN
    if w >= 11:             # K23's exact scan: a NaN bin; infinities of both signs
        prob[:, 0, (gt[0, 0, 9] + 20) % NUM_BINS, 0, 9] = math.nan
        prob[:, 0, (gt[0, 0, 10] + 30) % NUM_BINS, 0, 10] = math.inf
        prob[:, 0, (gt[0, 0, 10] + 40) % NUM_BINS, 0, 10] = -math.inf
    view = lambda x: x.unsqueeze(1).permute(0, 2, 3, 1)
    outputs = {"depths": {"probability": [p.permute(0, 2, 3, 1) for p in prob],
                          "combine": [view(c) for c in combine],
                          "initial": [view(lo + u(b, h, w) * (hi - lo))]},
               "confidences": [view(c) for c in conf],
               "depths_upsampled": [view(lo + u(b, 4 * h, 4 * w) * (hi - lo))]}
    gts = {"level_2": gt2[..., None], "level_0": gt0[..., None]}
    masks = {"level_2": m2[..., None], "level_0": m0[..., None]}
    return full_loss_ops.loss_tensors(outputs, gts, masks, dmin, dmax, regress)


def step_loss_tensors(batch, dtype=torch.float32):
    """The loss's arguments (`loss_tensors`, stage 2) of one training
    forward at the step's shapes from a fresh seeded init in `dtype`, not
    differentiated."""
    model = init_weights(Pipeline(iteration=TRAIN_ITERATION, test=False, dtype=dtype),
                         SEED).cuda()
    model.train()
    with torch.no_grad():
        outputs = model(batch["imgs"], batch["proj_matrices"], batch["depth_min"],
                        batch["depth_max"])
    return full_loss_ops.loss_tensors(outputs, batch["depth"], batch["mask"],
                                      batch["depth_min"], batch["depth_max"], True)


def grad_rel(got, exact):
    """max |got − exact| / max |exact| (0 where both are all 0; inf where
    only the exact one is)."""
    top = exact.abs().max().item()
    err = (got.double() - exact).abs().max().item()
    return err / top if top > 0 else (0.0 if err == 0 else math.inf)


def hold_full_loss(label, tensors, regress, upstream=1.0, timed=True):
    """K23 and K24 on the loss's arguments `tensors` (`loss_tensors`): K23's
    sums within LOSS_SUM_REL of float64 per term, its counts, p at the GT
    bin, GT bins, argmax windows and argmaxes equal to the plain
    version's, two launches bit-equal, the wrapper's launch equal to the
    bare one; K24 (upstream gradient `upstream`, this process's counts)
    within LOSS_GRAD_REL of its float64 formula, two launches bit-equal
    (each into outputs filled with NaN first: every element written), the
    wrapper's equal. Where `timed`: each bare launch (`ms`, `device_ms`),
    its wrapper (`call_ms`), and the eager loss's forward and backward
    (`plain_ms` of K23 and of K24; both together printed). One JSON line
    per kernel; returns {report name: record}."""
    inp = full_loss_ops.kernel_inputs(full_loss_ops.loss_inputs(regress, *tensors))
    n = len(inp.probs)
    stats, p_gt, flags, partials = full_loss_ops.terms_buffers(inp, regress)
    arg = torch.empty_like(p_gt, dtype=torch.int32)
    run = bare_launch("full_loss", full_loss_ops.full_loss_args(
        inp, regress, stats, p_gt, flags, partials, arg))
    run()
    want, (want_p, want_flags), want_arg = full_loss_ops.loss_terms_plain(
        inp, regress, acc=torch.float64, argmax=True)
    plain32 = full_loss_ops.loss_terms_plain(inp, regress)[0]
    sums = {"k23": stats[0].double(), "plain_f32": plain32[0]}
    rel = {k: ((v - want[0]).abs() / want[0].abs().clamp_min(1e-300)).max().item()
           for k, v in sums.items()}
    exact = {"counts": torch.equal(stats[1], want[1]), "p_gt": torch.equal(bits(p_gt),
                                                                            bits(want_p)),
             "flags": torch.equal(flags, want_flags),
             "argmax": not regress or torch.equal(arg, want_arg)}
    first = [t.clone() for t in (stats, p_gt, flags)]
    run()
    torch.cuda.synchronize()
    repeats = all(torch.equal(bits(a), bits(b)) for a, b in zip(first, (stats, p_gt))) and \
        torch.equal(first[2], flags)
    wrapped = full_loss_ops.full_loss_terms(inp, regress)
    wrapper_equal = torch.equal(bits(wrapped[0]), bits(stats)) and all(
        torch.equal(a, b) for a, b in zip(wrapped[1], (p_gt, flags)))

    saved, counts = (p_gt, flags), stats[1].clone()
    grad = torch.full((), upstream, device=p_gt.device)
    outs = full_loss_ops.grad_buffers(inp, regress)
    flat = lambda o: [*o[0], o[1], o[2]]
    run_grad = bare_launch("full_loss_grad", full_loss_ops.full_loss_grad_args(
        inp, regress, grad, counts, saved, outs))

    def fresh_grad():
        for t in flat(outs):
            t.fill_(math.nan)
        run_grad()

    fresh_grad()
    ref = full_loss_ops.full_loss_grad_plain(grad, counts, saved, inp, regress,
                                             acc=torch.float64)
    plain_grad = full_loss_ops.full_loss_grad_plain(grad, counts, saved, inp, regress)
    got = [torch.stack(outs[0]), outs[1], outs[2]]
    grad_errs = {name: grad_rel(g, r) for name, g, r in zip(("prob", "small", "up"), got, ref)}
    grad_abs = max((g - p).abs().max().item() for g, p in zip(got, plain_grad))
    del ref, plain_grad
    first_grad = [t.clone() for t in flat(outs)]
    fresh_grad()
    torch.cuda.synchronize()
    grad_repeats = all(torch.equal(bits(a), bits(b)) for a, b in zip(first_grad, flat(outs)))
    wrapped_grad = full_loss_ops.full_loss_grad(grad, counts, saved, inp, regress)
    grad_wrapper_equal = all(torch.equal(bits(a), bits(b))
                             for a, b in zip(flat(wrapped_grad), flat(outs)))
    del first_grad, wrapped_grad

    recs = {}
    for name, nbytes_ops, err in (("full_loss", inputs_work(inp, regress), rel["k23"]),
                                  ("full_loss_grad", inputs_work(inp, regress, True),
                                   max(grad_errs.values()))):
        recs[name] = {"max_abs_err": (stats[0] - plain32[0]).abs().max().item()
                      if name == "full_loss" else grad_abs, "max_rel_err": err,
                      "bytes": nbytes_ops[0], "ops": nbytes_ops[1], "library_ms": None}
    if timed:
        leaves = [t.detach().clone().requires_grad_(i >= 6) for i, t in enumerate(tensors)]
        eager = lambda: full_loss_ops.full_loss_plain(*plain_arguments(leaves, regress),
                                                      regress=regress)
        loss = eager()
        need = [t for t in leaves if t.requires_grad]
        backward = lambda: torch.autograd.grad(loss, need, retain_graph=True)
        both = lambda: torch.autograd.grad(eager(), need)
        recs["full_loss"].update(
            ms=time_ms(run), device_ms=sum(device_us(run, phase=f"full_loss at {label}")
                                           .values()) / 1e3,
            call_ms=time_ms(lambda: full_loss_ops.full_loss_terms(inp, regress)),
            plain_ms=time_ms(eager))
        recs["full_loss_grad"].update(
            ms=time_ms(run_grad),
            device_ms=sum(device_us(run_grad, phase=f"full_loss_grad at {label}").values())
            / 1e3,
            call_ms=time_ms(lambda: full_loss_ops.full_loss_grad(grad, counts, saved, inp,
                                                                 regress)),
            plain_ms=time_ms(backward))
        plain_both_ms = time_ms(both)
        del loss, leaves, need, backward, both
    for name, rec in recs.items():
        rec["bound_ms"], rec["bound_by"] = bound_ms(rec["bytes"], rec["ops"])
        line = {"kernel": name, "shape": label, "batch": inp.gt2.shape[0],
                "h": inp.gt2.shape[1], "w": inp.gt2.shape[2], "predictions": n,
                "regress": regress, "upstream": upstream, **rec}
        if timed:
            line.update(share=rec["bound_ms"] / rec["ms"], plain_fwd_bwd_ms=plain_both_ms)
        if name == "full_loss":
            line.update(sums_rel_err=rel, exact=exact, two_launches_bit_equal=repeats,
                        wrapper_equal=wrapper_equal, loss_terms=stats[0].tolist(),
                        counts=stats[1].tolist(),
                        tolerance=f"{LOSS_SUM_REL} of float64 per term, relative")
            ok = rel["k23"] <= LOSS_SUM_REL and all(exact.values()) and repeats and wrapper_equal
        else:
            line.update(grad_rel_err=grad_errs, two_launches_bit_equal=grad_repeats,
                        wrapper_equal=grad_wrapper_equal,
                        tolerance=f"{LOSS_GRAD_REL} of max |float64|")
            ok = (max(grad_errs.values()) <= LOSS_GRAD_REL and grad_repeats
                  and grad_wrapper_equal)
        print(json.dumps(line))
        if not ok:
            raise SystemExit(f"{name} at {label}: {line}")
    torch.cuda.empty_cache()
    return recs


def plain_arguments(tensors, regress):
    """models/losses.py's arguments from `loss_tensors`' flat form."""
    dmin, dmax, gt2, m2, gt0, m0, initial, up, *rest = tensors
    n = len(rest) // (3 if regress else 1)
    probs, combines, confs = rest[:n], rest[n:2 * n], rest[2 * n:]
    outputs = {"depths": {"probability": probs, "combine": combines or [None] * n,
                          "initial": [initial]},
               "confidences": confs, "depths_upsampled": [up]}
    return (outputs, {"level_2": gt2, "level_0": gt0}, {"level_2": m2, "level_0": m0}, dmin,
            dmax)


def check_full_loss():
    """K23 and K24 (`hold_full_loss`) at the training step's shapes (batch
    4, 128x160, level 0 512x640, 5 predictions): stage 2 on seeded inputs
    with the edge cases planted (`loss_case`), on one real step's
    inputs (a fresh seeded init's forward on the plane scene), then the
    LOSS_EDGE_CASES. Returns the per-step records of both kernels (the
    real step's, timed)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 30)
    h, w, n = TRAIN_HEIGHT // 4, TRAIN_WIDTH // 4, 1 + TRAIN_ITERATION
    hold_full_loss("step_planted", loss_case(TRAIN_BATCH, h, w, n, gen), True, timed=False)
    batch = to_device_batch(train_sample(TRAIN_WIDTH, TRAIN_HEIGHT, TRAIN_VIEWS, TRAIN_BATCH,
                                         SEED), "cuda")
    per_step = hold_full_loss("step_real", step_loss_tensors(batch), True)
    del batch
    for label, b, eh, ew, en, regress, empty, upstream in LOSS_EDGE_CASES:
        hold_full_loss(f"edge_{label}", loss_case(b, eh, ew, en, gen, regress, empty), regress,
                       upstream, timed=False)
    for rec in per_step.values():
        rec["launches"] = 1
    print(json.dumps({"full_loss_totals": {"per_step": per_step}}))
    return per_step


# ------------------------------------------------------------ the optimizer update
# K25's sum against the float64 sum of the same squares (relative); K26's
# p, m and v against the plain version in units in the last place: every
# operation is a _rn intrinsic in the kernel and one PyTorch kernel in the
# plain version, so 0 (bit for bit), from the same state and K25's norm.
GRAD_NORM_REL = 1e-12
CLIP_ADAM_ULPS = 0
# `check_clip_adam`'s cases: (label, the gradients' global norm, the
# weight decay), each over CLIP_STEPS consecutive steps from a fresh state
# (t = 1, 2, 3: the bias corrections), new gradients at each step.
CLIP_CASES = (("clip", 10.0, 0.0), ("no_clip", 1.0, 0.0), ("clip_wd", 10.0, 1e-4),
              ("no_clip_wd", 1.0, 1e-4))
CLIP_STEPS = 3
# Operations per element: K25 a float64 square and add; K26 the clip's
# divide and multiply, the decay's multiply and add, the moments' 7, the
# bias corrections' 2 divides, a square root, an add and a divide, and
# the update's multiply and add.
GRAD_NORM_OPS, CLIP_ADAM_OPS = 2, 19


@functools.lru_cache(maxsize=None)
def model_param_shapes():
    """The training model's parameter shapes in `parameters()` order (the
    optimizer's one group): 100 tensors, 341,333 elements."""
    return tuple(tuple(p.shape) for p in
                 Pipeline(iteration=TRAIN_ITERATION, test=False).parameters())


def update_work(numel, kernel):
    """(bytes, operations) of K25 (`grad_norm`: each gradient read once)
    or K26 (`clip_adam`: g, p, m and v read, p, m and v written, which is
    also the whole chain's least traffic) over `numel` elements."""
    if kernel == "grad_norm":
        return 4 * numel, GRAD_NORM_OPS * numel
    return 28 * numel, CLIP_ADAM_OPS * numel


def clip_adam_case(norm, steps, gen, dev="cuda"):
    """(params, [grads of each of `steps` steps]) at the training model's
    parameter shapes: the parameters of `init_weights(SEED)`, each step's
    gradients normal draws from `gen` scaled to the global norm `norm`."""
    params = [p.detach().to(dev).clone() for p in init_weights(
        Pipeline(iteration=TRAIN_ITERATION, test=False), SEED).parameters()]
    per_step = []
    for _ in range(steps):
        grads = [torch.randn(p.shape, device=dev, generator=gen) for p in params]
        scale = norm / clip_ops.grad_norm_plain(grads)[1].item()
        per_step.append([g * scale for g in grads])
    return params, per_step


def ulps_apart(got, want):
    """The largest distance in float32 units in the last place between the
    tensors of `got` and `want` (bit patterns as ordered integers)."""
    def ordered(t):
        i = t.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return max(((ordered(a) - ordered(b)).abs().max().item() for a, b in zip(got, want)),
               default=0)


def hold_clip_adam(label, norm, wd, gen, timed=False, smi=""):
    """K25 and K26 at `clip_adam_case`'s tensors over CLIP_STEPS steps from
    zero moments, launched bare, beside the plain versions run on copies:
    each step's K25 sum within GRAD_NORM_REL of the float64 sum and two
    launches bit-equal; K26's p, m and v within CLIP_ADAM_ULPS of the plain
    version's from the same state and norm, and two launches from that
    state bit-equal. Then `clip_adam_step_` on a torch.optim.Adam over the
    first state takes the same steps: one launch of each kernel per step,
    and p, m, v and the step bit-equal to the bare launches'. Where `timed`:
    bare ms, the profiler's device ms, bound, share and the launch floor
    (the same C call over one element) of each kernel, the wrappers' and
    the entry point's ms, the plain versions' ms, the eager path's
    (`clip_by_global_norm_` + `torch.optim.Adam.step`, foreach) and the
    library's (`clip_grad_norm_(foreach=True)` + `Adam(fused=True).step`).
    One JSON line per kernel; returns {report name: record}."""
    params, step_grads = clip_adam_case(norm, CLIP_STEPS, gen)
    numel = sum(p.numel() for p in params)
    ms, vs = [torch.zeros_like(p) for p in params], [torch.zeros_like(p) for p in params]
    start = [p.clone() for p in params]
    grads = [g.clone() for g in step_grads[0]]
    group = {"lr": TRAIN_LR, "betas": (0.9, 0.999), "eps": 1e-8, "weight_decay": wd}
    tables, blocks = clip_ops.tensor_tables(grads, params, ms, vs)
    out = torch.empty(2 + blocks, dtype=torch.float64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    run_norm = bare_launch("grad_norm", (tables, len(tables), out[2:].data_ptr(), blocks,
                                         out.data_ptr(), stream))
    flat = lambda: [*params, *ms, *vs]
    norm_rel, norm_repeats, ulps, abs_err, repeats, steps = 0.0, True, 0, 0.0, True, []
    for step, new in enumerate(step_grads, 1):
        for g, n in zip(grads, new):
            g.copy_(n)
        h = clip_ops.hyper(group, step)
        run_norm()
        first = out[:2].clone()
        run_norm()
        want = torch.stack([g.double().square().sum() for g in grads]).sum().item()
        got = out[0].item()
        norm_rel = max(norm_rel, abs(got - want) / want)
        norm_repeats &= torch.equal(bits(first), bits(out[:2]))
        run = bare_launch("clip_adam", (tables, len(tables), out.data_ptr(), *h, stream))
        before = [t.clone() for t in flat()]
        plain = [t.clone() for t in before]
        n = len(params)
        clip_ops.clip_adam_plain_(plain[:n], grads, plain[n:2 * n], plain[2 * n:], out[:2], h)
        run()
        once = [t.clone() for t in flat()]
        for t, b in zip(flat(), before):
            t.copy_(b)
        run()
        torch.cuda.synchronize()
        ulps = max(ulps, ulps_apart(flat(), plain))
        abs_err = max(abs_err, max((a - b).abs().max().item() for a, b in zip(flat(), plain)))
        repeats &= all(torch.equal(bits(a), bits(b)) for a, b in zip(once, flat()))
        steps.append({"t": step, "sum": got, "norm": out[1].item(),
                      "clipped": not out[1].item() < clip_ops.CLIP_NORM})
        del before, plain, once
    # The entry point on a torch.optim.Adam over the first state.
    module = torch.nn.ParameterList([torch.nn.Parameter(t.clone()) for t in start])
    optimizer = torch.optim.Adam(module.parameters(), lr=TRAIN_LR, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=wd)
    launches = (clip_ops.grad_norm.launches, clip_ops.clip_adam_.launches)
    for new in step_grads:
        for p, g in zip(module.parameters(), new):
            p.grad = g.clone()
        clip_ops.clip_adam_step_(optimizer)
    torch.cuda.synchronize()
    step_launches = (clip_ops.grad_norm.launches - launches[0],
                     clip_ops.clip_adam_.launches - launches[1])
    state = [optimizer.state[p] for p in module.parameters()]
    wrapper_equal = step_launches == (CLIP_STEPS, CLIP_STEPS) and all(
        torch.equal(bits(p.detach()), bits(q)) and torch.equal(bits(s["exp_avg"]), bits(m))
        and torch.equal(bits(s["exp_avg_sq"]), bits(v)) and s["step"].item() == CLIP_STEPS
        for p, q, s, m, v in zip(module.parameters(), params, state, ms, vs))

    recs = {}
    for name, err in (("grad_norm", norm_rel), ("clip_adam", float(ulps))):
        nbytes, ops = update_work(numel, name)
        recs[name] = {"bytes": nbytes, "ops": ops, "max_rel_err": err, "library_ms": None,
                      "launches": 1,
                      "max_abs_err": norm_rel * steps[-1]["sum"] if name == "grad_norm"
                      else abs_err}
        recs[name]["bound_ms"], recs[name]["bound_by"] = bound_ms(nbytes, ops)
    if timed:
        h = clip_ops.hyper(group, CLIP_STEPS + 1)
        run = bare_launch("clip_adam", (tables, len(tables), out.data_ptr(), *h, stream))
        # The launch floor: the same C calls over one element.
        one = [torch.zeros(1, device="cuda") for _ in range(4)]
        one_tables, one_blocks = clip_ops.tensor_tables(one[1:2], one[:1], one[2:3], one[3:])
        one_out = torch.zeros(2 + one_blocks, dtype=torch.float64, device="cuda")
        floor_norm = bare_launch("grad_norm", (one_tables, 1, one_out[2:].data_ptr(),
                                               one_blocks, one_out.data_ptr(), stream))
        floor_adam = bare_launch("clip_adam", (one_tables, 1, one_out.data_ptr(), *h, stream))
        plain_state = [t.clone() for t in flat()]
        n = len(params)
        calls = {
            "grad_norm": (lambda: clip_ops.grad_norm(grads), lambda: clip_ops.grad_norm_plain(
                grads)),
            "clip_adam": (lambda: clip_ops.clip_adam_(params, grads, ms, vs, out[:2], h),
                          lambda: clip_ops.clip_adam_plain_(
                              plain_state[:n], grads, plain_state[n:2 * n],
                              plain_state[2 * n:], out[:2], h))}
        for p, g in zip(module.parameters(), grads):
            p.grad = g.clone()
        entry_ms = time_ms(lambda: clip_ops.clip_adam_step_(optimizer))

        def adam(fused):
            """An optimizer step of `fused` Adam (or the default foreach one)
            over copies of the first state, gradients set once (the clips
            below leave their norm at 2.0, so each call does the same
            work)."""
            ps = [torch.nn.Parameter(t.clone()) for t in start]
            for p, g in zip(ps, grads):
                p.grad = g.clone()
            return ps, torch.optim.Adam(ps, lr=TRAIN_LR, betas=(0.9, 0.999), eps=1e-8,
                                        weight_decay=wd, fused=fused)

        eager_params, eager_opt = adam(None)
        library_params, library_opt = adam(True)

        def eager():
            train_loop.clip_by_global_norm_(eager_params)
            eager_opt.step()

        def library():
            torch.nn.utils.clip_grad_norm_(library_params, clip_ops.CLIP_NORM, foreach=True)
            library_opt.step()

        for name, bare, floor in (("grad_norm", run_norm, floor_norm),
                                  ("clip_adam", run, floor_adam)):
            rec = recs[name]
            rec.update(ms=time_ms(bare, reps=100), call_ms=time_ms(calls[name][0], reps=100),
                       device_ms=sum(device_us(bare, phase=f"{name} at {label}").values())
                       / 1e3, launch_floor_ms=time_ms(floor, reps=100),
                       launch_floor_device_ms=sum(device_us(
                           floor, phase=f"{name} floor at {label}").values()) / 1e3,
                       plain_ms=time_ms(calls[name][1]))
            rec.update(share=rec["bound_ms"] / rec["ms"],
                       device_share=rec["bound_ms"] / rec["device_ms"])
        recs["clip_adam"].update(
            library_ms=time_ms(library),
            library_device_ms=device_capture(library, f"library update at {label}")[2],
            library_note="clip_grad_norm_(foreach=True) + Adam(fused=True).step over the "
                         "same tensors: a near function (it scales by 2/(n + 1e-6) always "
                         "and rounds in torch's order) standing for the whole chain, K25 + "
                         "K26; a yardstick only, never on the path",
            eager_ms=time_ms(eager),
            eager_device_ms=device_capture(eager, f"eager update at {label}")[2],
            eager_note="clip_by_global_norm_ + torch.optim.Adam.step (foreach): what the "
                       "port ran before K25 and K26",
            entry_ms=entry_ms,
            entry_note="clip_adam_step_ on a torch.optim.Adam: the tables, both C calls")
        del plain_state, eager_params, eager_opt, library_params, library_opt
    del module, optimizer, state
    for name, rec in recs.items():
        line = {"kernel": name, "shape": label, "tensors": len(params), "elements": numel,
                "weight_decay": wd, "steps": steps if name == "grad_norm" else CLIP_STEPS,
                **rec, "card": smi}
        if name == "grad_norm":
            line.update(two_launches_bit_equal=norm_repeats,
                        tolerance=f"{GRAD_NORM_REL} of the float64 sum, relative")
            ok = norm_rel <= GRAD_NORM_REL and norm_repeats
        else:
            line.update(max_ulps=ulps, two_launches_bit_equal=repeats,
                        wrapper_equal=wrapper_equal, entry_launches=step_launches,
                        tolerance=f"{CLIP_ADAM_ULPS} ulp of the plain version (p, m, v)")
            ok = ulps <= CLIP_ADAM_ULPS and repeats and wrapper_equal
        print(json.dumps(line))
        if not ok:
            raise SystemExit(f"{name} at {label}: {line}")
    return recs


def check_clip_adam(smi=""):
    """K25 and K26 (`hold_clip_adam`) at the training model's 100 parameter
    shapes from the seeded init, with gradients drawn from SEED: each of
    CLIP_CASES (the global norm above and below 2.0, weight decay 0 and
    1e-4) over three steps, the first case timed. Returns the per-step
    records of both kernels (the timed case's)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    per_step = None
    for i, (label, norm, wd) in enumerate(CLIP_CASES):
        recs = hold_clip_adam(label, norm, wd, gen, timed=i == 0, smi=smi)
        per_step = per_step or recs
    print(json.dumps({"clip_adam_totals": {"per_step": per_step}}))
    return per_step


# ------------------------------------------------------------ the metrics
# K27's gates (`hold_depth_metrics`): each outlier rate within METRIC_ULPS
# float32 units in the last place of the plain version on the same inputs
# (both divide each image's exact counts in float32 and sum the batch in
# float64, exactly: 0 expected), each mean error within METRIC_REL of the
# plain version on float64 copies and NaN exactly where that is NaN, the
# counts of images with a valid pixel equal.
METRIC_ULPS, METRIC_REL = 1, 1e-6
# Operations per level-2 pixel (the mask's compare and its count's add),
# per level-2 pixel and prediction (subtract, abs, multiply, add; compare,
# multiply, add) and per level-0 pixel (those, and 3 per threshold more).
METRIC_OPS_PER_PIXEL2, METRIC_OPS_PER_PREDICTION, METRIC_OPS_PER_PIXEL0 = 2, 7, 18
# `check_depth_metrics`' cases after the step's: (label, batch, level-2
# height, width, predictions, kind of `metrics_case`).
METRIC_EDGE_CASES = (("one_prediction", TRAIN_BATCH, 128, 160, 1, "planted"),
                     ("sixteen", 2, 8, 12, 16, "planted"),
                     ("odd_7x9", 3, 7, 9, 3, "nan"))


def metrics_work(n, pixels2, pixels0):
    """(bytes, operations) of K27 over n predictions of `pixels2` level-2
    pixels and `pixels0` level-0 pixels: each prediction, GT and mask
    read once, the M float32 means and float64 (n, total) rows written
    once."""
    nbytes = 4 * (n * pixels2 + 2 * pixels2 + 3 * pixels0) + 20 * (5 + 2 * n)
    ops = (METRIC_OPS_PER_PIXEL2 + METRIC_OPS_PER_PREDICTION * n) * pixels2 \
        + METRIC_OPS_PER_PIXEL0 * pixels0
    return nbytes, ops


def metrics_case(b, h, w, n, gen, kind="planted", dev="cuda"):
    """The metrics' inputs as the training step hands them: n predictions
    [B, h, w, 1] and the upsampled depth [B, 4h, 4w, 1] (views of
    [B, 1, H, W]), GT and masks of both levels, seeded: GT 2..12, errors
    0..10, 70% of the pixels valid. `kind` "planted": image 1's level-2
    mask and image 2's level-0 mask empty (where the batch has them), and
    on image 0's first row, valid, GT 5 and errors of exactly ±1, ±2, ±4,
    ±8 at both levels, then a mask of exactly 0.5 (out) under an error of
    9, then one just above 0.5 (in); "nan": those, and on image 0's
    second row a NaN estimate of prediction 0 at a masked-out pixel, an
    infinite one of the last prediction (where n > 1) at another, and a
    NaN upsampled depth at a valid level-0 pixel; "empty": every mask
    empty."""
    u = lambda *s: torch.rand(*s, device=dev, generator=gen)
    gt2, gt0 = 2.0 + 10.0 * u(b, h, w), 2.0 + 10.0 * u(b, 4 * h, 4 * w)
    preds = [gt2 + 20.0 * u(b, h, w) - 10.0 for _ in range(n)]
    up = gt0 + 20.0 * u(b, 4 * h, 4 * w) - 10.0
    m2, m0 = (u(b, h, w) > 0.3).float(), (u(b, 4 * h, 4 * w) > 0.3).float()
    if kind == "empty":
        m2.zero_()
        m0.zero_()
    else:
        m2[1:2] = 0.0
        m0[2:3] = 0.0
        errors = torch.tensor([1.0, -1.0, 2.0, -2.0, 4.0, -4.0, 8.0, -8.0, 9.0, 9.0], device=dev)
        half = torch.tensor([0.5, 0.5, 0.5 + 2.0 ** -24], device=dev)    # float32's next
        for gt, ests, mask in ((gt2, preds, m2), (gt0, [up], m0)):
            cols = min(len(errors), gt.shape[2])
            gt[0, 0, :cols] = 5.0
            for est in ests:
                est[0, 0, :cols] = 5.0 + errors[:cols]
            mask[0, 0, :cols] = 1.0
            if gt.shape[2] >= len(errors) + 1:
                mask[0, 0, len(errors) - 2:len(errors) + 1] = half
    if kind == "nan":
        m2[0, 1, :2] = 0.0
        preds[0][0, 1, 0] = math.nan
        if n > 1:
            preds[-1][0, 1, 1] = math.inf
        m0[0, 1, 0] = 1.0
        up[0, 1, 0] = math.nan
    view = lambda x: x.unsqueeze(1).permute(0, 2, 3, 1)
    return [view(p) for p in preds], view(up), view(gt2), view(m2), view(gt0), view(m0)


def metric_errors(names, got, table, plain32, table32, plain64):
    """K27's means `got` and (n, total) rows `table` against the plain
    version's on the same float32 inputs and on float64 copies:
    {"max_ulps" of the outlier rates, "max_rel" of the mean errors
    (finite ones; where float64's is 0 the kernel's must be 0), "nan_agree",
    "counts_equal", "max_abs" against float32's}."""
    thres = [i for i, k in enumerate(names) if k.startswith("thres")]
    errs = [i for i, k in enumerate(names) if k.startswith("abs")]
    g, w = got[errs].double(), plain64[errs].double()
    finite = ~w.isnan()
    diff = (g - w).abs()[finite]
    scale = w.abs()[finite]
    rel = torch.where(scale > 0, diff / scale.clamp_min(1e-300),
                      torch.where(diff == 0, 0.0, math.inf))
    both = ~got.isnan() & ~plain32.isnan()
    return {"max_ulps": ulps_apart([got[thres]], [plain32[thres]]),
            "max_rel": rel.max().item() if rel.numel() else 0.0,
            "nan_agree": torch.equal(g.isnan(), w.isnan()),
            "counts_equal": torch.equal(table[:, 0], table32[:, 0]),
            "max_abs": (got - plain32).abs()[both].max().item()}


def host_ms(fn, reps=50):
    """The host's ms per call of `fn` (enqueue only; synced around the
    loop, not inside it)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e3 * (t1 - t0) / reps


def hold_depth_metrics(label, case, timed=False, smi=""):
    """K27 on `metrics_case`'s tensors, launched bare into outputs filled
    with NaN, against the plain version (`metric_errors` within
    METRIC_ULPS and METRIC_REL), two launches bit-equal, the wrapper's
    result equal to the bare launch's. Where `timed`: bare ms, device ms,
    bound, share, the launch floor (the same C call over one pixel and one
    prediction), the wrapper's ms, the plain version's (the eager chain the
    port ran before), and the host ms per call of the wrapper, of
    engine/metrics.py's `depth_metrics` (the step's entry) and of the
    eager chain. One JSON line; returns {"depth_metrics": record}."""
    preds, up, gt2, m2, gt0, m0 = case
    n = len(preds)
    names = metric_ops.metric_names(n - 1)
    scratch, got, table = metric_ops.metric_buffers(preds, gt0)
    run = bare_launch("depth_metrics", metric_ops.metric_args(preds, up, gt2, m2, gt0, m0,
                                                              scratch, got, table))

    def fresh():
        got.fill_(math.nan)
        table.fill_(math.nan)
        run()
        return got.clone(), table.clone()

    first = fresh()
    fresh()
    torch.cuda.synchronize()
    same = lambda a, b: torch.equal(a[0].view(torch.int32), b[0].view(torch.int32)) and \
        torch.equal(a[1].view(torch.int64), b[1].view(torch.int64))
    repeats = same(first, (got, table))
    plain32, table32 = metric_ops.depth_metrics_plain(preds, up, gt2, m2, gt0, m0)
    plain64 = metric_ops.depth_metrics_plain(*([p.double() for p in preds], up.double(),
                                               gt2.double(), m2.double(), gt0.double(),
                                               m0.double()))[0]
    errs = metric_errors(names, got, table, plain32, table32, plain64)
    wrapper_equal = same(metric_ops.depth_metrics(preds, up, gt2, m2, gt0, m0), (got, table))
    b = gt2.shape[0]
    nbytes, ops = metrics_work(n, gt2.numel(), gt0.numel())
    rec = {"bytes": nbytes, "ops": ops, "max_abs_err": errs["max_abs"],
           "max_rel_err": errs["max_rel"], "library_ms": None, "launches": 1}
    rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes, ops)
    if timed:
        one = [torch.zeros(1, 1, device="cuda") for _ in range(6)]
        floor = bare_launch("depth_metrics", metric_ops.metric_args(
            one[:1], *one[1:], *metric_ops.metric_buffers(one[:1], one[4])))
        dicts = ({"level_2": gt2, "level_0": gt0}, {"level_2": m2, "level_0": m0})
        calls = {"call": lambda: metric_ops.depth_metrics(preds, up, gt2, m2, gt0, m0),
                 "entry": lambda: engine_metrics.depth_metrics(preds, up, *dicts, n - 1),
                 "plain": lambda: metric_ops.depth_metrics_plain(preds, up, gt2, m2, gt0, m0)}
        rec.update(ms=time_ms(run, reps=100), call_ms=time_ms(calls["call"], reps=100),
                   device_ms=sum(device_us(run, phase=f"depth_metrics at {label}").values())
                   / 1e3, launch_floor_ms=time_ms(floor, reps=100),
                   launch_floor_device_ms=sum(device_us(
                       floor, phase=f"depth_metrics floor at {label}").values()) / 1e3,
                   plain_ms=time_ms(calls["plain"]), host_ms=host_ms(calls["call"]),
                   entry_host_ms=host_ms(calls["entry"]),
                   plain_host_ms=host_ms(calls["plain"], reps=20))
        rec.update(share=rec["bound_ms"] / rec["ms"],
                   device_share=rec["bound_ms"] / rec["device_ms"],
                   plain_note="depth_metrics_plain, the eager chain K27 replaced")
    line = {"kernel": "depth_metrics", "shape": label, "batch": b,
            "level2": list(gt2.shape[1:3]), "level0": list(gt0.shape[1:3]), "predictions": n,
            **rec, **{k: v for k, v in errs.items() if k != "max_abs"},
            "two_launches_bit_equal": repeats, "wrapper_equal": wrapper_equal,
            "metrics": dict(zip(names, got.tolist())),
            "tolerance": f"outlier rates {METRIC_ULPS} ulp of the float32 plain version, "
                         f"mean errors {METRIC_REL} of the float64 one, relative",
            "card": smi}
    print(json.dumps(line))
    if not (errs["max_ulps"] <= METRIC_ULPS and errs["max_rel"] <= METRIC_REL
            and errs["nan_agree"] and errs["counts_equal"] and repeats and wrapper_equal):
        raise SystemExit(f"depth_metrics at {label}: {line}")
    return {"depth_metrics": rec}


def check_depth_metrics(smi=""):
    """K27 (`hold_depth_metrics`) at the training step's metrics (batch 4,
    128x160, level 0 512x640, 5 predictions): `metrics_case`'s planted,
    NaN and empty kinds, the first timed, then METRIC_EDGE_CASES. Returns
    the timed case's per-step record."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 40)
    h, w, n = TRAIN_HEIGHT // 4, TRAIN_WIDTH // 4, 1 + TRAIN_ITERATION
    per_step = hold_depth_metrics("step_planted", metrics_case(TRAIN_BATCH, h, w, n, gen),
                                  timed=True, smi=smi)
    for kind in ("nan", "empty"):
        hold_depth_metrics(f"step_{kind}", metrics_case(TRAIN_BATCH, h, w, n, gen, kind))
    for label, b, eh, ew, en, kind in METRIC_EDGE_CASES:
        hold_depth_metrics(f"edge_{label}", metrics_case(b, eh, ew, en, gen, kind))
    print(json.dumps({"depth_metrics_totals": {"per_step": per_step}}))
    return per_step


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
# The templated kernels (one source, both dtypes), longest name first: a
# source's kernels are named `<name>_...kernel<T>`, T telling the dtype.
TEMPLATED = ("depth_readout_grad", "depth_readout", "sweep_taps", "convex_upsample_grad",
             "convex_upsample", "gru_update_grad", "gru_reset_grad", "gru_update", "gru_reset",
             "bn_act_grad", "bn_act", "upsample2x_grad", "upsample2x_add", "bn_stats_grad",
             "bn_stats", "resize_bilinear_grad", "resize_bilinear")
# The float32-only kernels, longest name first (K11's is a prefix of K12's,
# K23's of K24's): a source's kernels are named `<name>_...kernel`. They
# are named before the library's categories ("clip_adam" holds "adam").
F32_ONLY = ("view_aggregate_grad", "view_aggregate", "full_loss_grad", "full_loss",
            "grad_norm", "clip_adam", "depth_metrics")
# Device kernels per counted launch of each kernel (1 where not named): the
# launchers that run a second kernel (a fold, K5 bf16's rounding pass);
# K25's first kernel and K26 run once per table of MAX_TENSORS tensors,
# and the training model's 100 parameters make one.
KERNELS_PER_LAUNCH = {"sweep_grad_src_bf16": 2, "convex_upsample_grad": 2,
                      "convex_upsample_grad_bf16": 2, "bn_act_grad": 2, "bn_act_grad_bf16": 2,
                      "bn_stats": 2, "bn_stats_bf16": 2, "full_loss": 2, "grad_norm": 2,
                      "depth_metrics": 2}
# cuDNN's layout transposes (the bf16 path keeps NCHW storage, its kernels
# run NHWC) and the names of its convolution kernels that hold none of
# the usual words: the FFT algorithm's transforms, and anything in its
# namespaces.
CONV_LAYOUT = ("nchwToNhwc", "nhwcToNchw")
CUDNN_CONV = ("cudnn", "fft2d_", "fft1d_", "region_transform", "conv", "xmma", "gemm",
              "wgrad", "dgrad")


def planned_counts(**launches):
    """`launches` for the named kernels, 0 for every other."""
    return {k: launches.get(k, 0) for k in KERNEL_NAMES}


def planned_map_counts(shapes, dtype, maps=1, iteration=ITERATION, features=None):
    """Launches of each kernel over `maps` depth maps at `shapes` in
    `dtype`: the forward sweep kernels once per chunk, K6 once per
    prediction (1 + iteration), K8 once per sweep (1 + iteration), K9
    once, K11 (float32 in both precisions) once per aggregation: the
    init sweep's and each iteration's 3 levels', 1 + 3·iteration, K13 and
    K14 once per GRU call, iteration, K28 once per resize (`RESIZE_SITES`:
    2 in float32, 3 in `dtype`), and K17 13 times and K19 twice per
    FeatureNet call (`BN_CALLS`, `FPN_CALLS`): `features` calls, by
    default one per map (a forward's views in one call, or the feature
    cache's one new image per map)."""
    forward = sum(s[-1] for s in shapes) * maps
    features = maps if features is None else features
    plan = planned_counts(view_aggregate=(1 + len(LEVELS) * iteration) * maps,
                          **{kernel_name(k, dtype): n for k, n in (
        ("sweep_premul", forward), ("corr_epilogue", forward),
        ("depth_readout", (1 + iteration) * maps), ("sweep_taps", (1 + iteration) * maps),
        ("convex_upsample", maps), ("gru_reset", iteration * maps),
        ("gru_update", iteration * maps), ("bn_act", len(BN_CALLS) * features),
        ("upsample2x_add", len(FPN_CALLS) * features))})
    return add_resize_counts(plan, dtype, maps, train=False)


def add_resize_counts(plan, dtype, times, train):
    """`plan` with K28's launches (and, `train`, K29's) over `times` maps
    or training steps added, in float32 or `dtype` as each site of
    `RESIZE_SITES` runs."""
    for _, _, _, _, compute, _, train_only, grad in RESIZE_SITES:
        if train_only and not train:
            continue
        dt = dtype if compute else torch.float32
        plan[kernel_name("resize_bilinear", dt)] += times
        if train and grad:
            plan[kernel_name("resize_bilinear_grad", dt)] += times
    return plan


def _category(name):
    """A device event's kind: a hand-written kernel's report name, or
    "memcpy", "conv_layout", "batch_norm", "convolution", "optimizer",
    and "other" for every other (eager PyTorch) kernel."""
    if "round_to_bf16" in name:           # sweep_grad_src_bf16's rounding pass
        return "sweep_grad_src_bf16"
    for k in TEMPLATED:
        if f"::{k}_" in name and "kernel<" in name:
            return f"{k}_bf16" if "kernel<__nv_bfloat16" in name else k
    for k in F32_ONLY:
        if f"::{k}_" in name and "kernel" in name:
            return k
    for fn in SWEEP_KERNELS:
        if f"{fn.__name__}_bf16" in name:
            return f"{fn.__name__}_bf16"
    for fn in SWEEP_KERNELS:
        if fn.__name__ in name:
            return fn.__name__
    if "Memcpy" in name or "Memset" in name:
        return "memcpy"
    if any(s in name for s in CONV_LAYOUT):
        return "conv_layout"
    if "bn_" in name or "batch_norm" in name:
        return "batch_norm"
    if any(s in name for s in CUDNN_CONV):
        return "convolution"
    if any(s in name for s in ("multi_tensor", "foreach", "adam", "Adam")):
        return "optimizer"
    return "other"


# The profiler loses the first few device events of a capture (on the
# card: none in a process's first captures, then 1 to 5 over its next
# twenty, always the earliest: a training step's first kernel, its first
# convolution and K21's first pair). So each capture starts with
# PROFILE_PRIMERS spin kernels (`torch.cuda._sleep`), which take that
# loss, and their events are left out of what it returns.
PROFILE_PRIMERS = 64
PRIMER_KERNEL = "spin_kernel"


def trace_events(fn):
    """Run `fn` under torch.profiler (host and device); its events, the
    primers' device events left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_PRIMERS):
            torch.cuda._sleep(100)
        fn()
        torch.cuda.synchronize()
    return [e for e in prof.events()
            if not (e.device_type == DeviceType.CUDA and PRIMER_KERNEL in e.name)]


def _annotations(events):
    """Names of the record_function ranges among `events`. The profiler
    also lays each range out on the device as an event of that name; it
    spans the range's kernels and is no work of its own."""
    return {e.name for e in events if e.is_user_annotation}


def device_summary(events):
    """({kernel name: (calls, us)}, {category: us}, busy ms) of the device
    events (kernels and copies) among `events`."""
    from torch.autograd import DeviceType

    ranges = _annotations(events)
    by_name, by_cat = {}, {}
    for e in events:
        if e.device_type != DeviceType.CUDA or e.name in ranges:
            continue
        us = e.time_range.elapsed_us()
        calls, total = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (calls + 1, total + us)
        cat = _category(e.name)
        by_cat[cat] = by_cat.get(cat, 0.0) + us
    return by_name, by_cat, sum(by_cat.values()) / 1e3


def device_time(fn):
    """Run `fn` under torch.profiler: ({kernel name: (calls, us)},
    {category: us}, busy ms) of the device events (kernels and copies)."""
    return device_summary(trace_events(fn))


# The chains that the model runs under record_function labels
# (models/itermvs.py, models/blocks.py): K6, K8, K9 and K11, one launch
# per call each, K13 and K14 under `conv_gru`, two per GRU call, K17
# under `bn_act`, one per BN epilogue, K19 under `fpn_add`, one per FPN
# add, and in training K21 under `bn_stats`, one per BN (its sum and
# its fold: two kernels), the loss's forward under `full_loss`
# (models/losses.py: K23's two kernels and the few ops on its sums), the
# optimizer update under `clip_adam` (engine/train_loop.py: K25's two
# kernels and K26's one) and the metrics under `depth_metrics`
# (engine/train_loop.py: K27's two kernels; in a process group also the
# table's all-reduce and its clamp, div and cast), and K28 under `resize`
# (models/itermvs.py: one per bilinear resize, 5 per map, 6 per training
# step).
CHAINS = ("depth_readout", "fused_sweep_taps", "convex_upsample", "view_aggregate",
          "conv_gru", "bn_act", "fpn_add", "bn_stats", "full_loss", "clip_adam",
          "depth_metrics", "resize")


def label_kernels(events):
    """{label: [(kernel name, µs)]} of each of CHAINS: the kernels (copies
    aside) that ran inside the label's device-side ranges. One stream
    runs the model, so a range holds exactly the kernels launched inside
    it."""
    from torch.autograd import DeviceType

    ranges = _annotations(events)
    spans = {k: [] for k in CHAINS}
    kernels = []
    for e in events:
        if e.device_type != DeviceType.CUDA:
            continue
        if e.name in spans:
            spans[e.name].append((e.time_range.start, e.time_range.end))
        elif e.name not in ranges and _category(e.name) != "memcpy":
            kernels.append((e.name, e.time_range.start, e.time_range.end))
    return {label: [(name, t1 - t0) for name, t0, t1 in kernels
                    if any(a <= t0 and t1 <= b for a, b in windows)]
            for label, windows in spans.items()}


def chain_time(events):
    """{label: {"device_ms", "launches"}} of each of CHAINS
    (`label_kernels`)."""
    return {label: {"device_ms": sum(us for _, us in inside) / 1e3, "launches": len(inside)}
            for label, inside in label_kernels(events).items()}


def chain_bound_ms(width, height, views, iteration, batch=1, itemsize=4, train=False):
    """{label: ms} of CHAINS' forward over one map (or one training step's
    forward): each input read once and each output written once, over
    PEAK_BYTES_PER_S. depth_readout (1 + iteration calls) reads the
    256-bin logits in the compute dtype and writes the depth, and in
    training the probability the loss reads; fused_sweep_taps (one call
    per sweep) reads the depth samples and writes the int32 base index
    and 4 taps in the table dtype per (source, sample, pixel);
    convex_upsample reads the 144 mask logits and the coarse depth and
    writes the full-resolution depth; view_aggregate (the init sweep's
    call and 3 per iteration) reads each source's float32 correlation
    and weights and writes the aggregate; conv_gru (one GRU call per
    iteration) is K13 and K14 (`gru_work`); bn_act is K17's 13 launches
    per image (`bn_image_bytes`) and fpn_add K19's 2 (`up2_image_bytes`),
    over one image per map (the feature cache extracts each image once)
    or the step's batch·views images; bn_stats, in training only, K21's
    one read of each of the step's images' 16 BN inputs
    (`bn_stats_image_bytes`); full_loss, in training only, K23's
    (`loss_work` of stage 2: each of the 1 + iteration probabilities
    read once); clip_adam, in training only, the update's g, p, m, v read
    and p, m, v written once over the model's parameters (`update_work`);
    depth_metrics, in training only, K27's (`metrics_work`: each
    prediction, GT and mask read once); resize K28's (`resize_bytes`: each
    site's input read and output written once, 5 per map, 6 per training
    forward). Their operations per byte are far below the card's, so
    bytes bound all twelve."""
    p4 = batch * (height // 4) * (width // 4)
    p8 = batch * (height // 8) * (width // 8)
    sources = views - 1
    readout = p4 * (256 * itemsize + 4 + (256 * 4 if train else 0))
    taps = lambda n, p: n * p * 4 + sources * n * p * (4 + 4 * itemsize)
    upsample = p4 * (144 * itemsize + 4) + 16 * p4 * 4
    aggregate = lambda n, p: 4 * ((sources + 1) * n * GROUPS * p + sources * p)
    nbytes = {"depth_readout": (1 + iteration) * readout,
              "fused_sweep_taps": taps(NUM_INIT_SAMPLES, p8)
              + iteration * taps(sum(len(v) for v in CORR_INTERVALS.values()), p4),
              "convex_upsample": upsample,
              "view_aggregate": aggregate(NUM_INIT_SAMPLES, p8) + iteration * sum(
                  aggregate(len(CORR_INTERVALS[k]), p4) for k in LEVELS),
              "conv_gru": iteration * sum(gru_work(k, 1, p4, itemsize)[0]
                                          for k in ("gru_reset", "gru_update")),
              "bn_act": (batch * views if train else batch)
              * bn_image_bytes(width, height, itemsize),
              "fpn_add": (batch * views if train else batch)
              * up2_image_bytes(width, height, itemsize),
              "bn_stats": batch * views * bn_stats_image_bytes(width, height, itemsize)
              if train else 0,
              "full_loss": loss_work(1 + iteration, p4, batch * height * width, True)[0]
              if train else 0,
              "clip_adam": update_work(sum(math.prod(s) for s in model_param_shapes()),
                                       "clip_adam")[0] if train else 0,
              "depth_metrics": metrics_work(1 + iteration, p4, batch * height * width)[0]
              if train else 0,
              "resize": resize_bytes(width, height, views, batch,
                                     BF16 if itemsize == 2 else torch.float32, train)}
    return {k: 1e3 * v / PEAK_BYTES_PER_S for k, v in nbytes.items()}


def profile_maps(model, samples, outdir, unprofiled_wall):
    """Device time by kernel over the same maps as the timed run
    (torch.profiler, kernel and copy events only), the kernels launched
    per map, and the labelled chains' device time and launches per map
    beside their byte bounds. The capture is held against the maps'
    launch plan (`device_capture`: retaken where short, raising after
    PLAN_CAPTURES) and must hold no op of the eager resizes K28 replaced
    (`resize_op_events`). The idle share is taken against the timed
    run's own wall time, since tracing slows the host."""
    maps = len(samples)
    itemsize = torch.finfo(model.compute_dtype).bits // 8
    planned = planned_map_counts(sweep_shapes(WIDTH, HEIGHT, VIEWS, ITERATION,
                                              itemsize=itemsize), model.compute_dtype, maps)
    by_name, by_cat, busy_ms, events = device_capture(
        lambda: run_depth(model, samples, outdir, "cuda", log=lambda *_: None),
        f"profile_maps {model.compute_dtype}", planned)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    kernels = sum(c for k, (c, _) in by_name.items() if _category(k) != "memcpy")
    bounds = chain_bound_ms(WIDTH, HEIGHT, VIEWS, ITERATION, itemsize=itemsize)
    print(json.dumps({
        "profile_maps": maps, "dtype": str(model.compute_dtype),
        "device_busy_ms_per_map": busy_ms / maps,
        "wall_ms_per_map_unprofiled": unprofiled_wall * 1e3 / maps,
        "device_idle_share": max(0.0, 1 - busy_ms / (unprofiled_wall * 1e3)),
        "kernels_per_map": kernels / maps,
        "hand_written_kernels": {k: n for k, n in plan_counts(by_name).items() if n},
        "chains_per_map": {k: {"device_ms": v["device_ms"] / maps,
                               "launches": v["launches"] / maps,
                               "bound_ms": bounds[k]}
                           for k, v in chain_time(events).items()},
        "by_category_ms_per_map": {k: v / 1e3 / maps for k, v in
                                   sorted(by_cat.items(), key=lambda kv: -kv[1])},
        "top_ms_per_map": [{"name": k[:90], "calls_per_map": c / maps,
                            "device_ms": t / 1e3 / maps} for k, (c, t) in top],
        "eager_resize_events": resize_op_events(events)}))
    if resize_op_events(events):
        raise SystemExit(f"profile_maps {model.compute_dtype}: the eager resizes ran: "
                         f"{resize_op_events(events)}")


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


def planned_step_counts(shapes, dtype, iteration=TRAIN_ITERATION):
    """Launches of each kernel in one training step at `shapes` (the
    kernels of `dtype`: one forward sweep pair per chunk, one backward
    pair per sweep; K6, K7 and K8 once per prediction or sweep, 1 +
    iteration; K9 and K10 once; K11 and K12, float32 in both precisions,
    once per aggregation, 1 + 3·iteration; K13-K16 once per GRU call,
    iteration; K17, K18 and K22 13 times, K21 once per BN (16) and K19
    and K20 twice, FeatureNet's one call over the batch's views; K23 and
    K24, float32 in both precisions, once; the update's K25 and K26 and
    the metrics' K27, float32 in both precisions, once; K28 6 times, 3 in
    float32, and K29 4 times, 1 in float32, `add_resize_counts`)."""
    forward = sum(s[-1] for s in shapes)
    sweeps = sum(sweeps_of(shapes, dtype).values())
    aggregations = 1 + len(LEVELS) * iteration
    plan = planned_counts(view_aggregate=aggregations, view_aggregate_grad=aggregations,
                          full_loss=1, full_loss_grad=1, grad_norm=1, clip_adam=1,
                          depth_metrics=1,
                          **{kernel_name(k, dtype): n for k, n in (
        ("sweep_premul", forward), ("corr_epilogue", forward), ("sweep_grad_ref", sweeps),
        ("sweep_grad_src", sweeps), ("depth_readout", 1 + iteration),
        ("depth_readout_grad", 1 + iteration), ("sweep_taps", 1 + iteration),
        ("convex_upsample", 1), ("convex_upsample_grad", 1), ("gru_reset", iteration),
        ("gru_update", iteration), ("gru_update_grad", iteration),
        ("gru_reset_grad", iteration), ("bn_act", len(BN_CALLS)),
        ("bn_act_grad", len(BN_CALLS)), ("upsample2x_add", len(FPN_CALLS)),
        ("upsample2x_grad", len(FPN_CALLS)), ("bn_stats", len(BN_INPUTS)),
        ("bn_stats_grad", len(BN_CALLS)))})
    return add_resize_counts(plan, dtype, 1, train=True)


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
    out = [tuple(r) for r in captured]
    # Capture's class is a reference cycle that holds `captured` until the
    # garbage collector runs: emptied here, the sweeps go with `out`, not
    # into the peak memory of whatever runs next.
    captured.clear()
    return out


def prob_grad_layouts(model, batch):
    """The layout of each probability gradient that reaches K7 in one
    stage-2 training forward and backward of `model` on the device batch
    `batch` (no optimizer step; the gradients are cleared after), in call
    order: "dense" or "channels-last" (what K7 reads in place,
    `prob_grad_strides`) with its strides, or "other" (copied).
    `DepthReadout.backward` is wrapped for this call only."""
    seen = []
    backward = DepthReadout.backward

    def capture(ctx, d_depth, d_prob):
        strides = None if d_prob is None else prob_grad_strides(d_prob)
        seen.append({"layout": "none" if d_prob is None else "other" if strides is None
                     else "dense" if strides[2] == 1 else "channels-last",
                     "strides": None if d_prob is None else list(d_prob.stride())})
        return backward(ctx, d_depth, d_prob)

    model.train()
    DepthReadout.backward = staticmethod(capture)
    try:
        loss, _ = forward_loss(model, batch, True)
        loss.backward()
    finally:
        DepthReadout.backward = staticmethod(backward)
    model.zero_grad(set_to_none=True)
    return seen


def fpn_grad_layouts(model, batch):
    """The layout of each ∂out that reaches K20 in one stage-2 training
    forward and backward of `model` on the device batch `batch` (no
    optimizer step; the gradients are cleared after), in call order:
    "dense" (what K20 reads), "channels-last" or "other" (each copied
    once), with its shape and strides. `Upsample2xAdd.backward` is
    wrapped for this call only."""
    seen = []
    backward = resize_ops.Upsample2xAdd.backward

    def capture(ctx, grad):
        layout = ("dense" if grad.is_contiguous() else "channels-last"
                  if grad.is_contiguous(memory_format=torch.channels_last) else "other")
        seen.append({"layout": layout, "shape": list(grad.shape),
                     "strides": list(grad.stride())})
        return backward(ctx, grad)

    model.train()
    resize_ops.Upsample2xAdd.backward = staticmethod(capture)
    try:
        loss, _ = forward_loss(model, batch, True)
        loss.backward()
    finally:
        resize_ops.Upsample2xAdd.backward = staticmethod(backward)
    model.zero_grad(set_to_none=True)
    return seen


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


def var_mean_events(events):
    """{name: calls} of the host ops and device kernels among `events` that
    belong to torch.var_mean or its backward (BatchNorm's statistics
    before K21 and K22: `aten::var_mean`, autograd's `VarMeanBackward0`,
    the Welford reduction kernels)."""
    found = {}
    for e in events:
        if "var_mean" in e.name or "VarMean" in e.name or "Welford" in e.name:
            found[e.name[:90]] = found.get(e.name[:90], 0) + 1
    return found


def loss_op_events(events):
    """{name: calls} of the host ops and device kernels among `events` that
    belong to the eager loss K23 and K24 replaced: any name holding
    "gather" or "argmax" (`aten::gather`, autograd's `GatherBackward0` and
    `aten::gather_backward`, `aten::argmax` and their kernels); the step
    has no other gather or argmax on the card."""
    found = {}
    for e in events:
        if "gather" in e.name.lower() or "argmax" in e.name.lower():
            found[e.name[:90]] = found.get(e.name[:90], 0) + 1
    return found


def update_op_events(events):
    """{name: calls} of the device kernels among `events` that belong to
    the eager update K25 and K26 replaced: any kernel inside the
    `clip_adam` label that is not theirs (the clip's norms, divides,
    wheres and copies), and any foreach (`multi_tensor_apply`) kernel
    anywhere, which only torch.optim.Adam ran in the step."""
    from torch.autograd import DeviceType

    names = [n for n, _ in label_kernels(events)["clip_adam"]
             if _category(n) not in ("grad_norm", "clip_adam")]
    names += [e.name for e in events if e.device_type == DeviceType.CUDA
              and ("multi_tensor" in e.name or "foreach" in e.name)]
    found = {}
    for name in names:
        found[name[:90]] = found.get(name[:90], 0) + 1
    return found


def metric_op_events(events):
    """{name: calls} of the device kernels inside the `depth_metrics` label
    that are not K27's: the eager metrics' compares, wheres, clamps,
    casts and sums it replaced. In a process group the table's
    all-reduce, clamp, div and cast run there too, so only a step outside
    one is held to none."""
    found = {}
    for name, _ in label_kernels(events)["depth_metrics"]:
        if _category(name) != "depth_metrics":
            found[name[:90]] = found.get(name[:90], 0) + 1
    return found


def hold_loss_path(name, copies, readout_copies, layouts, events):
    """The loss's gates of a training phase: K23's wrapper copied no
    input, K7's no probability gradient, every probability gradient
    reached K7 dense NCHW (as K24 writes it), and the profiled step ran
    no op of the eager loss (`loss_op_events`). SystemExit on a miss."""
    if copies or readout_copies:
        raise SystemExit(f"{name}: K23 copied {copies} loss inputs, K7 {readout_copies} "
                         f"probability gradients")
    if layouts is not None and any(r["layout"] != "dense" for r in layouts):
        raise SystemExit(f"{name}: K7 got a probability gradient that is not dense: {layouts}")
    if events:
        raise SystemExit(f"{name}: the eager loss ran in the profiled step: {events}")


def train_full_width(shapes, dtype=torch.float32, synthetic_ms=None):
    """The training path at full width (see TRAIN_*) in `dtype`:
    TRAIN_STEPS steps on one batch from a fresh seeded init; the loss must
    be finite and fall and each sweep kernel of `dtype` launch 52 times
    per step. Then one profiled step, held against the step's launch
    plan (`device_capture`) and free of the eager update
    (`update_op_events`, "optimizer" 0), of the eager metrics
    (`metric_op_events`) and of the eager resizes (`resize_op_events`;
    K29's copies of a ∂out that is not contiguous are counted per step), a
    validation step, a checkpoint
    round trip on the card (the model and the Adam state K25 and K26
    keep, bit for bit) and `check_real_sweeps` on one more step's sweeps
    (`synthetic_ms`: the `sweep_inputs` times printed beside). Returns
    (launch counts of the timed steps, record)."""
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
    copies = depth_readout_grad.copies
    up2_copies = resize_ops.upsample2x_grad.copies
    resize_copies = resize_ops.resize_grad.copies
    loss_copies = full_loss_ops.full_loss_terms.copies
    peak = torch.cuda.max_memory_allocated()
    planned = {k: n * TRAIN_STEPS for k, n in planned_step_counts(shapes, dtype).items()}
    last = step_s[-5:]
    rec = {"size": [TRAIN_WIDTH, TRAIN_HEIGHT], "batch": TRAIN_BATCH, "views": TRAIN_VIEWS,
           "iteration": TRAIN_ITERATION, "dtype": str(dtype), "regress": True,
           "steps": TRAIN_STEPS,
           "losses": losses, "step_s": step_s, "ms_per_step_last5": 1e3 * sum(last) / len(last),
           "steps_per_s_last5": len(last) / sum(last), "peak_mem_gib": peak / 2 ** 30,
           "batch_setup_s": setup_s, "launches": counts, "planned_launches": planned,
           "depth_readout_grad_copies": copies, "upsample2x_grad_copies": up2_copies,
           "full_loss_copies": loss_copies, "resize_grad_copies_per_step":
           resize_copies / TRAIN_STEPS}

    by_name, by_cat, busy_ms, events = device_capture(
        lambda: train_step(model, optimizer, batch, TRAIN_LR, True, TRAIN_ITERATION),
        f"train_full_width {dtype}", planned_step_counts(shapes, dtype))
    rec["var_mean_events"] = var_mean_events(events)
    rec["eager_loss_events"] = loss_op_events(events)
    rec["eager_update_events"] = update_op_events(events)
    rec["eager_metric_events"] = metric_op_events(events)
    rec["eager_resize_events"] = resize_op_events(events)
    wall_ms = 1e3 * sorted(last)[len(last) // 2]
    bounds = chain_bound_ms(TRAIN_WIDTH, TRAIN_HEIGHT, TRAIN_VIEWS, TRAIN_ITERATION,
                            TRAIN_BATCH, torch.finfo(dtype).bits // 8, train=True)
    rec["profile_step"] = {
        "device_busy_ms": busy_ms, "wall_ms_unprofiled_median": wall_ms,
        "device_idle_share": max(0.0, 1 - busy_ms / wall_ms),
        "kernels": sum(c for k, (c, _) in by_name.items() if _category(k) != "memcpy"),
        # Each hand-written kernel's device kernels in the capture (two per
        # launch where KERNELS_PER_LAUNCH says so), held against the plan.
        "hand_written_kernels": {k: n for k, n in plan_counts(by_name).items() if n},
        "chains_forward": {k: dict(v, bound_ms=bounds[k])
                           for k, v in chain_time(events).items()},
        "by_category_ms": {k: v / 1e3 for k, v in
                           sorted(by_cat.items(), key=lambda kv: -kv[1])},
        "top_ms": [{"name": k[:90], "calls": c, "device_ms": t / 1e3} for k, (c, t)
                   in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]]}

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
    if rec["var_mean_events"]:
        raise SystemExit(f"var_mean ran in the training step: {rec['var_mean_events']}")
    if rec["eager_update_events"] or rec["profile_step"]["by_category_ms"].get("optimizer"):
        raise SystemExit(f"the eager update ran in the training step: "
                         f"{rec['eager_update_events']}, "
                         f"{rec['profile_step']['by_category_ms'].get('optimizer')} ms")
    if rec["eager_metric_events"]:
        raise SystemExit(f"the eager metrics ran in the training step: "
                         f"{rec['eager_metric_events']}")
    if rec["eager_resize_events"]:
        raise SystemExit(f"the eager resizes ran in the training step: "
                         f"{rec['eager_resize_events']}")
    if copies != 0:
        raise SystemExit(f"K7's wrapper copied the probability's gradient {copies} times")
    if up2_copies != 0:
        raise SystemExit(f"K20's wrapper copied the FPN's gradient {up2_copies} times")
    if not all(np.isfinite(list(val.values()))):
        raise SystemExit(f"validation step not finite: {val}")
    if position != (0, TRAIN_STEPS) or not (same_model and same_opt):
        raise SystemExit(f"checkpoint round trip failed: {rec['checkpoint']}")

    # The layouts in which K24 hands K7 the probability's gradient.
    rec["k7_prob_grad_layouts"] = prob_grad_layouts(model, batch)
    print(json.dumps({"k7_prob_grad_layouts": rec["k7_prob_grad_layouts"],
                      "dtype": str(dtype)}))
    hold_loss_path(f"train_full_width {dtype}", loss_copies, copies,
                   rec["k7_prob_grad_layouts"], rec["eager_loss_events"])
    # The layouts in which K20 gets the FPN adds' ∂out.
    rec["k20_grad_layouts"] = fpn_grad_layouts(model, batch)
    print(json.dumps({"k20_grad_layouts": rec["k20_grad_layouts"], "dtype": str(dtype)}))

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


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_steps(job, rank=0, world=1, device="cuda"):
    """The training runs of `job` on this rank's consecutive slice of its
    global batch (the whole batch at world 1), each from the job's
    `state` (rank 0's, broadcast in a process group) with a new Adam;
    `job["val"]` adds one val step of the first run's model before its
    steps, `job["profile"]` one more step of each run under
    torch.profiler after them (busy ms, ms by kind, `var_mean_events`,
    `loss_op_events` and `metric_op_events`), then `prob_grad_layouts`.
    Records per step: the loss, ms (host clock to a sync), the launch
    counts, K7's and K23's copies, the metrics' all-reduces, the
    state_dict and the gradients after the step (on the host); of the
    val step its scalars and its metrics' all-reduces."""
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
            reduces = engine_metrics.depth_metrics.all_reduces
            out["val"] = {k: float(v) for k, v in
                          val_step(model, batch, True, job["iteration"]).items()}
            out["val_metric_all_reduces"] = engine_metrics.depth_metrics.all_reduces - reduces
        steps = []
        for _ in range(run["steps"]):
            _sync(device)
            reset_launch_counts()
            reduces = engine_metrics.depth_metrics.all_reduces
            t0 = time.perf_counter()
            loss = train_step(model, optimizer, batch, job["lr"], run["regress"],
                              job["iteration"])["loss"].item()
            _sync(device)
            steps.append({"loss": loss, "ms": 1e3 * (time.perf_counter() - t0),
                          "launches": launch_counts(),
                          "copies": depth_readout_grad.copies,
                          "loss_copies": full_loss_ops.full_loss_terms.copies,
                          "metric_all_reduces":
                              engine_metrics.depth_metrics.all_reduces - reduces,
                          "state": {k: v.detach().cpu().clone()
                                    for k, v in model.state_dict().items()},
                          "grads": {k: p.grad.detach().cpu().clone()
                                    for k, p in model.named_parameters()}})
        out["runs"].append(steps)
        if job.get("profile"):
            events = trace_events(lambda: train_step(
                model, optimizer, batch, job["lr"], run["regress"], job["iteration"]))
            _, by_cat, busy = device_summary(events)
            out["profile"] = {"device_busy_ms": busy, "by_category_ms": {
                k: v / 1e3 for k, v in sorted(by_cat.items(), key=lambda kv: -kv[1])},
                "var_mean_events": var_mean_events(events),
                "eager_loss_events": loss_op_events(events),
                "eager_metric_events": metric_op_events(events),
                "prob_grad_layouts": prob_grad_layouts(model, batch)}
    return out


def ddp_rank(rank, world, port, backend, device, job_path, work="run_steps"):
    """One rank of `run_ranks`, in a process of its own: joins the group
    through torchrun's variables (every rank on `device`), runs `work`
    (this module's `run_steps` or `eval_rank`) and saves its records
    beside the job file."""
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK="0")
    job = torch.load(job_path, weights_only=True)
    mesh.initialize_distributed("on", backend=backend, device=device)
    try:
        out = {"run_steps": run_steps, "eval_rank": eval_rank}[work](
            job, int(rank), int(world), device)
    finally:
        torch.distributed.destroy_process_group()
    torch.save(out, f"{job_path}.rank{rank}")


def run_ranks(job, world, backend, device, timeout=900, env=None, work="run_steps"):
    """`work` (`run_steps` or `eval_rank`) of `job` on `world` ranks, each a
    Python process of its own (`ddp_rank`) on `device`, joined over
    `backend` on localhost. Returns each rank's records; a rank that fails
    stops all and raises with its output."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "job.pt")
        torch.save(job, path)
        try:
            launch.run_ranks("chip_smoke", "ddp_rank", (backend, device, path, work), world,
                             timeout, env=env)
        except launch.RankFailed as e:
            raise SystemExit(f"{backend} {e}") from None
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
    finite losses, `planned` launches per rank per step, one all-reduce
    of the metrics per rank per step, no copy in K7's or K23's wrapper
    and, where a rank profiled a step, `hold_loss_path`'s gates. Prints
    one JSON line (with `extra`); SystemExit on a miss."""
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
           "depth_readout_grad_copies": [[s["copies"] for s in r] for r in steps],
           "full_loss_copies": [[s["loss_copies"] for s in r] for r in steps],
           "metric_all_reduces": [[s["metric_all_reduces"] for s in r] for r in steps],
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
    if any(s["copies"] for r in steps for s in r):
        raise SystemExit(f"{name}: K7's wrapper copied the probability's gradient")
    if any(s["metric_all_reduces"] != 1 for r in steps for s in r):
        raise SystemExit(f"{name}: the metrics' all-reduces per rank per step != 1")
    for r in ranks:
        profile = r.get("profile") or {}
        hold_loss_path(name, sum(s["loss_copies"] for s in r["runs"][0]), 0,
                       profile.get("prob_grad_layouts"), profile.get("eager_loss_events"))
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
    ranks = run_ranks(dict(job, profile=True), DDP_WORLD, "gloo", "cuda:0")
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
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(launch.free_port()), RANK="0",
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
        if any(s["launches"] != planned or s["copies"] for s in plain["runs"][0]):
            raise SystemExit(f"train_ddp_nccl: plain launches per step != {planned}, or "
                             f"K7's wrapper copied the probability's gradient")
        hold_loss_path("train_ddp_nccl plain", sum(s["loss_copies"] for s in plain["runs"][0]),
                       0, plain["profile"]["prob_grad_layouts"],
                       plain["profile"]["eager_loss_events"])
        if plain["profile"]["eager_metric_events"]:
            raise SystemExit(f"train_ddp_nccl: the eager metrics ran in the plain step: "
                             f"{plain['profile']['eager_metric_events']}")
        if any(r["profile"]["var_mean_events"] for r in (plain, synced)):
            raise SystemExit(f"train_ddp_nccl: var_mean ran in a profiled step: "
                             f"{[r['profile']['var_mean_events'] for r in (plain, synced)]}")
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


# ---------------------------------------------------------- entry points
# entry_dryrun: `entry()`'s forward (128x160, 5 views, 4 iterations, a
# fresh seed-0 init) on the card against the same call on the CPU (the
# plain versions): the median relative depth difference, and the share
# of pixels beyond ENTRY_FAR. Fresh weights can leave two of the 256
# depth bins nearly tied behind a coarse pixel, which moves a patch of
# the upsampled map, so the share and the largest patch are printed.
ENTRY_MEDIAN_REL, ENTRY_FAR, ENTRY_FAR_SHARE = 1e-4, 1e-3, 0.01
ENTRY_WIDTH, ENTRY_HEIGHT, ENTRY_VIEWS = 160, 128, 5
# dryrun_multichip's ranks: two gloo processes sharing the one card.
DRYRUN_WORLD = 2


def largest_patch(bad):
    """(pixels, [y0, y1, x0, x1]) of the largest 8-connected patch of the
    2-D mask `bad`; (0, None) where it is empty."""
    from scipy import ndimage

    labels, n = ndimage.label(bad, structure=np.ones((3, 3)))
    if n == 0:
        return 0, None
    sizes = np.bincount(labels.ravel())[1:]
    ys, xs = np.nonzero(labels == int(np.argmax(sizes)) + 1)
    return int(sizes.max()), [int(ys.min()), int(ys.max()), int(xs.min()), int(xs.max())]


def hold_entry(got, want, counts, planned, extra=None):
    """`entry()`'s (depth, confidence) on the card against the CPU's: all
    [1, ENTRY_HEIGHT, ENTRY_WIDTH, 1], the card's finite, the median relative
    depth difference within ENTRY_MEDIAN_REL and fewer than
    ENTRY_FAR_SHARE of the pixels beyond ENTRY_FAR, and the call's
    launches as `planned`. Prints one JSON line; SystemExit on a miss."""
    shapes = [list(t.shape) for t in (*got, *want)]
    if shapes != [[1, ENTRY_HEIGHT, ENTRY_WIDTH, 1]] * 4:
        raise SystemExit(f"entry: outputs of another shape: {shapes}")
    (d, c), (wd, wc) = ([t.detach().cpu().double().numpy() for t in pair]
                        for pair in (got, want))
    rel = np.abs(d - wd) / np.abs(wd)
    far = rel[0, ..., 0] > ENTRY_FAR
    pixels, box = largest_patch(far)
    rec = {"finite": bool(np.isfinite(d).all() and np.isfinite(c).all()),
           "median_rel_depth": float(np.median(rel)), "max_rel_depth": float(rel.max()),
           "share_beyond_1e-3": float(far.mean()), "largest_patch_pixels": pixels,
           "largest_patch_box_y0_y1_x0_x1": box,
           "max_abs_conf": float(np.abs(c - wc).max()),
           "launches": {k: n for k, n in counts.items() if n},
           "planned": {k: n for k, n in planned.items() if n}, **(extra or {})}
    print(json.dumps({"entry": rec}))
    if not rec["finite"]:
        raise SystemExit(f"entry: outputs not finite: {rec}")
    if not (rec["median_rel_depth"] <= ENTRY_MEDIAN_REL
            and rec["share_beyond_1e-3"] < ENTRY_FAR_SHARE):
        raise SystemExit(f"entry: the card's depth disagrees with the CPU's: {rec}")
    if counts != planned:
        raise SystemExit(f"entry: launches {counts} != planned {planned}")
    return rec


def hold_dryrun(rec, planned, single_loss, extra=None):
    """`dryrun_multichip`'s record: the restored model and optimizer
    bit-equal to the live ones, the restored step's loss within
    RESUME_REL of the live one's, the ranks bit-equal after it, every
    rank's launches in every step as `planned`, and the first step's loss
    within DDP_LOSS_REL of `single_loss`, one process's step over the
    whole batch from the same init. Prints one JSON line; SystemExit on
    a miss."""
    rel = abs(rec["live"] - rec["restored"]) / max(1.0, abs(rec["live"]))
    out = {**{k: v for k, v in rec.items() if k != "launches"}, "resume_rel": rel,
           "single_process_loss": single_loss,
           "loss_rel": abs(rec["loss"] - single_loss) / abs(single_loss),
           "launches_per_rank_per_step": [[{k: n for k, n in step.items() if n}
                                           for step in rank] for rank in rec["launches"]],
           "planned_per_step": {k: n for k, n in planned.items() if n},
           **(extra or {})}
    print(json.dumps({"dryrun_multichip": out}))
    if not (rel <= entry_points.RESUME_REL and rec["ranks_bit_equal"]
            and rec["restored_bit_equal"]):
        raise SystemExit(f"dryrun_multichip: the resume or the ranks disagree: {out}")
    if any(step != planned for rank in rec["launches"] for step in rank):
        raise SystemExit(f"dryrun_multichip: launches per rank per step != {planned}")
    if not out["loss_rel"] <= DDP_LOSS_REL:
        raise SystemExit(f"dryrun_multichip: step 1 disagrees with one process: {out}")
    return out


def entry_dryrun(smi):
    """`entry()` on the card (one call counted, then ms per call) held
    against `entry(device="cpu")` (`hold_entry`), then
    `dryrun_multichip(DRYRUN_WORLD)` (`hold_dryrun`, 64x96, 3 views, 2
    iterations, batch 1 per rank) against one process's step over both
    samples, profiled: one launch each of K23 and K24 and
    `hold_loss_path`'s gates."""
    t0 = time.perf_counter()
    fn, args = entry_points.entry()
    reset_launch_counts()
    got = fn(*args)
    torch.cuda.synchronize()
    counts = launch_counts()
    first_s = time.perf_counter() - t0
    call_ms = []
    for _ in range(5):
        t1 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        call_ms.append(1e3 * (time.perf_counter() - t1))
    cpu_fn, cpu_args = entry_points.entry(device="cpu")
    planned = planned_map_counts(
        sweep_shapes(ENTRY_WIDTH, ENTRY_HEIGHT, ENTRY_VIEWS, ITERATION), torch.float32)
    hold_entry(got, cpu_fn(*cpu_args), counts, planned, extra={
        "first_call_s_with_init": first_s, "ms_per_call": call_ms,
        "entry_phase_s": time.perf_counter() - t0, "card": smi})
    t0 = time.perf_counter()
    dry = entry_points.dryrun_multichip(DRYRUN_WORLD, timeout=600)
    wall = time.perf_counter() - t0
    planned = planned_step_counts(sweep_shapes(
        entry_points.DRYRUN_WIDTH, entry_points.DRYRUN_HEIGHT, entry_points.DRYRUN_VIEWS,
        entry_points.DRYRUN_ITERATION), torch.float32, iteration=entry_points.DRYRUN_ITERATION)
    model = init_weights(Pipeline(iteration=entry_points.DRYRUN_ITERATION, test=False),
                         0).cuda()
    batch = to_device_batch(entry_points.dryrun_batch(DRYRUN_WORLD), "cuda")
    losses = []
    reset_launch_counts()
    events = trace_events(lambda: losses.append(train_step(
        model, make_optimizer(model), batch, entry_points.DRYRUN_LR, True,
        entry_points.DRYRUN_ITERATION)["loss"].item()))
    loss_counts = {k: launch_counts()[k] for k in ("full_loss", "full_loss_grad")}
    layouts = prob_grad_layouts(model, batch)
    extra = {"single_step_loss_launches": loss_counts, "single_step_prob_grad_layouts": layouts}
    if loss_counts != {"full_loss": 1, "full_loss_grad": 1}:
        raise SystemExit(f"entry_dryrun: one process's step launched {loss_counts}")
    hold_loss_path("entry_dryrun", full_loss_ops.full_loss_terms.copies,
                   depth_readout_grad.copies, layouts, loss_op_events(events))
    return hold_dryrun(dry, planned, losses[0], extra={
        "timing_note": "two processes sharing one card over gloo",
        "phase_wall_s": wall, "card": smi, **extra})


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
    host = []
    t0 = time.perf_counter()
    secs = run_depth(model, samples, outdir, "cuda", host_secs=host)
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
                      "host_dispatch_ms": [1e3 * d for d, _ in host],
                      "host_finalize_ms": [1e3 * f for _, f in host],
                      "warmup_s": warm, "peak_mem_gib": peak / 2 ** 30,
                      "launches": counts, "depth_check": errs}))
    bad = [e for e in errs if not e["median_abs_err_vs_gt"] < 0.05]
    if bad:
        raise SystemExit(f"depth check failed ({dtype}): {bad}")
    return counts, errs, wall


def dispatch_is_async(model, sample):
    """One map through the cached path (`extract` per view, `match`) and
    one through the full forward, each with torch's sync debug mode set
    to raise at any synchronising call; then whether the card was still
    busy when the host returned. Returns the record."""
    dev = lambda x: torch.as_tensor(x).to("cuda", non_blocking=True)
    projs = {k: dev(v) for k, v in sample["proj_matrices"].items() if k != "level_0"}
    dmin, dmax = dev(sample["depth_min"]), dev(sample["depth_max"])
    level0 = sample["imgs"]["level_0"]
    rec = {}
    paths = {"match": lambda: model.match([model.extract(dev(level0[:, i]))
                                           for i in range(level0.shape[1])],
                                          projs, dmin, dmax),
             "forward": lambda: model({"level_0": dev(level0)}, projs, dmin, dmax)}
    with torch.inference_mode():
        for name, run in paths.items():
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                run()
                done = torch.cuda.Event()
                done.record()
            except RuntimeError:
                raise SystemExit(f"eval_pipeline: {name} synchronises the host:\n"
                                 f"{traceback.format_exc()}")
            finally:
                torch.cuda.set_sync_debug_mode("default")
            rec[f"{name}_busy_at_return"] = not done.query()
            torch.cuda.synchronize()
    return rec


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN restricted to its deterministic algorithms within the block.
    In float32 the algorithms cuDNN picks for this model by default are
    not bit-deterministic on the card (two forwards of one input differ),
    which would hide what a comparison of two eval loops looks for."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


def eval_pipeline(model, samples, tmp, dtype):
    """run_depth's one-batch pipeline held against one map per call: the
    5 maps through one run_depth call, then twice through one call per
    map; the pipelined PFMs may differ in no more pixels than the two
    one-per-call runs differ in (0 where the path is deterministic). The
    held runs use cuDNN's deterministic algorithms; two one-per-call runs
    with cuDNN's default choice show its own spread (`default_cudnn`).
    Also checks that `match` and the forward make no host sync. Prints
    one JSON line; returns (the one-per-call noise in pixels, record)."""
    def out(key):
        return os.path.join(tmp, f"pipeline_{dtype}_{key}")

    def one_per_call(key):
        t0 = time.perf_counter()
        for s in samples:
            run_depth(model, [s], out(key), "cuda", log=lambda *_: None)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    default_s = [one_per_call("default_a"), one_per_call("default_b")]
    default = pfm_diff(out("default_b"), out("default_a"), len(samples))
    with deterministic_cudnn():
        t0 = time.perf_counter()
        run_depth(model, samples, out("all"), "cuda", log=lambda *_: None)
        torch.cuda.synchronize()
        all_s = time.perf_counter() - t0
        one_s = [one_per_call("one_a"), one_per_call("one_b")]
    vs_one = pfm_diff(out("all"), out("one_a"), len(samples))
    noise = pfm_diff(out("one_b"), out("one_a"), len(samples))
    differing = sum(r["differing_pixels"] for r in vs_one)
    allowed = sum(r["differing_pixels"] for r in noise)
    rec = {"dtype": str(dtype), "maps": len(samples), "pipelined_s": all_s,
           "one_per_call_s": one_s, "vs_one_per_call": vs_one,
           "differing_pixels": differing, "one_per_call_noise_pixels": allowed,
           "default_cudnn": {"one_per_call_s": default_s, "run_to_run": default,
                             "differing_pixels": sum(r["differing_pixels"] for r in default)},
           "no_host_sync": dispatch_is_async(model, samples[0])}
    print(json.dumps({"eval_pipeline": rec}))
    if differing > allowed:
        raise SystemExit(f"eval_pipeline ({dtype}): {differing} pixels differ from one "
                         f"map per call, beyond the {allowed} of two such runs")
    return allowed, rec


def input_uint8(model, samples, samples_u8, noise, tmp):
    """`--input_uint8` on the card: Pipeline._normalize of each raw uint8
    level_0 plane equals the host's float32 plane bit for bit, and the 5
    maps from uint8 input differ from the float32 input's in no more
    pixels than `noise` (both with cuDNN's deterministic algorithms).
    Prints maps/s and host→device bytes per map of both forms (the
    feature cache uploads each view once)."""
    planes_equal = all(
        torch.equal(Pipeline._normalize(u["imgs"]["level_0"].cuda()).cpu(),
                    torch.as_tensor(f["imgs"]["level_0"]))
        for u, f in zip(samples_u8, samples))
    rates = {}
    with deterministic_cudnn():
        for form, batch in (("float32", samples), ("uint8", samples_u8)):
            run_depth(model, batch[:1], os.path.join(tmp, f"warm_{form}"), "cuda",
                      log=lambda *_: None)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_depth(model, batch, os.path.join(tmp, f"input_{form}"), "cuda",
                      log=lambda *_: None)
            torch.cuda.synchronize()
            rates[form] = len(batch) / (time.perf_counter() - t0)
    vs_f32 = pfm_diff(os.path.join(tmp, "input_uint8"), os.path.join(tmp, "input_float32"),
                      len(samples))
    differing = sum(r["differing_pixels"] for r in vs_f32)
    rec = {"planes_bit_equal": planes_equal, "maps_per_s": rates,
           "h2d_bytes_per_map": {"float32": h2d_bytes_per_map(samples),
                                 "uint8": h2d_bytes_per_map(samples_u8)},
           "h2d_bytes_per_map_uncached": {
               "float32": h2d_bytes_per_map(samples, feature_cache=False),
               "uint8": h2d_bytes_per_map(samples_u8, feature_cache=False)},
           "vs_float32_input": vs_f32, "differing_pixels": differing,
           "one_per_call_noise_pixels": noise}
    print(json.dumps({"input_uint8": rec}))
    if not planes_equal:
        raise SystemExit("input_uint8: the card's normalised uint8 plane is not the "
                         "host's float32 plane")
    if differing > noise:
        raise SystemExit(f"input_uint8: {differing} pixels differ from the float32 "
                         f"input's maps, beyond {noise}")
    return rec


# eval_ddp_2rank: the eval path over two processes on the one card (gloo),
# at --batch_size 2: 3 global batches of the 5 maps, the last one padded.
EVAL_DDP_BATCH = 2
# (dtype, result wire) of the data-parallel eval runs, each held bit for
# bit against one process; the learned maps fused are the first run's.
EVAL_DDP_RUNS = (("float32", "uint16"), ("float32", "float32"), ("bfloat16", "uint16"))


def stack_samples(samples):
    """Batch-1 samples (`samples_of`) as one batch in the loader's layout."""
    def stack(values):
        if isinstance(values[0], dict):
            return {k: stack([v[k] for v in values]) for k in values[0]}
        if isinstance(values[0], list):
            return [x for v in values for x in v]
        return np.concatenate(values)

    return stack(samples)


def rank_batches(samples, batch_size, rank, world):
    """(batch, n_real) of this rank's rows of each global batch of
    `samples` at `batch_size`, as `eval_batches` gives them to the loader:
    the short last batch padded by its last sample."""
    return [(stack_samples([samples[i] for i in rows]), n)
            for rows, n in eval_batches(len(samples), batch_size, rank, world)]


def real_views(size, batch_size, rank, world):
    """The views whose maps `rank` writes: its rows before the padding."""
    return [rows[i] for rows, n in eval_batches(size, batch_size, rank, world)
            for i in range(n)]


def merge_rank_outputs(root, world):
    """Hard-links the PFMs that each rank wrote under root/rank<r> into
    root/all and returns {rank: [views it wrote]}; a map written by two
    ranks, or a depth map without its confidence, raises."""
    written = {}
    for r in range(world):
        views = {}
        for kind in ("depth_est", "confidence"):
            src, dst = os.path.join(root, f"rank{r}", kind), os.path.join(root, "all", kind)
            os.makedirs(dst, exist_ok=True)
            names = sorted(os.listdir(src)) if os.path.isdir(src) else []
            for name in names:
                if os.path.exists(os.path.join(dst, name)):
                    raise SystemExit(f"{kind}/{name} written by two ranks")
                os.link(os.path.join(src, name), os.path.join(dst, name))
            views[kind] = [int(name[:8]) for name in names]
        if views["depth_est"] != views["confidence"]:
            raise SystemExit(f"rank {r} wrote depth maps {views['depth_est']} but "
                             f"confidence maps {views['confidence']}")
        written[r] = views["depth_est"]
    return written


def eval_rank(job, rank=0, world=1, device="cuda"):
    """One rank of `eval_ddp_2rank`: renders the scene from its seed, runs
    `run_depth` on its rows of every global batch (`rank_batches`, the
    feature cache off, as save_depth runs a data-parallel eval) once per
    EVAL_DDP_RUNS into job["out"]/<dtype>_<wire>/rank<r>, under
    deterministic cuDNN; then `fuse_once`, as the eval CLI's main: after
    the barrier rank 0 links every rank's maps together
    (`merge_rank_outputs`) and fuses the learned depth of the first run.
    Records the rank's rows, each run's launches and rank 0's merge and
    fused cloud."""
    cams, images, _ = render_scene(job["width"], job["height"], job["views"], job["seed"])
    local = rank_batches(samples_of(cams, images), job["batch"], rank, world)
    batches = [b for b, _ in local]
    if torch.device(device).type == "cuda":
        batches = pinned(batches)
    out = {"rows": [len(b["filename"]) for b in batches], "n_real": [n for _, n in local],
           "launches": {}}
    with deterministic_cudnn():
        for dtype, wire in EVAL_DDP_RUNS:
            model = load_npz_weights(Pipeline(iteration=job["iteration"],
                                              dtype=getattr(torch, dtype)),
                                     pretrained_path("dtu")).to(device)
            _sync(device)
            reset_launch_counts()
            run_depth(model, batches, os.path.join(job["out"], f"{dtype}_{wire}", f"rank{rank}"),
                      device, feature_cache=False, result_wire=wire, n_real=out["n_real"],
                      log=lambda *_: None)
            _sync(device)
            out["launches"][f"{dtype}_{wire}"] = launch_counts()
            del model

    def fuse():
        merged = {f"{d}_{w}": merge_rank_outputs(os.path.join(job["out"], f"{d}_{w}"), world)
                  for d, w in EVAL_DDP_RUNS}
        learned = os.path.join(job["out"], "_".join(EVAL_DDP_RUNS[0]), "all")
        maps = [[read_pfm(os.path.join(learned, kind, f"{v:08d}.pfm"))[0][..., 0]
                 for v in range(job["views"])] for kind in ("depth_est", "confidence")]
        reset_launch_counts()
        fused = fuse_scene(fusion_views(cams, *maps, images),
                           os.path.join(job["out"], "fused"), device)
        _sync(device)
        return {"written": merged, "fused": fused, "fusion_launches": launch_counts()}

    out["rank0"] = fuse_once(fuse, device, parallel=True)
    return out


def eval_ddp_2rank(samples, card):
    """The eval path over DDP_WORLD processes sharing the card over gloo
    (`eval_rank`), the 5 maps at EVAL_DDP_BATCH, against one process at
    batch 1 with the feature cache off (`samples`, on the card), per
    EVAL_DDP_RUNS, both under deterministic cuDNN: each rank writes the
    maps of its real rows and no other, every map once, 0 differing
    pixels; each rank launches each kernel as planned for its rows (the
    padded row is computed, as on JAX's devices); rank 0's fused cloud of
    the learned depth passes the main phase's gate and launches K3 once per
    view. Prints one JSON line; SystemExit on a miss."""
    views = len(samples)
    with tempfile.TemporaryDirectory() as tmp:
        job = {"width": WIDTH, "height": HEIGHT, "views": views, "seed": SEED,
               "iteration": ITERATION, "batch": EVAL_DDP_BATCH, "out": tmp}
        t0 = time.perf_counter()
        ranks = run_ranks(job, DDP_WORLD, "gloo", "cuda:0", work="eval_rank")
        wall = time.perf_counter() - t0
        differing = {}
        with deterministic_cudnn():
            for dtype, wire in EVAL_DDP_RUNS:
                key = f"{dtype}_{wire}"
                model = load_npz_weights(Pipeline(iteration=ITERATION,
                                                  dtype=getattr(torch, dtype)),
                                         pretrained_path("dtu")).cuda()
                run_depth(model, samples, os.path.join(tmp, key, "one"), "cuda",
                          feature_cache=False, result_wire=wire, log=lambda *_: None)
                del model
                diff = pfm_diff(os.path.join(tmp, key, "all"), os.path.join(tmp, key, "one"),
                                views)
                differing[key] = sum(r["differing_pixels"] for r in diff)
    rank0 = ranks[0]["rank0"]

    def launched(counts):
        return {k: n for k, n in counts.items() if n}

    rec = {"world": DDP_WORLD, "batch": EVAL_DDP_BATCH, "maps": views,
           "rows_per_rank": [r["rows"] for r in ranks],
           "n_real_per_rank": [r["n_real"] for r in ranks],
           "written_per_rank": rank0["written"], "differing_pixels": differing,
           "launches_per_rank": [{key: launched(c) for key, c in r["launches"].items()}
                                 for r in ranks],
           "wall_s_with_process_start": wall,
           "timing_note": "two processes sharing one card over gloo: not a scaling figure",
           "fused": rank0["fused"], "fusion_launches": launched(rank0["fusion_launches"]),
           "card": card}
    print(json.dumps({"eval_ddp_2rank": rec}))
    for key, written in rank0["written"].items():
        want = {r: real_views(views, EVAL_DDP_BATCH, r, DDP_WORLD) for r in range(DDP_WORLD)}
        if written != want:
            raise SystemExit(f"eval_ddp_2rank {key}: the ranks wrote {written}, not {want}")
    if any(differing.values()):
        raise SystemExit(f"eval_ddp_2rank: maps differ from one process: {differing}")
    for r, rank in enumerate(ranks):
        for dtype, wire in EVAL_DDP_RUNS:
            dt = getattr(torch, dtype)
            planned = planned_map_counts(sweep_shapes(WIDTH, HEIGHT, views, ITERATION,
                                                      itemsize=dt.itemsize), dt,
                                         maps=sum(rank["rows"]))
            if rank["launches"][f"{dtype}_{wire}"] != planned:
                raise SystemExit(f"eval_ddp_2rank rank {r} {dtype} {wire}: launches "
                                 f"{rank['launches'][f'{dtype}_{wire}']} != planned {planned}")
    fused = rank0["fused"]
    if not (fused["pixel_share"] >= 0.05 and fused["median_abs_z_minus_z0"] < 0.05):
        raise SystemExit(f"eval_ddp_2rank: rank 0's fused cloud failed: {fused}")
    if rank0["fusion_launches"] != planned_counts(fusion_consistency=views):
        raise SystemExit(f"eval_ddp_2rank: fusion launches {rank0['fusion_launches']}: "
                         f"want {views} of fusion_consistency only")
    return rec


# The `kernels` line: the kernels reported per depth map (their launches
# from the f32 and bf16 map runs) and per training step (from the
# training runs); fusion_consistency has its own entry.
REPORT_PER_MAP = ("corr_epilogue", "sweep_premul", "depth_readout", "sweep_taps",
                  "convex_upsample", "view_aggregate", "gru_reset", "gru_update", "bn_act",
                  "upsample2x_add", "corr_epilogue_bf16", "sweep_premul_bf16",
                  "depth_readout_bf16", "sweep_taps_bf16", "convex_upsample_bf16",
                  "gru_reset_bf16", "gru_update_bf16", "bn_act_bf16", "upsample2x_add_bf16",
                  "resize_bilinear", "resize_bilinear_bf16")
REPORT_PER_STEP = ("sweep_grad_ref", "sweep_grad_src", "depth_readout_grad",
                   "convex_upsample_grad", "view_aggregate_grad", "gru_update_grad",
                   "gru_reset_grad", "bn_act_grad", "upsample2x_grad", "bn_stats",
                   "bn_stats_grad", "sweep_grad_ref_bf16", "sweep_grad_src_bf16",
                   "depth_readout_grad_bf16", "convex_upsample_grad_bf16",
                   "gru_update_grad_bf16", "gru_reset_grad_bf16", "bn_act_grad_bf16",
                   "upsample2x_grad_bf16", "bn_stats_bf16", "bn_stats_grad_bf16", "full_loss",
                   "full_loss_grad", "grad_norm", "clip_adam", "depth_metrics",
                   "resize_bilinear_grad", "resize_bilinear_grad_bf16")


def kernel_sources():
    """{report name: (source in the repo, file:line of what it replaces)}
    of every kernel."""
    sources = {"corr_epilogue": ("itermvs_tpu_torch/csrc/corr_epilogue.cu",
                                 "itermvs_tpu/ops/sweep_epilogue.py:61"),
               "sweep_premul": ("itermvs_tpu_torch/csrc/sweep_premul.cu",
                                "itermvs_tpu/ops/grid_sample.py:472"),
               "fusion_consistency": ("itermvs_tpu_torch/csrc/fusion_consistency.cu",
                                      "itermvs_tpu/fusion.py:57"),
               "sweep_grad_ref": ("itermvs_tpu_torch/csrc/sweep_grad_ref.cu",
                                  "itermvs_tpu/models/itermvs.py:106"),
               "sweep_grad_src": ("itermvs_tpu_torch/csrc/sweep_grad_src.cu",
                                  "itermvs_tpu/models/itermvs.py:106"),
               "depth_readout": ("itermvs_tpu_torch/csrc/depth_readout.cu",
                                 "itermvs_tpu/models/itermvs.py:75"),
               "depth_readout_grad": ("itermvs_tpu_torch/csrc/depth_readout_grad.cu",
                                      "itermvs_tpu/models/itermvs.py:75"),
               "sweep_taps": ("itermvs_tpu_torch/csrc/sweep_taps.cu",
                              "itermvs_tpu/ops/warping.py:158"),
               "convex_upsample": ("itermvs_tpu_torch/csrc/convex_upsample.cu",
                                   "itermvs_tpu/ops/upsample.py:13"),
               "convex_upsample_grad": ("itermvs_tpu_torch/csrc/convex_upsample_grad.cu",
                                        "itermvs_tpu/ops/upsample.py:13"),
               "view_aggregate": ("itermvs_tpu_torch/csrc/view_aggregate.cu",
                                  "itermvs_tpu/models/itermvs.py:251"),
               "view_aggregate_grad": ("itermvs_tpu_torch/csrc/view_aggregate_grad.cu",
                                       "itermvs_tpu/models/itermvs.py:251"),
               "gru_reset": ("itermvs_tpu_torch/csrc/gru_reset.cu",
                             "itermvs_tpu/models/blocks.py:178"),
               "gru_update": ("itermvs_tpu_torch/csrc/gru_update.cu",
                              "itermvs_tpu/models/blocks.py:176"),
               "gru_update_grad": ("itermvs_tpu_torch/csrc/gru_update_grad.cu",
                                   "itermvs_tpu/models/blocks.py:176"),
               "gru_reset_grad": ("itermvs_tpu_torch/csrc/gru_reset_grad.cu",
                                  "itermvs_tpu/models/blocks.py:178"),
               "bn_act": ("itermvs_tpu_torch/csrc/bn_act.cu", "itermvs_tpu/models/blocks.py:90"),
               "bn_act_grad": ("itermvs_tpu_torch/csrc/bn_act_grad.cu",
                               "itermvs_tpu/models/blocks.py:165"),
               "upsample2x_add": ("itermvs_tpu_torch/csrc/upsample2x_add.cu",
                                  "itermvs_tpu/models/feature_net.py:98"),
               "upsample2x_grad": ("itermvs_tpu_torch/csrc/upsample2x_grad.cu",
                                   "itermvs_tpu/models/feature_net.py:98"),
               "bn_stats": ("itermvs_tpu_torch/csrc/bn_stats.cu",
                            "itermvs_tpu/models/blocks.py:96"),
               "bn_stats_grad": ("itermvs_tpu_torch/csrc/bn_stats_grad.cu",
                                 "itermvs_tpu/models/blocks.py:96"),
               "full_loss": ("itermvs_tpu_torch/csrc/full_loss.cu",
                             "itermvs_tpu/models/losses.py:35"),
               "full_loss_grad": ("itermvs_tpu_torch/csrc/full_loss_grad.cu",
                                  "itermvs_tpu/models/losses.py:35"),
               "grad_norm": ("itermvs_tpu_torch/csrc/grad_norm.cu",
                             "itermvs_tpu/engine/train_loop.py:54"),
               "clip_adam": ("itermvs_tpu_torch/csrc/clip_adam.cu",
                             "itermvs_tpu/engine/train_loop.py:54"),
               "depth_metrics": ("itermvs_tpu_torch/csrc/depth_metrics.cu",
                                 "itermvs_tpu/engine/metrics.py:47"),
               "resize_bilinear": ("itermvs_tpu_torch/csrc/resize_bilinear.cu",
                                   "itermvs_tpu/ops/resize.py:41"),
               "resize_bilinear_grad": ("itermvs_tpu_torch/csrc/resize_bilinear_grad.cu",
                                        "itermvs_tpu/ops/resize.py:41")}
    for name in ("corr_epilogue", "sweep_premul", "sweep_grad_ref", "sweep_grad_src"):
        source, replaces = sources[name]
        sources[f"{name}_bf16"] = (source.replace(".cu", "_bf16.cu"), replaces)
    for name in TEMPLATED:                  # one templated source, both forms
        sources[f"{name}_bf16"] = sources[name]
    return sources


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
    # K8 at the two sweeps of a map and K6 (eval form) at its 5
    # predictions, then (after the bf16 maps) both in bf16.
    per_map.update(check_sweep_taps(WIDTH, HEIGHT, VIEWS, 1, ITERATION, torch.float32, "map"))
    per_map.update(check_readout(1, HEIGHT // 4, WIDTH // 4, torch.float32, 1 + ITERATION,
                                 "map", train=False))
    per_map.update(check_upsample(1, HEIGHT // 4, WIDTH // 4, torch.float32, 1, "map",
                                  train=False))
    # K11 at a map's 13 aggregations and K11/K12 at a training step's.
    view_map, view_step = check_view_aggregate()
    per_map.update(view_map)
    # K13-K16 at a map's and a training step's GRU calls, both dtypes.
    gru_map, gru_step = check_conv_gru()
    per_map.update(gru_map)
    # K17 at FeatureNet's BN calls on a map's image, K17/K18 on a step's.
    bn_map, bn_step = check_bn_act()
    per_map.update(bn_map)
    # K21 and K22 at FeatureNet's BN inputs and epilogues on a step's images.
    bn_stats_step = check_bn_stats()
    # K19 at FeatureNet's FPN adds on a map's image, K19/K20 on a step's.
    up2_map, up2_step = check_upsample2x()
    per_map.update(up2_map)
    # K28 at the model's resizes on a map, K28/K29 on a step's.
    resize_map, resize_step = check_resize()
    per_map.update(resize_map)
    # K23 and K24 at the training step's loss, planted and real.
    loss_step = check_full_loss()
    # K25 and K26 at the training model's parameters, clipped and not.
    update_step = check_clip_adam(smi)
    # K27 at the training step's metrics, planted, NaN, empty and edge shapes.
    metrics_step = check_depth_metrics(smi)
    # K3 at DTU's 10 sources, and at the 4 of the main path's fusion (the
    # shape its reported time and bound are taken at).
    k3 = check_consistency(WIDTH, HEIGHT, (DTU_SOURCES, VIEWS - 1))[VIEWS - 1]

    t0 = time.perf_counter()
    cams, images, gt_depths = render_scene(WIDTH, HEIGHT, VIEWS, SEED)
    # Page-locked, as save_depth's loader delivers batches on a card.
    samples = pinned(samples_of(cams, images))
    samples_u8 = pinned(samples_of(cams, images, uint8=True))
    print(json.dumps({"scene_seconds": time.perf_counter() - t0,
                      "size": [WIDTH, HEIGHT], "views": VIEWS}))

    with tempfile.TemporaryDirectory() as tmp:
        outdir = os.path.join(tmp, "out")
        counts, errs, wall = depth_run(model, samples, gt_depths, outdir, tmp, torch.float32)
        planned = planned_map_counts(shapes, torch.float32, len(samples))
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
        noise, _ = eval_pipeline(model, samples, tmp, torch.float32)
        input_uint8(model, samples, samples_u8, noise, tmp)
        del model
        torch.cuda.empty_cache()

        # bf16: the forward forms at the same shapes, then the same maps
        # with the same weights in bf16, held against the f32 run's error.
        shapes16 = sweep_shapes(WIDTH, HEIGHT, VIEWS, ITERATION, itemsize=2)
        per_map.update(check_kernels(shapes16, dtype=BF16))
        per_map.update(check_sweep_taps(WIDTH, HEIGHT, VIEWS, 1, ITERATION, BF16, "map"))
        per_map.update(check_readout(1, HEIGHT // 4, WIDTH // 4, BF16, 1 + ITERATION, "map",
                                     train=False))
        per_map.update(check_upsample(1, HEIGHT // 4, WIDTH // 4, BF16, 1, "map",
                                      train=False))
        check_fwd_edge_cases()
        check_edge_shapes()
        model16 = load_npz_weights(Pipeline(iteration=ITERATION, dtype=BF16),
                                   pretrained_path("dtu")).cuda()
        counts16, errs16, wall16 = depth_run(model16, samples, gt_depths,
                                             os.path.join(tmp, "out_bf16"), tmp, BF16)
        planned = planned_map_counts(shapes16, BF16, len(samples))
        if counts16 != planned:
            raise SystemExit(f"bf16 launch counts {counts16} != planned {planned}")
        bad = [(e16, e32) for e16, e32 in zip(errs16, errs)
               if not e16["median_abs_err_vs_gt"] < max(1.15 * e32["median_abs_err_vs_gt"],
                                                        e32["median_abs_err_vs_gt"] + 0.01)]
        if bad:
            raise SystemExit(f"bf16 depth error beyond max(1.15 f32, f32 + 0.01): {bad}")
        profile_maps(model16, samples, os.path.join(tmp, "prof_bf16"), wall16)
        eval_pipeline(model16, samples, tmp, BF16)
        del model16
        torch.cuda.empty_cache()
    counts.update({k: counts16[k] for k in ("sweep_premul_bf16", "corr_epilogue_bf16",
                                            "depth_readout_bf16", "sweep_taps_bf16",
                                            "convex_upsample_bf16", "gru_reset_bf16",
                                            "gru_update_bf16", "bn_act_bf16",
                                            "upsample2x_add_bf16", "resize_bilinear_bf16")})
    # The same maps as a data-parallel eval: two gloo ranks on the card.
    eval_ddp_2rank(samples, smi)

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
    readout_step = {}
    for dtype in (torch.float32, BF16):
        check_sweep_taps(TRAIN_WIDTH, TRAIN_HEIGHT, TRAIN_VIEWS, TRAIN_BATCH, TRAIN_ITERATION,
                         dtype, "step")
        readout_step.update(check_readout(TRAIN_BATCH, TRAIN_HEIGHT // 4, TRAIN_WIDTH // 4,
                                          dtype, 1 + TRAIN_ITERATION, "step", train=True))
        readout_step.update(check_upsample(TRAIN_BATCH, TRAIN_HEIGHT // 4, TRAIN_WIDTH // 4,
                                           dtype, 1, "step", train=True))
    compare_train_step()
    synthetic_ms = {k: v["ms_by_shape"] for k, v in per_step.items()}
    train_counts, train32 = train_full_width(train_shapes, synthetic_ms=synthetic_ms)
    train_counts16, train16 = train_full_width(train_shapes16, BF16, synthetic_ms)
    bf16_tracks_f32(train32["losses"], train16["losses"])
    train_counts.update({k: train_counts16[k] for k in ("sweep_grad_ref_bf16",
                                                        "sweep_grad_src_bf16",
                                                        "depth_readout_grad_bf16",
                                                        "convex_upsample_grad_bf16",
                                                        "gru_update_grad_bf16",
                                                        "gru_reset_grad_bf16",
                                                        "bn_act_grad_bf16",
                                                        "upsample2x_grad_bf16",
                                                        "bn_stats_bf16",
                                                        "bn_stats_grad_bf16",
                                                        "resize_bilinear_grad_bf16")})

    # Data-parallel training (two gloo ranks on the card; one NCCL rank in
    # bf16), then --debug_nans on one depth map.
    train_ddp_2rank()
    train_ddp_nccl()
    # The entry points: entry() against the CPU, the dry run on two ranks.
    entry_dryrun(smi)
    model = load_npz_weights(Pipeline(iteration=ITERATION), pretrained_path("dtu")).cuda()
    with tempfile.TemporaryDirectory() as tmp:
        debug_counts, _ = debug_nans_phase(model, samples[0], gt_depths[0], tmp)
    planned = planned_map_counts(shapes, torch.float32, features=VIEWS)
    if debug_counts != planned:
        raise SystemExit(f"debug_nans launch counts {debug_counts} != planned {planned}")
    del model

    sources = kernel_sources()
    report = []
    for name in REPORT_PER_MAP:
        tot = per_map[name]
        t_bytes, t_ops = tot["bytes"] / PEAK_BYTES_PER_S, tot["ops"] / PEAK_F32_PER_S
        report.append({
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": counts[name],
            "max_abs_err": tot["max_abs_err"], "ms": tot["ms"], "call_ms": tot["call_ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": tot["library_ms"], "per": "one depth map",
            **{k: tot[k] for k in ("device_ms", "plain_device_ms") if k in tot}})
    report.append({
        "name": "fusion_consistency", "route": "cuda",
        "source": sources["fusion_consistency"][0],
        "replaces": sources["fusion_consistency"][1],
        "launches": fusion_counts["fusion_consistency"],
        "max_abs_err": k3["max_abs_err"], "ms": k3["ms"], "call_ms": k3["call_ms"],
        "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
        "bound_by": k3["bound_by"], "library_ms": None,
        "per": f"one {WIDTH}x{HEIGHT} reference view, {VIEWS - 1} sources"})
    per_step.update(readout_step)
    per_step["view_aggregate_grad"] = view_step["view_aggregate_grad"]
    per_step.update(gru_step)
    per_step.update(bn_step)
    per_step.update(up2_step)
    per_step.update(bn_stats_step)
    per_step.update(loss_step)
    per_step.update(update_step)
    per_step.update(metrics_step)
    per_step.update(resize_step)
    for name in REPORT_PER_STEP:
        tot = per_step[name]
        t_bytes, t_ops = tot["bytes"] / PEAK_BYTES_PER_S, tot["ops"] / PEAK_F32_PER_S
        report.append({
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": train_counts[name],
            "max_abs_err": tot["max_abs_err"], "max_rel_err": tot["max_rel_err"],
            "ms": tot["ms"], "call_ms": tot["call_ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"],
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": tot.get("library_ms"), "launches_per_step": tot["launches"],
            **{k: tot[k] for k in ("device_ms", "plain_device_ms") if k in tot},
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
