#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Checks for a CUDA device and prints its name and power limit.
2. Builds the port's CUDA kernels from itermvs_tpu_torch/csrc with nvcc.
3. Holds each kernel against its plain PyTorch version on the card at
   the 1600x1152 shapes of the depth path (sweep_premul, corr_epilogue)
   and of fusion (fusion_consistency, bit for bit: with 10 sources as
   DTU's pair lists give, with the 4 of the fusion run below, which the
   report line carries, and at the K3_EDGE_CASES), and times kernel,
   plain version and (for corr_epilogue) one PyTorch call of the same
   function.
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

The last line is `{"ok": true, "device": {...}}`; any failed phase
exits non-zero before it. Without a CUDA device, or outside the repo,
the script exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from itermvs_tpu_torch import kernels
from itermvs_tpu_torch.eval import run_depth
from itermvs_tpu_torch.fusion import MemoryViews, consistency_matrices, fuse_views
from itermvs_tpu_torch.io import read_pfm, read_ply
from itermvs_tpu_torch.models import Pipeline
from itermvs_tpu_torch.models.itermvs import (
    CORR_INTERVALS, GROUPS, LEVELS, NUM_INIT_SAMPLES)
from itermvs_tpu_torch.ops.consistency import (
    MAX_SOURCES, consistency, consistency_plain, launch_consistency, record)
from itermvs_tpu_torch.ops.sweep import sample_chunks, sweep_premul, sweep_premul_plain
from itermvs_tpu_torch.ops.sweep_epilogue import corr_epilogue, corr_epilogue_plain
from itermvs_tpu_torch.weights import load_npz_weights, pretrained_path

WIDTH, HEIGHT = 1600, 1152
VIEWS = 5
ITERATION = 4
DTU_SOURCES = 10        # sources per reference view in DTU's pair lists
SEED = 0
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and
# float32 rate outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
FEATURE_CHANNELS = {"level1": 16, "level2": 32, "level3": 48}

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
def sweep_shapes(width, height, views, iteration):
    """Per sweep shape of one depth map: (name, batch, n, H, W, H1, W1, C,
    launches per map of each kernel, from the chunk plan)."""
    h4, w4 = height // 4, width // 4
    src = {"level1": (height // 2, width // 2), "level2": (h4, w4),
           "level3": (height // 8, width // 8)}
    out = [("init", 1, NUM_INIT_SAMPLES, h4 // 2, w4 // 2, *src["level3"], 48,
            (views - 1) * len(sample_chunks(1, NUM_INIT_SAMPLES, h4 * w4 // 4, 48)))]
    for key in LEVELS:
        n, c = len(CORR_INTERVALS[key]), FEATURE_CHANNELS[key]
        out.append((f"iter_{key}", 1, n, h4, w4, *src[key], c,
                    iteration * (views - 1) * len(sample_chunks(1, n, h4 * w4, c))))
    return out


def sweep_inputs(b, n, h, w, h1, w1, c, gen):
    """K2 inputs with the access pattern of a real sweep: each sample is
    the reference grid, scaled to the source size and shifted by a
    per-sample sub-pixel-to-several-pixel disparity."""
    dev = "cuda"
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
    return src, base, taps, ref


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


def check_kernels(shapes):
    """Each kernel against its plain version at every sweep shape; per
    shape one JSON line, and per kernel the totals of one depth map."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    per_map = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0,
                   "library_ms": 0.0, "bytes": 0.0, "ops": 0.0}
               for k in ("sweep_premul", "corr_epilogue")}
    for name, b, n, h, w, h1, w1, c, launches in shapes:
        hw = h * w
        p = n * hw
        src, base, taps, ref = sweep_inputs(b, n, h, w, h1, w1, c, gen)

        # K2 sweep_premul: products of the same floats in the same
        # order, so the tolerance is 1e-6 of the largest value.
        got = sweep_premul(src, base, taps, ref, n)
        want = sweep_premul_plain(src, base, taps, ref, n)
        err2 = (got - want).abs().max().item()
        tol2 = 1e-6 * want.abs().max().item()
        nbytes2 = 4 * (src.numel() + base.numel() + taps.numel() + ref.numel()
                       + got.numel())
        ops2 = 2 * got.numel()
        k2 = {"ms": time_ms(lambda: sweep_premul(src, base, taps, ref, n)),
              "plain_ms": time_ms(lambda: sweep_premul_plain(src, base, taps, ref, n)),
              "library_ms": None}
        k2["bound_ms"], k2["bound_by"] = bound_ms(nbytes2, ops2)

        # K1 corr_epilogue on the real K2 output: a sum of 4*C/G terms
        # in another order than the plain version, so 1e-5 of the
        # largest value.
        premul = got.reshape(b * p, 4 * c)
        del want
        got1 = corr_epilogue(premul, b * n, GROUPS)
        want1 = corr_epilogue_plain(premul, b * n, GROUPS)
        err1 = (got1 - want1).abs().max().item()
        tol1 = 1e-5 * want1.abs().max().item()
        cg = c // GROUPS
        m4 = torch.from_numpy(np.tile(np.repeat(np.eye(GROUPS), cg, axis=0) / cg,
                                      (4, 1)).T.astype(np.float32)).cuda()
        lib = torch.matmul(premul, m4.T)                       # [P, G]
        err_lib = (lib.T.reshape(GROUPS, b * n, hw) - want1).abs().max().item()
        nbytes1 = 4 * (premul.numel() + got1.numel())
        ops1 = premul.numel() + got1.numel()
        k1 = {"ms": time_ms(lambda: corr_epilogue(premul, b * n, GROUPS)),
              "plain_ms": time_ms(lambda: corr_epilogue_plain(premul, b * n, GROUPS)),
              "library_ms": time_ms(lambda: torch.matmul(premul, m4.T))}
        k1["bound_ms"], k1["bound_by"] = bound_ms(nbytes1, ops1)

        for kname, rec, err, tol, nbytes, ops in (
                ("sweep_premul", k2, err2, tol2, nbytes2, ops2),
                ("corr_epilogue", k1, err1, tol1, nbytes1, ops1)):
            line = {"kernel": kname, "shape": name, "batch": b, "n": n, "hw": hw,
                    "src_hw": [h1, w1], "c": c, "launches_per_map": launches,
                    "max_abs_err": err, "tol": tol, **rec}
            if kname == "corr_epilogue":
                line["library_max_abs_err"] = err_lib
            print(json.dumps(line))
            if not err <= tol:
                raise SystemExit(f"{kname} at {name}: max |kernel - plain| {err} > {tol}")
            tot = per_map[kname]
            for key in ("ms", "plain_ms", "bound_ms"):
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
def launch_counts():
    return {"sweep_premul": sweep_premul.launches,
            "corr_epilogue": corr_epilogue.launches,
            "fusion_consistency": consistency.launches}


def reset_launch_counts():
    sweep_premul.launches = 0
    corr_epilogue.launches = 0
    consistency.launches = 0


def _category(name):
    if "sweep_premul" in name or "corr_epilogue" in name:
        return name.split("::")[-1].split("_kernel")[0]
    if "Memcpy" in name or "Memset" in name:
        return "memcpy"
    if "bn_" in name or "batch_norm" in name:
        return "batch_norm"
    if any(s in name for s in ("conv", "xmma", "gemm", "wgrad", "dgrad")):
        return "convolution"
    return "other"


def profile_maps(model, samples, outdir, unprofiled_wall):
    """Device time by kernel over the same maps as the timed run
    (torch.profiler, kernel and copy events only). The idle share is
    taken against the timed run's own wall time, since tracing slows the
    host."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_depth(model, samples, outdir, "cuda", log=lambda *_: None)
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
    busy_ms = sum(by_cat.values()) / 1e3
    if not busy_ms:
        print(json.dumps({"profile": "device time not measured"}))
        return
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    maps = len(samples)
    print(json.dumps({
        "profile_maps": maps, "device_busy_ms_per_map": busy_ms / maps,
        "wall_ms_per_map_unprofiled": unprofiled_wall * 1e3 / maps,
        "device_idle_share": max(0.0, 1 - busy_ms / (unprofiled_wall * 1e3)),
        "by_category_ms_per_map": {k: v / 1e3 / maps for k, v in
                                   sorted(by_cat.items(), key=lambda kv: -kv[1])},
        "top_ms_per_map": [{"name": k[:90], "calls_per_map": c / maps,
                            "device_ms": t / 1e3 / maps} for k, (c, t) in top]}))


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

    with tempfile.TemporaryDirectory() as tmp:
        warm = run_depth(model, samples[:1], os.path.join(tmp, "warm"), "cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        outdir = os.path.join(tmp, "out")
        reset_launch_counts()
        t0 = time.perf_counter()
        secs = run_depth(model, samples, outdir, "cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated()

        expected = sum(s[-1] for s in shapes) * len(samples)
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
        print(json.dumps({"maps": len(samples), "wall_s": wall,
                          "maps_per_s": len(samples) / wall, "per_map_s": secs,
                          "warmup_s": warm, "peak_mem_gib": peak / 2 ** 30,
                          "launches": counts, "expected_launches": expected,
                          "depth_check": errs}))
        bad = [e for e in errs if not e["median_abs_err_vs_gt"] < 0.05]
        if bad:
            raise SystemExit(f"depth check failed: {bad}")
        planned = {"sweep_premul": expected, "corr_epilogue": expected,
                   "fusion_consistency": 0}
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
        if fusion_counts != {"sweep_premul": 0, "corr_epilogue": 0,
                             "fusion_consistency": VIEWS}:
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

    sources = {"corr_epilogue": ("itermvs_tpu_torch/csrc/corr_epilogue.cu",
                                 "itermvs_tpu/ops/sweep_epilogue.py:61"),
               "sweep_premul": ("itermvs_tpu_torch/csrc/sweep_premul.cu",
                                "itermvs_tpu/ops/grid_sample.py:472"),
               "fusion_consistency": ("itermvs_tpu_torch/csrc/fusion_consistency.cu",
                                      "itermvs_tpu/fusion.py:57")}
    report = []
    for name in ("corr_epilogue", "sweep_premul"):
        tot = per_map[name]
        t_bytes, t_ops = tot["bytes"] / PEAK_BYTES_PER_S, tot["ops"] / PEAK_F32_PER_S
        report.append({
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": counts[name],
            "max_abs_err": tot["max_abs_err"], "ms": tot["ms"],
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
    print(json.dumps({"kernels": report}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
