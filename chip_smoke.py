#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Checks for a CUDA device and prints its name and power limit.
2. Builds the port's CUDA kernels from itermvs_tpu_torch/csrc with nvcc.
3. Holds each kernel against its plain PyTorch version on the card at
   the 1600x1152 shapes of the depth path, and times kernel, plain
   version and (for corr_epilogue) one PyTorch call of the same function.
4. Runs the port's eval core loop (`itermvs_tpu_torch.eval.run_depth`)
   with the vendored DTU weights and the feature cache on a 5-view
   textured-plane scene made in memory at 1600x1152, one depth map per
   reference view, float32, 4 GRU iterations; reads the PFMs back and
   checks them against the scene's analytic depth; checks that each
   kernel launched as often as the chunk plan predicts; prints maps/s,
   and again for two more passes over the same maps.
5. Profiles the same maps once more with torch.profiler: device time
   by kernel and by kind, and the device's idle share.

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
from itermvs_tpu_torch.io import read_pfm
from itermvs_tpu_torch.models import Pipeline
from itermvs_tpu_torch.models.itermvs import (
    CORR_INTERVALS, GROUPS, LEVELS, NUM_INIT_SAMPLES)
from itermvs_tpu_torch.ops.sweep import sample_chunks, sweep_premul, sweep_premul_plain
from itermvs_tpu_torch.ops.sweep_epilogue import corr_epilogue, corr_epilogue_plain
from itermvs_tpu_torch.weights import load_npz_weights, pretrained_path

WIDTH, HEIGHT = 1600, 1152
VIEWS = 5
ITERATION = 4
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


def render_view(K, E, width, height):
    """(rgb [H,W,3] in [0,1], depth [H,W]) of the plane z = Z0."""
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
    depth = (s_hit * dirs[..., 2]).astype(np.float32)
    return _texture(pw[..., 0], pw[..., 1]).astype(np.float32), depth


def make_samples(width, height, views, seed):
    """One batch-1 sample per reference view, in the loader's layout
    (images quantized to uint8 and scaled to [-1, 1] as the loader does;
    only level_0 images, which is all the model reads), plus each view's
    analytic depth."""
    cams = make_cameras(views, width, height, np.random.RandomState(seed))
    imgs, depths, projs = [], [], []
    for K, E in cams:
        rgb, depth = render_view(K, E, width, height)
        u8 = (rgb * 255).astype(np.uint8)
        imgs.append(2.0 * u8.astype(np.float32) / 255.0 - 1.0)
        depths.append(depth)
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
    return samples, depths


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


def bound_ms(nbytes, ops):
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_PER_S
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


# ------------------------------------------------------------ end to end
def launch_counts():
    return {"sweep_premul": sweep_premul.launches,
            "corr_epilogue": corr_epilogue.launches}


def reset_launch_counts():
    sweep_premul.launches = 0
    corr_epilogue.launches = 0


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
            regs = [ln.strip() for ln in f if "registers" in ln or "spill" in ln]
        print(f"{name}: " + " | ".join(regs))

    model = load_npz_weights(Pipeline(iteration=ITERATION), pretrained_path("dtu")).cuda()
    shapes = sweep_shapes(WIDTH, HEIGHT, VIEWS, ITERATION)
    per_map = check_kernels(shapes)

    t0 = time.perf_counter()
    samples, gt_depths = make_samples(WIDTH, HEIGHT, VIEWS, SEED)
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
        if any(c != expected for c in counts.values()):
            raise SystemExit(f"launch counts {counts} != planned {expected}")

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
                                "itermvs_tpu/ops/grid_sample.py:472")}
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
    print(json.dumps({"kernels": report}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
