#!/usr/bin/env python3
"""Device time of the eval maps and the training step, this tree against
others, on one card in one run.

    python3 itermvs_tpu_torch/tools/ab_profile.py --tree _export/parent [--out DIR]

Runs one process per tree in turns (each other tree, this tree, this
tree, each other tree), each from its own root with its own chip_smoke:
the 5 depth maps of chip_smoke's 1600x1152 scene in float32 and bfloat16
(one warm-up `run_depth`, one timed, then `chip_smoke.profile_maps`:
busy ms, idle share, kernels and device ms by kind per map, the labelled
chains), then `chip_smoke.train_full_width` in both dtypes (ms per step,
one profiled step by kind), then one more profiled training step per
dtype with the host ops' shapes, listing PyTorch's bilinear resizes,
softmaxes, var_mean calls and the eager loss's gathers and argmaxes left
in it (host ops and autograd nodes holding `upsample_bilinear2d`,
`softmax`, `var_mean`, `VarMean`, `gather` or `argmax` by input shapes,
and their device kernels, Welford reductions and `cunn_SoftMax*`
included). Each run's whole output goes to
`DIR/ab_profile_<run>_<tree>.log` (by default `_export/ab_profile/`);
the summary lines print here. Each profile's whole kernel table is logged
too, and its device time by kind is restated with this tree's
`chip_smoke._category` (`restated_by_category_ms`), so that every tree's
maps and steps are read under the same categories. A tree needs
chip_smoke's `profile_maps`, `train_full_width`, `render_scene` and
`device_summary`.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
MAPS = 5                    # chip_smoke's VIEWS: the maps profile_maps runs

RUN = r'''
import json, tempfile, time, torch
from torch.profiler import ProfilerActivity, profile
import chip_smoke as c
from itermvs_tpu_torch.engine.train_loop import (
    init_weights, make_optimizer, to_device_batch, train_step)
from itermvs_tpu_torch.eval import run_depth
from itermvs_tpu_torch.models import Pipeline
from itermvs_tpu_torch.weights import load_npz_weights, pretrained_path

c.kernels.build_all()
summarize = c.device_summary


def logged_summary(events):
    """chip_smoke's `device_summary`, its kernel table printed first."""
    out = summarize(events)
    print(json.dumps({"device_kernels": out[0]}))
    return out


c.device_summary = logged_summary
cams, images, _ = c.render_scene(c.WIDTH, c.HEIGHT, c.VIEWS, c.SEED)
samples = c.pinned(c.samples_of(cams, images))
quiet = lambda *_: None
for dt in (torch.float32, torch.bfloat16):
    model = load_npz_weights(Pipeline(iteration=c.ITERATION, dtype=dt),
                             pretrained_path("dtu")).cuda()
    with tempfile.TemporaryDirectory() as tmp:
        run_depth(model, samples, tmp + "/warm", "cuda", log=quiet)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_depth(model, samples, tmp + "/timed", "cuda", log=quiet)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print(json.dumps({"maps_per_s": len(samples) / wall, "dtype": str(dt)}))
        c.profile_maps(model, samples, tmp + "/prof", wall)
    del model
    torch.cuda.empty_cache()
for dt in (torch.float32, torch.bfloat16):
    c.train_full_width(c.sweep_shapes(c.TRAIN_WIDTH, c.TRAIN_HEIGHT, c.TRAIN_VIEWS,
                                      c.TRAIN_ITERATION, c.TRAIN_BATCH,
                                      itemsize=torch.finfo(dt).bits // 8), dt)
    torch.cuda.empty_cache()
batch = to_device_batch(c.train_sample(c.TRAIN_WIDTH, c.TRAIN_HEIGHT, c.TRAIN_VIEWS,
                                       c.TRAIN_BATCH, c.SEED), "cuda")
for dt in (torch.float32, torch.bfloat16):
    model = init_weights(Pipeline(iteration=c.TRAIN_ITERATION, test=False, dtype=dt),
                         c.SEED).cuda()
    opt = make_optimizer(model)
    step = lambda: train_step(model, opt, batch, c.TRAIN_LR, True, c.TRAIN_ITERATION)
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        step()
        torch.cuda.synchronize()
    host, device = {}, {}
    for e in prof.events():
        if not any(k in e.name for k in ("upsample_bilinear2d", "var_mean", "VarMean",
                                         "Welford", "gather", "Gather", "argmax",
                                         "ArgMax", "softmax", "Softmax", "SoftMax")):
            continue
        if e.device_type == torch.autograd.DeviceType.CUDA:
            calls, us = device.get(e.name[:90], (0, 0.0))
            device[e.name[:90]] = (calls + 1, us + e.time_range.elapsed_us())
        elif e.name.startswith(("aten::", "autograd::")):
            key = f"{e.name} {e.input_shapes}"
            host[key] = host.get(key, 0) + 1
    print(json.dumps({"listed_step": str(dt), "host": host,
                      "device": {k: {"calls": n, "device_ms": us / 1e3}
                                 for k, (n, us) in device.items()}}))
    del model, opt
    torch.cuda.empty_cache()
'''


def restate(table, per, category):
    """{kind: ms} of a logged kernel table ({name: (calls, µs)}) under
    `category`, over `per` maps or steps, and its kernels (copies aside)."""
    ms, kernels = {}, 0
    for name, (calls, us) in table.items():
        kind = category(name)
        ms[kind] = ms.get(kind, 0.0) + us / 1e3 / per
        kernels += calls if kind != "memcpy" else 0
    return {"restated_by_category_ms": dict(sorted(ms.items(), key=lambda kv: -kv[1])),
            "restated_kernels": kernels / per}


def summary(rec):
    """The fields of one output record worth printing here, or None."""
    if "maps_per_s" in rec or "listed_step" in rec:
        return rec
    if "profile_maps" in rec:
        return {k: rec[k] for k in ("dtype", "device_busy_ms_per_map", "device_idle_share",
                                    "kernels_per_map", "chains_per_map",
                                    "by_category_ms_per_map")}
    if "train" in rec and isinstance(rec["train"], dict):
        t = rec["train"]
        prof = t["profile_step"] if isinstance(t["profile_step"], dict) else {}
        return {"train": t["dtype"], "ms_per_step_last5": t["ms_per_step_last5"],
                "peak_mem_gib": t["peak_mem_gib"], "var_mean_events": t.get("var_mean_events"),
                **{k: prof.get(k) for k in ("device_busy_ms", "device_idle_share", "kernels",
                                            "chains_forward", "by_category_ms")}}
    return None


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", action="append", default=[],
                        help="another checkout's root (repeatable)")
    parser.add_argument("--out", default=os.path.join(ROOT, "_export", "ab_profile"),
                        help="directory for each run's whole output")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("ab_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from chip_smoke import _category

    trees = [os.path.abspath(t) for t in args.tree]
    order = trees + [ROOT, ROOT] + trees[::-1]
    out_dir = os.path.abspath(args.out)
    os.makedirs(out_dir, exist_ok=True)
    for run, tree in enumerate(order):
        label = "this" if tree == ROOT else os.path.basename(tree)
        proc = subprocess.run([sys.executable, "-c", RUN], cwd=tree, capture_output=True,
                              text=True)
        with open(os.path.join(out_dir, f"ab_profile_{run}_{label}.log"), "w") as f:
            f.write(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"ab_profile: run {run} ({label}) failed")
        table = None
        for line in proc.stdout.splitlines():
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict) and "device_kernels" in rec:
                table = rec["device_kernels"]
                continue
            out = summary(rec) if isinstance(rec, dict) else None
            if out is None:
                continue
            if table is not None and ("profile_maps" in rec or "train" in rec):
                out.update(restate(table, MAPS if "profile_maps" in rec else 1, _category))
            print(json.dumps({"run": run, "tree": label, **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
