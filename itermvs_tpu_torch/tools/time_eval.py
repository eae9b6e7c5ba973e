#!/usr/bin/env python3
"""Time the eval core loop (`run_depth`) of this checkout and of another
in turns on the card, so that the two can be compared in one run:

    python3 itermvs_tpu_torch/tools/time_eval.py --tree DIR [--rounds 5]

DIR is the root of another checkout of the port (for example the parent
commit unpacked with `git archive` into `_export/parent`). Each round
runs DIR's `run_depth` and this checkout's, in alternating order (DIR,
this, this, DIR, ...), each in a fresh process that imports only its own
checkout's `itermvs_tpu_torch` and builds its own kernels. Both are fed
the same 5 maps of chip_smoke's textured-plane scene at 1600x1152, N = 5,
4 GRU iterations, batch 1, feature cache on, with the vendored DTU
weights, as page-locked tensors (as save_depth's loader delivers them on
a card), in float32 and in bfloat16.

Per round, checkout and dtype one JSON line: maps/s and the wall ms per
map over the 5 maps (after one warm-up map; first upload to last PFM on
disk), `run_depth`'s own per-batch ms, the device's busy ms per map
(torch.profiler over the same 5 maps, kernel and copy events) and the
idle share (busy time against the unprofiled wall time). Then, per
checkout and dtype, the median, min and max of each over the rounds,
and the card's name and power limit. Exits non-zero without a CUDA
device.
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DTYPES = ("float32", "bfloat16")
METRICS = ("maps_per_s", "wall_ms_per_map", "busy_ms_per_map", "idle_share")


def busy_ms(fn):
    """Device busy ms of `fn`: the kernel and copy events torch.profiler
    records, without the device-side spans of record_function ranges."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    ranges = {e.name for e in events if e.is_user_annotation}
    return sum(e.time_range.elapsed_us() for e in events
               if e.device_type == DeviceType.CUDA and e.name not in ranges) / 1e3


def child(tree: str, data: str) -> int:
    """One round of one checkout: its own package times the maps."""
    sys.path.insert(0, tree)
    import torch

    from itermvs_tpu_torch import kernels
    from itermvs_tpu_torch.eval import run_depth
    from itermvs_tpu_torch.models import Pipeline
    from itermvs_tpu_torch.weights import load_npz_weights, pretrained_path

    kernels.build_all()
    with open(data, "rb") as f:
        iteration, samples = pickle.load(f)

    def pin(x):
        return torch.from_numpy(x).pin_memory()

    samples = [dict(s, imgs={k: pin(v) for k, v in s["imgs"].items()},
                    proj_matrices={k: pin(v) for k, v in s["proj_matrices"].items()},
                    depth_min=pin(s["depth_min"]), depth_max=pin(s["depth_max"]))
               for s in samples]
    quiet = lambda *_: None
    out = {}
    for name in DTYPES:
        model = load_npz_weights(Pipeline(iteration=iteration, dtype=getattr(torch, name)),
                                 pretrained_path("dtu")).cuda()
        with tempfile.TemporaryDirectory() as tmp:
            run_depth(model, samples[:1], os.path.join(tmp, "warm"), "cuda", log=quiet)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batch_s = run_depth(model, samples, os.path.join(tmp, "timed"), "cuda", log=quiet)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            busy = busy_ms(lambda: run_depth(model, samples, os.path.join(tmp, "prof"),
                                             "cuda", log=quiet))
        maps = len(samples)
        out[name] = {"maps_per_s": maps / wall, "wall_ms_per_map": 1e3 * wall / maps,
                     "batch_ms": [1e3 * s for s in batch_s],
                     "busy_ms_per_map": busy / maps,
                     "idle_share": max(0.0, 1 - busy / (1e3 * wall))}
        del model
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


def spread(values):
    return {"median": statistics.median(values), "min": min(values), "max": max(values)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", required=True, help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--data", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(os.path.abspath(args.tree), args.data)

    import torch
    if not torch.cuda.is_available():
        print("time_eval: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    trees = (("other", os.path.abspath(args.tree)), ("this", REPO))
    runs = {(label, d): [] for label, _ in trees for d in DTYPES}
    with tempfile.TemporaryDirectory() as tmp:
        cams, images, _ = cs.render_scene(cs.WIDTH, cs.HEIGHT, cs.VIEWS, cs.SEED)
        data = os.path.join(tmp, "samples.pkl")
        with open(data, "wb") as f:
            pickle.dump((cs.ITERATION, cs.samples_of(cams, images)), f)
        for r in range(args.rounds):
            for label, root in (trees if r % 2 == 0 else trees[::-1]):
                proc = subprocess.run(
                    [sys.executable, os.path.abspath(__file__), "--child", "--tree", root,
                     "--data", data], capture_output=True, text=True, cwd=root)
                if proc.returncode != 0:
                    print(proc.stdout[-2000:] + proc.stderr[-4000:], file=sys.stderr)
                    raise SystemExit(f"time_eval: round {r} of {root} failed")
                rec = json.loads(proc.stdout.strip().splitlines()[-1])
                for d in DTYPES:
                    runs[(label, d)].append(rec[d])
                    print(json.dumps({"round": r, "tree": label, "root": root, "dtype": d,
                                      **rec[d]}), flush=True)
    for (label, d), recs in runs.items():
        print(json.dumps({"summary": label, "root": dict(trees)[label], "dtype": d,
                          "rounds": len(recs),
                          **{m: spread([x[m] for x in recs]) for m in METRICS}}))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
