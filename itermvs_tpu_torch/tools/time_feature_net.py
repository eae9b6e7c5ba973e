#!/usr/bin/env python3
"""Time FeatureNet's training forward and backward, host and device, for
this checkout and another in turns on the card:

    python3 itermvs_tpu_torch/tools/time_feature_net.py --tree DIR [--rounds 2]

DIR is the root of another checkout of the port (for example the parent
commit unpacked with `git archive` into `_export/parent`). Each round
runs DIR's FeatureNet and this checkout's, in alternating order (DIR,
this, this, DIR, ...), each in a fresh process that imports only its own
checkout's `itermvs_tpu_torch` and builds its own kernels. The input is
a training step's fold of views, 20 seeded images at 640x512 (batch 4 x
5 views), in train mode (batch statistics), float32 and bfloat16; one
step is the forward and the backward of the mean square of the three
feature levels.

Per round, checkout and dtype one JSON line, over 10 steps after 3
warm-up steps: the host's ms to enqueue a step (`enqueue_ms`: the call
returns before the device is done), its ms to the end of the device's
work (`step_ms`), the device's busy ms of one profiled step (kernel and
copy events), the kernels it launched, and the 12 host operations of
most self CPU time in that profile (the profiler's own overhead
included). Then, per checkout and dtype, the median, min and max of each
over the rounds, and the card's name and power limit. Exits non-zero
without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DTYPES = ("float32", "bfloat16")
METRICS = ("enqueue_ms", "step_ms", "busy_ms")
STEPS, WARM = 10, 3
IMAGES, HEIGHT, WIDTH = 20, 512, 640


def child(tree: str) -> int:
    """One round of one checkout: its own FeatureNet is timed."""
    sys.path.insert(0, tree)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from itermvs_tpu_torch import kernels
    from itermvs_tpu_torch.models.feature_net import FeatureNet
    from itermvs_tpu_torch.models.pipeline import disable_tf32

    kernels.build_all()
    disable_tf32()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    x = torch.rand(IMAGES, 3, HEIGHT, WIDTH, device="cuda", generator=gen) * 2 - 1
    out = {}
    for name in DTYPES:
        torch.manual_seed(0)
        net = FeatureNet(getattr(torch, name)).cuda().train()

        def step():
            feats = net(x)
            sum(f.float().square().mean() for f in feats.values()).backward()

        for _ in range(WARM):
            step()
        torch.cuda.synchronize()
        enqueue, total = [], []
        for _ in range(STEPS):
            t0 = time.perf_counter()
            step()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            enqueue.append(1e3 * (t1 - t0))
            total.append(1e3 * (time.perf_counter() - t0))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
        events = prof.events()
        ranges = {e.name for e in events if e.is_user_annotation}
        device = [e for e in events if e.device_type == DeviceType.CUDA and e.name not in ranges]
        top = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:12]
        out[name] = {"enqueue_ms": statistics.median(enqueue),
                     "step_ms": statistics.median(total),
                     "busy_ms": sum(e.time_range.elapsed_us() for e in device) / 1e3,
                     "kernels": sum(1 for e in device if "Memcpy" not in e.name
                                    and "Memset" not in e.name),
                     "top_self_cpu_ms": [[e.key[:60], e.count, e.self_cpu_time_total / 1e3]
                                         for e in top]}
        del net
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


def spread(values):
    return {"median": statistics.median(values), "min": min(values), "max": max(values)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", required=True, help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(os.path.abspath(args.tree))

    import torch
    if not torch.cuda.is_available():
        print("time_feature_net: no CUDA device", file=sys.stderr)
        return 1
    trees = (("other", os.path.abspath(args.tree)), ("this", REPO))
    runs = {(label, d): [] for label, _ in trees for d in DTYPES}
    for r in range(args.rounds):
        for label, root in (trees if r % 2 == 0 else trees[::-1]):
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                                   "--tree", root], capture_output=True, text=True, cwd=root)
            if proc.returncode != 0:
                print(proc.stdout[-2000:] + proc.stderr[-4000:], file=sys.stderr)
                raise SystemExit(f"time_feature_net: round {r} of {root} failed")
            rec = json.loads(proc.stdout.strip().splitlines()[-1])
            for d in DTYPES:
                runs[(label, d)].append(rec[d])
                print(json.dumps({"round": r, "tree": label, "root": root, "dtype": d,
                                  **rec[d]}), flush=True)
    for (label, d), recs in runs.items():
        print(json.dumps({"summary": label, "root": dict(trees)[label], "dtype": d,
                          "rounds": len(recs), "kernels": recs[0]["kernels"],
                          **{m: spread([x[m] for x in recs]) for m in METRICS}}))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
