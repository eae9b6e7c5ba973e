#!/usr/bin/env python3
"""Time K4 (sweep_grad_ref) and K5 (sweep_grad_src) of one checkout of
the port on the card, in float32 or in their bfloat16 forms, so that two
checkouts can be compared in one run:

    python3 itermvs_tpu_torch/tools/time_sweep_grad.py [--tree DIR] [--dtype bfloat16]

DIR is the root of a checkout (default: the one this script lies in).
Its own `chip_smoke.py` gives the four sweep shapes of a 640x512, batch
4, 5-view, 4-iteration training step (`sweep_shapes`), the inputs
(`sweep_inputs` in the chosen dtype and a seeded grad_corr), the bound
(`bound_ms`), the timer (`median_ms`), the limit (`hold_grad`: 1e-5 of
max|plain|, plus one bf16 step of |plain| for a bf16 result) and the
bare launches (`grad_launchers`, the ones its `check_grad_kernels`
times; K5's bf16 form sums into a float32 scratch allocated here); its
own `itermvs_tpu_torch` gives the kernels, built inside that checkout,
and their plain versions. Per kernel and shape the script holds the
kernel against the plain version, then prints one JSON line: `ms`, the
median, min and max of 7 rounds of 20 bare launches (outputs allocated
beforehand), the bound, the share of it, and the device time of a
launch by kernel and memset (`device_us_by_name`, the mean of 5 profiled
launches, summed in `device_ms`: where a kernel takes less time than the
host needs to launch it, `ms` is the launch rate and `device_ms` the
card's own time). The last JSON line has the per-step totals (each
shape's median times its launches per step; `*_device` the same of
`device_ms`).

With `--captures FILE` the kernels run on the sweeps of one training
step of the model itself instead (`chip_smoke.capture_sweeps`: a fresh
seeded init at the same recipe, in the chosen dtype): FILE is written
by the first run that names it, with that checkout's chip_smoke, and
read by the others, so that every checkout of one call times the same
inputs. Per shape, the line then gives the mean over its captures of
each capture's median; the per-step totals are the sums over all
captures. Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PROFILED = 5        # launches profiled per kernel and shape


def step_captures(cs, dtype):
    """The sweeps of one training step at chip_smoke's full-width recipe,
    from a fresh seeded init in `dtype` (`cs.capture_sweeps`)."""
    import torch
    from itermvs_tpu_torch.engine.train_loop import init_weights, to_device_batch
    from itermvs_tpu_torch.models import Pipeline
    sample = cs.train_sample(cs.TRAIN_WIDTH, cs.TRAIN_HEIGHT, cs.TRAIN_VIEWS,
                             cs.TRAIN_BATCH, cs.SEED)
    model = init_weights(Pipeline(iteration=cs.TRAIN_ITERATION, test=False, dtype=dtype),
                         cs.SEED).cuda()
    captures = cs.capture_sweeps(model, to_device_batch(sample, "cuda"), cs.TRAIN_ITERATION)
    del model
    torch.cuda.empty_cache()
    return captures


def time_captures(cs, sg, args, captures, name, b, n, hw, h1, w1, c, dtype, totals):
    """Hold and time both kernels on the captures of one sweep shape; one
    JSON line; adds each capture's median to `totals`."""
    import torch
    mine = [t for t in captures if tuple(t[0].shape) == (b, h1, w1, c)
            and tuple(t[4].shape) == (b, n, cs.GROUPS, hw)]
    ms = {}
    for src, ref, base, taps, grad in mine:
        outs = {"sweep_grad_ref": torch.empty(b, hw, c, device="cuda", dtype=dtype),
                "sweep_grad_src": torch.empty(b, h1, w1, c, device="cuda", dtype=dtype)}
        scratch = (None if dtype == torch.float32
                   else torch.empty(b, h1, w1, c, device="cuda"))
        bare = cs.grad_launchers(src, base, taps, ref, grad, *outs.values(), scratch)
        want = {"sweep_grad_ref": sg.sweep_grad_ref_plain(src, base, taps, grad),
                "sweep_grad_src": sg.sweep_grad_src_plain(ref, base, taps, grad, h1, w1)}
        for kname, launch in bare.items():
            launch()
            torch.cuda.synchronize()
            cs.hold_grad(kname, outs[kname], want[kname], f"{name}, captured sweep")
            key = cs.kernel_name(kname, dtype)
            ms.setdefault(key, []).append(cs.median_ms(launch, args.rounds, args.reps)[0])
        del outs, scratch, bare, want
    for key, times in ms.items():
        print(json.dumps({"tree": args.tree, "kernel": key, "shape": name,
                          "inputs": "captured", "captures": len(times),
                          "ms_mean": sum(times) / len(times), "ms_min": min(times),
                          "ms_max": max(times)}), flush=True)
        totals[key] = totals.get(key, 0.0) + sum(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=REPO, help="root of the checkout to time")
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32",
                    help="the kernels' form: float32, or bfloat16 features and taps")
    ap.add_argument("--captures", help="time on one training step's own sweeps, kept "
                    "in this file (written if missing)")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))

    import torch
    if not torch.cuda.is_available():
        print("time_sweep_grad: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from itermvs_tpu_torch.ops import sweep_grad as sg

    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED + 1)
    dtype = getattr(torch, args.dtype)
    size = torch.tensor([], dtype=dtype).element_size()

    shapes = cs.sweep_shapes(cs.TRAIN_WIDTH, cs.TRAIN_HEIGHT, cs.TRAIN_VIEWS,
                             cs.TRAIN_ITERATION, cs.TRAIN_BATCH, itemsize=size)
    captures = None
    if args.captures and os.path.exists(args.captures):
        captures = torch.load(args.captures, map_location="cuda")
    elif args.captures:
        captures = step_captures(cs, dtype)
        torch.save(captures, args.captures)
    totals = {"bound_ms_per_step": 0.0}
    for name, b, n, h, w, h1, w1, c, launches in shapes:
        launches //= len(cs.sample_chunks(b, n, h * w, c, itemsize=size))   # one per sweep
        hw = h * w
        if captures is not None:
            time_captures(cs, sg, args, captures, name, b, n, hw, h1, w1, c, dtype, totals)
            continue
        src, base, taps, ref = cs.sweep_inputs(b, n, h, w, h1, w1, c, gen, dtype=dtype)
        grad = torch.randn(b, n, cs.GROUPS, hw, device="cuda", generator=gen)
        ops = float(c * (1 + 2 * cs.valid_corners(base, h1, w1).sum().item()))
        nbytes = (4 * (base.numel() + grad.numel())
                  + size * (taps.numel() + src.numel() + ref.numel()))
        bound, bound_by = cs.bound_ms(nbytes, ops)
        outs = {"sweep_grad_ref": torch.empty(b, hw, c, device="cuda", dtype=dtype),
                "sweep_grad_src": torch.empty(b, h1, w1, c, device="cuda", dtype=dtype)}
        scratch = (None if dtype == torch.float32
                   else torch.empty(b, h1, w1, c, device="cuda"))
        bare = cs.grad_launchers(src, base, taps, ref, grad, *outs.values(), scratch)
        want = {"sweep_grad_ref": sg.sweep_grad_ref_plain(src, base, taps, grad),
                "sweep_grad_src": sg.sweep_grad_src_plain(ref, base, taps, grad, h1, w1)}
        for kname, launch in bare.items():
            out = outs[kname]
            launch()
            torch.cuda.synchronize()
            err, scale = cs.hold_grad(kname, out, want[kname], name)
            ms = cs.median_ms(launch, args.rounds, args.reps)
            line = {"tree": args.tree, "kernel": cs.kernel_name(kname, dtype), "shape": name,
                    "batch": b, "n": n, "hw": hw, "src_hw": [h1, w1], "c": c,
                    "launches_per_step": launches, "max_rel_err": err / scale,
                    "ms": ms, "bound_ms": bound, "bound_by": bound_by,
                    "share_of_bound": bound / ms[0], "rounds": args.rounds, "reps": args.reps}
            by_name, _, busy_ms = cs.device_time(lambda: [launch() for _ in range(PROFILED)])
            busy_ms /= PROFILED
            line["device_us_by_name"] = {k[:40]: us / PROFILED for k, (_, us) in by_name.items()}
            line["device_ms"] = busy_ms
            print(json.dumps(line), flush=True)
            key = cs.kernel_name(kname, dtype)
            totals[key] = totals.get(key, 0.0) + launches * ms[0]
            totals[f"{key}_device"] = totals.get(f"{key}_device", 0.0) + launches * busy_ms
        totals["bound_ms_per_step"] += launches * bound
        del src, base, taps, ref, grad, want, outs, bare, scratch
        torch.cuda.empty_cache()
    print(json.dumps({"tree": args.tree, "ms_per_step": totals}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
