#!/usr/bin/env python3
"""Time K1 (corr_epilogue) and K2 (sweep_premul), float32 and bfloat16
forms, of one checkout of the port on the card, so that two checkouts
can be compared in one run:

    python3 itermvs_tpu_torch/tools/time_sweep_fwd.py [--tree DIR]

DIR is the root of a checkout (default: the one this script lies in).
Its own `chip_smoke.py` gives the sweep shapes of a 1600x1152 depth map
(N = 5, 4 iterations) and of a 640x512, batch 4 training step
(`sweep_shapes`, with the chunk plan of each dtype), the inputs
(`sweep_inputs`), the bound (`bound_ms`) and the timer (`median_ms`);
its own `itermvs_tpu_torch` gives the kernels, built inside that
checkout, and their plain versions. Each kernel is launched bare through
its C launcher into an output allocated beforehand (the wrappers add an
allocation). Per kernel, dtype and shape the script first holds the
kernel against its plain version (K2: 1e-6 of max|plain| in float32, bit
for bit in bfloat16; K1 on K2's output: 1e-5 of max|plain| in float32,
1e-6 in bfloat16), then prints one JSON line: `ms`, the median, min and
max of 7 rounds of 20 launches, the bound, the share of it (bound over
the median), and for K1 one `torch.matmul` of the same product in the
same dtype (`library_ms`, timed the same way) and `vs_library` (K1's
median over the matmul's). The last JSON line per map and per step has
the totals (each shape's median times its launches). Exits non-zero
without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=REPO, help="root of the checkout to time")
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))

    import torch
    if not torch.cuda.is_available():
        print("time_sweep_fwd: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from itermvs_tpu_torch import kernels
    from itermvs_tpu_torch.ops.sweep import sweep_premul_plain
    from itermvs_tpu_torch.ops.sweep_epilogue import corr_epilogue_plain

    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    cells = (("map", (cs.WIDTH, cs.HEIGHT, cs.VIEWS, cs.ITERATION, 1)),
             ("step", (cs.TRAIN_WIDTH, cs.TRAIN_HEIGHT, cs.TRAIN_VIEWS,
                       cs.TRAIN_ITERATION, cs.TRAIN_BATCH)))
    for per, config in cells:
        for dtype in (torch.float32, torch.bfloat16):
            size = torch.tensor([], dtype=dtype).element_size()
            k1, k2 = (cs.kernel_name(k, dtype) for k in ("corr_epilogue", "sweep_premul"))
            fn1, fn2 = kernels.function(k1), kernels.function(k2)
            totals = {k2: 0.0, k1: 0.0, f"{k2}_bound": 0.0, f"{k1}_bound": 0.0,
                      "matmul": 0.0}
            for name, b, n, h, w, h1, w1, c, launches in cs.sweep_shapes(
                    *config, itemsize=size):
                hw = h * w
                p = n * hw
                src, base, taps, ref = cs.sweep_inputs(b, n, h, w, h1, w1, c, gen, dtype=dtype)
                premul = torch.empty(b, p, 4 * c, dtype=dtype, device="cuda")
                corr = torch.empty(cs.GROUPS, b * p, device="cuda")

                def launch2():
                    kernels.check_launch(k2, fn2(
                        src.data_ptr(), base.data_ptr(), taps.data_ptr(), ref.data_ptr(),
                        premul.data_ptr(), b, p, hw, h1, w1, c,
                        torch.cuda.current_stream().cuda_stream))

                def launch1():
                    kernels.check_launch(k1, fn1(
                        premul.data_ptr(), corr.data_ptr(), b * p, c, cs.GROUPS,
                        torch.cuda.current_stream().cuda_stream))

                launch2()
                want = sweep_premul_plain(src, base, taps, ref, n)
                if dtype == torch.bfloat16:
                    ok = torch.equal(premul.view(torch.int16), want.view(torch.int16))
                else:
                    ok = ((premul - want).abs().max() <= 1e-6 * want.abs().max()).item()
                if not ok:
                    raise SystemExit(f"{k2} at {name} ({per}): differs from its plain version")
                del want
                flat = premul.reshape(b * p, 4 * c)
                launch1()
                want1 = corr_epilogue_plain(flat, b * n, cs.GROUPS).reshape(cs.GROUPS, b * p)
                err = (corr - want1).abs().max().item()
                tol = (1e-5 if dtype == torch.float32 else 1e-6) * want1.abs().max().item()
                if not err <= tol:
                    raise SystemExit(f"{k1} at {name} ({per}): max |kernel - plain| {err} > {tol}")
                cg = c // cs.GROUPS
                m4 = torch.from_numpy(np.tile(np.repeat(np.eye(cs.GROUPS), cg, axis=0) / cg,
                                              (4, 1))).cuda().to(dtype)      # [4C, G]

                bytes2 = size * (src.numel() + taps.numel() + ref.numel() + premul.numel()) \
                    + 4 * base.numel()
                bytes1 = size * premul.numel() + 4 * corr.numel()
                for kname, launch, nbytes, ops in (
                        (k2, launch2, bytes2, 2 * premul.numel()),
                        (k1, launch1, bytes1, premul.numel() + corr.numel())):
                    ms = cs.median_ms(launch, args.rounds, args.reps)
                    bound, bound_by = cs.bound_ms(nbytes, ops)
                    line = {"tree": args.tree, "kernel": kname, "shape": name, "per": per,
                            "batch": b, "n": n, "hw": hw, "src_hw": [h1, w1], "c": c,
                            "launches": launches, "ms": ms, "bound_ms": bound,
                            "bound_by": bound_by, "share": bound / ms[0],
                            "rounds": args.rounds, "reps": args.reps}
                    if kname == k1:
                        lib = cs.median_ms(lambda: torch.matmul(flat, m4), args.rounds,
                                           args.reps)
                        line.update(max_abs_err=err, tol=tol, library_ms=lib,
                                    vs_library=ms[0] / lib[0])
                        totals["matmul"] += launches * lib[0]
                    print(json.dumps(line), flush=True)
                    totals[kname] += launches * ms[0]
                    totals[f"{kname}_bound"] += launches * bound
                del src, base, taps, ref, premul, corr, flat, want1
                torch.cuda.empty_cache()
            totals["vs_library"] = totals[k1] / totals["matmul"]
            totals[f"{k2}_share"] = totals[f"{k2}_bound"] / totals[k2]
            totals[f"{k1}_share"] = totals[f"{k1}_bound"] / totals[k1]
            print(json.dumps({"tree": args.tree, "dtype": str(dtype), f"ms_per_{per}": totals}),
                  flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
