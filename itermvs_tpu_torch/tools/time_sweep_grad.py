#!/usr/bin/env python3
"""Time K4 (sweep_grad_ref) and K5 (sweep_grad_src) of one checkout of
the port on the card, so that two checkouts can be compared in one run:

    python3 itermvs_tpu_torch/tools/time_sweep_grad.py [--tree DIR]

DIR is the root of a checkout (default: the one this script lies in).
Its own `chip_smoke.py` gives the four sweep shapes of a 640x512, batch
4, 5-view, 4-iteration training step (`sweep_shapes`), the inputs
(`sweep_inputs` and a seeded grad_corr), the bound (`bound_ms`), the
timer (`median_ms`) and the bare launches (`grad_launchers`, the ones
its `check_grad_kernels` times); its own `itermvs_tpu_torch` gives the
kernels, built inside that checkout, and their plain versions. A
checkout whose chip_smoke has no `grad_launchers` has a K5 launcher
that adds into a zeroed output: it is launched through its raw C
launchers, K5's output zero-filled in the round as its wrapper did
(`older_launchers`). Per kernel and shape the script holds the kernel
against the plain version (1e-5 of max|plain|), then prints one JSON
line: `ms`, the median, min and max of 7 rounds of 20 bare launches
(outputs allocated beforehand), the bound, the share of it, and one
launch profiled by device kernel and memset (`device_us_by_name`). The
last JSON line has the per-step totals (each shape's median times its
launches per step). Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def older_launchers(kernels, groups):
    """`grad_launchers` for a checkout whose chip_smoke lacks it: the raw
    C launchers on the current stream, K5's output zero-filled before its
    launch (that launcher adds into it)."""
    import torch
    fn_ref = kernels.function("sweep_grad_ref")
    fn_src = kernels.function("sweep_grad_src")

    def launchers(src, base, taps, ref, grad, d_ref, d_src):
        b, h1, w1, c = src.shape
        n, hw = grad.shape[1], grad.shape[3]

        def sizes():
            return (b, n, hw, h1, w1, c, groups, torch.cuda.current_stream().cuda_stream)

        def launch_ref():
            kernels.check_launch("sweep_grad_ref", fn_ref(
                src.data_ptr(), base.data_ptr(), taps.data_ptr(), grad.data_ptr(),
                d_ref.data_ptr(), *sizes()))

        def launch_src():
            d_src.zero_()
            kernels.check_launch("sweep_grad_src", fn_src(
                ref.data_ptr(), base.data_ptr(), taps.data_ptr(), grad.data_ptr(),
                d_src.data_ptr(), *sizes()))

        return {"sweep_grad_ref": launch_ref, "sweep_grad_src": launch_src}
    return launchers


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=REPO, help="root of the checkout to time")
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))

    import torch
    if not torch.cuda.is_available():
        print("time_sweep_grad: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from itermvs_tpu_torch import kernels
    from itermvs_tpu_torch.ops import sweep_grad as sg

    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED + 1)
    launchers = getattr(cs, "grad_launchers", None) or older_launchers(kernels, cs.GROUPS)

    shapes = cs.sweep_shapes(cs.TRAIN_WIDTH, cs.TRAIN_HEIGHT, cs.TRAIN_VIEWS,
                             cs.TRAIN_ITERATION, cs.TRAIN_BATCH)
    totals = {"bound_ms_per_step": 0.0}
    for name, b, n, h, w, h1, w1, c, launches in shapes:
        launches //= len(cs.sample_chunks(b, n, h * w, c))      # one per sweep
        hw = h * w
        src, base, taps, ref = cs.sweep_inputs(b, n, h, w, h1, w1, c, gen)
        grad = torch.randn(b, n, cs.GROUPS, hw, device="cuda", generator=gen)
        ops = float(c * (1 + 2 * cs.valid_corners(base, h1, w1).sum().item()))
        nbytes = 4 * (base.numel() + taps.numel() + grad.numel() + src.numel() + ref.numel())
        bound, bound_by = cs.bound_ms(nbytes, ops)
        outs = {"sweep_grad_ref": torch.empty(b, hw, c, device="cuda"),
                "sweep_grad_src": torch.empty(b, h1, w1, c, device="cuda")}
        bare = launchers(src, base, taps, ref, grad, *outs.values())
        want = {"sweep_grad_ref": sg.sweep_grad_ref_plain(src, base, taps, grad),
                "sweep_grad_src": sg.sweep_grad_src_plain(ref, base, taps, grad, h1, w1)}
        for kname, launch in bare.items():
            out = outs[kname]
            launch()
            torch.cuda.synchronize()
            err = (out - want[kname]).abs().max().item()
            scale = want[kname].abs().max().item()
            if not err <= 1e-5 * scale:
                raise SystemExit(f"{kname} at {name}: max |kernel - plain| {err} > "
                                 f"1e-5 * {scale}")
            ms = cs.median_ms(launch, args.rounds, args.reps)
            line = {"tree": args.tree, "kernel": kname, "shape": name,
                    "batch": b, "n": n, "hw": hw, "src_hw": [h1, w1], "c": c,
                    "launches_per_step": launches, "max_rel_err": err / scale,
                    "ms": ms, "bound_ms": bound, "bound_by": bound_by,
                    "share_of_bound": bound / ms[0], "rounds": args.rounds, "reps": args.reps}
            by_name, _, _ = cs.device_time(launch)
            line["device_us_by_name"] = {k[:40]: us for k, (_, us) in by_name.items()}
            print(json.dumps(line), flush=True)
            totals[kname] = totals.get(kname, 0.0) + launches * ms[0]
        totals["bound_ms_per_step"] += launches * bound
        del src, base, taps, ref, grad, want, outs, bare
        torch.cuda.empty_cache()
    print(json.dumps({"tree": args.tree, "ms_per_step": totals}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
