#!/usr/bin/env python3
"""Time K9 (convex_upsample) and K10 (convex_upsample_grad), float32 and
bfloat16 forms, of this checkout against those of other checkouts, in
one process on the card:

    python3 itermvs_tpu_torch/tools/time_upsample.py --tree DIR [--tree DIR ...]

Each DIR is the root of another checkout (a `git archive` of the parent
unpacked under the ignored `_export/`, or a copy with one source
edited). Its `itermvs_tpu_torch/csrc/convex_upsample.cu` and
`convex_upsample_grad.cu` are compiled with this checkout's nvcc flags
into this checkout's `itermvs_tpu_torch/_build/` (`other_tree.library`)
and bound through the same C signatures (every checkout since K9 exists
exports the same four launchers). The inputs, plain versions, gates,
bound and timer are this checkout's (`chip_smoke.upsample_inputs`,
`convex_upsample_plain`, `convex_upsample_grad_plain`, `hold_grad`,
`upsample_work`, `bound_ms`, `median_ms`).

Per case, the 1600x1152 map's call ([1, 144, 288, 400]: K9) and the
640x512 batch-4 training step's ([4, 144, 128, 160]: K9 and K10), in
each dtype: every version is first held against the plain version (K9
within chip_smoke.UPSAMPLE_TOL; K10 against the float64 formula under
`hold_grad`, and launched twice bit for bit), then its bare launches
(outputs and K10's scratch allocated beforehand) are timed in turns
(this checkout, the others, the others in reverse, this checkout; each
turn the median, min and max of `--rounds` rounds of `--reps`
launches). Those launches run back to back on the same inputs, which
then partly stay in the 50 MB L2 cache (the map's bf16 call reads 33 MB,
the step's 24 MB); `cold_ms` is the median of `--reps` launches each
after a 256 MiB write that evicts them, timed launch by launch. This
checkout's wrapper is timed too (`call_ms`). One JSON line per kernel
and case: per version its turns, `ms` (the mean of its turns' medians),
`cold_ms`, the share of the bound (of `ms`) and `device_us`, the profiler's
device time per launch of each of its kernel functions (K10: its main
kernel and its fold; a programmatic dependent launch counts from its
blocks' start, so its wait for the kernel before it is included), and
for K10 whether its fold is a programmatic dependent launch. Then each version's SASS
instruction count and registers per kernel function (`cuobjdump -sass`,
the ptxas report), and the card's name and power limit. Exits non-zero
without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCES = ("convex_upsample", "convex_upsample_grad")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", required=True,
                    help="root of another checkout (repeatable)")
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, REPO)

    import torch
    if not torch.cuda.is_available():
        print("time_upsample: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from itermvs_tpu_torch import kernels
    from itermvs_tpu_torch.ops.upsample import (
        convex_upsample_grad, convex_upsample_grad_plain, convex_upsample_plain,
        upsample_depth)
    from itermvs_tpu_torch.tools import other_tree

    kernels.build_all(SOURCES)
    libs = {"this": {s: kernels.library_path(s) for s in SOURCES}}
    for tree in args.tree:
        libs[os.path.abspath(tree)] = {s: other_tree.library(tree, s) for s in SOURCES}
    names = {n: kernels.SIGNATURES[n] for s in SOURCES for n in (s, f"{s}_bf16")}
    versions = {v: {n: other_tree.bind(lib[sig[2] if len(sig) > 2 else n], *sig[:2])
                    for n, sig in names.items()}
                for v, lib in libs.items()}
    order = list(versions)
    stream = lambda: torch.cuda.current_stream().cuda_stream
    cases = (("map", 1, cs.HEIGHT // 4, cs.WIDTH // 4, False),
             ("step", cs.TRAIN_BATCH, cs.TRAIN_HEIGHT // 4, cs.TRAIN_WIDTH // 4, True))
    for per, b, h, w, train in cases:
        for dtype in (torch.float32, torch.bfloat16):
            gen = torch.Generator(device="cuda")
            gen.manual_seed(cs.SEED + 4)
            x, logits = cs.upsample_inputs(b, h, w, gen, dtype)
            kname = cs.kernel_name("convex_upsample", dtype)
            want = convex_upsample_plain(x, logits)
            runs, errs = {}, {}
            for version, fns in versions.items():
                up = torch.empty(b, 1, 4 * h, 4 * w, device="cuda")

                def run(fn=fns[kname], up=up):
                    kernels.check_launch(kname, fn(logits.data_ptr(), x.data_ptr(),
                                                   up.data_ptr(), b, h, w, stream()))

                run()
                torch.cuda.synchronize()
                errs[version] = (up - want).abs().max().item()
                if not errs[version] <= cs.UPSAMPLE_TOL:
                    raise SystemExit(f"{kname} of {version} at {per}: max |kernel - plain| "
                                     f"{errs[version]} > {cs.UPSAMPLE_TOL}")
                runs[version] = run
            del want
            report(cs, kname, per, b, h, w, dtype, False, runs, order, args,
                   cs.median_ms(lambda: upsample_depth(x, logits), args.rounds, args.reps),
                   {"max_abs_err": errs})
            if not train:
                continue

            gname = cs.kernel_name("convex_upsample_grad", dtype)
            grad = torch.randn(b, 1, 4 * h, 4 * w, device="cuda", generator=gen)
            exact_x, exact_l = convex_upsample_grad_plain(
                x.double(), logits.double(), grad.double(), torch.float64)
            exact_x, exact_l = exact_x.float(), exact_l.to(dtype)
            runs, errs = {}, {}
            for version, fns in versions.items():
                d_x, d_logits = torch.empty_like(x), torch.empty_like(logits)
                partial = torch.empty(b, 9, h, w, device="cuda")

                def run(fn=fns[gname], d_x=d_x, d_logits=d_logits, partial=partial):
                    kernels.check_launch(gname, fn(
                        logits.data_ptr(), x.data_ptr(), grad.data_ptr(), d_logits.data_ptr(),
                        partial.data_ptr(), d_x.data_ptr(), b, h, w, stream()))

                run()
                first_x, first_l = d_x.clone(), d_logits.clone()
                run()
                torch.cuda.synchronize()
                if not (torch.equal(first_x, d_x)
                        and torch.equal(cs.bits(first_l), cs.bits(d_logits))):
                    raise SystemExit(f"{gname} of {version} at {per}: two launches differ")
                errs[version] = {}
                for label, got, exact in (("d_logits", d_logits, exact_l), ("d_x", d_x, exact_x)):
                    e, scale = cs.hold_grad(gname, got, exact, f"{version} {label}")
                    errs[version][label] = e / max(scale, 1e-30)
                runs[version] = run
            del exact_x, exact_l
            report(cs, gname, per, b, h, w, dtype, True, runs, order, args,
                   cs.median_ms(lambda: convex_upsample_grad(x, logits, grad), args.rounds,
                                args.reps),
                   {"max_rel_err": errs, "two_launches_bit_equal": True,
                    "fold_programmatic": {
                        v: other_tree.query(lib["convex_upsample_grad"],
                                            "itermvs_convex_upsample_grad_programmatic")
                        for v, lib in libs.items()}})
            del x, logits, grad, runs
            torch.cuda.empty_cache()
    print(json.dumps({"sass_instructions": {v: {s: other_tree.sass_instructions(lib)
                                                for s, lib in ls.items()}
                                            for v, ls in libs.items()}}))
    print(json.dumps({"registers": {v: {s: other_tree.registers(lib) for s, lib in ls.items()}
                                    for v, ls in libs.items()}}))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())
    return 0


def report(cs, kname, per, b, h, w, dtype, grad, runs, order, args, call, gates):
    """Time `runs` in turns and print one JSON line."""
    turns = {v: [] for v in order}
    for v in order + order[::-1]:
        turns[v].append(cs.median_ms(runs[v], args.rounds, args.reps))
    bound, bound_by = cs.bound_ms(*cs.upsample_work(b, h, w, dtype, grad))
    line = {"kernel": kname, "per": per, "shape": [b, cs.CHANNELS, h, w], **gates,
            "bound_ms": bound, "bound_by": bound_by, "call_ms": call,
            "rounds": args.rounds, "reps": args.reps, "versions": {}}
    for v in order:
        mean = sum(t[0] for t in turns[v]) / len(turns[v])
        line["versions"][v] = {"turns_ms": turns[v], "ms": mean, "share": bound / mean,
                               "cold_ms": cold_ms(runs[v], args.reps),
                               "device_us": cs.device_us(runs[v], args.reps)}
    print(json.dumps(line), flush=True)


def cold_ms(run, reps):
    """Median ms of `reps` launches of `run`, each timed on its own after
    a 256 MiB write (more than the L2 cache). All are queued before the
    first is waited for: the write keeps the card busy while the host
    queues the launch behind it, so the host's launch time stays out."""
    import torch

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    torch.cuda.synchronize()
    for start, end in events:
        flush.zero_()
        start.record()
        run()
        end.record()
    torch.cuda.synchronize()
    return sorted(start.elapsed_time(end) for start, end in events)[reps // 2]


if __name__ == "__main__":
    sys.exit(main())
