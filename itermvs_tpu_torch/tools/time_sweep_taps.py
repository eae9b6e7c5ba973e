#!/usr/bin/env python3
"""Time K8 (sweep_taps), float32 and bfloat16 forms, of this checkout
against K8 of other checkouts, in one process on the card:

    python3 itermvs_tpu_torch/tools/time_sweep_taps.py --tree DIR [--tree DIR ...]

Each DIR is the root of another checkout. Its
`itermvs_tpu_torch/csrc/sweep_taps.cu` is compiled with this checkout's
nvcc flags into this checkout's `itermvs_tpu_torch/_build/`
(`other_tree.library`) and bound through the same C signature (every
checkout since K8 exists exports the same two launchers). The inputs,
plain version, bound and timer are this checkout's
(`chip_smoke.taps_cases`, `fused_sweep_taps_plain`, `bound_ms`,
`median_ms`).

Per sweep of a 1600x1152 depth map (N = 5: `init`, 32 samples on the
1/8 grid, once; `iter`, 10 samples over three levels on the 1/4 grid,
once per iteration) and of a 640x512, batch 4 training step, in each
dtype, every version is first held against the plain version bit for
bit (indices and taps), then its bare launches (outputs allocated
beforehand) are timed in turns (this checkout, the others, the others
in reverse, this checkout; each turn the median, min and max of
`--rounds` rounds of `--reps` launches). This checkout's wrapper is
timed too (`call_ms`), and beside it the same wrapper with its sample
table built anew on every call (`call_ms_table_rebuilt`, the host path
before the table was cached). One JSON line per sweep, then one per map
and per step with the totals (each sweep's mean of medians times its
launches), the bound and the share of it; then each version's SASS
instruction count per kernel (`cuobjdump -sass`). Exits non-zero
without a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


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
        print("time_sweep_taps: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from itermvs_tpu_torch import kernels
    from itermvs_tpu_torch.ops import warping
    from itermvs_tpu_torch.ops.warping import (
        fused_sweep_taps, fused_sweep_taps_plain, sample_table)
    from itermvs_tpu_torch.tools import other_tree

    names = ("sweep_taps", "sweep_taps_bf16")
    kernels.build_all(("sweep_taps",))
    libs = {"this": kernels.library_path("sweep_taps")}
    for tree in args.tree:
        libs[os.path.abspath(tree)] = other_tree.library(tree, "sweep_taps")
    versions = {v: {n: other_tree.bind(lib, *kernels.SIGNATURES[n][:2]) for n in names}
                for v, lib in libs.items()}
    order = list(versions)
    cells = (("map", cs.WIDTH, cs.HEIGHT, cs.VIEWS, 1, cs.ITERATION),
             ("step", cs.TRAIN_WIDTH, cs.TRAIN_HEIGHT, cs.TRAIN_VIEWS, cs.TRAIN_BATCH,
              cs.TRAIN_ITERATION))
    rebuilt = lambda *a: warping._sample_table.__wrapped__(
        tuple(a[0]), tuple(map(tuple, a[1])), *a[2:])
    for per, width, height, views, batch, iteration in cells:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(cs.SEED + 2)
        cases = [c for c in cs.taps_cases(width, height, views, batch, gen)
                 if c[0] in ("init", "iter")]
        for dtype in (torch.float32, torch.bfloat16):
            kname = cs.kernel_name("sweep_taps", dtype)
            size = torch.tensor([], dtype=dtype).element_size()
            total = {"bytes": 0, "ops": 0, "ms": {v: 0.0 for v in order}, "call_ms": 0.0,
                     "call_ms_table_rebuilt": 0.0}
            for name, rel, depth, levels, srcs, launches in cases:
                launches = iteration if launches is None else launches
                b, n, h, w = depth.shape
                v = rel.shape[1]
                want_idx, want_taps = fused_sweep_taps_plain(rel, depth, levels, srcs, dtype)
                table = sample_table(levels, srcs, h, w)
                runs = {}
                for version, fns in versions.items():
                    idx = torch.empty_like(want_idx)
                    taps = torch.empty_like(want_taps)

                    def run(fn=fns[kname], idx=idx, taps=taps):
                        kernels.check_launch(kname, fn(
                            rel.data_ptr(), depth.data_ptr(), idx.data_ptr(), taps.data_ptr(),
                            ctypes.byref(table), b, v, rel.shape[2], n, h, w, *depth.stride(),
                            torch.cuda.current_stream().cuda_stream))

                    run()
                    torch.cuda.synchronize()
                    if not (torch.equal(idx, want_idx)
                            and torch.equal(cs.bits(taps), cs.bits(want_taps))):
                        raise SystemExit(f"{kname} of {version} at {per} {name}: differs "
                                         f"from the plain version")
                    runs[version] = run
                turns = {ver: [] for ver in order}
                for ver in order + order[::-1]:
                    turns[ver].append(cs.median_ms(runs[ver], args.rounds, args.reps))
                call = cs.median_ms(lambda: fused_sweep_taps(rel, depth, levels, srcs, dtype),
                                    args.rounds, args.reps)
                saved = warping.sample_table
                warping.sample_table = rebuilt
                try:
                    call_rebuilt = cs.median_ms(
                        lambda: fused_sweep_taps(rel, depth, levels, srcs, dtype),
                        args.rounds, args.reps)
                finally:
                    warping.sample_table = saved
                nbytes = (depth.untyped_storage().nbytes() + 4 * rel.numel()
                          + want_idx.numel() * (4 + 4 * size))
                bound, bound_by = cs.bound_ms(nbytes, cs.K8_OPS * want_idx.numel())
                line = {"kernel": kname, "per": per, "shape": name, "batch": b, "views": v,
                        "n": n, "hw": [h, w], "launches": launches, "bit_equal": True,
                        "bound_ms": bound, "bound_by": bound_by, "call_ms": call,
                        "call_ms_table_rebuilt": call_rebuilt, "versions": {}}
                for ver in order:
                    mean = sum(t[0] for t in turns[ver]) / len(turns[ver])
                    line["versions"][ver] = {"turns_ms": turns[ver], "ms": mean,
                                             "share": bound / mean}
                    total["ms"][ver] += launches * mean
                total["bytes"] += launches * nbytes
                total["ops"] += launches * cs.K8_OPS * want_idx.numel()
                total["call_ms"] += launches * call[0]
                total["call_ms_table_rebuilt"] += launches * call_rebuilt[0]
                print(json.dumps(line), flush=True)
                del want_idx, want_taps, runs
                torch.cuda.empty_cache()
            bound = cs.bound_ms(total["bytes"], total["ops"])[0]
            print(json.dumps({"kernel": kname, "total_per": per, "bound_ms": bound,
                              "call_ms": total["call_ms"],
                              "call_ms_table_rebuilt": total["call_ms_table_rebuilt"],
                              "versions": {ver: {"ms": ms, "share": bound / ms}
                                           for ver, ms in total["ms"].items()}}), flush=True)
    print(json.dumps({"sass_instructions": {v: other_tree.sass_instructions(lib)
                                            for v, lib in libs.items()}}))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
