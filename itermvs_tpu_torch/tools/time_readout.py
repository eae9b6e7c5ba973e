#!/usr/bin/env python3
"""Time K6 (depth_readout) of this checkout against K6 of other
checkouts, in one process on the card:

    python3 itermvs_tpu_torch/tools/time_readout.py --tree DIR [--tree DIR ...]

Each DIR is the root of another checkout. Its
`itermvs_tpu_torch/csrc/depth_readout.cu` is compiled with this
checkout's nvcc flags into this checkout's `itermvs_tpu_torch/_build/`
(under a name that carries a hash of the source) and bound through the
same C signature (`kernels.SIGNATURES`: every checkout since K6 exists
exports the same two launchers). The inputs, plain version, bound and
timer are this checkout's (`chip_smoke.readout_logits`,
`depth_readout_plain`, `bound_ms`, `median_ms`).

Per case (the eval call at the 1600x1152 map's shape [1, 256, 288, 400],
eval form, and the training call [4, 256, 128, 160], training form, each
in float32 and bfloat16) the script first holds every version against
the plain version (the same argmax on every pixel, depth and probability
within chip_smoke.READOUT_TOL) and against this checkout's (depth, and
in training the probability, argmax, S and r, bit for bit), then times
the bare launches in turns (this checkout, the others, the others in
reverse, this checkout; each turn the median, min and max of `--rounds`
rounds of `--reps` launches) and prints one JSON line per case: per
version all its turns, `ms` the mean of its turns' medians, the bound
and the share of it. Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join("itermvs_tpu_torch", "csrc", "depth_readout.cu")


def other_launchers(tree, kernels):
    """{dtype name: the bound C launcher} of `tree`'s K6, built here."""
    path = os.path.join(tree, SOURCE)
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(kernels.NVCC_FLAGS).encode())
    lib = os.path.join(kernels.BUILD_DIR,
                       f"libdepth_readout_other-{digest.hexdigest()[:16]}.so")
    if not os.path.exists(lib):
        os.makedirs(kernels.BUILD_DIR, exist_ok=True)
        out = subprocess.run([kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o", lib, path],
                             capture_output=True, text=True)
        if out.returncode != 0:
            raise SystemExit(f"nvcc failed for {path}:\n{out.stdout}{out.stderr}")
    handle = ctypes.CDLL(lib)
    fns = {}
    for name in ("depth_readout", "depth_readout_bf16"):
        symbol, argtypes, *_ = kernels.SIGNATURES[name]
        fn = getattr(handle, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


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
        print("time_readout: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from itermvs_tpu_torch import kernels
    from itermvs_tpu_torch.ops.depth_readout import NUM_BINS, depth_readout_plain

    versions = {"this": {n: kernels.function(n) for n in ("depth_readout",
                                                           "depth_readout_bf16")}}
    for tree in args.tree:
        versions[os.path.abspath(tree)] = other_launchers(tree, kernels)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED + 3)
    cases = (("eval_call", 1, cs.HEIGHT // 4, cs.WIDTH // 4, False),
             ("training_call", cs.TRAIN_BATCH, cs.TRAIN_HEIGHT // 4, cs.TRAIN_WIDTH // 4,
              True))
    for label, b, h, w, train in cases:
        for dtype in (torch.float32, torch.bfloat16):
            kname = cs.kernel_name("depth_readout", dtype)
            size = torch.tensor([], dtype=dtype).element_size()
            pixels = b * h * w
            logits = cs.readout_logits(b, h, w, gen, dtype)
            want = depth_readout_plain(logits)
            outs = {}
            launch = {}
            for version, fns in versions.items():
                f32 = dict(device="cuda", dtype=torch.float32)
                o = [torch.empty(b, 1, h, w, **f32)]
                if train:
                    o += [torch.empty(b, NUM_BINS, h, w, **f32),
                          torch.empty(b, 1, h, w, device="cuda", dtype=torch.int32),
                          torch.empty(b, 1, h, w, **f32), torch.empty(b, 1, h, w, **f32)]
                ptrs = [t.data_ptr() for t in o] + [None] * (5 - len(o))

                def run(fn=fns[kname], ptrs=ptrs):
                    kernels.check_launch(kname, fn(logits.data_ptr(), *ptrs, b, h * w,
                                                   torch.cuda.current_stream().cuda_stream))

                run()
                torch.cuda.synchronize()
                d_err = (o[0] - want[0]).abs().max().item()
                ok = d_err <= cs.READOUT_TOL
                if train:
                    ok = ok and torch.equal(o[2].long(), want[2]) and \
                        (o[1] - want[1]).abs().max().item() <= cs.READOUT_TOL
                if not ok:
                    raise SystemExit(f"{kname} of {version} at {label}: differs from the "
                                     f"plain version (|depth| err {d_err})")
                outs[version], launch[version] = o, run
            same = all(torch.equal(cs.bits(a), cs.bits(c)) if a.is_floating_point()
                       else torch.equal(a, c)
                       for v in outs for a, c in zip(outs[v], outs["this"]))
            if not same:
                raise SystemExit(f"{kname} at {label}: the versions' outputs differ")
            order = list(versions)
            turns = {v: [] for v in order}
            for v in order + order[::-1]:
                turns[v].append(cs.median_ms(launch[v], args.rounds, args.reps))
            nbytes = pixels * (NUM_BINS * size + 4 + ((NUM_BINS * 4 + 12) if train else 0))
            ops = (cs.K6_TRAIN_OPS_PER_BIN if train else cs.K6_OPS_PER_BIN) * NUM_BINS * pixels
            bound, bound_by = cs.bound_ms(nbytes, ops)
            line = {"kernel": kname, "case": label, "shape": [b, NUM_BINS, h, w],
                    "form": "training (writes p)" if train else "eval (no p)",
                    "bound_ms": bound, "bound_by": bound_by, "outputs_bit_equal": same,
                    "rounds": args.rounds, "reps": args.reps, "versions": {}}
            for v in order:
                mean = sum(t[0] for t in turns[v]) / len(turns[v])
                line["versions"][v] = {"turns_ms": turns[v], "ms": mean, "share": bound / mean}
            print(json.dumps(line), flush=True)
            del logits, want, outs, launch
            torch.cuda.empty_cache()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
