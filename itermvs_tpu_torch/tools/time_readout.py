#!/usr/bin/env python3
"""Time K6 (depth_readout) and K7 (depth_readout_grad) of this checkout
against those of other checkouts, in one process on the card:

    python3 itermvs_tpu_torch/tools/time_readout.py --tree DIR [--tree DIR ...]

Each DIR is the root of another checkout. Its
`itermvs_tpu_torch/csrc/depth_readout.cu` and `depth_readout_grad.cu`
are compiled with this checkout's nvcc flags into this checkout's
`itermvs_tpu_torch/_build/` (`other_tree.library`) and bound through
their own C signatures: K6's is every checkout's since K6 exists
(`kernels.SIGNATURES`); K7's launcher took no strides of the
probability's gradient before K7 read it where it lies, and such a K7 is
given the dense copy, timed with the copy, as its wrapper made it. The inputs, plain versions, gates, bound and timer
are this checkout's (`chip_smoke.readout_logits`, `depth_readout_plain`,
`depth_readout_grad_plain`, `hold_grad`, `bound_ms`, `median_ms`).

K6, per case (the eval call at the 1600x1152 map's shape [1, 256, 288,
400], eval form, and the training call [4, 256, 128, 160], training
form, each in float32 and bfloat16): every version is first held against
the plain version (the same argmax on every pixel, depth and probability
within chip_smoke.READOUT_TOL) and against this checkout's (depth, and
in training the probability, argmax, S and r, bit for bit), then the
bare launches are timed in turns (this checkout, the others, the others
in reverse, this checkout; each turn the median, min and max of
`--rounds` rounds of `--reps` launches). One JSON line per case: per
version all its turns, `ms` the mean of its turns' medians, the bound and
the share of it.

K7, at the training call in float32 and bfloat16, on this checkout's K6
outputs and a seeded gradient of the probability (channels-last, and its
dense copy, the training loss's layout) and of the depth: every version
is first held against the float64 formula (`hold_grad`: 1e-5 of
max|plain|, one bf16 step more in bf16) and launched twice (bit for
bit), then timed in turns as above, per version: `bare_channels_last` (a
launch on the channels-last gradient; only a K7 that reads strides),
`bare_dense` (a launch on the dense one) and `call` (what the wrapper
does with the channels-last gradient: for a K7 without strides the
copy, the output's allocation and the launch; for this checkout's, its
wrapper). One JSON line per dtype. Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
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
        print("time_readout: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from itermvs_tpu_torch import kernels
    from itermvs_tpu_torch.ops.depth_readout import NUM_BINS, depth_readout_plain
    from itermvs_tpu_torch.tools import other_tree

    names = ("depth_readout", "depth_readout_bf16")
    versions = {"this": {n: kernels.function(n) for n in names}}
    for tree in args.tree:
        lib = other_tree.library(tree, "depth_readout")
        versions[os.path.abspath(tree)] = {
            n: other_tree.bind(lib, kernels.SIGNATURES[n][0], kernels.SIGNATURES[n][1])
            for n in names}
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
    for dtype in (torch.float32, torch.bfloat16):
        time_k7(cs, kernels, other_tree, args, dtype)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())
    return 0


def k7_versions(kernels, other_tree, trees, name):
    """{version: (launcher, takes strides)} of K7's form `name`."""
    symbol, argtypes, *_ = kernels.SIGNATURES[name]
    out = {"this": (kernels.function(name), True)}
    for tree in trees:
        lib = other_tree.library(tree, "depth_readout_grad")
        strided = other_tree.launcher_arity(tree, "depth_readout_grad", symbol) == len(argtypes)
        # A launcher without strides: this one's arguments but the three.
        types = argtypes if strided else argtypes[:-4] + argtypes[-1:]
        out[os.path.abspath(tree)] = (other_tree.bind(lib, symbol, types), strided)
    return out


def time_k7(cs, kernels, other_tree, args, dtype):
    """K7 of every version at the training call in `dtype`: held against
    the float64 formula and itself, then timed in turns; one JSON line."""
    import torch
    from itermvs_tpu_torch.ops.depth_readout import (
        NUM_BINS, depth_readout_grad, depth_readout_grad_plain, launch_depth_readout,
        prob_grad_strides)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED + 3)
    b, h, w = cs.TRAIN_BATCH, cs.TRAIN_HEIGHT // 4, cs.TRAIN_WIDTH // 4
    f32 = dict(device="cuda", dtype=torch.float32)
    logits = cs.readout_logits(b, h, w, gen, dtype)
    depth, prob = torch.empty(b, 1, h, w, **f32), torch.empty(b, NUM_BINS, h, w, **f32)
    index = torch.empty(b, 1, h, w, device="cuda", dtype=torch.int32)
    mass, regress = torch.empty_like(depth), torch.empty_like(depth)
    launch_depth_readout(logits, depth, prob, index, mass, regress)
    d_prob = torch.randn(b, h, w, NUM_BINS, generator=gen, **f32).permute(0, 3, 1, 2)
    d_depth = torch.randn(b, 1, h, w, generator=gen, **f32)
    dense = d_prob.contiguous()
    exact = depth_readout_grad_plain(prob.double(), index, mass.double(), regress.double(),
                                     dense.double(), d_depth.double(), torch.float64)
    name = cs.kernel_name("depth_readout_grad", dtype)
    stream = lambda: torch.cuda.current_stream().cuda_stream
    args_of = lambda dp, out: (prob.data_ptr(), dp.data_ptr(), d_depth.data_ptr(),
                               index.data_ptr(), mass.data_ptr(), regress.data_ptr(),
                               out.data_ptr(), b, h * w)
    runs, gates = {}, {}
    for version, (fn, strided) in k7_versions(kernels, other_tree, args.tree, name).items():
        out = torch.empty(b, NUM_BINS, h, w, device="cuda", dtype=dtype)

        def bare(dp, fn=fn, out=out, strided=strided):
            extra = prob_grad_strides(dp) if strided else ()
            kernels.check_launch(name, fn(*args_of(dp, out), *extra, stream()))

        if strided:
            def call():
                depth_readout_grad(prob, index, mass, regress, d_prob, d_depth, dtype)
        else:
            def call(fn=fn):
                copy = d_prob.float().contiguous()
                bare_out = torch.empty(b, NUM_BINS, h, w, device="cuda", dtype=dtype)
                kernels.check_launch(name, fn(*args_of(copy, bare_out), stream()))

        layouts = {"bare_dense": dense}
        if strided:
            layouts["bare_channels_last"] = d_prob
        got = {}
        for label, dp in layouts.items():
            bare(dp)
            first = out.clone()
            bare(dp)
            torch.cuda.synchronize()
            if not torch.equal(cs.bits(first), cs.bits(out)):
                raise SystemExit(f"{name} of {version}: two launches differ ({label})")
            err, scale = cs.hold_grad(name, out, exact.to(dtype), f"{version} {label}")
            got[label] = first
            gates[f"{version} {label}"] = err / scale
        if strided and not torch.equal(cs.bits(got["bare_dense"]),
                                       cs.bits(got["bare_channels_last"])):
            raise SystemExit(f"{name} of {version}: the two layouts' results differ")
        runs[version] = {label: (lambda bare=bare, dp=dp: bare(dp))
                         for label, dp in layouts.items()}
        runs[version]["call"] = call
    order = list(runs)
    turns = {v: {label: [] for label in runs[v]} for v in order}
    for v in order + order[::-1]:
        for label, run in runs[v].items():
            turns[v][label].append(cs.median_ms(run, args.rounds, args.reps))
    size = torch.tensor([], dtype=dtype).element_size()
    pixels = b * h * w
    bound, bound_by = cs.bound_ms(pixels * (NUM_BINS * (8 + size) + 16),
                                  cs.K7_OPS_PER_BIN * NUM_BINS * pixels)
    line = {"kernel": name, "case": "training_call", "shape": [b, NUM_BINS, h, w],
            "bound_ms": bound, "bound_by": bound_by, "max_rel_err": gates,
            "rounds": args.rounds, "reps": args.reps, "versions": {}}
    for v in order:
        line["versions"][v] = {}
        for label, t in turns[v].items():
            mean = sum(x[0] for x in t) / len(t)
            line["versions"][v][label] = {"turns_ms": t, "ms": mean, "share": bound / mean}
    print(json.dumps(line), flush=True)
    torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
