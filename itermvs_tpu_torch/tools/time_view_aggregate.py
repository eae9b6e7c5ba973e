#!/usr/bin/env python3
"""Time K12 (view_aggregate_grad), with K11 (view_aggregate) as the
unchanged control, of this checkout against those of other checkouts,
in one process on the card:

    python3 itermvs_tpu_torch/tools/time_view_aggregate.py --tree DIR [--tree DIR ...]

Each DIR is the root of another checkout (a `git archive` of the parent
unpacked under the ignored `_export/`, or a copy with one source
edited). Its `itermvs_tpu_torch/csrc/view_aggregate.cu` and
`view_aggregate_grad.cu` are compiled with this checkout's nvcc flags
into this checkout's `itermvs_tpu_torch/_build/` (`other_tree.library`)
and bound through their own C signatures: every checkout since K11/K12
exist exports the same two launchers (a launcher of another arity is
refused), and whether its K12 is a programmatic dependent launch is read
from the query symbol `itermvs_view_aggregate_grad_programmatic` (False
where a library lacks it). The inputs, plain versions, gates, bound and
timer are this checkout's (`chip_smoke.view_aggregate_inputs`,
`view_aggregate_plain`, `view_aggregate_grad_plain`, `hold_view_grad`,
`view_aggregate_work`, `bound_ms`, `median_ms`).

Cases: the four aggregations of a 640x512 batch-4 training step (the
init sweep's, K12 with ∂w, on the batch-strided slices of one stacked
tensor; the three iteration levels', 4 launches each, without ∂w), K11
and K12 at each, and K11 at the four of a 1600x1152 map. Every version
is first held under chip_smoke's gates (K11 and every ∂c_v bit for bit
against the plain versions, ∂w within VIEW_GRAD_REL, two K12 launches
bit-equal), then its bare launches (the C launcher on arguments built
once, outputs allocated beforehand) are timed in turns (this checkout,
the others, the others in reverse, this checkout; each turn the median,
min and max of `--rounds` rounds of `--reps` launches). One JSON line
per kernel and case: per version its turns, `ms` (the mean of its turns'
medians), `cold_ms` (each launch after a 256 MiB write that evicts the
50 MB L2; `time_upsample.cold_ms`), the share of the bound (of `ms`) and
`device_us`, the profiler's device time per launch of each kernel
function; this checkout's wrapper `call_ms`. Then per version K12's and
K11's totals per step (each case times its launches; K12's init call
and its 12 iteration calls apart, each with its share of the bound) and
K11's per map, each version's SASS instruction count and registers per
kernel function (`cuobjdump -sass`, the ptxas report), and the card's
name and power limit. Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCES = ("view_aggregate", "view_aggregate_grad")


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
        print("time_view_aggregate: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from itermvs_tpu_torch import kernels
    from itermvs_tpu_torch.ops.view_aggregate import (
        view_aggregate, view_aggregate_args, view_aggregate_grad, view_aggregate_grad_args,
        view_aggregate_grad_plain, view_aggregate_plain)
    from itermvs_tpu_torch.tools import other_tree

    kernels.build_all(SOURCES)
    libs = {"this": {s: kernels.library_path(s) for s in SOURCES}}
    for tree in args.tree:
        for s in SOURCES:
            symbol, argtypes = kernels.SIGNATURES[s][:2]
            arity = other_tree.launcher_arity(tree, s, symbol)
            if arity != len(argtypes):
                raise SystemExit(f"{tree}: {symbol} takes {arity} arguments, this checkout's "
                                 f"{len(argtypes)}")
        libs[os.path.abspath(tree)] = {s: other_tree.library(tree, s) for s in SOURCES}
    versions = {v: {s: other_tree.bind(lib[s], *kernels.SIGNATURES[s][:2]) for s in SOURCES}
                for v, lib in libs.items()}
    order = list(versions)
    cases = [("step", name, b, n, h * w, name == "init", 1 if name == "init" else
              cs.TRAIN_ITERATION)
             for name, b, n, h, w, *_ in cs.sweep_shapes(cs.TRAIN_WIDTH, cs.TRAIN_HEIGHT,
                                                         cs.TRAIN_VIEWS, cs.TRAIN_ITERATION,
                                                         cs.TRAIN_BATCH)]
    cases += [("map", name, b, n, h * w, name == "init", 1 if name == "init" else cs.ITERATION)
              for name, b, n, h, w, *_ in cs.sweep_shapes(cs.WIDTH, cs.HEIGHT, cs.VIEWS,
                                                          cs.ITERATION)]
    nv_of = {"step": cs.TRAIN_VIEWS - 1, "map": cs.VIEWS - 1}
    totals = {}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED + 6)
    for per, name, b, n, p, init, launches in cases:
        nv = nv_of[per]
        corrs, weights, grad = cs.view_aggregate_inputs(b, nv, n, p, init, gen)
        want = view_aggregate_plain(corrs, weights)
        runs, outs = {}, {}
        for version, fns in versions.items():
            out = torch.empty_like(want)
            k11_args = view_aggregate_args(corrs, weights, out)

            def run(fn=fns["view_aggregate"], k11_args=k11_args):
                kernels.check_launch("view_aggregate", fn(*k11_args))

            run()
            torch.cuda.synchronize()
            if not torch.equal(cs.bits(out), cs.bits(want)):
                raise SystemExit(f"view_aggregate of {version} at {per}_{name}: differs from "
                                 f"its plain version")
            runs[version], outs[version] = run, out
        nbytes, ops = cs.view_aggregate_work(b, nv, n * cs.GROUPS, p, grad=False)
        report(cs, "view_aggregate", per, name, b, nv, n, p, launches, runs, order, args,
               cs.median_ms(lambda: view_aggregate(corrs, weights), args.rounds, args.reps),
               cs.bound_ms(nbytes, ops), {"bit_equal": True}, totals)
        if per == "map":
            continue

        want_c, want_w = view_aggregate_grad_plain(corrs, weights, grad, init)
        runs, gates = {}, {}
        for version, fns in versions.items():
            d_corr = torch.empty(nv, *grad.shape, device="cuda")
            d_w = torch.empty_like(weights) if init else None
            more = dict(corrs=corrs, out=outs[version], d_weights=d_w) if init else {}
            k12_args = view_aggregate_grad_args(weights, grad, d_corr, **more)

            def run(fn=fns["view_aggregate_grad"], k12_args=k12_args):
                kernels.check_launch("view_aggregate_grad", fn(*k12_args))

            same, repeats, err, rel = cs.hold_view_grad(run, d_corr, d_w, want_c, want_w)
            if not (same and repeats and rel <= cs.VIEW_GRAD_REL):
                raise SystemExit(f"view_aggregate_grad of {version} at {per}_{name}: ∂c "
                                 f"bit-equal {same}, launches bit-equal {repeats}, ∂w rel "
                                 f"L2 {rel} (tolerance {cs.VIEW_GRAD_REL})")
            runs[version], gates[version] = run, {"max_abs_err": err, "max_rel_err": rel}
        out = outs["this"]
        call = lambda: view_aggregate_grad(weights, grad, *((corrs, out) if init else ()))
        nbytes, ops = cs.view_aggregate_work(b, nv, n * cs.GROUPS, p, grad=True,
                                             weight_grad=init)
        report(cs, "view_aggregate_grad", per, name, b, nv, n, p, launches, runs, order, args,
               cs.median_ms(call, args.rounds, args.reps), cs.bound_ms(nbytes, ops),
               {"weight_grad": init, "d_corr_bit_equal": True, "two_launches_bit_equal": True,
                "errors": gates, "programmatic": {
                    v: other_tree.query(lib["view_aggregate_grad"],
                                        "itermvs_view_aggregate_grad_programmatic")
                    for v, lib in libs.items()}}, totals)
        del corrs, weights, grad, want, want_c, want_w, runs, outs
        torch.cuda.empty_cache()
    print(json.dumps({"totals": totals}))
    print(json.dumps({"sass_instructions": {v: {s: other_tree.sass_instructions(lib)
                                                for s, lib in ls.items()}
                                            for v, ls in libs.items()}}))
    print(json.dumps({"registers": {v: {s: other_tree.registers(lib) for s, lib in ls.items()}
                                    for v, ls in libs.items()}}))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())
    return 0


def report(cs, kname, per, name, b, nv, n, p, launches, runs, order, args, call, bound,
           gates, totals):
    """Time `runs` in turns, print one JSON line and add each version's
    time, times `launches`, to `totals` (K12 per step: its init call and
    its iteration calls apart)."""
    from itermvs_tpu_torch.tools.time_upsample import cold_ms

    turns = {v: [] for v in order}
    for v in order + order[::-1]:
        turns[v].append(cs.median_ms(runs[v], args.rounds, args.reps))
    bound_ms, bound_by = bound
    line = {"kernel": kname, "per": per, "case": name, "batch": b, "views": nv, "n": n,
            "p": p, f"launches_per_{per}": launches, **gates, "bound_ms": bound_ms,
            "bound_by": bound_by, "call_ms": call, "rounds": args.rounds, "reps": args.reps,
            "versions": {}}
    keys = [f"{kname}_per_{per}"]
    if kname == "view_aggregate_grad":
        keys.append(f"{kname}_{'init' if name == 'init' else 'iterations'}_per_{per}")
    for v in order:
        mean = sum(t[0] for t in turns[v]) / len(turns[v])
        line["versions"][v] = {"turns_ms": turns[v], "ms": mean, "share": bound_ms / mean,
                               "cold_ms": cold_ms(runs[v], args.reps),
                               "device_us": cs.device_us(runs[v], args.reps)}
        for key in keys:
            tot = totals.setdefault(key, {}).setdefault(
                v, {"ms": 0.0, "device_ms": 0.0, "bound_ms": 0.0, "launches": 0})
            tot["ms"] += launches * mean
            tot["device_ms"] += launches * sum(line["versions"][v]["device_us"].values()) / 1e3
            tot["bound_ms"] += launches * bound_ms
            tot["launches"] += launches
            tot["share"] = tot["bound_ms"] / tot["ms"]
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    sys.exit(main())
