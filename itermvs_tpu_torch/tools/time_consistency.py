#!/usr/bin/env python3
"""Time K3 (fusion_consistency) of one checkout of the port on the card,
so that two checkouts can be compared in one run:

    python3 itermvs_tpu_torch/tools/time_consistency.py [--tree DIR]

DIR is the root of a checkout (default: the one this script lies in).
Its own `chip_smoke.py` gives the inputs (`consistency_inputs`: reference
view 0 of the plane scene with its planted traps), the settings
(`FUSION`) and the timer (`time_ms`); its own `itermvs_tpu_torch` gives
the kernel, built inside that checkout, and the plain version. For 4 and
10 sources at 1600x1152 the script holds the kernel bit for bit against
the plain version, then prints one JSON line:

  kernel_ms  median, min and max of 7 rounds of 100 launches of the bare
             C launcher on a record already on the card;
  call_ms    median of the same for the wrapper `consistency`, with the
             matrices on the host, as fusion passes them;
  upload_ms  (where the checkout has `record`) medians of the same for
             the record built from the host matrices, uploaded pageable,
             pageable with non_blocking=True, or pinned with
             non_blocking=True, and launched.

A checkout whose consistency module has no `record` lays the matrices out
in 18 + 42 S floats (`_params`); the launcher's C arguments are the same,
so its kernel is timed the same way. Exits non-zero without a CUDA device.
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
    ap.add_argument("--tree", default=REPO, help="root of the checkout to time")
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--reps", type=int, default=100)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))

    import torch
    if not torch.cuda.is_available():
        print("time_consistency: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from itermvs_tpu_torch import kernels
    from itermvs_tpu_torch.ops import consistency as cons

    build = getattr(cons, "record", None) or cons._params
    fn = kernels.function("fusion_consistency")
    fusion = chip_smoke.FUSION
    dev = torch.device("cuda")

    def median(f):
        times = sorted(chip_smoke.time_ms(f, reps=args.reps) for _ in range(args.rounds))
        return times[args.rounds // 2], times[0], times[-1]

    def hold(got, want, what):
        equal = got[1] == want[1]
        if not (bool(equal.all()) and torch.equal(got[0], want[0])):
            raise SystemExit(f"{what}: bits equal on {equal.float().mean().item()}, "
                             "averages differ from the plain version")

    for sources in (chip_smoke.VIEWS - 1, chip_smoke.DTU_SOURCES):
        inputs = chip_smoke.consistency_inputs(chip_smoke.WIDTH, chip_smoke.HEIGHT,
                                               sources, chip_smoke.SEED, "cuda")
        ref, conf, src, r2s, s2r, k_ref, k_ref_inv, k_srcs, k_srcs_inv = inputs
        host = inputs[:3] + tuple(m.cpu() for m in inputs[3:])
        h, w = ref.shape
        params = build(k_ref, k_ref_inv, r2s, k_srcs, k_srcs_inv, s2r).to(dev)

        def launch(params=params):
            avg = torch.empty((h, w), dtype=torch.float32, device=dev)
            bits = torch.empty((h, w), dtype=torch.uint8, device=dev)
            kernels.check_launch("fusion_consistency", fn(
                ref.data_ptr(), conf.data_ptr(), src.data_ptr(), params.data_ptr(),
                avg.data_ptr(), bits.data_ptr(), sources, h, w,
                float(fusion["geo_pixel_thres"]), float(fusion["geo_depth_thres"]),
                float(fusion["photo_thres"]), int(fusion["geo_mask_thres"]),
                torch.cuda.current_stream().cuda_stream))
            return avg, bits

        want = cons.consistency_plain(*inputs, **fusion)
        hold(launch(), want, f"kernel, {sources} sources")
        hold(cons.consistency(*host, **fusion), want, f"wrapper, {sources} sources")
        line = {"tree": args.tree, "size": [w, h], "sources": sources,
                "layout": build.__name__, "rounds": args.rounds, "reps": args.reps,
                "kernel_ms": median(launch),
                "call_ms": median(lambda: cons.consistency(*host, **fusion))[0]}
        if build.__name__ == "record":
            mats = host[5], host[6], host[3], host[7], host[8], host[4]
            uploads = {"pageable": lambda r: r.to(dev),
                       "pageable_non_blocking": lambda r: r.to(dev, non_blocking=True),
                       "pinned_non_blocking":
                           lambda r: r.pin_memory().to(dev, non_blocking=True)}
            line["upload_ms"] = {
                name: median(lambda up=up: launch(up(build(*mats))))[0]
                for name, up in uploads.items()}
        print(json.dumps(line), flush=True)
        del inputs, host, params, want
        torch.cuda.empty_cache()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
