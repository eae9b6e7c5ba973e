#!/usr/bin/env python3
"""Which order of operations PyTorch's CUDA kernels take for the init
sweep's two softmax tails, so that K30-K33 can take the same one.

    python3 itermvs_tpu_torch/tools/probe_sample_softmax.py

On seeded [N, 32, h, w] maps at the init sweep's shapes (a 1600x1152
map's [4, 32, 144, 200] view-weight logits, a 640x512 training step's
[16, 32, 64, 80] logits and [4, 32, 64, 80] score), in float32 and from
bfloat16 logits, it emulates candidate orders with PyTorch's own
elementwise operations on the card (each an IEEE operation on float32)
and counts the elements that differ bit for bit from:

  - `torch.softmax(x, 1)`: max, then Σ exp(x − max) in sample order, then
    exp(x − max) / Σ (the spatial kernel with one thread per pixel);
  - `amax` of it against 1 / Σ;
  - `(index · p).sum(1)` against each summation order in `ORDERS`;
  - `e / 31.0` against `e · float32(1 / 31)`.

Prints one JSON line per shape and the card's name and power limit; exits
non-zero without a CUDA device.
"""
from __future__ import annotations

import json
import subprocess
import sys

import torch

SAMPLES = 32
SHAPES = (("map_view_weight", 4, 144, 200), ("step_view_weight", 16, 64, 80),
          ("step_init_depth", 4, 64, 80))


def split_sum(t, threads, accumulators=4, halving=True):
    """Σ over dim 1 of t [N, 32, ...] as `threads` threads would take it:
    thread y sums samples y, y + threads, ... into `accumulators`
    interleaved partial sums combined in order, then the threads' sums
    are combined by halving (or in order)."""
    parts = []
    for y in range(threads):
        idx = list(range(y, t.shape[1], threads))
        acc = [None] * accumulators
        for k, d in enumerate(idx):
            a = k % accumulators
            acc[a] = t[:, d] if acc[a] is None else acc[a] + t[:, d]
        total = None
        for a in acc:
            if a is not None:
                total = a if total is None else total + a
        parts.append(total)
    if halving:
        while len(parts) > 1:
            half = len(parts) // 2
            parts = [parts[y] + parts[y + half] for y in range(half)]
        return parts[0]
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


def pairwise(t):
    parts = [t[:, d] for d in range(t.shape[1])]
    while len(parts) > 1:
        parts = [parts[2 * k] + parts[2 * k + 1] for k in range(len(parts) // 2)]
    return parts[0]


ORDERS = {"sequential": lambda t: split_sum(t, 1, accumulators=1),
          "acc4": lambda t: split_sum(t, 1, 4),
          "acc2": lambda t: split_sum(t, 1, 2),
          "acc8": lambda t: split_sum(t, 1, 8),
          "pairwise": pairwise,
          **{f"threads{s}_acc4": (lambda s: lambda t: split_sum(t, s, 4))(s)
             for s in (2, 4, 8, 16, 32)}}


def differ(a, b):
    return int((a.view(torch.int32) != b.view(torch.int32)).sum().item())


def probe(label, n, h, w, source_dtype, gen):
    x = (torch.randn(n, SAMPLES, h, w, device="cuda", generator=gen) * 3.0).to(
        source_dtype).float()
    want = torch.softmax(x, 1)
    m = x.amax(1, keepdim=True)
    e = torch.exp(x - m)
    s = split_sum(e, 1, accumulators=1)[:, None]
    p = e / s
    index = torch.arange(SAMPLES, dtype=torch.float32, device="cuda").reshape(1, SAMPLES, 1, 1)
    t = index * want
    expectation = t.sum(1)
    inv = torch.tensor(1.0, dtype=torch.float32) / torch.tensor(31.0, dtype=torch.float32)
    rec = {"shape": label, "x": [n, SAMPLES, h, w], "from": str(source_dtype),
           "softmax_differ": differ(p, want), "elements": want.numel(),
           "amax_vs_reciprocal_differ": differ(want.amax(1), 1.0 / s[:, 0]),
           "sum_order_differ": {k: differ(fn(t), expectation) for k, fn in ORDERS.items()},
           "div31_vs_mul_reciprocal_differ": differ(expectation / 31.0,
                                                    expectation * inv.item())}
    print(json.dumps(rec))
    return rec


def main():
    if not torch.cuda.is_available():
        print("probe_sample_softmax: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(json.dumps({"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda}))
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, n, h, w in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            probe(label, n, h, w, dtype, gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
