#!/usr/bin/env python3
"""Compare the SASS of the port's CUDA kernels in this checkout with
another checkout's, kernel by kernel:

    python3 itermvs_tpu_torch/tools/compare_sass.py --tree DIR [NAME ...]

DIR is the root of the other checkout (e.g. a `git archive` of the parent
commit unpacked under `_export/`). Each kernel NAME (default: every
source of DIR's `itermvs_tpu_torch/csrc/` that this checkout also has) is
built from both trees with this checkout's nvcc flags, and the
instruction lines of `cuobjdump -sass` are compared. Prints one JSON line
per kernel (instruction lines in each tree, lines that differ, the first
three differences); exits non-zero if nvcc or cuobjdump is missing or a
build fails. Needs the CUDA toolkit, not a card.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)

from itermvs_tpu_torch import kernels  # noqa: E402


def sass_lines(library: str, cuobjdump: str) -> list[str]:
    """The instruction lines (`/*0000*/ ...`) of a library's SASS."""
    out = subprocess.run([cuobjdump, "-sass", library], capture_output=True, text=True,
                         check=True).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip().startswith("/*")]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", required=True, help="root of the other checkout")
    ap.add_argument("names", nargs="*", help="kernels to compare (default: all shared)")
    args = ap.parse_args()
    try:
        nvcc = kernels.nvcc_path()
    except RuntimeError as err:
        print(f"compare_sass: {err}", file=sys.stderr)
        return 1
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if not os.path.exists(cuobjdump):
        cuobjdump = shutil.which("cuobjdump")
    if cuobjdump is None:
        print("compare_sass: cuobjdump not found", file=sys.stderr)
        return 1
    other = os.path.join(os.path.abspath(args.tree), "itermvs_tpu_torch", "csrc")
    names = args.names or sorted(f[:-3] for f in os.listdir(other)
                                 if f.endswith(".cu") and f[:-3] in kernels.SOURCES)
    with tempfile.TemporaryDirectory() as tmp:
        builds = {}
        for name in names:
            for tree, csrc in (("this", kernels.CSRC_DIR), ("other", other)):
                lib = os.path.join(tmp, f"{tree}_{name}.so")
                builds[(tree, name)] = (lib, subprocess.Popen(
                    [nvcc, *kernels.NVCC_FLAGS, "-o", lib, os.path.join(csrc, f"{name}.cu")],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for (tree, name), (_, proc) in builds.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                print(f"compare_sass: nvcc failed for {tree} {name}.cu:\n{log}", file=sys.stderr)
                return 1
        for name in names:
            this = sass_lines(builds[("this", name)][0], cuobjdump)
            that = sass_lines(builds[("other", name)][0], cuobjdump)
            diff = [(i, a, b) for i, (a, b) in enumerate(zip(this, that)) if a != b]
            print(json.dumps({"kernel": name, "instructions": [len(this), len(that)],
                              "differing_lines": len(diff) + abs(len(this) - len(that)),
                              "first_differences": diff[:3]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
