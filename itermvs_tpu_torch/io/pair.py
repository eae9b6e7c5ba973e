"""MVSNet pair.txt reader (copy of itermvs_tpu/io/pair.py).

Format:

    NUM_VIEWPOINTS
    <ref id>
    <n> <src id> <score> <src id> <score> ...
    ... repeated per viewpoint
"""
from __future__ import annotations


def read_pair_file(path: str) -> list[tuple[int, list[int]]]:
    """Return [(ref_view, [src views...])], dropping entries with no sources."""
    data = []
    with open(path) as f:
        num_viewpoint = int(f.readline())
        for _ in range(num_viewpoint):
            ref_view = int(f.readline().rstrip())
            src_views = [int(x) for x in f.readline().rstrip().split()[1::2]]
            if src_views:
                data.append((ref_view, src_views))
    return data
