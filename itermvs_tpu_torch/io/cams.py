"""MVSNet-convention camera text files (reader of itermvs_tpu/io/cams.py).

Layout:

    extrinsic
    <4x4 world-to-camera matrix, rows on lines 1-4>
    (blank)
    intrinsic
    <3x3 K matrix, rows on lines 7-9>
    (blank)
    depth_min [interval [num] [depth_max]]   # line 11; first + last token
"""
from __future__ import annotations

import numpy as np


def _read_matrices(lines: list[str]) -> tuple[np.ndarray, np.ndarray]:
    extrinsics = np.fromstring(" ".join(lines[1:5]), dtype=np.float32, sep=" ").reshape(4, 4)
    intrinsics = np.fromstring(" ".join(lines[7:10]), dtype=np.float32, sep=" ").reshape(3, 3)
    return intrinsics, extrinsics


def read_cam_file(path: str) -> tuple[np.ndarray, np.ndarray, float, float]:
    """Return (intrinsics[3,3], extrinsics[4,4], depth_min, depth_max)."""
    with open(path) as f:
        lines = [line.rstrip() for line in f.readlines()]
    intrinsics, extrinsics = _read_matrices(lines)
    depth_tokens = lines[11].split()
    return intrinsics, extrinsics, float(depth_tokens[0]), float(depth_tokens[-1])


def read_camera_parameters(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Return (intrinsics[3,3], extrinsics[4,4]) only: fusion's reader,
    which needs no depth line."""
    with open(path) as f:
        lines = [line.rstrip() for line in f.readlines()]
    return _read_matrices(lines)
