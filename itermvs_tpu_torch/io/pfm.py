"""PFM (portable float map) codec, NumPy only.

Copy of the JAX package's codec (itermvs_tpu/io/pfm.py) without its
native fast path: `Pf` single-channel / `PF` color, bottom-up row order
(vertical flip on read and write), scale line whose sign encodes
endianness (negative = little endian).
"""
from __future__ import annotations

import re
import sys

import numpy as np


def read_pfm(path: str) -> tuple[np.ndarray, float]:
    """Read a PFM file.

    Returns (data, scale) where data is [H, W, 1] for `Pf` or [H, W, 3]
    for `PF`, top-down row order, dtype float32 (native byte order).
    """
    with open(path, "rb") as f:
        header = f.readline().decode("utf-8").rstrip()
        if header == "PF":
            channels = 3
        elif header == "Pf":
            channels = 1
        else:
            raise ValueError(f"{path}: not a PFM file (header {header!r})")

        dims = f.readline().decode("utf-8")
        m = re.match(r"^(\d+)\s(\d+)\s$", dims)
        if not m:
            raise ValueError(f"{path}: malformed PFM dimension line {dims!r}")
        width, height = int(m.group(1)), int(m.group(2))

        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        scale = abs(scale)

        data = np.fromfile(f, endian + "f")

    expected = width * height * channels
    if data.size != expected:
        raise ValueError(f"{path}: payload has {data.size} floats, expected {expected}")
    data = np.flipud(data.reshape(height, width, channels))
    return np.ascontiguousarray(data.astype(np.float32)), scale


def save_pfm(path: str, image: np.ndarray, scale: float = 1.0) -> None:
    """Write a float32 image ([H,W], [H,W,1] or [H,W,3]) as PFM."""
    image = np.asarray(image)
    if image.dtype != np.float32:
        raise TypeError("PFM images must be float32")
    if image.ndim == 3 and image.shape[2] == 3:
        color = True
    elif image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 1):
        color = False
    else:
        raise ValueError(f"bad PFM image shape {image.shape}")

    flipped = np.flipud(image)
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode("utf-8"))
        # Little-endian is flagged with a negative scale.
        byteorder = flipped.dtype.byteorder
        little = byteorder == "<" or (byteorder == "=" and sys.byteorder == "little")
        f.write((f"{-scale if little else scale:f}\n").encode("utf-8"))
        flipped.tofile(f)
