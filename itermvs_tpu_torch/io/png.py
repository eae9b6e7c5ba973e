"""8-bit greyscale and RGB PNG writer on the standard library alone.

Fusion writes its masks and display images with it, so that a machine
without PIL or cv2 (e.g. the GPU host that runs chip_smoke.py) can run
fusion. The files decode to the same pixels as PIL's
`Image.fromarray(img).save(path)`; the compressed bytes differ (no
per-row filter here).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPE = {1: 0, 3: 2}          # channels -> PNG colour type (grey, RGB)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """Write a uint8 [H, W] (grey) or [H, W, 3] (RGB) image as an 8-bit PNG."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"PNG image must be uint8, got {img.dtype}")
    channels = 1 if img.ndim == 2 else img.shape[-1]
    if img.ndim not in (2, 3) or channels not in _COLOR_TYPE:
        raise ValueError(f"PNG image must be [H, W] or [H, W, 3], got {img.shape}")
    h, w = img.shape[:2]
    rows = np.zeros((h, 1 + w * channels), np.uint8)   # filter byte 0: none
    rows[:, 1:] = img.reshape(h, w * channels)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[channels], 0, 0, 0)
    data = (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)
