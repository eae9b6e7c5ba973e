"""Binary little-endian PLY point clouds (copy of itermvs_tpu/io/ply.py,
plain numpy only).

Vertex layout: x/y/z float32 + red/green/blue uint8, element `vertex`,
as the reference's `plyfile` output.
"""
from __future__ import annotations

import numpy as np

_VERTEX_DTYPE = np.dtype([
    ("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
    ("red", "u1"), ("green", "u1"), ("blue", "u1"),
])


def _vertex_bytes(xyz: np.ndarray, rgb: np.ndarray) -> np.ndarray:
    """[N, 15] uint8 rows: the xyz bytes and the rgb bytes, interleaved by
    two block copies."""
    n = xyz.shape[0]
    buf = np.empty((n, _VERTEX_DTYPE.itemsize), np.uint8)
    buf[:, 0:12] = xyz.view(np.uint8).reshape(n, 12)
    buf[:, 12:15] = rgb
    return buf


def write_ply(path: str, xyz: np.ndarray, rgb: np.ndarray) -> None:
    """Write points xyz [N,3] float and colors rgb [N,3] uint8 to a binary PLY."""
    xyz = np.ascontiguousarray(xyz, dtype=np.float32)
    rgb = np.asarray(rgb, dtype=np.uint8)
    if xyz.ndim != 2 or xyz.shape[1] != 3 or rgb.shape != xyz.shape:
        raise ValueError(f"bad point-cloud shapes xyz={xyz.shape} rgb={rgb.shape}")
    header = (
        "ply\n"
        "format binary_little_endian 1.0\n"
        f"element vertex {xyz.shape[0]}\n"
        "property float x\n"
        "property float y\n"
        "property float z\n"
        "property uchar red\n"
        "property uchar green\n"
        "property uchar blue\n"
        "end_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        _vertex_bytes(xyz, rgb).tofile(f)


class PlyWriter:
    """Streaming binary PLY writer: vertices are appended chunk by chunk
    and the header's vertex count is patched on close (a zero-padded
    12-digit integer, which every ASCII-int parser reads). Fusion appends
    each reference view's points as they are produced, so the whole cloud
    never sits in memory."""

    def __init__(self, path: str):
        self._f = open(path, "wb")
        self._n = 0
        self._f.write(b"ply\nformat binary_little_endian 1.0\nelement vertex ")
        self._count_offset = self._f.tell()
        self._f.write(b"000000000000\n")
        self._f.write(
            b"property float x\nproperty float y\nproperty float z\n"
            b"property uchar red\nproperty uchar green\nproperty uchar blue\n"
            b"end_header\n")

    def add(self, xyz: np.ndarray, rgb: np.ndarray) -> None:
        xyz = np.ascontiguousarray(xyz, dtype=np.float32)
        rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
        if xyz.ndim != 2 or xyz.shape[1] != 3 or rgb.shape != xyz.shape:
            raise ValueError(f"bad chunk shapes xyz={xyz.shape} rgb={rgb.shape}")
        if xyz.shape[0] == 0:
            return
        _vertex_bytes(xyz, rgb).tofile(self._f)
        self._n += xyz.shape[0]

    def close(self) -> int:
        """Patch the vertex count, close the file; returns the count."""
        self._f.seek(self._count_offset)
        self._f.write(f"{self._n:012d}".encode("ascii"))
        self._f.close()
        return self._n

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


_TYPES = {
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
    "uchar": "u1", "uint8": "u1", "int": "<i4", "int32": "<i4",
    "uint": "<u4", "short": "<i2", "ushort": "<u2",
}


def read_ply(path: str) -> tuple[np.ndarray, np.ndarray | None]:
    """Read a PLY point cloud; returns (xyz [N,3] f32, rgb [N,3] u8 or None).

    Binary little-endian or ASCII, float32/float64 x/y/z and optional
    uchar red/green/blue.
    """
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        n = None
        props: list[tuple[str, str]] = []
        in_vertex = False
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: truncated header")
            tokens = line.decode("ascii", "replace").strip().split()
            if not tokens:
                continue
            if tokens[0] == "format":
                fmt = tokens[1]
            elif tokens[0] == "element":
                in_vertex = tokens[1] == "vertex"
                if in_vertex:
                    n = int(tokens[2])
            elif tokens[0] == "property" and in_vertex:
                props.append((tokens[1], tokens[2]))
            elif tokens[0] == "end_header":
                break

        if n is None:
            raise ValueError(f"{path}: no vertex element")
        dtype = np.dtype([(name, _TYPES[t]) for t, name in props])
        if fmt == "binary_little_endian":
            data = np.fromfile(f, dtype=dtype, count=n)
        elif fmt == "ascii":
            data = np.loadtxt(f, dtype=dtype, max_rows=n)
        else:
            raise ValueError(f"{path}: unsupported PLY format {fmt}")

    xyz = np.stack([data["x"], data["y"], data["z"]], axis=1).astype(np.float32)
    if all(c in dtype.names for c in ("red", "green", "blue")):
        rgb = np.stack([data["red"], data["green"], data["blue"]], axis=1).astype(np.uint8)
    else:
        rgb = None
    return xyz, rgb
