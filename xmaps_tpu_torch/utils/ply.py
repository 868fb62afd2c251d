"""Minimal binary PLY point-cloud writer (replaces pyntcloud in the
reference eval, compute_depth_x_maps.py:124-131)."""

from __future__ import annotations

import numpy as np


def write_ply(path: str, points: np.ndarray) -> None:
    """Write an (N, 3) float array as a binary_little_endian PLY file."""
    points = np.asarray(points, dtype=np.float32)
    assert points.ndim == 2 and points.shape[1] == 3
    header = (
        "ply\n"
        "format binary_little_endian 1.0\n"
        f"element vertex {len(points)}\n"
        "property float x\n"
        "property float y\n"
        "property float z\n"
        "end_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(np.ascontiguousarray(points, dtype="<f4").tobytes())


def read_ply(path: str) -> np.ndarray:
    """Read back a PLY written by write_ply (for tests)."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    n = int(
        next(
            line.split()[-1]
            for line in data[:end].decode().splitlines()
            if line.startswith("element vertex")
        )
    )
    return np.frombuffer(data[end:], dtype="<f4").reshape(n, 3).copy()
