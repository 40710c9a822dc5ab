"""Binary STL bounding-box reader (numpy, no external deps)."""

from __future__ import annotations

import struct

import numpy as np


def stl_aabb(path: str):
    """Return (min_xyz, max_xyz) of a binary STL mesh."""
    with open(path, "rb") as f:
        header = f.read(84)
        ntri = struct.unpack("<I", header[80:84])[0]
        data = np.frombuffer(f.read(ntri * 50), dtype=np.uint8)
    data = data.reshape(ntri, 50)
    # each record: normal (3f), v0 (3f), v1 (3f), v2 (3f), attr (u16)
    floats = np.ascontiguousarray(data[:, :48]).view(np.float32).reshape(ntri, 4, 3)
    verts = floats[:, 1:4, :].reshape(-1, 3)
    return verts.min(axis=0), verts.max(axis=0)
