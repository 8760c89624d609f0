"""Triangle-mesh loading (port of the load half of
``instant_ngp_tpu/geometry/mesh_io.py``): OBJ and STL (ASCII and binary) to a
triangle soup, and the SDF primitive's normalization into the unit cube
(reference testbed_sdf.cu:1363-1447). The writers wait for mesh export.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np


def load_obj(path) -> np.ndarray:
    """Parse OBJ → triangle soup (N, 3, 3) float32; polygons are
    fan-triangulated, negative indices count from the end."""
    verts = []
    faces = []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif line.startswith("f "):
                idx = [int(tok.split("/")[0]) for tok in line.split()[1:]]
                for k in range(1, len(idx) - 1):
                    faces.append((idx[0], idx[k], idx[k + 1]))
    v = np.asarray(verts, np.float32)
    f_arr = np.asarray(faces, np.int64)
    f_arr = np.where(f_arr > 0, f_arr - 1, len(v) + f_arr)
    return v[f_arr]


def load_stl(path) -> np.ndarray:
    """ASCII or binary STL → (N, 3, 3) float32."""
    data = Path(path).read_bytes()
    if data[:5].lower() == b"solid" and b"facet" in data[:500]:
        tris = []
        cur = []
        for line in data.decode(errors="ignore").splitlines():
            line = line.strip()
            if line.startswith("vertex"):
                parts = line.split()
                cur.append((float(parts[1]), float(parts[2]), float(parts[3])))
                if len(cur) == 3:
                    tris.append(cur)
                    cur = []
        return np.asarray(tris, np.float32)
    n = struct.unpack("<I", data[80:84])[0]
    arr = np.frombuffer(data, np.uint8, n * 50, 84).reshape(n, 50)
    return np.ascontiguousarray(arr[:, 12:48].copy().view(np.float32).reshape(n, 3, 3))


def load_mesh(path) -> np.ndarray:
    path = Path(path)
    suffix = path.suffix.lower()
    if suffix == ".obj":
        return load_obj(path)
    if suffix == ".stl":
        return load_stl(path)
    raise ValueError(f"unsupported mesh format {path.suffix}")


def normalize_to_unit_cube(tris: np.ndarray, margin: float = 0.1):
    """Scale and centre into [margin, 1 − margin]³ (reference load_mesh,
    testbed_sdf.cu:1402-1412). Returns (tris, scale, offset) with world =
    mesh·scale + offset."""
    lo = tris.reshape(-1, 3).min(0)
    hi = tris.reshape(-1, 3).max(0)
    size = (hi - lo).max()
    scale = (1.0 - 2 * margin) / size
    center = (lo + hi) / 2
    out = (tris - center) * scale + 0.5
    return out.astype(np.float32), scale, (0.5 - center * scale)
