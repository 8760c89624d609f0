"""Triangle BVH over ctypes (port of ``instant_ngp_tpu/geometry/bvh.py``).

The library is the port's own copy of the JAX package's host BVH,
``csrc/bvh.cpp``, compiled with ``g++`` at first use into
``build/instant_ngp_torch/`` at the repository root and loaded with ctypes.
It is keyed by a hash of the source and the host (``-march=native`` binaries
are not portable), so an edited source or another CPU rebuilds. Queries take
and return numpy arrays on the host: the SDF primitive's ground truth is
host work that overlaps the training step on the card. ctypes releases the
GIL for the length of a query.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import time
from pathlib import Path

import numpy as np

from ..cuda_lib import BUILD_DIR

SRC = Path(__file__).resolve().parents[1] / "csrc" / "bvh.cpp"
GXX_FLAGS = ["-O3", "-march=native", "-funroll-loops", "-std=c++17", "-shared", "-fPIC"]

SDF_MODES = {
    "unsigned": 0,
    "watertight": 1,
    "raystab": 2,
    "pathescape": 2,
    "pseudonormal": 3,
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "bvh_create": ([_P, _I], _P),
    "bvh_destroy": ([_P], None),
    # handle, points, n, mode, out
    "bvh_signed_distance": ([_P, _P, _I, _I, _P], None),
    "bvh_closest_points": ([_P, _P, _I, _P], None),
    # handle, origins, dirs, n, t, tri
    "bvh_raytrace": ([_P, _P, _P, _I, _P, _P], None),
    "bvh_inside": ([_P, _P, _I, _I, _P], None),
}

_lib = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    h.update(platform.machine().encode())
    h.update(platform.processor().encode())
    return BUILD_DIR / f"libngpbvh_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the library if it is missing. Returns (path, seconds spent
    compiling; 0 when it was already built)."""
    path = library_path()
    if path.exists():
        return path, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SRC), "-lpthread"],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed to build {SRC.name} ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, path)  # atomic against concurrent builds
    return path, time.perf_counter() - t0


def load() -> ctypes.CDLL:
    """The loaded BVH library, building it first if needed."""
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
        _lib = lib
    return _lib


def _points(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32).reshape(-1, 3)


class TriangleBvh:
    """BVH over a triangle soup (N, 3, 3) float32."""

    def __init__(self, triangles: np.ndarray):
        self.triangles = np.ascontiguousarray(triangles, np.float32).reshape(-1, 3, 3)
        self._lib = load()
        self._handle = self._lib.bvh_create(self.triangles.ctypes.data, len(self.triangles))

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.bvh_destroy(self._handle)
            self._handle = None

    def signed_distance(self, points: np.ndarray, mode: str = "raystab") -> np.ndarray:
        pts = _points(points)
        out = np.empty(len(pts), np.float32)
        self._lib.bvh_signed_distance(self._handle, pts.ctypes.data, len(pts), SDF_MODES[mode],
                                      out.ctypes.data)
        return out

    def closest_points(self, points: np.ndarray) -> np.ndarray:
        pts = _points(points)
        out = np.empty_like(pts)
        self._lib.bvh_closest_points(self._handle, pts.ctypes.data, len(pts), out.ctypes.data)
        return out

    def raytrace(self, origins: np.ndarray, dirs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(t (N,) f32, +inf on a miss; triangle index (N,) int32, −1 on a miss)."""
        o, d = _points(origins), _points(dirs)
        if len(o) != len(d):
            raise ValueError(f"{len(o)} origins for {len(d)} directions")
        t = np.empty(len(o), np.float32)
        tri = np.empty(len(o), np.int32)
        self._lib.bvh_raytrace(self._handle, o.ctypes.data, d.ctypes.data, len(o),
                               t.ctypes.data, tri.ctypes.data)
        return t, tri

    def inside(self, points: np.ndarray, mode: str = "raystab") -> np.ndarray:
        pts = _points(points)
        out = np.empty(len(pts), np.uint8)
        self._lib.bvh_inside(self._handle, pts.ctypes.data, len(pts), SDF_MODES[mode],
                             out.ctypes.data)
        return out.astype(bool)
