"""Morton (Z-order) permutations, numpy-vectorized.

Port of ``instant_ngp_tpu/ops/morton.py``. Only needed at snapshot
boundaries: the reference stores the density grid Morton-ordered; the
runtime layout is dense [mip, x, y, z]."""

from __future__ import annotations

import numpy as np


def _compact1by2(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64) & 0x1249249249249249
    x = (x ^ (x >> 2)) & 0x10C30C30C30C30C3
    x = (x ^ (x >> 4)) & 0x100F00F00F00F00F
    x = (x ^ (x >> 8)) & 0x1F0000FF0000FF
    x = (x ^ (x >> 16)) & 0x1F00000000FFFF
    x = (x ^ (x >> 32)) & 0x1FFFFF
    return x


def morton3d_invert(code) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    code = np.asarray(code, np.uint64)
    return (
        _compact1by2(code).astype(np.uint32),
        _compact1by2(code >> 1).astype(np.uint32),
        _compact1by2(code >> 2).astype(np.uint32),
    )


def dense_to_morton_perm(g: int) -> np.ndarray:
    """Permutation p so that morton_flat[i] = dense_xyz.reshape(-1)[p[i]]
    for a dense [x, y, z] (C-order) grid of size g³."""
    codes = np.arange(g**3, dtype=np.uint64)
    x, y, z = morton3d_invert(codes)
    return (x.astype(np.int64) * g + y) * g + z


def morton_to_dense_perm(g: int) -> np.ndarray:
    p = dense_to_morton_perm(g)
    inv = np.empty_like(p)
    inv[p] = np.arange(len(p))
    return inv
