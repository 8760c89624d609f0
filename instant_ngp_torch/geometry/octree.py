"""Triangle octree: the occupancy hierarchy of a mesh surface (port of
``instant_ngp_tpu/geometry/octree.py``; reference triangle_octree.cuh), which
hosts the Takikawa (NGLOD) feature encoding.

Each level l is a dense boolean occupancy grid of resolution 2^l. Occupancy
is built on the host from area-weighted samples of the triangle soup
(``np.random.default_rng(0)``, so that one mesh gives the JAX package's
octree bit for bit), splatted into the finest level, dilated by one cell and
reduced to the coarser levels.
"""

from __future__ import annotations

import numpy as np


class TriangleOctree:
    def __init__(self, triangles: np.ndarray, depth: int = 7, samples_per_area: float = 4e6):
        """triangles: (N, 3, 3) in [0,1]³. depth: finest level (res 2^depth)."""
        self.depth = depth
        e1 = triangles[:, 1] - triangles[:, 0]
        e2 = triangles[:, 2] - triangles[:, 0]
        areas = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
        total_area = float(areas.sum())
        n_samples = min(int(samples_per_area * max(total_area, 1e-6)), 4_000_000)
        n_samples = max(n_samples, 100_000)
        rng = np.random.default_rng(0)
        cdf = np.cumsum(areas) / max(total_area, 1e-12)
        ti = np.clip(np.searchsorted(cdf, rng.random(n_samples)), 0, len(triangles) - 1)
        b1 = rng.random(n_samples)
        b2 = rng.random(n_samples)
        flip = b1 + b2 > 1
        b1 = np.where(flip, 1 - b1, b1)
        b2 = np.where(flip, 1 - b2, b2)
        t = triangles[ti]
        pts = t[:, 0] + e1[ti] * b1[:, None] + e2[ti] * b2[:, None]

        res = 1 << depth
        idx = np.clip((pts * res).astype(np.int64), 0, res - 1)
        fine = np.zeros((res, res, res), bool)
        fine[idx[:, 0], idx[:, 1], idx[:, 2]] = True
        levels = [None] * (depth + 1)
        levels[depth] = _dilate(fine)  # conservative coverage of sparse sampling
        for lv in range(depth - 1, -1, -1):
            r = 1 << lv
            levels[lv] = levels[lv + 1].reshape(r, 2, r, 2, r, 2).any(axis=(1, 3, 5))
        self.levels: list[np.ndarray] = levels

    def n_nodes(self, level: int) -> int:
        return int(self.levels[level].sum())

    def contains(self, points: np.ndarray, level: int | None = None) -> np.ndarray:
        level = self.depth if level is None else level
        res = 1 << level
        idx = np.clip((np.asarray(points) * res).astype(np.int64), 0, res - 1)
        return self.levels[level][idx[..., 0], idx[..., 1], idx[..., 2]]


def _dilate(grid: np.ndarray) -> np.ndarray:
    out = grid.copy()
    for axis in range(3):
        out |= np.roll(grid, 1, axis) | np.roll(grid, -1, axis)
    return out
