"""A closed, non-convex procedural mesh made from a seed: a torus whose tube
radius carries seeded sinusoidal bumps, for tests and for ``chip_smoke.py``
where no scanned mesh is in the repository. At its default 256 × 136 (u, v)
grid it has 69,632 triangles, about the size of the reference's
``bunny.obj`` (69,451).
"""

from __future__ import annotations

import numpy as np


def bumpy_torus(n_u: int = 256, n_v: int = 136, seed: int = 0, major: float = 1.0,
                minor: float = 0.4, n_bumps: int = 6,
                amplitude: float = 0.15) -> tuple[np.ndarray, np.ndarray]:
    """(vertices (n_u·n_v, 3) f32, faces (2·n_u·n_v, 3) int64), faces wound
    outward. The tube radius is minor · (1 + Σ_k a_k sin(i_k u + j_k v + φ_k))
    with Σ|a_k| = amplitude < 1 and integer frequencies, so the surface is
    closed, seamless and never crosses itself while minor·(1 + amplitude) <
    major."""
    rng = np.random.default_rng(seed)
    freq_u = rng.integers(1, 7, n_bumps)
    freq_v = rng.integers(1, 5, n_bumps)
    phase = rng.uniform(0.0, 2 * np.pi, n_bumps)
    amp = rng.uniform(0.5, 1.0, n_bumps)
    amp *= amplitude / amp.sum()
    u = np.arange(n_u) * (2 * np.pi / n_u)
    v = np.arange(n_v) * (2 * np.pi / n_v)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    r = minor * (1.0 + np.sum(amp * np.sin(uu[..., None] * freq_u + vv[..., None] * freq_v
                                           + phase), axis=-1))
    ring = major + r * np.cos(vv)
    verts = np.stack([ring * np.cos(uu), r * np.sin(vv), ring * np.sin(uu)], -1)
    i, j = np.meshgrid(np.arange(n_u), np.arange(n_v), indexing="ij")
    a = i * n_v + j
    b = ((i + 1) % n_u) * n_v + j
    c = ((i + 1) % n_u) * n_v + (j + 1) % n_v
    d = i * n_v + (j + 1) % n_v
    faces = np.concatenate([np.stack([a, d, c], -1).reshape(-1, 3),
                            np.stack([a, c, b], -1).reshape(-1, 3)])
    return verts.reshape(-1, 3).astype(np.float32), faces.astype(np.int64)


def write_obj(path, vertices: np.ndarray, faces: np.ndarray) -> None:
    """A minimal OBJ: one ``v`` line a vertex, one ``f`` line a triangle
    (1-based indices)."""
    lines = [f"v {x:.9g} {y:.9g} {z:.9g}" for x, y, z in np.asarray(vertices, np.float64)]
    lines += [f"f {a + 1} {b + 1} {c + 1}" for a, b, c in np.asarray(faces)]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
