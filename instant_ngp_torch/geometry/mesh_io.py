"""Triangle meshes (port of ``instant_ngp_tpu/geometry/mesh_io.py``): OBJ
and STL (ASCII and binary) to a triangle soup, the SDF primitive's
normalization into the unit cube (reference testbed_sdf.cu:1363-1447), and
the mesh writers of mesh export (OBJ, binary PLY, and the OBJ with a UV atlas
and baked texture), byte for byte the JAX package's. The writers take numpy
arrays or tensors; a tensor is copied to the host as f32 first.
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


def _host(a, dtype=np.float32) -> np.ndarray:
    if a is None:
        return None
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype)


def save_obj(path, vertices, faces, colors=None) -> None:
    """Wavefront OBJ: ``v x y z [r g b]`` lines (numpy f32's shortest
    repr), then ``f`` lines, 1-based (mesh_io.py:84)."""
    vertices, faces, colors = _host(vertices), _host(faces, np.int64), _host(colors)
    if colors is not None:
        lines = [f"v {v[0]} {v[1]} {v[2]} {c[0]} {c[1]} {c[2]}\n" for v, c in zip(vertices, colors)]
    else:
        lines = [f"v {v[0]} {v[1]} {v[2]}\n" for v in vertices]
    lines += [f"f {a} {b} {c}\n" for a, b, c in (faces + 1).tolist()]
    Path(path).write_text("".join(lines))


def read_ply(path):
    """Read a PLY that ``save_ply`` wrote → (vertices (V, 3) f32, faces (F,
    3) int32, colours (V, 3) uint8 or None)."""
    data = Path(path).read_bytes()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode().splitlines()
    n_v = int(next(ln for ln in header if ln.startswith("element vertex")).split()[-1])
    n_f = int(next(ln for ln in header if ln.startswith("element face")).split()[-1])
    fields = [("p", "<f4", 3)] + ([("c", "u1", 3)] if "property uchar red" in header else [])
    vrec = np.frombuffer(data, np.dtype(fields), n_v, end)
    frec = np.frombuffer(data, np.dtype([("n", "u1"), ("i", "<i4", 3)]), n_f,
                         end + vrec.nbytes)
    if np.any(frec["n"] != 3):
        raise ValueError(f"{path}: faces that are not triangles")
    return (vrec["p"].copy(), frec["i"].copy(),
            vrec["c"].copy() if "c" in vrec.dtype.names else None)


def save_ply(path, vertices, faces, colors=None) -> None:
    """Binary little-endian PLY (mesh_io.py:96): f32 positions, optional
    uchar colours round(c·255), faces as a uchar count 3 and three int32,
    written whole through structured arrays."""
    vertices, faces, colors = _host(vertices), _host(faces, np.int64), _host(colors)
    n_v, n_f = len(vertices), len(faces)
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n_v}",
              "property float x", "property float y", "property float z"]
    if colors is not None:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    header += [f"element face {n_f}", "property list uchar int vertex_indices", "end_header"]
    if colors is not None:
        vrec = np.empty(n_v, np.dtype([("p", "<f4", 3), ("c", "u1", 3)]))
        vrec["c"] = np.clip(colors * 255.0 + 0.5, 0, 255).astype(np.uint8)
    else:
        vrec = np.empty(n_v, np.dtype([("p", "<f4", 3)]))
    vrec["p"] = vertices
    frec = np.empty(n_f, np.dtype([("n", "u1"), ("i", "<i4", 3)]))
    frec["n"] = 3
    frec["i"] = faces
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        f.write(vrec.tobytes())
        f.write(frec.tobytes())


def save_obj_unwrapped(path, vertices, faces, colors=None, quad_res: int = 8) -> None:
    """OBJ with a per-triangle UV atlas and a baked texture (mesh_io.py:117;
    reference unwrap_it, marching_cubes.cu:806-930): triangle pairs take
    (quad_res + 3) × quad_res texel quads of a near-square atlas, each
    triangle's texels the mean of its vertex colours; faces reference
    v/vt/vn, the normals area-weighted. Writes the OBJ, its ``.mtl`` and the
    texture as ``.png`` (``io/png``) beside it."""
    from ..io.png import write_png

    path = str(path)
    vertices = _host(vertices)
    faces = _host(faces, np.int64)
    colors = _host(colors)
    n_tri = len(faces)
    numquads = (n_tri + 1) // 2
    numquadsx = max(int(np.sqrt(numquads) + 4) & ~3, 4)
    numquadsy = (numquads + numquadsx - 1) // numquadsx
    qy = quad_res
    qx = qy + 3
    texw, texh = qx * numquadsx, qy * numquadsy
    d = qy - 1
    i = np.arange(n_tri)
    q = i // 2
    x0 = (q % numquadsx) * qx
    y0 = (q // numquadsx) * qy
    even = (i % 2 == 0)[:, None]
    cx = np.where(even, np.stack([x0, x0 + d, x0], -1), np.stack([x0 + 3, x0 + 3 + d, x0 + 3 + d], -1))
    cy = np.where(even, np.stack([y0, y0 + d, y0 + d], -1), np.stack([y0, y0, y0 + d], -1))
    uv = np.stack([(cx + 0.5) / texw, 1.0 - (cy + 0.5) / texh], -1)  # (n_tri, 3, 2) f64

    tex = np.full((texh, texw, 3), 128, np.uint8)
    if colors is not None:
        colors = np.clip(colors, 0.0, 1.0)
        c = (colors[faces].mean(1) * 255.0 + 0.5).astype(np.uint8)  # (n_tri, 3)
        rows = (y0[:, None] + np.arange(qy)[None, :])  # (n_tri, qy)
        cols = (x0 + np.where(even[:, 0], 0, 3))[:, None] + np.arange(qy)[None, :]
        tex[rows[:, :, None], cols[:, None, :]] = c[:, None, None, :]
    base = path.rsplit(".", 1)[0]
    write_png(base + ".png", tex)
    mtl = base + ".mtl"
    name = Path(base).name
    Path(mtl).write_text(f"newmtl ngp\nKa 1 1 1\nKd 1 1 1\nmap_Kd {name}.png\n")

    nrm = np.zeros_like(vertices)
    tri = vertices[faces]
    fn = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    for k in range(3):
        np.add.at(nrm, faces[:, k], fn)
    nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-9)

    lines = [f"mtllib {Path(mtl).name}\n"]
    if colors is not None:
        lines += [f"v {v[0]:.5f} {v[1]:.5f} {v[2]:.5f} {c[0]:.3f} {c[1]:.3f} {c[2]:.3f}\n"
                  for v, c in zip(vertices.tolist(), colors.tolist())]
    else:
        lines += [f"v {v[0]:.5f} {v[1]:.5f} {v[2]:.5f}\n" for v in vertices.tolist()]
    lines += [f"vn {n[0]:.5f} {n[1]:.5f} {n[2]:.5f}\n" for n in nrm.tolist()]
    lines += [f"vt {u:.6f} {v:.6f}\n" for u, v in uv.reshape(-1, 2).tolist()]
    lines.append("usemtl ngp\n")
    lines += [f"f {a + 1}/{3 * t + 1}/{a + 1} {b + 1}/{3 * t + 2}/{b + 1} {c + 1}/{3 * t + 3}/{c + 1}\n"
              for t, (a, b, c) in enumerate(faces.tolist())]
    Path(path).write_text("".join(lines))
