"""Isosurface extraction and mesh export from trained fields (port of
``instant_ngp_tpu/geometry/marching_cubes.py``; reference marching_cubes.cu,
testbed_nerf.cu:3400-3654): sample the field on a dense grid (the density
network for NeRF, the SDF network for SDF), extract the isosurface by exact
256-case marching cubes (or marching tetrahedra), weld the vertices along
shared cell edges, colour them through the network, and optimise them.

The case tables are derived at import time, as in the JAX package (this
module keeps its own copy of that derivation: the cut-edge graph of each
corner configuration walked into cycles, ambiguous faces resolved by
isolating their inside corners, cycles oriented along the trilinear field's
gradient and fan-triangulated).

Everything after the tables runs as torch ops on the field's device:
classify the cells, expand the active ones by case into triangles in the
JAX package's emission order, interpolate a vertex on each cut edge, and
weld by edge key. A vertex is interpolated in f32 as p_a + t·(p_b − p_a)
with p_b − p_a ∈ {−1, 0, 1}: one rounding of p_a ± t, as numpy's f64 sum
rounded to f32 is. Duplicates of an edge key keep the position of their
first emission, as ``np.unique(..., return_index=True)`` does.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..io.png import write_png

# 6 tetrahedra decomposition of a cube (corner indices)
_TETS = np.array(
    [
        [0, 5, 1, 6],
        [0, 1, 2, 6],
        [0, 2, 3, 6],
        [0, 3, 7, 6],
        [0, 7, 4, 6],
        [0, 4, 5, 6],
    ]
)
_CORNERS = np.array(
    [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
     [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]]
)

# tetra case table: for each of the 16 sign cases, list of edges
# (pairs of tet-vertex indices) forming 0, 1, or 2 triangles
_TET_EDGES = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]


def _tet_triangles(case: int):
    """Triangles (as triples of edge indices) for a tet sign case."""
    inside = [i for i in range(4) if case & (1 << i)]
    if len(inside) == 0 or len(inside) == 4:
        return []
    if len(inside) == 3:
        inside = [i for i in range(4) if i not in inside]
        flip = True
    else:
        flip = False
    if len(inside) == 1:
        v = inside[0]
        edges = [_TET_EDGES.index(tuple(sorted((v, o)))) for o in range(4) if o != v]
        tri = [tuple(edges)]
    else:  # 2 inside
        a, b = inside
        others = [i for i in range(4) if i not in inside]
        c, d = others
        e_ac = _TET_EDGES.index(tuple(sorted((a, c))))
        e_ad = _TET_EDGES.index(tuple(sorted((a, d))))
        e_bc = _TET_EDGES.index(tuple(sorted((b, c))))
        e_bd = _TET_EDGES.index(tuple(sorted((b, d))))
        tri = [(e_ac, e_ad, e_bd), (e_ac, e_bd, e_bc)]
    if flip:
        tri = [(t[0], t[2], t[1]) for t in tri]
    return tri


_CASE_TRIS = [_tet_triangles(c) for c in range(16)]


# ---------------------------------------------------------------------------
# exact marching cubes: derived 256-case tables
# ---------------------------------------------------------------------------

# classic MC edge numbering over the _CORNERS layout above
_MC_EDGES = [
    (0, 1), (1, 2), (2, 3), (3, 0),
    (4, 5), (5, 6), (6, 7), (7, 4),
    (0, 4), (1, 5), (2, 6), (3, 7),
]
_MC_EDGE_INDEX = {tuple(sorted(e)): i for i, e in enumerate(_MC_EDGES)}
# cube faces as cyclic corner quads
_MC_FACES = [
    (0, 1, 2, 3), (4, 5, 6, 7),
    (0, 1, 5, 4), (1, 2, 6, 5), (2, 3, 7, 6), (3, 0, 4, 7),
]


def _derive_mc_case(config: int):
    """Triangles (triples of edge ids) for one corner configuration.
    Bit i of config set ⇔ corner i is INSIDE (value < iso)."""
    inside = [(config >> i) & 1 for i in range(8)]
    cut = [i for i, (a, b) in enumerate(_MC_EDGES) if inside[a] != inside[b]]
    if not cut:
        return []

    # per-face pairing of cut edges
    links: dict[int, list[int]] = {e: [] for e in cut}
    for quad in _MC_FACES:
        fe = []  # face's cut edges in boundary order
        for k in range(4):
            a, b = quad[k], quad[(k + 1) % 4]
            e = _MC_EDGE_INDEX[tuple(sorted((a, b)))]
            if e in links:
                fe.append((k, e))
        if len(fe) == 2:
            links[fe[0][1]].append(fe[1][1])
            links[fe[1][1]].append(fe[0][1])
        elif len(fe) == 4:
            # ambiguous face: two diagonal inside corners — isolate
            # them: pair the two face edges incident to each inside
            # corner (a sign-only rule, identical from both cells)
            for k in range(4):
                c = quad[k]
                if inside[c]:
                    e_prev = _MC_EDGE_INDEX[tuple(sorted((quad[k - 1], c)))]
                    e_next = _MC_EDGE_INDEX[tuple(sorted((c, quad[(k + 1) % 4])))]
                    links[e_prev].append(e_next)
                    links[e_next].append(e_prev)

    for e, ls in links.items():
        assert len(ls) == 2, (config, e, ls)

    # walk cycles
    unused = set(cut)
    tris = []
    corner_pos = _CORNERS.astype(np.float64)
    while unused:
        start = min(unused)
        cycle = [start]
        unused.discard(start)
        prev, cur = None, start
        while True:
            a, b = links[cur]
            nxt = a if a != prev else b
            if nxt == start:
                break
            cycle.append(nxt)
            unused.discard(nxt)
            prev, cur = cur, nxt

        # orient outward: the cycle is one connected isosurface piece
        # of the trilinear field with corner values −1 (inside) / +1
        # (outside); its normals must align with ∇field (which is
        # continuous across cells → globally crack-consistent winding).
        pts = np.array([
            corner_pos[_MC_EDGES[e][0]] * 0.5 + corner_pos[_MC_EDGES[e][1]] * 0.5
            for e in cycle
        ])
        vals = np.where(np.asarray(inside, bool), -1.0, 1.0)

        def trilerp_grad(p):
            g = np.zeros(3)
            eps = 1e-4
            for d in range(3):
                for s, sign in ((eps, 1.0), (-eps, -1.0)):
                    q = p.copy()
                    q[d] += s
                    f = 0.0
                    for ci in range(8):
                        w = 1.0
                        for dd in range(3):
                            cd = (ci >> dd) & 1 if False else _CORNERS[ci][dd]
                            w *= q[dd] if cd else (1.0 - q[dd])
                        f += vals[ci] * w
                    g[d] += sign * f / (2 * eps)
            return g

        score = 0.0
        for i in range(1, len(pts) - 1):
            n_tri = np.cross(pts[i] - pts[0], pts[i + 1] - pts[0])
            centroid = (pts[0] + pts[i] + pts[i + 1]) / 3.0
            score += np.dot(n_tri, trilerp_grad(centroid))
        if score < 0:
            cycle = cycle[::-1]

        for i in range(1, len(cycle) - 1):
            tris.append((cycle[0], cycle[i], cycle[i + 1]))
    return tris


_MC_CASES = [_derive_mc_case(c) for c in range(256)]
MC_MAX_TRIS = max(len(t) for t in _MC_CASES)


def _tables(device) -> dict:
    """The case tables as tensors on ``device``."""
    mc_tris = torch.zeros((256, MC_MAX_TRIS, 3), dtype=torch.int64)
    mc_ntris = torch.zeros((256,), dtype=torch.int64)
    for c, tris in enumerate(_MC_CASES):
        mc_ntris[c] = len(tris)
        if tris:
            mc_tris[c, :len(tris)] = torch.tensor(tris)
    return {"mc_tris": mc_tris.to(device), "mc_ntris": mc_ntris.to(device),
            "edge_a": torch.tensor([e[0] for e in _MC_EDGES], device=device),
            "edge_b": torch.tensor([e[1] for e in _MC_EDGES], device=device),
            "corners": torch.as_tensor(_CORNERS, dtype=torch.int64, device=device)}


def _as_field(values) -> torch.Tensor:
    return torch.as_tensor(np.asarray(values, np.float32) if not torch.is_tensor(values)
                           else values).to(torch.float32)


def _edge_vertices(values: torch.Tensor, pa: torch.Tensor, pb: torch.Tensor, iso: float):
    """The vertex on each cut edge pa → pb (int64 grid points, (M, 3)) and
    its weld key: t = (iso − v_a) / (v_b − v_a), a difference below 1e-12
    read as 1e-12, t clamped to [0, 1]."""
    X, Y, Z = values.shape
    va = values[pa[:, 0], pa[:, 1], pa[:, 2]]
    vb = values[pb[:, 0], pb[:, 1], pb[:, 2]]
    den = vb - va
    t = (iso - va) / torch.where(torch.abs(den) < 1e-12, 1e-12, den)
    p = pa.to(torch.float32) + torch.clamp(t, 0.0, 1.0)[:, None] * (pb - pa).to(torch.float32)
    ga = (pa[:, 0] * Y + pa[:, 1]) * Z + pa[:, 2]
    gb = (pb[:, 0] * Y + pb[:, 1]) * Z + pb[:, 2]
    keys = torch.minimum(ga, gb) * (X * Y * Z) + torch.maximum(ga, gb)
    return p, keys


def _weld(keys: torch.Tensor, by_first: bool):
    """Vertex ids of emissions ``keys`` and the emission each vertex takes
    its position from (its key's first). Ids follow the sorted keys
    (``by_first`` False: ``np.unique``) or the order of first emission
    (True: a dictionary filled in emission order)."""
    uniq, inv = torch.unique(keys, sorted=True, return_inverse=True)
    pos = torch.arange(keys.shape[0], device=keys.device)
    first = torch.full((uniq.shape[0],), keys.shape[0], dtype=torch.int64, device=keys.device)
    first = first.scatter_reduce(0, inv, pos, reduce="amin")
    if not by_first:
        return inv, first
    order = torch.argsort(first)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.shape[0], device=keys.device)
    return rank[inv], first[order]


def marching_cubes(values, iso: float = 0.0):
    """Exact marching cubes of values == iso on a dense (X, Y, Z) grid
    (marching_cubes.py:193). Inside = values < iso. Returns (vertices (V, 3)
    f32 grid coordinates, faces (F, 3) int32), welded along shared cell
    edges, on the field's device; bit for bit the JAX package's numpy
    version on the same field."""
    values = _as_field(values)
    dev = values.device
    X, Y, Z = values.shape
    tab = _tables(dev)
    config = torch.zeros((X - 1, Y - 1, Z - 1), dtype=torch.int64, device=dev)
    for c, (dx, dy, dz) in enumerate(_CORNERS.tolist()):
        config |= (values[dx:X - 1 + dx, dy:Y - 1 + dy, dz:Z - 1 + dz] < iso).to(torch.int64) << c
    config = config.reshape(-1)
    cells = torch.nonzero((config != 0) & (config != 255)).squeeze(1)
    config = config[cells]
    counts = tab["mc_ntris"][config]
    n_tris = int(counts.sum())
    if n_tris == 0:
        return (torch.zeros((0, 3), dtype=torch.float32, device=dev),
                torch.zeros((0, 3), dtype=torch.int32, device=dev))
    # triangles in the JAX package's order: by case, then the case's
    # triangle, then the cell
    row = torch.repeat_interleave(torch.arange(cells.shape[0], device=dev), counts)
    tri = torch.arange(n_tris, device=dev) - (torch.cumsum(counts, 0) - counts)[row]
    order = torch.sort(config[row] * MC_MAX_TRIS + tri, stable=True).indices
    row, tri = row[order], tri[order]
    edges = tab["mc_tris"][config[row], tri].reshape(-1)  # (3S,)
    cell = cells[row].repeat_interleave(3)
    base = torch.stack([cell // ((Y - 1) * (Z - 1)), (cell // (Z - 1)) % (Y - 1),
                        cell % (Z - 1)], -1)
    pa = base + tab["corners"][tab["edge_a"][edges]]
    pb = base + tab["corners"][tab["edge_b"][edges]]
    p, keys = _edge_vertices(values, pa, pb, iso)
    inv, first = _weld(keys, by_first=False)
    verts = p[first]
    faces = inv.reshape(-1, 3).to(torch.int32)
    ok = (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) & (faces[:, 0] != faces[:, 2])
    return verts, faces[ok]


def marching_tetrahedra(values, iso: float = 0.0):
    """Marching tetrahedra (six tetrahedra a cell) of values == iso on a
    dense (X, Y, Z) grid (marching_cubes.py:254). Returns (vertices (V, 3)
    f32 grid coordinates, faces (F, 3) int32) on the field's device; vertex
    ids in order of first emission (tetrahedron, case, triangle, corner,
    cell), bit for bit the JAX package's numpy version."""
    values = _as_field(values)
    dev = values.device
    X, Y, Z = values.shape
    corners = torch.as_tensor(_CORNERS, dtype=torch.int64, device=dev)
    signs = torch.stack([values[dx:X - 1 + dx, dy:Y - 1 + dy, dz:Z - 1 + dz] > iso
                         for dx, dy, dz in _CORNERS.tolist()], -1).reshape(-1, 8)
    n_in = signs.sum(-1)
    cells = torch.nonzero((n_in != 0) & (n_in != 8)).squeeze(1)
    signs = signs[cells]
    base = torch.stack([cells // ((Y - 1) * (Z - 1)), (cells // (Z - 1)) % (Y - 1),
                        cells % (Z - 1)], -1)
    weights = torch.tensor([1, 2, 4, 8], device=dev)
    ps, keys, blocks = [], [], []  # blocks: (emission start, number of cells)
    n_emit = 0
    for tet in _TETS.tolist():
        case = (signs[:, tet].to(torch.int64) * weights).sum(-1)
        for c in range(1, 15):
            tris = _CASE_TRIS[c]
            if not tris:
                continue
            sel = torch.nonzero(case == c).squeeze(1)
            if sel.numel() == 0:
                continue
            for tri in tris:
                for e in tri:
                    a, b = _TET_EDGES[e]
                    p, k = _edge_vertices(values, base[sel] + corners[tet[a]],
                                          base[sel] + corners[tet[b]], iso)
                    ps.append(p)
                    keys.append(k)
                blocks.append((n_emit, sel.numel()))
                n_emit += 3 * sel.numel()
    if not keys:
        return (torch.zeros((0, 3), dtype=torch.float32, device=dev),
                torch.zeros((0, 3), dtype=torch.int32, device=dev))
    vid, first = _weld(torch.cat(keys), by_first=True)
    verts = torch.cat(ps)[first]
    faces = torch.cat([vid[s:s + 3 * m].reshape(3, m).T for s, m in blocks])
    return verts, faces.to(torch.int32)


def compute_mesh_1ring(verts: torch.Tensor, faces: torch.Tensor):
    """Each vertex's 1-ring sum in homogeneous coordinates (V, 4) and its
    area-weighted normal (V, 3), both f64 (reference compute_mesh_1ring,
    marching_cubes.cu). The face normals are f32 cross products; the sums
    are ``index_add_`` in f64, in another order than the JAX package's
    ``np.add.at``."""
    faces = faces.to(torch.int64)
    tri = verts[faces]  # (F, 3, 3)
    fn = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]).to(torch.float64)
    acc = torch.zeros((verts.shape[0], 4), dtype=torch.float64, device=verts.device)
    nrm = torch.zeros((verts.shape[0], 3), dtype=torch.float64, device=verts.device)
    ones = torch.ones((faces.shape[0], 1), dtype=torch.float64, device=verts.device)
    for k in range(3):
        acc.index_add_(0, faces[:, k], torch.cat([tri[:, (k + 1) % 3].to(torch.float64), ones],
                                                 -1))
        nrm.index_add_(0, faces[:, k], fn)
    return acc, nrm


def vertex_normals(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Area-weighted unit vertex normals in f32 (testbed.py:1468-1476): the
    faces' f32 cross products summed into their vertices, divided by
    max(|n|, 1e-12); zeros without faces."""
    nrm = torch.zeros_like(verts)
    if verts.shape[0] and faces.shape[0]:
        f = faces.to(torch.int64)
        fn = torch.linalg.cross(verts[f[:, 1]] - verts[f[:, 0]], verts[f[:, 2]] - verts[f[:, 0]])
        for k in range(3):
            nrm.index_add_(0, f[:, k], fn)
        nrm = nrm / torch.clamp(torch.linalg.vector_norm(nrm, dim=-1, keepdim=True), min=1e-12)
    return nrm


def density_and_grad(task, v: torch.Tensor):
    """The activated density exp(clip(σ, ±15)) at unit-cube points v and
    its gradient: autograd of Σ exp(clip(σ)) through the density network
    (kernel F's dX) and the encoding (kernel K), marching_cubes.py:363-370."""
    params = {k: val.detach() for k, val in task.inference_params().items()}
    with torch.enable_grad():
        p = v.detach().requires_grad_(True)
        out = task.inference_density(p, params)
        dens = torch.exp(torch.clamp(out[:, 0].to(torch.float32), -15.0, 15.0))
        (g,) = torch.autograd.grad(dens.sum(), p)
    return dens.detach(), g


def optimise_mesh(task, verts, faces, n_steps: int = 25, thresh: float = 2.5,
                  smooth_amount: float = 2048.0, density_amount: float = 128.0,
                  inflate_amount: float = 1.0, lr: float = 1e-4) -> torch.Tensor:
    """Vertex optimisation of a NeRF mesh (marching_cubes.py:338; reference
    optimise_mesh_step, testbed_nerf.cu:3400-3456, and
    compute_mesh_opt_gradients, marching_cubes.cu:708-740): per step and
    vertex the gradient n̂(∇σ)·sign(σ − thresh)·density_amount + (v − 1-ring
    centroid)·smooth_amount − n̂_vertex·inflate_amount, stepped by Adam (β
    0.9, 0.99, ε 1e-8), in the JAX package's dtypes. Returns the vertices
    (V, 3) f32 on the task's device."""
    v = torch.as_tensor(np.asarray(verts, np.float32) if not torch.is_tensor(verts) else verts,
                        device=task.device).to(torch.float32).clone()
    faces = torch.as_tensor(np.asarray(faces) if not torch.is_tensor(faces) else faces,
                            device=task.device)
    m = torch.zeros_like(v)
    s2 = torch.zeros_like(v)
    b1, b2, eps = 0.9, 0.99, 1e-8
    for step in range(1, n_steps + 1):
        dens, grad = density_and_grad(task, v)
        n_in = grad / torch.clamp(torch.linalg.vector_norm(grad, dim=-1, keepdim=True), min=1e-9)
        acc, nrm = compute_mesh_1ring(v, faces)
        target = acc[:, :3] / torch.clamp(acc[:, 3:4], min=1.0)
        nrm_u = nrm / torch.clamp(torch.linalg.vector_norm(nrm, dim=-1, keepdim=True), min=1e-9)
        g = (n_in * torch.sign(dens - thresh)[:, None] * density_amount
             + (v - target) * smooth_amount - nrm_u * inflate_amount).to(torch.float32)
        m = b1 * m + (1 - b1) * g
        s2 = b2 * s2 + (1 - b2) * g * g
        mh = m / (1 - b1**step)
        vh = s2 / (1 - b2**step)
        v -= lr * mh / (torch.sqrt(vh) + eps)
    return v


def _unit_grid(res: int, device) -> torch.Tensor:
    """The centres of a res³ grid over the unit cube, (res³, 3) f32, x
    slowest."""
    xs = torch.from_numpy(((np.arange(res) + 0.5) / res).astype(np.float32)).to(device)
    gx, gy, gz = torch.meshgrid(xs, xs, xs, indexing="ij")
    return torch.stack([gx, gy, gz], -1).reshape(-1, 3)


CHUNK = 1 << 18  # field points a network call


@torch.no_grad()
def nerf_density(task, pts: torch.Tensor) -> torch.Tensor:
    """The activated density exp(clip(σ, ±15)) at unit-cube points, in
    chunks of 2^18 (kernels A and B on the card)."""
    out = torch.cat([task.inference_density(pts[i:i + CHUNK])[:, 0].to(torch.float32)
                     for i in range(0, pts.shape[0], CHUNK)])
    return torch.exp(torch.clamp(out, -15.0, 15.0))


@torch.no_grad()
def mesh_colors(task, verts: torch.Tensor) -> torch.Tensor:
    """A NeRF mesh's vertex colours: the full model at each vertex seen
    along the warped direction (0.5, 0.5, 0.5), through the rgb activation."""
    from ..common import network_to_rgb

    view = torch.full_like(verts, 0.5)
    params = task.inference_params()
    out = torch.cat([torch.func.functional_call(task.model, params,
                                                (verts[i:i + CHUNK // 2], view[i:i + CHUNK // 2]))
                     for i in range(0, verts.shape[0], CHUNK // 2)])
    return network_to_rgb(out[:, :3].to(torch.float32), task.rgb_activation)


def sample_field(task, res: int, iso: float | None = None):
    """The extraction field on the unit cube's res³ grid (x slowest) and
    its iso: NeRF iso − density (inside negative, iso 2.5 by default), SDF
    distance − iso (iso 0)."""
    from ..nerf.task import NerfTask

    pts = _unit_grid(res, task.device)
    if isinstance(task, NerfTask):
        iso = 2.5 if iso is None else iso
        return iso - nerf_density(task, pts).reshape(res, res, res), iso
    iso = 0.0 if iso is None else iso
    return task.sdf(pts).reshape(res, res, res) - iso, iso


def extract_mesh(task, res: int = 256, iso: float | None = None, with_colors: bool = True,
                 method: str = "cubes"):
    """Field → mesh (marching_cubes.py:399): (vertices (V, 3) in the unit
    cube, faces (F, 3) int32, colours (V, 3) or None), on the task's device.
    The field is sampled on the unit cube in model coordinates, whatever the
    scene's aabb, as the JAX package samples it. NeRF vertices take the
    network's colour; SDF vertices 0.7 grey."""
    from ..nerf.task import NerfTask

    field, _ = sample_field(task, res, iso)
    extractor = marching_cubes if method == "cubes" else marching_tetrahedra
    verts, faces = extractor(field, 0.0)
    verts = (verts + 0.5) / res
    colors = None
    if with_colors and isinstance(task, NerfTask) and verts.shape[0]:
        colors = mesh_colors(task, verts)
    elif with_colors and verts.shape[0]:
        colors = torch.full((verts.shape[0], 3), 0.7, dtype=torch.float32, device=verts.device)
    return verts, faces, colors


def get_marching_cubes_res(res_1d: int, aabb_min, aabb_max) -> np.ndarray:
    """Per-axis resolution scaled by the box's aspect, padded to a multiple
    of 16 (reference get_marching_cubes_res, marching_cubes.cu:40-48)."""
    lo = np.asarray(aabb_min, np.float32)
    hi = np.asarray(aabb_max, np.float32)
    diag = hi - lo
    scale = res_1d / max(float(diag.max()), 1e-9)
    res3d = (diag * scale + 0.5).astype(np.int64)
    return ((np.maximum(res3d, 1) + 15) // 16) * 16


@torch.no_grad()
def get_density_on_grid(task, res3d, aabb_min, aabb_max, to_local=None) -> torch.Tensor:
    """The task's field on an (rx, ry, rz) grid over the (possibly rotated)
    box (marching_cubes.py:462; reference testbed_nerf.cu:3502-3557): NeRF
    the activated density, SDF the distance. Grid coordinates are in the
    box's frame; world positions are Rᵀ·local. Returns a tensor on the
    task's device."""
    from ..nerf.task import NerfTask

    rx, ry, rz = (int(r) for r in res3d)
    lo = np.asarray(aabb_min, np.float32)
    hi = np.asarray(aabb_max, np.float32)
    axes = [lo[i] + (np.arange(r) + 0.5) / r * (hi[i] - lo[i]) for i, r in enumerate((rx, ry, rz))]
    g = np.meshgrid(*axes, indexing="ij")
    pts = np.stack(g, -1).reshape(-1, 3).astype(np.float32)
    if to_local is not None and not np.allclose(to_local, np.eye(3)):
        pts = pts @ np.asarray(to_local, np.float32)
    pts = torch.from_numpy(pts).to(task.device)
    if isinstance(task, NerfTask):
        amin = torch.as_tensor(np.asarray(task.aabb_min, np.float32), device=task.device)
        asize = torch.as_tensor(np.asarray(task.aabb_max, np.float32) - task.aabb_min,
                                device=task.device)
        out = nerf_density(task, (pts - amin) / asize)
    else:
        out = task.sdf(pts)
    return out.reshape(rx, ry, rz)


def save_density_grid_to_png(density, path, thresh: float = 2.5, density_range: float = 4.0,
                             flip_y_and_z_axes: bool = False) -> None:
    """The z-slices of an (rx, ry, rz) field tiled into one grayscale PNG
    sheet (``io/png``), [thresh − range, thresh + range] → [0, 255], ~√rz
    slices a column, y flipped a slice (marching_cubes.py:503; reference
    save_density_grid_to_png, marching_cubes.cu:957-1030)."""
    d = torch.as_tensor(density).to(torch.float32)
    if flip_y_and_z_axes:
        d = d.permute(0, 2, 1)
    rx, ry, rz = d.shape
    scale = 128.0 / density_range
    ndown = max(1, int(np.sqrt(rz)))
    nacross = (rz + ndown - 1) // ndown
    vals = torch.clamp((d - thresh) * scale + 128.5, 0.0, 255.0).to(torch.uint8)
    tiles = vals.flip(1).permute(2, 1, 0)  # (rz, ry, rx)
    pad = ndown * nacross - rz
    if pad:
        tiles = torch.cat([tiles, torch.zeros((pad, ry, rx), dtype=torch.uint8,
                                              device=tiles.device)])
    sheet = tiles.reshape(ndown, nacross, ry, rx).permute(0, 2, 1, 3).reshape(ndown * ry,
                                                                            nacross * rx)
    write_png(Path(path), sheet.cpu().numpy())
