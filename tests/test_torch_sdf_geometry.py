"""The SDF primitive's host side in the PyTorch port against the JAX package
on the CPU: the MAPE loss, mesh loading and normalization, and the port's
own build of the triangle BVH against the JAX package's build."""

import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instant_ngp_tpu.geometry import bvh as jax_bvh
from instant_ngp_tpu.geometry import mesh_io as jax_mesh_io
from instant_ngp_tpu.ops import losses as jax_losses
from instant_ngp_torch import cuda_lib
from instant_ngp_torch.geometry import bvh as port_bvh
from instant_ngp_torch.geometry import mesh_io
from instant_ngp_torch.geometry.procedural import bumpy_torus, write_obj
from instant_ngp_torch.ops import losses

torch.set_num_threads(2)

TOL_MAPE = 1e-6  # relative: the same f32 formula


def cube_triangles() -> np.ndarray:
    """tests/test_tasks.py's cube: side 0.4 centred at 0.5, 12 triangles."""
    lo, hi = 0.3, 0.7
    v = np.array([[x, y, z] for x in (lo, hi) for y in (lo, hi) for z in (lo, hi)])
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]
    tris = []
    for a, b, c, d in quads:
        tris += [[v[a], v[b], v[c]], [v[a], v[c], v[d]]]
    return np.asarray(tris, np.float32)


def torus_triangles() -> np.ndarray:
    v, f = bumpy_torus(24, 12, seed=3)
    return mesh_io.normalize_to_unit_cube(v[f])[0]


MESHES = {"cube": cube_triangles, "torus": torus_triangles}


def test_mape_and_gradient_equal_jax():
    rng = np.random.default_rng(0)
    t = rng.standard_normal(4096).astype(np.float32) * 0.1
    p = rng.standard_normal(4096).astype(np.float32) * 0.1
    p[:8] = 0.0  # the denominator's floor
    ref, ref_grad = jax.value_and_grad(lambda q: jnp.mean(jax_losses.mape(t, q)))(p)
    pt = torch.from_numpy(p).requires_grad_(True)
    loss_fn = losses.loss_fn(losses.loss_type_from_string("Mape"))
    out = torch.mean(loss_fn(torch.from_numpy(t), pt))
    (grad,) = torch.autograd.grad(out, pt)
    np.testing.assert_allclose(float(out.detach()), float(ref), rtol=TOL_MAPE)
    np.testing.assert_allclose(grad.numpy(), np.asarray(ref_grad), rtol=TOL_MAPE, atol=0)
    per = losses.mape(torch.from_numpy(t), torch.from_numpy(p)).numpy()
    np.testing.assert_allclose(per, np.asarray(jax_losses.mape(t, p)), rtol=TOL_MAPE)


def test_load_obj_equals_jax(tmp_path):
    """Triangles, a quad (fan-triangulated), v/vt/vn tokens and negative
    indices."""
    v, f = bumpy_torus(16, 8, seed=1)
    path = tmp_path / "torus.obj"
    write_obj(path, v, f)
    with open(path, "a") as fh:
        fh.write("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nvt 0 0\nf -4/1/1 -3/1/1 -2/1/1 -1/1/1\n")
    ours = mesh_io.load_obj(path)
    np.testing.assert_array_equal(ours, jax_mesh_io.load_obj(path))
    assert ours.shape == (len(f) + 2, 3, 3)
    np.testing.assert_array_equal(ours[:len(f)], v[f])
    np.testing.assert_array_equal(mesh_io.load_mesh(path), jax_mesh_io.load_mesh(path))


def test_load_stl_equals_jax(tmp_path):
    tris = torus_triangles()
    binary = tmp_path / "torus.stl"
    with open(binary, "wb") as fh:
        fh.write(b"\0" * 80 + struct.pack("<I", len(tris)))
        for t in tris:
            fh.write(np.zeros(3, "<f4").tobytes() + t.astype("<f4").tobytes() + b"\0\0")
    ascii_ = tmp_path / "cube.stl"
    lines = ["solid cube"]
    for t in cube_triangles():
        lines += ["facet normal 0 0 0", "outer loop"]
        lines += [f"vertex {a!r} {b!r} {c!r}" for a, b, c in t.tolist()]
        lines += ["endloop", "endfacet"]
    ascii_.write_text("\n".join(lines + ["endsolid cube"]) + "\n")
    for path, expected in ((binary, tris), (ascii_, cube_triangles())):
        ours = mesh_io.load_stl(path)
        np.testing.assert_array_equal(ours, jax_mesh_io.load_stl(path))
        np.testing.assert_array_equal(ours, expected)
        np.testing.assert_array_equal(mesh_io.load_mesh(path), jax_mesh_io.load_mesh(path))
    with pytest.raises(ValueError):
        mesh_io.load_mesh(tmp_path / "mesh.ply")


def test_normalize_to_unit_cube_equals_jax():
    v, f = bumpy_torus(16, 8, seed=2)
    raw = v[f] * np.float32(3.7) + np.float32(-1.25)
    ours = mesh_io.normalize_to_unit_cube(raw)
    theirs = jax_mesh_io.normalize_to_unit_cube(raw)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    assert ours[0].min() >= 0.1 - 1e-6 and ours[0].max() <= 0.9 + 1e-6


def _query_points(rng, n=3000):
    """Uniform points in a box a little larger than the unit cube, and
    points near the surface of both meshes' scale."""
    return np.concatenate([rng.uniform(-0.1, 1.1, (n, 3)),
                           rng.uniform(0.25, 0.75, (n, 3))]).astype(np.float32)


@pytest.mark.parametrize("mesh", MESHES)
def test_bvh_equals_jax_build(mesh):
    """Every query of the port's build bit for bit the JAX package's build:
    signed_distance in every mode, closest_points, raytrace and inside."""
    tris = MESHES[mesh]()
    ours, theirs = port_bvh.TriangleBvh(tris), jax_bvh.TriangleBvh(tris)
    rng = np.random.default_rng(7)
    pts = _query_points(rng)
    assert port_bvh.SDF_MODES == jax_bvh.SDF_MODES
    for mode in port_bvh.SDF_MODES:
        d = ours.signed_distance(pts, mode=mode)
        np.testing.assert_array_equal(d, theirs.signed_distance(pts, mode=mode))
        if mode != "unsigned":
            assert 0 < np.mean(d < 0) < 1
    np.testing.assert_array_equal(ours.closest_points(pts), theirs.closest_points(pts))
    for mode in ("watertight", "raystab"):
        np.testing.assert_array_equal(ours.inside(pts, mode), theirs.inside(pts, mode))
    o = rng.uniform(-0.5, 1.5, (2000, 3)).astype(np.float32)
    d = rng.standard_normal((2000, 3)).astype(np.float32)
    d[:1000] = (0.5 - o[:1000])  # aimed at the centre (the torus's hole lets some through)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t, tri = ours.raytrace(o, d)
    t_ref, tri_ref = theirs.raytrace(o, d)
    np.testing.assert_array_equal(t, t_ref)
    np.testing.assert_array_equal(tri, tri_ref)
    assert np.isfinite(t).mean() > 0.1 and np.all((tri >= 0) == np.isfinite(t))


def test_bvh_cube_distances():
    """The JAX package's own cube checks (tests/test_tasks.py)."""
    bvh = port_bvh.TriangleBvh(cube_triangles())
    pts = np.array([[0.5, 0.5, 0.5], [0.1, 0.5, 0.5], [0.5, 0.75, 0.5]], np.float32)
    for mode in ("watertight", "raystab", "pseudonormal"):
        d = bvh.signed_distance(pts, mode=mode)
        np.testing.assert_allclose(d, [-0.2, 0.2, 0.05], atol=1e-4)
    t, tri = bvh.raytrace(np.array([[0.5, 0.5, -1.0]]), np.array([[0.0, 0.0, 1.0]]))
    np.testing.assert_allclose(t[0], 1.3, atol=1e-4)
    assert tri[0] >= 0


def test_bvh_library_is_the_ports_own():
    """The port builds its own copy of the source into build/instant_ngp_torch/,
    never loading the JAX package's library."""
    path = port_bvh.library_path()
    assert path.parent == cuda_lib.BUILD_DIR and path.name.startswith("libngpbvh_")
    assert port_bvh.SRC.parent == cuda_lib.CSRC
    port_bvh.load()
    assert path.exists()
    lib_file = port_bvh.load()._name
    assert lib_file == str(path) and "instant_ngp_tpu" not in lib_file


def test_bvh_queries_from_two_threads():
    """The producer thread and the caller query one BVH at once; the lazy
    pseudonormal build runs once (std::call_once)."""
    import threading

    tris = torus_triangles()
    pts = _query_points(np.random.default_rng(9))
    ref = jax_bvh.TriangleBvh(tris).signed_distance(pts, mode="pseudonormal")
    for _ in range(5):
        bvh = port_bvh.TriangleBvh(tris)
        out = [None] * 4

        def query(i):
            out[i] = bvh.signed_distance(pts, mode="pseudonormal")

        threads = [threading.Thread(target=query, args=(i,)) for i in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
        for o in out:
            np.testing.assert_array_equal(o, ref)
