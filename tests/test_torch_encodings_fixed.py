"""The port's Frequency, OneBlob, TriangleWave and Takikawa encodings (with
its triangle octree) against the JAX package's on seeded inputs, on the CPU:
the output widths and feature order, the values, and the gradients (of the
input for the fixed encodings, of the vertex table for Takikawa)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instant_ngp_tpu.geometry.octree import TriangleOctree as JaxOctree
from instant_ngp_tpu.ops import encodings as jax_enc
from instant_ngp_tpu.ops.takikawa import TakikawaEncoding as JaxTakikawa
from instant_ngp_torch.geometry.mesh_io import normalize_to_unit_cube
from instant_ngp_torch.geometry.octree import TriangleOctree
from instant_ngp_torch.geometry.procedural import bumpy_torus
from instant_ngp_torch.ops import encodings as port_enc
from instant_ngp_torch.ops.takikawa import TakikawaEncoding

torch.set_num_threads(2)

# Values: f32 elementwise maps in the same order of operations. Frequency's
# sin and cos of angles up to 2^11·π differ by an ulp or two between torch
# and XLA (6e-8 measured), OneBlob's polynomial by XLA's fused multiply-adds
# (1.2e-7), Takikawa's trilerp likewise (4.8e-7 on tables in ±1).
TOL_VALUE = 1e-6
# Gradients, per element against the largest |value|: the same derivative
# formulas; Frequency's carries the angle's 2^k·π factor, so its ulp-level
# differences grow with it.
TOL_GRAD = 1e-5

FIXED = [("Frequency", {"n_frequencies": 12}, 3), ("Frequency", {"n_frequencies": 6}, 2),
         ("OneBlob", {"n_bins": 64}, 3), ("OneBlob", {"n_bins": 128}, 2),
         ("TriangleWave", {"n_frequencies": 12}, 3), ("TriangleWave", {"n_frequencies": 8}, 2)]


@pytest.mark.parametrize("otype,kw,n_dims", FIXED)
def test_fixed_encoding_equals_jax(otype, kw, n_dims):
    cfg = {"otype": otype, **kw}
    theirs = jax_enc.encoding_from_config(cfg, n_dims)
    ours = port_enc.encoding_from_config(cfg, n_dims)
    assert ours.n_output_dims == theirs.n_output_dims
    x = np.random.default_rng(3).random((777, n_dims), dtype=np.float32)
    ref = np.asarray(jax.jit(lambda v: theirs(None, v))(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = ours(xt)
    assert out.shape == ref.shape == (777, ours.n_output_dims)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0, atol=TOL_VALUE)
    if otype == "TriangleWave":  # piecewise linear: the same floors, the same slopes
        np.testing.assert_array_equal(out.detach().numpy(), ref)
    g = np.random.default_rng(4).standard_normal(ref.shape).astype(np.float32)
    gref = np.asarray(jax.jit(jax.grad(lambda v: jnp.sum(theirs(None, v) * g)))(x))
    (gout,) = torch.autograd.grad((out * torch.from_numpy(g)).sum(), xt)
    np.testing.assert_allclose(gout.numpy(), gref, rtol=0, atol=TOL_GRAD * np.abs(gref).max())


def test_composite_order_and_slices_equal_jax():
    """A Composite of the fixed encodings over explicit, overlapping slices
    concatenates them in the JAX package's order."""
    cfg = {"otype": "Composite", "nested": [
        {"otype": "Frequency", "n_frequencies": 4, "n_dims_to_encode": 2,
         "dims_to_encode_begin": 0},
        {"otype": "OneBlob", "n_bins": 8, "n_dims_to_encode": 2, "dims_to_encode_begin": 1},
        {"otype": "TriangleWave", "n_frequencies": 5, "dims_to_encode_begin": 2}]}
    theirs, ours = jax_enc.encoding_from_config(cfg, 3), port_enc.encoding_from_config(cfg, 3)
    x = np.random.default_rng(5).random((300, 3), dtype=np.float32)
    ref = np.asarray(theirs(theirs.init(jax.random.PRNGKey(0)), x))
    assert ours.n_output_dims == ref.shape[1] == 16 + 16 + 5
    np.testing.assert_allclose(ours(torch.from_numpy(x)).numpy(), ref, rtol=0, atol=TOL_VALUE)


@pytest.fixture(scope="module")
def torus_triangles():
    v, f = bumpy_torus(32, 16, seed=3)
    return normalize_to_unit_cube(v[f].astype(np.float32))[0]


@pytest.mark.parametrize("depth,start", [(5, 2), (4, 0)])
def test_octree_equals_jax(torus_triangles, depth, start):
    """Every occupancy level and every vertex map bit for bit: the same
    seeded surface samples, splat, dilation and numbering."""
    theirs, ours = JaxOctree(torus_triangles, depth=depth), TriangleOctree(torus_triangles,
                                                                           depth=depth)
    for a, b in zip(theirs.levels, ours.levels):
        np.testing.assert_array_equal(a, b)
    assert ours.n_nodes(depth) == theirs.n_nodes(depth) > 0
    pts = np.random.default_rng(6).random((200, 3))
    np.testing.assert_array_equal(ours.contains(pts), theirs.contains(pts))
    je, pe = JaxTakikawa(theirs, 4, start), TakikawaEncoding(ours, 4, start)
    assert pe.n_entries == je.n_entries and pe.n_output_dims == je.n_output_dims
    for i, (lj, lp) in enumerate(zip(je.levels, pe.levels)):
        assert dataclasses_tuple(lj) == dataclasses_tuple(lp)
        np.testing.assert_array_equal(getattr(pe, f"vertex_map_{i}").numpy(),
                                      np.asarray(je.vertex_maps[i]))


def dataclasses_tuple(level) -> tuple:
    return (level.level, level.resolution, level.n_vertices, level.offset)


def test_takikawa_equals_jax(torus_triangles):
    """Values and the vertex table's gradient on a table drawn in ±1, at
    points in the cube and outside the octree (clamped to [0, 1 − 1e-6])."""
    je = JaxTakikawa(JaxOctree(torus_triangles, depth=5), 4, 2)
    pe = TakikawaEncoding(TriangleOctree(torus_triangles, depth=5), 4, 2)
    rng = np.random.default_rng(7)
    table = rng.uniform(-1, 1, (je.n_entries, 4)).astype(np.float32)
    x = np.concatenate([rng.random((900, 3)), rng.uniform(-0.2, 1.2, (100, 3))]).astype(np.float32)
    ref = np.asarray(jax.jit(lambda t, v: je(t, v))(table, x))
    with torch.no_grad():
        pe.table.copy_(torch.from_numpy(table))
    out = pe(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0, atol=TOL_VALUE)
    assert np.any(ref == 0.0) and np.any(ref != 0.0)  # empty and occupied cells both met
    g = rng.standard_normal(ref.shape).astype(np.float32)
    gref = np.asarray(jax.jit(jax.grad(lambda t: jnp.sum(je(t, x) * g)))(table))
    (gout,) = torch.autograd.grad((out * torch.from_numpy(g)).sum(), pe.table)
    np.testing.assert_allclose(gout.numpy(), gref, rtol=0, atol=TOL_GRAD * np.abs(gref).max())
