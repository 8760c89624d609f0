"""Hash-grid and direction encodings of the PyTorch port against the JAX
package, on the CPU (the plain versions of kernel A, and at D = 2 of
kernel E)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instant_ngp_tpu.models.factory import autoconfig_grid_encoding as jax_autoconfig
from instant_ngp_tpu.ops import encodings as jax_enc
from instant_ngp_tpu.ops import hashgrid as jax_hg
from instant_ngp_torch.models.factory import autoconfig_grid_encoding
from instant_ngp_torch.ops import encodings as port_enc
from instant_ngp_torch.ops import hashgrid as port_hg

torch.set_num_threads(2)

FOX = {"otype": "HashGrid", "n_levels": 8, "n_features_per_level": 4, "log2_hashmap_size": 19,
       "base_resolution": 16, "interpolation": "Simplex"}
CONFIGS = {
    "fox": (FOX, 4),
    "small_f2": ({"otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2,
                  "log2_hashmap_size": 12, "base_resolution": 4}, 1),
    "small_f4": ({"otype": "HashGrid", "n_levels": 4, "n_features_per_level": 4,
                  "log2_hashmap_size": 12, "base_resolution": 4}, 2),
}


def _encodings(name, interpolation=None):
    cfg, aabb_scale = CONFIGS[name]
    if interpolation is not None:
        cfg = dict(cfg, interpolation=interpolation)
    port_cfg = autoconfig_grid_encoding(cfg, "nerf", aabb_scale=aabb_scale)
    assert port_cfg == jax_autoconfig(cfg, "nerf", aabb_scale=aabb_scale)
    return (jax_hg.grid_encoding_from_config(port_cfg, 3),
            port_hg.grid_encoding_from_config(port_cfg, 3))


def _positions(rng, enc, n=3000):
    """Random points plus exact cell boundaries of every level and
    simplex ties (x = y = z, x = y > z, two-way and three-way)."""
    x = [rng.random((n, 3), dtype=np.float32)]
    for lv in enc.levels:
        k = rng.integers(0, lv.resolution, (64, 3))
        x.append(((k - 0.5) / np.float32(lv.scale)).astype(np.float32))
    u = rng.random(200, dtype=np.float32)
    v = rng.random(200, dtype=np.float32)
    x += [np.stack([u, u, u], -1), np.stack([u, u, v], -1), np.stack([v, u, u], -1),
          np.array([[0, 0, 0], [1, 1, 1], [0.5, 0.5, 0.5], [0, 1, 0.5]], np.float32)]
    return np.clip(np.concatenate(x), 0.0, 1.0).astype(np.float32)


def _level_tuple(lv):
    return (lv.scale, lv.resolution, lv.size, lv.offset, lv.hashed)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_levels_equal_jax(name):
    theirs, ours = _encodings(name)
    assert [_level_tuple(lv) for lv in ours.levels] == [_level_tuple(lv) for lv in theirs.levels]
    assert ours.n_entries == theirs.n_entries


def test_fox_levels_are_the_documented_ones():
    _, ours = _encodings("fox")
    assert ours.per_level_scale == pytest.approx(2.43803, abs=1e-5)
    assert [lv.hashed for lv in ours.levels] == [False, False] + [True] * 6
    assert [lv.size for lv in ours.levels[:3]] == [4096, 64000, 524288]
    assert ours.n_entries == 3_213_824


@pytest.mark.parametrize("interpolation", ["linear", "simplex", "nearest", "smoothstep"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_encode_equals_jax(name, interpolation):
    theirs, ours = _encodings(name, interpolation)
    rng = np.random.default_rng(3)
    tables = tuple(rng.uniform(-1, 1, (lv.size, ours.n_features_per_level)).astype(np.float32)
                   for lv in ours.levels)
    with torch.no_grad():
        ours.table.copy_(torch.from_numpy(np.concatenate(tables)))
    x = _positions(rng, ours)
    # the render path compiles the encoding, so compare with the jitted form
    ref = np.asarray(jax.jit(lambda t, p: theirs(t, p))(tables, x))
    out = ours(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)

    # corner indices match exactly
    port_idx = [port_hg._level_corners(lv, ours.interpolation, torch.from_numpy(x))[0]
                for lv in ours.levels]
    for lv, idx in zip(theirs.levels, port_idx):
        op = theirs._level_op(lv)

        def corners(p, op=op):
            grid, t, _ = jax_hg._corner_setup(op, p)
            return jax_hg._level_corners(op, grid, t)[0]

        np.testing.assert_array_equal(idx.numpy(), np.asarray(jax.jit(corners)(x)))

    # max_level masking, scalar and per-sample
    for max_level in (np.float32(0.5), rng.random(x.shape[0], dtype=np.float32)):
        ref = np.asarray(jax.jit(lambda t, p, m: theirs(t, p, max_level=m))(tables, x, max_level))
        out = ours(torch.from_numpy(x), max_level=torch.from_numpy(np.asarray(max_level))).detach().numpy()
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("cfg", [
    {"otype": "Composite", "nested": [
        {"n_dims_to_encode": 3, "otype": "SphericalHarmonics", "degree": 4},
        {"otype": "Identity"}]},
    {"otype": "SphericalHarmonics", "degree": 4},
    {"otype": "SphericalHarmonics", "degree": 2},
])
def test_direction_encodings_equal_jax(cfg):
    theirs = jax_enc.encoding_from_config(cfg, 3)
    ours = port_enc.encoding_from_config(cfg, 3)
    assert ours.n_output_dims == theirs.n_output_dims
    rng = np.random.default_rng(5)
    d = rng.standard_normal((4096, 3)).astype(np.float32)
    d = ((d / np.linalg.norm(d, axis=-1, keepdims=True) + 1.0) * 0.5).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p: theirs(None, p))(d))
    np.testing.assert_allclose(ours(torch.from_numpy(d)).numpy(), ref, rtol=0, atol=1e-6)


def test_identity_in_composite_is_dropped_like_jax():
    cfg = {"otype": "Composite", "nested": [
        {"n_dims_to_encode": 3, "otype": "SphericalHarmonics", "degree": 4}, {"otype": "Identity"}]}
    ours = port_enc.encoding_from_config(cfg, 3)
    assert len(ours.nested) == len(jax_enc.encoding_from_config(cfg, 3).nested) == 1


# --- D = 2, the image primitive's grid: kernel A's and E's plain versions
# 6 levels at resolutions 4..32 in a 2^8 table: levels 0-3 dense, 4-5 hashed
IMAGE_ENC = {"otype": "HashGrid", "n_levels": 6, "n_features_per_level": 2,
             "log2_hashmap_size": 8, "base_resolution": 4}
IMAGE_RES = (64, 48)
TOL_HASHED, TOL_DENSE = 1e-5, 2e-2  # as tests/test_torch_train_ops.py: JAX splats dense levels in bf16


def _encodings_2d(interpolation="linear", corners=1):
    cfg = autoconfig_grid_encoding(IMAGE_ENC, "image", image_resolution=IMAGE_RES)
    assert cfg == jax_autoconfig(IMAGE_ENC, "image", image_resolution=IMAGE_RES)
    cfg = dict(cfg, interpolation=interpolation)
    theirs = dataclasses.replace(jax_hg.grid_encoding_from_config(cfg, 2),
                                 hashed_grad_corners=corners)
    return theirs, port_hg.grid_encoding_from_config(cfg, 2)


def _positions_2d(rng, enc, n=3000):
    """Random points, exact cell boundaries of every level, and the edges."""
    x = [rng.random((n, 2), dtype=np.float32)]
    for lv in enc.levels:
        k = rng.integers(0, lv.resolution, (64, 2))
        x.append(((k - 0.5) / np.float32(lv.scale)).astype(np.float32))
    x.append(np.array([[0, 0], [1, 1], [0, 1], [0.5, 0.5]], np.float32))
    return np.clip(np.concatenate(x), 0.0, 1.0).astype(np.float32)


def test_levels_2d_equal_jax():
    theirs, ours = _encodings_2d()
    assert [_level_tuple(lv) for lv in ours.levels] == [_level_tuple(lv) for lv in theirs.levels]
    assert [lv.hashed for lv in ours.levels] == [False] * 4 + [True] * 2


@pytest.mark.parametrize("interpolation", ["linear", "nearest", "simplex"])
def test_encode_2d_equals_jax(interpolation):
    """Simplex is 3-D only: at D = 2 both packages interpolate 4 corners."""
    theirs, ours = _encodings_2d(interpolation)
    rng = np.random.default_rng(8)
    tables = tuple(rng.uniform(-1, 1, (lv.size, 2)).astype(np.float32) for lv in ours.levels)
    with torch.no_grad():
        ours.table.copy_(torch.from_numpy(np.concatenate(tables)))
    x = _positions_2d(rng, ours)
    ref = np.asarray(jax.jit(lambda t, p: theirs(t, p))(tables, x))
    np.testing.assert_allclose(ours(torch.from_numpy(x)).detach().numpy(), ref, rtol=0, atol=1e-6)
    for lv, jlv in zip(ours.levels, theirs.levels):
        op = theirs._level_op(jlv)

        def corners(p, op=op):
            grid, t, _ = jax_hg._corner_setup(op, p)
            return jax_hg._level_corners(op, grid, t)[0]

        idx = port_hg._level_corners(lv, ours.interpolation, torch.from_numpy(x))[0]
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jax.jit(corners)(x)))


@pytest.mark.parametrize("corners", [1, 2, 4])
@pytest.mark.parametrize("interpolation", ["linear", "nearest"])
def test_table_gradient_2d_equals_jax_vjp(interpolation, corners):
    """Kernel E's plain version at D = 2 against jax.vjp, per level: hashed
    levels (stochastic below 4 corners, the draw JAX's) to 1e-5 of the
    level's max, dense levels to bf16 tolerance."""
    theirs, ours = _encodings_2d(interpolation, corners)
    rng = np.random.default_rng(9)
    x = _positions_2d(rng, ours)
    g = rng.standard_normal((x.shape[0], ours.n_output_dims)).astype(np.float32)
    params = theirs.init(jax.random.PRNGKey(0))
    _, vjp = jax.vjp(lambda p: jax_hg.hashgrid_encode(theirs, p, jnp.asarray(x)), params)
    ref = [np.asarray(t) for t in vjp(jnp.asarray(g))[0]]
    flat = port_hg.hashgrid_encode_bwd_plain(ours.levels, interpolation, torch.from_numpy(x),
                                             torch.from_numpy(g), ours.n_entries, corners).numpy()
    for lv, r in zip(ours.levels, ref):
        tol = (TOL_HASHED if lv.hashed else TOL_DENSE) * float(np.abs(r).max())
        np.testing.assert_allclose(flat[lv.offset:lv.offset + lv.size], r, rtol=0, atol=tol)
