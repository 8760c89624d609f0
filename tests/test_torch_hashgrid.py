"""Hash-grid and direction encodings of the PyTorch port against the JAX
package, on the CPU (the plain versions of kernel A)."""

import jax
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


@pytest.mark.parametrize("interpolation", ["linear", "simplex", "nearest"])
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
    out = ours(torch.from_numpy(x)).numpy()
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
        out = ours(torch.from_numpy(x), max_level=torch.from_numpy(np.asarray(max_level))).numpy()
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
