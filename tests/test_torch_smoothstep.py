"""The grid's smoothstep interpolation in the port against the JAX package, on
the CPU: the table gradients (kernel E's plain version, exact and with
stochastic corner draws) and the position gradient (kernel K's plain version,
through the port's autograd) against ``jax.vjp`` of the JAX ``hashgrid_encode``
at D = 2 and 3 on grids with dense and hashed levels, and a config with
``"interpolation": "Smoothstep"`` through ``NerfNetwork.from_config``. The
encode itself is a case of ``test_torch_hashgrid.py::test_encode_equals_jax``,
the stochastic-corner encode one of
``test_torch_render_modes.py::test_stochastic_encode_equals_jax_encode_infer``.
"""

import copy
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instant_ngp_tpu.config import CONFIGS_DIR
from instant_ngp_tpu.models.nerf_network import NerfNetwork as JaxNerfNetwork
from instant_ngp_tpu.ops import hashgrid as jax_hg
from instant_ngp_torch.models.nerf_network import NerfNetwork, params_from_jax
from instant_ngp_torch.ops import hashgrid as port_hg
from torch_configs_common import numpy_tree, shrink

torch.set_num_threads(2)

# 4 levels at resolutions 4..32 (D = 3: three dense levels and a hashed one in
# 2^12 rows) and 6 at 4..128 (D = 2: four dense, two hashed in 2^8 rows)
GRIDS = {
    3: {"otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2, "log2_hashmap_size": 12,
        "base_resolution": 4, "per_level_scale": 2.0, "interpolation": "Smoothstep"},
    2: {"otype": "HashGrid", "n_levels": 6, "n_features_per_level": 2, "log2_hashmap_size": 8,
        "base_resolution": 4, "per_level_scale": 2.0, "interpolation": "Smoothstep"},
}
# Table gradients per level against the level's largest |ref| (the JAX side
# sums in f32 with grad_method "merge", the port adds in another order);
# d/dx against its largest |ref| (sums of a few dozen f32 terms a sample).
TOL_TABLE, TOL_DX = 1e-5, 1e-5


def _encodings(n_dims, corners=8):
    cfg = GRIDS[n_dims]
    theirs = dataclasses.replace(jax_hg.grid_encoding_from_config(cfg, n_dims),
                                 hashed_grad_corners=corners, grad_method="merge")
    ours = port_hg.grid_encoding_from_config(cfg, n_dims)
    assert ours.interpolation == theirs.interpolation == "smoothstep"
    assert any(lv.hashed for lv in ours.levels) and not all(lv.hashed for lv in ours.levels)
    return theirs, ours


def _positions(rng, enc, n=2000):
    """Random points, exact cell boundaries of every level (f = 0: dt/dx
    is 0 there), cell middles and the edges of the cube."""
    d = enc.n_dims
    x = [rng.random((n, d), dtype=np.float32)]
    for lv in enc.levels:
        k = rng.integers(0, lv.resolution, (64, d))
        x.append(((k - 0.5) / np.float32(lv.scale)).astype(np.float32))
        x.append((k / np.float32(lv.scale)).astype(np.float32))
    x.append(np.array([[0.0] * d, [1.0] * d, [0.5] * d], np.float32))
    return np.clip(np.concatenate(x), 0.0, 1.0).astype(np.float32)


def _setup(n_dims, corners, seed):
    theirs, ours = _encodings(n_dims, corners)
    rng = np.random.default_rng(seed)
    x = _positions(rng, ours)
    g = rng.standard_normal((x.shape[0], ours.n_output_dims)).astype(np.float32)
    tables = tuple(rng.uniform(-1, 1, (lv.size, ours.n_features_per_level)).astype(np.float32)
                   for lv in ours.levels)
    with torch.no_grad():
        ours.table.copy_(torch.from_numpy(np.concatenate(tables)))
    return theirs, ours, x, g, tables


@pytest.mark.parametrize("corners", [1, 2, 8])
@pytest.mark.parametrize("n_dims", [2, 3])
def test_table_gradient_equals_jax_vjp(n_dims, corners):
    """Kernel E's plain version, per level, through the port's autograd:
    every corner (8), or k stochastic draws on the hashed levels from the
    smoothstep weights (1, 2; the draw JAX's bit for bit, so the same rows)."""
    theirs, ours, x, g, tables = _setup(n_dims, corners, 11)
    ours.hashed_grad_corners = corners
    _, vjp = jax.vjp(lambda p: jax_hg.hashgrid_encode(theirs, p, jnp.asarray(x)),
                     tuple(map(jnp.asarray, tables)))
    ref = [np.asarray(t) for t in vjp(jnp.asarray(g))[0]]
    out = ours(torch.from_numpy(x))
    (flat,) = torch.autograd.grad(out, [ours.table], torch.from_numpy(g))
    flat = flat.numpy()
    for lv, r in zip(ours.levels, ref):
        np.testing.assert_allclose(flat[lv.offset:lv.offset + lv.size], r, rtol=0,
                                   atol=TOL_TABLE * float(np.abs(r).max()))


@pytest.mark.parametrize("n_dims", [2, 3])
def test_position_gradient_equals_jax_vjp(n_dims):
    """Kernel K's plain version (``hashgrid_encode_dx_plain``, reached through
    the port's autograd on x) against the JAX analytic d/dx: dt/dx is
    6f(1 − f)·scale per axis, 0 on cell boundaries."""
    theirs, ours, x, g, tables = _setup(n_dims, 8, 12)
    _, vjp = jax.vjp(lambda p: jax_hg.hashgrid_encode(theirs, tuple(map(jnp.asarray, tables)), p),
                     jnp.asarray(x))
    ref = np.asarray(vjp(jnp.asarray(g))[0])
    xt = torch.from_numpy(x).requires_grad_(True)
    (dx,) = torch.autograd.grad(ours(xt), [xt], torch.from_numpy(g))
    np.testing.assert_allclose(dx.numpy(), ref, rtol=0, atol=TOL_DX * float(np.abs(ref).max()))
    plain = port_hg.hashgrid_encode_dx_plain(ours.levels, "smoothstep", ours.table.detach(),
                                             torch.from_numpy(x), torch.from_numpy(g))
    assert torch.equal(plain, dx)
    # the linear d/dx differs
    linear = port_hg.hashgrid_encode_dx_plain(ours.levels, "linear", ours.table.detach(),
                                              torch.from_numpy(x), torch.from_numpy(g))
    assert not torch.allclose(linear, plain)


def test_smoothstep_weights_at_the_ends():
    """t(0) = 0, t(1/2) = 1/2, t(1) = 1, and the corner weights sum to 1."""
    f = torch.tensor([0.0, 0.5, 1.0, 0.25], dtype=torch.float32)
    np.testing.assert_array_equal(port_hg.smoothstep(f).numpy()[:3], [0.0, 0.5, 1.0])
    lv = port_hg.grid_levels(3, 1, 12, 4, 2.0)[0]
    x = torch.rand((64, 3), generator=torch.Generator().manual_seed(0))
    _, w = port_hg._level_corners(lv, "smoothstep", x)
    np.testing.assert_allclose(w.sum(0).numpy(), 1.0, atol=1e-6)


def _base_smoothstep_config():
    cfg = json.loads((CONFIGS_DIR / "nerf" / "base.json").read_text())
    cfg = shrink(copy.deepcopy(cfg))
    cfg["encoding"]["interpolation"] = "Smoothstep"
    return cfg


def test_config_path_reaches_smoothstep():
    """``configs/nerf/base.json`` with ``"interpolation": "Smoothstep"``
    (shrunk as the config tests shrink it) through both packages'
    ``NerfNetwork.from_config``: the port's grid interpolates by smoothstep
    and the forward equals the JAX package's with the parameters carried
    across (2e-2 of max |ref|, the config tests' bf16 tolerance), and not the
    linear forward."""
    cfg = _base_smoothstep_config()
    theirs = JaxNerfNetwork.from_config(cfg)
    params = numpy_tree(theirs.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    params["pos_enc"] = jax.tree.map(
        lambda t: rng.uniform(-1, 1, np.shape(t)).astype(np.float32), params["pos_enc"])
    ours = NerfNetwork.from_config(cfg, device="cpu")
    assert ours.pos_encoding.interpolation == "smoothstep"
    params_from_jax(ours, params)
    pos = rng.random((256, 3), dtype=np.float32)
    dirs = rng.random((256, 3), dtype=np.float32)
    ref = np.asarray(jax.jit(lambda p, a, b: theirs(p, a, b).astype(jnp.float32))(params, pos,
                                                                                    dirs))
    with torch.no_grad():
        out = ours(torch.from_numpy(pos), torch.from_numpy(dirs)).numpy()
        ours.pos_encoding.interpolation = "linear"
        lin = ours(torch.from_numpy(pos), torch.from_numpy(dirs)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-2 * np.abs(ref).max())
    assert np.abs(lin - ref).max() > 2e-2 * np.abs(ref).max()
