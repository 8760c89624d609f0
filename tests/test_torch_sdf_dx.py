"""The hash grid's position gradient (kernel K's plain version) and the SDF
model's input gradient, the render's analytic normals, against the JAX
package on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instant_ngp_tpu.models.factory import autoconfig_grid_encoding as jax_autoconfig
from instant_ngp_tpu.models.network import NetworkWithInputEncoding as JaxNetwork
from instant_ngp_tpu.ops import hashgrid as jax_hg
from instant_ngp_torch.models.factory import autoconfig_grid_encoding
from instant_ngp_torch.models.network import NetworkWithInputEncoding, params_from_jax
from instant_ngp_torch.ops import hashgrid as port_hg

torch.set_num_threads(2)

# d/dx against jax.vjp: the same corners, weights and order; only XLA's
# contractions differ, so 1e-5 of the largest |dx|
TOL_DX = 1e-5
# normals: the cosine of the port's and JAX's model input gradients where
# |∇| > 1e-3 (bf16 MLP on both sides, its f32 sums in another order)
MIN_COSINE = 0.9999

GRID_3D = {"otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2,
           "log2_hashmap_size": 12, "base_resolution": 4}
GRID_2D = {"otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2,
           "log2_hashmap_size": 10, "base_resolution": 4}


def _encodings(n_dims, interpolation, n_features=2):
    if n_dims == 3:
        cfg, mode, kw = GRID_3D, "sdf", {}
    else:
        cfg, mode, kw = GRID_2D, "image", {"image_resolution": (256, 256)}
    cfg = dict(cfg, n_features_per_level=n_features)
    port_cfg = autoconfig_grid_encoding(cfg, mode, **kw)
    assert port_cfg == jax_autoconfig(cfg, mode, **kw)
    port_cfg = dict(port_cfg, interpolation=interpolation)
    return (jax_hg.grid_encoding_from_config(port_cfg, n_dims),
            port_hg.grid_encoding_from_config(port_cfg, n_dims))


def _positions(rng, enc, n_dims, n=2000):
    """Random points, exact cell boundaries of every level, and in 3-D the
    simplex ties (x = y = z, x = y ≠ z, y = z ≠ x, x = z ≠ y)."""
    x = [rng.random((n, n_dims), dtype=np.float32)]
    for lv in enc.levels:
        k = rng.integers(0, lv.resolution, (64, n_dims))
        x.append(((k - 0.5) / np.float32(lv.scale)).astype(np.float32))
    if n_dims == 3:
        u = rng.random(200, dtype=np.float32)
        v = rng.random(200, dtype=np.float32)
        x += [np.stack([u, u, u], -1), np.stack([u, u, v], -1), np.stack([v, u, u], -1),
              np.stack([u, v, u], -1)]
    return np.clip(np.concatenate(x), 0.0, 1.0).astype(np.float32)


@pytest.mark.parametrize("n_features", [2, 4])
@pytest.mark.parametrize("interpolation,n_dims", [("linear", 3), ("simplex", 3), ("nearest", 3),
                                                  ("linear", 2), ("nearest", 2)])
def test_dx_equals_jax_vjp(interpolation, n_dims, n_features):
    """``hashgrid_encode_dx_plain`` against jax.vjp of ``hashgrid_encode``
    with respect to x, on dense and hashed levels (3-D: level 0 dense; 2-D:
    levels 0 and 1), with ties of the simplex ranks."""
    theirs, ours = _encodings(n_dims, interpolation, n_features)
    n_dense = 1 if n_dims == 3 else 2
    assert [lv.hashed for lv in ours.levels] == [False] * n_dense + [True] * (4 - n_dense)
    rng = np.random.default_rng(11)
    tables = tuple(rng.uniform(-1, 1, (lv.size, n_features)).astype(np.float32)
                   for lv in ours.levels)
    x = _positions(rng, ours, n_dims)
    g = rng.standard_normal((x.shape[0], ours.n_output_dims)).astype(np.float32)

    @jax.jit
    def jax_dx(tables, x, g):
        _, vjp = jax.vjp(lambda p: jax_hg.hashgrid_encode(theirs, tables, p), x)
        return vjp(g)[0]

    ref = np.asarray(jax_dx(tables, x, g))
    out = port_hg.hashgrid_encode_dx_plain(ours.levels, interpolation,
                                           torch.from_numpy(np.concatenate(tables)),
                                           torch.from_numpy(x), torch.from_numpy(g)).numpy()
    assert out.shape == x.shape and out.dtype == np.float32
    if interpolation == "nearest":
        np.testing.assert_array_equal(out, 0.0)
        np.testing.assert_array_equal(ref, 0.0)
        return
    scale = float(np.abs(ref).max())
    assert scale > 1.0
    np.testing.assert_allclose(out, ref, rtol=0, atol=TOL_DX * scale)


def test_backward_runs_only_what_is_asked(monkeypatch):
    """The table gradient (E) only where the table takes one, dx (K) only
    where x does: a training step runs E alone, the normals K alone."""
    _, enc = _encodings(3, "linear")
    x = torch.from_numpy(np.random.default_rng(0).random((64, 3), dtype=np.float32))
    calls = []
    real_bwd, real_dx = port_hg.hashgrid_encode_bwd_plain, port_hg.hashgrid_encode_dx_plain
    monkeypatch.setattr(port_hg, "hashgrid_encode_bwd_plain",
                        lambda *a: calls.append("E") or real_bwd(*a))
    monkeypatch.setattr(port_hg, "hashgrid_encode_dx_plain",
                        lambda *a: calls.append("K") or real_dx(*a))
    enc.use_kernel = False
    enc(x).sum().backward()
    assert calls == ["E"] and enc.table.grad is not None
    calls.clear()
    enc.table.grad = None
    xg = x.clone().requires_grad_(True)
    with torch.no_grad():
        table = enc.table.detach()
    out = port_hg._GridEncodeFunction.apply(enc, table, xg)
    (dx,) = torch.autograd.grad(out.sum(), xg)
    assert calls == ["K"] and dx.shape == x.shape


SDF_CONFIG = {"encoding": {"otype": "HashGrid", "n_levels": 6, "n_features_per_level": 2,
                           "log2_hashmap_size": 12, "base_resolution": 8},
              "network": {"otype": "FullyFusedMLP", "activation": "ReLU",
                          "output_activation": "None", "n_neurons": 32, "n_hidden_layers": 2}}


@pytest.mark.parametrize("interpolation", ["Linear", "Simplex"])
def test_model_input_gradient_equals_jax(interpolation):
    """The SDF model's input gradient (the render's analytic normals:
    kernel F's dX, then K) against JAX's vmap(grad) of the model at one
    point, with the weights carried across and a trained-looking table."""
    cfg = {**SDF_CONFIG, "encoding": {**SDF_CONFIG["encoding"], "interpolation": interpolation}}
    cfg["encoding"] = jax_autoconfig(cfg["encoding"], "sdf")
    theirs = JaxNetwork.from_config(cfg, n_input_dims=3, n_output_dims=1)
    params = theirs.init(jax.random.PRNGKey(3))
    rng = np.random.default_rng(5)
    params["enc"] = tuple(jnp.asarray(rng.uniform(-0.5, 0.5, t.shape).astype(np.float32))
                          for t in params["enc"])
    ours = NetworkWithInputEncoding.from_config(cfg, 3, 1)
    params_from_jax(ours, jax.tree.map(np.asarray, params))
    x = rng.random((1500, 3), dtype=np.float32)

    grad_fn = jax.jit(jax.vmap(jax.grad(
        lambda p, xi: theirs(p, xi[None]).astype(jnp.float32)[0, 0], argnums=1),
        in_axes=(None, 0)))
    ref = np.asarray(grad_fn(params, x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = ours(xt)[:, 0]
    (n,) = torch.autograd.grad(out, xt, grad_outputs=torch.ones_like(out))
    n = n.numpy()
    norm_ref, norm = np.linalg.norm(ref, axis=-1), np.linalg.norm(n, axis=-1)
    sel = norm_ref > 1e-3
    assert sel.mean() > 0.9
    cos = np.sum(n[sel] * ref[sel], -1) / (norm[sel] * norm_ref[sel])
    assert cos.min() >= MIN_COSINE, cos.min()
