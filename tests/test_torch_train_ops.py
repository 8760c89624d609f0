"""The plain versions of the training kernels against the JAX package on
the CPU: kernel E (hash-grid table gradients) against ``jax.vjp`` of
``hashgrid_encode``, kernel F (MLP backward) against ``jax.vjp`` of
``MLP.__call__``, kernel H (scatter-add) against ``.at[idx].add``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instant_ngp_tpu.ops import hashgrid as jax_hg
from instant_ngp_tpu.ops import mlp as jax_mlp
from instant_ngp_torch.ops import hashgrid as port_hg
from instant_ngp_torch.ops.mlp_kernel import fused_mlp_bwd_plain
from instant_ngp_torch.ops.scatter import scatter_add_rows_plain

torch.set_num_threads(2)

# 6 levels at resolutions 4..128 in a 2^12 table: levels 0-2 dense, 3-5 hashed
ENC = dict(n_dims=3, n_levels=6, n_features_per_level=2, log2_hashmap_size=12,
           base_resolution=4, per_level_scale=2.0)
N = 3000
# Hashed levels: the same products w_c·g summed in another order (JAX sorts
# them), f32 round-off only. Dense levels: JAX sums them in a bf16 matmul
# splat (weights, g and the weight products rounded to bf16), the port in
# f32, so they are held to a bf16 tolerance.
TOL_HASHED = 1e-5
TOL_DENSE = 2e-2


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.random((N, 3), dtype=np.float32)
    g = rng.standard_normal((N, ENC["n_levels"] * ENC["n_features_per_level"])).astype(np.float32)
    return x, g


@pytest.mark.parametrize("corners", [1, 2, 8])
@pytest.mark.parametrize("interpolation", ["linear", "simplex", "nearest"])
def test_table_gradient_equals_jax_vjp(interpolation, corners):
    x, g = _inputs(3)
    enc = jax_hg.GridEncoding(**ENC, interpolation=interpolation, hashed_grad_corners=corners)
    params = enc.init(jax.random.PRNGKey(0))
    _, vjp = jax.vjp(lambda p: jax_hg.hashgrid_encode(enc, p, jnp.asarray(x)), params)
    ref = [np.asarray(t) for t in vjp(jnp.asarray(g))[0]]
    levels = port_hg.grid_levels(3, ENC["n_levels"], ENC["log2_hashmap_size"],
                                 ENC["base_resolution"], ENC["per_level_scale"])
    assert [lv.hashed for lv in levels] == [False, False, False, True, True, True]
    n_entries = levels[-1].offset + levels[-1].size
    flat = port_hg.hashgrid_encode_bwd_plain(levels, interpolation, torch.from_numpy(x),
                                             torch.from_numpy(g), n_entries, corners).numpy()
    for lv, r in zip(levels, ref):
        out = flat[lv.offset:lv.offset + lv.size]
        scale = float(np.abs(r).max())
        tol = (TOL_HASHED if lv.hashed else TOL_DENSE) * scale
        np.testing.assert_allclose(out, r, rtol=0, atol=tol)


def test_stochastic_draw_is_jax_draw_bit_for_bit():
    """One draw per hashed level deposits g at exactly the JAX corner: with
    g = 1 on one sample at a time the two tables hold the same single row."""
    x, _ = _inputs(4)
    enc = jax_hg.GridEncoding(**ENC, interpolation="simplex", hashed_grad_corners=1)
    levels = port_hg.grid_levels(3, ENC["n_levels"], ENC["log2_hashmap_size"],
                                 ENC["base_resolution"], ENC["per_level_scale"])
    n_entries = levels[-1].offset + levels[-1].size
    params = enc.init(jax.random.PRNGKey(1))
    xs = x[:64]
    g = np.zeros((64, ENC["n_levels"] * 2), np.float32)
    g[:, 6:] = 1.0  # hashed levels only
    _, vjp = jax.vjp(lambda p: jax_hg.hashgrid_encode(enc, p, jnp.asarray(xs)), params)
    ref = np.concatenate([np.asarray(t) for t in vjp(jnp.asarray(g))[0]])
    out = port_hg.hashgrid_encode_bwd_plain(levels, "simplex", torch.from_numpy(xs),
                                            torch.from_numpy(g), n_entries, 1).numpy()
    np.testing.assert_array_equal(out, ref)


SHAPES = {"density": (32, 64, 16), "rgb": (32, 64, 64, 3)}


@pytest.mark.parametrize("shape", list(SHAPES))
def test_mlp_backward_equals_jax_vjp(shape):
    dims = SHAPES[shape]
    rng = np.random.default_rng(5)
    mlp = jax_mlp.MLP(dims[0], dims[-1], n_neurons=dims[1], n_hidden_layers=len(dims) - 2)
    ws = [np.asarray(w) for w in mlp.init(jax.random.PRNGKey(2))]
    x = rng.standard_normal((777, dims[0])).astype(np.float32)
    g = (rng.standard_normal((777, dims[-1])) * 1e-2).astype(np.float32)
    x[3] = 0.0  # a row whose hidden pre-activations are exactly 0 (ReLU tie)
    _, vjp = jax.vjp(lambda p, xx: mlp(p, xx), [jnp.asarray(w) for w in ws], jnp.asarray(x))
    ref_dws, ref_dx = vjp(jnp.asarray(g))
    dx, dws = fused_mlp_bwd_plain([torch.tensor(w) for w in ws], torch.from_numpy(x),
                                  torch.from_numpy(g))
    # Both sides round every dh, dW and dX to bf16 after f32 sums taken in
    # another order, which can move a value by one bf16 step (2^-8 relative).
    for out, ref in [(dx, ref_dx), *zip(dws, ref_dws)]:
        out, ref = out.numpy(), np.asarray(ref, np.float32)
        np.testing.assert_array_equal(out, out.astype(jnp.bfloat16).astype(np.float32))
        np.testing.assert_allclose(out, ref, rtol=1e-2, atol=1e-2 * float(np.abs(ref).max()))
        assert np.mean(out == ref) > 0.95
    np.testing.assert_array_equal(dx.numpy()[3], np.asarray(ref_dx)[3])


@pytest.mark.parametrize("n_features", [1, 2])
def test_scatter_add_equals_jax_at_add(n_features):
    """Both layouts of the scatter probes: rows into (S, 2) and flat (S, 1);
    rows past the end are dropped. f32 sums in another order: rtol 1e-6."""
    rng = np.random.default_rng(6)
    size = 1 << 12
    idx = rng.integers(0, size + 3, 1 << 14)
    vals = rng.standard_normal((1 << 14, n_features)).astype(np.float32)
    ref = np.asarray(jnp.zeros((size, n_features), jnp.float32).at[jnp.asarray(idx)].add(
        jnp.asarray(vals), mode="drop"))
    out = scatter_add_rows_plain(torch.from_numpy(idx), torch.from_numpy(vals), size).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-5)
