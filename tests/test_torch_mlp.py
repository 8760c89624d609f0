"""The port's fused MLP (plain version of kernel B) against the JAX
package's Pallas ``fused_mlp`` in interpret mode and against
``MLP.__call__``, on the CPU."""

import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from instant_ngp_tpu.ops import mlp as jax_mlp
from instant_ngp_tpu.ops.pallas import mlp_kernel as jax_mk
from instant_ngp_torch.ops import mlp as port_mlp
from instant_ngp_torch.ops.mlp_kernel import fused_mlp, fused_mlp_plain

torch.set_num_threads(2)

SHAPES = {"density": (32, 64, 16), "rgb": (32, 64, 64, 3)}
# Both sides round inputs, weights and hidden activations to bf16 and
# accumulate in f32, so only the f32 summation order differs; that can
# flip one bf16 rounding of a hidden unit. Measured max abs error on these
# inputs: 4.8e-7 against Pallas interpret mode, 2.4e-7 to 4.8e-7 against
# MLP.__call__.
RTOL, ATOL = 1e-2, 1e-3


def _weights(rng, dims):
    return [(rng.standard_normal((a, b)) * np.sqrt(2.0 / a)).astype(np.float32)
            for a, b in zip(dims[:-1], dims[1:])]


def _interpret_pallas_call(orig):
    def call(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)
    return call


@pytest.mark.parametrize("n", [512, 1024])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_fused_mlp_equals_pallas_interpret(shape, n):
    rng = np.random.default_rng(11)
    ws = _weights(rng, SHAPES[shape])
    x = rng.standard_normal((n, SHAPES[shape][0])).astype(np.float32)
    with mock.patch.object(pl, "pallas_call", _interpret_pallas_call(pl.pallas_call)):
        ref = np.asarray(jax_mk.fused_mlp([jnp.asarray(w, jnp.bfloat16) for w in ws],
                                          jnp.asarray(x, jnp.bfloat16), "relu", "none"))
    out = fused_mlp([torch.from_numpy(w) for w in ws], torch.from_numpy(x), "relu", "none").numpy()
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
    assert np.abs(out - ref).max() < 1e-3


@pytest.mark.parametrize("shape", list(SHAPES))
def test_mlp_module_equals_jax_mlp_call_at_ragged_n(shape):
    dims = SHAPES[shape]
    rng = np.random.default_rng(12)
    ws = _weights(rng, dims)
    x = rng.standard_normal((300, dims[0])).astype(np.float32)
    theirs = jax_mlp.MLP(n_input_dims=dims[0], n_output_dims=dims[-1], n_neurons=dims[1],
                         n_hidden_layers=len(dims) - 2)
    ref = np.asarray(jax.jit(lambda p, v: theirs(p, v))([jnp.asarray(w) for w in ws], x))
    ours = port_mlp.MLP(dims[0], dims[-1], n_neurons=dims[1], n_hidden_layers=len(dims) - 2)
    assert ours.layer_sizes == theirs.layer_sizes
    with torch.no_grad():
        for dst, w in zip(ours.weights, ws):
            dst.copy_(torch.from_numpy(w))
    out = ours(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(out, fused_mlp_plain(list(ours.weights), torch.from_numpy(x)).numpy())


def test_hidden_activations_round_to_bf16():
    # (1 + 2^-7)^2 = 1 + 2^-6 + 2^-14 rounds to 1 + 2^-6 in bf16 before
    # the output layer; both factors are exact in bf16
    a = torch.tensor([[1.0 + 2.0**-7]])
    h = fused_mlp_plain([a, torch.tensor([[1.0]])], a)
    assert float(h) == 1.0 + 2.0**-6
