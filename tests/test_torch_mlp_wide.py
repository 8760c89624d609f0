"""Kernel #1's full contract in the port, on the CPU: the plain versions of
kernels B and F at the wide and deep shapes of the shipped configs and with
the sigmoid and exponential activations, against the JAX package's Pallas
``fused_mlp`` in interpret mode and ``jax.vjp`` of ``MLP.__call__``; and the
wrappers' routes on tensors off the CPU (a mocked launch): every width up to
256, any depth and every activation reaches a kernel, a wider layer raises."""

import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from instant_ngp_tpu.ops import mlp as jax_mlp
from instant_ngp_tpu.ops.pallas import mlp_kernel as jax_mk
from instant_ngp_torch import cuda_lib
from instant_ngp_torch.ops import mlp_kernel as mk

torch.set_num_threads(2)

# image/oneblob.json's MLP and nerf/frequency.json's density MLP
SHAPES = {"oneblob": (256,) + (128,) * 8 + (3,), "frequency": (72,) + (128,) * 4 + (16,)}
# bf16 inputs, weights and hidden activations on both sides, f32 sums in
# another order: a hidden unit's bf16 rounding can flip (test_torch_mlp.py's
# tolerance); per output against the largest |output|.
TOL_FWD = 1e-2
# the backward, per dX and dW against the largest |value|, as
# test_torch_bwd_design.py holds the plain backward against jax.vjp
TOL_BWD = 1e-2


def _weights(rng, dims, scale=1.0):
    return [(rng.standard_normal((a, b)) * np.sqrt(2.0 / a) * scale).astype(np.float32)
            for a, b in zip(dims[:-1], dims[1:])]


def _interpret_pallas_call(orig):
    def call(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)
    return call


@pytest.mark.parametrize("n", [512, 1024])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_plain_forward_equals_pallas_interpret(shape, n):
    rng = np.random.default_rng(21)
    ws = _weights(rng, SHAPES[shape])
    x = rng.random((n, SHAPES[shape][0]), dtype=np.float32)
    with mock.patch.object(pl, "pallas_call", _interpret_pallas_call(pl.pallas_call)):
        ref = np.asarray(jax_mk.fused_mlp([jnp.asarray(w, jnp.bfloat16) for w in ws],
                                          jnp.asarray(x, jnp.bfloat16), "relu", "none"))
    out = mk.fused_mlp([torch.from_numpy(w) for w in ws], torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=TOL_FWD * np.abs(ref).max())


def _mask_differs(ws, x) -> np.ndarray:
    """(N,) bool: rows where a hidden ReLU mask (z > 0, z == 0) of the port's
    plain forward differs from that of MLP.__call__'s (eager JAX, as jax.vjp
    runs it)."""
    zs = mk._forward_record([mk._bf16(torch.from_numpy(w)) for w in ws], torch.from_numpy(x),
                            "relu")[1]
    h = jnp.asarray(x).astype(jnp.bfloat16)
    differs = np.zeros(x.shape[0], bool)
    for w, zp in zip(ws[:-1], zs):
        z = jnp.dot(h, jnp.asarray(w).astype(jnp.bfloat16), preferred_element_type=jnp.float32)
        zj, zp = np.asarray(z), zp.numpy()
        differs |= ((zp > 0) != (zj > 0)).any(1) | ((zp == 0) != (zj == 0)).any(1)
        h = jnp.maximum(z, 0.0).astype(jnp.bfloat16)
    return differs


CASES = [("oneblob", "relu", "none"), ("frequency", "relu", "none"),
         ("frequency", "sigmoid", "none"), ("frequency", "exponential", "none"),
         ("frequency", "relu", "sigmoid"), ("frequency", "relu", "exponential"),
         ("frequency", "sigmoid", "exponential")]


@pytest.mark.parametrize("shape,act,out_act", CASES)
def test_plain_backward_equals_jax_vjp(shape, act, out_act):
    """dX and every dW of the plain backward against jax.vjp of MLP.__call__
    on f32 cotangents; the forward against MLP.__call__ too. The weights are
    scaled down under the exponential so that e^z stays near 1. Under ReLU,
    rows whose ReLU mask differs between the two forwards are left out: they
    sum in another order, so a hidden unit at a tie can take the other
    branch, and that row's dX then differs by a whole branch (81 of the
    oneblob MLP's 262,144 dX values otherwise). Few rows are left out."""
    dims = SHAPES[shape]
    rng = np.random.default_rng(22)
    ws = _weights(rng, dims, 0.3 if "exponential" in (act, out_act) else 1.0)
    x = rng.random((1024, dims[0]), dtype=np.float32)
    g = (rng.standard_normal((1024, dims[-1])) * 1e-2).astype(np.float32)
    if act == "relu":
        keep = ~_mask_differs(ws, x)
        assert keep.mean() > 0.9
        x, g = x[keep], g[keep]
    mlp = jax_mlp.MLP(dims[0], dims[-1], n_neurons=dims[1], n_hidden_layers=len(dims) - 2,
                      activation=act, output_activation=out_act)
    out_ref, vjp = jax.vjp(lambda p, xx: mlp(p, xx), [jnp.asarray(w) for w in ws],
                           jnp.asarray(x))
    ref_dws, ref_dx = vjp(jnp.asarray(g))
    wt = [torch.from_numpy(w) for w in ws]
    out = mk.fused_mlp_plain(wt, torch.from_numpy(x), act, out_act).numpy()
    out_ref = np.asarray(out_ref, np.float32)
    np.testing.assert_allclose(out, out_ref, rtol=0, atol=TOL_FWD * np.abs(out_ref).max())
    dx, dws = mk.fused_mlp_bwd_plain(wt, torch.from_numpy(x), torch.from_numpy(g), act, out_act)
    for o, r in [(dx, ref_dx), *zip(dws, ref_dws)]:
        o, r = o.numpy(), np.asarray(r, np.float32)
        np.testing.assert_array_equal(o, o.astype(jnp.bfloat16).astype(np.float32))
        np.testing.assert_allclose(o, r, rtol=0, atol=TOL_BWD * np.abs(r).max())


@pytest.mark.parametrize("act,out_act", [("sigmoid", "none"), ("exponential", "sigmoid")])
def test_act_grad_is_jax_derivative(act, out_act):
    """``_act_grad`` of sigmoid and exponential, against jax.grad of the JAX
    package's activation at f32 pre-activations: within 4e-7 relative, or
    1.2e-7 absolute (two ulps of s near 1: torch's sigmoid and XLA's
    logistic can differ by an ulp, which 1 − s keeps as an absolute error)."""
    z = np.linspace(-6, 6, 4001, dtype=np.float32)
    for name in (act, out_act):
        f = jax_mlp.activation_fn(name)
        ref = np.asarray(jax.vmap(jax.grad(lambda v: f(v)))(jnp.asarray(z)))
        out = mk._act_grad(name, torch.from_numpy(z)).numpy()
        np.testing.assert_allclose(out, ref, rtol=4e-7, atol=1.2e-7)


ROUTES = [
    (SHAPES["oneblob"], "relu", "none", "fused_mlp_wide", "fused_mlp_bwd_wide"),
    (SHAPES["frequency"], "relu", "none", "fused_mlp_wide", "fused_mlp_bwd_wide"),
    ((32, 128, 128, 16), "relu", "none", "fused_mlp_wide", "fused_mlp_bwd_wide"),
    ((3,) + (256,) * 3 + (1,), "relu", "none", "fused_mlp_wide", "fused_mlp_bwd_wide"),
    ((16,) * 11 + (1,), "relu", "none", "fused_mlp_wide", "fused_mlp_bwd_wide"),  # 11 matrices
    ((32, 64, 16), "sigmoid", "none", "fused_mlp_wide", "fused_mlp_bwd_wide"),
    ((32, 64, 16), "exponential", "sigmoid", "fused_mlp_wide", "fused_mlp_bwd_wide"),
    ((32, 64, 64, 3), "relu", "exponential", "fused_mlp_wide", "fused_mlp_bwd_wide"),
    ((32, 64, 64, 3), "relu", "relu", "fused_mlp", "fused_mlp_bwd_wide"),
    ((32, 64, 64, 3), "relu", "none", "fused_mlp", "fused_mlp_bwd"),
]


@pytest.fixture
def mocked_card(monkeypatch):
    """Tensors on the meta device stand for the card's: the contiguity check
    passes, and every launch is recorded instead of made."""
    calls = []
    monkeypatch.setattr(cuda_lib, "check_cuda", lambda *t, dtype=None: None)
    monkeypatch.setattr(cuda_lib, "launch", lambda name, *args: calls.append((name, args)))
    monkeypatch.setattr(cuda_lib, "query", lambda name, *args: 4096)
    yield calls
    mk._wide_scratch_bytes.cache_clear()


@pytest.mark.parametrize("dims,act,out_act,fwd,bwd", ROUTES)
def test_card_tensors_reach_a_kernel(mocked_card, dims, act, out_act, fwd, bwd):
    """B, F and F's recompute each launch their route's kernel once, with
    the activations' codes; no plain version runs off the CPU."""
    meta = torch.device("meta")
    ws = [torch.zeros(a, b, device=meta) for a, b in zip(dims[:-1], dims[1:])]
    x = torch.zeros((300, dims[0]), device=meta)
    g = torch.zeros((300, dims[-1]), device=meta)
    with mock.patch.object(mk, "fused_mlp_plain", side_effect=AssertionError), \
            mock.patch.object(mk, "fused_mlp_bwd_plain", side_effect=AssertionError):
        out = mk.fused_mlp(ws, x, act, out_act)
        dx, dws = mk.fused_mlp_bwd(ws, x, g, act, out_act)
        zs = mk.mlp_recompute(ws, x, act, out_act)
    assert tuple(out.shape) == (300, dims[-1]) and tuple(dx.shape) == (300, dims[0])
    assert [tuple(d.shape) for d in dws] == [(a, b) for a, b in zip(dims[:-1], dims[1:])]
    assert [tuple(z.shape) for z in zs] == [(300, d) for d in dims[1:]]
    assert [name for name, _ in mocked_card] == [fwd, bwd, bwd]
    codes = (mk.ACTIVATIONS[act], mk.ACTIVATIONS[out_act])
    n_layers = len(dims) - 1
    fwd_args = mocked_card[0][1]
    assert fwd_args[3:6] == (n_layers, *codes)
    if bwd == "fused_mlp_bwd_wide":
        assert mocked_card[1][1][4:7] == (n_layers, *codes)


@pytest.mark.parametrize("dims", [(32, 272, 16), (272, 64, 3), (64, 64, 272)])
def test_a_layer_past_256_raises(mocked_card, dims):
    meta = torch.device("meta")
    ws = [torch.zeros(a, b, device=meta) for a, b in zip(dims[:-1], dims[1:])]
    x = torch.zeros((8, dims[0]), device=meta)
    g = torch.zeros((8, dims[-1]), device=meta)
    for call in (lambda: mk.fused_mlp(ws, x), lambda: mk.fused_mlp_bwd(ws, x, g),
                 lambda: mk.mlp_recompute(ws, x)):
        with pytest.raises(ValueError, match="256"):
            call()
    assert mocked_card == []


@pytest.mark.parametrize("precision", ["high", "medium"])
def test_wide_backward_needs_full_f32_matmuls(mocked_card, precision):
    """The wide F forms dW with f32 matrix products: under a process-wide
    TF32 (or bf16) matmul setting it raises, and changes no setting itself;
    the narrow route, which forms dW in its kernel, runs."""
    meta = torch.device("meta")
    wide, narrow = SHAPES["frequency"], (32, 64, 64, 3)
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(precision)
    try:
        for dims in (wide, narrow):
            ws = [torch.zeros(a, b, device=meta) for a, b in zip(dims[:-1], dims[1:])]
            x = torch.zeros((64, dims[0]), device=meta)
            g = torch.zeros((64, dims[-1]), device=meta)
            if dims == wide:
                with pytest.raises(RuntimeError, match="highest"):
                    mk.fused_mlp_bwd(ws, x, g)
            else:
                mk.fused_mlp_bwd(ws, x, g)
            assert torch.get_float32_matmul_precision() == precision
    finally:
        torch.set_float32_matmul_precision(before)
    assert [name for name, _ in mocked_card] == ["fused_mlp_bwd"]


@pytest.mark.parametrize("shape", list(SHAPES))
def test_configs_phase_gate_is_relative(shape):
    """``chip_smoke.py``'s configs phase holds F's leaves at a training
    step's cotangent (~1/N, N = 2^18 here) relative to each leaf's own max |ref|: the plain
    backward against itself and against a copy off by one bf16 step in a few
    entries passes; every planted fault (dX zeroed or negated, each dW off by
    4 %) is refused, though an absolute floor of 1 (max(1, max |ref|)) would
    pass them all at this scale."""
    from chip_smoke import TOL_MLP_BWD, mlp_bwd_agrees, mlp_bwd_leaves, planted_faults

    dims = SHAPES[shape]
    rng = np.random.default_rng(23)
    n = 512
    ws = [torch.from_numpy(w) for w in _weights(rng, dims)]
    x = torch.from_numpy(rng.random((n, dims[0]), dtype=np.float32))
    # the size of a mean loss's cotangent at the image step's 2^18 rows
    g = torch.from_numpy((rng.standard_normal((n, dims[-1])) / 2 ** 18).astype(np.float32))
    dx, dws = mk.fused_mlp_bwd_plain(ws, x, g)
    refs = [dx, *dws]
    assert max(float(r.abs().max()) for r in refs) < 1e-2
    assert mlp_bwd_agrees(mlp_bwd_leaves(refs, refs))
    # a few entries of each leaf one bf16 step off (2^-8 of themselves)
    near = [r.clone() for r in refs]
    for t in near:
        t.view(-1)[::97] *= 1 + 2.0 ** -8
    assert mlp_bwd_agrees(mlp_bwd_leaves(near, refs))
    faults = list(planted_faults(dx, dws))
    assert len(faults) == 2 + len(dws)
    for what, outs in faults:
        leaves = mlp_bwd_leaves(outs, refs)
        assert not mlp_bwd_agrees(leaves), what
        assert all(v["err"] <= TOL_MLP_BWD * max(1.0, v["scale"]) for v in leaves), what
