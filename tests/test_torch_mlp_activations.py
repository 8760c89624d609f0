"""The MLP's other five activations (leakyrelu, sine, squareplus, softplus,
tanh) in the port against the JAX package, on the CPU: the plain versions of
kernels B and F as the hidden and as the output activation against
``MLP.__call__`` and ``jax.vjp`` (the JAX MLP's XLA path, which takes them);
pairs of two different ones (hidden, output); each derivative against
``jax.grad`` of the JAX activation, at 0 and far out; the wrappers' route off
the CPU: each goes to the wide kernels (a mocked launch) with its own code,
never to the narrow ones nor the plain versions; and the sources: each
activation compiled into the generic kernels, no call a value."""

import re
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instant_ngp_tpu.ops import mlp as jax_mlp
from instant_ngp_torch import cuda_lib
from instant_ngp_torch.ops import mlp_kernel as mk

torch.set_num_threads(2)

NEW = ["leakyrelu", "sine", "squareplus", "softplus", "tanh"]
# fox's rgb MLP and a deeper 128-wide one (nerf/frequency.json's density MLP)
SHAPES = {"fox_rgb": (32, 64, 64, 3), "frequency": (72,) + (128,) * 4 + (16,)}
# as tests/test_torch_mlp_wide.py: bf16 inputs, weights and hidden activations
# on both sides, f32 sums in another order; per leaf against its largest |ref|
TOL_FWD, TOL_BWD = 1e-2, 1e-2


def _weights(rng, dims):
    return [(rng.standard_normal((a, b)) * np.sqrt(2.0 / a)).astype(np.float32)
            for a, b in zip(dims[:-1], dims[1:])]


def _mask_differs(ws, x) -> np.ndarray:
    """(N,) bool: rows where a hidden leakyrelu mask (z > 0) of the port's
    plain forward differs from that of ``MLP.__call__``'s."""
    zs = mk._forward_record([mk._bf16(torch.from_numpy(w)) for w in ws], torch.from_numpy(x),
                            "leakyrelu")[1]
    h = jnp.asarray(x).astype(jnp.bfloat16)
    differs = np.zeros(x.shape[0], bool)
    for w, zp in zip(ws[:-1], zs):
        z = jnp.dot(h, jnp.asarray(w).astype(jnp.bfloat16), preferred_element_type=jnp.float32)
        differs |= ((zp.numpy() > 0) != (np.asarray(z) > 0)).any(1)
        h = jnp.where(z > 0, z, 0.01 * z).astype(jnp.bfloat16)
    return differs


# pairs of two different generic activations, (hidden, output)
MIXED = [("sine", "tanh"), ("tanh", "softplus"), ("leakyrelu", "squareplus")]
CASES = [(shape, act, "none") for act in NEW for shape in SHAPES] + \
        [("fox_rgb", "relu", act) for act in NEW] + [("fox_rgb", h, o) for h, o in MIXED]


@pytest.mark.parametrize("shape,act,out_act", CASES)
def test_plain_forward_and_backward_equal_jax(shape, act, out_act):
    """The forward, dX and every dW against ``MLP.__call__`` and its vjp on
    f32 cotangents; each dX and dW a bf16 value. Under a leakyrelu hidden
    layer, rows whose mask (z > 0) differs between the two forwards are left
    out, as ``test_torch_mlp_wide.py`` leaves out ReLU's: the f32 sums run in
    another order, so a unit at the kink can take the other branch, and the
    row's dX then differs by 0.99 of a term (32 of 73,728 dX values at the
    128-wide shape otherwise)."""
    dims = SHAPES[shape]
    rng = np.random.default_rng(31)
    ws = _weights(rng, dims)
    x = (rng.standard_normal((1024, dims[0])) * 2.0).astype(np.float32)
    g = (rng.standard_normal((1024, dims[-1])) * 1e-2).astype(np.float32)
    if act == "leakyrelu":
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


# the pre-activations the derivative is held at: a sweep, 0, and far out on
# both sides (softplus past ±30, squareplus and tanh saturating)
Z = np.concatenate([np.linspace(-8, 8, 2001), [0.0, -0.0, 1e-30, -1e-30, 30.0, -30.0, 45.0,
                                                -45.0, 88.0, -88.0, 1e4, -1e4]]).astype(np.float32)


@pytest.mark.parametrize("act", NEW)
def test_act_and_its_derivative_are_jax(act):
    """``_act`` against the JAX activation and ``_act_grad`` against
    ``jax.grad`` of it, at f32 pre-activations, within 4e-7 relative or
    2.4e-7 absolute (two ulps of 1: torch's and XLA's sin, cos, exp and
    log1p can differ by an ulp), tanh's within 6e-7 absolute (near ±1
    torch's and XLA's tanh differ by up to 4 ulps of 1, which (1 + t)(1 − t)
    keeps as an absolute error); leakyrelu's derivative at 0 is 0.01, as
    ``jnp.where`` takes the false branch."""
    f = jax_mlp.activation_fn(act)
    z = jnp.asarray(Z)
    ref = np.asarray(jax.jit(jax.vmap(jax.grad(f)))(z))
    out = mk._act_grad(act, torch.from_numpy(Z)).numpy()
    atol = 6e-7 if act == "tanh" else 2.4e-7
    np.testing.assert_allclose(out, ref, rtol=4e-7, atol=atol)
    np.testing.assert_allclose(mk._act(act, torch.from_numpy(Z)).numpy(), np.asarray(f(z)),
                               rtol=4e-7, atol=2.4e-7)
    at0 = float(mk._act_grad(act, torch.zeros(1))[0])
    assert at0 == {"leakyrelu": np.float32(0.01), "sine": 1.0, "squareplus": 0.5, "softplus": 0.5,
                   "tanh": 1.0}[act]


def test_derivatives_far_out():
    """Softplus's derivative is 1 past +30 and e^z past −30 (not 0); squareplus's
    tends to 1 and 0, tanh's to 0; none is NaN."""
    big = torch.tensor([30.0, 45.0, 1e4], dtype=torch.float32)
    np.testing.assert_allclose(mk._act_grad("softplus", big).numpy(), 1.0, rtol=1e-6)
    neg = torch.tensor([-30.0, -45.0], dtype=torch.float32)
    np.testing.assert_allclose(mk._act_grad("softplus", neg).numpy(), np.exp(neg.numpy()),
                               rtol=1e-5)
    far = torch.tensor([-1e4, 1e4], dtype=torch.float32)
    np.testing.assert_allclose(mk._act_grad("squareplus", far).numpy(), [0.0, 1.0], atol=1e-6)
    np.testing.assert_array_equal(mk._act_grad("tanh", far).numpy(), [0.0, 0.0])
    for act in NEW:
        assert bool(torch.isfinite(mk._act_grad(act, torch.from_numpy(Z))).all()), act


@pytest.fixture
def mocked_card(monkeypatch):
    """Tensors on the meta device stand for the card's (as
    test_torch_mlp_wide.py's fixture): every launch is recorded."""
    calls = []
    monkeypatch.setattr(cuda_lib, "check_cuda", lambda *t, dtype=None: None)
    monkeypatch.setattr(cuda_lib, "launch", lambda name, *args: calls.append((name, args)))
    monkeypatch.setattr(cuda_lib, "query", lambda name, *args: 0)
    yield calls
    mk._wide_sizes.cache_clear()


@pytest.mark.parametrize("act", NEW)
@pytest.mark.parametrize("hidden", [True, False])
def test_new_activations_take_the_wide_route(mocked_card, act, hidden):
    """On fox's rgb widths (narrow otherwise), an MLP with the activation as
    its hidden or output activation launches the wide B, the wide F and its
    dW kernel with the activation's code; ``is_narrow`` refuses it."""
    dims = SHAPES["fox_rgb"]
    act_h, act_o = (act, "none") if hidden else ("relu", act)
    codes = (mk.ACTIVATIONS[act_h], mk.ACTIVATIONS[act_o])
    assert mk.ACTIVATIONS[act] >= 4
    assert not mk.is_narrow(dims, *codes, backward=False)
    assert not mk.is_narrow(dims, *codes, backward=True)
    meta = torch.device("meta")
    ws = [torch.zeros(a, b, device=meta) for a, b in zip(dims[:-1], dims[1:])]
    x = torch.zeros((300, dims[0]), device=meta)
    g = torch.zeros((300, dims[-1]), device=meta)
    with mock.patch.object(mk, "fused_mlp_plain", side_effect=AssertionError), \
            mock.patch.object(mk, "fused_mlp_bwd_plain", side_effect=AssertionError):
        mk.fused_mlp(ws, x, act_h, act_o)
        mk.fused_mlp_bwd(ws, x, g, act_h, act_o)
    assert [name for name, _ in mocked_card] == ["fused_mlp_wide", "fused_mlp_bwd_wide",
                                                 "fused_mlp_dw_wide"]
    assert mocked_card[0][1][3:6] == (len(dims) - 1, *codes)
    assert mocked_card[1][1][4:7] == (len(dims) - 1, *codes)
    # every dz under the new hidden activation is an f32 value: three bf16 terms
    layout = mk.wide_layout(dims, act_h)
    assert [v["terms"] for v in layout] == ([3, 3, 3] if hidden else [1, 1, 3])


@pytest.mark.parametrize("act_h,act_o", MIXED)
def test_mixed_pairs_take_the_wide_route(mocked_card, act_h, act_o):
    """A pair of two different generic activations on fox's rgb widths
    launches the wide B, F and dW with both codes, never a plain version."""
    dims = SHAPES["fox_rgb"]
    codes = (mk.ACTIVATIONS[act_h], mk.ACTIVATIONS[act_o])
    meta = torch.device("meta")
    ws = [torch.zeros(a, b, device=meta) for a, b in zip(dims[:-1], dims[1:])]
    x = torch.zeros((300, dims[0]), device=meta)
    g = torch.zeros((300, dims[-1]), device=meta)
    with mock.patch.object(mk, "fused_mlp_plain", side_effect=AssertionError), \
            mock.patch.object(mk, "fused_mlp_bwd_plain", side_effect=AssertionError):
        mk.fused_mlp(ws, x, act_h, act_o)
        mk.fused_mlp_bwd(ws, x, g, act_h, act_o)
    assert [name for name, _ in mocked_card] == ["fused_mlp_wide", "fused_mlp_bwd_wide",
                                                 "fused_mlp_dw_wide"]
    assert mocked_card[0][1][3:6] == (len(dims) - 1, *codes)
    assert mocked_card[1][1][4:7] == (len(dims) - 1, *codes)
    assert mocked_card[2][1][3:5] == (len(dims) - 1, codes[0])


CSRC = cuda_lib.CSRC


def test_generic_kernels_compile_each_activation_in():
    """csrc/mlp_wide.cuh's activation codes are ``ACTIVATIONS``', its
    ``NGP_GENERIC_SWITCH`` takes each of the five by its constant, each
    wide source has a generic twin compiled with ``NGP_GENERIC_ACT``, and no
    wide source holds a non-inlined function (the call a value the generic
    kernels had)."""
    header = (CSRC / "mlp_wide.cuh").read_text()
    decl = re.search(r"constexpr int (kRelu = .*?);", header, re.S).group(1)
    consts = dict(re.findall(r"(k\w+) = (\d+)", decl))
    names = {"kRelu": "relu", "kSigmoid": "sigmoid", "kExp": "exponential",
             "kLeakyRelu": "leakyrelu", "kSine": "sine", "kSquareplus": "squareplus",
             "kSoftplus": "softplus", "kTanh": "tanh"}
    assert {names[k]: int(v) for k, v in consts.items()} == \
        {k: v for k, v in mk.ACTIVATIONS.items() if k not in ("none", "logistic")}
    switch = header.split("#define NGP_GENERIC_SWITCH", 1)[1].split("\n\n", 1)[0]
    assert re.findall(r"CALL\((k\w+)\)", switch) == ["kLeakyRelu", "kSine", "kSquareplus",
                                                      "kSoftplus", "kTanh"]
    for src in ("mlp_wide.cu", "mlp_wide_bwd.cu", "mlp_wide_bwd256.cu"):
        twin = (CSRC / src.replace(".cu", "_generic.cu")).read_text()
        assert f'#define NGP_GENERIC_ACT 1\n#include "{src}"' in twin
    for path in CSRC.glob("mlp_wide*"):
        assert "__noinline__" not in path.read_text(), path.name


def _wgn(v):
    return max(16, 1 << (v - 1).bit_length())


@pytest.mark.parametrize("dout", [1, 3, 8, 9, 16, 17, 64, 100, 128, 200, 256])
def test_rolled_output_loops_cover_the_unrolled_ones(dout):
    """A mirror of csrc/mlp_wide.cuh's output loops for one thread (tig 0-3;
    row 0 is r0, 1 is r1): ``out_rolled``'s values are exactly those
    ``write_out`` stores, each once; ``last_dz_rolled``'s value v is the
    accumulator value v of ``last_dz`` (row and column alike)."""
    n = _wgn(dout)
    for tig in range(4):
        unrolled = [(h, 8 * j + 2 * tig + e) for j in range(n // 8) if j * 8 < dout
                    for h in range(2) for e in range(2) if 8 * j + 2 * tig + e < dout]
        rolled = [((v & 3) >= 2, 8 * (v >> 2) + 2 * tig + (v & 1)) for v in range(4 * ((dout + 7) // 8))]
        rolled = [(int(h), c) for h, c in rolled if c < dout]
        assert sorted(rolled) == sorted(unrolled) and len(set(rolled)) == len(rolled)
        last = [(int(e >= 2), 8 * j + 2 * tig + (e & 1)) for j in range(n // 8) for e in range(4)]
        assert [(int((v & 3) >= 2), 8 * (v >> 2) + 2 * tig + (v & 1)) for v in range(n // 2)] == last


def test_an_unknown_activation_raises():
    with pytest.raises(ValueError, match="unknown activation"):
        mk._act("gelu", torch.zeros(1))
    with pytest.raises(ValueError, match="kernels B and F take"):
        mk._activation_code("gelu")
