"""The premises of the wide route's Hopper design (csrc/mlp_wide.cu,
mlp_wide_bwd.cu, mlp_wide_dw.cu), on the CPU: the dW kernel's plain
version ``mlp_dw_plain`` against the plain backward's dW and JAX's vjp; the
values kernel F stores in bf16 are bf16 values; Python mirrors of the packed
weight layout and of the h/dz tile layout hold every value once; and every
launcher's argument types match its C function."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instant_ngp_tpu.ops import mlp as jax_mlp
from instant_ngp_torch import cuda_lib
from instant_ngp_torch.ops import mlp_kernel as mk

torch.set_num_threads(2)

CSRC = Path(mk.__file__).resolve().parents[1] / "csrc"
# image/oneblob.json's MLP, nerf/frequency.json's density MLP, a 256-wide one
SHAPES = {"oneblob": (256,) + (128,) * 8 + (3,), "frequency": (72,) + (128,) * 4 + (16,),
          "wide256": (3, 256, 256, 256, 1), "small": (32, 64, 16)}
# dW leaves against the largest |value|: f32 sums in another order, then
# bf16 (as test_torch_mlp_wide.py's TOL_BWD)
TOL_BWD = 1e-2


def _weights(rng, dims, scale=1.0):
    return [(rng.standard_normal((a, b)) * np.sqrt(2.0 / a) * scale).astype(np.float32)
            for a, b in zip(dims[:-1], dims[1:])]


def _plain_intermediates(ws, x, g, act, out_act):
    """Each layer's input h_i and output cotangent dz_i of the plain
    backward (``fused_mlp_bwd_plain``'s recurrences), and each act'(z_i)."""
    wb = [mk._bf16(w) for w in ws]
    hs, zs = mk._forward_record(wb, x, act)
    dz = g.float() * mk._act_grad(out_act, zs[-1])
    dzs, grads = [None] * len(wb), [None] * len(wb)
    for i in reversed(range(len(wb))):
        dzs[i] = dz
        if i > 0:
            grads[i - 1] = mk._act_grad(act, zs[i - 1])
            dz = mk._bf16(dz @ wb[i].T) * grads[i - 1]
    return hs, dzs, grads


def _mask_differs(ws, x) -> np.ndarray:
    """(N,) bool: rows whose hidden ReLU masks differ between the port's
    plain forward and MLP.__call__'s (test_torch_mlp_wide.py's filter)."""
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


DW_CASES = [("oneblob", "relu", "none", 4096), ("oneblob", "relu", "none", 256),
            ("frequency", "relu", "none", 256), ("wide256", "relu", "none", 128),
            ("small", "sigmoid", "none", 256), ("small", "exponential", "sigmoid", 256),
            ("small", "relu", "exponential", 64)]


@pytest.mark.parametrize("shape,act,out_act,split_rows", DW_CASES)
def test_dw_plain_equals_bwd_plain_and_jax(shape, act, out_act, split_rows):
    """``mlp_dw_plain`` on the plain backward's h_i and dz_i, at one split
    (4,096 rows) and at several, against ``fused_mlp_bwd_plain``'s dW and
    against jax.vjp of MLP.__call__, every leaf within TOL_BWD of its max
    |ref|; its values are bf16. Under ReLU the rows whose masks differ
    between the two forwards are left out, as test_torch_mlp_wide.py does."""
    dims = SHAPES[shape]
    rng = np.random.default_rng(31)
    ws = _weights(rng, dims, 0.3 if "exponential" in (act, out_act) else 1.0)
    x = rng.random((700, dims[0]), dtype=np.float32)
    g = (rng.standard_normal((700, dims[-1])) * 1e-2).astype(np.float32)
    if act == "relu":
        keep = ~_mask_differs(ws, x)
        assert keep.mean() > 0.9
        x, g = x[keep], g[keep]
    wt, xt, gt = [torch.from_numpy(w) for w in ws], torch.from_numpy(x), torch.from_numpy(g)
    hs, dzs, _ = _plain_intermediates(wt, xt, gt, act, out_act)
    dws = [mk.mlp_dw_plain(h, dz, split_rows) for h, dz in zip(hs, dzs)]
    _, ref_plain = mk.fused_mlp_bwd_plain(wt, xt, gt, act, out_act)
    mlp = jax_mlp.MLP(dims[0], dims[-1], n_neurons=dims[1], n_hidden_layers=len(dims) - 2,
                      activation=act, output_activation=out_act)
    _, vjp = jax.vjp(lambda p, xx: mlp(p, xx), [jnp.asarray(w) for w in ws], jnp.asarray(x))
    ref_jax, _ = vjp(jnp.asarray(g))
    for o, rp, rj in zip(dws, ref_plain, ref_jax):
        o = o.numpy()
        np.testing.assert_array_equal(o, o.astype(jnp.bfloat16).astype(np.float32))
        for r in (rp.numpy(), np.asarray(rj, np.float32)):
            np.testing.assert_allclose(o, r, rtol=0, atol=TOL_BWD * np.abs(r).max())


@pytest.mark.parametrize("shape", ["oneblob", "frequency", "wide256"])
@pytest.mark.parametrize("act", ["relu", "none"])
def test_stored_values_are_bf16(shape, act):
    """What kernel F writes in bf16 loses nothing: every h_i is a bf16
    value, and under a relu/none hidden layer every act'(z) is 0, ½ or 1 and
    every inner dz_i a bf16 value, so one bf16 term holds it; dz_{L-1} =
    g·act_out'(z_L) is an f32 value, which split_bf16's three terms hold
    exactly and two do not."""
    dims = SHAPES[shape]
    rng = np.random.default_rng(32)
    wt = [torch.from_numpy(w) for w in _weights(rng, dims)]
    xt = torch.from_numpy(rng.random((512, dims[0]), dtype=np.float32))
    gt = torch.from_numpy((rng.standard_normal((512, dims[-1])) / 2 ** 18).astype(np.float32))
    hs, dzs, grads = _plain_intermediates(wt, xt, gt, act, "none")
    for h in hs:
        assert torch.equal(h, mk._bf16(h))
    for gr in grads[:-1]:
        assert bool(torch.isin(gr, torch.tensor([0.0, 0.5, 1.0])).all())
    for dz in dzs[:-1]:
        assert torch.equal(dz, mk._bf16(dz))
    hi, mid, lo = mk.split_bf16(dzs[-1])
    assert torch.equal(hi + mid + lo, dzs[-1])
    assert not torch.equal(hi + mid, dzs[-1])
    for t in (hi, mid, lo):
        assert torch.equal(t, mk._bf16(t))


def _stage_bytes() -> int:
    src = (CSRC / "mlp_wide.cuh").read_text()
    return int(re.search(r"constexpr int kStageBytes = (\d+);", src).group(1))


def _wgn(v: int) -> int:
    return max(16, 1 << (v - 1).bit_length())


def _pad16(v: int) -> int:
    return -(-v // 16) * 16


def _chunk_rows(k: int, n: int) -> int:
    return min(k, _stage_bytes() // (2 * n) // 16 * 16)


def _packed_offset(k, n, kk, nn, r):
    """A mirror of mlp_wide.cuh's packed_offset: (k, n) of a (N x K) K-major
    operand in chunks of r rows of K, core matrices of 8 x 8 values."""
    c = k // r
    kl = k - c * r
    kr = np.minimum(r, kk - c * r)
    return c * r * nn + ((n >> 3) * (kr >> 3) + (kl >> 3)) * 64 + (n & 7) * 8 + (kl & 7)


LAYERS = sorted({(a, b) for dims in SHAPES.values() for a, b in zip(dims[:-1], dims[1:])}
                | {(256, 256), (200, 256), (256, 72), (48, 128), (128, 1), (64, 64)})


@pytest.mark.parametrize("din,dout", LAYERS)
def test_packed_layout_holds_every_weight_once(din, dout):
    """The forward (W^T: N = wgmma N of d_out, K = pad16(d_in)) and backward
    (W: N = wgmma N of d_in, K = pad16(d_out)) packings: every (k, n) of the
    padded operand has its own offset in [0, K·N), each chunk of a stage's
    rows is one contiguous run no larger than a stage, so packing a layer
    puts every weight in once and zero everywhere else."""
    rng = np.random.default_rng(din * 1000 + dout)
    w = rng.standard_normal((din, dout)).astype(np.float32) + 3.0  # no zero weights
    for kk, nn, kmax, nmax, val in ((_pad16(din), _wgn(dout), din, dout, lambda k, n: w[k, n]),
                                    (_pad16(dout), _wgn(din), dout, din, lambda k, n: w[n, k])):
        r = _chunk_rows(kk, nn)
        assert r % 16 == 0 and r * nn * 2 <= _stage_bytes()
        k, n = np.meshgrid(np.arange(kk), np.arange(nn), indexing="ij")
        off = _packed_offset(k, n, kk, nn, r)
        assert sorted(off.ravel().tolist()) == list(range(kk * nn))
        for c0 in range(0, kk, r):  # the chunk of rows [c0, c0 + r): one run
            o = off[c0:c0 + r]
            assert o.min() == c0 * nn and o.max() == c0 * nn + o.size - 1
        packed = np.zeros(kk * nn, np.float32)
        inside = (k < kmax) & (n < nmax)
        packed[off[inside]] = val(k[inside], n[inside])
        assert np.count_nonzero(packed) == din * dout
        np.testing.assert_array_equal(np.sort(packed[packed != 0]), np.sort(w.ravel()))


def test_untile_mirrors_the_tile_layout():
    """``untile`` reads back what kernel F's tile stores write: per 64-row
    tile, (r, c) at ((c // 8)·8 + r // 8)·64 + (r % 8)·8 + c % 8 from the
    layer's column (``wide_layout``), every value of every layer once, at a
    ragged row count."""
    dims, n = (72, 128, 16), 150
    lay = mk.wide_layout(dims, "relu")
    hw, zw = lay[0]["hw"], lay[0]["zw"]
    assert [v["hcol"] for v in lay] == [0, 128] and hw == 256
    assert [(v["zcol"], v["nz"], v["terms"]) for v in lay] == [(0, 128, 1), (128, 16, 3)]
    assert zw == 128 + 3 * 16
    n_t = -(-n // 64)
    rng = np.random.default_rng(33)
    hbuf = np.full(n_t * 64 * hw, np.nan, np.float32)
    mats = []
    for v, d in zip(lay, dims[:-1]):
        m = rng.standard_normal((n, d)).astype(np.float32)
        mats.append(m)
        r, c = np.meshgrid(np.arange(n), np.arange(d), indexing="ij")
        off = ((r // 64) * 64 * hw + 64 * v["hcol"] + ((c // 8) * 8 + (r % 64) // 8) * 64
               + (r % 8) * 8 + c % 8)
        assert np.isnan(hbuf[off]).all()  # no two values on one place
        hbuf[off] = m[r, c]
    for v, d, m in zip(lay, dims[:-1], mats):
        out = mk.untile(torch.from_numpy(hbuf), n, hw, v["hcol"], d).numpy()
        np.testing.assert_array_equal(out, m)


def test_launcher_signatures_match_the_sources():
    """Every launcher's and query's argument types (``cuda_lib``) have as
    many entries as its C function has parameters, the stream included:
    ctypes passes a missing trailing pointer as a 32-bit int."""
    src = "".join(p.read_text() for p in sorted(CSRC.glob("*.cu")))
    sigs = {**cuda_lib.SIGNATURES, **{k: v[0] for k, v in cuda_lib.QUERIES.items()}}
    for name, argtypes in sigs.items():
        m = re.search(r'extern "C" [\w ]+ ngp_' + name + r"\(([^)]*)\)", src)
        assert m is not None, name
        assert len([a for a in m.group(1).split(",") if a.strip()]) == len(argtypes), name
