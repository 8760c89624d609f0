"""The premises of kernels G and I's designs against the JAX package on the
CPU: kernel G's order of sums (a warp scan of 5 shfl_up steps per chunk of
32 samples, with a carry from chunk to chunk) inside a copy of the plain
formulas stays within the card's tolerance of JAX's autodiff of its
composite + loss + regularizer; the bilinear entry's per-read arithmetic
(f32, three FMAs) gives the jitted JAX read bit for bit, and so does its
plain version; the new wrappers raise off the CPU instead of falling back."""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from chip_smoke import TOL_COMPOSITE_TRAIN, edge_positions
from instant_ngp_tpu.common import NERF_MIN_OPTICAL_THICKNESS
from instant_ngp_tpu.image_fit import task as jax_image_task
from instant_ngp_tpu.nerf.task import NerfTask as JaxNerfTask
from instant_ngp_torch import common
from instant_ngp_torch.common import EPS_T, LossType, NerfActivation
from instant_ngp_torch.nerf import train as port_train
from instant_ngp_torch.ops import gather as port_gather

torch.set_num_threads(2)

f32 = np.float32
R = 96
NEAR, REG_SCALE = 0.1, 1.0 / 128.0


def warp_cumsum(x: np.ndarray) -> np.ndarray:
    """Inclusive sums along axis 1 in kernel G's order: chunks of 32 lanes
    (the ragged last one padded with zeros), in each an inclusive
    Hillis-Steele scan (lane l adds lane l − d's value, d = 1, 2, 4, 8, 16),
    then the carry (the sum of the chunks before) added to every lane."""
    n, k = x.shape[:2]
    nc = -(-k // 32)
    pad = np.zeros((n, nc * 32 - k, *x.shape[2:]), f32)
    chunks = np.concatenate([x, pad], axis=1).reshape(n, nc, 32, *x.shape[2:])
    out = np.empty_like(chunks)
    carry = np.zeros((n, *x.shape[2:]), f32)
    for c in range(nc):
        y = chunks[:, c].copy()
        for d in (1, 2, 4, 8, 16):
            shifted = y.copy()
            shifted[:, d:] = y[:, d:] + y[:, :-d]
            y = shifted
        out[:, c] = carry[:, None] + y
        carry = out[:, c, 31]
    return out.reshape(n, nc * 32, *x.shape[2:])[:, :k]


def clip_grad(v, lo, hi):
    return np.where((v == lo) | (v == hi), f32(0.5), np.where((v > lo) & (v < hi), f32(1), f32(0)))


def kernel_g_emulated(out, ts, dts, valid, target, bg, ok, mean_density):
    """``composite_train_plain``'s formulas (logistic rgb, exponential
    density, Huber) in numpy f32, its cumsums in kernel G's order, rgb and
    T_final read from the scans' last sample as the kernel reads them."""
    x, s = out[..., :3], out[..., 3]
    c = f32(1) / (f32(1) + np.exp(-x))
    sigma = np.where(valid, np.exp(np.clip(s, f32(-15), f32(15))), f32(0))
    tau = sigma * dts
    cum = warp_cumsum(tau)
    T = np.exp(-cum + tau)
    e = np.exp(-tau)
    w = (f32(1) - e) * T
    prefix = warp_cumsum(w[..., None] * c)
    T_final = np.exp(-cum[:, -1])
    rgb = prefix[:, -1] + np.where(T_final >= f32(EPS_T), T_final, f32(0))[:, None] * bg
    d = rgb - target
    ad = np.abs(d)
    okf = ok.astype(f32)
    per_ray = np.mean(np.where(ad > f32(0.1), ad - f32(0.05), f32(5) * d * d) / f32(5), -1) * okf
    ct = (f32(1) / f32(R) * okf / f32(3))[:, None] / f32(5)
    G = np.where(ad > f32(0.1), ct * np.sign(d), ct * (f32(5) * d) + ct * d * f32(5))
    suffix = rgb[:, None, :] - prefix
    dtau = np.sum(G[:, None, :] * ((T * e)[..., None] * c - suffix), -1)
    dgrad = np.exp(np.clip(s, f32(-15), f32(15))) * clip_grad(s, f32(-15), f32(15))
    ds = np.where(valid, dtau * dts * dgrad, f32(0))
    foggy = mean_density < NERF_MIN_OPTICAL_THICKNESS
    coeff = (np.where(foggy & (s < 0), f32(-1e-4), f32(0))
             + np.where((s > -10) & (ts < NEAR), f32(1e-4), f32(0)))
    ds = ds + coeff * valid * f32(REG_SCALE) * clip_grad(s, f32(-30), f32(30))
    eg = np.exp(-x)
    dx = G[:, None, :] * w[..., None] * (eg / ((f32(1) + eg) * (f32(1) + eg)))
    return per_ray, np.concatenate([dx, ds[..., None]], -1)


@pytest.fixture(scope="module")
def jax_task():
    jt = JaxNerfTask(graft._synthetic_dataset(), graft._tiny_nerf_config(),
                     target_batch_size=1 << 12, n_rays_per_batch=R, max_samples_per_ray=8,
                     n_march_iters=16)
    jt.model = lambda params, *a, **kw: params["out"]
    return jt


def _window(K, seed):
    """Random outputs N(0, 2^2), a valid prefix of 0..K samples a ray, ts
    from 0.05 (some nearer than NEAR) in random steps, random dts, pixels,
    backgrounds and masks."""
    rng = np.random.default_rng(seed)
    valid = np.arange(K)[None, :] < rng.integers(0, K + 1, (R, 1))
    ts = np.where(valid, 0.05 + np.cumsum(rng.random((R, K)) * 0.03, 1), 0.0).astype(f32)
    dts = np.where(valid, rng.random((R, K)) * 0.02 + 0.002, 0.0).astype(f32)
    out = (rng.standard_normal((R, K, 4)) * 2).astype(f32)
    return (out, ts, dts, valid, rng.random((R, 3), dtype=f32), rng.random((R, 3), dtype=f32),
            rng.random(R) < 0.95)


@pytest.mark.parametrize("K,foggy", [(8, True), (32, False), (40, True), (48, False)])
def test_kernel_g_scan_order_within_tolerance_of_jax(jax_task, K, foggy):
    """Kernel G's order of sums (chunks of 32, 5 shfl_up steps, a carry; K
    under, at, and past a chunk, ragged and not) against jax.vjp of JAX's
    _composite + Huber + the density regularizers: per-ray loss and d/d out
    within TOL_COMPOSITE_TRAIN of their max |ref|, the card's tolerance of
    kernel G against its plain version."""
    jt = jax_task
    # the activations the emulation computes
    assert (jt.rgb_activation.value, jt.density_activation.value) == ("logistic", "exponential")
    out, ts, dts, valid, target, bg, ok = _window(K, K)
    mean_density = f32(0.0 if foggy else 0.5)
    o = np.tile(np.array([[0.5, 0.5, -0.7]], f32), (R, 1))
    d = np.tile(np.array([[0.0, 0.0, 1.0]], f32), (R, 1))

    def objective(params):
        rgb, _, _, (_, sigma_logit, _) = jt._composite(params, jnp.asarray(o), jnp.asarray(d),
                                                        jnp.asarray(ts), jnp.asarray(dts),
                                                        jnp.asarray(valid), jnp.asarray(bg))
        per_ray = jnp.mean(jt.loss(jnp.asarray(target), rgb), -1) * jnp.asarray(ok)
        coeff = (jnp.where((mean_density < NERF_MIN_OPTICAL_THICKNESS) & (sigma_logit < 0.0),
                           -1e-4, 0.0)
                 + jnp.where((sigma_logit > -10.0) & (jnp.asarray(ts) < NEAR), 1e-4, 0.0))
        coeff = coeff * jnp.asarray(valid) * REG_SCALE
        reg = jnp.sum(jax.lax.stop_gradient(coeff) * jnp.clip(sigma_logit, -30.0, 30.0))
        return jnp.mean(per_ray) + reg, per_ray

    (_, ref_per_ray), ref = jax.jit(jax.value_and_grad(objective, has_aux=True))(
        {"out": jnp.asarray(out.reshape(R * K, 4))})
    ref_grad = np.asarray(ref["out"]).reshape(R, K, 4)
    per_ray, dout = kernel_g_emulated(out, ts, dts, valid, target, bg, ok, mean_density)
    for got, want in ((per_ray, np.asarray(ref_per_ray)), (dout, ref_grad)):
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL_COMPOSITE_TRAIN * scale)
    # the same inputs through the port's plain version: the emulation differs
    # from it only in the order of its sums
    t = [torch.from_numpy(np.asarray(a)) for a in (out, ts, dts, valid, target, bg, ok)]
    p_per_ray, p_dout, *_ = port_train.composite_train_plain(
        *t, torch.tensor(mean_density), NEAR, REG_SCALE, float(f32(1) / f32(R)), LossType.HUBER,
        NerfActivation.LOGISTIC, NerfActivation.EXPONENTIAL)
    for got, want in ((per_ray, p_per_ray.numpy()), (dout, p_dout.numpy())):
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL_COMPOSITE_TRAIN * np.abs(want).max())


def test_warp_cumsum_is_an_inclusive_sum():
    """The emulated scan order sums what a cumsum sums: exact on small
    integers, at K under, at and over a chunk."""
    rng = np.random.default_rng(0)
    for k in (1, 31, 32, 33, 100):
        x = rng.integers(0, 9, (5, k)).astype(f32)
        np.testing.assert_array_equal(warp_cumsum(x), np.cumsum(x, 1))


def fmaf(a, b, c):
    """fmaf in numpy: the f64 product is exact, the f64 sum made round-to-odd
    (TwoSum gives its error; an inexact sum with an even last bit steps one
    ulp toward the exact sum), then rounded to f32: one rounding in all."""
    p = np.asarray(a, np.float64) * np.float64(b) if np.isscalar(b) else \
        np.asarray(a, np.float64) * np.asarray(b, np.float64)
    c = np.asarray(c, np.float64)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    step = (err != 0) & np.isfinite(err) & ((s.view(np.int64) & 1) == 0)
    return np.where(step, np.nextafter(s, np.copysign(np.inf, err)), s).astype(f32)


def round_to_f32(x: Fraction) -> np.float32:
    """The f32 nearest the exact value x, ties to an even last bit."""
    near = f32(float(x))
    cands = (np.nextafter(near, f32(-np.inf)), near, np.nextafter(near, f32(np.inf)))
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - x),
                                     int(np.array(v).view(np.uint32)) & 1))


def near_tie_triples(rng, n):
    """n triples (a, b, c) in f32 whose exact a·b + c lies a hair from a tie
    between two f32 values: c with a random odd or even last bit, a = 1 + u,
    b = ±(half an ulp of c)·(1 − u) with u = 2^-e, e in [12, 24), so a·b + c
    is the tie ∓ half an ulp·u²; where e >= 15 that is under half an f64
    ulp and the f64 sum lands on the tie. Then n random triples."""
    c = (rng.random(n) + 1.0).astype(f32) * np.exp2(rng.integers(-8, 8, n)).astype(f32)
    half_ulp = (np.nextafter(c, f32(np.inf)) - c) / f32(2)
    u = np.exp2(-rng.integers(12, 24, n)).astype(f32)
    sign = np.where(rng.random(n) < 0.5, f32(-1), f32(1))
    a = (f32(1) + u).astype(f32)
    b = (sign * half_ulp * (f32(1) - u)).astype(f32)
    ra, rb, rc = (rng.standard_normal((3, n)) * np.exp2(rng.integers(-20, 20, (3, n)))).astype(f32)
    return np.concatenate([a, ra]), np.concatenate([b, rb]), np.concatenate([c, rc])


def test_fma_exact_rounds_once_where_f64_rounds_twice():
    """A constructed tie: a·b + c = 1 + 2^-24 + 2^-70 exactly, just above
    the tie between 1 and 1 + 2^-23. The f64 sum rounds onto the tie, which
    rounds to even (1), so common.fma gives 1; a true FMA gives 1 + 2^-23,
    and so do common.fma_exact and the tests' numpy fmaf."""
    a, b, c = f32(1 + 2**-23), f32(-(2**-24) * (1 - 2**-23)), f32(1 + 2**-23)
    exact = round_to_f32(Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c)))
    assert exact == f32(1 + 2**-23)
    t = [torch.tensor([v]) for v in (a, b, c)]
    assert common.fma(*t).item() == 1.0  # the double rounding fma_exact repairs
    assert common.fma_exact(*t).item() == exact
    assert fmaf(a, b, c) == exact


@pytest.mark.parametrize("seed", [0, 1])
def test_fma_exact_equals_exact_rounding(seed):
    """common.fma_exact and the numpy fmaf against the exact sum rounded once
    (fractions), on near-tie and random f32 triples, bit for bit; the
    near-tie triples are ones where common.fma differs at least once."""
    rng = np.random.default_rng(seed)
    a, b, c = near_tie_triples(rng, 1500)
    want = np.array([round_to_f32(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], f32)
    t = [torch.from_numpy(v) for v in (a, b, c)]
    np.testing.assert_array_equal(common.fma_exact(*t).numpy(), want)
    np.testing.assert_array_equal(fmaf(a, b, c), want)
    assert (common.fma(*t).numpy() != want).any()


def bilinear_entry_emulated(tex: np.ndarray, uv: np.ndarray):
    """Kernel I's bilinear entry per read in f32: pos = fmaf(uv, res, −0.5),
    clamped to
    [0, res − 1.0001 in f32], floor, frac, corners clamped to [0, W−2] and
    [0, H−2], weights (1−fx)(1−fy), fx(1−fy), (1−fx)fy, fx·fy, and the sum
    fma(w11, v11, fma(w01, v01, fma(w00, v00, w10·v10))). Returns ((x0, y0),
    the reads)."""
    h, w = tex.shape[:2]

    def axis(u, r):
        hi = f32(r) - f32(1.0 + 1e-4)
        p = np.minimum(np.maximum(fmaf(u, f32(r), -0.5), f32(0)), hi)
        i = np.floor(p)
        return p - i, np.clip(i.astype(np.int64), 0, r - 2)

    fx, x0 = axis(uv[:, 0], w)
    fy, y0 = axis(uv[:, 1], h)
    gx, gy = f32(1) - fx, f32(1) - fy
    w00, w10, w01, w11 = ((a * b)[:, None] for a, b in ((gx, gy), (fx, gy), (gx, fy), (fx, fy)))
    v00, v10, v01, v11 = tex[y0, x0], tex[y0, x0 + 1], tex[y0 + 1, x0], tex[y0 + 1, x0 + 1]
    return (x0, y0), fmaf(w11, v11, fmaf(w01, v01, fmaf(w00, v00, w10 * v10)))


def _positions(rng, w, h):
    """Random positions, the edge positions chip_smoke.py holds the entry at
    on the card, and pixel centres."""
    centers = np.stack([(rng.integers(0, w, 500) + 0.5) / w,
                        (rng.integers(0, h, 500) + 0.5) / h], -1)
    return np.concatenate([rng.random((4000, 2)), edge_positions((w, h)).numpy(),
                           centers]).astype(f32)


@pytest.mark.parametrize("shape", [(517, 1021), (37, 53), (2, 2)])
def test_bilinear_entry_arithmetic_equals_jax_bit_for_bit(shape):
    """The entry's per-read arithmetic emulated in f32: the same corners as
    the port's bilinear_texels and the same values as the jitted JAX
    bilinear_read, bit for bit, at random, edge and pixel-centre positions
    of a non-square texture."""
    h, w = shape
    rng = np.random.default_rng(h + w)
    tex = rng.random((h, w, 4), dtype=f32)
    uv = _positions(rng, w, h)
    (x0, y0), ours = bilinear_entry_emulated(tex, uv)
    np.testing.assert_array_equal(ours, np.asarray(jax.jit(jax_image_task.bilinear_read)(tex, uv)))
    idx, _ = port_gather.bilinear_texels((w, h), torch.from_numpy(uv))
    np.testing.assert_array_equal(idx.numpy()[:uv.shape[0]], y0 * w + x0)


@pytest.mark.parametrize("shape", [(517, 1021), (64, 16), (2, 2)])
def test_bilinear_read_plain_equals_jax_bit_for_bit(shape):
    """bilinear_read_plain, the entry's reference on the card, against the
    jitted JAX bilinear_read: equal bit for bit."""
    h, w = shape
    rng = np.random.default_rng(h * w)
    tex = rng.random((h, w, 4), dtype=f32)
    uv = _positions(rng, w, h)
    ours = port_gather.bilinear_read_plain(torch.from_numpy(tex.reshape(h * w, 4)), (w, h),
                                           torch.from_numpy(uv)).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jax.jit(jax_image_task.bilinear_read)(tex, uv)))


@pytest.mark.parametrize("which", ["G", "I_take_rows", "I_bilinear"])
def test_wrappers_do_not_fall_back_off_the_cpu(which):
    """A tensor that is neither on the CPU nor on the card raises: the
    wrappers run their plain versions for CPU tensors only."""
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="CUDA"):
        if which == "G":
            z = torch.zeros((4, 8), device=meta)
            port_train.composite_train(
                torch.zeros((4, 8, 4), device=meta), z, z, torch.zeros((4, 8), dtype=torch.bool,
                                                                       device=meta),
                torch.zeros((4, 3), device=meta), torch.zeros((4, 3), device=meta),
                torch.zeros(4, dtype=torch.bool, device=meta), torch.zeros((), device=meta),
                NEAR, REG_SCALE, 0.25, LossType.HUBER, NerfActivation.LOGISTIC,
                NerfActivation.EXPONENTIAL)
        elif which == "I_take_rows":
            port_gather.take_rows(torch.zeros((16, 4), device=meta),
                                  torch.zeros(8, dtype=torch.int32, device=meta))
        else:
            port_gather.bilinear_read(torch.zeros((16, 4), device=meta), (4, 4),
                                      torch.zeros((8, 2), device=meta))
