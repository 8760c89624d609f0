"""Kernel G's plain version with the depth objective and d objective / d bg
(the trained environment map's path) against ``jax.vjp`` of the JAX
package's objective on the CPU: ``_composite`` (the network replaced by its
outputs), the photometric loss of the train mode, the density regularizers
and λ·mean(ℓ_d(target depth, depth)·[target depth > 0]) (task.py:753,
930-1037)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instant_ngp_tpu.common import NERF_MIN_OPTICAL_THICKNESS
from instant_ngp_tpu.ops.losses import loss_fn, loss_type_from_string
from instant_ngp_torch.common import LossType
from instant_ngp_torch.nerf import train as port_train

from test_torch_train_step import K, R, _t, _tasks

LAMBDA = 0.7


def _inputs(seed):
    rng = np.random.default_rng(seed)
    o = np.tile(np.array([[0.5, 0.5, -0.7]], np.float32), (R, 1))
    d = rng.standard_normal((R, 3)).astype(np.float32) * 0.2 + np.array([0, 0, 1], np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    n_valid = rng.integers(0, K + 1, R)
    valid = np.arange(K)[None, :] < n_valid[:, None]
    ts = np.where(valid, 0.7 + np.cumsum(rng.random((R, K)) * 0.03, 1), 0.0).astype(np.float32)
    dts = np.where(valid, 0.02, 0.0).astype(np.float32)
    return dict(o=o, d=d, valid=valid, ts=ts, dts=dts,
                bg=rng.random((R, 3), dtype=np.float32),
                target=rng.random((R, 3), dtype=np.float32),
                ok=rng.random(R) < 0.9,
                depth=np.where(rng.random(R) < 0.8, rng.uniform(0.6, 1.2, R), 0.0).astype(
                    np.float32),
                out=(rng.standard_normal((R * K, 4)) * 2).astype(np.float32))


@pytest.mark.parametrize("mode,depth_loss", [("nerf", "L1"), ("nerf", "Huber"), ("rfl", "L2"),
                                             ("rflrelax", "L1")])
def test_composite_depth_and_background_gradients_equal_jax(mode, depth_loss):
    """d objective / d out, / d target and / d bg, the per-ray loss and the
    depth, each within 1e-4 of its largest |ref| (the same f32 formulas,
    sums in another order, suffixes taken as differences)."""
    jt, pt = _tasks(3)
    x = _inputs(4 + len(mode))
    jt.model = lambda params, *a, **kw: params["out"]
    grid_mean = jt.state.grid.mean_density
    loss = jt.loss
    dl = loss_fn(loss_type_from_string(depth_loss))
    j = {k: jnp.asarray(v) for k, v in x.items()}

    def objective(out, target, bg):
        rgb, depth_ray, weight, (T_final, sigma_logit, saux) = jt._composite(
            {"out": out}, j["o"], j["d"], j["ts"], j["dts"], j["valid"], bg)
        per_ray = jnp.mean(loss(target, rgb), -1) * j["ok"]
        if mode == "nerf":
            obj = jnp.mean(per_ray)
        elif mode == "rfl":
            l_s = loss(jnp.broadcast_to(target[:, None, :], saux["rgb"].shape), saux["rgb"])
            comp = jnp.sum(weight[..., None] * l_s, 1) + jnp.where(
                T_final >= 1e-4, T_final, 0.0)[:, None] * loss(target, bg)
            obj = jnp.mean(jnp.mean(comp, -1) * j["ok"])
        else:  # rflrelax (task.py:978-990)
            sg = jax.lax.stop_gradient
            rgb_s, alpha_s, T_before = saux["rgb"], saux["alpha"], saux["T_before"]
            suffix = rgb[:, None, :] - jnp.cumsum(weight[..., None] * rgb_s, 1)
            T_after = T_before - weight
            lerp = (sg((1.0 - alpha_s[..., None]) * suffix / jnp.maximum(T_after, 1e-6)[..., None])
                    + sg(alpha_s[..., None]) * rgb_s)
            tgt_b = jnp.broadcast_to(target[:, None, :], rgb_s.shape)
            g_local = jax.grad(lambda p: jnp.sum(loss(tgt_b, p)))(sg(lerp))
            color = jnp.sum(sg(T_before * saux["valid"] * j["ok"][:, None])[..., None]
                            * loss(tgt_b, lerp)) / 3.0
            dsig = jnp.sum(g_local * (T_after[..., None] * rgb_s - suffix), -1) * j["dts"] * \
                saux["valid"] * j["ok"][:, None] / 3.0
            sigma = jnp.where(saux["valid"], jnp.exp(jnp.clip(sigma_logit, -15.0, 15.0)), 0.0)
            obj = (color + jnp.sum(sg(dsig) * sigma)) / R
        coeff = (jnp.where((grid_mean < NERF_MIN_OPTICAL_THICKNESS) & (sigma_logit < 0.0),
                           -1e-4, 0.0)
                 + jnp.where((sigma_logit > -10.0) & (j["ts"] < 0.1), 1e-4, 0.0))
        coeff = coeff * j["valid"] * (1.0 / 128.0)
        reg = jnp.sum(jax.lax.stop_gradient(coeff) * jnp.clip(sigma_logit, -30.0, 30.0))
        dloss = dl(j["depth"][:, None], depth_ray[:, None])[:, 0] * (j["depth"] > 0)
        return obj + reg + LAMBDA * jnp.mean(dloss), (per_ray, depth_ray)

    (_, (ref_per_ray, ref_depth)), vjp = jax.vjp(objective, j["out"], j["target"], j["bg"])
    refs = vjp((jnp.float32(1.0), (jnp.zeros(R), jnp.zeros(R))))
    assert np.abs(np.asarray(refs[2])).max() > 0 or mode == "rflrelax"
    ltype = {"L1": LossType.L1, "Huber": LossType.HUBER, "L2": LossType.L2}[depth_loss]
    per_ray, dout, dtarget, dbg, depth = port_train.composite_train_plain(
        _t(x["out"]).reshape(R, K, 4), _t(x["ts"]), _t(x["dts"]), _t(x["valid"]),
        _t(x["target"]), _t(x["bg"]), _t(x["ok"]), _t(np.asarray(grid_mean)), 0.1, 1.0 / 128.0,
        float(np.float32(1.0) / np.float32(R)), pt.loss_type, pt.rgb_activation,
        pt.density_activation, mode, want_dtarget=True,
        depth=port_train.DepthTerm(_t(x["depth"]), LAMBDA, ltype), want_dbg=True,
        want_depth=True)
    for name, a, b in (("dout", dout.reshape(R * K, 4), refs[0]), ("dtarget", dtarget, refs[1]),
                       ("dbg", dbg, refs[2]), ("per_ray", per_ray, ref_per_ray),
                       ("depth", depth, ref_depth)):
        b = np.asarray(b)
        scale = max(np.abs(b).max(), 1e-30)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-4 * scale, err_msg=name)
    if mode == "rflrelax":  # its coefficients are stop-gradients
        assert not dbg.any()


def test_logistic_gradient_is_zero_where_jax_gives_nan():
    """The rgb logistic's gradient as JAX's autodiff of 1 / (1 + e^-x)
    forms it, e^-x / (1 + e^-x)², within an f32 ulp where that is finite (XLA
    fuses it otherwise), and 0,
    its limit, where e^-x overflows (x < -88.7): JAX gives NaN there, and
    one such sample's NaN reached every parameter and stopped fox's
    training (found by instant_ngp_torch/bench/nerf_repeat.py). G's plain
    version on such outputs: d/d out finite, those samples' rgb rows 0."""
    from instant_ngp_tpu.common import logistic as jax_logistic
    from instant_ngp_torch.common import NerfActivation, network_to_rgb_grad

    x = np.array([-200.0, -100.0, -89.0, -88.7, -88.0, -50.0, -1.0, 0.0, 3.0, 50.0, 100.0],
                 np.float32)
    ref = np.asarray(jax.vmap(jax.grad(jax_logistic))(jnp.asarray(x)))
    ours = network_to_rgb_grad(_t(x), NerfActivation.LOGISTIC).numpy()
    overflow = np.isinf(np.exp(-x.astype(np.float32)))
    assert np.all(np.isnan(ref[overflow])) and overflow.sum() == 3
    # XLA flushes denormals to 0 (x = 100): atol the smallest normal f32
    np.testing.assert_allclose(ours[~overflow], ref[~overflow], rtol=1.2e-7, atol=1.2e-38)
    assert np.all(ours[overflow] == 0.0)
    _, pt = _tasks(3)
    x_in = _inputs(12)
    out = _t(x_in["out"]).reshape(R, K, 4)
    out[::7, :, 0] = -100.0
    per_ray, dout, *_ = port_train.composite_train_plain(
        out, _t(x_in["ts"]), _t(x_in["dts"]), _t(x_in["valid"]), _t(x_in["target"]),
        _t(x_in["bg"]), _t(x_in["ok"]), torch.tensor(0.0), 0.1, 1.0 / 128.0, 1.0 / R,
        pt.loss_type, NerfActivation.LOGISTIC, pt.density_activation)
    assert bool(torch.isfinite(dout).all()) and bool(torch.isfinite(per_ray).all())
    assert not dout[::7, :, 0].any()
