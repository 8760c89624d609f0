"""Kernel G's plain version in every loss and train mode against the JAX
package on the CPU: ``composite_train_plain`` against ``jax.value_and_grad``
of the JAX step's objective (``instant_ngp_tpu/nerf/task.py``'s
``_composite``, the per-ray loss, the nerf / rfl / rflrelax objectives of
:930-990 and the density regularizers of :1004-1020), the network replaced
by the outputs themselves and the target an argument, for the 7 losses ×
3 modes: the per-ray loss, d objective / d out and d objective / d target.
The same f32 formulas, sums in another order: each within 1e-4 of its
largest |ref|. Then the losses' values against the JAX package's and their
derivatives against ``jax.grad``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from instant_ngp_tpu.common import NERF_MIN_OPTICAL_THICKNESS
from instant_ngp_tpu.nerf.task import EPS_T
from instant_ngp_tpu.common import network_to_density as jax_network_to_density
from instant_ngp_tpu.nerf.task import NerfTask as JaxNerfTask
from instant_ngp_tpu.ops import losses as jax_losses
from instant_ngp_torch.common import LossType, NerfActivation
from instant_ngp_torch.nerf import train as port_train
from instant_ngp_torch.ops import losses as port_losses

torch.set_num_threads(2)

R, K = 96, 12
NEAR, REG_SCALE = 0.1, 1.0 / 128.0
LOSSES = ["L2", "Huber", "L1", "Mape", "Smape", "LogL1", "RelativeL2"]
MODES = ["nerf", "rfl", "rflrelax"]


@pytest.fixture(scope="module")
def jax_task():
    jt = JaxNerfTask(graft._synthetic_dataset(), graft._tiny_nerf_config(),
                     target_batch_size=1 << 12, n_rays_per_batch=R, max_samples_per_ray=K,
                     n_march_iters=16)
    jt.model = lambda params, *a, **kw: params["out"]
    return jt


def _window(seed):
    """Outputs N(0, 1.5^2), a valid prefix of 0..K samples a ray, ts from
    0.05 (some nearer than NEAR), random dts, targets and backgrounds (a few
    targets equal to their background, as a transparent pixel's is), masks."""
    rng = np.random.default_rng(seed)
    valid = np.arange(K)[None, :] < rng.integers(0, K + 1, (R, 1))
    ts = np.where(valid, 0.05 + np.cumsum(rng.random((R, K)) * 0.03, 1), 0.0).astype(np.float32)
    dts = np.where(valid, rng.random((R, K)) * 0.05 + 0.002, 0.0).astype(np.float32)
    out = (rng.standard_normal((R, K, 4)) * 1.5).astype(np.float32)
    target = rng.random((R, 3), dtype=np.float32)
    bg = rng.random((R, 3), dtype=np.float32)
    target[:4] = bg[:4]
    return out, ts, dts, valid, target, bg, rng.random(R) < 0.9


def _jax_objective(jt, mode, loss, ts, dts, valid, bg, ok, mean_density):
    """The JAX step's objective of (outputs, target), as task.py:930-1020
    forms it with the network's outputs given."""
    o = jnp.tile(jnp.array([[0.5, 0.5, -0.7]], jnp.float32), (R, 1))
    d = jnp.tile(jnp.array([[0.0, 0.0, 1.0]], jnp.float32), (R, 1))
    sg = jax.lax.stop_gradient
    ts, dts, valid, bg, ok = (jnp.asarray(a) for a in (ts, dts, valid, bg, ok))

    def objective(params, target):
        rgb_ray, _, weight, (T_final, sigma_logit, saux) = jt._composite(
            params, o, d, ts, dts, valid, bg)
        per_ray = jnp.mean(loss(target, rgb_ray), axis=-1) * ok
        if mode == "nerf":
            obj = jnp.mean(per_ray)
        elif mode == "rfl":
            l_s = loss(jnp.broadcast_to(target[:, None, :], saux["rgb"].shape), saux["rgb"])
            comp = jnp.sum(weight[..., None] * l_s, axis=1)
            comp = comp + jnp.where(T_final >= EPS_T, T_final, 0.0)[:, None] * loss(target, bg)
            obj = jnp.mean(jnp.mean(comp, axis=-1) * ok)
        else:
            rgb_s, alpha_s, T_before = saux["rgb"], saux["alpha"], saux["T_before"]
            prefix = jnp.cumsum(weight[..., None] * rgb_s, axis=1)
            suffix = rgb_ray[:, None, :] - prefix
            T_after = T_before - weight
            rgb_bg = suffix / jnp.maximum(T_after, 1e-6)[..., None]
            lerp = sg((1.0 - alpha_s[..., None]) * rgb_bg) + sg(alpha_s[..., None]) * rgb_s
            tgt_b = jnp.broadcast_to(target[:, None, :], rgb_s.shape)
            g_local = jax.grad(lambda p: jnp.sum(loss(tgt_b, p)))(sg(lerp))
            color = jnp.sum(sg(T_before * saux["valid"] * ok[:, None])[..., None]
                            * loss(tgt_b, lerp)) / 3.0
            dsig = jnp.sum(g_local * (T_after[..., None] * rgb_s - suffix), axis=-1) \
                * dts * saux["valid"] * ok[:, None] / 3.0
            dens = jnp.sum(sg(dsig) * jax_network_to_density(sigma_logit, jt.density_activation))
            obj = (color + dens) / R
        coeff = (jnp.where((mean_density < NERF_MIN_OPTICAL_THICKNESS) & (sigma_logit < 0.0),
                           -1e-4, 0.0)
                 + jnp.where((sigma_logit > -10.0) & (ts < NEAR), 1e-4, 0.0))
        coeff = coeff * valid * REG_SCALE
        reg = jnp.sum(sg(coeff) * jnp.clip(sigma_logit, -30.0, 30.0))
        return obj + reg, per_ray

    return objective


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("loss_name", LOSSES)
def test_composite_train_plain_equals_jax(jax_task, loss_name, mode):
    jt = jax_task
    assert (jt.rgb_activation.value, jt.density_activation.value) == ("logistic", "exponential")
    out, ts, dts, valid, target, bg, ok = _window(LOSSES.index(loss_name) * 3 + MODES.index(mode))
    mean_density = np.float32(0.0 if mode != "rfl" else 0.5)
    loss = jax_losses.loss_fn(jax_losses.loss_type_from_string(loss_name))
    objective = _jax_objective(jt, mode, loss, ts, dts, valid, bg, ok, mean_density)
    (_, ref_per_ray), (ref_dout, ref_dtarget) = jax.jit(
        jax.value_and_grad(objective, argnums=(0, 1), has_aux=True))(
        {"out": jnp.asarray(out.reshape(R * K, 4))}, jnp.asarray(target))
    t = [torch.from_numpy(np.asarray(a)) for a in (out, ts, dts, valid, target, bg, ok)]
    per_ray, dout, dtarget, *_ = port_train.composite_train_plain(
        *t, torch.tensor(mean_density), NEAR, REG_SCALE, float(np.float32(1) / np.float32(R)),
        port_losses.loss_type_from_string(loss_name), NerfActivation.LOGISTIC,
        NerfActivation.EXPONENTIAL, mode, want_dtarget=True)
    pairs = ((per_ray, ref_per_ray), (dout, np.asarray(ref_dout["out"]).reshape(R, K, 4)),
             (dtarget, ref_dtarget))
    for got, want in pairs:
        want = np.asarray(want)
        scale = float(np.abs(want).max())
        assert scale > 0
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * scale)
    # without d/d target the same two outputs, and None in its slot
    per_ray2, dout2, dtarget2, *_ = port_train.composite_train_plain(
        *t, torch.tensor(mean_density), NEAR, REG_SCALE, float(np.float32(1) / np.float32(R)),
        port_losses.loss_type_from_string(loss_name), NerfActivation.LOGISTIC,
        NerfActivation.EXPONENTIAL, mode)
    assert torch.equal(per_ray2, per_ray) and torch.equal(dout2, dout) and dtarget2 is None


@pytest.mark.parametrize("loss_name", LOSSES)
def test_losses_and_their_derivatives_equal_jax(loss_name):
    """``loss_fn`` against the JAX package's (rtol 1e-6); ``loss_and_grads``'
    value and derivatives in the prediction and the target against
    ``jax.grad`` of the JAX loss (rtol 1e-5), at d = 0 too, where |x|'s slope
    is +1 as JAX takes it."""
    rng = np.random.default_rng(LOSSES.index(loss_name))
    t = rng.standard_normal((400, 3)).astype(np.float32)
    p = (t + rng.standard_normal((400, 3)) * 0.3).astype(np.float32)
    p[:20] = t[:20]
    lt = port_losses.loss_type_from_string(loss_name)
    jl = jax_losses.loss_fn(jax_losses.loss_type_from_string(loss_name))
    ref = np.asarray(jl(t, p))
    np.testing.assert_allclose(port_losses.loss_fn(lt)(torch.from_numpy(t), torch.from_numpy(p))
                               .numpy(), ref, rtol=1e-6, atol=1e-7)
    ref_dp, ref_dt = jax.grad(lambda a, b: jnp.sum(jl(a, b)), argnums=(1, 0))(t, p)
    val, dp, dt = port_losses.loss_and_grads(lt, torch.from_numpy(t), torch.from_numpy(p))
    np.testing.assert_allclose(val.numpy(), ref, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(dp.numpy(), np.asarray(ref_dp), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(dt.numpy(), np.asarray(ref_dt), rtol=1e-5, atol=1e-6)


def test_unknown_mode_raises():
    t = [torch.zeros((2, 3, 4)), torch.zeros((2, 3)), torch.zeros((2, 3)),
         torch.zeros((2, 3), dtype=torch.bool), torch.zeros((2, 3)), torch.zeros((2, 3)),
         torch.ones(2, dtype=torch.bool), torch.zeros(())]
    with pytest.raises(ValueError, match="train mode"):
        port_train.composite_train_plain(*t, NEAR, REG_SCALE, 0.5, LossType.L2,
                                         NerfActivation.LOGISTIC, NerfActivation.EXPONENTIAL,
                                         "surface")
