"""The port's NeRF training step against the JAX package's on the CPU:
kernel G's plain version against ``jax.value_and_grad`` of ``_composite`` +
Huber + the density regularizers (compaction off and on), the error-CDF
pixel sampling, and one whole ``_train_step`` from the same state with the
JAX package's draws injected, with the error CDF off and on."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from instant_ngp_tpu.common import NERF_MIN_OPTICAL_THICKNESS
from instant_ngp_tpu.nerf import occupancy as jax_occ
from instant_ngp_tpu.nerf.sampler import march_rays as jax_march
from instant_ngp_tpu.nerf.task import NerfTask as JaxNerfTask
from instant_ngp_tpu.nerf.task import _rebuild_error_cdf
from instant_ngp_torch.io.nerf_loader import NerfDataset
from instant_ngp_torch.models.nerf_network import train_state_from_jax, train_state_to_numpy
from instant_ngp_torch.nerf import train as port_train
from instant_ngp_torch.nerf.task import NerfTask
from instant_ngp_torch.ops.compaction import expand_gather, prefix_compaction_maps

torch.set_num_threads(2)

R, K, ITERS = 128, 16, 48
TARGET = 1 << 11  # sample capacity 1024 < R·K: the step compacts and drops


def _grid(seed):
    rng = np.random.default_rng(seed)
    dens = np.where(rng.random((1, 128, 128, 128)) < 0.15, 0.05, 0.0).astype(np.float32)
    dens = jnp.asarray(dens)
    mean = jnp.mean(jnp.maximum(dens[0], 0.0))  # below the optical-thickness floor: foggy
    bits = jax_occ._bitfield_from_density(dens, mean)
    return jax_occ.OccupancyGridState(density=dens, bitfield=bits, skipmip=jax_occ._skip_chain(bits),
                                      mean_density=mean, ema_step=jnp.int32(1))


def _tasks(seed=0):
    ds = graft._synthetic_dataset()
    cfg = graft._tiny_nerf_config()
    kw = dict(target_batch_size=TARGET, n_rays_per_batch=R, max_samples_per_ray=K,
              n_march_iters=ITERS)
    jt = JaxNerfTask(ds, cfg, **kw)
    jt.state = dataclasses.replace(jt.state, grid=_grid(seed))
    # exact corners: the stochastic corner is a hash of the positions' last
    # bit, which the two packages' ray arithmetic does not share everywhere
    jt.model = dataclasses.replace(jt.model, pos_encoding=dataclasses.replace(
        jt.model.pos_encoding, hashed_grad_corners=8))
    pds = NerfDataset(images=ds.images, is_hdr=False, xforms_start=ds.xforms_start,
                      xforms_end=ds.xforms_end, focal_lengths=ds.focal_lengths,
                      principal_points=ds.principal_points, rolling_shutter=ds.rolling_shutter,
                      resolution=ds.resolution, aabb_scale=ds.aabb_scale)
    pt = NerfTask(pds, cfg, "cpu", **kw)
    pt.model.pos_encoding.hashed_grad_corners = 8
    assert pt.compact_samples == jt.compact_samples and pt.error_map_res == jt.error_map_res
    train_state_from_jax(pt.model, pt.state, jt.state)
    return jt, pt


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


@pytest.mark.parametrize("capacity", [None, 700])
def test_composite_loss_gradient_equals_jax(capacity):
    """d(mean Huber loss + regularizer)/d(network output): JAX's autodiff of
    its _composite (the network replaced by the outputs themselves) against
    composite_train_plain. The same f32 formulas; sums in another order and
    the suffix taken as a difference: rtol 1e-4 of the largest gradient."""
    jt, pt = _tasks(1)
    rng = np.random.default_rng(2)
    o = np.tile(np.array([[0.5, 0.5, -0.7]], np.float32), (R, 1))
    d = rng.standard_normal((R, 3)).astype(np.float32) * 0.2 + np.array([0, 0, 1], np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    n_valid = rng.integers(0, K + 1, R)
    valid = np.arange(K)[None, :] < n_valid[:, None]
    ts = np.where(valid, 0.7 + np.cumsum(rng.random((R, K)) * 0.03, 1), 0.0).astype(np.float32)
    dts = np.where(valid, 0.02, 0.0).astype(np.float32)
    bg = rng.random((R, 3), dtype=np.float32)
    target = rng.random((R, 3), dtype=np.float32)
    ok = rng.random(R) < 0.9
    n_rows = capacity or R * K
    out = (rng.standard_normal((n_rows, 4)) * 2).astype(np.float32)
    jt.model = lambda params, *a, **kw: params["out"]
    grid_mean = jt.state.grid.mean_density

    def objective(params):
        rgb, _, _, (_, sigma_logit, _) = jt._composite(params, jnp.asarray(o), jnp.asarray(d),
                                                        jnp.asarray(ts), jnp.asarray(dts),
                                                        jnp.asarray(valid), jnp.asarray(bg),
                                                        compact=capacity)
        per_ray = jnp.mean(jt.loss(jnp.asarray(target), rgb), -1) * jnp.asarray(ok)
        # the regularizer of task.py:1006-1018 (valid after the capacity drop)
        v = jnp.asarray(valid)
        if capacity is not None:
            from instant_ngp_tpu.ops.compaction import prefix_compaction_maps as jmaps

            v = v & jmaps(jnp.sum(v, -1), K, capacity).kept.reshape(R, K)
        coeff = (jnp.where((grid_mean < NERF_MIN_OPTICAL_THICKNESS) & (sigma_logit < 0.0),
                           -1e-4, 0.0)
                 + jnp.where((sigma_logit > -10.0) & (jnp.asarray(ts) < 0.1), 1e-4, 0.0))
        coeff = coeff * v * (1.0 / 128.0)
        reg = jnp.sum(jax.lax.stop_gradient(coeff) * jnp.clip(sigma_logit, -30.0, 30.0))
        return jnp.mean(per_ray) + reg, per_ray

    (_, ref_per_ray), ref_grad = jax.jit(jax.value_and_grad(objective, has_aux=True))(
        {"out": jnp.asarray(out)})
    ref_grad = np.asarray(ref_grad["out"])
    out_t = _t(out).requires_grad_(True)
    valid_t = _t(valid)
    if capacity is None:
        full = out_t.reshape(R, K, 4)
    else:
        maps = prefix_compaction_maps(_t(n_valid), K, capacity)
        full = expand_gather(out_t, maps).reshape(R, K, 4)
        valid_t = valid_t & maps.kept.reshape(R, K)
    per_ray, dout, *_ = port_train.composite_train_plain(
        full.detach(), _t(ts), _t(dts), valid_t, _t(target), _t(bg), _t(ok),
        pt.state.grid.mean_density, 0.1, 1.0 / 128.0, float(np.float32(1) / np.float32(R)),
        pt.loss_type, pt.rgb_activation, pt.density_activation)
    (grad,) = torch.autograd.grad(full, out_t, dout)
    np.testing.assert_allclose(per_ray.numpy(), np.asarray(ref_per_ray), rtol=1e-5, atol=1e-7)
    scale = float(np.abs(ref_grad).max())
    np.testing.assert_allclose(grad.numpy(), ref_grad, rtol=0, atol=1e-4 * scale)


def test_error_cdf_and_pixel_sampling_equal_jax():
    """The CDF rebuild (rtol 1e-6) and the inverse-CDF pixel pick from the
    same uniforms: image and pixel bins exact, uv and pdf rtol 1e-5."""
    jt, pt = _tasks(2)
    rng = np.random.default_rng(3)
    emap = (rng.random(jt.state.error_map.shape) ** 4).astype(np.float32)
    ref = _rebuild_error_cdf(jnp.asarray(emap))
    cdfs = port_train.rebuild_error_cdf(_t(emap))
    for a, b in zip(cdfs, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    pt.cdf_x, pt.cdf_y, pt.cdf_img, pt.pmf_img = (_t(np.asarray(a)) for a in ref)
    data = dict(jt.data, cdf_x=ref[0], cdf_y=ref[1], cdf_img=ref[2], pmf_img=ref[3])
    key = jax.random.PRNGKey(5)
    img, uv, pdf = jt._sample_pixels(data, key, 4096, True)
    k_img, k_uv, _, _ = jax.random.split(key, 4)
    p_img, p_uv, p_pdf = port_train.sample_pixels(
        pt, _t(jax.random.uniform(k_img, (4096,))), _t(jax.random.uniform(k_uv, (4096, 2))), True)
    np.testing.assert_array_equal(p_img.numpy(), np.asarray(img))
    np.testing.assert_allclose(p_uv.numpy(), np.asarray(uv), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(p_pdf.numpy(), np.asarray(pdf), rtol=1e-5)


def _jax_step_with_grads(jt, state, data, key, use_cdf):
    """The jitted JAX step, also returning the gradients it hands to Adam."""
    seen = {}
    update = jt.opt.update

    def spy(grads, st, params, **kw):
        seen["grads"] = grads
        return update(grads, st, params, **kw)

    jt.opt.update = spy

    def step(state, data, key):
        new_state, stats = jt._train_step(state, data, key, 0, n_rays=R, use_cdf=use_cdf)
        return new_state, stats, seen["grads"]

    try:
        return jax.jit(step)(state, data, key)
    finally:
        jt.opt.update = update


@pytest.mark.parametrize("use_cdf", [False, True])
def test_train_step_equals_jax_with_injected_draws(use_cdf):
    """One whole step from the same state and draws, exact corners.
    Gradients per leaf: every dW and the encoding's cotangent are rounded to
    bf16 after f32 sums taken in another order (one bf16 step is 2^-8), and
    the JAX package sums dense-level table gradients in a bf16 splat: held
    to 1e-2 (MLPs, hashed levels) and 3e-2 (dense levels) of the leaf's
    largest gradient. Loss and error map: rtol 1e-5. New parameters and
    Adam moments where |g| > 1e-3 of the leaf's largest gradient (Adam's
    first step moves each parameter by ±lr wherever g ≠ 0)."""
    jt, pt = _tasks(3)
    data = dict(jt.data)
    if use_cdf:
        rng = np.random.default_rng(4)
        emap = jnp.asarray((rng.random(jt.state.error_map.shape) ** 4).astype(np.float32))
        cdfs = _rebuild_error_cdf(emap)
        data.update(cdf_x=cdfs[0], cdf_y=cdfs[1], cdf_img=cdfs[2], pmf_img=cdfs[3])
        pt.cdf_x, pt.cdf_y, pt.cdf_img, pt.pmf_img = (_t(np.asarray(a)) for a in cdfs)
    key = jax.random.PRNGKey(9)
    k_pix, k_bg, k_jit, _ = jax.random.split(key, 4)
    img, uv, pdf = jt._sample_pixels(data, k_pix, R, use_cdf)
    draws = port_train.StepDraws(_t(img, torch.int64), _t(uv), _t(pdf),
                                 _t(jax.random.uniform(k_jit, (R,))),
                                 _t(jax.random.uniform(k_bg, (R, 3))))
    state0 = jt.state
    new_state, stats, grads = _jax_step_with_grads(jt, state0, data, key, use_cdf)

    # the march: the port marches as the compiled reference does
    o, d = jax.jit(lambda dd, i, u: jt._generate_rays(dd, i, u, None))(
        data, img, (jnp.floor(uv * jnp.array([16.0, 16.0])) + 0.5) / 16.0)
    ref_march = jax.jit(lambda o, d, s, j: jax_march(o, d, s, jnp.asarray(jt.aabb_min),
                                                     jnp.asarray(jt.aabb_max), j, jt.march_cfg))(
        o, d, state0.grid.skipmip, jax.random.uniform(k_jit, (R,)))
    p_grads, per_ray, batch = port_train.step_gradients(pt, draws)
    n_valid = batch.n_valid
    assert np.mean(n_valid.numpy() == np.asarray(ref_march[4])) >= 0.99
    assert int(n_valid.sum()) > TARGET // 2  # the capacity drop is exercised

    levels = pt.model.pos_encoding.levels
    ref = {"density_net": grads["density_net"], "rgb_net": grads["rgb_net"]}
    ours = {"density_net": p_grads[:2], "rgb_net": p_grads[2:4]}
    for key_ in ref:
        for a, b in zip(ours[key_], ref[key_]):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-2 * np.abs(b).max())
    table = p_grads[4].numpy()
    for lv, b in zip(levels, grads["pos_enc"]):
        b = np.asarray(b)
        a = table[lv.offset:lv.offset + lv.size]
        tol = (1e-2 if lv.hashed else 3e-2) * np.abs(b).max()
        np.testing.assert_allclose(a, b, rtol=0, atol=tol)
    assert float(per_ray.mean()) == pytest.approx(float(stats["loss"]), rel=1e-5)

    # the full step: Adam, EMA-free config, error map
    stats_p = port_train.train_step(pt, draws)
    assert float(stats_p["loss"]) == pytest.approx(float(stats["loss"]), rel=1e-5)
    assert int(stats_p["measured_samples"]) == int(stats["measured_samples"])
    got = train_state_to_numpy(pt.model, pt.state)
    np.testing.assert_allclose(got["error_map"], np.asarray(new_state.error_map), rtol=1e-5,
                               atol=1e-6 * float(np.abs(np.asarray(new_state.error_map)).max()))
    lr = float(jt.opt.learning_rate_at(0))
    for key_ in ("density_net", "rgb_net", "pos_enc"):
        for g_ref, p_ref, p_new, m_ref, m_new in zip(
                jax.tree.leaves(grads[key_]), jax.tree.leaves(new_state.params[key_]),
                got["params"][key_], jax.tree.leaves(new_state.opt_state["m"][key_]),
                got["opt_state"]["m"][key_]):
            g_ref = np.asarray(g_ref)
            big = np.abs(g_ref) > 1e-3 * np.abs(g_ref).max()
            np.testing.assert_allclose(np.asarray(p_new)[big], np.asarray(p_ref)[big], rtol=0,
                                       atol=1e-3 * lr)
            np.testing.assert_allclose(np.asarray(m_new)[big], np.asarray(m_ref)[big], rtol=0,
                                       atol=3e-3 * np.abs(np.asarray(m_ref)).max())
    assert got["opt_state"]["step"] == int(new_state.opt_state["step"]) == 1
