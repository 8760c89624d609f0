"""NeRF camera optimization on the port against the JAX package, on the CPU.

One whole training step with the extrinsics, exposure, focal length and
distortion map optimized and E = 4 per-image latents, from the same state
(parameters, grid, camera offsets set off zero) with the JAX step's draws
injected: the parameters' and every camera leaf's gradients, the new
parameters, every new camera leaf and the camera optimizer's state. Cases:
all on in nerf mode, the latents pinned (``optimize_extra_dims`` off: their
values stay, Adam's state advances), ``max_level_rand_training``, and the
rfl and rflrelax modes. Then the pieces: the distortion map's bilinear read
and its texture gradient against ``jax.vjp``, ``so3_exp``'s Jacobian at
w = 0 (where every rotation offset starts), and the camera optimizer's
steps against the JAX ``Optimizer`` with ``extrinsic_l2_reg`` on rot/pos."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from instant_ngp_tpu.image_fit.task import bilinear_read as jax_bilinear_read
from instant_ngp_tpu.nerf import occupancy as jax_occ
from instant_ngp_tpu.nerf.task import NerfTask as JaxNerfTask
from instant_ngp_tpu.ops.optimizers import Optimizer as JaxOptimizer
from instant_ngp_tpu.ops.optimizers import OptimizerSpec as JaxOptimizerSpec
from instant_ngp_tpu.render.camera import so3_exp as jax_so3_exp
from instant_ngp_torch.io.nerf_loader import NerfDataset
from instant_ngp_torch.models.nerf_network import train_state_from_jax, train_state_to_numpy
from instant_ngp_torch.nerf import train as port_train
from instant_ngp_torch.nerf.task import NerfTask
from instant_ngp_torch.ops.gather import bilinear_read_differentiable
from instant_ngp_torch.ops.optimizers import camera_optimizer, camera_optimizer_spec
from instant_ngp_torch.render.camera import so3_exp

torch.set_num_threads(2)

R, K, ITERS, E = 128, 16, 48, 4
TARGET = 1 << 11  # a capacity of 1,024 samples < R·K: the step compacts and drops
FLAGS = dict(optimize_extrinsics=True, optimize_exposure=True, optimize_focal_length=True,
             optimize_distortion=True)


def _grid(seed):
    rng = np.random.default_rng(seed)
    dens = np.where(rng.random((1, 128, 128, 128)) < 0.15, 0.05, 0.0).astype(np.float32)
    dens = jnp.asarray(dens)
    mean = jnp.mean(jnp.maximum(dens[0], 0.0))
    bits = jax_occ._bitfield_from_density(dens, mean)
    return jax_occ.OccupancyGridState(density=dens, bitfield=bits,
                                      skipmip=jax_occ._skip_chain(bits), mean_density=mean,
                                      ema_step=jnp.int32(1))


def _tasks(seed, loss="Huber"):
    """The JAX task and the port's on one state: the camera offsets set off
    zero (small rotations and shifts, exposures, a focal scale, a
    distortion map), exact corners."""
    ds = graft._synthetic_dataset()
    ds.n_extra_learnable_dims = E
    cfg = graft._tiny_nerf_config()
    cfg["loss"] = {"otype": loss}
    kw = dict(target_batch_size=TARGET, n_rays_per_batch=R, max_samples_per_ray=K,
              n_march_iters=ITERS)
    jt = JaxNerfTask(ds, cfg, **kw, **FLAGS)
    rng = np.random.default_rng(seed)
    n = ds.n_images
    cam = dict(jt.state.cam)
    cam.update(rot=rng.normal(scale=0.01, size=(n, 3)), pos=rng.normal(scale=0.005, size=(n, 3)),
               exposure=rng.normal(scale=0.3, size=(n, 3)), focal=rng.normal(scale=0.01, size=2),
               distortion=rng.normal(scale=0.002, size=(32, 32, 2)))
    cam = {k: jnp.asarray(v, jnp.float32) for k, v in cam.items()}
    jt.state = dataclasses.replace(jt.state, grid=_grid(seed), cam=cam,
                                   cam_opt=jt.cam_opt.init(cam))
    jt.model = dataclasses.replace(jt.model, pos_encoding=dataclasses.replace(
        jt.model.pos_encoding, hashed_grad_corners=8))
    pds = NerfDataset(images=ds.images, is_hdr=False, xforms_start=ds.xforms_start,
                      xforms_end=ds.xforms_end, focal_lengths=ds.focal_lengths,
                      principal_points=ds.principal_points, rolling_shutter=ds.rolling_shutter,
                      resolution=ds.resolution, aabb_scale=ds.aabb_scale,
                      n_extra_learnable_dims=E)
    pt = NerfTask(pds, cfg, "cpu", **kw, **FLAGS)
    pt.model.pos_encoding.hashed_grad_corners = 8
    train_state_from_jax(pt.model, pt.state, jt.state)
    assert sorted(pt.cam_offsets) == sorted(cam)
    return jt, pt


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _jax_step(jt, state, key):
    """The jitted JAX step, also returning the gradients it hands to both
    optimizers."""
    seen = {}
    updates = jt.opt.update, jt.cam_opt.update

    def spy(name, update):
        def f(grads, st, params, **kw):
            seen[name] = grads
            return update(grads, st, params, **kw)
        return f

    jt.opt.update, jt.cam_opt.update = spy("params", updates[0]), spy("cam", updates[1])

    def step(state, key):
        new_state, stats = jt._train_step(state, jt.data, key, 0, n_rays=R,
                                          mode=jt.train_mode)
        return new_state, stats, seen["params"], seen["cam"]

    try:
        return jax.jit(step)(state, key)
    finally:
        jt.opt.update, jt.cam_opt.update = updates


CASES = {"all_on": {}, "latents_pinned": {"optimize_extra_dims": False},
         "max_level_rand": {"max_level_rand_training": True},
         "rfl": {"train_mode": "rfl"}, "rflrelax": {"train_mode": "rflrelax"}}


@pytest.mark.parametrize("case", list(CASES))
def test_camera_step_equals_jax(case):
    """The MLPs' gradients within 2e-2 of the leaf's largest |ref| (every
    MLP cotangent is rounded to bf16, 2^-8, after f32 sums in another
    order). Each camera leaf's gradient within 5e-2 of its norm: it sums
    its view's rays' position and direction gradients (through both MLPs'
    dX and the grid's d/dx), which cancel to a few per cent of their size in
    the 6-element rot and pos leaves, so one bf16 step of one ray's
    cotangent moves a small element by more than 2e-2 of the largest (seen
    at 4.7e-2 in the pos leaf of one case, 2.7e-2 of its norm; the other
    leaves and cases 3e-3 or less). New parameters where |g| > 1e-3 of the
    leaf's largest (Adam's first step moves each by ±lr there) within 1e-3
    of lr. Every new camera value within what its gradient's distance from
    JAX's allows Adam's first step (the camera gradients are ~1e-6, near
    Adam's ε), and its first moment likewise; the camera optimizer's step;
    the error map rtol 1e-5. The latents' pin and the exposure's and focal length's decays
    are the JAX step's."""
    jt, pt = _tasks(11 + list(CASES).index(case))
    jt.exposure_l2_reg = pt.exposure_l2_reg = 0.5
    for k, v in CASES[case].items():
        setattr(jt, k, v)
        setattr(pt, k, v)
    key = jax.random.PRNGKey(21)
    k_pix, k_bg, k_jit, k_lvl = jax.random.split(key, 4)
    img, uv, pdf = jt._sample_pixels(jt.data, k_pix, R, False)
    max_level = (_t(2.0 * jax.random.uniform(k_lvl, (R,)))
                 if pt.max_level_rand_training else None)
    draws = port_train.StepDraws(_t(img, torch.int64), _t(uv), _t(pdf),
                                 _t(jax.random.uniform(k_jit, (R,))),
                                 _t(jax.random.uniform(k_bg, (R, 3))), max_level)
    state0 = jt.state
    new_state, stats, grads, cam_grads = _jax_step(jt, state0, key)

    p_grads, per_ray, batch = port_train.step_gradients(pt, draws)
    assert int(batch.n_valid.sum()) > TARGET // 2  # the capacity drop is exercised
    n_p = len(pt.model.param_list())
    assert len(p_grads) == n_p + len(pt.cam_offsets)
    ours = dict(zip(pt.camera_keys(), p_grads[n_p:]))
    for k, b in cam_grads.items():
        b = np.asarray(b)
        if not np.any(b):
            assert not torch.any(ours[k]), k
            continue
        rel = np.linalg.norm(ours[k].numpy() - b) / np.linalg.norm(b)
        assert rel <= 5e-2, (k, rel)
    assert set(k for k, v in cam_grads.items() if np.any(np.asarray(v))) >= (
        {"rot", "pos", "exposure", "focal", "distortion", "extra"})
    for a, b in zip(p_grads[:4], [*grads["density_net"], *grads["rgb_net"]]):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=2e-2 * np.abs(b).max())
    assert float(per_ray.mean()) == pytest.approx(float(stats["loss"]), rel=1e-5)

    stats_p = port_train.train_step(pt, draws)
    assert float(stats_p["loss"]) == pytest.approx(float(stats["loss"]), rel=1e-5)
    got = train_state_to_numpy(pt.model, pt.state)
    np.testing.assert_allclose(got["error_map"], np.asarray(new_state.error_map), rtol=1e-5,
                               atol=1e-6 * float(np.abs(np.asarray(new_state.error_map)).max()))
    lr = float(jt.opt.learning_rate_at(0))
    for key_ in ("density_net", "rgb_net"):
        for g_ref, p_ref, p_new in zip(grads[key_], new_state.params[key_],
                                       got["params"][key_]):
            big = np.abs(np.asarray(g_ref)) > 1e-3 * np.abs(np.asarray(g_ref)).max()
            np.testing.assert_allclose(p_new[big], np.asarray(p_ref)[big], rtol=0,
                                       atol=1e-3 * lr)
    cam_lr = float(jt.cam_opt.learning_rate_at(0))
    eps = jt.cam_opt.spec.epsilon
    assert got["cam_opt"]["step"] == int(new_state.cam_opt["step"]) == 1
    for k in cam_grads:
        g_ref, g_ours = np.asarray(cam_grads[k]), ours[k].numpy()
        dg = np.abs(g_ours - g_ref)
        # Adam's first step moves a value by lr·g/(|g| + ε), and |a/(|a|+ε) −
        # b/(|b|+ε)| <= 2|a − b|/(|b| + ε): the step's distance that the
        # gradients' distance allows, plus rounding
        bound = cam_lr * (1e-3 + 2.0 * dg / (np.abs(g_ref) + eps))
        diff = np.abs(got["cam"][k] - np.asarray(new_state.cam[k]))
        assert np.all(diff <= bound), (k, float((diff - bound).max()))
        m_ref = np.asarray(new_state.cam_opt["m"][k])  # 0.1·g after one step
        assert np.all(np.abs(got["cam_opt"]["m"][k] - m_ref)
                      <= 0.1 * dg + 1e-6 * np.abs(m_ref).max()), k
    if case == "latents_pinned":
        np.testing.assert_array_equal(got["cam"]["extra"], np.asarray(state0.cam["extra"]))
        assert np.any(got["cam_opt"]["m"]["extra"])  # Adam's state advanced


def test_distortion_read_and_its_texture_gradient_equal_jax():
    """The bilinear read of an (h, w, 2) map at random uv, as the step reads
    the distortion map (the map as an (h·w, 4) texture, kernel I's entry
    and H's deposit on the card), against the JAX read (bit for bit) and
    ``jax.vjp``'s texture cotangent (the deposit's sums in another order:
    within 1e-6 of its largest |ref|), at uv on the clamps too."""
    from instant_ngp_torch.nerf.task import distortion_read

    rng = np.random.default_rng(8)
    dist = rng.normal(size=(32, 24, 2)).astype(np.float32)
    uv = rng.random((500, 2), dtype=np.float32)
    uv[:10] = [[0, 0], [1, 1], [0, 1], [1, 0], [0.5, 0], [0, 0.5], [1, 0.5], [0.5, 1],
               [0.99999, 0.00001], [0.5, 0.5]]
    g = rng.normal(size=(500, 2)).astype(np.float32)
    _, vjp = jax.vjp(lambda tex: jax_bilinear_read(tex, jnp.asarray(uv)), jnp.asarray(dist))
    (ref_dtex,) = vjp(jnp.asarray(g))
    d_t = _t(dist).requires_grad_(True)
    out = distortion_read(d_t, _t(uv), use_kernel=True)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jax.jit(jax_bilinear_read)(
        jnp.asarray(dist), jnp.asarray(uv))))
    (dtex,) = torch.autograd.grad(out, d_t, _t(g))
    ref_dtex = np.asarray(ref_dtex)
    np.testing.assert_allclose(dtex.numpy(), ref_dtex, rtol=0, atol=1e-6 * np.abs(ref_dtex).max())
    # the (W·H, 4) entry: the gradient of the unused channels is the deposit's too
    tex = _t(rng.normal(size=(24 * 32, 4)).astype(np.float32)).requires_grad_(True)
    out4 = bilinear_read_differentiable(tex, (24, 32), _t(uv))
    (g4,) = torch.autograd.grad(out4, tex, torch.ones_like(out4))
    np.testing.assert_allclose(g4.sum(0).numpy(), np.full(4, 500.0, np.float32), rtol=1e-5)


def test_so3_exp_jacobian_at_zero_equals_jax():
    """d so3_exp / d w at w = 0 (the Taylor branch): the skew generators,
    as JAX's jacobian gives them; and a small w's rotation and Jacobian."""
    for w in (np.zeros(3, np.float32), np.array([1e-5, -2e-5, 3e-5], np.float32),
              np.array([0.1, -0.2, 0.05], np.float32)):
        ref = np.asarray(jax.jacobian(jax_so3_exp)(jnp.asarray(w)))
        jac = torch.autograd.functional.jacobian(so3_exp, _t(w)).numpy()
        np.testing.assert_allclose(jac, ref, rtol=0, atol=1e-6)
        np.testing.assert_allclose(so3_exp(_t(w)).numpy(), np.asarray(jax_so3_exp(jnp.asarray(w))),
                                   rtol=0, atol=1e-7)
    jac0 = torch.autograd.functional.jacobian(so3_exp, torch.zeros(3)).numpy()
    for a in range(3):  # d R / d w_a = skew(e_a): antisymmetric, ±1 off the diagonal
        np.testing.assert_array_equal(jac0[:, :, a], -jac0[:, :, a].T)
        assert np.abs(jac0[:, :, a]).sum() == 2.0


def test_camera_optimizer_steps_equal_jax():
    """Five steps of the camera optimizer over a camera tree (rot, pos,
    exposure, focal, extra, distortion) with extrinsic_l2_reg 1e-3 on rot and
    pos only, against the JAX package's cam_opt (task.py:287-293): state and
    values within an f32 ulp's worth."""
    rng = np.random.default_rng(3)
    shapes = {"distortion": (32, 32, 2), "exposure": (3, 3), "extra": (3, 4), "focal": (2,),
              "pos": (3, 3), "rot": (3, 3)}
    cam = {k: rng.normal(scale=0.1, size=s).astype(np.float32) for k, s in shapes.items()}
    spec = dataclasses.replace(camera_optimizer_spec(), l2_reg=1e-3)
    jspec = JaxOptimizerSpec(learning_rate=1e-4, beta1=0.9, beta2=0.99, epsilon=1e-8,
                             l2_reg=1e-3, decay_start=0, decay_interval=2048, decay_base=0.33)
    jopt = JaxOptimizer(jspec, matrix_mask={k: k in ("rot", "pos") for k in cam})
    jcam = {k: jnp.asarray(v) for k, v in cam.items()}
    jstate = jopt.init(jcam)
    keys = sorted(cam)
    opt = camera_optimizer(spec, keys)
    params = [_t(cam[k]) for k in keys]
    state = opt.init(params)
    for step in range(5):
        grads = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
        jcam, jstate = jopt.update({k: jnp.asarray(v) for k, v in grads.items()}, jstate, jcam)
        opt.update([_t(grads[k]) for k in keys], state, params)
    assert state["step"] == int(jstate["step"]) == 5
    for i, k in enumerate(keys):
        np.testing.assert_allclose(params[i].numpy(), np.asarray(jcam[k]), rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(state["m"][i].numpy(), np.asarray(jstate["m"][k]), rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(state["v"][i].numpy(), np.asarray(jstate["v"][k]), rtol=1e-5,
                                   atol=1e-9)
