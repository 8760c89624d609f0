"""The rest of NeRF's training half on the port against the JAX package, on
the CPU: one whole training step, from the same state with the JAX step's
draws injected (the motion-blur time among them), for each feature of a
capture: here depth supervision (L1 and Huber depth losses), a trained
environment map and the sharpness-weighted error map;
``test_torch_train_capture.py`` runs images of differing sizes, supplied
rays and a moving camera (start and end transforms, rolling shutter)
through ``check_feature_step``. Compared: the per-ray loss, the
parameters' gradients, the camera leaves' (the environment map's), the
error map and the sharp grid."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from instant_ngp_tpu.nerf.task import NerfTask as JaxNerfTask
from instant_ngp_torch.io.nerf_loader import NerfDataset
from instant_ngp_torch.models.nerf_network import train_state_from_jax, train_state_to_numpy
from instant_ngp_torch.nerf import train as port_train
from instant_ngp_torch.nerf.task import NerfTask

from test_torch_camopt import _grid, _t

torch.set_num_threads(2)

R, K, ITERS = 128, 16, 48
TARGET = 1 << 11  # a capacity of 1,024 samples < R·K: the step compacts and drops
N_IMG, W, H = 3, 16, 16
SMALL = (12, 10)  # image 1's (w, h) in the mixed-size scene
# the sharpness scene's eyes: the rays of its faint start hit near them
SHARP_EYES = np.array([[0.3, 0.5, 0.2], [0.5, 0.5, 0.2], [0.7, 0.5, 0.2]], np.float32)


def _rotation(axis, deg):
    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    a = np.radians(deg)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(a) * k + (1 - np.cos(a)) * k @ k


def _jax_dataset(feature: str):
    """The synthetic scene with one feature of a capture added."""
    ds = graft._synthetic_dataset(N_IMG, W, H)
    rng = np.random.default_rng(5)
    if feature.startswith("depth"):
        depths = rng.uniform(0.8, 1.6, (N_IMG, H, W)).astype(np.float32)
        depths[rng.random(depths.shape) < 0.2] = 0.0  # pixels without a depth
        ds.depths = depths
    elif feature == "mixed_sizes":
        sw, sh = SMALL
        ds.images[1, sh:] = 0
        ds.images[1, :, sw:] = 0
        ds.per_image_resolution = np.array([[W, H], [sw, sh], [W, H]], np.int32)
        ds.focal_lengths[1] = (15.0, 13.0)
    elif feature == "rays":
        o = np.array([0.5, 0.5, -0.7], np.float32) + rng.normal(0, 0.01, (N_IMG, H, W, 3))
        d = np.array([0.0, 0.0, 1.0], np.float32) + rng.normal(0, 0.3, (N_IMG, H, W, 3))
        ds.rays = np.concatenate([o, d], -1).astype(np.float32)
    elif feature == "sharpness":  # cameras inside the aabb: the rays' hits are too
        ds.xforms_start[:, :, 3] = SHARP_EYES
        ds.xforms_end[:, :, 3] = SHARP_EYES
    elif feature == "motion":
        for i in range(N_IMG):
            ds.xforms_end[i, :, :3] = _rotation(rng.normal(size=3), 3.0) @ ds.xforms_start[i, :, :3]
            ds.xforms_end[i, :, 3] += rng.normal(0, 0.02, 3)
        ds.rolling_shutter[0] = (0, 0, 1, 0)
        ds.rolling_shutter[1] = (0, 0, 0, 1)
        ds.rolling_shutter[2] = (0.2, 0.3, 0.1, 0.4)
    return ds


FEATURES = {"depth_l1": {}, "depth_huber": {"depth_loss_type": "Huber"},
            "envmap": {}, "sharpness": {}, "mixed_sizes": {}, "rays": {}, "motion": {}}


def _tasks(feature: str):
    ds = _jax_dataset(feature)
    cfg = graft._tiny_nerf_config()
    kw = dict(target_batch_size=TARGET, n_rays_per_batch=R, max_samples_per_ray=K,
              n_march_iters=ITERS, train_envmap=feature == "envmap",
              include_sharpness_in_error=feature == "sharpness")
    jt = JaxNerfTask(ds, cfg, **kw)
    state = dataclasses.replace(jt.state, grid=_grid(7))
    rng = np.random.default_rng(9)
    if feature == "envmap":  # a map off zeros: the read and its alpha matter
        cam = dict(state.cam, envmap=jax.numpy.asarray(
            rng.uniform(0, 0.5, (128, 256, 4)).astype(np.float32)))
        state = dataclasses.replace(state, cam=cam, cam_opt=jt.cam_opt.init(cam))
    if feature == "sharpness":  # cells holding blurrier views, and none, and a sharper one
        smax = float(np.asarray(jt.data["sharpness"]).max())
        sg = rng.uniform(0, smax, state.sharp_grid.shape).astype(np.float32)
        for i, eye in enumerate((SHARP_EYES * 128).astype(int)):
            sg[0, eye[0], eye[1], eye[2]] = 2.0 * smax if i == 0 else 0.0
        state = dataclasses.replace(state, sharp_grid=jax.numpy.asarray(sg))
    jt.state = state
    jt.model = dataclasses.replace(jt.model, pos_encoding=dataclasses.replace(
        jt.model.pos_encoding, hashed_grad_corners=8))
    for k, v in FEATURES[feature].items():
        setattr(jt, k, v)
    pds = NerfDataset(**{f.name: getattr(ds, f.name) for f in dataclasses.fields(NerfDataset)})
    pt = NerfTask(pds, cfg, "cpu", **kw)
    pt.model.pos_encoding.hashed_grad_corners = 8
    for k, v in FEATURES[feature].items():
        setattr(pt, k, v)
    train_state_from_jax(pt.model, pt.state, jt.state)
    if feature == "sharpness":
        pt.state.sharp_grid = _t(jt.state.sharp_grid)
    assert pt.has_motion == jt.has_motion and pt.training_near_distance == jt.training_near_distance
    assert pt.depth_supervision_lambda == jt.depth_supervision_lambda
    return jt, pt


def _jax_step(jt, state, key):
    """The jitted JAX step, also returning the gradients it hands to the
    model's optimizer and to the camera's (None where it takes no camera
    step)."""
    seen = {}
    updates = jt.opt.update, jt.cam_opt.update

    def spy(name, update):
        def f(grads, st, params, **kw):
            seen[name] = grads
            return update(grads, st, params, **kw)
        return f

    jt.opt.update, jt.cam_opt.update = spy("params", updates[0]), spy("cam", updates[1])

    def step(state, key):
        new_state, stats = jt._train_step(state, jt.data, key, 0, n_rays=R, mode=jt.train_mode)
        return new_state, stats, seen["params"], seen.get("cam")

    try:
        return jax.jit(step)(state, key)
    finally:
        jt.opt.update, jt.cam_opt.update = updates


def _draws(jt, key):
    """The JAX step's draws (task.py:865-875), the motion-blur time last."""
    k_pix, k_bg, k_jit, _ = jax.random.split(key, 4)
    img, uv, pdf = jt._sample_pixels(jt.data, k_pix, R, False)
    motion_time = None
    if jt.has_motion:
        motion_time = _t(jax.random.uniform(jax.random.split(key)[1], (R,)))
    return port_train.StepDraws(_t(img, torch.int64), _t(uv), _t(pdf),
                                _t(jax.random.uniform(k_jit, (R,))),
                                _t(jax.random.uniform(k_bg, (R, 3))), None, motion_time)


@pytest.mark.parametrize("feature", ["depth_l1", "depth_huber", "envmap", "sharpness"])
def test_feature_step_equals_jax(feature):
    check_feature_step(feature)


def check_feature_step(feature):
    """The per-ray loss within 1e-5 (relative, its mean); each parameter
    leaf's gradient within 2e-2 of the leaf's largest |ref| (MLP cotangents
    rounded to bf16 after f32 sums in another order, as in
    test_torch_camopt.py); the environment map's gradient within 5e-2 of its
    norm (it sums every ray's background through bilinear weights, as the
    camera leaves there); the error map rtol 1e-5 (atol 1e-6 of its largest);
    the sharp grid bit for bit."""
    jt, pt = _tasks(feature)
    key = jax.random.PRNGKey(31)
    draws = _draws(jt, key)
    state0 = jt.state
    new_state, stats, grads, cam_grads = _jax_step(jt, state0, key)

    p_grads, per_ray, batch = port_train.step_gradients(pt, draws)
    assert int(batch.n_valid.sum()) > 0
    n_p = len(pt.model.param_list())
    ref = [*grads["density_net"], *grads["rgb_net"],
           np.concatenate([np.asarray(t) for t in grads["pos_enc"]])]
    for a, b in zip(p_grads[:n_p], ref):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=2e-2 * np.abs(b).max())
    assert float(per_ray.mean()) == pytest.approx(float(stats["loss"]), rel=1e-5)
    if feature == "envmap":
        ours = dict(zip(pt.camera_keys(), p_grads[n_p:]))["envmap"].numpy()
        b = np.asarray(cam_grads["envmap"])
        assert np.any(b)
        assert np.linalg.norm(ours - b) / np.linalg.norm(b) <= 5e-2

    if feature.startswith("depth"):
        # the depth term moves the density gradient: the step without it differs
        pt.depth_supervision_lambda = 0.0
        g0 = port_train.step_gradients(pt, draws, batch)[0]
        pt.depth_supervision_lambda = 1.0
        assert not torch.allclose(g0[0], p_grads[0], rtol=0,
                                  atol=1e-3 * float(p_grads[0].abs().max()))

    port_train.train_step(pt, draws)
    got = train_state_to_numpy(pt.model, pt.state)
    emap = np.asarray(new_state.error_map)
    np.testing.assert_allclose(got["error_map"], emap, rtol=1e-5, atol=1e-6 * np.abs(emap).max())
    if feature == "sharpness":
        ref_sg, sg = np.asarray(new_state.sharp_grid), pt.state.sharp_grid.numpy()
        assert not np.array_equal(ref_sg, np.asarray(state0.sharp_grid))  # the scatter-max ran
        np.testing.assert_array_equal(sg, ref_sg)
