"""The port's lens stack against the JAX package's, on the CPU: every lens's
``uv_to_ray_cam`` and the SO(3) helpers, one training step on a generated
scene seen through a fisheye and through an F-theta lens (the JAX draws
injected), and a 16² render of the tiny snapshot through each lens."""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from instant_ngp_tpu.common import Lens as JaxLens
from instant_ngp_tpu.common import LensMode as JaxLensMode
from instant_ngp_tpu.io.nerf_loader import load_nerf as jax_load_nerf
from instant_ngp_tpu.nerf.sampler import march_rays as jax_march
from instant_ngp_tpu.nerf.task import NerfTask as JaxNerfTask
from instant_ngp_tpu.render import camera as jax_cam
from instant_ngp_tpu.testbed import Testbed as JaxTestbed
from instant_ngp_torch import testbed as port_testbed
from instant_ngp_torch.common import Lens, LensMode
from instant_ngp_torch.io.nerf_loader import load_nerf
from instant_ngp_torch.io.synthetic import generate_synthetic_dataset
from instant_ngp_torch.models.nerf_network import train_state_from_jax
from instant_ngp_torch.nerf import train as port_train
from instant_ngp_torch.nerf.task import NerfTask
from instant_ngp_torch.render import camera as port_cam
from test_torch_train_step import ITERS, K, R, TARGET, _grid, _jax_step_with_grads, _t

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
TINY = ROOT / "tests" / "fixtures" / "tiny_nerf.ingp"
# each lens with parameters that keep every pixel of a 16² frame valid
LENSES = {
    "perspective": [],
    "opencv": [0.05, -0.01, 0.002, -0.001],
    "opencv_fisheye": [0.03, -0.004, 0.001, 0.0],
    "ftheta": [0.0, 0.04, 1e-4, 0.0, 0.0, 16.0, 16.0],
    "latlong": [],
    "equirectangular": [],
    "orthographic": [],
}
# the transforms.json keys of the lens a training scene is written with
SCENE_LENSES = {
    "opencv_fisheye": {"is_fisheye": True, "k1": 0.03, "k2": -0.004},
    "ftheta": {"ftheta_p0": 0.0, "ftheta_p1": 0.04, "ftheta_p2": 1e-4, "ftheta_p3": 0.0,
               "ftheta_p4": 0.0, "w": 16, "h": 16},
}
# PSNR of each lens's 16² render of the tiny snapshot against JAX's
MIN_PSNR_DB = 45.0
# Rays a package loses at the crop-box face (ROADMAP Queue 3, open): a ray
# starts exactly on the face, and where its first position rounds outside
# the box it renders transparent. The lat-long and equirectangular
# directions differ from XLA's by an ulp (torch's sin/cos), which moves the
# start by an ulp: 4 of the 256 rays of this frame render transparent in
# the port and not in JAX (measured on the CPU). At most this many may.
MAX_FACE_LOST = 8


@pytest.mark.parametrize("lens", list(LENSES))
def test_uv_to_ray_cam_equals_jax(lens):
    """Directions and origin offsets of every lens on random and
    pixel-centre uv with per-ray intrinsics: within 2e-6 (f32 trigonometry
    and the fixed-point undistortion iterate in another library)."""
    rng = np.random.default_rng(3)
    n = 512
    uv = np.concatenate([rng.random((n, 2), dtype=np.float32),
                         ((np.mgrid[0:16, 0:16].reshape(2, -1).T + 0.5) / 16).astype(np.float32)])
    fl = (rng.uniform(10, 30, (len(uv), 2))).astype(np.float32)
    pp = (0.5 + rng.uniform(-0.05, 0.05, (len(uv), 2))).astype(np.float32)
    params = np.asarray(LENSES[lens] or [0.0] * 4, np.float32)
    ref = jax.jit(lambda u, f, p, lp: jax_cam.uv_to_ray_cam(
        u, (16.0, 16.0), f, p, lens_mode=JaxLensMode(lens), lens_params=lp))(uv, fl, pp, params)
    got = port_cam.uv_to_ray_cam(torch.from_numpy(uv), (16.0, 16.0), torch.from_numpy(fl),
                                 torch.from_numpy(pp), lens_mode=LensMode(lens),
                                 lens_params=torch.from_numpy(params))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=2e-6)
    if lens == "orthographic":
        assert np.abs(got[1].numpy()).max() > 0  # the pixel offset rides on the origin


def test_so3_and_camera_slerp_equal_jax():
    """so3_exp at θ = 0, below the Taylor switch and large; so3_log back;
    the slerp of two cameras at t in [0, 1]: within 2e-6."""
    rng = np.random.default_rng(5)
    w = np.concatenate([np.zeros((1, 3)), rng.normal(size=(4, 3)) * 1e-5,
                        rng.normal(size=(27, 3))]).astype(np.float32)
    for ours, theirs, arg in ((port_cam.so3_exp, jax_cam.so3_exp, w),):
        np.testing.assert_allclose(ours(torch.from_numpy(arg)).numpy(),
                                   np.asarray(theirs(jnp.asarray(arg))), rtol=0, atol=2e-6)
    R = np.asarray(jax_cam.so3_exp(jnp.asarray(w)))
    np.testing.assert_allclose(port_cam.so3_log(torch.from_numpy(R.copy())).numpy(),
                               np.asarray(jax_cam.so3_log(jnp.asarray(R))), rtol=0, atol=2e-6)
    xs = np.concatenate([R[:8], rng.normal(size=(8, 3, 1)).astype(np.float32)], -1)
    xe = np.concatenate([R[8:16], rng.normal(size=(8, 3, 1)).astype(np.float32)], -1)
    t = rng.random(8).astype(np.float32)
    np.testing.assert_allclose(
        port_cam.camera_slerp(torch.from_numpy(xs), torch.from_numpy(xe), torch.from_numpy(t)).numpy(),
        np.asarray(jax_cam.camera_slerp(jnp.asarray(xs), jnp.asarray(xe), jnp.asarray(t))),
        rtol=0, atol=2e-6)


@pytest.fixture(scope="module")
def lens_scenes(tmp_path_factory):
    """A generated 16² scene, written once more per lens with the lens's
    keys in its transforms.json (the images stay the perspective ones)."""
    base, _ = generate_synthetic_dataset(tmp_path_factory.mktemp("lens") / "base", res=16,
                                         n_train=2, n_test=1, n_steps=32)
    scenes = {}
    for lens, keys in SCENE_LENSES.items():
        meta = json.loads((base / "transforms.json").read_text())
        meta.update(keys)
        for fr in meta["frames"]:
            fr["file_path"] = str(base / fr["file_path"])
        d = tmp_path_factory.mktemp(lens)
        (d / "transforms.json").write_text(json.dumps(meta))
        scenes[lens] = d
    return scenes


@pytest.mark.parametrize("lens", list(SCENE_LENSES))
def test_train_step_through_a_lens_equals_jax(lens_scenes, lens):
    """One whole step from one state with the JAX draws, as
    tests/test_torch_nerf_loader.py holds a disk scene's: the march's sample
    counts on ≥ 99 % of rays, gradients within 1e-2 (MLPs, hashed levels)
    and 3e-2 (dense levels) of the leaf's largest, the loss rtol 1e-5."""
    scene = lens_scenes[lens]
    cfg = graft._tiny_nerf_config()
    kw = dict(target_batch_size=TARGET, n_rays_per_batch=R, max_samples_per_ray=K,
              n_march_iters=ITERS)
    jt = JaxNerfTask(jax_load_nerf(scene), cfg, **kw)
    assert jt.dataset.lens_mode == lens
    jt.state = dataclasses.replace(jt.state, grid=_grid(5))
    jt.model = dataclasses.replace(jt.model, pos_encoding=dataclasses.replace(
        jt.model.pos_encoding, hashed_grad_corners=8))
    pt = NerfTask(load_nerf(scene), cfg, "cpu", **kw)
    assert pt.dataset.lens_mode == lens
    pt.model.pos_encoding.hashed_grad_corners = 8
    train_state_from_jax(pt.model, pt.state, jt.state)

    data = dict(jt.data)
    key = jax.random.PRNGKey(13)
    k_pix, k_bg, k_jit, _ = jax.random.split(key, 4)
    img, uv, pdf = jt._sample_pixels(data, k_pix, R, False)
    draws = port_train.StepDraws(_t(img, torch.int64), _t(uv), _t(pdf),
                                 _t(jax.random.uniform(k_jit, (R,))),
                                 _t(jax.random.uniform(k_bg, (R, 3))))
    _, stats, grads = _jax_step_with_grads(jt, jt.state, data, key, False)
    o, d = jax.jit(lambda dd, i, u: jt._generate_rays(dd, i, u, None))(
        data, img, (jnp.floor(uv * jnp.array([16.0, 16.0])) + 0.5) / 16.0)
    ref_march = jax.jit(lambda o, d, s, j: jax_march(o, d, s, jnp.asarray(jt.aabb_min),
                                                     jnp.asarray(jt.aabb_max), j, jt.march_cfg))(
        o, d, jt.state.grid.skipmip, jax.random.uniform(k_jit, (R,)))
    p_grads, per_ray, batch = port_train.step_gradients(pt, draws)
    assert np.mean(batch.n_valid.numpy() == np.asarray(ref_march[4])) >= 0.99
    assert int(batch.n_valid.sum()) > 0
    for key_, ours in (("density_net", p_grads[:2]), ("rgb_net", p_grads[2:4])):
        for a, b in zip(ours, grads[key_]):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-2 * np.abs(b).max())
    table = p_grads[4].numpy()
    for lv, b in zip(pt.model.pos_encoding.levels, grads["pos_enc"]):
        b = np.asarray(b)
        tol = (1e-2 if lv.hashed else 3e-2) * np.abs(b).max()
        np.testing.assert_allclose(table[lv.offset:lv.offset + lv.size], b, rtol=0, atol=tol)
    assert float(per_ray.mean()) == pytest.approx(float(stats["loss"]), rel=1e-5)


@pytest.fixture(scope="module")
def tiny_testbeds():
    ours = port_testbed.Testbed("nerf", device="cpu")
    ours.load_snapshot(TINY)
    theirs = JaxTestbed("nerf")
    theirs.load_snapshot(str(TINY))
    return ours, theirs


def _psnr(a, b):
    mse = float(np.mean((np.clip(a[..., :3], 0, 1) - np.clip(b[..., :3], 0, 1)) ** 2))
    return -10.0 * np.log10(max(mse, 1e-12))


@pytest.mark.parametrize("lens", [k for k in LENSES if k != "perspective"])
def test_render_through_each_lens_matches_jax(tiny_testbeds, lens):
    """The snapshot's view 0 at 16² through the lens, in both packages:
    ≥ 45 dB over the rays neither package loses at the crop-box face, at
    most ``MAX_FACE_LOST`` lost by one package alone, and not the
    perspective frame."""
    ours, theirs = tiny_testbeds
    ds = ours.nerf_dataset
    w, h = ds.resolution
    xf = np.asarray(ds.xforms_start[0], np.float32)
    kw = dict(focal_length=(ds.focal_lengths[0, 0] * 16 / w, ds.focal_lengths[0, 1] * 16 / h),
              principal_point=tuple(ds.principal_points[0]), background=(0, 0, 0, 0))
    plain = ours.task.render(16, 16, xf, **kw).numpy()
    params = np.asarray(LENSES[lens], np.float32)
    saved = (ds.lens_mode, ds.lens_params)
    try:
        ours.render_lens = Lens(lens, params)
        theirs.render_lens = JaxLens(lens, params)
        frame = ours.task.render(16, 16, xf, **kw).numpy()
        ref = np.asarray(theirs.task.render(16, 16, xf, **kw))
    finally:
        ours.render_lens = Lens(*saved)
        theirs.render_lens = JaxLens(*saved)
    lost = (frame[..., 3] == 0) != (ref[..., 3] == 0)
    assert lost.sum() <= MAX_FACE_LOST
    assert _psnr(frame[~lost], ref[~lost]) >= MIN_PSNR_DB
    assert not np.array_equal(frame, plain)
