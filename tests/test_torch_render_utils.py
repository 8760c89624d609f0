"""The port's render utilities (``instant_ngp_torch/render/{buffer,camera_path,
camera_predictor,overlays,foveation}.py``) against the JAX package's, on the
CPU: camera paths saved by one package and loaded by the other, the path's
matrices, every predictor mode, the tonemap curves, the render buffer and
the dynamic-resolution controller, overlay pixels, foveation warps and a
foveated render. Host-side numpy code is held to 1e-6 (most of it bit for
bit); torch against jnp elementwise curves to 1e-6 relative; the foveated
render to tests/test_torch_render.py's 45 dB."""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instant_ngp_tpu.common import ColorSpace as JaxColorSpace
from instant_ngp_tpu.common import TonemapCurve as JaxTonemapCurve
from instant_ngp_tpu.render import buffer as jax_buffer
from instant_ngp_tpu.render import camera_path as jax_path
from instant_ngp_tpu.render import camera_predictor as jax_predictor
from instant_ngp_tpu.render import foveation as jax_foveation
from instant_ngp_tpu.render import overlays as jax_overlays
from instant_ngp_tpu.testbed import Testbed as JaxTestbed
from instant_ngp_torch import testbed as port_testbed
from instant_ngp_torch.common import ColorSpace, TonemapCurve
from instant_ngp_torch.render import buffer, camera_path, camera_predictor, foveation, overlays

torch.set_num_threads(2)

TINY = Path(__file__).resolve().parent / "fixtures" / "tiny_nerf.ingp"


def _cameras(n: int, seed: int) -> list[np.ndarray]:
    """n seeded 3x4 camera-to-world matrices (rotations from random axis-angles)."""
    rng = np.random.default_rng(seed)
    mats = []
    for _ in range(n):
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        ang = rng.uniform(0.1, 2.5)
        K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
        R = np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * K @ K
        mats.append(np.concatenate([R, rng.normal(size=(3, 1))], 1).astype(np.float32))
    return mats


def _path(module, seed: int, loop: bool, order: int):
    cp = module.CameraPath(loop=loop, spline_order=order)
    for i, m in enumerate(_cameras(5, seed)):
        cp.add_camera(m, fov=40.0 + 3 * i, aperture_size=0.01 * i, timestamp=0.1 + 0.2 * i)
    return cp


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_camera_path_saved_by_one_package_loads_in_the_other(tmp_path, saver):
    src, dst = (jax_path, camera_path) if saver == "jax" else (camera_path, jax_path)
    cp = _path(src, 3, loop=True, order=3)
    cp.keyframes[2].slice_z = 0.25
    cp.save(tmp_path / "path.json")
    loaded = dst.CameraPath.load(tmp_path / "path.json")
    assert loaded.loop and len(loaded.keyframes) == len(cp.keyframes)
    for a, b in zip(cp.keyframes, loaded.keyframes):
        np.testing.assert_array_equal(np.float32(a.R), b.R)
        np.testing.assert_array_equal(np.float32(a.T), b.T)
        assert (a.fov, a.aperture_size, a.slice_z, a.timestamp) == (
            b.fov, b.aperture_size, b.slice_z, b.timestamp)
    # the file each package writes for one path is the same text
    other = (camera_path if saver == "jax" else jax_path).CameraPath.load(tmp_path / "path.json")
    other.save(tmp_path / "again.json")
    assert (tmp_path / "again.json").read_text() == (tmp_path / "path.json").read_text()


@pytest.mark.parametrize("order", [3, 1])
@pytest.mark.parametrize("loop", [False, True])
def test_camera_path_eval_equals_jax(loop, order):
    ours, theirs = _path(camera_path, 7, loop, order), _path(jax_path, 7, loop, order)
    for t in np.linspace(0.0, 1.0, 23):
        a, b = ours.eval(float(t)), theirs.eval(float(t))
        np.testing.assert_array_equal(a.to_matrix(), b.to_matrix())
        assert a.fov == b.fov and a.aperture_size == b.aperture_size
        a, b = ours.eval_camera_path(float(t)), theirs.eval_camera_path(float(t))
        np.testing.assert_array_equal(a.to_matrix(), b.to_matrix())
        assert tuple(ours.get_pos(float(t))) == tuple(theirs.get_pos(float(t)))
    assert ours.get_playtime(2) == theirs.get_playtime(2)


def test_camera_path_keyframe_surface_equals_jax():
    m = _cameras(1, 11)[0]
    a, b = camera_path.Keyframe.from_matrix(m), jax_path.Keyframe.from_matrix(m)
    np.testing.assert_array_equal(a.m(), b.m())
    assert a.same_pos_as(b) and camera_path.RenderSettings().n_frames == 300
    for kernel in ("gaussian", "quartic", "hat", "box", "none"):
        for x in (-1.5, -0.5, 0.0, 0.3, 1.0):
            assert camera_path.editing_kernel(x, kernel) == jax_path.editing_kernel(x, kernel)
    cp, jp = camera_path.CameraPath(), jax_path.CameraPath()
    for c in _cameras(3, 2):
        cp.add_camera(c)
        jp.add_camera(c)
    cp.sanitize_keyframes()
    jp.sanitize_keyframes()
    assert [k.timestamp for k in cp.keyframes] == [k.timestamp for k in jp.keyframes]


@pytest.mark.parametrize("mode", [m.value for m in camera_predictor.CameraPredictionMode
                                  if m.value != "none"])
def test_camera_predictor_equals_jax(mode):
    ours = camera_predictor.make_predictor(mode, half_life_s=0.05)
    theirs = jax_predictor.make_predictor(mode, half_life_s=0.05)
    base = _cameras(1, 5)[0]
    for i in range(6):  # a camera turning and moving at a steady rate
        ang = 0.05 * i
        R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]])
        cam = np.concatenate([R @ base[:, :3], base[:, 3:] + 0.1 * i], 1)
        ours.sample_camera(cam, 1 / 30)
        theirs.sample_camera(cam, 1 / 30)
    for dt in (0.0, 0.05, 0.2):
        np.testing.assert_allclose(ours.predict_camera(dt), theirs.predict_camera(dt),
                                   rtol=1e-6, atol=1e-9)
    assert camera_predictor.make_predictor("none") is None


@pytest.mark.parametrize("curve", [c.value for c in TonemapCurve if c.name == c.name.upper()])
def test_tonemap_equals_jax(curve):
    x = np.random.default_rng(3).uniform(-0.5, 8.0, (64, 3)).astype(np.float32)
    ours = buffer.tonemap(torch.from_numpy(x), TonemapCurve(curve)).numpy()
    theirs = np.asarray(jax_buffer.tonemap(jnp.asarray(x), JaxTonemapCurve(curve)))
    np.testing.assert_allclose(ours, theirs, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("space", ["linear", "srgb"])
def test_render_buffer_equals_jax(space):
    rng = np.random.default_rng(9)
    ours, theirs = buffer.RenderBuffer(6, 4), jax_buffer.RenderBuffer(6, 4)
    for _ in range(3):
        frame = rng.uniform(0, 1.5, (4, 6, 4)).astype(np.float32)
        depth = rng.uniform(0, 3, (4, 6)).astype(np.float32)
        ours.accumulate(frame, depth)
        theirs.accumulate(frame, depth)
    np.testing.assert_array_equal(ours.accum, theirs.accum)
    np.testing.assert_array_equal(ours.depth, theirs.depth)
    bg = rng.uniform(0, 1, (4, 6, 4)).astype(np.float32)
    for curve in ("identity", "aces"):
        a = ours.tonemapped(0.5, TonemapCurve(curve), ColorSpace(space), background=bg)
        b = theirs.tonemapped(0.5, JaxTonemapCurve(curve), JaxColorSpace(space), background=bg)
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    ours.reset()
    assert ours.spp == 0 and not ours.accum.any()


def test_dynamic_resolution_equals_jax():
    ours, theirs = buffer.DynamicResolution(30.0), jax_buffer.DynamicResolution(30.0)
    for ms in (10.0, 12.0, 90.0, 80.0, 20.0, 5.0, 5.0, 33.0):
        assert ours.update(ms) == theirs.update(ms)


def test_overlay_pixels_equal_jax():
    cam = np.concatenate([np.eye(3), [[0.5], [0.5], [-1.2]]], 1).astype(np.float32)
    xforms = np.stack(_cameras(3, 4)) * np.float32(0.3)
    ours = torch.zeros((40, 48, 4))
    theirs = np.zeros((40, 48, 4), np.float32)
    overlays.draw_wire_box(ours, (0.1, 0.2, 0.0), (0.9, 0.8, 1.0), cam, 35.0, (0.45, 0.55))
    jax_overlays.draw_wire_box(theirs, (0.1, 0.2, 0.0), (0.9, 0.8, 1.0), cam, 35.0, (0.45, 0.55))
    overlays.draw_cameras(ours, xforms, cam, 35.0)
    jax_overlays.draw_cameras(theirs, xforms, cam, 35.0)
    assert theirs.any()
    np.testing.assert_array_equal(ours.numpy(), theirs)
    pts = np.random.default_rng(1).normal(size=(16, 3))
    for a, b in zip(overlays.project_points(pts, cam, 48, 40, (30.0, 31.0)),
                    jax_overlays.project_points(pts, cam, 48, 40, (30.0, 31.0))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("params", [((2.0, 2.0), (0.5, 0.5), (0.2, 0.2)),
                                    ((3.0, 1.5), (0.3, 0.7), (0.1, 0.3)),
                                    ((1.0, 1.0), (0.5, 0.5), (0.2, 0.2))])
def test_foveation_warp_and_unwarp_equal_jax(params):
    ours, theirs = foveation.Foveation.make(*params), jax_foveation.Foveation.make(*params)
    uv = np.random.default_rng(2).random((257, 2))
    for fn in ("warp", "unwarp", "density"):
        np.testing.assert_array_equal(getattr(ours, fn)(uv), getattr(theirs, fn)(uv))


def test_foveation_fit_reference_defect_is_matched():
    """The JAX package's fit leaves the warp's right arm above 1 (at
    steepness 2, focus 0.5, radius 0.2: warp(0.7) = 1.19), so unwarp∘warp is
    not the identity past ~0.5. The port keeps the fit as it is."""
    ours = foveation.PiecewiseQuadratic.fit(2.0, 0.5, 0.2)
    theirs = jax_foveation.PiecewiseQuadratic.fit(2.0, 0.5, 0.2)
    assert dataclasses.astuple(ours) == dataclasses.astuple(theirs)
    assert ours.warp(0.7) > 1.1 and abs(ours.unwarp(ours.warp(0.7)) - 0.7) > 0.1
    x = np.linspace(0.0, 0.45, 10)
    np.testing.assert_allclose(ours.unwarp(ours.warp(x)), x, atol=1e-9)


def test_render_foveated_equals_jax():
    ours = port_testbed.Testbed(device="cpu")
    ours.load_snapshot(TINY)
    theirs = JaxTestbed()
    theirs.load_snapshot(str(TINY))
    ds = ours.nerf_dataset
    kw = dict(focal_length=tuple(ds.focal_lengths[0]), principal_point=(0.5, 0.5))
    fov, jfov = (m.Foveation.make((2.0, 2.0), (0.45, 0.5), (0.25, 0.25))
                 for m in (foveation, jax_foveation))
    frame = foveation.render_foveated(ours.task, 32, 24, ds.xforms_start[0], fov, scale=0.5,
                                      **kw).numpy()
    ref = jax_foveation.render_foveated(theirs.task, 32, 24, ds.xforms_start[0], jfov,
                                        scale=0.5, **kw)
    assert frame.shape == ref.shape == (24, 32, 4) and frame.dtype == np.float32
    mse = float(np.mean((np.clip(frame, 0, 1) - np.clip(ref, 0, 1)) ** 2))
    assert -10 * np.log10(max(mse, 1e-12)) >= 45.0
