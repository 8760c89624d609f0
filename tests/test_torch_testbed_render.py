"""The port's pyngp ``Testbed.render`` on the tiny snapshot against the JAX
package's ``Testbed`` on the same snapshot, on the CPU: linear and sRGB, spp
4, ``background_color``, ``exposure``, the checkerboard, a training view's
intrinsics, ``render_gt_view``, ``render_error_overlay``,
``render_progressive``, ``render_with_dynamic_res``, ``render_with_depth``,
``screenshot``'s file and ``load_camera_path`` with ``start_t`` / ``end_t``.
Tolerance: tests/test_torch_render.py's 45 dB (the ground-truth views, which
no render enters, to 1e-6); screenshots within one 8-bit step."""

from pathlib import Path

import numpy as np
import pytest
import torch

from instant_ngp_tpu.render.camera_path import CameraPath as JaxCameraPath
from instant_ngp_tpu.testbed import Testbed as JaxTestbed
from instant_ngp_torch import testbed as port_testbed
from instant_ngp_torch.io.png import read_png

torch.set_num_threads(2)

TINY = Path(__file__).resolve().parent / "fixtures" / "tiny_nerf.ingp"
MIN_PSNR_DB = 45.0  # tests/test_torch_render.py's render tolerance
W, H = 24, 16


def _psnr(a, b):
    mse = float(np.mean((np.clip(a, 0, 1) - np.clip(b, 0, 1)) ** 2))
    return -10.0 * np.log10(max(mse, 1e-12))


@pytest.fixture(scope="module")
def loaded():
    ours = port_testbed.Testbed(device="cpu")
    ours.load_snapshot(TINY)
    theirs = JaxTestbed()
    theirs.load_snapshot(str(TINY))
    # the snapshot's dataset holds no images: give both the same ones
    images = np.random.default_rng(4).integers(0, 256, ours.nerf_dataset.images.shape, np.uint8)
    ours.nerf_dataset.images = images.copy()
    theirs.nerf_dataset.images = images.copy()
    return ours, theirs


@pytest.fixture
def pair(loaded):
    """Both Testbeds at their defaults, a free camera at training view 0's
    pose (the JAX render compiles its ray generation anew for each call
    given a view's np.float32 intrinsics, ~5 s on the CPU)."""
    for tb in loaded:
        tb.background_color = np.ones(4, np.float32)
        tb.exposure = 0.0
        tb.render_transparency_as_checkerboard = False
        tb.render_ground_truth = False
        tb.zoom = 1.0
        tb.fov, tb.fov_axis = 50.625, 1
        tb.set_nerf_camera_matrix(tb.nerf.training.get_camera_extrinsics(0))
    return loaded


SETTINGS = {
    "linear": ({}, {}),
    "srgb": ({"linear": False}, {}),
    "spp4": ({"spp": 4}, {}),
    "background": ({}, {"background_color": np.array([0.2, 0.5, 0.9, 1.0], np.float32)}),
    "exposure_linear": ({}, {"exposure": 1.0}),
    "exposure_srgb": ({"linear": False}, {"exposure": -0.5}),
    "checkerboard": ({}, {"render_transparency_as_checkerboard": True}),
    "zoom": ({}, {"zoom": 1.5}),
    "training_view": ({}, {"view": 0}),
    "training_view_fov_axis_0_zoom": ({}, {"view": 1, "fov_axis": 0, "zoom": 1.25}),
}


@pytest.mark.parametrize("case", list(SETTINGS))
def test_render_equals_jax_testbed(pair, case):
    kwargs, knobs = SETTINGS[case]
    frames = []
    for tb in pair:
        for k, v in knobs.items():
            if k == "view":  # a training view's intrinsics, scaled by fov_axis
                tb.set_camera_to_training_view(v)
            else:
                setattr(tb, k, v)
        frames.append(tb.render(W, H, **kwargs))
    ours, theirs = frames
    assert isinstance(ours, np.ndarray) and ours.shape == theirs.shape == (H, W, 4)
    assert _psnr(ours, theirs) >= MIN_PSNR_DB
    assert np.abs(ours[..., 3] - theirs[..., 3]).max() <= 1e-3
    tensor = pair[0].render_tensor(W, H, **kwargs)
    assert torch.equal(tensor, torch.from_numpy(ours))


def test_free_camera_render_equals_jax_testbed(pair):
    """A free camera: fov and screen_center, not the view's intrinsics."""
    frames = []
    for tb in pair:
        tb.set_nerf_camera_matrix(tb.nerf.training.get_camera_extrinsics(1))
        tb.screen_center = (0.45, 0.55)
        frames.append(tb.render(W, H, fov=40.0, camera_matrix=tb.camera_matrix))
        tb.screen_center = (0.5, 0.5)
    assert _psnr(*frames) >= MIN_PSNR_DB


def test_ground_truth_views_equal_jax(pair):
    ours, theirs = pair
    np.testing.assert_allclose(ours.render_gt_view(W, H, 1), theirs.render_gt_view(W, H, 1),
                               rtol=1e-6, atol=1e-6)
    for tb in pair:
        tb.render_ground_truth = True
    for linear in (True, False):
        np.testing.assert_allclose(ours.render(W, H, linear=linear),
                                   theirs.render(W, H, linear=linear), rtol=1e-5, atol=1e-6)


def test_error_overlay_equals_jax(pair):
    ours, theirs = pair
    a, b = ours.render_error_overlay(W, H, 1), theirs.render_error_overlay(W, H, 1)
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape == (H, W, 4)
    assert _psnr(a, b) >= MIN_PSNR_DB


def test_progressive_and_dynamic_res_equal_jax(pair):
    ours, theirs = pair
    assert _psnr(ours.render_progressive(W, H, spp=2), theirs.render_progressive(W, H, spp=2)
                 ) >= MIN_PSNR_DB
    ours.reset_accumulation(due_to_camera_movement=True)
    assert ours._accum_buffer.spp == 0
    for tb in pair:
        tb.dynamic_res, tb.fixed_res_factor = False, 16
    a, b = ours.render_with_dynamic_res(32, 32), theirs.render_with_dynamic_res(32, 32)
    assert a.shape == b.shape == (32, 32, 4) and _psnr(a, b) >= MIN_PSNR_DB


def test_render_with_depth_equals_jax(pair):
    (a, da), (b, db) = (tb.render_with_depth(W, H, spp=2) for tb in pair)
    assert _psnr(a, b) >= MIN_PSNR_DB and da.shape == (H, W)
    np.testing.assert_allclose(da, db, atol=1e-3)


def test_screenshot_file_equals_jax(pair, tmp_path):
    ours, theirs = pair
    ours.screenshot(tmp_path / "ours.png", W, H, spp=2)
    theirs.screenshot(str(tmp_path / "theirs.png"), W, H, spp=2)
    a, b = read_png(tmp_path / "ours.png"), read_png(tmp_path / "theirs.png")
    assert a.shape == b.shape == (H, W, 3)
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_camera_path_render_equals_jax(pair, tmp_path):
    """A path through the training views saved by the JAX package, loaded by
    each; render at start_t / end_t moves the camera to the shutter's point."""
    ours, theirs = pair
    path = JaxCameraPath()
    for i in (0, 1, 0):
        path.add_camera(theirs.nerf_dataset.xforms_start[i], fov=45.0 + 5 * i)
    path.save(tmp_path / "path.json")
    frames = []
    for tb in pair:
        tb.load_camera_path(str(tmp_path / "path.json"))
        frames.append(tb.render(W, H, start_t=0.2, end_t=0.4, shutter_fraction=0.5))
        assert tb._view_index is None
    np.testing.assert_allclose(ours.camera_matrix, theirs.camera_matrix, atol=1e-6)
    assert ours.fov == pytest.approx(theirs.fov)
    assert _psnr(*frames) >= MIN_PSNR_DB


def test_later_slices_raise_at_render(pair):
    """The slab quality no longer raises (Queue 1 item 3 is ported): the
    Testbed renders it, finite and other than the exact frame
    (tests/test_torch_slab.py holds it against the JAX Testbed)."""
    ours, _ = pair
    exact = ours.render(W, H)
    ours.render_quality = "slab"
    ours.task.slab_res0 = 32
    frame = ours.render(W, H)
    assert np.isfinite(frame).all() and frame.shape == (H, W, 4)
    assert not np.array_equal(frame, exact)
    # a G-buffer mode takes the exact path whatever the quality, as the JAX
    # Testbed's (nerf/task.py:2168-2171)
    ours.render_mode = port_testbed.RenderMode.DEPTH
    try:
        depth_slab = ours.render(W, H)
        ours.render_quality = "exact"
        np.testing.assert_array_equal(depth_slab, ours.render(W, H))
    finally:
        ours.render_quality = "exact"
        ours.render_mode = port_testbed.RenderMode.SHADE
