"""The port's Testbed and pyngp surface against the JAX package's, on the CPU.

The completeness test: every public name of ``instant_ngp_tpu.testbed.Testbed``
and of its ``nerf``, ``nerf.training``, ``nerf.training.dataset``, ``sdf``,
``sdf.training``, ``image`` and ``image.training`` views, on the class and on
a fresh instance, is in the port's (``NOT_YET_PORTED``, the names that would
wait for a ROADMAP Queue 1 item, is empty: every item is ported); the GUI's
window and VR calls warn and do nothing in both, as in the JAX package. The
camera optimization's and the latents' names (``CAMERA_SLICE``) set or
called on both Testbeds on a scene with latent dims have the same effect.
``instant_ngp_torch.pyngp`` has every name of the root ``pyngp.py``. Then the
cases of ``tests/test_pyngp_surface.py`` that the port's surface reaches, run
on the port (a 16² generated scene, the tiny config, 4,096-ray batches)."""

import enum
import inspect
import math
import threading

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import pyngp as root_pyngp
from instant_ngp_tpu import testbed as jax_testbed
from instant_ngp_torch import pyngp as ngp
from instant_ngp_torch import testbed as port_testbed
from instant_ngp_torch.geometry.mesh_io import read_ply
from instant_ngp_torch.geometry.procedural import bumpy_torus, write_obj
from instant_ngp_torch.io.png import read_png
from instant_ngp_torch.io.image import save_image
from instant_ngp_torch.io.synthetic import generate_synthetic_dataset

torch.set_num_threads(2)

FOX = Path(__file__).resolve().parents[1] / "data" / "fox_1536.ingp"

# every public name the port's surface leaves for a later slice, with the
# ROADMAP Queue 1 item it waits for: none, the window calls were the last
NOT_YET_PORTED: dict[str, int] = {}

# the names that left NOT_YET_PORTED with the rest of NeRF's training half;
# each case sets or calls one on both Testbeds
# (test_names_of_the_capture_slice_work_as_in_the_jax_testbed)
CAPTURE_SLICE = tuple(f"nerf.training.{name}" for name in (
    "include_sharpness_in_error", "depth_supervision_lambda", "depth_loss_type",
    "set_camera_extrinsics_rolling_shutter"))

# the names that left NOT_YET_PORTED with the camera optimization, the latents
# and the coarse-to-fine level cap; each case sets or calls one of them on
# both Testbeds (test_names_of_the_camera_slice_work_as_in_the_jax_testbed)
CAMERA_SLICE = (
    "Testbed.max_level_rand_training", "nerf.rendering_extra_dims_from_training_view",
    "nerf.set_rendering_extra_dims_from_training_view", "nerf.set_rendering_extra_dims",
    *(f"nerf.training.{name}" for name in (
        "optimize_extrinsics", "optimize_exposure", "optimize_focal_length",
        "optimize_distortion", "optimize_extra_dims", "optimize_per_image_latents",
        "n_steps_between_cam_updates", "extrinsic_learning_rate", "extrinsic_l2_reg",
        "intrinsic_l2_reg", "exposure_l2_reg", "set_camera_intrinsics",
        "set_camera_extrinsics")))

VIEWS = {
    "Testbed": (lambda tb: tb, lambda m: m.Testbed),
    "nerf": (lambda tb: tb.nerf, lambda m: m._NerfView),
    "nerf.training": (lambda tb: tb.nerf.training, lambda m: m._NerfTrainingView),
    "nerf.training.dataset": (lambda tb: tb.nerf.training.dataset, lambda m: m._DatasetView),
    "sdf": (lambda tb: tb.sdf, lambda m: m._SdfView),
    "sdf.training": (lambda tb: tb.sdf.training, lambda m: m._SdfTrainingView),
    "image": (lambda tb: tb.image, lambda m: m._ImageView),
    "image.training": (lambda tb: tb.image.training, lambda m: m._ImageTrainingView),
}


def _public(*objs) -> set[str]:
    return {n for o in objs for n in dir(o) if not n.startswith("_")}


@pytest.fixture(scope="module")
def testbeds():
    return jax_testbed.Testbed(), port_testbed.Testbed(device="cpu")


@pytest.mark.parametrize("view", list(VIEWS))
def test_port_testbed_has_every_public_name_of_the_jax_testbed(testbeds, view):
    jax_tb, port_tb = testbeds
    get, cls = VIEWS[view]
    theirs = _public(get(jax_tb), cls(jax_testbed))
    if view == "sdf":  # forwarded through __getattr__
        theirs |= set(jax_testbed._SdfView._FWD)
    ours = _public(get(port_tb), cls(port_testbed))
    waiting = {k.rsplit(".", 1)[1] for k in NOT_YET_PORTED if k.rsplit(".", 1)[0] == view}
    assert theirs - ours == set()
    assert waiting <= ours and waiting <= theirs


def _non_default(v):
    if isinstance(v, bool):
        return not v
    if isinstance(v, (int, float)):
        return v + 1
    return f"{v}_other"


@pytest.mark.parametrize("name", ["init_window", "init_vr", "destroy_window"])
def test_window_calls_are_warning_no_ops_as_in_jax(testbeds, name):
    """In both Testbeds init_window and init_vr warn and only keep the
    window's size (init_window), destroy_window forgets it; none raises."""
    args = {"init_window": (64, 48), "init_vr": (), "destroy_window": ()}[name]
    for tb in testbeds:
        if name == "destroy_window":
            assert getattr(tb, name)(*args) is None
            assert tb._window_res is None
            continue
        with pytest.warns(UserWarning, match="no-op"):
            assert getattr(tb, name)(*args) is None
    assert port_testbed.NOT_PORTED_ITEMS == {}
    if name == "init_window":
        assert testbeds[1]._window_res == testbeds[0]._window_res == (64, 48)


@pytest.fixture(scope="module")
def fox_testbeds():
    """The fox snapshot in the JAX Testbed and the port's."""
    theirs = jax_testbed.Testbed()
    theirs.load_snapshot(str(FOX))
    ours = port_testbed.Testbed(device="cpu")
    ours.load_snapshot(FOX)
    return theirs, ours


def _render_both(fox_testbeds):
    return tuple(tb.render(16, 16, camera_matrix=np.asarray(tb.nerf_dataset.xforms_start[0]))
                 for tb in fox_testbeds)


def _psnr(a, b):
    mse = float(np.mean((np.clip(a[..., :3], 0, 1) - np.clip(b[..., :3], 0, 1)) ** 2))
    return -10.0 * np.log10(max(mse, 1e-12))


@pytest.mark.parametrize("name", ["autofocus", "autofocus_target", "aperture_size", "dof",
                                  "compute_marching_cubes_mesh",
                                  "compute_and_save_marching_cubes_mesh",
                                  "compute_and_save_png_slices"])
def test_names_of_this_slice_work_as_in_the_jax_testbed(fox_testbeds, name, tmp_path):
    """The depth-of-field knobs and the mesh methods, once they wait for no
    item, on fox in both Testbeds: the knobs' values and 16² renders (≥ 45
    dB), the mesh dict at res 24 (the same faces; vertices within 2 % of a
    voxel, normals within 1e-3, colours of ≥ 99 % of vertices within 4e-3:
    tests/test_torch_mesh_export.py's tolerances), the saved PLY's vertex
    count, and the PNG sheet's name and ≥ 99 % of its pixels within one
    8-bit step (the density through bf16 networks)."""
    theirs, ours = fox_testbeds
    if name in ("autofocus", "autofocus_target", "aperture_size", "dof"):
        value = {"autofocus": True, "autofocus_target": 2.2, "aperture_size": 0.05,
                 "dof": 0.04}[name]
        for tb in fox_testbeds:
            tb.aperture_size = 0.04  # focus only shows through a lens
            setattr(tb, name, value)
        try:
            assert getattr(ours, name) == pytest.approx(getattr(theirs, name))
            frame, ref = _render_both(fox_testbeds)
            assert ours.autofocus_target == pytest.approx(theirs.autofocus_target, rel=1e-6)
        finally:
            for tb in fox_testbeds:
                tb.autofocus, tb.aperture_size, tb.autofocus_target = False, 0.0, 1.0
        assert ours.dof == ours.aperture_size == 0.0
        assert _psnr(frame, ref) >= 45.0
        return
    if name == "compute_marching_cubes_mesh":
        ref = theirs.compute_marching_cubes_mesh(resolution=(24, 24, 24))
        got = ours.compute_marching_cubes_mesh(resolution=(24, 24, 24))
        assert set(got) == {"V", "N", "C", "F"} and len(ref["F"]) > 100
        np.testing.assert_array_equal(got["F"], ref["F"])
        np.testing.assert_allclose(got["V"], ref["V"], rtol=0, atol=0.02 / 24)
        np.testing.assert_allclose(got["N"], ref["N"], rtol=0, atol=1e-3)
        assert np.mean(np.abs(got["C"] - ref["C"]).max(-1) <= 4e-3) >= 0.99
    elif name == "compute_and_save_marching_cubes_mesh":
        n_ref = theirs.compute_and_save_marching_cubes_mesh(str(tmp_path / "j.ply"),
                                                            resolution=(24, 24, 24))
        n = ours.compute_and_save_marching_cubes_mesh(str(tmp_path / "p.ply"),
                                                      resolution=(24, 24, 24))
        assert n == n_ref > 100
        v, f, _ = read_ply(tmp_path / "p.ply")
        v_ref, f_ref, _ = read_ply(tmp_path / "j.ply")
        np.testing.assert_array_equal(f, f_ref)
        np.testing.assert_allclose(v, v_ref, rtol=0, atol=0.02 / 24)
    else:
        res_ref = theirs.compute_and_save_png_slices(str(tmp_path / "s"), resolution=32)
        res = ours.compute_and_save_png_slices(str(tmp_path / "s"), resolution=32)
        assert res == res_ref
        path = tmp_path / f"s.density_slices_{res[0]}x{res[1]}x{res[2]}.png"
        import imageio.v2 as imageio

        ref = imageio.imread(path)
        ours.compute_and_save_png_slices(str(tmp_path / "p"), resolution=32)
        got = read_png(tmp_path / f"p.density_slices_{res[0]}x{res[1]}x{res[2]}.png")
        got = got[..., 0] if got.ndim == 3 else got
        assert got.shape == ref.shape and np.ptp(ref) > 100
        assert np.mean(np.abs(got.astype(int) - ref) <= 1) >= 0.99


def test_pyngp_has_every_name_of_the_root_pyngp():
    names = {n for n in dir(root_pyngp)
             if not n.startswith("_") and not inspect.ismodule(getattr(root_pyngp, n))}
    assert names - set(dir(ngp)) == set()
    assert ngp.__all__ == root_pyngp.__all__
    for n in names:
        theirs, ours = getattr(root_pyngp, n), getattr(ngp, n)
        if isinstance(theirs, enum.Enum):
            assert (ours.name, ours.value) == (theirs.name, theirs.value), n
        elif isinstance(theirs, type) and issubclass(theirs, enum.Enum):
            assert ([(k, m.value) for k, m in ours.__members__.items()]
                    == [(k, m.value) for k, m in theirs.__members__.items()]), n
        else:
            assert callable(ours), n
    assert ngp.mode_from_string("nerf") == ngp.TestbedMode.NERF
    assert ngp.Testbed().device.type == "cuda"  # the card unless asked otherwise


# --- tests/test_pyngp_surface.py's cases, on the port ---

@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    scene_dir, _ = generate_synthetic_dataset(tmp_path_factory.mktemp("scene") / "s", res=16,
                                              n_train=2, n_test=1, n_steps=32)
    return scene_dir


def _nerf_testbed(scene_dir):
    tb = ngp.Testbed(device="cpu")
    tb.training_batch_size = 1 << 12
    tb.reload_network_from_json(graft._tiny_nerf_config())
    tb.load_training_data(scene_dir)
    return tb


def test_geometry():
    b = ngp.BoundingBox([0, 0, 0], [2, 2, 2])
    assert b.contains([1, 1, 1]) and not b.contains([3, 0, 0])
    assert abs(b.distance([4, 0, 0]) - 2.0) < 1e-6
    assert b.intersects(ngp.BoundingBox([1, 1, 1], [3, 3, 3]))
    assert not b.intersects(ngp.BoundingBox([5, 5, 5], [6, 6, 6]))
    np.testing.assert_allclose(b.relative_pos([1, 0, 2]), [0.5, 0, 1])
    e = ngp.BoundingBox()
    assert e.is_empty()
    e.enlarge([1, 2, 3])
    e.enlarge(b)
    np.testing.assert_allclose(e.min, 0.0)
    np.testing.assert_allclose(e.max, [2, 2, 3])
    ref = root_pyngp.BoundingBox([0.1, 0.2, 0.3], [0.9, 0.8, 0.7])
    ours = ngp.BoundingBox([0.1, 0.2, 0.3], [0.9, 0.8, 0.7])
    for p, d in (([0.0, 0.5, 0.5], [1, 0.1, 0]), ([0.5, 0.5, 0.5], [0, 0, 1])):
        assert ours.ray_intersect(p, d) == ref.ray_intersect(p, d)
        assert ours.signed_distance(p) == ref.signed_distance(p)
    np.testing.assert_array_equal(ours.get_vertices(), ref.get_vertices())


def test_mode_from_string():
    assert ngp.mode_from_string("nerf") == ngp.TestbedMode.NERF
    assert ngp.mode_from_string("sdf") == ngp.TestbedMode.SDF


def test_checkerboard_transparency(scene):
    tb = _nerf_testbed(scene)
    tb.task.train(1)
    cam = tb.nerf_dataset.xforms_start[0]
    tb.background_color = np.array([0, 0, 0, 0], np.float32)
    plain = tb.render(16, 16, camera_matrix=cam)
    tb.render_transparency_as_checkerboard = True
    checked = tb.render(16, 16, camera_matrix=cam)
    a = plain[..., 3]
    assert (a < 0.05).any()
    vals = checked[..., 0][a < 0.05]
    assert ((np.abs(vals - 0.55) < 0.06) | (np.abs(vals - 0.4) < 0.06)).all()


def test_fixed_res_factor(scene):
    tb = _nerf_testbed(scene)
    tb.task.train(1)
    tb.dynamic_res = False
    tb.fixed_res_factor = 16  # factor 0.5: renders at half resolution
    frame = tb.render_with_dynamic_res(32, 32, camera_matrix=tb.nerf_dataset.xforms_start[0])
    assert frame.shape == (32, 32, 4)
    assert np.allclose(frame[0::2, 0::2], frame[1::2, 1::2])  # 2x2 blocks repeat a pixel


def test_aabb_and_default_camera(scene):
    tb = _nerf_testbed(scene)
    box = tb.aabb
    assert box.contains(box.center)
    np.testing.assert_allclose(tb.default_camera[:, :3], np.eye(3))
    tb.screen_center = (0.4, 0.6)
    tb.reset_camera()
    assert tb.screen_center == (0.5, 0.5)
    assert tb.crop_box.contains(box.center)
    tb.set_crop_box([[0.2, 0.2, 0.2], [0.8, 0.8, 0.8]])
    np.testing.assert_allclose(tb.crop_box_corners(), [[0.2] * 3, [0.8] * 3])
    tb.render_aabb_to_local = np.eye(3)  # the identity is kept
    np.testing.assert_array_equal(tb.render_aabb_to_local, np.eye(3))
    turn = np.array([[0, 1, 0], [-1, 0, 0], [0, 0, 1]], np.float32)
    tb.render_aabb_to_local = turn  # a rotated crop box (tests/test_torch_render_modes.py)
    np.testing.assert_array_equal(tb.render_aabb_to_local, turn)
    np.testing.assert_array_equal(tb.task.render_aabb_to_local, turn)


def test_timestamp_api():
    cp = ngp.CameraPath()
    for k in range(4):
        cp.add_camera(np.hstack([np.eye(3), [[0], [0], [float(k)]]]).astype(np.float32),
                      fov=50.0 + k)
    assert not cp.has_valid_timestamps()
    cp.sanitize_keyframes()
    assert cp.has_valid_timestamps() and cp.duration_seconds == 1.0
    for t in (0.0, 0.3, 0.5, 0.9, 1.0):
        np.testing.assert_allclose(cp.eval_camera_path(t).T, cp.eval(t).T, atol=1e-5)
    for k, stamp in zip(cp.keyframes, (0.75, 0.8, 0.9, 1.0)):
        k.timestamp = stamp
    i, f = cp.get_pos(0.5)
    assert i == 0 and 0 < f < 1
    assert cp.get_pos(0.99)[0] == 2
    cp.clear()
    assert cp.empty() and cp.play_time == 0.0


def test_frame_playback_and_record(scene):
    tb = _nerf_testbed(scene)
    tb.shall_train = False
    tb.record_camera_path = True
    for _ in range(3):
        tb.frame()
    assert len(tb.camera_path.keyframes) == 3 and tb.camera_path.has_valid_timestamps()
    tb.record_camera_path = False
    cp = tb.camera_path
    cp.keyframes[0].T = np.array([9.0, 9.0, 9.0], np.float32)
    cp.update_cam_from_path = True
    cp.auto_play_speed = 0.0
    cp.play_time = 0.0
    tb.frame()
    np.testing.assert_allclose(tb.camera_matrix[:, 3], [9, 9, 9], atol=1e-5)


def test_view_binding(scene):
    """View 0's latents are the default; a scene without latent dims has
    none, from any view (the JAX Testbed's empty vector)."""
    tb = _nerf_testbed(scene)
    assert tb.nerf.rendering_extra_dims_from_training_view == 0
    tb.nerf.set_rendering_extra_dims_from_training_view(0)
    tb.nerf.set_rendering_extra_dims_from_training_view(1)
    assert tb.nerf.rendering_extra_dims_from_training_view == 1
    assert tb.nerf.get_rendering_extra_dims().shape == (0,)
    assert tb.nerf.training.get_extra_dims(0).shape == (0,)


def test_aliases_and_fov(scene):
    tb = _nerf_testbed(scene)
    tb.render_groundtruth = True
    assert tb.render_ground_truth is True
    tb.loop_animation = True
    assert tb.camera_path.loop is True
    np.testing.assert_allclose(tb.view_camera(), tb.camera_matrix)
    tb.fov = 60.0
    np.testing.assert_allclose(tb.fov_xy, [60, 60])
    tb.fov_xy = (50.0, 40.0)
    assert tb.fov == 40.0  # fov_axis 1
    assert abs(tb.relative_focal_length[1] - 0.5 / math.tan(math.radians(20))) < 1e-5
    tb.relative_focal_length = (1.0, 1.0)
    assert abs(tb.fov - math.degrees(2 * math.atan(0.5))) < 1e-4
    tr = tb.nerf.training
    tr.optimize_per_image_latents = False
    assert tr.optimize_extra_dims is False


def test_camera_prediction(scene):
    tb = _nerf_testbed(scene)
    tb.shall_train = False
    tb.camera_prediction_mode = ngp.CameraPredictionMode.MAT_LOG_LINEAR
    for _ in range(5):  # a constant-velocity translation through frame()
        tb.camera_matrix = tb.camera_matrix.copy()
        tb.camera_matrix[0, 3] += 0.1
        tb.frame()
    pred = tb.predict_view_camera(1.0)
    assert pred.shape == (3, 4) and pred[0, 3] > tb.camera_matrix[0, 3] + 1e-4


def test_projection_and_segment():
    from instant_ngp_torch.render.overlays import draw_segment, project_points

    cam = np.hstack([np.eye(3), [[0.0], [0.0], [0.0]]]).astype(np.float32)
    px, front = project_points(np.array([[0, 0, 2.0]]), cam, 64, 64, 32.0)
    assert front[0]
    np.testing.assert_allclose(px[0], [32, 32], atol=1e-4)
    _, behind = project_points(np.array([[0, 0, -1.0]]), cam, 64, 64, 32.0)
    assert not behind[0]
    frame = torch.zeros((16, 16, 4))
    draw_segment(frame, (0, 8), (15, 8), (1.0, 0.0, 0.0))
    assert (frame[8, :, 0] == 1.0).all() and frame[0].sum() == 0


def test_testbed_overlay_flags(scene):
    tb = _nerf_testbed(scene)
    tb.task.train(1)
    cam = tb.nerf_dataset.xforms_start[0]
    base = tb.render(32, 32, camera_matrix=cam)
    tb.visualize_unit_cube = True
    tb.visualize_cameras = True
    over = tb.render(32, 32, camera_matrix=cam)
    assert np.abs(over - base).max() > 0.1 and np.isfinite(over).all()


def test_prediction_mode_change_rebuilds(scene):
    tb = _nerf_testbed(scene)
    tb.shall_train = False
    tb.camera_prediction_mode = ngp.CameraPredictionMode.MAT_LOG_LINEAR
    tb.frame()
    p_lin = tb._cam_predictor
    assert p_lin is not None and not p_lin.is_quadratic
    tb.camera_prediction_mode = ngp.CameraPredictionMode.MAT_LOG_QUADRATIC
    tb.frame()
    assert tb._cam_predictor is not p_lin and tb._cam_predictor.is_quadratic
    tb.camera_prediction_mode = ngp.CameraPredictionMode.NONE
    tb.frame()
    assert tb._cam_predictor is None
    np.testing.assert_allclose(tb.predict_view_camera(1.0), tb.camera_matrix)


def test_training_knobs_forward_and_queue_before_a_scene(scene):
    """tests/test_pyngp_surface.py's density_grid_decay and pending-knob
    cases: set before the scene loads, applied to its task."""
    tb = ngp.Testbed(device="cpu")
    tb.training_batch_size = 1 << 12
    tb.reload_network_from_json(graft._tiny_nerf_config())
    tr = tb.nerf.training
    tr.density_grid_decay = 0.9
    tr.near_distance = 0.2
    tr.random_bg_color = False
    tr.loss_type = ngp.LossType.L2
    tr.sample_focal_plane_proportional_to_error = False
    tr.train_mode = "rflrelax"
    tr.optimize_exposure = True
    tr.extrinsic_learning_rate = 2e-3
    tb.nerf.cone_angle_constant = 0.01
    tb.shall_train_encoding = False
    tb.load_training_data(scene)
    t = tb.task
    assert (t.density_grid_decay, t.training_near_distance, t.random_bg_color) == (0.9, 0.2, False)
    assert t.loss_type == ngp.LossType.L2 and tr.loss_type == ngp.LossType.L2
    assert t.march_cfg.cone_angle == t.cone_angle == 0.01
    assert t.sample_image_proportional_to_error and not t.sample_focal_plane_proportional_to_error
    assert not t.shall_train_encoding and tr.n_images_for_training == 2
    assert tr.train_mode == ngp.TrainMode.RFL_RELAX and tr.linear_colors is False
    assert t.optimize_exposure and t.cam_opt_spec.learning_rate == pytest.approx(2e-3 / 16)
    tr.train_mode = "rfl"
    tr.loss_type = "L1"
    assert tr.train_mode == ngp.TrainMode.RFL and t.train_mode == "rfl"
    assert tr.loss_type == ngp.LossType.L1 == t.loss_type
    m = tr.get_camera_extrinsics(1)
    np.testing.assert_allclose(tb.nerf_dataset.nerf_matrix_to_ngp(m),
                               tb.nerf_dataset.xforms_start[1], atol=1e-6)


def test_nerf_freeze_encoding(scene):
    tb = _nerf_testbed(scene)
    tb.task.train(1)
    enc0 = tb.task.model.pos_encoding.table.detach().clone()
    net0 = tb.task.model.density_network.weights[0].detach().clone()
    tb.shall_train_encoding = False
    tb.frame()
    assert torch.equal(enc0, tb.task.model.pos_encoding.table.detach())
    assert not torch.equal(net0, tb.task.model.density_network.weights[0].detach())
    tb.shall_train_encoding = True
    tb.shall_train_network = False
    net1 = tb.task.model.density_network.weights[0].detach().clone()
    tb.frame()
    assert torch.equal(net1, tb.task.model.density_network.weights[0].detach())
    assert not torch.equal(enc0, tb.task.model.pos_encoding.table.detach())


def test_set_image_and_views_of_the_dataset(scene):
    tb = _nerf_testbed(scene)
    ds = tb.nerf.training.dataset
    assert ds.n_images == 2 and ds.aabb_scale == tb.nerf_dataset.aabb_scale
    assert ds.metadata[0].resolution == (16, 16) and ds.metadata[0].lens.mode.value == "perspective"
    img = np.random.default_rng(0).random((16, 16, 4)).astype(np.float32)
    tb.nerf.training.set_image(1, img)
    expect = (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)
    assert np.array_equal(tb.nerf_dataset.images[1], expect)
    assert np.array_equal(tb.task.images[1].numpy(), expect)


def test_post_task_runs_at_the_next_frame_and_meters_update(scene):
    tb = _nerf_testbed(scene)
    seen = []
    done = [tb.post_task(lambda i=i: seen.append(i)) for i in range(3)]
    worker = threading.Thread(target=lambda: done.append(tb.post_task(lambda: seen.append(3))))
    worker.start()
    worker.join(timeout=10)
    assert not worker.is_alive() and seen == []
    tb.frame()
    assert seen == [0, 1, 2, 3] and all(d.is_set() for d in done)
    assert tb.training_ms.val() > 0 and tb.frame_ms.val() >= tb.training_ms.val()
    tb.render(8, 8)
    assert tb.render_ms.val() > 0 and tb.view().shape == (8, 8, 4)
    assert tb.n_params() > tb.n_encoding_params() > 0


def test_image_view_forwarding(tmp_path):
    img = np.random.default_rng(0).random((32, 32, 4)).astype(np.float32)
    save_image(tmp_path / "img.bin", img)
    tb = ngp.Testbed(device="cpu")
    tb.training_batch_size = 256
    tb.reload_network_from_json({"encoding": {"otype": "HashGrid", "n_levels": 4},
                                 "network": {"n_neurons": 16, "n_hidden_layers": 1}})
    tb.load_training_data(tmp_path / "img.bin")
    assert tb.image.random_mode == ngp.RandomMode("stratified")
    tb.image.random_mode = ngp.RandomMode("halton")
    assert tb.task.random_mode == "halton"
    tb.image.training.snap_to_pixel_centers = True
    assert tb.task.snap_to_pixel_centers
    tb.image.training.linear_colors = True
    assert tb.task.linear_colors


def test_sdf_view_forwarding_and_fixed_training_data(tmp_path):
    v, f = bumpy_torus(16, 8, seed=3)
    write_obj(tmp_path / "t.obj", v, f)
    tb = ngp.Testbed(device="cpu")
    tb.reload_network_from_json({"loss": {"otype": "Mape"},
                                 "encoding": {"otype": "HashGrid", "n_levels": 4,
                                              "log2_hashmap_size": 12, "base_resolution": 4},
                                 "network": {"n_neurons": 16, "n_hidden_layers": 1}})
    tb.load_training_data(tmp_path / "t.obj")
    try:
        assert tb.sdf.mesh_sdf_mode == ngp.MeshSdfMode("pseudonormal")
        tb.sdf.zero_offset = 0.05
        tb.sdf.fd_normals_epsilon = 2e-3
        assert (tb.task.zero_offset, tb.task.fd_normals_epsilon) == (0.05, 2e-3)
        assert tb.sdf.training.generate_sdf_data_online
        tb.sdf.training.surface_offset_scale = 2.0
        assert tb.task.surface_offset_scale == 2.0
        assert tb.sdf.mesh_scale == pytest.approx(tb.task.mesh_scale)
        assert not tb.sdf.use_triangle_octree
        np.testing.assert_allclose(tb.raw_aabb.min, v.min(0), atol=1e-5)
        tb.task.batch_size = 512
        pts = np.random.default_rng(1).uniform(v.min(0), v.max(0), (700, 3)).astype(np.float32)
        tb.override_sdf_training_data(pts, np.full(700, 0.01, np.float32))
        assert not tb.sdf.training.generate_sdf_data_online
        for _ in range(2):
            tb.frame()
        assert tb.training_step == 2 and tb.task._thread is None  # no producer
        assert tb.task._override_idx == 1024 % 700
    finally:
        tb.task.stop_producer()


def test_empty_dataset_lens_and_reset(scene):
    theirs = jax_testbed.Testbed()
    theirs.network_config = graft._tiny_nerf_config()
    tb = ngp.Testbed(device="cpu")
    tb.network_config = graft._tiny_nerf_config()
    ds, ref = tb.create_empty_nerf_dataset(3, aabb_scale=2), theirs.create_empty_nerf_dataset(3, 2)
    for field in ("images", "xforms_start", "focal_lengths", "principal_points", "offset"):
        np.testing.assert_array_equal(getattr(ds, field), getattr(ref, field))
    assert (ds.resolution, ds.aabb_scale, ds.scale) == (ref.resolution, ref.aabb_scale, ref.scale)
    assert tb.mode == ngp.TestbedMode.NERF and tb.task.dataset is ds
    tb.render_lens = ngp.Lens("opencv", [0.1, -0.05, 0.0, 0.0])
    assert tb.render_lens.mode == ngp.LensMode.OPENCV
    np.testing.assert_allclose(tb.task.lens_params.numpy()[:2], [0.1, -0.05])
    tb = _nerf_testbed(scene)
    tb.frame()
    tb.reset()
    assert tb.training_step == 0 and tb.task.training_step == 0
    tb.clear_training_data()
    assert tb.task is None and not tb.want_repl()


@pytest.fixture(scope="module")
def latent_scene(scene, tmp_path_factory):
    """The 16² scene with 4 latent dims a view (its transforms.json's
    ``n_extra_learnable_dims``)."""
    import json
    import shutil

    out = tmp_path_factory.mktemp("latent") / "s"
    shutil.copytree(scene, out)
    meta = json.loads((out / "transforms.json").read_text())
    meta["n_extra_learnable_dims"] = 4
    (out / "transforms.json").write_text(json.dumps(meta))
    return out


def _both_on(scene_dir):
    """The JAX Testbed and the port's on the scene, the port's latents those
    of the JAX task (each package draws its own)."""
    theirs = jax_testbed.Testbed()
    theirs.training_batch_size = 1 << 12
    theirs.reload_network_from_json(graft._tiny_nerf_config())
    theirs.load_training_data(str(scene_dir))
    ours = _nerf_testbed(scene_dir)
    ours.task.cam_offsets["extra"] = torch.from_numpy(np.array(theirs.task.state.cam["extra"]))
    return theirs, ours


def _cam(tb, key):
    task = tb.task
    v = task.state.cam[key] if hasattr(task.state, "params") else task.cam_offsets[key]
    return np.asarray(v)


@pytest.mark.parametrize("name", CAMERA_SLICE)
def test_names_of_the_camera_slice_work_as_in_the_jax_testbed(latent_scene, name):
    theirs, ours = _both_on(latent_scene)
    view, attr = name.rsplit(".", 1)
    objs = [VIEWS[view][0](tb) for tb in (theirs, ours)]
    rng = np.random.default_rng(len(name))
    if attr == "max_level_rand_training":
        for o in objs:
            setattr(o, attr, True)
        assert theirs.task.max_level_rand_training is ours.task.max_level_rand_training is True
        ours.frame()  # each ray trains at its drawn level cap
        assert np.isfinite(ours.loss)
    elif attr in ("rendering_extra_dims_from_training_view",
                  "set_rendering_extra_dims_from_training_view"):
        for o in objs:
            if attr.startswith("set_"):
                getattr(o, attr)(1)
            else:
                setattr(o, attr, 1)
        assert [o.rendering_extra_dims_from_training_view for o in objs] == [1, 1]
        np.testing.assert_array_equal(ours.nerf.get_rendering_extra_dims(),
                                      np.asarray(theirs.nerf.get_rendering_extra_dims()))
        np.testing.assert_array_equal(ours.nerf.get_rendering_extra_dims(),
                                      ours.nerf.training.get_extra_dims(1))
    elif attr == "set_rendering_extra_dims":
        vec = rng.normal(size=4).astype(np.float32)
        for o in objs:
            o.set_rendering_extra_dims(vec)
        assert [o.rendering_extra_dims_from_training_view for o in objs] == [-1, -1]
        for tb in (theirs, ours):
            np.testing.assert_array_equal(np.asarray(tb.nerf.get_rendering_extra_dims()), vec)
        with pytest.raises(ValueError):
            ours.nerf.set_rendering_extra_dims(vec[:3])
    elif attr.startswith("optimize_"):
        default = [getattr(o, attr) for o in objs]
        assert default[0] == default[1]
        for o in objs:
            setattr(o, attr, not default[0])
        assert [getattr(o, attr) for o in objs] == [not default[0]] * 2
        if attr == "optimize_distortion":
            for tb in (theirs, ours):
                np.testing.assert_array_equal(_cam(tb, "distortion"), np.zeros((32, 32, 2)))
            assert ours.task.state.cam_opt is None  # made anew at the next step
    elif attr in ("n_steps_between_cam_updates", "extrinsic_learning_rate", "extrinsic_l2_reg",
                  "intrinsic_l2_reg", "exposure_l2_reg"):
        value = {"n_steps_between_cam_updates": 8, "extrinsic_learning_rate": 2e-3,
                 "extrinsic_l2_reg": 1e-3, "intrinsic_l2_reg": 3e-4,
                 "exposure_l2_reg": 0.25}[attr]
        for o in objs:
            setattr(o, attr, value)
        got = [getattr(o, attr) for o in objs]
        assert got[0] == pytest.approx(got[1], rel=1e-7) and got[1] == pytest.approx(value)
        jspec, pspec = theirs.task.cam_opt.spec, ours.task.cam_opt_spec
        assert (jspec.learning_rate, jspec.l2_reg) == pytest.approx((pspec.learning_rate,
                                                                     pspec.l2_reg))
    elif attr == "set_camera_intrinsics":
        for o in objs:
            o.set_camera_intrinsics(1, fx=30.0, fy=31.0, cx=7.0, cy=-0.4, k1=0.01, p1=0.001)
        a, b = theirs.nerf_dataset, ours.nerf_dataset
        np.testing.assert_array_equal(a.focal_lengths, b.focal_lengths)
        np.testing.assert_array_equal(a.principal_points, b.principal_points)
        assert a.lens_mode == b.lens_mode
        np.testing.assert_array_equal(a.lens_params, b.lens_params)
        np.testing.assert_array_equal(ours.task.focals.numpy(), b.focal_lengths)
    else:  # set_camera_extrinsics
        m = np.concatenate([np.linalg.qr(rng.normal(size=(3, 3)))[0],
                            rng.normal(size=(3, 1))], 1).astype(np.float32)
        offs = {k: rng.normal(size=_cam(ours, k).shape).astype(np.float32)
                for k in ("rot", "pos", "exposure")}
        import dataclasses as dc

        theirs.task.state = dc.replace(theirs.task.state, cam={
            **theirs.task.state.cam, **{k: jnp.asarray(v) for k, v in offs.items()}})
        ours.task.cam_offsets.update({k: torch.from_numpy(v.copy()) for k, v in offs.items()})
        for o in objs:
            o.set_camera_extrinsics(1, m)
        np.testing.assert_array_equal(theirs.nerf_dataset.xforms_start,
                                      ours.nerf_dataset.xforms_start)
        np.testing.assert_array_equal(ours.task.xforms.numpy(), ours.nerf_dataset.xforms_start)
        for k in offs:
            np.testing.assert_array_equal(_cam(theirs, k), _cam(ours, k))
            assert not np.any(_cam(ours, k)[1]) and np.array_equal(_cam(ours, k)[0], offs[k][0])
        np.testing.assert_allclose(ours.nerf.training.get_camera_extrinsics(1),
                                   theirs.nerf.training.get_camera_extrinsics(1), atol=1e-6)


def test_offset_cameras_reach_find_closest_and_reset(latent_scene):
    """``find_closest_training_view`` over the offset poses, and
    ``reset_camera_extrinsics`` zeroing them, as in the JAX Testbed."""
    import dataclasses as dc

    theirs, ours = _both_on(latent_scene)
    n = ours.nerf_dataset.n_images
    offs = {"rot": np.zeros((n, 3), np.float32), "pos": np.zeros((n, 3), np.float32),
            "exposure": np.full((n, 3), 0.5, np.float32)}
    # move view 0's camera onto view 1's pose: the closest view to it flips
    xf = ours.nerf_dataset.xforms_start
    offs["pos"][0] = xf[1, :, 3] - xf[0, :, 3]
    theirs.task.state = dc.replace(theirs.task.state, cam={
        **theirs.task.state.cam, **{k: jnp.asarray(v) for k, v in offs.items()}})
    ours.task.cam_offsets.update({k: torch.from_numpy(v.copy()) for k, v in offs.items()})
    pose = xf[1].copy()
    pose[:, 3] += 1e-3
    assert ours.nerf.find_closest_training_view(pose) == theirs.nerf.find_closest_training_view(
        pose)
    for pose in (xf[0], xf[1], xf[1] + 0.3):
        assert (ours.nerf.find_closest_training_view(pose)
                == theirs.nerf.find_closest_training_view(pose))
    for tb in (theirs, ours):
        tb.nerf.training.reset_camera_extrinsics()
    for k in offs:
        np.testing.assert_array_equal(_cam(ours, k), _cam(theirs, k))
        assert not np.any(_cam(ours, k))
    np.testing.assert_array_equal(_cam(ours, "extra"), _cam(theirs, "extra"))  # kept


@pytest.mark.parametrize("name", CAPTURE_SLICE)
def test_names_of_the_capture_slice_work_as_in_the_jax_testbed(scene, name):
    attr = name.rsplit(".", 1)[1]
    tbs = [jax_testbed.Testbed(), ngp.Testbed(device="cpu")]
    for tb in tbs:
        tb.training_batch_size = 1 << 12
        tb.reload_network_from_json(graft._tiny_nerf_config())
        if attr == "include_sharpness_in_error":  # set before the load, as pyngp asks
            tb.nerf.training.include_sharpness_in_error = True
        tb.load_training_data(str(scene))
    theirs, ours = tbs
    objs = [tb.nerf.training for tb in tbs]
    if attr == "include_sharpness_in_error":
        assert [o.include_sharpness_in_error for o in objs] == [True, True]
        assert tuple(ours.task.state.sharp_grid.shape) == tuple(theirs.task.state.sharp_grid.shape)
        np.testing.assert_allclose(ours.task.sharpness.numpy(),
                                   np.asarray(theirs.task.data["sharpness"]), rtol=1e-6)
        for o in objs:
            with pytest.raises(RuntimeError):
                o.include_sharpness_in_error = False
        ours.frame()
        assert np.isfinite(ours.loss)
    elif attr == "depth_supervision_lambda":
        assert [o.depth_supervision_lambda for o in objs] == [0.0, 0.0]  # no depth maps
        for o in objs:
            o.depth_supervision_lambda = 0.5
        assert ours.task.depth_supervision_lambda == theirs.task.depth_supervision_lambda == 0.5
    elif attr == "depth_loss_type":
        assert [o.depth_loss_type for o in objs] == ["L1", "L1"]
        for o in objs:
            o.depth_loss_type = ngp.LossType.HUBER
        assert ours.task.depth_loss_type == theirs.task.depth_loss_type
        for o in objs:
            o.depth_loss_type = "L2"
        assert [o.depth_loss_type for o in objs] == ["L2", "L2"]
    else:  # set_camera_extrinsics_rolling_shutter
        rng = np.random.default_rng(4)
        m0, m1 = (np.concatenate([np.linalg.qr(rng.normal(size=(3, 3)))[0],
                                  rng.normal(size=(3, 1))], 1).astype(np.float32)
                  for _ in range(2))
        for o in objs:
            o.set_camera_extrinsics_rolling_shutter(1, m0, m1, [0.1, 0.2, 0.3, 0.4])
        a, b = theirs.nerf_dataset, ours.nerf_dataset
        for field in ("xforms_start", "xforms_end", "rolling_shutter"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
        np.testing.assert_array_equal(b.rolling_shutter[1], np.float32([0.1, 0.2, 0.3, 0.4]))
        np.testing.assert_array_equal(ours.task.xforms.numpy(), b.xforms_start)
        # a scene loaded still keeps sampling its start transforms, as the JAX task
        assert ours.task.has_motion is theirs.task.has_motion is False


TINY = Path(__file__).resolve().parent / "fixtures" / "tiny_nerf.ingp"


@pytest.fixture(scope="module")
def tiny_testbeds():
    """The tiny snapshot in the JAX Testbed and the port's, their bakes at
    32³ (the snapshot's untrained grid is dense)."""
    theirs = jax_testbed.Testbed()
    theirs.load_snapshot(str(TINY))
    ours = port_testbed.Testbed(device="cpu")
    ours.load_snapshot(TINY)
    for tb in (theirs, ours):
        tb.task.baked_res0 = tb.task.slab_res0 = 32
    return theirs, ours


@pytest.mark.parametrize("quality", ["baked", "slab"])
def test_fast_render_qualities_work_as_in_the_jax_testbed(tiny_testbeds, quality):
    """``render_quality`` "baked" and "slab" set on both Testbeds: their
    16² frames of training view 0 agree (≥ 45 dB; 100.2 and 80.9 dB
    measured), and ``free_temporary_memory`` drops the bake on both."""
    frames = []
    for tb in tiny_testbeds:
        tb.render_quality = quality
        tb.set_camera_to_training_view(0)
        try:
            frames.append(np.asarray(tb.render(16, 16)))
        finally:
            tb.render_quality = "exact"
    assert _psnr(*frames) >= 45.0
    attr = "_baked_cache" if quality == "baked" else "_slab_cache"
    for tb in tiny_testbeds:
        assert getattr(tb.task, attr) is not None
        tb.free_temporary_memory()
        assert tb.task._baked_cache is None and tb.task._slab_cache is None
