"""The ``Testbed`` and its pyngp surface (port of ``instant_ngp_tpu/testbed.py``):
train a NeRF scene from disk or an in-memory dataset, fit an image, fit a
mesh's signed-distance field, fit a density grid's neural volume, render
them through pyngp's ``render``, evaluate, save a snapshot, and load one to
render or to train on.

    tb = Testbed()  # on the card; device="cpu" runs the plain versions
    tb.load_training_data("scene_dir")  # a transforms.json scene, configs/nerf/base.json
    for _ in range(n):
        tb.frame()  # one training step; tb.loss is its EMA
    tb.save_snapshot("scene.ingp", include_optimizer_state=True)

    tb = Testbed()
    tb.load_snapshot("scene.ingp")  # no scene: cameras from the snapshot, render only
    tb.set_camera_to_training_view(0)
    frame = tb.render(1920, 1080, spp=8, linear=False)  # numpy (H, W, 4), sRGB
    tb.screenshot("shot.png", 1920, 1080, spp=4)
    tb.load_camera_path("path.json")
    frame = tb.render(1920, 1080, start_t=0.5, end_t=0.55)  # a frame of the path
    tb.render_mode = RenderMode.NORMALS  # depth, positions, ao, cost, ..., slice
    tb.compute_and_save_marching_cubes_mesh("scene.ply", resolution=(256, 256, 256))

    tb = Testbed()
    tb.load_training_data("scene_dir")
    tb.load_snapshot("scene.ingp")  # onto the scene: training continues

    tb = Testbed("nerf")
    tb.nerf_dataset, tb.network_config = ds, cfg
    tb.task = NerfTask(ds, cfg, "cuda", n_rays_per_batch=4096, ...)  # an in-memory set

    tb = Testbed("image")
    tb.reload_network_from_file("configs/image/base.json")
    tb.load_training_data("image.exr")  # .exr, .bin, or an LDR format
    for _ in range(n):
        tb.frame()
    frame = tb.render(1920, 1080)  # numpy (H, W, 4), linear unless linear=False
    mse = tb.compute_image_mse()
    tb.save_snapshot("image.ingp")  # loads back onto a Testbed holding the image

    tb = Testbed("sdf")
    tb.load_training_data("mesh.obj")  # .obj or .stl, configs/sdf/base.json
    for _ in range(n):
        tb.frame()  # one step on the batch producer's points
    iou = tb.calculate_iou()
    frame = tb.render(1920, 1080)  # sphere-traced, numpy (H, W, 4), linear
    tb.save_snapshot("mesh.ingp", include_optimizer_state=True)  # loads back onto the mesh

    tb = Testbed("volume")
    tb.load_training_data("cloud.nvdb")  # a NanoVDB float grid, configs/volume/base.json
    for _ in range(n):
        tb.frame()  # one step on a fresh delta-tracked batch
    mse = tb.task.compute_density_mse()
    frame = tb.render(1920, 1080)  # the learned field, numpy (H, W, 4), linear
    gt = tb.render(1920, 1080, ground_truth=True)  # a path trace of the grid
    tb.save_snapshot("cloud.ingp", include_optimizer_state=True)  # loads back onto the grid

Snapshots are the JAX package's format, key for key: each package reads
the other's.

``render`` takes pyngp's ``render_to_cpu`` arguments (width, height, spp,
linear, start_t, end_t, fps, shutter_fraction, camera_matrix, fov) and
returns the frame on the host; ``render_tensor`` returns the same frame as a
tensor on the task's device. A NeRF frame's camera is the Testbed's view:
``camera_matrix`` with ``fov`` and ``screen_center``, or a training view's
intrinsics after ``set_camera_to_training_view``; its background is
``background_color``, white by default, and its colour linear unless
``linear`` is False. ``NerfTask.render`` takes a camera and intrinsics of
its own and returns the task's colour on transparent black.

The window and VR calls are no-ops that warn, as in the JAX package: the
interactive surface is the web viewer (``python -m instant_ngp_torch.viewer``).
"""

from __future__ import annotations

import collections
import dataclasses
import math
import threading
import time
import warnings
from pathlib import Path

import numpy as np
import torch

from . import snapshot as snapshot_io
from .common import (
    BoundingBox,
    ColorSpace,
    GroundTruthRenderMode,
    Lens,
    LossType,
    MeshSdfMode,
    NerfActivation,
    RandomMode,
    RenderMode,
    TestbedMode,
    TonemapCurve,
    TrainMode,
    linear_to_srgb,
    srgb_to_linear,
)
from .config import default_config, load_network_config
from .image_fit.task import ImageTask
from .io.image import load_image, save_image
from .io.nerf_loader import NerfDataset, load_nerf
from .models import network as image_network
from .models import nerf_network
from .nerf.task import DISTORTION_SHAPE, NerfTask
from .ops.encodings import encoding_tables
from .ops.losses import loss_type_from_string
from .render.camera_path import CameraPath
from .render.camera_predictor import CameraPredictionMode, MatLogCameraPredictor
from .sdf.task import SdfTask
from .volume.task import VolumeTask

# the camera-optimization toggles a NeRF task takes when it is built
CAMERA_FLAGS = ("optimize_extrinsics", "optimize_exposure", "optimize_focal_length",
                "optimize_distortion")

# ROADMAP Queue 1's items that parts of the surface wait for: none is left
NOT_PORTED_ITEMS: dict[int, str] = {}


def mode_from_scene(path) -> TestbedMode:
    """reference common_host.cu:144-161."""
    p = Path(path)
    if p.is_dir() or p.suffix == ".json":
        return TestbedMode.NERF
    if p.suffix in (".obj", ".stl"):
        return TestbedMode.SDF
    if p.suffix in (".nvdb",):
        return TestbedMode.VOLUME
    if p.suffix.lower() in (".exr", ".png", ".jpg", ".jpeg", ".bmp", ".tga", ".bin"):
        return TestbedMode.IMAGE
    return TestbedMode.NONE


def _empty_nerf_dataset_from_snapshot(snap: dict) -> NerfDataset:
    """A render-ready dataset from the snapshot's dataset block: zero
    images, real cameras. Reads the reference json_binding schema and
    the older private block (raw f32 xforms/focals/principals)."""
    block = snap["nerf"]["dataset"]
    if "xforms" in block and not isinstance(block["xforms"], (bytes, bytearray)):
        ds = snapshot_io.dataset_from_json(block)
        if "aabb_scale" not in block and "aabb_scale" in snap["nerf"]:
            ds.aabb_scale = int(snap["nerf"]["aabb_scale"])
        return ds
    n = int(block["n_images"])
    w, h = block["resolution"]
    xforms = np.frombuffer(block["xforms"], np.float32).reshape(n, 3, 4).copy()
    focals = np.frombuffer(block["focals"], np.float32).reshape(n, 2).copy()
    pps = np.frombuffer(block["principals"], np.float32).reshape(n, 2).copy()
    return NerfDataset(
        images=np.zeros((n, h, w, 4), np.uint8),
        is_hdr=bool(block.get("is_hdr", False)),
        xforms_start=xforms,
        xforms_end=xforms.copy(),
        focal_lengths=focals,
        principal_points=pps,
        rolling_shutter=np.zeros((n, 4), np.float32),
        resolution=(int(w), int(h)),
        aabb_scale=int(snap["nerf"].get("aabb_scale", 1)),
        scale=float(block.get("scale", 0.33)),
        offset=np.asarray(block.get("offset", [0.5, 0.5, 0.5]), np.float32),
    )


def _home_camera() -> np.ndarray:
    return np.concatenate(
        [np.eye(3, dtype=np.float32), np.array([[0.5], [0.5], [-1.5]], np.float32)], axis=1)


class Ema:
    """EMA meter (reference common_host.h:83-129)."""

    def __init__(self, half_life: float = 50.0):
        self.alpha = 0.5 ** (1.0 / half_life)
        self.value = 0.0
        self.n = 0

    def update(self, v: float) -> None:
        self.value = self.alpha * self.value + (1 - self.alpha) * v if self.n else v
        self.n += 1

    def val(self) -> float:
        return self.value


class _ImageMetadata:
    """Per-image view of dataset metadata (pyngp's
    TrainingImageMetadata binding; python_api.cu:755-765)."""

    def __init__(self, ds: NerfDataset, i: int):
        if ds.per_image_resolution is not None:
            self.resolution = tuple(int(v) for v in ds.per_image_resolution[i])
        else:
            self.resolution = tuple(int(v) for v in ds.resolution)
        self.focal_length = tuple(float(v) for v in ds.focal_lengths[i])
        self.principal_point = tuple(float(v) for v in ds.principal_points[i])
        self.rolling_shutter = tuple(float(v) for v in np.asarray(ds.rolling_shutter[i]).reshape(4))
        self.lens = Lens(ds.lens_mode, ds.lens_params)
        self.camera_distortion = self.lens  # pyngp's older name (python_api.cu:757-758)
        self.light_dir = (1e4, 1e4, 1e4)  # the reference's default (unset)


class _DatasetView:
    """pyngp testbed.nerf.training.dataset (python_api.cu:880-930)."""

    def __init__(self, tb: "Testbed"):
        self._tb = tb

    @property
    def _ds(self) -> NerfDataset:
        return self._tb.nerf_dataset

    @property
    def n_images(self) -> int:
        return int(self._ds.n_images)

    @property
    def metadata(self):
        return [_ImageMetadata(self._ds, i) for i in range(self._ds.n_images)]

    @property
    def transforms(self):
        return np.asarray(self._ds.xforms_start, np.float32)

    @property
    def render_aabb(self) -> BoundingBox:
        if self._ds.render_aabb is None:
            return BoundingBox(np.zeros(3), np.ones(3))
        return BoundingBox(self._ds.render_aabb[0], self._ds.render_aabb[1])

    @property
    def up(self):
        return np.asarray(self._ds.up, np.float32)

    @property
    def offset(self):
        return np.asarray(self._ds.offset, np.float32)

    @property
    def scale(self) -> float:
        return float(self._ds.scale)

    @property
    def aabb_scale(self) -> int:
        return int(self._ds.aabb_scale)

    @property
    def from_mitsuba(self) -> bool:
        return bool(self._ds.from_mitsuba)

    @property
    def is_hdr(self) -> bool:
        return bool(self._ds.is_hdr)

    @property
    def envmap_resolution(self):
        """(w, h) of the task's trained environment map; (0, 0) without one."""
        task = self._tb.task
        if isinstance(task, NerfTask) and "envmap" in task.cam_offsets:
            eh, ew = task.cam_offsets["envmap"].shape[:2]
            return (ew, eh)
        return (0, 0)

    @property
    def render_aabb_to_local(self):
        m = self._ds.render_aabb_to_local
        return np.eye(3, dtype=np.float32) if m is None else np.asarray(m, np.float32)

    @property
    def paths(self):
        return list(self._ds.paths)


class _NerfTrainingView:
    """pyngp testbed.nerf.training.* (python_api.cu Testbed::Nerf::Training).
    Settings made before a scene is loaded are queued and applied when its
    task is built."""

    def __init__(self, tb: "Testbed"):
        self._tb = tb

    @property
    def dataset(self) -> _DatasetView:
        return _DatasetView(self._tb)

    def _task(self) -> NerfTask | None:
        task = self._tb.task
        return task if isinstance(task, NerfTask) else None

    def _get(self, attr: str, pending: str, default):
        task = self._task()
        return getattr(task, attr) if task is not None else self._tb._nerf_pending.get(
            pending, default)

    def _set(self, attr: str, pending: str, v) -> None:
        task = self._task()
        if task is not None:
            setattr(task, attr, v)
        else:
            self._tb._nerf_pending[pending] = v

    near_distance = property(lambda s: s._get("training_near_distance", "near_distance", 0.1),
                             lambda s, v: s._set("training_near_distance", "near_distance",
                                                 float(v)))
    random_bg_color = property(lambda s: s._get("random_bg_color", "random_bg_color", True),
                               lambda s, v: s._set("random_bg_color", "random_bg_color", bool(v)))
    density_grid_decay = property(
        lambda s: s._get("density_grid_decay", "density_grid_decay", 0.95),
        lambda s, v: s._set("density_grid_decay", "density_grid_decay", float(v)))
    sample_image_proportional_to_error = property(
        lambda s: s._get("sample_image_proportional_to_error",
                         "sample_image_proportional_to_error", True),
        lambda s, v: s._set("sample_image_proportional_to_error",
                            "sample_image_proportional_to_error", bool(v)))
    sample_focal_plane_proportional_to_error = property(
        lambda s: s._get("sample_focal_plane_proportional_to_error",
                         "sample_focal_plane_proportional_to_error", True),
        lambda s, v: s._set("sample_focal_plane_proportional_to_error",
                            "sample_focal_plane_proportional_to_error", bool(v)))

    @property
    def train_mode(self) -> TrainMode:
        return TrainMode(self._get("train_mode", "train_mode", "nerf"))

    @train_mode.setter
    def train_mode(self, v) -> None:
        self._set("train_mode", "train_mode", TrainMode(getattr(v, "value", v)).value)

    @property
    def n_images_for_training(self) -> int:
        return self.dataset.n_images

    @property
    def loss_type(self) -> LossType:
        """pyngp nerf.training.loss_type (python_api.cu:785)."""
        task = self._task()
        if task is None:
            return loss_type_from_string(self._tb._nerf_pending.get("loss_type", "huber"))
        return task.loss_type

    @loss_type.setter
    def loss_type(self, v) -> None:
        loss = loss_type_from_string(str(getattr(v, "name", v)))
        self._set("loss_type", "loss_type", loss if self._task() is not None else loss.value)

    @property
    def linear_colors(self) -> bool:
        """pyngp nerf.training.linear_colors (python_api.cu:784): HDR scenes
        train in linear colour, LDR ones in sRGB (read-only, chosen by the
        dataset, testbed_nerf.cu:2354)."""
        ds = self._tb.nerf_dataset
        return bool(ds.is_hdr) if ds is not None else False

    def get_camera_extrinsics(self, frame_idx: int) -> np.ndarray:
        """3×4 camera-to-world of a training view in the source (nerf)
        convention (testbed_nerf.cu:2287-2292); identity out of range."""
        task = self._task()
        if task is None:
            raise RuntimeError("load a NeRF scene first")
        ds = task.dataset
        i = int(frame_idx)
        if not 0 <= i < ds.n_images:
            return np.eye(3, 4, dtype=np.float32)
        return ds.ngp_matrix_to_nerf(np.asarray(ds.xforms_start[i], np.float32))

    def set_image(self, frame_idx: int, img, depth_img=None, depth_scale: float = 1.0) -> None:
        """pyngp testbed.nerf.training.set_image (python_api.cu:45-72): replace
        a training image, float (H, W, 4) in the dataset's training colour
        space, and where given its depth map (scaled by ``depth_scale`` and
        the scene scale), at run time (task.py:1337-1367)."""
        task = self._task()
        if task is None:
            raise RuntimeError("load a NeRF scene before set_image")
        task.set_training_image(frame_idx, img, depth_img, depth_scale)

    def reset_camera_extrinsics(self) -> None:
        """pyngp reset_camera_extrinsics (testbed_nerf.cu:2215-2227): zero the
        trained pose and exposure offsets, the camera optimizer made anew."""
        task = self._task()
        if task is not None:
            task.reset_camera_extrinsics()

    def get_extra_dims(self, view: int) -> np.ndarray:
        """pyngp get_extra_dims (python_api.cu:810-813): a training view's
        trained latent code; empty where the scene has none."""
        return self._scene_task().get_extra_dims(view)

    def _scene_task(self) -> NerfTask:
        task = self._task()
        if task is None:
            raise RuntimeError("load a NeRF scene first")
        return task

    def set_camera_intrinsics(self, frame_idx: int, fx: float = 0.0, fy: float = 0.0,
                              cx: float = -0.5, cy: float = -0.5, k1: float = 0.0,
                              k2: float = 0.0, p1: float = 0.0, p2: float = 0.0, k3: float = 0.0,
                              k4: float = 0.0, is_fisheye: bool = False) -> None:
        """pyngp set_camera_intrinsics (python_api.cu:815-831)."""
        self._scene_task().set_camera_intrinsics(frame_idx, fx, fy, cx, cy, k1, k2, p1, p2, k3,
                                                 k4, is_fisheye)

    def set_camera_extrinsics(self, frame_idx: int, camera_to_world,
                              convert_to_ngp: bool = True) -> None:
        """pyngp set_camera_extrinsics (python_api.cu:832-839)."""
        self._scene_task().set_camera_extrinsics(frame_idx, camera_to_world,
                                                 convert_to_ngp=convert_to_ngp)

    def _opt_flag(self, name: str) -> bool:
        return bool(self._get(name, name, False))

    def _set_opt_flag(self, name: str, v) -> None:
        """Camera-optimization toggles (python_api.cu:791-800): turning
        ``optimize_distortion`` on gives the task a zero map where it has
        none, and the camera optimizer's state is made anew."""
        task = self._task()
        self._set(name, name, bool(v))
        if (task is not None and name == "optimize_distortion" and v
                and "distortion" not in task.cam_offsets):
            task.cam_offsets["distortion"] = torch.zeros(DISTORTION_SHAPE, dtype=torch.float32,
                                                         device=task.device)
            task.state.cam_opt = None

    optimize_extrinsics = property(lambda s: s._opt_flag("optimize_extrinsics"),
                                   lambda s, v: s._set_opt_flag("optimize_extrinsics", v))
    optimize_exposure = property(lambda s: s._opt_flag("optimize_exposure"),
                                 lambda s, v: s._set_opt_flag("optimize_exposure", v))
    optimize_focal_length = property(lambda s: s._opt_flag("optimize_focal_length"),
                                     lambda s, v: s._set_opt_flag("optimize_focal_length", v))
    optimize_distortion = property(lambda s: s._opt_flag("optimize_distortion"),
                                   lambda s, v: s._set_opt_flag("optimize_distortion", v))
    # the reference binds the latents' toggle under two names (python_api.cu:789-792)
    optimize_extra_dims = property(
        lambda s: s._opt_flag("optimize_extra_dims"),
        lambda s, v: s._set("optimize_extra_dims", "optimize_extra_dims", bool(v)))
    optimize_per_image_latents = optimize_extra_dims
    n_steps_between_cam_updates = property(
        lambda s: s._get("n_steps_between_cam_updates", "n_steps_between_cam_updates", 16),
        lambda s, v: s._set("n_steps_between_cam_updates", "n_steps_between_cam_updates",
                            int(v)))
    exposure_l2_reg = property(
        lambda s: s._get("exposure_l2_reg", "exposure_l2_reg", 0.0),
        lambda s, v: s._set("exposure_l2_reg", "exposure_l2_reg", float(v)))
    intrinsic_l2_reg = property(
        lambda s: s._get("intrinsic_l2_reg", "intrinsic_l2_reg", 1e-4),
        lambda s, v: s._set("intrinsic_l2_reg", "intrinsic_l2_reg", float(v)))

    @property
    def extrinsic_learning_rate(self) -> float:
        """The camera's rate per n_steps_between_cam_updates steps."""
        task = self._task()
        if task is None:
            return self._tb._nerf_pending.get("extrinsic_learning_rate", 1e-3)
        return float(task.cam_opt_spec.learning_rate
                     * max(int(task.n_steps_between_cam_updates), 1))

    @extrinsic_learning_rate.setter
    def extrinsic_learning_rate(self, v) -> None:
        task = self._task()
        if task is None:
            self._tb._nerf_pending["extrinsic_learning_rate"] = float(v)
        else:
            task.set_camera_optimizer_hparams(extrinsic_learning_rate=float(v))

    @property
    def extrinsic_l2_reg(self) -> float:
        task = self._task()
        if task is None:
            return self._tb._nerf_pending.get("extrinsic_l2_reg", 1e-4)
        return float(task.cam_opt_spec.l2_reg)

    @extrinsic_l2_reg.setter
    def extrinsic_l2_reg(self, v) -> None:
        task = self._task()
        if task is None:
            self._tb._nerf_pending["extrinsic_l2_reg"] = float(v)
        else:
            task.set_camera_optimizer_hparams(extrinsic_l2_reg=float(v))

    @property
    def include_sharpness_in_error(self) -> bool:
        return bool(self._get("include_sharpness_in_error", "include_sharpness_in_error", False))

    @include_sharpness_in_error.setter
    def include_sharpness_in_error(self, v) -> None:
        """pyngp include_sharpness_in_error: the sharpness maps and the sharp
        grid are made with the task, so it is set before load_training_data."""
        task = self._task()
        if task is not None and bool(v) != task.include_sharpness_in_error:
            raise RuntimeError("include_sharpness_in_error must be set before "
                               "load_training_data (it allocates the sharpness maps)")
        self._tb._nerf_pending["include_sharpness_in_error"] = bool(v)

    depth_supervision_lambda = property(
        lambda s: s._get("depth_supervision_lambda", "depth_supervision_lambda", 0.0),
        lambda s, v: s._set("depth_supervision_lambda", "depth_supervision_lambda", float(v)))

    @property
    def depth_loss_type(self) -> str:
        """pyngp depth_loss_type (python_api.cu:786; default L1)."""
        return self._get("depth_loss_type", "depth_loss_type", "L1")

    @depth_loss_type.setter
    def depth_loss_type(self, v) -> None:
        name = str(getattr(v, "name", v))
        loss_type_from_string(name)
        self._set("depth_loss_type", "depth_loss_type", name)

    def set_camera_extrinsics_rolling_shutter(self, frame_idx: int, camera_to_world_start,
                                              camera_to_world_end, rolling_shutter,
                                              convert_to_ngp: bool = True) -> None:
        """pyngp set_camera_extrinsics_rolling_shutter (testbed_nerf.cu:2188-2209):
        a training view's start and end transforms and its rolling shutter."""
        self._scene_task().set_camera_extrinsics(frame_idx, camera_to_world_start,
                                                 convert_to_ngp=convert_to_ngp,
                                                 xform_end=camera_to_world_end,
                                                 rolling_shutter=rolling_shutter)


class _NerfView:
    """pyngp testbed.nerf.* (python_api.cu:520-620)."""

    def __init__(self, tb: "Testbed"):
        self._tb = tb
        self.training = _NerfTrainingView(tb)
        self.sharpen = 0.0  # the 3×3 unsharp mask of a render (render_buffer.cu)
        # G-buffer modes shade the raw surface value (python_api.cu:723);
        # kept for the surface, the port renders shade mode only
        self.render_gbuffer_hard_edges = False

    def _task(self) -> NerfTask:
        task = self._tb.task
        if not isinstance(task, NerfTask):
            raise RuntimeError("load a NeRF scene first")
        return task

    @property
    def render_min_transmittance(self) -> float:
        return self._tb.nerf_min_transmittance

    @render_min_transmittance.setter
    def render_min_transmittance(self, v) -> None:
        self._tb.nerf_min_transmittance = float(v)

    @property
    def rgb_activation(self):
        task = self._tb.task
        return task.rgb_activation if isinstance(task, NerfTask) else None

    @rgb_activation.setter
    def rgb_activation(self, v) -> None:
        self._task().rgb_activation = NerfActivation(getattr(v, "value", v))

    @property
    def density_activation(self):
        task = self._tb.task
        return task.density_activation if isinstance(task, NerfTask) else None

    @density_activation.setter
    def density_activation(self, v) -> None:
        self._task().density_activation = NerfActivation(getattr(v, "value", v))

    @property
    def cone_angle_constant(self) -> float:
        task = self._tb.task
        if isinstance(task, NerfTask):
            return task.march_cfg.cone_angle
        return self._tb._nerf_pending.get("cone_angle_constant", 1.0 / 256.0)

    @cone_angle_constant.setter
    def cone_angle_constant(self, v) -> None:
        task = self._tb.task
        if isinstance(task, NerfTask):
            _set_cone_angle(task, float(v))
        else:
            self._tb._nerf_pending["cone_angle_constant"] = float(v)

    def find_closest_training_view(self, pose=None) -> int:
        """pyngp find_closest_training_view (testbed_nerf.cu:3710-3723): the
        training view nearest the current (or given) camera by position
        distance + 0.25 × z-axis distance, over the offset cameras."""
        return self._task().find_closest_training_view(
            self._tb.camera_matrix if pose is None else pose)

    def get_rendering_extra_dims(self) -> np.ndarray:
        """The latent vector renders condition on (python_api.cu:741-743)."""
        task = self._tb.task
        vec = task.render_extra_vec() if isinstance(task, NerfTask) else None
        return np.zeros((0,), np.float32) if vec is None else vec.cpu().numpy()

    @property
    def rendering_extra_dims_from_training_view(self) -> int:
        task = self._tb.task
        if isinstance(task, NerfTask):
            return task.rendering_extra_dims_from_training_view
        return self._tb._nerf_pending.get("rendering_extra_dims_from_training_view", 0)

    @rendering_extra_dims_from_training_view.setter
    def rendering_extra_dims_from_training_view(self, v) -> None:
        task = self._tb.task
        if isinstance(task, NerfTask):
            task.rendering_extra_dims_from_training_view = int(v)
        else:
            self._tb._nerf_pending["rendering_extra_dims_from_training_view"] = int(v)

    def set_rendering_extra_dims_from_training_view(self, i: int) -> None:
        """Render with training view i's latents (python_api.cu:735-745)."""
        self.rendering_extra_dims_from_training_view = int(i)

    def set_rendering_extra_dims(self, vals) -> None:
        """Render with an explicit latent vector (python_api.cu:725-733)."""
        task = self._tb.task
        if isinstance(task, NerfTask):
            task.set_rendering_extra_dims(vals)
        else:
            self._tb._nerf_pending["rendering_extra_dims"] = vals


def _set_cone_angle(task: NerfTask, cone_angle: float) -> None:
    task.cone_angle = cone_angle
    task.march_cfg = dataclasses.replace(task.march_cfg, cone_angle=cone_angle)


class _SdfTrainingView:
    """pyngp testbed.sdf.training (python_api.cu:869-871)."""

    def __init__(self, tb: "Testbed"):
        object.__setattr__(self, "_tb", tb)

    @property
    def generate_sdf_data_online(self) -> bool:
        task = self._tb.task
        return isinstance(task, SdfTask) and task.override is None

    @property
    def surface_offset_scale(self) -> float:
        task = self._tb.task
        return task.surface_offset_scale if isinstance(task, SdfTask) else 1.0

    @surface_offset_scale.setter
    def surface_offset_scale(self, v) -> None:
        self._tb.task.surface_offset_scale = float(v)


class _SdfView:
    """pyngp testbed.sdf.* (python_api.cu:855-867). The names of ``_FWD``
    forward to the SdfTask's knobs; reads before a mesh is loaded give the
    reference's defaults."""

    _FWD = ("analytic_normals", "shadow_sharpness", "fd_normals_epsilon", "zero_offset", "brdf",
            "floor_enable", "sun_color", "groundtruth_mode")
    _DEFAULTS = {"analytic_normals": True, "shadow_sharpness": 16.0, "fd_normals_epsilon": 1e-3,
                 "zero_offset": 0.0, "brdf": None, "floor_enable": False,
                 "sun_color": (1.0, 1.0, 1.0), "groundtruth_mode": "raytracedmesh"}

    def __init__(self, tb: "Testbed"):
        object.__setattr__(self, "_tb", tb)
        object.__setattr__(self, "training", _SdfTrainingView(tb))

    def _task(self) -> SdfTask | None:
        return self._tb.task if self._tb.mode == TestbedMode.SDF else None

    def __getattr__(self, name):
        if name in self._FWD:
            task = self._task()
            return getattr(task, name) if task else self._DEFAULTS[name]
        raise AttributeError(name)

    def __setattr__(self, name, value):
        if name in self._FWD:
            task = self._task()
            if task is None:
                raise RuntimeError(f"load an SDF scene before setting {name}")
            setattr(task, name, value)
        else:
            object.__setattr__(self, name, value)

    def __dir__(self):
        return [*super().__dir__(), *self._FWD]

    @property
    def mesh_sdf_mode(self) -> MeshSdfMode:
        task = self._task()
        return MeshSdfMode(task.sdf_mode if task else "pseudonormal")

    @mesh_sdf_mode.setter
    def mesh_sdf_mode(self, v) -> None:
        self._task().sdf_mode = MeshSdfMode(getattr(v, "value", v)).value

    @property
    def mesh_scale(self) -> float:
        task = self._task()
        return float(task.mesh_scale) if task else 1.0

    @property
    def use_triangle_octree(self) -> bool:
        task = self._task()
        return bool(task is not None and task.octree is not None)

    @property
    def calculate_iou_online(self) -> bool:
        return self._tb.calculate_iou_online

    @calculate_iou_online.setter
    def calculate_iou_online(self, v) -> None:
        self._tb.calculate_iou_online = bool(v)


class _ImageView:
    """pyngp testbed.image.* (python_api.cu:874-880)."""

    def __init__(self, tb: "Testbed"):
        self._tb = tb
        self.training = _ImageTrainingView(tb)

    @property
    def random_mode(self) -> RandomMode:
        task = self._tb.task if self._tb.mode == TestbedMode.IMAGE else None
        return RandomMode(task.random_mode if task else "stratified")

    @random_mode.setter
    def random_mode(self, v) -> None:
        self._tb.task.random_mode = RandomMode(v).value


class _ImageTrainingView:
    """pyngp testbed.image.training.*."""

    def __init__(self, tb: "Testbed"):
        self._tb = tb

    @property
    def snap_to_pixel_centers(self) -> bool:
        return self._tb.task.snap_to_pixel_centers if self._tb.task else False

    @snap_to_pixel_centers.setter
    def snap_to_pixel_centers(self, v) -> None:
        self._tb.task.snap_to_pixel_centers = bool(v)

    @property
    def linear_colors(self) -> bool:
        return self._tb.task.linear_colors if self._tb.task else False

    @linear_colors.setter
    def linear_colors(self, v) -> None:
        self._tb.task.linear_colors = bool(v)


def _unsharp(frame: torch.Tensor, amount: float) -> torch.Tensor:
    """3×3 unsharp mask on the rgb channels, edges replicated (the
    reference's ``sharpen`` in the tonemap stage, render_buffer.cu)."""
    rgb = frame[..., :3]
    h, w = rgb.shape[:2]
    ys = torch.clamp(torch.arange(-1, h + 1, device=frame.device), 0, h - 1)
    xs = torch.clamp(torch.arange(-1, w + 1, device=frame.device), 0, w - 1)
    pad = rgb[ys][:, xs]
    blur = (pad[:-2, :-2] + pad[:-2, 1:-1] + pad[:-2, 2:] + pad[1:-1, :-2] + pad[1:-1, 1:-1]
            + pad[1:-1, 2:] + pad[2:, :-2] + pad[2:, 1:-1] + pad[2:, 2:]) / 9.0
    return torch.cat([rgb + amount * (rgb - blur), frame[..., 3:]], dim=-1)


def premultiplied_srgb(img: np.ndarray) -> np.ndarray:
    """An LDR image's straight-alpha sRGB (H, W, 4) in [0, 1] → its rgb
    premultiplied by alpha in linear colour and back in sRGB: the ground
    truth of a render on black (``scripts/run.py``'s evaluation and the
    JAX package's ``render_gt_view``)."""
    rgb = torch.from_numpy(np.ascontiguousarray(img[..., :3], np.float32))
    alpha = torch.from_numpy(np.ascontiguousarray(img[..., 3:4], np.float32))
    return linear_to_srgb(srgb_to_linear(rgb) * alpha).numpy()


def _resample_nearest(frame: np.ndarray, width: int, height: int) -> np.ndarray:
    """Nearest-pixel resample of an (h, w, C) image to (height, width, C)."""
    h, w = frame.shape[:2]
    ys = np.clip((np.arange(height) + 0.5) * h / height, 0, h - 1).astype(int)
    xs = np.clip((np.arange(width) + 0.5) * w / width, 0, w - 1).astype(int)
    return frame[ys][:, xs]


_PORTED_MODES = (TestbedMode.NERF, TestbedMode.IMAGE, TestbedMode.SDF, TestbedMode.VOLUME)


class Testbed:
    """Modes "nerf", "image", "sdf" and "volume" ("none" until
    ``load_training_data`` or ``load_snapshot`` sets the mode). Work runs on
    ``device``, the card unless the caller asks for the CPU. The fields are
    pyngp's (python_api.cu:439-870), with the JAX package's defaults
    (testbed.py:842-968)."""

    def __init__(self, mode: TestbedMode | str = TestbedMode.NONE, device="cuda"):
        mode = TestbedMode(mode.lower()) if isinstance(mode, str) else mode
        if mode not in (TestbedMode.NONE, *_PORTED_MODES):
            raise NotImplementedError(f"testbed mode {mode.value!r} is not ported yet")
        self.mode = mode
        self.device = torch.device(device)
        self.task: NerfTask | ImageTask | SdfTask | VolumeTask | None = None
        self.nerf_dataset: NerfDataset | None = None
        self.network_config: dict = {}
        self.network_config_path: Path | None = None
        self.scene_path: str | None = None

        self.shall_train = True
        self.training_step = 0
        self.training_batch_size = 1 << 18
        self.background_color = np.array([1.0, 1.0, 1.0, 1.0], np.float32)
        self.fov = 50.625
        self.seed = 1337
        self.nerf_min_transmittance = 1e-4
        self.snap_to_pixel_centers = True
        self.dynamic_res = False
        self.dynamic_res_target_fps = 20.0
        self.camera_matrix = _home_camera()  # a scene's first training camera once loaded
        self.scale = 1.5
        self.loss_graph: list[float] = []
        self.render_ground_truth = False
        self.color_space = ColorSpace.SRGB
        self.tonemap_curve = TonemapCurve.IDENTITY  # SDF and volume renders
        self.exposure = 0.0
        self.fov_axis = 1
        self.camera_smoothing = False
        self.render_with_lens_distortion = True
        self.render_quality = "exact"  # or "fast", "baked", "slab"
        self.render_mode = RenderMode.SHADE
        self.slice_plane_z = 0.0
        self.autofocus = False  # m_autofocus: focus at the crop box's centre
        self.mesh_thresh = 2.5  # the NeRF density of exported surfaces
        self.screen_center = (0.5, 0.5)  # the principal point of a free camera
        self.fixed_res_factor = 8  # render factor 8 / this when dynamic_res is off
        self.render_transparency_as_checkerboard = False
        self.bounding_radius = 1.0
        self.jit_fusion = True  # pyngp's NVRTC toggle; the kernels here are built ahead
        self.is_rendering = True
        self.calculate_iou_online = False  # SDF: the IoU every 16 frames into sdf_iou
        self.sdf_iou: float | None = None
        self.camera_path = CameraPath()
        self.record_camera_path = False
        self.camera_prediction_mode = CameraPredictionMode.NONE
        self._cam_predictor: MatLogCameraPredictor | None = None
        self._cam_predictor_mode = None
        self.parallax_shift = np.zeros(3, np.float32)
        self.visualized_dimension = 0
        self.visualized_layer = 0
        self.groundtruth_render_mode = GroundTruthRenderMode.SHADE
        self.visualize_unit_cube = False
        self.visualize_cameras = False
        self.zoom = 1.0
        self.up_dir = np.array([0.0, 1.0, 0.0], np.float32)
        self.sun_dir = np.array([0.577, -0.577, 0.577], np.float32)  # the SDF light
        self.floor_enable = False
        self.display_gui = True
        self.root_dir = str(Path(__file__).resolve().parents[1])
        self._last_frame: np.ndarray | None = None
        self._smoothed_cam: np.ndarray | None = None
        self._last_frame_t: float | None = None
        self._fov_x: float | None = None
        self._accum_buffer = None
        self._dyn_res = None
        self._spp_warned = False
        self._nerf_pending: dict = {}
        self._pend_train_enc: bool | None = None
        self._pend_train_net: bool | None = None
        self.nerf = _NerfView(self)
        self.sdf = _SdfView(self)
        self.image = _ImageView(self)
        self._view_index: int | None = None

        # timing meters (reference testbed.h:1023-1027)
        self.training_prep_ms = Ema()
        self.training_ms = Ema()
        self.render_ms = Ema()
        self.frame_ms = Ema()
        self._loss_ema = Ema(half_life=10.0)

        # callables posted from other threads, run at the start of the next
        # frame() on the thread that calls it (reference m_task_queue,
        # testbed.h:735, drained in frame, testbed.cu:3969-3973)
        self._task_queue: collections.deque = collections.deque()
        self._task_queue_lock = threading.Lock()

    # --- depth of field (testbed.py:1417-1422, 1762-1775) ---
    @property
    def aperture_size(self) -> float:
        return float(getattr(self.task, "aperture_size", 0.0))

    @aperture_size.setter
    def aperture_size(self, v: float) -> None:
        self.task.aperture_size = float(v)

    @property
    def dof(self) -> float:
        """pyngp dof ≡ the aperture size (python_api.cu:631)."""
        return self.aperture_size

    @dof.setter
    def dof(self, v: float) -> None:
        self.aperture_size = float(v)

    @property
    def autofocus_target(self) -> float:
        """The focus distance ``NerfTask.focus_z``."""
        return getattr(self.task, "focus_z", 1.0)

    @autofocus_target.setter
    def autofocus_target(self, v) -> None:
        self.task.focus_z = float(v)

    @property
    def max_level_rand_training(self) -> bool:
        """Train each ray at a random coarse-to-fine level cap (task.py:849)."""
        return bool(getattr(self.task, "max_level_rand_training", False))

    @max_level_rand_training.setter
    def max_level_rand_training(self, v) -> None:
        self.task.max_level_rand_training = bool(v)

    # --- the GUI's calls (testbed.py:2024-2043): no window exists ---
    def init_window(self, width: int, height: int, second_window: bool = False,
                    hidden: bool = False) -> None:
        """A no-op that warns, as in the JAX package: the interactive surface
        is the web viewer. Keeps scripts that pass --gui running."""
        warnings.warn("init_window is a no-op in the port; use `python -m "
                      "instant_ngp_torch.viewer` for interactive viewing")
        self._window_res = (int(width), int(height))

    def init_vr(self) -> None:
        """A no-op that warns: there is no OpenXR here."""
        warnings.warn("init_vr is a no-op in the port (no OpenXR)")

    def destroy_window(self) -> None:
        self._window_res = None

    def post_task(self, fn) -> threading.Event:
        """Queue a callable for the start of the next ``frame()`` on the
        thread that calls it. Returns an Event set once it has run."""
        done = threading.Event()
        with self._task_queue_lock:
            self._task_queue.append((fn, done))
        return done

    def _drain_task_queue(self) -> None:
        while True:
            with self._task_queue_lock:
                if not self._task_queue:
                    return
                fn, done = self._task_queue.popleft()
            try:
                fn()
            finally:
                done.set()

    # --- loading ---
    def load_file(self, path) -> None:
        """A snapshot → ``load_snapshot``; anything else is training data
        (reference load_file, testbed.cu:353-411)."""
        if Path(path).suffix in (".ingp", ".msgpack"):
            self.load_snapshot(path)
        else:
            self.load_training_data(path)

    def load_training_data(self, path) -> None:
        mode = mode_from_scene(path)
        if mode == TestbedMode.NONE:
            raise ValueError(f"cannot infer mode from scene path {path}")
        self.scene_path = str(path)
        self.mode = mode
        if not self.network_config:
            self.network_config = default_config(mode.value)
        self._build_task()

    def reload_network_from_file(self, config_path) -> None:
        self.network_config_path = Path(config_path)
        mode = self.mode.value if self.mode != TestbedMode.NONE else None
        self.network_config = load_network_config(config_path, mode=mode)
        if self.scene_path:
            self._build_task()

    def reload_network_from_json(self, config: dict) -> None:
        self.network_config = dict(config)
        if self.scene_path:
            self._build_task()

    def _build_task(self) -> None:
        """A fresh task on the scene (testbed.py:1026-1113): an image, a mesh,
        a density grid (its own batch size, 2^17, as the JAX package's), or a
        NeRF scene whose first training camera becomes the view and which
        takes the knobs set on ``nerf.training`` before it loaded."""
        if isinstance(self.task, SdfTask):
            self.task.stop_producer()
        if self.mode == TestbedMode.SDF:
            self.task = SdfTask(self.scene_path, self.network_config, device=self.device,
                                seed=self.seed)
        elif self.mode == TestbedMode.VOLUME:
            self.task = VolumeTask(self.scene_path, self.network_config, device=self.device,
                                   seed=self.seed)
        elif self.mode == TestbedMode.NERF:
            self.nerf_dataset = load_nerf(self.scene_path)
            pend = self._nerf_pending
            # train_envmap: set on the Testbed before the load (testbed.py:1054)
            self.task = NerfTask(self.nerf_dataset, self.network_config, self.device,
                                 seed=self.seed, target_batch_size=self.training_batch_size,
                                 train_envmap=bool(getattr(self, "train_envmap", False)),
                                 include_sharpness_in_error=bool(
                                     pend.get("include_sharpness_in_error", False)),
                                 **{k: bool(pend.get(k, False)) for k in CAMERA_FLAGS})
            self.camera_matrix = self.nerf_dataset.xforms_start[0].copy()
            pend = self._nerf_pending
            for key, attr in (("near_distance", "training_near_distance"),
                              ("random_bg_color", "random_bg_color"),
                              ("density_grid_decay", "density_grid_decay"),
                              ("sample_image_proportional_to_error",
                               "sample_image_proportional_to_error"),
                              ("sample_focal_plane_proportional_to_error",
                               "sample_focal_plane_proportional_to_error")):
                if key in pend:
                    setattr(self.task, attr, pend[key])
            if "cone_angle_constant" in pend:
                _set_cone_angle(self.task, pend["cone_angle_constant"])
            if "loss_type" in pend:
                self.task.loss_type = loss_type_from_string(pend["loss_type"])
            for key in ("train_mode", "optimize_extra_dims", "n_steps_between_cam_updates",
                        "exposure_l2_reg", "intrinsic_l2_reg",
                        "rendering_extra_dims_from_training_view", "depth_supervision_lambda",
                        "depth_loss_type"):
                if key in pend:
                    setattr(self.task, key, pend[key])
            if "extrinsic_learning_rate" in pend or "extrinsic_l2_reg" in pend:
                self.task.set_camera_optimizer_hparams(
                    extrinsic_learning_rate=pend.get("extrinsic_learning_rate"),
                    extrinsic_l2_reg=pend.get("extrinsic_l2_reg"))
            if "rendering_extra_dims" in pend:
                self.task.set_rendering_extra_dims(pend["rendering_extra_dims"])
        else:
            img, is_hdr = load_image(self.scene_path)
            self.task = ImageTask(img, is_hdr, self.network_config, device=self.device,
                                  seed=self.seed, batch_size=self.training_batch_size)
        if self._pend_train_enc is not None:
            self.task.shall_train_encoding = self._pend_train_enc
        if self._pend_train_net is not None:
            self.task.shall_train_network = self._pend_train_net
        self.training_step = 0

    # --- the heartbeat ---
    def frame(self) -> bool:
        """One tick (reference frame → train_and_render, testbed.cu:
        3908-4034): the posted callables, a training step while
        ``shall_train`` (a step that marched no sample stops training), the
        IoU every 16 SDF frames if asked, the camera predictor's pose feed,
        and the camera path's recording or playback."""
        t0 = time.perf_counter()
        self._drain_task_queue()
        if self.shall_train and self.task is not None:
            t_train = time.perf_counter()
            loss = self.task.train(1)
            self.training_ms.update((time.perf_counter() - t_train) * 1000.0)
            self.training_step = self.task.training_step
            self._loss_ema.update(loss)
            self.loss_graph.append(loss)
            if getattr(self.task, "training_aborted", False):
                self.shall_train = False
            if (self.calculate_iou_online and self.mode == TestbedMode.SDF
                    and self.training_step % 16 == 0):
                self.sdf_iou = float(self.task.calculate_iou(1 << 14))
        mode = self.camera_prediction_mode
        if mode == CameraPredictionMode.NONE:
            self._cam_predictor = None
        else:
            if self._cam_predictor is None or self._cam_predictor_mode != mode:
                self._cam_predictor = MatLogCameraPredictor(is_quadratic="quadratic" in mode.value,
                                                            is_se3="se3" in mode.value)
                self._cam_predictor_mode = mode
            self._cam_predictor.sample_camera(self.camera_matrix,
                                              max(self.frame_ms.val(), 1.0) / 1000.0)
        cp = self.camera_path
        # wall time since the previous tick
        now = time.perf_counter()
        dt = min(now - (self._last_frame_t if self._last_frame_t is not None else now), 1.0)
        self._last_frame_t = now
        if self.record_camera_path:
            cp.add_camera(self.camera_matrix, fov=self.fov,
                          timestamp=(len(cp.keyframes) + 1) / 30.0)
            cp.duration_seconds = cp.keyframes[-1].timestamp
        elif cp.update_cam_from_path and not cp.empty():
            cp.play_time += cp.auto_play_speed * dt
            cp.play_time = cp.play_time % 1.0 if cp.loop else min(cp.play_time, 1.0)
            kf = cp.eval_camera_path(cp.play_time)
            self.camera_matrix = np.asarray(kf.to_matrix(), np.float32)
            self.fov = float(kf.fov)
            self._view_index = None
        self.frame_ms.update((time.perf_counter() - t0) * 1000.0)
        return True

    def train(self, batch_size=None) -> None:
        self.frame()

    @property
    def loss(self) -> float:
        return self._loss_ema.value

    # --- rendering (pyngp render_to_cpu, python_api.cu:100-170) ---
    def render(self, width: int, height: int, spp: int = 1, linear: bool = True,
               start_t: float = -1.0, end_t: float = -1.0, fps: float = 30.0,
               shutter_fraction: float = 0.5, camera_matrix=None, fov=None,
               **kwargs) -> np.ndarray:
        """The frame of ``render_tensor`` as a numpy (H, W, 4) f32 array."""
        return self.render_tensor(width, height, spp, linear, start_t, end_t, fps,
                                  shutter_fraction, camera_matrix, fov, **kwargs).cpu().numpy()

    def render_tensor(self, width: int, height: int, spp: int = 1, linear: bool = True,
                      start_t: float = -1.0, end_t: float = -1.0, fps: float = 30.0,
                      shutter_fraction: float = 0.5, camera_matrix=None, fov=None,
                      ground_truth: bool = False) -> torch.Tensor:
        """A frame (H, W, 4) f32 on the task's device (testbed.py:1196-1395).
        ``start_t`` ≥ 0 with a loaded camera path first moves the view to the
        path at start_t + (end_t − start_t)·shutter_fraction. NeRF: the
        task's render at ``spp`` from the view (a training view's intrinsics,
        its focal length scaled by (width, height)[fov_axis] /
        resolution[fov_axis], else ``fov`` and ``screen_center``; ``zoom``) on
        ``background_color``, or the training image of the view with
        ``render_ground_truth``; the unsharp mask of ``nerf.sharpen``. Image:
        the fit, alpha 1. SDF: the sphere trace from the view with
        ``sun_dir`` and ``floor_enable``; volume: the learned field, or with
        ``ground_truth`` a path trace of the grid; both tonemapped by
        ``tonemap_curve`` (spp has no effect on them). Then, in that order:
        the colour space (linear, or sRGB if ``linear`` is False),
        ``exposure``, the overlays, the checkerboard behind transparency."""
        t0 = time.perf_counter()
        if self.task is None:
            raise RuntimeError("load a snapshot or training data before rendering")
        if ground_truth and self.mode != TestbedMode.VOLUME:
            raise ValueError("ground_truth traces a volume's grid; a NeRF view's image is "
                             "render_ground_truth")
        if start_t >= 0.0 and not self.camera_path.empty():
            kf = self.camera_path.eval(start_t + max(end_t - start_t, 0.0) * shutter_fraction)
            target = np.asarray(kf.to_matrix(), np.float32)
            if self.camera_smoothing and self._smoothed_cam is not None:
                target = 0.8 * self._smoothed_cam + 0.2 * target
            self._smoothed_cam = target
            self.camera_matrix = target
            if kf.fov:
                self.fov = float(kf.fov)
            self._view_index = None
        cam = self.camera_matrix if camera_matrix is None else camera_matrix
        if self.mode == TestbedMode.IMAGE:
            rgb = self.task.render(width, height)
            frame = torch.cat([rgb, torch.ones_like(rgb[..., :1])], dim=-1)
            frame = self._to_space(frame, bool(self.task.is_hdr), linear)
        elif self.mode == TestbedMode.NERF:
            if self.render_ground_truth:
                # the training image of the view, returned as it is (testbed.py:1250-1258)
                gt = torch.from_numpy(self.render_gt_view(width, height, self._view_index or 0))
                frame = self._to_space(gt.to(self.task.device), bool(self.nerf_dataset.is_hdr),
                                       linear)
                self.render_ms.update((time.perf_counter() - t0) * 1000.0)
                return frame
            frame = self._render_nerf(width, height, spp, linear, cam, fov)
        elif self.mode in (TestbedMode.SDF, TestbedMode.VOLUME):
            if spp != 1 and not self._spp_warned:
                warnings.warn("spp > 1 has no effect on SDF and volume renders (their traces are "
                              "deterministic at pixel centres)")
                self._spp_warned = True
            if self.mode == TestbedMode.SDF:
                self.task.floor_enable = bool(self.floor_enable)
                frame = self.task.render(width, height, cam, fov=fov or self.fov,
                                         light_dir=tuple(np.asarray(self.sun_dir, np.float32)))
            else:
                frame = self.task.render(width, height, cam, fov=fov or self.fov,
                                         ground_truth=ground_truth)
            if self.tonemap_curve != TonemapCurve.IDENTITY:
                from .render.buffer import tonemap

                frame = torch.cat([tonemap(frame[..., :3], self.tonemap_curve), frame[..., 3:]],
                                  dim=-1)
            frame = self._to_space(frame, True, linear)
        else:
            raise ValueError(self.mode)
        if self.exposure:
            scale = 2.0 ** self.exposure
            rgb = frame[..., :3]
            if linear:
                rgb = rgb * scale
            else:
                rgb = linear_to_srgb(torch.clamp(srgb_to_linear(torch.clamp(rgb, 0, 1)) * scale,
                                                 0, 1))
            frame = torch.cat([rgb, frame[..., 3:]], dim=-1)
        if self.visualize_unit_cube or self.visualize_cameras:
            frame = self._draw_overlays(frame.clone(), height, cam, fov)
        if self.render_transparency_as_checkerboard:
            # the premultiplied colour over a grey checkerboard of 8-pixel squares
            h, w = frame.shape[:2]
            ys, xs = np.mgrid[0:h, 0:w]
            checker = torch.from_numpy(np.where(((xs // 8) + (ys // 8)) % 2 == 0, 0.55, 0.4))
            a = torch.clamp(frame[..., 3:4], 0.0, 1.0)
            rgb = frame[..., :3].double() + checker.to(frame.device)[..., None] * (1 - a).double()
            frame = torch.cat([rgb.to(torch.float32), frame[..., 3:]], dim=-1)
        self.render_ms.update((time.perf_counter() - t0) * 1000.0)
        self._last_frame = frame
        return frame

    def _view_intrinsics(self, width: int, height: int) -> dict:
        """A training view's focal length (scaled by (width, height)[fov_axis]
        / resolution[fov_axis]) and principal point after
        ``set_camera_to_training_view``, else ``screen_center``."""
        if self._view_index is None:
            return {"principal_point": tuple(self.screen_center)}
        ds, i = self.nerf_dataset, self._view_index
        s = (width, height)[self.fov_axis] / ds.resolution[self.fov_axis]
        return {"focal_length": tuple(ds.focal_lengths[i] * s),
                "principal_point": tuple(ds.principal_points[i])}

    def _render_nerf(self, width, height, spp, linear, cam, fov) -> torch.Tensor:
        task = self.task
        mode = self.render_mode.value if isinstance(self.render_mode, RenderMode) else str(
            self.render_mode)
        mode = mode.replace("_", "")
        quality = self.render_quality
        task.min_transmittance = self.nerf_min_transmittance
        task.visualized_dimension = self.visualized_dimension
        bg = (0.0, 0.0, 0.0, 0.0) if self.render_transparency_as_checkerboard else tuple(
            self.background_color)
        kw = self._view_intrinsics(width, height)
        produced_linear = task.rgb_activation == NerfActivation.EXPONENTIAL
        if mode == "slice":
            # the model on the plane slice_plane_z + scale (testbed.py:1278-1290)
            frame = task.render_slice(width, height, cam, fov=fov or self.fov,
                                      plane_dist=self.slice_plane_z + self.scale,
                                      background=bg, **kw)
            return self._to_space(frame, produced_linear, linear)
        fov_eff = fov or self.fov
        if self.zoom != 1.0:  # m_zoom scales the focal length
            if "focal_length" in kw:
                kw["focal_length"] = tuple(f * self.zoom for f in kw["focal_length"])
            else:
                fov_eff = 2.0 * math.degrees(math.atan(
                    math.tan(math.radians(fov_eff) * 0.5) / self.zoom))
        if self.autofocus:
            # focus at the crop box's centre (testbed.py:1302-1307)
            center = 0.5 * (np.asarray(task.render_aabb_min) + np.asarray(task.render_aabb_max))
            task.focus_z = float(np.linalg.norm(center - np.asarray(cam)[:, 3]))
        frame = task.render(width, height, cam, fov=fov_eff, spp=spp, background=bg,
                            render_mode=mode, render_quality=quality, **kw)
        # LDR scenes train and render in sRGB, HDR in linear (testbed_nerf.cu:2354)
        frame = self._to_space(frame, produced_linear, linear)
        if self.nerf.sharpen:
            frame = _unsharp(frame, self.nerf.sharpen)
        return frame

    def _draw_overlays(self, frame: torch.Tensor, height: int, cam, fov) -> torch.Tensor:
        """The unit cube (NeRF: the render box) and the training cameras'
        frusta (testbed.cu draw_visualizations, :2126-2254)."""
        from .render.overlays import draw_cameras, draw_wire_box

        fl = 0.5 * height / math.tan(0.5 * math.radians(fov or self.fov))
        if self.visualize_unit_cube:
            lo, hi = np.zeros(3), np.ones(3)
            if self.mode == TestbedMode.NERF:
                lo = np.asarray(self.task.render_aabb_min)
                hi = np.asarray(self.task.render_aabb_max)
            draw_wire_box(frame, lo, hi, cam, fl, tuple(self.screen_center))
        if self.visualize_cameras and self.mode == TestbedMode.NERF:
            draw_cameras(frame, self.nerf_dataset.xforms_start, cam, fl, tuple(self.screen_center))
        return frame

    @staticmethod
    def _to_space(frame: torch.Tensor, produced_linear: bool, linear: bool) -> torch.Tensor:
        """The frame's rgb in linear colour or sRGB, as asked (pyngp
        render_to_cpu's contract)."""
        if produced_linear == linear:
            return frame
        rgb = frame[..., :3]
        if produced_linear:
            rgb = linear_to_srgb(torch.clamp(rgb, min=0.0))
        else:
            rgb = srgb_to_linear(torch.clamp(rgb, 0.0, 1.0))
        return torch.cat([rgb, frame[..., 3:]], dim=-1)

    def view(self, linear: bool = True, view: int = 0) -> np.ndarray:
        """pyngp view (python_api.cu:471-475): the last rendered frame (one
        view), in sRGB if ``linear`` is False; a 64² render if none."""
        if self._last_frame is None:
            return self.render(64, 64, linear=linear)
        frame = self._last_frame
        if not linear:
            frame = torch.cat([linear_to_srgb(torch.clamp(frame[..., :3], min=0.0)),
                               frame[..., 3:]], dim=-1)
        return frame.cpu().numpy()

    def screenshot(self, path, width: int = 1920, height: int = 1080, spp: int = 1) -> np.ndarray:
        """Render (linear, as ``render``'s default) and save the rgb."""
        frame = self.render(width, height, spp=spp)
        save_image(path, frame[..., :3])
        return frame

    def render_with_depth(self, width: int = 1920, height: int = 1080, spp: int = 1,
                          linear: bool = True, start_t: float = -1.0, end_t: float = -1.0,
                          fps: float = 30.0, shutter_fraction: float = 1.0):
        """pyngp render_with_depth (python_api.cu:521-529): (rgba (H, W, 4),
        depth (H, W)). NeRF's depth is the expected termination distance;
        the other primitives have no depth buffer and give zeros."""
        if self.mode == TestbedMode.NERF and self.task is not None:
            frame, depth = self.task.render(
                width, height, self.camera_matrix, fov=self.fov, spp=spp,
                background=tuple(self.background_color), return_depth=True,
                render_quality=self.render_quality, **self._view_intrinsics(width, height))
            produced_linear = self.task.rgb_activation == NerfActivation.EXPONENTIAL
            frame = self._to_space(frame, produced_linear, linear)
            return frame.cpu().numpy(), depth.cpu().numpy()
        frame = self.render(width, height, spp=spp, linear=linear, start_t=start_t, end_t=end_t,
                            fps=fps, shutter_fraction=shutter_fraction)
        return frame, np.zeros((height, width), np.float32)

    def render_gt_view(self, width: int, height: int, view_idx: int) -> np.ndarray:
        """The training image of a view, resampled to (H, W, 4) by nearest
        pixel in the model's colour space, its alpha premultiplied in linear
        colour for an LDR scene (testbed.cu:5074-5143). ``render_ground_truth``
        routes ``render`` through this."""
        ds = self.nerf_dataset
        if (self.groundtruth_render_mode == GroundTruthRenderMode.DEPTH
                and ds.depths is not None):
            dep = (ds.depths[view_idx] / max(float(ds.depths.max()), 1e-6)).astype(np.float32)
            frame = np.stack([dep, dep, dep, np.ones_like(dep)], -1)
            return _resample_nearest(frame, width, height)
        img = ds.images[view_idx].astype(np.float32)
        if not ds.is_hdr:
            img = img / 255.0
            rgb = premultiplied_srgb(img)
        else:
            rgb = img[..., :3]
        return _resample_nearest(np.concatenate([rgb, img[..., 3:4]], -1), width, height)

    def render_error_overlay(self, width: int, height: int, view_idx: int,
                             scale: float = 4.0) -> np.ndarray:
        """|render − ground truth| of a training view as a red-to-blue heat
        map (the reference's error overlay)."""
        ds = self.nerf_dataset
        gt = self.render_gt_view(width, height, view_idx)
        frame = self.task.render(
            width, height, ds.xforms_start[view_idx],
            focal_length=tuple(ds.focal_lengths[view_idx] * np.array([width, height])
                               / ds.resolution),
            principal_point=tuple(ds.principal_points[view_idx]),
            background=(0, 0, 0, 0)).cpu().numpy()
        err = np.abs(frame[..., :3] - gt[..., :3]).mean(-1, keepdims=True)
        heat = np.clip(err * scale, 0.0, 1.0)
        return np.concatenate([heat, np.zeros_like(heat), 1.0 - heat, np.ones_like(heat)],
                              -1).astype(np.float32)

    def render_progressive(self, width: int, height: int, spp: int = 8, **kw) -> np.ndarray:
        """``spp`` renders accumulated in a RenderBuffer (the reference's
        progressive accumulation, render_buffer.h:173-317), in linear colour."""
        from .render.buffer import RenderBuffer

        buf = RenderBuffer(width, height)
        self._accum_buffer = buf  # reset_accumulation() clears it
        for _ in range(spp):
            buf.accumulate(self.render(width, height, **kw))
        return buf.tonemapped(color_space=ColorSpace.LINEAR)

    def render_with_dynamic_res(self, width: int, height: int, **kw) -> np.ndarray:
        """Render at the dynamic-resolution factor (or 8 / fixed_res_factor
        when ``dynamic_res`` is off) and upsample by repeating pixels
        (testbed.cu:3299-3395)."""
        if self._dyn_res is None:
            from .render.buffer import DynamicResolution

            self._dyn_res = DynamicResolution(self.dynamic_res_target_fps)
        if self.dynamic_res:
            factor = self._dyn_res.factor
        else:
            factor = min(1.0, 8.0 / max(float(self.fixed_res_factor), 1.0))
        rw, rh = max(16, int(width * factor)), max(16, int(height * factor))
        t0 = time.perf_counter()
        frame = self.render(rw, rh, **kw)
        self._dyn_res.update((time.perf_counter() - t0) * 1000.0)
        if (rw, rh) != (width, height):
            reps_y, reps_x = int(np.ceil(height / rh)), int(np.ceil(width / rw))
            frame = np.repeat(np.repeat(frame, reps_y, 0), reps_x, 1)[:height, :width]
        return frame

    def reset_accumulation(self, due_to_camera_movement: bool = False,
                           immediate_redraw: bool = True) -> None:
        """pyngp reset_accumulation (python_api.cu:537-543): clear the
        progressive accumulation; a camera movement also restarts the
        smoothed camera."""
        if self._accum_buffer is not None:
            self._accum_buffer.reset()
        if due_to_camera_movement:
            self._smoothed_cam = None

    def load_camera_path(self, path) -> CameraPath:
        """A camera path JSON (the reference's format; either package's)."""
        self.camera_path = CameraPath.load(path)
        return self.camera_path

    # --- the camera ---
    def set_camera_to_training_view(self, i: int) -> None:
        self.camera_matrix = self.nerf_dataset.xforms_start[i].copy()
        self._view_index = i  # render() uses this view's intrinsics

    def first_training_view(self) -> None:
        self.set_camera_to_training_view(0)

    def last_training_view(self) -> None:
        self.set_camera_to_training_view(self.nerf_dataset.n_images - 1)

    def previous_training_view(self) -> None:
        i = self._view_index if self._view_index is not None else 0
        self.set_camera_to_training_view(max(i - 1, 0))

    def next_training_view(self) -> None:
        i = self._view_index if self._view_index is not None else -1
        self.set_camera_to_training_view(min(i + 1, self.nerf_dataset.n_images - 1))

    def set_nerf_camera_matrix(self, m) -> None:
        """The view from a NeRF-convention matrix; a free camera again."""
        self.camera_matrix = self.nerf_dataset.nerf_matrix_to_ngp(np.asarray(m))
        self._view_index = None

    def look_at(self, target) -> None:
        t = np.asarray(target, np.float32)
        eye = self.camera_matrix[:, 3]
        fwd = t - eye
        n = np.linalg.norm(fwd)
        if n < 1e-9:
            return
        fwd = fwd / n
        right = np.cross(fwd, np.array([0.0, 1.0, 0.0], np.float32))
        right /= max(np.linalg.norm(right), 1e-9)
        up = np.cross(right, fwd)
        self.camera_matrix = np.stack([right, -up, fwd, eye], axis=1)

    def view_dir(self) -> np.ndarray:
        return self.camera_matrix[:, 2].copy()

    @property
    def default_camera(self) -> np.ndarray:
        """The home view ``reset_camera`` restores."""
        return _home_camera()

    def reset_camera(self) -> None:
        self.camera_matrix = _home_camera()
        self.fov = 50.625
        self.screen_center = (0.5, 0.5)

    def view_camera(self, view: int = 0) -> np.ndarray:
        return np.array(self.camera_matrix, copy=True)

    def predict_view_camera(self, delta_t: float, view: int = 0) -> np.ndarray:
        """The pose ``delta_t`` seconds ahead (needs camera_prediction_mode
        other than NONE and a few frame() ticks); else the current one."""
        if self._cam_predictor is None:
            return self.view_camera(view)
        return np.asarray(self._cam_predictor.predict_camera(delta_t), np.float32)

    @property
    def fov_xy(self) -> np.ndarray:
        """Per-axis field of view in degrees; both follow ``fov`` unless set."""
        return np.asarray([self._fov_x if self._fov_x is not None else self.fov, self.fov],
                          np.float32)

    @fov_xy.setter
    def fov_xy(self, v) -> None:
        v = np.asarray(v, np.float32).reshape(2)
        self._fov_x = float(v[0])
        self.fov = float(v[self.fov_axis])

    @property
    def relative_focal_length(self) -> np.ndarray:
        """focal length / resolution[fov_axis] (testbed.cu:491-492)."""
        rel = 0.5 / math.tan(0.5 * math.radians(self.fov))
        rel_x = 0.5 / math.tan(0.5 * math.radians(self._fov_x)) if self._fov_x is not None else rel
        return np.asarray([rel_x, rel], np.float32)

    @relative_focal_length.setter
    def relative_focal_length(self, v) -> None:
        v = np.asarray(v, np.float32).reshape(2)
        self._fov_x = math.degrees(2 * math.atan(0.5 / max(v[0], 1e-9)))
        self.fov = math.degrees(2 * math.atan(0.5 / max(v[self.fov_axis], 1e-9)))

    @property
    def render_groundtruth(self) -> bool:
        return self.render_ground_truth

    @render_groundtruth.setter
    def render_groundtruth(self, v) -> None:
        self.render_ground_truth = bool(v)

    @property
    def loop_animation(self) -> bool:
        return self.camera_path.loop

    @loop_animation.setter
    def loop_animation(self, v) -> None:
        self.camera_path.loop = bool(v)

    @property
    def render_lens(self) -> Lens:
        """The lens of free-camera renders: the dataset's."""
        ds = self.nerf_dataset
        return Lens() if ds is None else Lens(ds.lens_mode, ds.lens_params)

    @render_lens.setter
    def render_lens(self, lens: Lens) -> None:
        ds = self.nerf_dataset
        if ds is None:
            raise RuntimeError("load a NeRF scene first")
        ds.lens_mode = getattr(lens.mode, "value", lens.mode)
        ds.lens_params = np.asarray(lens.params, np.float32)
        if isinstance(self.task, NerfTask):
            self.task.lens_params = self.task._t(ds.lens_params)

    # --- the scene's boxes ---
    @property
    def aabb(self) -> BoundingBox:
        if self.mode == TestbedMode.NERF and self.task is not None:
            return BoundingBox(self.task.aabb_min, self.task.aabb_max)
        return BoundingBox(np.zeros(3), np.ones(3))

    @property
    def raw_aabb(self) -> BoundingBox:
        """SDF: the mesh's bounds before its normalization into the unit cube
        (world = raw·scale + offset inverted; testbed.py:1690-1701)."""
        if self.mode == TestbedMode.SDF and self.task is not None:
            t = self.task
            raw = (t.triangles.reshape(-1, 3) - t.mesh_offset) / t.mesh_scale
            return BoundingBox(raw.min(0), raw.max(0))
        return self.aabb

    @property
    def render_aabb(self) -> np.ndarray:
        return np.stack([self.task.render_aabb_min, self.task.render_aabb_max])

    @render_aabb.setter
    def render_aabb(self, v) -> None:
        v = np.asarray(v, np.float32)
        self.task.render_aabb_min, self.task.render_aabb_max = v[0], v[1]

    @property
    def crop_box(self) -> BoundingBox:
        """The render box as a BoundingBox, in the frame that
        ``render_aabb_to_local`` reaches."""
        if not isinstance(self.task, NerfTask):
            return BoundingBox(np.zeros(3), np.ones(3))
        return BoundingBox(self.task.render_aabb_min, self.task.render_aabb_max)

    @crop_box.setter
    def crop_box(self, box: BoundingBox) -> None:
        self.render_aabb = np.stack([np.asarray(box.min), np.asarray(box.max)])

    def set_crop_box(self, corners) -> None:
        self.render_aabb = np.asarray(corners, np.float32)

    def crop_box_corners(self) -> np.ndarray:
        return self.render_aabb

    @property
    def render_aabb_to_local(self) -> np.ndarray:
        """The rotation into the render box's frame (pyngp
        render_aabb_to_local, python_api.cu:642)."""
        if isinstance(self.task, NerfTask):
            return np.asarray(self.task.render_aabb_to_local, np.float32)
        return np.eye(3, dtype=np.float32)

    @render_aabb_to_local.setter
    def render_aabb_to_local(self, m) -> None:
        m = np.asarray(m, np.float32).reshape(3, 3)
        if isinstance(self.task, NerfTask):
            self.task.render_aabb_to_local = m

    # --- mesh export (testbed.py:1460-1480, 1591-1640, 2053-2074) ---
    def compute_marching_cubes_mesh(self, resolution=(256, 256, 256), aabb=None,
                                    thresh: float = 2.5) -> dict:
        """pyngp compute_marching_cubes_mesh: {"V", "N", "C", "F"} as numpy,
        the vertices in the unit cube (NeRF: model coordinates), their
        area-weighted normals, colours and the faces. Only
        ``resolution[0]`` is read and ``aabb`` is not, as in the JAX
        package."""
        from .geometry.marching_cubes import extract_mesh, vertex_normals

        res = int(resolution[0]) if np.ndim(resolution) else int(resolution)
        verts, faces, colors = extract_mesh(self.task, res=res, iso=thresh)
        normals = vertex_normals(verts, faces)
        if colors is None:
            colors = torch.full_like(verts, 0.7)
        return {"V": verts.cpu().numpy(), "N": normals.cpu().numpy(),
                "C": colors.cpu().numpy(), "F": faces.cpu().numpy()}

    def compute_and_save_marching_cubes_mesh(self, filename: str, resolution=(256, 256, 256),
                                             aabb=None, thresh: float = 2.5,
                                             generate_uvs_for_exporting_texture: bool = False,
                                             generate_uvs_for_obj_file: bool = False) -> int:
        """pyngp compute_and_save_marching_cubes_mesh: a ``.ply`` by its
        suffix, else an OBJ (with a UV atlas and texture where asked).
        Returns the vertex count."""
        from .geometry.marching_cubes import extract_mesh
        from .geometry.mesh_io import save_obj, save_obj_unwrapped, save_ply

        res = int(resolution[0]) if np.ndim(resolution) else int(resolution)
        verts, faces, colors = extract_mesh(self.task, res=res, iso=thresh)
        if str(filename).lower().endswith(".ply"):
            save_ply(filename, verts, faces, colors)
        elif generate_uvs_for_exporting_texture or generate_uvs_for_obj_file:
            save_obj_unwrapped(filename, verts, faces, colors)
        else:
            save_obj(filename, verts, faces, colors)
        return int(verts.shape[0])

    def compute_and_save_png_slices(self, filename: str, resolution: int = 256, aabb=None,
                                    thresh: float = float("inf"), density_range: float = 4.0,
                                    flip_y_and_z_axes: bool = False) -> tuple:
        """pyngp compute_and_save_png_slices (reference testbed.cu:556-585):
        the field on a grid over the render box (NeRF; the unit cube
        otherwise, or ``aabb``), its z-slices tiled into
        ``<filename>.density_slices_<rx>x<ry>x<rz>.png``. SDF: the box grows
        by ``density_range`` voxels and the range turns into voxel units,
        negated. Returns the grid's resolution."""
        from .geometry.marching_cubes import (get_density_on_grid, get_marching_cubes_res,
                                              save_density_grid_to_png)

        if aabb is None or (hasattr(aabb, "is_empty") and aabb.is_empty()):
            if self.mode == TestbedMode.NERF and self.task is not None:
                lo = np.asarray(self.task.render_aabb_min)
                hi = np.asarray(self.task.render_aabb_max)
            else:
                lo, hi = np.zeros(3, np.float32), np.ones(3, np.float32)
            to_local = self.render_aabb_to_local
        else:
            lo = np.asarray(aabb.min, np.float32)
            hi = np.asarray(aabb.max, np.float32)
            to_local = np.eye(3, dtype=np.float32)
        if thresh == float("inf"):
            thresh = float(self.mesh_thresh)
        rng = float(density_range)
        res3d = get_marching_cubes_res(int(resolution), lo, hi)
        if self.mode == TestbedMode.SDF:
            pad = rng * (hi - lo)[0] / res3d[0]
            lo, hi = lo - pad, hi + pad
            res3d = get_marching_cubes_res(int(resolution), lo, hi)
            rng = -rng * (hi - lo)[0] / res3d[0]
            thresh = 0.0
        density = get_density_on_grid(self.task, res3d, lo, hi, to_local)
        save_density_grid_to_png(density, f"{filename}.density_slices_{res3d[0]}x{res3d[1]}x"
                                          f"{res3d[2]}.png", thresh=thresh, density_range=rng,
                                 flip_y_and_z_axes=flip_y_and_z_axes)
        return tuple(int(r) for r in res3d)

    @property
    def render_near_distance(self) -> float:
        return float(getattr(self.task, "render_near_distance", 0.0))

    @render_near_distance.setter
    def render_near_distance(self, v) -> None:
        self.task.render_near_distance = float(v)

    @property
    def rendering_min_transmittance(self) -> float:
        return self.nerf_min_transmittance

    @rendering_min_transmittance.setter
    def rendering_min_transmittance(self, v) -> None:
        self.nerf_min_transmittance = float(v)

    # --- the model and the scene ---
    def _param_split(self) -> tuple[list, list]:
        """(all parameters, the input encoding's)."""
        model = self.task.model
        params = model.param_list()
        if isinstance(self.task, NerfTask):
            return params, encoding_tables(model.pos_encoding)
        return params, params[len(model.network.weights):]

    def n_params(self) -> int:
        return int(sum(p.numel() for p in self._param_split()[0]))

    def n_encoding_params(self) -> int:
        return int(sum(p.numel() for p in self._param_split()[1]))

    @property
    def shall_train_encoding(self) -> bool:
        """pyngp's toggle: freeze the input encoding while the MLPs train."""
        if self.task is not None:
            return self.task.shall_train_encoding
        return self._pend_train_enc if self._pend_train_enc is not None else True

    @shall_train_encoding.setter
    def shall_train_encoding(self, v) -> None:
        if self.task is None:
            self._pend_train_enc = bool(v)
        else:
            self.task.shall_train_encoding = bool(v)

    @property
    def shall_train_network(self) -> bool:
        if self.task is not None:
            return self.task.shall_train_network
        return self._pend_train_net if self._pend_train_net is not None else True

    @shall_train_network.setter
    def shall_train_network(self, v) -> None:
        if self.task is None:
            self._pend_train_net = bool(v)
        else:
            self.task.shall_train_network = bool(v)

    def override_sdf_training_data(self, points, distances) -> None:
        """pyngp override_sdf_training_data (python_api.cu:74-112): train the
        SDF on a fixed (points, distances) set in the mesh's raw frame."""
        if self.mode != TestbedMode.SDF or self.task is None:
            raise RuntimeError("override_sdf_training_data requires a loaded SDF scene")
        self.task.override_training_data(points, distances)

    def create_empty_nerf_dataset(self, n_images: int, aabb_scale: int = 1,
                                  is_hdr: bool = False) -> NerfDataset:
        """pyngp create_empty_nerf_dataset (nerf_loader.cu:153-173): n images
        of 64², identity cameras, black frames, for ``set_image``."""
        n, w, h = int(n_images), 64, 64
        xforms = np.tile(np.eye(3, 4, dtype=np.float32), (n, 1, 1))
        ds = NerfDataset(
            images=np.zeros((n, h, w, 4), np.float16 if is_hdr else np.uint8),
            is_hdr=bool(is_hdr), xforms_start=xforms, xforms_end=xforms.copy(),
            focal_lengths=np.full((n, 2), 0.5 * w, np.float32),
            principal_points=np.full((n, 2), 0.5, np.float32),
            rolling_shutter=np.zeros((n, 4), np.float32), resolution=(w, h),
            aabb_scale=int(aabb_scale), scale=0.33,
            offset=np.array([0.5, 0.5, 0.5], np.float32))
        self.mode = TestbedMode.NERF
        self.nerf_dataset = ds
        if not self.network_config:
            self.network_config = default_config("nerf")
        self.task = NerfTask(ds, self.network_config, self.device, seed=self.seed)
        return ds

    def clear_training_data(self) -> None:
        if isinstance(self.task, SdfTask):
            self.task.stop_producer()
        self.task = None
        self.scene_path = None

    def reset(self) -> None:
        """A fresh network on the loaded scene (reference Testbed::reset)."""
        if self.scene_path:
            self._build_task()
        self.training_step = 0

    def free_temporary_memory(self) -> None:
        """Drop the NeRF task's baked and slab caches (testbed.py:1703-1713)
        and hand the allocator's cached blocks back to the card."""
        for attr in ("_baked_cache", "_slab_cache"):
            if self.task is not None and hasattr(self.task, attr):
                setattr(self.task, attr, None)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def want_repl(self) -> bool:
        return False

    # --- snapshots ---
    def save_snapshot(self, path, include_optimizer_state: bool = False) -> None:
        """Write the task's snapshot (testbed.py:2079-2128): the config, the
        parameters in fp16, the step, the loss and the view; for NeRF also
        the density grid, the dataset block and the camera offsets; the
        optimizer state if asked."""
        task = self.task
        if task is None:
            raise RuntimeError("load training data or a snapshot before saving one")
        nerf = self.mode == TestbedMode.NERF
        model_io = nerf_network if nerf else image_network  # image and SDF: models/network
        kw = {}
        if nerf:
            ds = task.dataset
            kw = {"density_grid": task.state.grid.density.cpu().numpy(),
                  "nerf_extra": {"aabb_scale": ds.aabb_scale,
                                 "rgb": {"rays_per_batch": task.n_rays_per_batch},
                                 "dataset": snapshot_io.dataset_to_json(ds)},
                  "cam_offsets": task.cam_offsets_numpy()}
            # the JAX package builds the live crop box (task.render_aabb_min/max)
            # here but never writes it (testbed.py:2102), so a round trip loses
            # it; matched on purpose, so that both packages write one document
        snapshot_io.save_snapshot(
            path, self.network_config, model_io.params_to_numpy(task.model), self.mode.value,
            training_step=task.training_step, loss=self.loss,
            camera={"matrix": np.asarray(self.camera_matrix).tolist(), "fov_axis": 1},
            optimizer_state=task.opt_state_tree() if include_optimizer_state else None, **kw)

    def load_snapshot(self, path) -> None:
        """Load a snapshot (testbed.py:2165-2233). NeRF: onto the loaded
        scene's task, so that training continues on its images; with no
        scene, onto a task built from the snapshot's dataset block (cameras
        only, for rendering). Image, SDF and volume: onto the task of the
        loaded image, mesh or grid (the JAX package's generic branch). The
        loss meter stays as it was, as the JAX package's does."""
        doc = snapshot_io.load_snapshot_file(path)
        snap = doc["snapshot"]
        mode = TestbedMode(snap["mode"])
        if mode not in _PORTED_MODES:
            raise NotImplementedError(f"snapshot mode {mode.value!r} is not ported yet")
        self.network_config = {k: v for k, v in doc.items() if k != "snapshot"}
        self.mode = mode
        nerf = mode == TestbedMode.NERF
        task_type = {TestbedMode.NERF: NerfTask, TestbedMode.IMAGE: ImageTask,
                     TestbedMode.SDF: SdfTask, TestbedMode.VOLUME: VolumeTask}[mode]
        model_io = nerf_network if nerf else image_network
        if nerf and not isinstance(self.task, NerfTask):
            if "nerf" not in snap or "dataset" not in snap["nerf"]:
                raise RuntimeError("snapshot lacks a dataset block and no scene is loaded")
            self.nerf_dataset = _empty_nerf_dataset_from_snapshot(snap)
            self.task = NerfTask(self.nerf_dataset, self.network_config, device=self.device)
        if (isinstance(self.task, (SdfTask, VolumeTask))
                and self.task.network_config != self.network_config):
            self._build_task()  # the loaded mesh or grid under the snapshot's network
        task = self.task
        if not isinstance(task, task_type):
            raise RuntimeError(f"load the {mode.value} scene before its snapshot: an image, SDF "
                               "or volume snapshot holds no image, mesh or grid")
        params = snapshot_io.restore_params(snap, model_io.params_to_numpy(task.model))
        opt_state = None
        if "optimizer_state" in snap:
            opt_state = snapshot_io.unpack_tree(snap["optimizer_state"], task.opt_state_tree())
        step = int(snap.get("training_step", 0))
        if nerf:
            cam = None
            if "cam_offsets" in snap:
                cam = snapshot_io.unpack_cam_offsets(snap["cam_offsets"])
            task.load_state(params, opt_state,
                            snapshot_io.restore_density_grid(snap, task.max_cascade + 1), step,
                            cam)
        else:
            task.load_state(params, opt_state, step)
        self.training_step = task.training_step

    # --- metrics ---
    def compute_image_mse(self, quantize_to_byte: bool = False) -> float:
        return self.task.compute_mse(quantize_to_byte)

    def calculate_iou(self, n_samples: int = 128**3) -> float:
        return self.task.calculate_iou(n_samples)

