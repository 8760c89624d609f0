"""A minimal ``Testbed`` (port of the NeRF and image branches, the
training tick and the snapshots of ``instant_ngp_tpu/testbed.py``): train a
NeRF scene from disk or an in-memory dataset, fit an image, save a
snapshot, and load one to render or to train on.

    tb = Testbed("nerf")  # on the card; device="cpu" runs the plain versions
    tb.load_training_data("scene_dir")  # a transforms.json scene, configs/nerf/base.json
    for _ in range(n):
        tb.frame()  # one training step; tb.loss is its EMA
    tb.save_snapshot("scene.ingp", include_optimizer_state=True)

    tb = Testbed("nerf")
    tb.load_snapshot("scene.ingp")  # no scene: cameras from the snapshot, render only
    frame = tb.render(256, 256, camera_matrix, focal_length=..., ...)  # numpy (H, W, 4)

    tb = Testbed("nerf")
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

Snapshots are the JAX package's format, key for key: each package reads
the other's.

``render`` returns the frame on the host, as pyngp's ``render_to_cpu`` and
the JAX package's ``Testbed.render`` do; ``render_tensor`` returns the same
frame as a tensor on the task's device, for code that keeps working on it.
"""

from __future__ import annotations

import numpy as np
import torch

from pathlib import Path

from . import snapshot as snapshot_io
from .common import RandomMode, TestbedMode, linear_to_srgb, srgb_to_linear
from .config import default_config, load_network_config
from .image_fit.task import ImageTask
from .io.image import load_image
from .io.nerf_loader import NerfDataset, load_nerf
from .models import network as image_network
from .models import nerf_network
from .nerf.task import NerfTask


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


class LossEma:
    """EMA meter of the training loss (reference common_host.h:83-129)."""

    def __init__(self, half_life: float = 10.0):
        self.alpha = 0.5 ** (1.0 / half_life)
        self.value = 0.0
        self.n = 0

    def update(self, v: float) -> None:
        self.value = self.alpha * self.value + (1 - self.alpha) * v if self.n else v
        self.n += 1


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


class Testbed:
    """Modes "nerf" and "image" ("none" until ``load_training_data`` infers
    the mode from the scene). Work runs on ``device``, the card unless the
    caller asks for the CPU."""

    def __init__(self, mode: TestbedMode | str = "nerf", device="cuda"):
        mode = TestbedMode(mode.lower()) if isinstance(mode, str) else mode
        if mode not in (TestbedMode.NONE, TestbedMode.NERF, TestbedMode.IMAGE):
            raise NotImplementedError(f"testbed mode {mode.value!r} is not ported yet")
        self.mode = mode
        self.device = torch.device(device)
        self.task: NerfTask | ImageTask | None = None
        self.nerf_dataset: NerfDataset | None = None
        self.network_config: dict = {}
        self.scene_path: str | None = None
        self.seed = 1337
        self.training_batch_size = 1 << 18
        self.training_step = 0
        self.shall_train = True
        # the view a snapshot records: a scene's first training camera
        self.camera_matrix = np.concatenate(
            [np.eye(3, dtype=np.float32), np.array([[0.5], [0.5], [-1.5]], np.float32)], axis=1)
        self.loss_graph: list[float] = []
        self._loss_ema = LossEma()
        self.image = _ImageView(self)

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
        if mode not in (TestbedMode.NERF, TestbedMode.IMAGE):
            raise NotImplementedError(f"loading {mode.value} training data is not ported yet")
        self.scene_path = str(path)
        self.mode = mode
        if not self.network_config:
            self.network_config = default_config(mode.value)
        self._build_task()

    def reload_network_from_file(self, config_path) -> None:
        mode = self.mode.value if self.mode != TestbedMode.NONE else None
        self.network_config = load_network_config(config_path, mode=mode)
        if self.scene_path:
            self._build_task()

    def reload_network_from_json(self, config: dict) -> None:
        self.network_config = dict(config)
        if self.scene_path:
            self._build_task()

    def _build_task(self) -> None:
        """A fresh task on the scene (testbed.py:1028-1058): an image, or a
        NeRF scene whose first training camera becomes the view."""
        if self.mode == TestbedMode.NERF:
            self.nerf_dataset = load_nerf(self.scene_path)
            self.task = NerfTask(self.nerf_dataset, self.network_config, self.device,
                                 seed=self.seed, target_batch_size=self.training_batch_size)
            self.camera_matrix = self.nerf_dataset.xforms_start[0].copy()
        else:
            img, is_hdr = load_image(self.scene_path)
            self.task = ImageTask(img, is_hdr, self.network_config, device=self.device,
                                  seed=self.seed, batch_size=self.training_batch_size)
        self.training_step = 0

    def save_snapshot(self, path, include_optimizer_state: bool = False) -> None:
        """Write the task's snapshot (testbed.py:2079-2128): the config, the
        parameters in fp16, the step, the loss and the view; for NeRF also
        the density grid, the dataset block and the camera offsets; the
        optimizer state if asked."""
        task = self.task
        if task is None:
            raise RuntimeError("load training data or a snapshot before saving one")
        nerf = self.mode == TestbedMode.NERF
        model_io = nerf_network if nerf else image_network
        kw = {}
        if nerf:
            ds = task.dataset
            kw = {"density_grid": task.state.grid.density.cpu().numpy(),
                  "nerf_extra": {"aabb_scale": ds.aabb_scale,
                                 "rgb": {"rays_per_batch": task.n_rays_per_batch},
                                 "dataset": snapshot_io.dataset_to_json(ds)},
                  "cam_offsets": task.cam_offsets}
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
        only, for rendering). Image: onto the loaded image's task. The loss
        meter stays as it was, as the JAX package's does."""
        doc = snapshot_io.load_snapshot_file(path)
        snap = doc["snapshot"]
        mode = TestbedMode(snap["mode"])
        if mode not in (TestbedMode.NERF, TestbedMode.IMAGE):
            raise NotImplementedError(f"snapshot mode {mode.value!r} is not ported yet")
        self.network_config = {k: v for k, v in doc.items() if k != "snapshot"}
        self.mode = mode
        nerf = mode == TestbedMode.NERF
        task_type, model_io = (NerfTask, nerf_network) if nerf else (ImageTask, image_network)
        if nerf and not isinstance(self.task, NerfTask):
            if "nerf" not in snap or "dataset" not in snap["nerf"]:
                raise RuntimeError("snapshot lacks a dataset block and no scene is loaded")
            self.nerf_dataset = _empty_nerf_dataset_from_snapshot(snap)
            self.task = NerfTask(self.nerf_dataset, self.network_config, device=self.device)
        task = self.task
        if not isinstance(task, task_type):
            raise RuntimeError("load the image before its snapshot: an image snapshot holds "
                               "no image")
        params = snapshot_io.restore_params(snap, model_io.params_to_numpy(task.model))
        opt_state = None
        if "optimizer_state" in snap:
            opt_state = snapshot_io.unpack_tree(snap["optimizer_state"], task.opt_state_tree())
        step = int(snap.get("training_step", 0))
        if nerf:
            cam = None
            if "cam_offsets" in snap:
                cam = snapshot_io.unpack_tree(snap["cam_offsets"], task.cam_offsets)
            task.load_state(params, opt_state,
                            snapshot_io.restore_density_grid(snap, task.max_cascade + 1), step,
                            cam)
        else:
            task.load_state(params, opt_state, step)
        self.training_step = task.training_step

    def render(self, *args, **kwargs) -> np.ndarray:
        """The frame of ``render_tensor`` as a numpy (H, W, 4) f32 array
        (pyngp render_to_cpu; the JAX package's testbed.py:1196-1248)."""
        return self.render_tensor(*args, **kwargs).cpu().numpy()

    def render_tensor(self, *args, **kwargs) -> torch.Tensor:
        """NeRF: ``NerfTask.render``'s arguments and frame. Image:
        ``render(width, height, linear=True)`` → (H, W, 4) with alpha 1, in
        linear colour unless ``linear`` is False (testbed.py:1245-1248). A
        tensor on the task's device."""
        if self.task is None:
            raise RuntimeError("load a snapshot or training data before rendering")
        if self.mode == TestbedMode.IMAGE:
            return self._render_image(*args, **kwargs)
        return self.task.render(*args, **kwargs)

    def _render_image(self, width: int, height: int, linear: bool = True) -> torch.Tensor:
        rgb = self.task.render(width, height)
        frame = torch.cat([rgb, torch.ones_like(rgb[..., :1])], dim=-1)
        produced_linear = bool(self.task.is_hdr)
        if produced_linear == linear:
            return frame
        if produced_linear:
            rgb = linear_to_srgb(torch.clamp(rgb, min=0.0))
        else:
            rgb = srgb_to_linear(torch.clamp(rgb, 0.0, 1.0))
        return torch.cat([rgb, frame[..., 3:]], dim=-1)

    def compute_image_mse(self, quantize_to_byte: bool = False) -> float:
        return self.task.compute_mse(quantize_to_byte)

    def frame(self) -> bool:
        """One tick: a training step while ``shall_train`` (reference
        frame → train_and_render, testbed.cu:3908-4034). A step that
        marched no sample stops training."""
        if self.shall_train and self.task is not None:
            loss = self.task.train(1)
            self.training_step = self.task.training_step
            self._loss_ema.update(loss)
            self.loss_graph.append(loss)
            if getattr(self.task, "training_aborted", False):
                self.shall_train = False
        return True

    def train(self, batch_size=None) -> None:
        self.frame()

    @property
    def loss(self) -> float:
        return self._loss_ema.value
