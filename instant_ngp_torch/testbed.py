"""A minimal NeRF ``Testbed`` (port of the scene-free snapshot branch and
the training tick of ``instant_ngp_tpu/testbed.py``): load a ``.ingp``
snapshot and render frames from it, or train a task set from an in-memory
dataset.

    tb = Testbed("nerf", device="cuda")
    tb.load_snapshot("data/fox_1536.ingp")
    frame = tb.render(256, 256, camera_matrix, focal_length=..., ...)

    tb = Testbed("nerf", device="cuda")
    tb.nerf_dataset, tb.network_config = ds, cfg
    tb.task = NerfTask(ds, cfg, "cuda", n_rays_per_batch=4096, ...)
    for _ in range(n):
        tb.frame()  # one training step; tb.loss is its EMA
"""

from __future__ import annotations

import numpy as np
import torch

from . import snapshot as snapshot_io
from .io.nerf_loader import NerfDataset
from .models.nerf_network import params_from_jax, params_to_numpy
from .nerf.task import NerfTask


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


class Testbed:
    def __init__(self, mode: str = "nerf", device="cpu"):
        if str(mode).lower() != "nerf":
            raise NotImplementedError(f"testbed mode {mode!r} is not ported yet")
        self.mode = "nerf"
        self.device = torch.device(device)
        self.task: NerfTask | None = None
        self.nerf_dataset: NerfDataset | None = None
        self.network_config: dict = {}
        self.training_step = 0
        self.shall_train = True
        self.loss_graph: list[float] = []
        self._loss_ema = LossEma()

    def load_snapshot(self, path) -> None:
        doc = snapshot_io.load_snapshot_file(path)
        snap = doc["snapshot"]
        if snap["mode"] != "nerf":
            raise NotImplementedError(f"snapshot mode {snap['mode']!r} is not ported yet")
        self.network_config = {k: v for k, v in doc.items() if k != "snapshot"}
        optimizer = self.network_config.get("optimizer", {})
        if optimizer.get("otype", "").lower() == "ema" and "optimizer_state" in snap:
            # the JAX package renders the saved parameter EMA here
            raise NotImplementedError("rendering a snapshot's saved parameter EMA is not ported yet")
        if "nerf" not in snap or "dataset" not in snap["nerf"]:
            raise RuntimeError("snapshot lacks a dataset block and no scene is loaded")
        ds = _empty_nerf_dataset_from_snapshot(snap)
        self.nerf_dataset = ds
        task = NerfTask(ds, self.network_config, device=self.device)
        params = snapshot_io.restore_params(snap, params_to_numpy(task.model))
        params_from_jax(task.model, params)
        grid = snapshot_io.restore_density_grid(snap, task.max_cascade + 1)
        if grid is not None:
            task.set_density_grid(torch.from_numpy(grid))
        task.training_step = int(snap.get("training_step", 0))
        self.task = task
        self.training_step = task.training_step

    def render(self, *args, **kwargs) -> torch.Tensor:
        if self.task is None:
            raise RuntimeError("load a snapshot before rendering")
        return self.task.render(*args, **kwargs)

    def frame(self) -> bool:
        """One tick: a training step while ``shall_train`` (reference
        frame → train_and_render, testbed.cu:3908-4034). A step that
        marched no sample stops training."""
        if self.shall_train and self.task is not None:
            loss = self.task.train(1)
            self.training_step = self.task.training_step
            self._loss_ema.update(loss)
            self.loss_graph.append(loss)
            if self.task.training_aborted:
                self.shall_train = False
        return True

    def train(self, batch_size=None) -> None:
        self.frame()

    @property
    def loss(self) -> float:
        return self._loss_ema.value
