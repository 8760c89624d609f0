"""The NeRF task (port of ``instant_ngp_tpu/nerf/task.py``): the scene's
model, occupancy grid and training state, the render loop here, and the
training step in ``nerf/train.py`` (reference testbed_nerf.cu:1894-2150,
2704-3382).

A frame renders in windows: march a K = 8 sample window for the alive
rays (kernel C), evaluate the model on the valid samples (kernels A and
B), composite the window (kernel D), and repeat while any ray is alive.
Alive rays and valid samples are compacted with plain index ops between
the steps. A ray stays alive while it is transparent enough, has scene
left and made marching progress in its last window. Rendering and grid
updates read the inference parameters: the optimizer's parameter EMA once
training has made one, as the JAX package does (task.py:2169).

``composite_window`` launches kernel D (``csrc/composite.cu``) on CUDA
tensors and runs ``composite_window_plain`` on CPU tensors.

Two faster render qualities read a bake of the model instead of the model:
"baked" (``nerf/baked.py``: a round is the march, then one launch of the
baked round for the samples' table rows and the composite) and "slab"
(``nerf/slab.py``: dense volumes swept slab by slab, kernels P and O).
Each bake is cached on the task, keyed on the step, its settings and the
route (kernels or plain versions).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.func import functional_call

from .. import cuda_lib
from ..common import (
    ACTIVATION_CODES,
    EPS_T,
    MAX_DEPTH,
    MIN_CONE_STEPSIZE,
    NERF_CASCADES,
    NERF_GRIDSIZE,
    LensMode,
    NerfActivation,
    fma,
    linear_to_srgb,
    network_to_density,
    network_to_rgb,
    warp_direction,
)
from ..io.nerf_loader import NerfDataset
from ..models.factory import autoconfig_grid_encoding
from ..models.nerf_network import NerfNetwork, flat_from_tree, params_from_jax, tree_from_flat
from ..ops.gather import bilinear_read_differentiable
from ..ops.losses import loss_type_from_string
from ..ops.optimizers import (Optimizer, OptimizerSpec, camera_optimizer, camera_optimizer_spec,
                              state_from_tree, state_to_tree)
from ..ops.raymarch import ray_intersect_aabb
from ..parallel import sharding
from ..render.camera import so3_exp, uv_to_ray_cam
from . import baked, slab
from . import train as nerf_train
from .occupancy import OccupancyGrid, mark_untrained_cells
from .sampler import MarchConfig, march_rays, march_rays_plain

# rays per render pass: bounds the (rays, K) window buffers of a large frame
RENDER_CHUNK = 1 << 18
DISTORTION_SHAPE = (32, 32, 2)  # the trainable uv offset map (configs/nerf/base.json)
ENVMAP_RESOLUTION = (128, 256)  # (EH, EW) of the trainable lat-long environment map


def running_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum over the last dimension in x's dtype, one
    element after another."""
    cols, acc = [], torch.zeros_like(x[..., 0])
    for k in range(x.shape[-1]):
        acc = acc + x[..., k]
        cols.append(acc)
    return torch.stack(cols, dim=-1)


def composite_window_plain(out, ts, dts, valid, t, t_exit, T, rgb, depth, alive, tmax, cost,
                           eps_t: float, rgb_activation: NerfActivation,
                           density_activation: NerfActivation, activated: bool = False):
    """Composite one (R, K) window of network outputs onto the rays'
    running (T, rgb, depth). The weight of sample k is (1 − e^{−τ_k})·T·
    e^{−Σ_{j<k} τ_j} with τ = σ·dt. Returns the new (t, T, rgb, depth,
    alive, cost).

    The exponent is −cumsum(τ)_k + τ_k, as the JAX package writes it: past
    a dense sample (τ ~ 1e3) it keeps only that sum's last bits, so a
    one-ulp change of the running sum moves a weight by ~1e-4 of itself.
    The running sum is therefore taken in f32, one sample after another:
    the order of kernel D and of XLA's cumsum (a reduce-window), where
    torch.cumsum accumulates in f64 on the CPU and by a parallel scan on
    the GPU. ``activated``: out holds activated [r, g, b, σ] (a baked
    render's samples), read as they are (task.py:1853-1860); the baked
    round's plain version (``baked.render_round_plain``) composites so."""
    if activated:
        rgb_s = out[..., :3].to(torch.float32)
        sigma = out[..., 3].to(torch.float32)
    else:
        rgb_s = network_to_rgb(out[..., :3].to(torch.float32), rgb_activation)
        sigma = network_to_density(out[..., 3].to(torch.float32), density_activation)
    sigma = torch.where(valid, sigma, 0.0)
    tau = sigma * dts
    T_cum = T[:, None] * torch.exp(-running_sum(tau) + tau)
    weight = (1.0 - torch.exp(-tau)) * T_cum
    rgb = rgb + torch.sum(weight[..., None] * rgb_s, dim=1)
    depth = depth + torch.sum(weight * ts, dim=1)
    T_new = T * torch.exp(-torch.sum(tau, dim=-1))
    # alive: transparent enough, scene left, AND marching progress this
    # window (zero progress ⇔ the march left the aabb or passed MAX_DEPTH)
    progressed = t_exit > t
    alive = alive & (T_new >= eps_t) & (t_exit < tmax) & progressed
    cost = cost + torch.sum(valid, dim=-1).to(torch.float32)
    return t_exit, T_new, rgb, depth, alive, cost


def composite_window(out, ts, dts, valid, t, t_exit, T, rgb, depth, alive, tmax, cost,
                     eps_t: float, rgb_activation: NerfActivation,
                     density_activation: NerfActivation, activated: bool = False):
    """See ``composite_window_plain``. CPU tensors run the plain version;
    CUDA tensors launch kernel D (one thread per ray). The activated
    composite has no kernel of its own: the baked round
    (``baked.render_round``) does it together with the samples' lookups."""
    if out.device.type == "cpu":
        return composite_window_plain(out, ts, dts, valid, t, t_exit, T, rgb, depth, alive, tmax,
                                      cost, eps_t, rgb_activation, density_activation, activated)
    if activated:
        raise ValueError("the activated composite has no CUDA kernel of its own: a baked "
                         "render's round launches baked.render_round")
    R, K = ts.shape
    f32 = [out, ts, dts, t, t_exit, T, rgb, depth, tmax, cost]
    cuda_lib.check_cuda(*f32, dtype=torch.float32)
    cuda_lib.check_cuda(valid, alive, dtype=torch.bool)
    if out.shape != (R, K, 4) or rgb.shape != (R, 3):
        raise ValueError(f"composite shapes out {tuple(out.shape)}, rgb {tuple(rgb.shape)} "
                         f"for a ({R}, {K}) window")
    T_new = torch.empty_like(T)
    rgb_new = torch.empty_like(rgb)
    depth_new = torch.empty_like(depth)
    alive_new = torch.empty_like(alive)
    cost_new = torch.empty_like(cost)
    if R > 0:
        ptrs = (out.data_ptr(), ts.data_ptr(), dts.data_ptr(), valid.data_ptr(), t.data_ptr(),
                t_exit.data_ptr(), T.data_ptr(), rgb.data_ptr(), depth.data_ptr(),
                alive.data_ptr(), tmax.data_ptr(), cost.data_ptr(), R, K, eps_t)
        outs = (T_new.data_ptr(), rgb_new.data_ptr(), depth_new.data_ptr(),
                alive_new.data_ptr(), cost_new.data_ptr())
        cuda_lib.launch("composite_window", *ptrs, ACTIVATION_CODES[rgb_activation],
                        ACTIVATION_CODES[density_activation], *outs)
    return t_exit, T_new, rgb_new, depth_new, alive_new, cost_new


class NerfTask:
    """A NeRF scene: model, optimizer, occupancy grid, error map, aabb and
    crop box, the render loop and ``train``. Built from a dataset (loaded
    from disk by ``Testbed.load_training_data``, built in memory, or from a
    snapshot's dataset block by ``Testbed.load_snapshot``); a snapshot's
    state loads onto it with ``load_state``. The constructor follows the
    JAX package's (task.py:91-461) for the options this slice ports."""

    def __init__(self, dataset: NerfDataset, config: dict, device, seed: int = 1337,
                 target_batch_size: int = 1 << 18, n_rays_per_batch: int = 1 << 13,
                 max_samples_per_ray: int = 48, n_march_iters: int = 256,
                 optimize_extrinsics: bool = False, optimize_exposure: bool = False,
                 optimize_focal_length: bool = False, optimize_distortion: bool = False,
                 train_envmap: bool = False, envmap_resolution: tuple = ENVMAP_RESOLUTION,
                 use_error_map: bool = True, include_sharpness_in_error: bool = False):
        self.dataset = dataset
        self.config = dict(config)
        self.device = torch.device(device)
        # AABB from aabb_scale: unit cube inflated around its center
        aabb_scale = dataset.aabb_scale
        half = 0.5 * min(1 << (NERF_CASCADES - 1), aabb_scale)
        self.aabb_min = np.array([0.5 - half] * 3, np.float32)
        self.aabb_max = np.array([0.5 + half] * 3, np.float32)
        self.max_cascade = 0
        while (1 << self.max_cascade) < aabb_scale:
            self.max_cascade += 1
        self.cone_angle = 0.0 if aabb_scale <= 1 else 1.0 / 256.0
        self.config["encoding"] = autoconfig_grid_encoding(
            self.config.get("encoding", {}), "nerf", aabb_scale=aabb_scale)
        self.model = NerfNetwork.from_config(self.config,
                                             n_extra_dims=dataset.n_extra_learnable_dims,
                                             device=self.device)
        # LDR datasets train in sRGB space with a logistic rgb activation
        self.rgb_activation = (NerfActivation.EXPONENTIAL if dataset.is_hdr
                               else NerfActivation.LOGISTIC)
        self.density_activation = NerfActivation.EXPONENTIAL
        self.min_transmittance = EPS_T
        # per-window iteration budget and sample window of rendering
        self.render_march_iters = 64
        self.render_samples_per_window = 8
        self.render_near_distance = 0.0
        # the baked render (task.py:394-399): a window of 16 samples, the
        # finest cascade baked at 256^3; the slab render (task.py:400-420):
        # levels of an eye-centred clipmap, the finest 0.25 across at 256^3,
        # the outer ones at 192^3, deferred view dependence through 3 PCA
        # features of the density MLP's output (or a per-camera bake)
        self.baked_samples_per_window = 16
        self.baked_res0 = 256
        self._baked_cache = None  # (key, BakedCache)
        self._slab_cache = None  # (key, DenseVolumes, the rgb head at the bake)
        self.slab_res0 = 256
        self.slab_res_outer = 192
        self.slab_finest_extent = 0.25
        self.slab_bake_view_dependent = False
        self.slab_deferred_vd = True
        self.slab_n_feat = 3
        self._slab_feat_proj = None  # the frozen (mu, sd, P) PCA basis
        # a torch.distributed process group: the training step and the slab's
        # warp are data-parallel over it (parallel/sharding.py)
        self.mesh = None
        # render crop box: the dataset crop intersected with the scene
        # aabb; an empty intersection means no crop
        self.render_aabb_min = np.array(self.aabb_min)
        self.render_aabb_max = np.array(self.aabb_max)
        if dataset.render_aabb is not None:
            lo = np.maximum(np.asarray(dataset.render_aabb[0], np.float32), self.render_aabb_min)
            hi = np.minimum(np.asarray(dataset.render_aabb[1], np.float32), self.render_aabb_max)
            if (hi > lo).all():
                self.render_aabb_min = lo
                self.render_aabb_max = hi
        # the crop box is axis-aligned in the frame this rotation reaches
        # (reference render_aabb_to_local, testbed_nerf.cu:1472)
        self.render_aabb_to_local = np.eye(3, dtype=np.float32)
        if dataset.render_aabb_to_local is not None:
            self.render_aabb_to_local = np.asarray(dataset.render_aabb_to_local, np.float32)
        # thin-lens depth of field: aperture radius 0 is a pinhole
        self.aperture_size = 0.0
        self.focus_z = 1.0
        # the first of the three encoding features the encodingvis mode shows
        self.visualized_dimension = 0
        self._aabb_t = (self._t(self.aabb_min), self._t(self.aabb_max))
        self.use_kernels = True

        # --- camera optimization (task.py:111-147, 261-293) ---
        self.optimize_extrinsics = optimize_extrinsics
        self.optimize_exposure = optimize_exposure
        self.optimize_focal_length = optimize_focal_length
        self.optimize_distortion = optimize_distortion
        self.train_envmap = train_envmap
        self.envmap_resolution = tuple(envmap_resolution)  # (EH, EW)
        # per-image latents train whenever present; False pins them
        self.optimize_extra_dims = dataset.n_extra_learnable_dims > 0
        self.exposure_l2_reg = 0.0  # decoupled decays of the exposure and focal offsets
        self.intrinsic_l2_reg = 1e-4
        # the latents renders read: a training view's (>= 0), or the vector
        # set_rendering_extra_dims gave (-1)
        self.rendering_extra_dims_from_training_view = 0
        self._rendering_extra_dims = None
        # the reference applies a camera step every so many steps; the camera
        # here takes a step every training step at a rate divided by it
        self.n_steps_between_cam_updates = 16
        self.max_level_rand_training = False  # per-ray coarse-to-fine level cap
        self.train_mode = "nerf"  # "nerf" | "rfl" | "rflrelax", read every step

        # --- training (task.py:172-461) ---
        self.loss_type = loss_type_from_string(self.config.get("loss", {}).get("otype", "Huber"))
        self.march_cfg = MarchConfig(n_march_iters=n_march_iters,
                                     max_samples_per_ray=max_samples_per_ray,
                                     cone_angle=self.cone_angle, max_mip=self.max_cascade)
        self.n_rays_per_batch = n_rays_per_batch
        self.n_rays_current = n_rays_per_batch
        self.target_batch_size = target_batch_size
        self.max_ray_bucket_log2 = 13  # adaptive rays per batch: at most 2^13
        self.compact_samples = target_batch_size // 2  # network sample capacity
        self.random_bg_color = True
        self.snap_to_pixel_centers = True
        self.training_near_distance = 0.1  # near-camera density penalty distance
        # depth supervision (task.py:188-191, 445): on where the scene has depth maps
        self.depth_supervision_lambda = 1.0 if dataset.depths is not None else 0.0
        self.depth_loss_type = "L1"
        self.density_reg_scale = 1.0
        self.density_grid_decay = 0.95
        self.grid_update_interval = 16
        self.exact_corners_after: int | None = 256  # stochastic table gradients before
        self.training_aborted = False
        self.training_step = 0
        # pyngp's freeze toggles: a frozen part takes no update while Adam's
        # moments advance (task.py:1082-1092)
        self.shall_train_encoding = True
        self.shall_train_network = True
        # the last step's device stats, kept across train() calls: they size
        # the next grid update's ray count (see nerf/train.train)
        self.last_stats: dict | None = None
        init_gen = torch.Generator(device=self.device).manual_seed(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed ^ 0xBEEF)
        self.model.init(init_gen)
        names = {id(p): name for name, p in self.model.named_parameters()}
        self._param_names = [names[id(p)] for p in self.model.param_list()]
        self.opt = Optimizer(OptimizerSpec.from_config(self.config.get("optimizer", {})),
                             self.model.matrix_mask())
        self.use_error_map = use_error_map
        # the reference's two toggles (testbed.h:810-811): the image pick and
        # the pixel pick, each error-proportional on its own
        self.sample_image_proportional_to_error = use_error_map
        self.sample_focal_plane_proportional_to_error = use_error_map
        self.error_map_res = nerf_train.error_map_res(n_rays_per_batch, dataset.n_images,
                                                      dataset.resolution)
        # the optimizer state is made at the first training step
        # (optimizer_state): a task that only renders holds none
        self.include_sharpness_in_error = include_sharpness_in_error
        self.state = nerf_train.NerfTrainState(
            opt_state=None,
            grid=OccupancyGrid(self.max_cascade + 1, self.device),
            error_map=torch.zeros((dataset.n_images, *self.error_map_res), dtype=torch.float32,
                                  device=self.device),
            sharp_grid=(torch.zeros((NERF_CASCADES,) + (NERF_GRIDSIZE,) * 3, dtype=torch.float32,
                                    device=self.device) if include_sharpness_in_error else None))
        # error-map importance sampling: CDFs rebuilt on a growing interval
        eh, ew = self.error_map_res
        n_img = dataset.n_images
        self.cdf_x = torch.zeros((n_img, eh, ew), device=self.device)
        self.cdf_y = torch.zeros((n_img, eh), device=self.device)
        self.cdf_img = torch.zeros((n_img,), device=self.device)
        self.pmf_img = torch.full((n_img,), 1.0 / n_img, device=self.device)
        self.cdf_valid = False
        self.err_interval = 128  # reference n_steps_between_error_map_updates
        self.err_steps_since = 0
        # the dataset on the device (the images at their first training read),
        # with the constants a training step reads, so that a step makes no
        # host-to-device copy (each would wait for the card)
        self._images = None
        self.xforms = self._t(dataset.xforms_start)
        self.focals = self._t(dataset.focal_lengths)
        self.principals = self._t(dataset.principal_points)
        self.lens_params = self._t(dataset.lens_params)
        self.resolution_t = self._t(dataset.resolution)
        self.error_map_wh = self._t([ew, eh])
        # a moving camera: each pixel's transform is slerped between the start
        # and end transforms at its shutter time (task.py:334-358)
        self.has_motion = bool(not np.allclose(dataset.xforms_start, dataset.xforms_end)
                               or np.any(np.asarray(dataset.rolling_shutter) != 0))
        self.xforms_end = self._t(dataset.xforms_end) if self.has_motion else None
        self.rolling_shutter = self._t(dataset.rolling_shutter) if self.has_motion else None
        self.depths = None if dataset.depths is None else self._t(dataset.depths)
        self.img_wh = (None if dataset.per_image_resolution is None else torch.as_tensor(
            np.asarray(dataset.per_image_resolution, np.int64), device=self.device))
        # supplied rays as an (N·H·W, 6) table, read through kernel I's row gather;
        # they bypass the near distance and the cameras' visibility culling
        self.rays = None
        if dataset.rays is not None:
            self.rays = self._t(np.asarray(dataset.rays, np.float32).reshape(-1, 6))
            self.training_near_distance = 0.0
        self.sharpness = (self._t(dataset.compute_sharpness_maps())
                          if include_sharpness_in_error else None)
        # the camera state (task.py:261-293): per-image rotation (axis-angle)
        # and position offsets, exposure (log2, per channel), a shared focal
        # scale, per-image latents ("extra", 0.1·N(0, 1)) and a 32×32 uv offset
        # map ("distortion"), each an f32 tensor on the device; Adam over them
        # (camera_optimizer), its state made at the first step that needs it
        dev = self.device
        self.cam_offsets = {k: torch.zeros(shape, dtype=torch.float32, device=dev)
                            for k, shape in (("rot", (n_img, 3)), ("pos", (n_img, 3)),
                                             ("exposure", (n_img, 3)), ("focal", (2,)))}
        if dataset.n_extra_learnable_dims > 0:
            extra_gen = torch.Generator(device=dev).manual_seed(seed ^ 0xE17A)
            self.cam_offsets["extra"] = 0.1 * torch.randn(
                (n_img, dataset.n_extra_learnable_dims), generator=extra_gen, device=dev)
        if optimize_distortion:
            self.cam_offsets["distortion"] = torch.zeros(DISTORTION_SHAPE, dtype=torch.float32,
                                                         device=dev)
        if train_envmap:
            # the trainable lat-long RGBA environment map (reference envmap
            # TrainableBuffer, testbed.cu:4391-4409), trained with the camera state
            self.cam_offsets["envmap"] = torch.zeros((*self.envmap_resolution, 4),
                                                     dtype=torch.float32, device=dev)
        self.cam_opt_spec = camera_optimizer_spec()

    @property
    def images(self) -> torch.Tensor:
        if self._images is None:
            self._images = torch.as_tensor(self.dataset.images, device=self.device)
        return self._images

    def set_training_image(self, frame_idx: int, img, depth_img=None,
                           depth_scale: float = 1.0) -> None:
        """Replace one training image at run time (pyngp
        ``nerf.training.set_image``, task.py:1337-1359): float (H, W, 4) in
        the dataset's training colour space, stored as the loader stores it
        (uint8 sRGB, or float16 for an HDR scene); and its depth map (H, W),
        scaled by ``depth_scale`` and the scene scale, as the loader scales
        it, where the scene has depth maps."""
        ds = self.dataset
        if not 0 <= int(frame_idx) < ds.n_images:
            raise IndexError(f"invalid frame index {frame_idx}")
        img = np.asarray(img, np.float32)
        expect = (ds.resolution[1], ds.resolution[0], 4)
        if img.shape != expect:
            raise ValueError(f"image should be {expect}, got {img.shape}")
        if ds.is_hdr:
            stored = img.astype(np.float16)
        else:
            stored = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        ds.images[frame_idx] = stored
        if self._images is not None:
            self._images[int(frame_idx)] = torch.from_numpy(stored).to(self.device)
        if depth_img is not None:
            if ds.depths is None:
                raise ValueError("dataset has no depth channel; load with depth maps to "
                                 "supervise depth (nerf_loader depth_path)")
            depth = np.asarray(depth_img, np.float32) * float(depth_scale) * float(ds.scale)
            ds.depths[frame_idx] = depth
            self.depths[int(frame_idx)] = self._t(depth)

    @property
    def skipmip(self) -> torch.Tensor:
        return self.state.grid.skipmip

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def set_density_grid(self, density: torch.Tensor) -> None:
        """Take a (n_cascades, G, G, G) float density grid: derive the
        bitfield and the skip chain the marcher reads. The grid's update
        count stays, as the JAX package's snapshot load keeps it."""
        self.state.grid.set_density(density, ema_step=self.state.grid.ema_step)

    def opt_state_tree(self) -> dict:
        """The optimizer state as the JAX package's tree of numpy arrays;
        before the first training step, the state that step would start
        from."""
        state = self.state.opt_state or self.opt.init(self.model.param_list())
        return state_to_tree(state, lambda flat: tree_from_flat(self.model, flat))

    @torch.no_grad()
    def load_state(self, params: dict, opt_state: dict | None = None,
                   density_grid: np.ndarray | None = None, training_step: int = 0,
                   cam_offsets: dict | None = None) -> None:
        """Load a snapshot's state onto this task, as the JAX package's
        ``Testbed.load_snapshot`` does (testbed.py:2188-2222): the
        parameters; the optimizer state, or a fresh one from the loaded
        parameters; the density grid with its bitfield and skip chain; the
        step; the camera offsets. Trees are numpy trees in the JAX layout.
        The images, the error map and the grid's update count stay."""
        params_from_jax(self.model, params)
        if opt_state is None:
            self.state.opt_state = self.opt.init(self.model.param_list())
        else:
            self.state.opt_state = state_from_tree(
                opt_state, lambda tree: flat_from_tree(self.model, tree), self.device)
        if density_grid is not None:
            self.set_density_grid(torch.from_numpy(np.asarray(density_grid, np.float32)))
        self.training_step = int(training_step)
        if cam_offsets is not None:
            self.set_camera_offsets(cam_offsets)

    def set_camera_offsets(self, tree: dict) -> None:
        """Take a camera-offset tree of numpy arrays in the JAX layout (a
        snapshot's ``cam_offsets``): rot, pos, exposure and focal of this
        scene's shapes, and where present extra (n, E), distortion (h, w, 2)
        and envmap (h, w, 4). The camera optimizer's state stays where the
        leaves keep their shapes, as the JAX package's load keeps its
        ``cam_opt``."""
        n = self.dataset.n_images
        want = {"rot": (n, 3), "pos": (n, 3), "exposure": (n, 3), "focal": (2,)}
        shapes = {k: tuple(np.shape(v)) for k, v in tree.items()}
        extra, dist, env = shapes.get("extra"), shapes.get("distortion"), shapes.get("envmap")
        if ({k: shapes.get(k) for k in want} != want
                or set(shapes) - set(want) - {"extra", "distortion", "envmap"}
                or (extra is not None and (len(extra) != 2 or extra[0] != n))
                or (dist is not None and (len(dist) != 3 or dist[2] != 2))
                or (env is not None and (len(env) != 3 or env[2] != 4))):
            raise ValueError(f"camera offsets {shapes} do not fit this scene's {n} images")
        before = {k: tuple(v.shape) for k, v in self.cam_offsets.items()}
        self.cam_offsets = {k: torch.tensor(np.asarray(v, np.float32), device=self.device)
                            for k, v in tree.items()}
        if {k: tuple(v.shape) for k, v in self.cam_offsets.items()} != before:
            self.state.cam_opt = None

    # --- the camera state (task.py:1202-1336, 1746-1770) ---
    @property
    def cam_offsets(self) -> dict:
        """The camera offsets, name → f32 tensor on the task's device
        (``state.cam``)."""
        return self.state.cam

    @cam_offsets.setter
    def cam_offsets(self, cam: dict) -> None:
        self.state.cam = cam

    def camera_keys(self) -> list[str]:
        """The camera leaves in the JAX tree's order (sorted keys)."""
        return sorted(self.cam_offsets)

    def camera_optimizer(self) -> Optimizer:
        return camera_optimizer(self.cam_opt_spec, self.camera_keys())

    def camera_optimizer_state(self) -> dict:
        """The camera optimizer's state, made from the offsets at its first
        use (zero moments, step 0)."""
        if self.state.cam_opt is None:
            self.state.cam_opt = self.camera_optimizer().init(
                [self.cam_offsets[k] for k in self.camera_keys()])
        return self.state.cam_opt

    def optimizes_camera(self) -> bool:
        """Whether a step differentiates the camera state (task.py:894-898):
        a flag is on, or the state holds latents, a distortion map or an
        environment map."""
        return (self.optimize_extrinsics or self.optimize_exposure or self.optimize_focal_length
                or any(k in self.cam_offsets for k in ("extra", "distortion", "envmap")))

    def cam_offsets_numpy(self) -> dict:
        """The camera offsets as the JAX package's tree of numpy arrays."""
        return {k: v.detach().cpu().numpy() for k, v in self.cam_offsets.items()}

    def set_camera_optimizer_hparams(self, extrinsic_learning_rate=None,
                                     extrinsic_l2_reg=None) -> None:
        """pyngp extrinsic_learning_rate / extrinsic_l2_reg (task.py:
        1202-1220): the camera takes a step every training step, so the rate
        is the given one divided by ``n_steps_between_cam_updates``."""
        import dataclasses

        spec = self.cam_opt_spec
        if extrinsic_learning_rate is not None:
            spec = dataclasses.replace(spec, learning_rate=float(extrinsic_learning_rate)
                                       / max(int(self.n_steps_between_cam_updates), 1))
        if extrinsic_l2_reg is not None:
            spec = dataclasses.replace(spec, l2_reg=float(extrinsic_l2_reg))
        self.cam_opt_spec = spec

    @torch.no_grad()
    def find_closest_training_view(self, pose) -> int:
        """The training view whose offset camera is nearest ``pose`` by
        position distance + 0.25 × z-axis distance (task.py:1222-1238)."""
        xf = np.asarray(self.dataset.xforms_start, np.float32)
        rot = so3_exp(self.cam_offsets["rot"].cpu()).numpy()
        R_eff = np.einsum("nij,njk->nik", rot, xf[:, :, :3])
        t_eff = xf[:, :, 3] + self.cam_offsets["pos"].cpu().numpy()
        pose = np.asarray(pose, np.float32)
        score = (np.linalg.norm(t_eff - pose[:, 3], axis=-1)
                 + 0.25 * np.linalg.norm(R_eff[:, :, 2] - pose[:, 2], axis=-1))
        return int(np.argmin(score))

    def get_extra_dims(self, view: int) -> np.ndarray:
        """The trained latent code of one training view (task.py:1240-1248);
        empty where the scene has none."""
        if "extra" not in self.cam_offsets:
            return np.zeros((0,), np.float32)
        v = int(view)
        if not 0 <= v < self.dataset.n_images:
            raise IndexError(f"invalid training view {view}")
        return self.cam_offsets["extra"][v].detach().cpu().numpy()

    @torch.no_grad()
    def set_camera_extrinsics(self, frame_idx: int, camera_to_world,
                              convert_to_ngp: bool = True, xform_end=None,
                              rolling_shutter=None) -> None:
        """Replace one training camera's pose (task.py:1250-1284): the
        dataset's and the device's start and end transforms (the end the
        start where not given) and rolling shutter (where given), that
        frame's rot, pos and exposure offsets zeroed, and the camera
        optimizer's state made anew. As in the JAX package, a task whose
        camera was still at its load keeps sampling the start transform."""
        ds = self.dataset
        i = int(frame_idx)
        if not 0 <= i < ds.n_images:
            raise IndexError(f"invalid frame index {frame_idx}")
        m = np.asarray(camera_to_world, np.float32).reshape(3, 4)
        m_end = m if xform_end is None else np.asarray(xform_end, np.float32).reshape(3, 4)
        if convert_to_ngp:
            m = ds.nerf_matrix_to_ngp(m)
            m_end = ds.nerf_matrix_to_ngp(m_end)
        ds.xforms_start[i] = m
        ds.xforms_end[i] = m_end
        self.xforms[i] = self._t(m)
        if self.xforms_end is not None:
            self.xforms_end[i] = self._t(m_end)
        if rolling_shutter is not None:
            rs = np.asarray(rolling_shutter, np.float32).reshape(4)
            ds.rolling_shutter[i] = rs
            if self.rolling_shutter is not None:
                self.rolling_shutter[i] = self._t(rs)
        for k in ("rot", "pos", "exposure"):
            self.cam_offsets[k][i] = 0.0
        self.state.cam_opt = None

    def set_camera_intrinsics(self, frame_idx: int, fx: float = 0.0, fy: float = 0.0,
                              cx: float = -0.5, cy: float = -0.5, k1: float = 0.0,
                              k2: float = 0.0, p1: float = 0.0, p2: float = 0.0,
                              k3: float = 0.0, k4: float = 0.0, is_fisheye: bool = False) -> None:
        """One frame's focal length and principal point (a negative c is a
        fraction of the image, as given), and the lens of the whole dataset
        where any coefficient is set (task.py:1296-1336)."""
        ds = self.dataset
        i = int(frame_idx)
        if not 0 <= i < ds.n_images:
            raise IndexError(f"invalid frame index {frame_idx}")
        fx, fy = float(fx), float(fy)
        if fx <= 0.0:
            fx = fy
        if fy <= 0.0:
            fy = fx
        w, h = ds.resolution
        cx = -float(cx) if cx < 0 else float(cx) / w
        cy = -float(cy) if cy < 0 else float(cy) / h
        ds.focal_lengths[i] = (fx, fy)
        ds.principal_points[i] = (cx, cy)
        self.focals[i] = self._t([fx, fy])
        self.principals[i] = self._t([cx, cy])
        if any((k1, k2, k3, k4, p1, p2)):
            if is_fisheye:
                ds.lens_mode = LensMode.OPENCV_FISHEYE.value
                ds.lens_params = np.array([k1, k2, k3, k4], np.float32)
            else:
                ds.lens_mode = LensMode.OPENCV.value
                ds.lens_params = np.array([k1, k2, p1, p2], np.float32)
            self.lens_params = self._t(ds.lens_params)

    @torch.no_grad()
    def reset_camera_extrinsics(self) -> None:
        """Zero every trained pose and exposure offset and make the camera
        optimizer's state anew (pyngp reset_camera_extrinsics)."""
        for k in ("rot", "pos", "exposure"):
            self.cam_offsets[k].zero_()
        self.state.cam_opt = None

    def render_extra_vec(self) -> torch.Tensor | None:
        """The (E,) latents renders condition on (task.py:1746-1759): the
        training view ``rendering_extra_dims_from_training_view`` (clamped to
        the last), or the vector ``set_rendering_extra_dims`` gave, or zeros;
        None where the model has no latent dims."""
        ne = self.model.n_extra_dims
        if not ne or "extra" not in self.cam_offsets:
            return None
        v = int(self.rendering_extra_dims_from_training_view)
        if v >= 0:
            return self.cam_offsets["extra"][min(v, self.dataset.n_images - 1)].detach()
        if self._rendering_extra_dims is not None:
            return self._t(self._rendering_extra_dims)
        return torch.zeros((ne,), dtype=torch.float32, device=self.device)

    def set_rendering_extra_dims(self, vals) -> None:
        """Render with an explicit latent vector (task.py:1761-1770)."""
        ne = self.model.n_extra_dims
        vals = np.asarray(vals, np.float32).reshape(-1)
        if vals.shape[0] != ne:
            raise ValueError(f"expected {ne} extra dims, got {vals.shape[0]}")
        self._rendering_extra_dims = vals
        self.rendering_extra_dims_from_training_view = -1

    def optimizer_state(self) -> dict:
        """The optimizer state, made from the current parameters at its
        first use (zero moments, step 0, the EMA equal to the parameters),
        as the JAX package initializes it for a new or loaded model."""
        if self.state.opt_state is None:
            self.state.opt_state = self.opt.init(self.model.param_list())
        return self.state.opt_state

    def inference_params(self) -> dict:
        """The parameters rendering and grid updates read, by name: the
        optimizer's parameter EMA once training has made one, else the
        model's own."""
        params = self.model.param_list()
        if self.state.opt_state is not None:
            params = self.opt.inference_params(self.state.opt_state, params)
        return dict(zip(self._param_names, params))

    def inference_density(self, pos: torch.Tensor, params: dict | None = None) -> torch.Tensor:
        """``model.density`` on the inference parameters (or ``params``, by
        name): pos (N, 3) in the unit cube → (N, 16)."""
        params = self.inference_params() if params is None else params
        feats = functional_call(self.model.pos_encoding, _strip(params, "pos_encoding."), (pos,))
        return functional_call(self.model.density_network, _strip(params, "density_network."),
                               (feats,))

    def set_use_kernels(self, flag: bool) -> None:
        """True (default): rendering and training run the CUDA kernels on
        CUDA tensors. False: they run the kernels' plain versions, which are
        the reference a kernel run is checked against on the card."""
        self.use_kernels = flag
        self.model.set_use_kernels(flag)

    def train(self, n_steps: int = 1) -> float:
        """n training steps (``nerf/train.py``); returns the last loss. A
        fresh grid is first culled to the cells the training cameras see
        (task.py:228-259)."""
        if self.state.grid.fresh:
            ds = self.dataset
            if self.rays is not None:  # supplied rays defeat the cameras' cone test
                culled = torch.zeros_like(self.state.grid.density)
            else:
                culled = mark_untrained_cells(self.max_cascade + 1, ds.resolution,
                                              ds.focal_lengths, ds.xforms_start,
                                              ds.principal_points, self.device)
            self.state.grid.set_density(culled, 0.0)
        self.optimizer_state()
        return nerf_train.train(self, n_steps)

    def _prep_rays(self, uv, wh, fl, pp, xform):
        """Ray generation through the dataset lens, clipped to the render
        crop box and the near plane → (o, d, tmin, tmax)."""
        R = uv.shape[0]
        dir_cam, o_off = uv_to_ray_cam(
            uv, (wh[0], wh[1]), fl[None, :].expand(R, 2), pp[None, :].expand(R, 2),
            lens_mode=LensMode(self.dataset.lens_mode),
            lens_params=self.lens_params)
        d = dir_cam @ xform[:, :3].T
        o = xform[:, 3].expand(d.shape) + o_off @ xform[:, :3].T
        d = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-12)
        tmin, tmax = self._crop_tminmax(o, d)
        tmin = torch.clamp(tmin, min=self.render_near_distance)
        return o, d, tmin, tmax

    def _crop_tminmax(self, o, d):
        """Ray interval inside scene AABB ∩ render crop box (task.py:487-503).
        The crop box is axis-aligned in the frame ``render_aabb_to_local``
        reaches; both boxes are convex, so the interval inside both is the
        intersection of their entry/exit intervals."""
        tmin, tmax = _aabb_entry(o, d, *self._aabb_t)
        rot = np.asarray(self.render_aabb_to_local, np.float32)
        if not np.allclose(rot, np.eye(3)):
            rot_t = self._t(rot)
            o, d = o @ rot_t.T, d @ rot_t.T
        t2min, t2max = _aabb_entry(o, d, self._t(self.render_aabb_min),
                                   self._t(self.render_aabb_max))
        return torch.maximum(tmin, t2min), torch.minimum(tmax, t2max)

    def _march_window(self, o, d, t, alive, tmax, window: int | None = None,
                      dt_scale: float = 1.0):
        """March one K-sample window from t for the alive rays (dead rays
        start at MAX_DEPTH, so they emit nothing); K is ``window`` or
        ``render_samples_per_window``, the steps scaled by ``dt_scale``."""
        cfg = MarchConfig(n_march_iters=self.render_march_iters,
                          max_samples_per_ray=window or self.render_samples_per_window,
                          cone_angle=self.cone_angle, max_mip=self.max_cascade,
                          dt_scale=dt_scale)
        jitter = torch.full_like(t, 0.5)
        t_in = torch.where(alive, t, MAX_DEPTH)
        march = march_rays if self.use_kernels else march_rays_plain
        ts, dts, valid, t_exit, n_valid = march(
            o, d, self.skipmip, *self._aabb_t, jitter, cfg, t_init=t_in)
        valid = valid & alive[:, None]
        n_valid = torch.where(alive, n_valid, 0)
        return ts, dts, valid, t_exit, n_valid

    def _window_inputs(self, o, d, ts):
        """The network inputs of an (R, K) window's samples: positions in
        the unit cube (R·K, 3) and warped directions (R·K, 3)."""
        R, K = ts.shape
        aabb_min, aabb_max = self._aabb_t
        pos = fma(ts[..., None], d[:, None, :], o[:, None, :])
        pos_w = ((pos - aabb_min) / (aabb_max - aabb_min)).reshape(R * K, 3)
        return pos_w, warp_direction(d)[:, None, :].expand(R, K, 3).reshape(R * K, 3)

    def _eval_window(self, o, d, ts, valid, fast: bool = False):
        """Network outputs (R, K, 4) on the valid samples of a window,
        zero elsewhere. Only the valid samples are evaluated; ``fast`` reads
        one stochastic corner a hashed level (``render_quality="fast"``)."""
        R, K = ts.shape
        pos_w, dirs = self._window_inputs(o, d, ts)
        sel = torch.nonzero(valid.reshape(-1)).squeeze(1)
        out = torch.zeros((R * K, 4), dtype=torch.float32, device=o.device)
        if sel.numel() > 0:
            out[sel] = functional_call(self.model, self.inference_params(),
                                       (pos_w[sel], dirs[sel]),
                                       {"extra": self._render_extra(sel.numel()), "fast": fast})
        return out.reshape(R, K, 4)

    def _render_extra(self, n: int) -> torch.Tensor | None:
        """``render_extra_vec`` for n rows, or None."""
        vec = self.render_extra_vec()
        return None if vec is None else vec[None, :].expand(n, vec.shape[0])

    def _composite_window(self, out, ts, dts, valid, t, t_exit, T, rgb, depth, alive, tmax,
                          cost, eps_t=EPS_T):
        composite = composite_window if self.use_kernels else composite_window_plain
        return composite(out, ts, dts, valid.contiguous(), t, t_exit, T, rgb, depth,
                         alive.contiguous(), tmax, cost, eps_t, self.rgb_activation,
                         self.density_activation)

    @torch.no_grad()
    def _render_rays(self, o, d, tminmax=None, max_rounds: int = 64, fast: bool = False,
                     baked_cache=None):
        """Render rays → (rgb (R, 3), alpha (R,), depth (R,), cost (R,)):
        windows of march + eval + composite on the alive rays, compacted
        before each window. Without ``tminmax`` the rays are clipped to the
        crop box and the near distance here. With ``baked_cache`` a round
        marches ``baked_samples_per_window`` samples at the bake's finest
        cell size and then reads and composites them in one launch
        (``baked.render_round``, task.py:1820-1838); JAX takes two baked
        rounds a dispatch, so the bound is 2 × ``max_rounds`` rounds
        (task.py:1903-1973)."""
        R = o.shape[0]
        if tminmax is not None:
            tmin, tmax = tminmax
        else:
            tmin, tmax = self._crop_tminmax(o, d)
            tmin = torch.clamp(tmin, min=self.render_near_distance)
        t = tmin.clone()
        T = torch.ones((R,), dtype=torch.float32, device=o.device)
        rgb = torch.zeros((R, 3), dtype=torch.float32, device=o.device)
        depth = torch.zeros((R,), dtype=torch.float32, device=o.device)
        cost = torch.zeros((R,), dtype=torch.float32, device=o.device)
        alive = tmax > tmin
        if baked_cache is not None:
            # the field is trilinear a cell: steps finer than its finest cell buy nothing
            baked_dt = max(1.0, (1.0 / float(baked_cache.res_host[0])) / MIN_CONE_STEPSIZE)
            max_rounds *= 2
        for _ in range(max_rounds):
            idx = torch.nonzero(alive).squeeze(1)
            if idx.numel() == 0:
                break
            o_c, d_c, t_c, tmax_c = o[idx].contiguous(), d[idx].contiguous(), t[idx], tmax[idx]
            alive_c = torch.ones_like(idx, dtype=torch.bool)
            if baked_cache is not None:
                ts, dts, valid, t_exit, _ = self._march_window(
                    o_c, d_c, t_c, alive_c, tmax_c, window=self.baked_samples_per_window,
                    dt_scale=baked_dt)
                round_fn = baked.render_round if self.use_kernels else baked.render_round_plain
                t_n, T_n, rgb_n, depth_n, alive_n, cost_n = round_fn(
                    baked_cache, o_c, d_c, ts, dts, valid.contiguous(), t_c, t_exit, T[idx],
                    rgb[idx], depth[idx], alive_c, tmax_c, cost[idx], self.min_transmittance)
            else:
                ts, dts, valid, t_exit, _ = self._march_window(o_c, d_c, t_c, alive_c, tmax_c)
                out = self._eval_window(o_c, d_c, ts, valid, fast=fast)
                t_n, T_n, rgb_n, depth_n, alive_n, cost_n = self._composite_window(
                    out, ts, dts, valid, t_c, t_exit, T[idx], rgb[idx], depth[idx], alive_c,
                    tmax_c, cost[idx], self.min_transmittance)
            t[idx], T[idx], rgb[idx], depth[idx] = t_n, T_n, rgb_n, depth_n
            alive[idx], cost[idx] = alive_n, cost_n
        return rgb, 1.0 - T, depth, cost

    @torch.no_grad()
    def render(self, width: int, height: int, camera_matrix, focal_length=None,
               principal_point=(0.5, 0.5), fov: float = 50.0, spp: int = 1,
               background=(0.0, 0.0, 0.0, 0.0), to_srgb: bool = False,
               render_mode: str = "shade", uv_warp_fn=None, return_depth: bool = False,
               render_quality: str = "exact"):
        """Render a frame → (H, W, 4) f32 RGBA tensor on the task's device
        (task.py:2128-2342), through the dataset's lens. ``spp`` samples a
        pixel: sample 0 at the pixel centre, sample s ≥ 1 offset by
        (halton(s, 2), halton(s, 3)); ``uv_warp_fn`` maps each sample's (n,
        2) numpy uv before ray generation (foveation). rgb and alpha (and
        depth) are summed over the samples in sample order on the device,
        scaled by 1/spp, and only then is ``background`` blended in (shade
        mode). With ``return_depth``: (frame, (H, W) expected termination
        depth).

        ``render_mode``: shade, depth, positions, normals (−∇σ through the
        density network), ao (alpha), cost (samples a ray), encodingvis
        (three encoding features from ``visualized_dimension`` at the hit),
        distortion (the distortion map at uv, zeros without one) or slice
        (the density on the plane ``focus_z`` along each ray). An
        ``aperture_size`` > 0 renders a thin lens focused at ``focus_z``:
        sample s sits on the aperture disk at Halton(s + 1; 5, 7).
        ``render_quality`` "fast" reads one stochastic corner a hashed level
        (kernel A's stochastic mode); "baked" renders through a bake at the
        camera's position (``nerf/baked.py``); "slab" through the dense
        volumes (``_render_slab``), which, as in the JAX package, ignores
        ``spp``, ``uv_warp_fn``, the thin lens and ``to_srgb``. The G-buffer
        modes of "baked" and "slab" take the exact path (task.py:2173-2185)."""
        if render_mode not in RENDER_MODES:
            raise ValueError(f"unknown render mode {render_mode!r}")
        if render_quality not in RENDER_QUALITIES:
            raise ValueError(f"unknown render quality {render_quality!r}")
        if render_mode != "shade" and render_quality in ("slab", "baked"):
            render_quality = "exact"  # the bakes carry only [rgb, σ]
        fast = render_quality == "fast"
        if focal_length is None:
            fl = 0.5 * height / math.tan(0.5 * math.radians(fov))
            focal_length = (fl, fl)
        xform_np = np.asarray(camera_matrix, np.float32)
        if render_quality == "slab":
            return self._render_slab(width, height, xform_np, focal_length, principal_point,
                                     background, return_depth=return_depth)
        baked_cache = (self._get_baked(origin=xform_np[:, 3]) if render_quality == "baked"
                       else None)
        xform = self._t(xform_np)
        ys, xs = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
        xs = xs.reshape(-1).astype(np.float32)
        ys = ys.reshape(-1).astype(np.float32)
        n = xs.shape[0]
        wh = self._t([width, height])
        fl, pp = self._t(focal_length), self._t(principal_point)
        rgb_acc = torch.zeros((n, 3), dtype=torch.float32, device=self.device)
        alpha_acc = torch.zeros((n,), dtype=torch.float32, device=self.device)
        depth_acc = torch.zeros((n,), dtype=torch.float32, device=self.device)
        for s in range(max(spp, 1)):
            off = (0.5, 0.5) if s == 0 else (halton(s, 2), halton(s, 3))
            uv = np.stack([(xs + off[0]) / width, (ys + off[1]) / height], -1).astype(np.float32)
            if uv_warp_fn is not None:
                uv = np.asarray(uv_warp_fn(uv), np.float32)
            uv = torch.from_numpy(uv).to(self.device)
            rgbs, alphas, depths = [], [], []
            for i in range(0, n, RENDER_CHUNK):
                uv_c = uv[i:i + RENDER_CHUNK]
                if self.aperture_size > 0.0:
                    o, d = self._thin_lens_rays(uv_c, wh, fl, pp, xform_np, s)
                    tminmax = None
                else:
                    o, d, tmin, tmax = self._prep_rays(uv_c, wh, fl, pp, xform)
                    tminmax = (tmin, tmax)
                rgb, alpha, depth, cost = self._render_rays(o, d, tminmax=tminmax, fast=fast,
                                                            baked_cache=baked_cache)
                if render_mode == "shade" and self.train_envmap and "envmap" in self.cam_offsets:
                    env = nerf_train.read_envmap(self.cam_offsets["envmap"], d, self.use_kernels)
                    rgb = rgb + (1.0 - alpha)[:, None] * env[:, :3]
                if render_mode != "shade":
                    rgb = self._mode_rgb(render_mode, o, d, uv_c, rgb, alpha, depth, cost)
                rgbs.append(rgb)
                alphas.append(alpha)
                depths.append(depth)
            rgb_acc += torch.cat(rgbs)
            alpha_acc += torch.cat(alphas)
            depth_acc += torch.cat(depths)
        inv = 1.0 / max(spp, 1)
        rgb, alpha = rgb_acc * inv, alpha_acc * inv
        if render_mode == "shade":
            bg = self._t(background)
            rgb = rgb + (1.0 - alpha)[:, None] * bg[None, :3] * (bg[3] if len(bg) > 3 else 1.0)
            if to_srgb:
                rgb = linear_to_srgb(torch.clamp(rgb, min=0.0))
        frame = torch.cat([rgb, alpha[:, None]], -1).reshape(height, width, 4)
        if return_depth:
            return frame, (depth_acc * inv).reshape(height, width)
        return frame

    @torch.no_grad()
    def render_batch(self, width: int, height: int, camera_matrices, focal_lengths=None,
                     principal_points=None, background=(0.0, 0.0, 0.0, 0.0),
                     render_quality: str = "exact") -> torch.Tensor:
        """V views through one pool of rays (task.py:2346-2399) → (V, H, W,
        4) f32 on the task's device, shade mode at the pixel centres. Each
        view's focal length defaults to a 50° field of view and its principal
        point to the centre; "baked" bakes at the first camera's position."""
        if render_quality not in ("exact", "baked"):
            raise ValueError(f"render_batch renders exact or baked, not {render_quality!r}")
        V = len(camera_matrices)
        baked_cache = None
        if render_quality == "baked":
            baked_cache = self._get_baked(
                origin=np.asarray(camera_matrices[0], np.float32)[:, 3])
        ys, xs = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
        uv = torch.from_numpy(np.stack([(xs.reshape(-1) + 0.5) / width,
                                        (ys.reshape(-1) + 0.5) / height],
                                       -1).astype(np.float32)).to(self.device)
        wh = self._t([width, height])
        rays = []
        for v in range(V):
            fl = (focal_lengths[v] if focal_lengths is not None
                  else (0.5 * height / math.tan(0.5 * math.radians(50.0)),) * 2)
            pp = principal_points[v] if principal_points is not None else (0.5, 0.5)
            rays.append(self._prep_rays(uv, wh, self._t(fl), self._t(pp),
                                        self._t(camera_matrices[v])))
        o, d, tmin, tmax = (torch.cat(parts) for parts in zip(*rays))
        rgbs, alphas = [], []
        for i in range(0, o.shape[0], RENDER_CHUNK):
            sl = slice(i, i + RENDER_CHUNK)
            rgb, alpha, _, _ = self._render_rays(o[sl], d[sl], tminmax=(tmin[sl], tmax[sl]),
                                                 baked_cache=baked_cache)
            rgbs.append(rgb)
            alphas.append(alpha)
        rgb, alpha = torch.cat(rgbs), torch.cat(alphas)
        bg = self._t(background)
        rgb = rgb + (1.0 - alpha)[:, None] * bg[None, :3] * (bg[3] if len(bg) > 3 else 1.0)
        return torch.cat([rgb, alpha[:, None]], -1).reshape(V, height, width, 4)

    def get_camera_extrinsics(self, frame_idx: int) -> np.ndarray:
        """3×4 camera-to-world of a training view in the source (nerf)
        convention (task.py:1286-1294); the identity out of range."""
        ds = self.dataset
        i = int(frame_idx)
        if not 0 <= i < ds.n_images:
            return np.eye(3, 4, dtype=np.float32)
        return ds.ngp_matrix_to_nerf(np.asarray(ds.xforms_start[i], np.float32))

    # --- the baked and slab renders (task.py:1484-1698) ---
    def _bitfield(self) -> torch.Tensor:
        """The training grid's occupancy (NERF_CASCADES, G, G, G) bool."""
        return self.skipmip == 0

    def _model_fns(self):
        """Closures over the inference parameters: the whole model (pos,
        warped dirs) → (n, 4) logits, the density MLP pos → (n, 16), and
        the rgb head (features (n, 16), warped dirs) → (n, 3) logits, the
        latent inputs at zero."""
        params = self.inference_params()
        model = self.model

        def full(pos, dirs):
            return functional_call(model, params, (pos, dirs))

        def density(pos):
            return self.inference_density(pos, params)

        def rgb(feat, dirs):
            inputs = [feat.to(torch.float32),
                      functional_call(model.dir_encoding, _strip(params, "dir_encoding."),
                                      (dirs,)).to(torch.float32)]
            if model.n_extra_dims > 0:
                inputs.append(torch.zeros((feat.shape[0], model.n_extra_dims),
                                          dtype=torch.float32, device=feat.device))
            return functional_call(model.rgb_network, _strip(params, "rgb_network."),
                                   (torch.cat(inputs, -1),))

        return full, density, rgb

    @torch.no_grad()
    def bake(self, origin=None, res0: int | None = None,
             max_rows_log2: int = 21) -> baked.BakedCache:
        """Bake the model into a ``BakedCache`` (task.py:1484-1503): 64-byte
        records of the occupied cells. origin: a camera position for a
        view-dependent bake; None bakes the fixed direction."""
        full, _, _ = self._model_fns()
        return baked.bake(full, self._bitfield().cpu().numpy(), self.max_cascade + 1,
                          self.aabb_min, self.aabb_max, self.rgb_activation,
                          self.density_activation, self.device, origin=origin,
                          res0=res0 or self.baked_res0, max_rows_log2=max_rows_log2)

    def _get_baked(self, origin=None) -> baked.BakedCache:
        """The bake of (step, ``baked_res0``, origin rounded to 1e-4, the
        route), made anew when any of them changes (task.py:1505-1518)."""
        key = (self.training_step, self.baked_res0,
               None if origin is None else
               tuple(np.round(np.asarray(origin, np.float64), 4).tolist()), self.use_kernels)
        c = self._baked_cache
        if c is not None and c[0] == key:
            return c[1]
        cache = self.bake(origin=origin)
        self._baked_cache = (key, cache)
        return cache

    @torch.no_grad()
    def _get_slab(self, origin=None, eye=None) -> slab.DenseVolumes:
        """The dense-volume bake of the slab render (task.py:1520-1576),
        cached on (step, resolutions, deferred, origin, clipmap boxes, the
        route). Diffuse with the deferred features unless
        ``slab_bake_view_dependent`` asks for a bake at the camera; the
        levels are an eye-centred clipmap where the scene has more than one
        cascade."""
        if not self.slab_bake_view_dependent:
            origin = None
        boxes = None
        if eye is not None and self.max_cascade > 0:
            boxes = slab.clipmap_boxes(eye, self.aabb_min, self.aabb_max,
                                       finest_extent=self.slab_finest_extent)
        deferred = self.slab_deferred_vd and origin is None and self.slab_n_feat > 0
        key = (self.training_step, self.slab_res0, self.slab_res_outer, deferred,
               None if origin is None else
               tuple(np.round(np.asarray(origin, np.float64), 4).tolist()),
               None if boxes is None else boxes.tobytes(), self.use_kernels)
        c = self._slab_cache
        if c is not None and c[0] == key:
            return c[1]
        self._slab_cache = None  # the old bake's memory goes before the new one's
        _, density, rgb = self._model_fns()
        feat_proj = self._get_slab_feat_proj(density) if deferred else None
        dvols = slab.bake_dense(density, rgb, self._bitfield(), self.max_cascade + 1,
                                self.aabb_min, self.aabb_max, self.rgb_activation,
                                self.density_activation, origin=origin, res0=self.slab_res0,
                                res_outer=self.slab_res_outer, boxes=boxes, feat_proj=feat_proj)
        self._slab_cache = (key, dvols, rgb)
        return dvols

    def _get_slab_feat_proj(self, density) -> tuple:
        """The frozen PCA basis (mu (16,), sd (16,), P (16, F)) of the
        density MLP's output at up to 8,192 seeded points of each cascade's
        occupied cells (task.py:1579-1611), made once a task."""
        if self._slab_feat_proj is not None:
            return self._slab_feat_proj
        F = int(self.slab_n_feat)
        bf = self._bitfield().cpu().numpy()
        rng = np.random.default_rng(3)
        pts = []
        for mip in range(bf.shape[0]):
            idx = np.flatnonzero(bf[mip])
            if len(idx) == 0:
                continue
            if len(idx) > 8192:
                idx = rng.choice(idx, 8192, replace=False)
            i, j, k = np.unravel_index(idx, (NERF_GRIDSIZE,) * 3)
            cell = (np.stack([i, j, k], -1) + rng.random((len(idx), 3))) / NERF_GRIDSIZE
            pts.append((cell - 0.5) * (2.0 ** mip) + 0.5)
        pos = (np.concatenate(pts, 0).astype(np.float32) if pts
               else rng.random((4096, 3)).astype(np.float32))
        pos_w = (pos - self.aabb_min) / (self.aabb_max - self.aabb_min)
        feats = density(self._t(np.clip(pos_w, 0.0, 1.0))).to(torch.float32).cpu().numpy()
        mu = feats.mean(0).astype(np.float32)
        sd = np.maximum(feats.std(0), 1e-4).astype(np.float32)
        _, _, vt = np.linalg.svd((feats - mu) / sd, full_matrices=False)
        self._slab_feat_proj = (mu, sd, vt[:F].T.astype(np.float32).copy())
        return self._slab_feat_proj

    @torch.no_grad()
    def _render_slab(self, width, height, xform: np.ndarray, focal_length, principal_point,
                     background, return_depth: bool = False):
        """A frame through the slab renderer (task.py:1613-1698): the dense
        bake, the sweeps and the warp (``slab.render_frame``), then, with
        deferred features, the per-pixel decode through the rgb MLP. Rays at
        the pixel centres through the dataset's lens; the groups planned on
        the host for a perspective lens, else reduced on the device. Returns
        (H, W, 4) [premultiplied rgb over the background, α] (and the (H, W)
        depth)."""
        if self.mesh is not None:  # no unsharded frame under a mesh
            sharding.check_group(self.mesh)
        eye = xform[:, 3]
        dvols = self._get_slab(origin=eye, eye=eye)
        rgb_head = self._slab_cache[2]
        ys, xs = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
        uv = torch.from_numpy(np.stack([(xs.reshape(-1) + 0.5) / width,
                                        (ys.reshape(-1) + 0.5) / height],
                                       -1).astype(np.float32)).to(self.device)
        _, d, _, _ = self._prep_rays(uv, self._t([width, height]), self._t(focal_length),
                                     self._t(principal_point), self._t(xform))
        B0 = 512 if max(width, height) <= 640 else 1024
        plan = None
        if LensMode(self.dataset.lens_mode) == LensMode.PERSPECTIVE:
            plan = slab.plan_groups_host(xform, (width, height), focal_length, principal_point)
        out = slab.render_frame(dvols, eye, d, background=np.asarray(background, np.float32),
                                B0=B0, Bo=B0 // 2, plan=plan, use_kernels=self.use_kernels,
                                group=self.mesh)
        if dvols.n_feat > 0:
            out = slab.deferred_decode(out, d, rgb_head, dvols.feat_proj, self.rgb_activation)
        frame = out[:, :4].reshape(height, width, 4)
        if return_depth:
            return frame, out[:, 4].reshape(height, width)
        return frame

    def _thin_lens_rays(self, uv, wh, fl, pp, xform: np.ndarray, s: int):
        """Depth-of-field rays of sample ``s`` (task.py:2231-2255): the
        origin moved to a point of the aperture disk at Halton(s + 1; 5, 7),
        the ray re-aimed at the plane z = ``focus_z`` of camera space. The
        lens offset is formed in f64 on the host and rounded to f32, as the
        JAX package forms it in numpy."""
        R = uv.shape[0]
        dir_cam, _ = uv_to_ray_cam(
            uv, (wh[0], wh[1]), fl[None, :].expand(R, 2), pp[None, :].expand(R, 2),
            lens_mode=LensMode(self.dataset.lens_mode), lens_params=self.lens_params)
        ang = 2.0 * np.pi * halton(s + 1, 5)
        rad = self.aperture_size * np.sqrt(halton(s + 1, 7))
        lens = rad * (np.cos(ang) * xform[:, 0] + np.sin(ang) * xform[:, 1])
        shift = self._t([lens @ xform[:, 0], lens @ xform[:, 1], 0.0])
        xf = self._t(xform)
        d = (dir_cam * self.focus_z - shift) @ xf[:, :3].T
        o = (xf[:, 3] + self._t(lens)).expand(d.shape)
        d = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-12)
        return o, d

    def _mode_rgb(self, mode: str, o, d, uv, rgb, alpha, depth, cost) -> torch.Tensor:
        """The colour of a G-buffer render mode for one chunk of rays
        (task.py:2263-2325)."""
        n = alpha.shape[0]
        aabb_min, aabb_max = self._aabb_t
        if mode in ("positions", "normals", "encodingvis"):
            hit = o + depth[:, None] * d
            if mode == "positions":
                return torch.clamp((hit - aabb_min) / (aabb_max - aabb_min), 0.0, 1.0)
            if mode == "normals":
                return self._surface_normals(hit)
            pw = torch.clamp((hit - aabb_min) / (aabb_max - aabb_min), 0.0, 1.0)
            feats = functional_call(self.model.pos_encoding, _strip(self.inference_params(), "pos_encoding."),
                                    (pw,))
            vd = int(np.clip(self.visualized_dimension, 0, max(feats.shape[-1] - 3, 0)))
            return torch.clamp(torch.abs(feats[:, vd:vd + 3].to(torch.float32)) * 10.0, 0.0, 1.0)
        if mode == "depth":
            return depth[:, None].expand(n, 3)
        if mode == "ao":
            return alpha[:, None].expand(n, 3)
        if mode == "cost":
            heat = torch.clamp(cost / 256.0, 0.0, 1.0)
            return torch.stack([heat, 1.0 - heat, torch.zeros_like(heat)], -1)
        if mode == "distortion":
            off = self._distortion_at(uv)
            mag = torch.linalg.vector_norm(off, dim=-1)
            return torch.stack([torch.clamp(off[:, 0] * 50 + 0.5, 0, 1),
                                torch.clamp(off[:, 1] * 50 + 0.5, 0, 1),
                                torch.clamp(mag * 100, 0, 1)], -1)
        # slice: the density on the plane focus_z along each ray
        pw = (o + float(self.focus_z) * d - aabb_min) / (aabb_max - aabb_min)
        logit = self.inference_density(torch.clamp(pw, 0.0, 1.0))[:, 0].to(torch.float32)
        heat = torch.clamp(torch.log1p(network_to_density(logit, self.density_activation)) / 6.0,
                           0.0, 1.0)
        heat = torch.where(torch.all((pw >= 0) & (pw <= 1), dim=-1), heat, 0.0)
        return torch.stack([heat, heat * 0.5, 1.0 - heat], -1)

    def _distortion_at(self, uv: torch.Tensor) -> torch.Tensor:
        """The (n, 2) offsets of the task's distortion map (a snapshot's
        ``cam_offsets["distortion"]``, (h, w, 2)) read bilinearly at uv
        through kernel I's bilinear entry; zeros without a map."""
        dist = self.cam_offsets.get("distortion")
        if dist is None:
            return torch.zeros((uv.shape[0], 2), dtype=torch.float32, device=uv.device)
        return distortion_read(torch.as_tensor(dist, device=uv.device), uv, self.use_kernels)

    def _surface_normals(self, pos_world: torch.Tensor) -> torch.Tensor:
        """−∇σ at pos_world, normalized and mapped to [0, 1] (task.py:
        2405-2417): the gradient of the density logits' sum through the
        density network (kernel F's dX) and the encoding (kernel K)."""
        aabb_min, aabb_max = self._aabb_t
        params = {k: v.detach() for k, v in self.inference_params().items()}
        with torch.enable_grad():
            p = pos_world.detach().requires_grad_(True)
            out = self.inference_density((p - aabb_min) / (aabb_max - aabb_min), params)
            (g,) = torch.autograd.grad(out[:, 0].to(torch.float32).sum(), p)
        nrm = -g / torch.clamp(torch.linalg.vector_norm(g, dim=-1, keepdim=True), min=1e-9)
        return nrm * 0.5 + 0.5

    @torch.no_grad()
    def render_slice(self, width: int, height: int, camera_matrix, focal_length=None,
                     principal_point=(0.5, 0.5), fov: float = 50.0, plane_dist: float = 1.5,
                     background=(0.0, 0.0, 0.0, 0.0)) -> torch.Tensor:
        """The slice render (task.py:2036-2126, reference ERenderMode::Slice):
        the whole model on the plane of view-space depth ``plane_dist``,
        rgba = [rgb·a, a] with a = 1 − exp(−σ·0.01), over ``background``.
        Returns (H, W, 4) f32 on the task's device."""
        if focal_length is None:
            fl = 0.5 * height / math.tan(0.5 * math.radians(fov))
            focal_length = (fl, fl)
        xform = self._t(camera_matrix)
        ys, xs = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
        uv = torch.from_numpy(np.stack([(xs.reshape(-1) + 0.5) / width,
                                        (ys.reshape(-1) + 0.5) / height],
                                       -1).astype(np.float32)).to(self.device)
        n = uv.shape[0]
        fl = self._t(focal_length)[None, :].expand(n, 2)
        pp = self._t(principal_point)[None, :].expand(n, 2)
        # unit z-depth camera directions: eye + dir·plane_dist is the plane
        dir_cam, off_cam = uv_to_ray_cam(uv, (width, height), fl, pp,
                                         lens_mode=LensMode(self.dataset.lens_mode),
                                         lens_params=self.lens_params)
        d_w = dir_cam @ xform[:, :3].T
        world = xform[:, 3] + off_cam @ xform[:, :3].T + d_w * plane_dist
        aabb_min, aabb_max = self._aabb_t
        pos_w = (world - aabb_min) / (aabb_max - aabb_min)
        dirs = d_w / torch.clamp(torch.linalg.vector_norm(d_w, dim=-1, keepdim=True), min=1e-9)
        out = functional_call(self.model, self.inference_params(),
                              (pos_w, warp_direction(dirs)), {"extra": self._render_extra(n)})
        rgb = network_to_rgb(out[:, :3].to(torch.float32), self.rgb_activation)
        sigma = network_to_density(out[:, 3].to(torch.float32), self.density_activation)
        a = torch.clamp(1.0 - torch.exp(-sigma * 0.01), 0.0, 1.0)
        bg = self._t(background)
        rgb = rgb * a[:, None] + (1.0 - a[:, None]) * bg[:3] * bg[3]
        alpha = a + (1.0 - a) * bg[3]
        return torch.cat([rgb, alpha[:, None]], -1).reshape(height, width, 4)


def distortion_read(dist: torch.Tensor, uv: torch.Tensor, use_kernel: bool = True) -> torch.Tensor:
    """The (n, 2) offsets of an (h, w, 2) distortion map read bilinearly at
    uv, differentiable in the map: kernel I's bilinear entry on the map as
    an (h·w, 4) texture whose last two channels are zero, and its gradient
    a 4-corner deposit through kernel H (``bilinear_read_differentiable``)."""
    h, w = dist.shape[:2]
    tex = torch.nn.functional.pad(dist.reshape(h * w, 2), (0, 2))
    return bilinear_read_differentiable(tex, (w, h), uv.contiguous(), use_kernel)[:, :2]


RENDER_MODES = ("shade", "depth", "positions", "normals", "ao", "cost", "encodingvis",
                "distortion", "slice")
RENDER_QUALITIES = ("exact", "fast", "baked", "slab")


def _strip(params: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in params.items() if k.startswith(prefix)}


def level_stats(task: NerfTask) -> list[dict]:
    """Each hash-grid level's parameter statistics (task.py:2470, the
    reference's LevelStats panel, testbed.cu:5234-5284)."""
    out = []
    enc = task.model.pos_encoding
    for lv, table in zip(enc.levels, enc.unpack_params()):
        chunk = table.detach().cpu().numpy()
        out.append({"resolution": lv.resolution, "hashed": lv.hashed, "n_entries": lv.size,
                    "mean": float(chunk.mean()), "std": float(chunk.std()),
                    "min": float(chunk.min()), "max": float(chunk.max()),
                    "frac_nonzero": float((np.abs(chunk) > 1e-6).mean())})
    return out


@torch.no_grad()
def density_slice(task: NerfTask, z: float = 0.5, res: int = 256) -> np.ndarray:
    """The activated density on the slice z of the unit cube, (res, res)
    with x along the rows (task.py:2490)."""
    xs = (np.arange(res) + 0.5) / res
    gx, gy = np.meshgrid(xs, xs, indexing="ij")
    pts = np.stack([gx, gy, np.full_like(gx, z)], -1).reshape(-1, 3).astype(np.float32)
    out = task.inference_density(torch.from_numpy(pts).to(task.device))[:, 0].to(torch.float32)
    return np.exp(np.clip(out.cpu().numpy(), -15, 15)).reshape(res, res)


def halton(i: int, b: int) -> float:
    """The i-th element of the base-b Halton sequence (task.py:2201-2207)."""
    f, r = 1.0, 0.0
    while i > 0:
        f /= b
        r += f * (i % b)
        i //= b
    return r


def _aabb_entry(o, d, aabb_min, aabb_max):
    return ray_intersect_aabb(o, d, aabb_min, aabb_max)
