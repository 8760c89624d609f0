"""SDF primitive: mesh → neural signed-distance field (port of
``instant_ngp_tpu/sdf/task.py``; reference testbed_sdf.cu).

  * the mesh is normalized into the unit cube and an area-weighted
    triangle CDF is built for surface sampling (:1363-1447)
  * each batch: 4/8 on-surface points (distance 0), 3/8 surface points with
    logistic noise and 1/8 uniform points, their distances from the BVH,
    shuffled (generate_training_samples_sdf :1449-1535). Made on the host
    with numpy from ``np.random.default_rng(seed)``, so that one seed gives
    the JAX package's batches bit for bit
  * a background producer thread makes batches into a queue of 2 while the
    card trains; each ``train`` call waits for a fresh batch for its first
    step, and a later step of the same call whose fresh batch is not ready
    reuses the last, as the JAX package does. ``frame()`` trains one step,
    so every frame waits for the producer
  * MAPE loss, Adam (``ops/optimizers``); the step runs kernels A and B
    forward and F and E backward
  * ``calculate_iou``: sign agreement with the mesh on uniform points
    (:1636-1680)
  * ``render``: a sphere trace of the learned field with analytic normals
    (kernels F and K through autograd) or 6-tap finite differences, iq's soft
    shadows, an optional floor, the Disney BRDF (:798-959, :1108-1361); the
    ground truth by BVH ray casts or a sphere trace of the mesh's SDF.

The JAX package advances every ray in lockstep inside a ``while_loop``;
here the loop is on the host and each iteration evaluates only the rays
still alive (``nonzero``), which gives each ray the same result, since the
network's rows are independent.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Optional

import numpy as np
import torch
from torch.func import functional_call

from ..common import fma
from ..geometry.bvh import TriangleBvh
from ..geometry.mesh_io import load_mesh, normalize_to_unit_cube
from ..geometry.octree import TriangleOctree
from ..models.factory import autoconfig_grid_encoding
from ..models.network import NetworkTask
from ..ops.raymarch import ray_intersect_aabb
from ..ops.takikawa import TakikawaEncoding
from ..render.brdf import BRDFParams, evaluate_shading
from ..render.camera import pinhole_rays

CHUNK = 1 << 18  # points per inference pass of ``sdf``
IOU_SEED = 4242
AMBIENT = (0.25, 0.3, 0.35)
FLOOR_COLOR = (0.6, 0.65, 0.7)
SHADOW_STEPS = 48


class SdfTask(NetworkTask):
    """A neural SDF of one mesh: the BVH, the model, the optimizer and its
    state, the batch producer, the step, ``calculate_iou`` and ``render``.
    The constructor follows the JAX package's (task.py:35-121)."""

    def __init__(self, mesh_path_or_tris, config: dict, device="cuda", seed: int = 1337,
                 batch_size: int = 1 << 16, sdf_mode: str = "pseudonormal"):
        if isinstance(mesh_path_or_tris, (str, bytes)) or hasattr(mesh_path_or_tris, "__fspath__"):
            tris = load_mesh(mesh_path_or_tris)
        else:
            tris = np.asarray(mesh_path_or_tris, np.float32)
        self.device = torch.device(device)
        self.triangles, self.mesh_scale, self.mesh_offset = normalize_to_unit_cube(tris)
        # shading (reference BRDFParams sdf_device.cuh:30-40, iq's soft
        # shadows, the floor plane testbed_sdf.cu:198-204)
        self.brdf = BRDFParams()
        self.shadow_sharpness = 16.0
        self.render_shadows = True
        self.floor_y = 0.0
        self.floor_enable = False
        self.sun_color = (1.0, 1.0, 1.0)
        # pyngp Sdf knobs (python_api.cu:855-871)
        self.zero_offset = 0.0
        self.analytic_normals = True
        self.fd_normals_epsilon = 1e-3
        self.surface_offset_scale = 1.0
        self.distance_scale = 1.0
        self.groundtruth_mode = "raytracedmesh"  # or "spheretracedmesh"
        t0 = time.perf_counter()
        self.bvh = TriangleBvh(self.triangles)
        self.bvh_build_s = time.perf_counter() - t0
        self.sdf_mode = sdf_mode
        self.batch_size = batch_size

        # area-weighted triangle CDF for surface sampling
        e1 = self.triangles[:, 1] - self.triangles[:, 0]
        e2 = self.triangles[:, 2] - self.triangles[:, 0]
        areas = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
        self.tri_cdf = np.cumsum(areas) / max(areas.sum(), 1e-12)

        self.network_config = config  # as given, before the grid's autoconfiguration
        config = dict(config)
        enc_cfg = config.get("encoding", {})
        self.octree = None
        encoding = None
        if str(enc_cfg.get("otype", "")).lower() == "takikawa":
            # the NGLOD feature octree over the normalized mesh (JAX task.py:90-104)
            self.octree = TriangleOctree(self.triangles, depth=int(enc_cfg.get("n_levels", 7)))
            encoding = TakikawaEncoding(
                self.octree, n_features_per_level=int(enc_cfg.get("n_features_per_level", 4)),
                start_level=int(enc_cfg.get("starting_level", 2)), device=self.device)
        else:
            config["encoding"] = autoconfig_grid_encoding(enc_cfg, "sdf")
        self.config = config
        self._init_network(config, 3, 1, seed, "Mape", encoding=encoding)
        self._rng = np.random.default_rng(seed)
        # the batch producer and what it did: batches made and seconds spent,
        # and the steps that took a fresh batch or reused the last
        self._queue: Optional[queue.Queue] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.batches_produced = 0
        self.producer_seconds = 0.0
        self.fresh_batches = 0
        self.reused_batches = 0
        self._iou_truth: dict = {}

    def set_use_kernels(self, flag: bool) -> None:
        """True (default): the model runs kernels A, B, E, F and K on CUDA
        tensors. False: their plain versions."""
        self.model.set_use_kernels(flag)

    # --- training batches (host) ---
    def _sample_surface(self, n: int) -> np.ndarray:
        u = self._rng.random(n)
        ti = np.searchsorted(self.tri_cdf, u)
        ti = np.clip(ti, 0, len(self.triangles) - 1)
        b1 = self._rng.random(n)
        b2 = self._rng.random(n)
        flip = b1 + b2 > 1
        b1 = np.where(flip, 1 - b1, b1)
        b2 = np.where(flip, 1 - b2, b2)
        t = self.triangles[ti]
        return (t[:, 0] + (t[:, 1] - t[:, 0]) * b1[:, None]
                + (t[:, 2] - t[:, 0]) * b2[:, None]).astype(np.float32)

    def generate_training_batch(self) -> tuple[np.ndarray, np.ndarray]:
        """(points (n, 3), distances (n,)) f32: 4/8 surface, 3/8 perturbed
        by logistic noise, 1/8 uniform, shuffled (testbed_sdf.cu:1449-1535)."""
        n = self.batch_size
        n_surf = n // 2
        n_pert = n * 3 // 8
        n_unif = n - n_surf - n_pert

        surf = self._sample_surface(n_surf + n_pert)
        pts_surf = surf[:n_surf]
        u = np.clip(self._rng.random((n_pert, 3)), 1e-6, 1 - 1e-6)
        logistic = (0.01 * self.surface_offset_scale * np.log(u / (1 - u)).astype(np.float32))
        pts_pert = np.clip(surf[n_surf:] + logistic, 0.0, 1.0)
        pts_unif = self._rng.random((n_unif, 3)).astype(np.float32)

        pts = np.concatenate([pts_surf, pts_pert, pts_unif]).astype(np.float32)
        d = np.zeros(n, np.float32)
        d[n_surf:] = self.bvh.signed_distance(np.concatenate([pts_pert, pts_unif]),
                                              mode=self.sdf_mode)
        perm = self._rng.permutation(n)
        return pts[perm], d[perm]

    def _batch_producer(self) -> queue.Queue:
        """The queue the producer thread fills, the thread started on first
        use. The BVH queries release the GIL, so batches are made while
        the card runs the steps. The worker parks on the bounded queue and
        exits when ``stop_producer`` is called (also from ``__del__``)."""
        if self._queue is None:
            self._queue = queue.Queue(maxsize=2)

            def worker():
                while not self._stop.is_set():
                    t0 = time.perf_counter()
                    batch = self.generate_training_batch()
                    self.producer_seconds += time.perf_counter() - t0
                    self.batches_produced += 1
                    while not self._stop.is_set():
                        try:
                            self._queue.put(batch, timeout=0.5)
                            break
                        except queue.Full:
                            continue

            self._thread = threading.Thread(target=worker, name="sdf-batches", daemon=True)
            self._thread.start()
        return self._queue

    def stop_producer(self) -> None:
        """End the producer thread (idempotent)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def __del__(self):  # noqa: D105
        try:
            self.stop_producer()
        except Exception:  # noqa: BLE001 (interpreter teardown)
            pass

    # --- the step ---
    def step_gradients(self, pts: torch.Tensor,
                       target: torch.Tensor) -> tuple[list[torch.Tensor], torch.Tensor]:
        """Forward and backward of one step on a batch, without the update:
        (grads in ``param_list`` order, the mean loss)."""
        with torch.enable_grad():
            pred = self.model(pts).to(torch.float32)[:, 0]
            loss = torch.mean(self.loss(target, pred))
            grads = torch.autograd.grad(loss, self.model.param_list())
        return list(grads), loss.detach()

    def to_device(self, batch) -> tuple[torch.Tensor, torch.Tensor]:
        """A host batch (points, distances) as tensors on the task's device."""
        pts, d = batch
        return torch.from_numpy(pts).to(self.device), torch.from_numpy(d).to(self.device)

    def train(self, n_steps: int = 1) -> float:
        """n steps on the producer's batches. The first waits for a fresh
        batch; a later step whose fresh batch is not ready reuses the last
        (task.py:262-295). Returns the last step's loss (the one host read)."""
        q = self._batch_producer()
        loss = None
        last = None
        for _ in range(n_steps):
            try:
                last = self.to_device(q.get(block=last is None, timeout=300.0))
                self.fresh_batches += 1
            except queue.Empty:
                if last is None:
                    # the producer stalled on the very first batch
                    last = self.to_device(self.generate_training_batch())
                    self.fresh_batches += 1
                else:
                    self.reused_batches += 1
            loss = self.train_step(*last)
            self.training_step += 1
        return float(loss) if loss is not None else 0.0

    # --- inference ---
    def _field(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        return functional_call(self.model, params, (x,)).to(torch.float32)[:, 0]

    def _sdf_fn(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """The distance the tracers step by: (field − zero_offset) ·
        distance_scale (advance_pos_kernel_sdf, testbed_sdf.cu:183-185)."""
        return (self._field(params, x) - self.zero_offset) * self.distance_scale

    @torch.no_grad()
    def sdf(self, points) -> torch.Tensor:
        """The learned distance at points (n, 3) → (n,) f32 on the device, in
        chunks of 2^18."""
        pts = torch.as_tensor(points, dtype=torch.float32, device=self.device).reshape(-1, 3)
        params = self.inference_params()
        return torch.cat([self._field(params, pts[i:i + CHUNK])
                          for i in range(0, pts.shape[0], CHUNK)])

    def calculate_iou(self, n_samples: int = 1 << 21) -> float:
        """Sign agreement of the field and the mesh on uniform points from
        seed 4242 (testbed_sdf.cu:1636-1680). The mesh's side is computed
        once per sample count and mode."""
        key = (n_samples, self.sdf_mode)
        if key not in self._iou_truth:
            pts = np.random.default_rng(IOU_SEED).random((n_samples, 3)).astype(np.float32)
            gt = torch.from_numpy(self.bvh.signed_distance(pts, mode=self.sdf_mode) < 0)
            self._iou_truth[key] = (torch.from_numpy(pts).to(self.device), gt.to(self.device))
        pts, gt_inside = self._iou_truth[key]
        pred_inside = self.sdf(pts) < 0
        inter = torch.sum(gt_inside & pred_inside)
        union = torch.sum(gt_inside | pred_inside)
        return float(inter) / max(float(union), 1.0)

    # --- rendering ---
    @torch.no_grad()
    def render(self, width: int, height: int, camera_matrix, fov: float = 50.0,
               n_trace_steps: int = 96, light_dir=(0.4, -0.7, 0.6),
               ground_truth: bool = False) -> torch.Tensor:
        """Sphere-trace the learned SDF → shaded (H, W, 4) f32 on the device
        (linear rgb, alpha 1 where a ray hit)."""
        o, d = pinhole_rays(width, height, camera_matrix, fov, self.device)
        if ground_truth:
            o_np, d_np = o.cpu().numpy(), d.cpu().numpy()
            if self.groundtruth_mode == "spheretracedmesh":
                rgb, hit = self._render_mesh_sdf(o_np, d_np, n_trace_steps, light_dir)
            else:
                rgb, hit = self._render_mesh_raytrace(o_np, d_np, light_dir)
        else:
            light = torch.as_tensor(light_dir, dtype=torch.float32, device=self.device)
            rgb, hit = self._render_field(self.inference_params(), o, d.to(torch.float32), light,
                                          n_trace_steps)
        return torch.cat([rgb, hit[:, None].to(torch.float32)], -1).reshape(height, width, 4)

    def _trace(self, params: dict, o, d, t, alive, tmax, n_steps: int) -> torch.Tensor:
        """The sphere trace from t of the rays where alive: each steps by the
        field until |dist| < 5e-4 or it passes tmax, at most n_steps times.
        Returns t."""
        t = t.clone()
        idx = torch.nonzero(alive).reshape(-1)
        for _ in range(n_steps):
            if idx.numel() == 0:
                break
            dist = self._sdf_fn(params, fma(t[idx, None], d[idx], o[idx]))
            t_new = t[idx] + dist
            t[idx] = t_new
            done = (torch.abs(dist) < 5e-4) | (t_new > tmax[idx])
            idx = idx[~done]
        return t

    def _gradient(self, params: dict, pos: torch.Tensor) -> torch.Tensor:
        """The field's input gradient at pos (kernels F and K on the card)."""
        with torch.enable_grad():
            x = pos.detach().requires_grad_(True)
            out = self._field(params, x)
            (n,) = torch.autograd.grad(out, x, grad_outputs=torch.ones_like(out))
        return n

    def _normals(self, params: dict, pos: torch.Tensor) -> torch.Tensor:
        """Unit normals at pos: the field's input gradient, or 6-tap central
        differences of the distance."""
        if pos.shape[0] == 0:
            return torch.zeros_like(pos)
        if self.analytic_normals:
            n = self._gradient(params, pos)
        else:
            eps = self.fd_normals_epsilon
            taps = []
            for ax in range(3):
                e = torch.zeros(3, device=pos.device)
                e[ax] = eps
                taps.append(self._sdf_fn(params, pos + e) - self._sdf_fn(params, pos - e))
            n = torch.stack(taps, -1) / (2 * eps)
        return n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True), min=1e-9)

    def _shadow(self, params: dict, pos, normal, light) -> torch.Tensor:
        """iq's soft-shadow visibility along the light from each position
        (advance_pos_kernel_sdf :207-215): at most 48 steps; a ray stops
        where the distance falls below 1e-4 or it leaves the unit cube."""
        k = self.shadow_sharpness
        n = pos.shape[0]
        so = fma(normal, 2e-3, pos)
        st = torch.full((n,), 2e-2, device=pos.device)
        vis = torch.ones(n, device=pos.device)
        prev = torch.full((n,), 1e10, device=pos.device)
        idx = torch.arange(n, device=pos.device)
        for _ in range(SHADOW_STEPS):
            if idx.numel() == 0:
                break
            st_i = st[idx]
            sp = fma(st_i[:, None], light, so[idx])
            dist = self._sdf_fn(params, sp)
            y = dist * dist / (2.0 * torch.clamp(prev[idx], min=1e-6))
            dd = torch.sqrt(torch.clamp(dist * dist - y * y, min=0.0))
            vis[idx] = torch.minimum(vis[idx], k * dd / torch.clamp(st_i - y, min=1e-6))
            st[idx] = st_i + dist
            prev[idx] = dist
            inb = torch.all((sp >= 0.0) & (sp <= 1.0), dim=-1)
            idx = idx[~((dist < 1e-4) | ~inb)]
        return torch.clamp(vis, 0.0, 1.0)

    def _surface(self, params: dict, o, d, n_steps: int):
        """The sphere trace of the learned field through the unit cube:
        (t, positions, hit) of every ray; hit where it ended on the surface
        (|dist| < 2e-3) inside the cube."""
        dev = o.device
        tmin, tmax = ray_intersect_aabb(o, d, torch.zeros(3, device=dev),
                                        torch.ones(3, device=dev))
        hit_box = tmin < tmax
        t = self._trace(params, o, d, tmin, hit_box, tmax, n_steps)
        pos = fma(t[:, None], d, o)
        hit = hit_box.clone()
        sel = torch.nonzero(hit_box).reshape(-1)
        final = self._sdf_fn(params, pos[sel])
        hit[sel] = (torch.abs(final) < 2e-3) & (t[sel] <= tmax[sel])
        return t, pos, hit

    @torch.no_grad()
    def hit_positions(self, width: int, height: int, camera_matrix, fov: float = 50.0,
                      n_trace_steps: int = 96) -> torch.Tensor:
        """The surface positions of ``render``'s frame of the learned field,
        (n, 3) f32 on the device: those whose normals it takes."""
        o, d = pinhole_rays(width, height, camera_matrix, fov, self.device)
        _, pos, hit = self._surface(self.inference_params(), o, d.to(torch.float32),
                                    n_trace_steps)
        return pos[hit].contiguous()

    def _render_field(self, params: dict, o, d, light, n_steps: int):
        """The learned field's frame: (rgb (n, 3), hit (n,) bool)."""
        dev = o.device
        t, pos, hit = self._surface(params, o, d, n_steps)
        floor_hit = torch.zeros_like(hit)
        if self.floor_enable:
            dy = d[:, 1]
            t_floor = (self.floor_y - o[:, 1]) / torch.where(torch.abs(dy) < 1e-9,
                                                             torch.full_like(dy, 1e-9), dy)
            floor_hit = (~hit) & (t_floor > 0) & (dy < 0)
            t = torch.where(floor_hit, t_floor, t)
            pos = fma(t[:, None], d, o)
            hit = hit | floor_hit
        l = light / torch.linalg.vector_norm(light)
        normal = torch.zeros_like(pos)
        surf = torch.nonzero(hit & ~floor_hit).reshape(-1)
        normal[surf] = self._normals(params, pos[surf])
        normal[floor_hit] = torch.tensor([0.0, 1.0, 0.0], device=dev)
        hit_idx = torch.nonzero(hit).reshape(-1)
        shadow = torch.ones(o.shape[0], device=dev)
        if self.render_shadows:
            shadow[hit_idx] = self._shadow(params, pos[hit_idx], normal[hit_idx], l)
        base = torch.as_tensor(self.brdf.basecolor, dtype=torch.float32, device=dev)
        base = base.expand(hit_idx.shape[0], 3)
        if self.floor_enable:
            floorcol = torch.tensor(FLOOR_COLOR, device=dev)
            base = torch.where(floor_hit[hit_idx, None], floorcol, base)
        rgb_hit = evaluate_shading(base, AMBIENT, self.sun_color, self.brdf, l, -d[hit_idx],
                                   normal[hit_idx])
        rgb = torch.zeros_like(pos)
        rgb[hit_idx] = torch.clamp(rgb_hit * shadow[hit_idx, None], 0.0, 1.0)
        return rgb, hit

    def _shade_host(self, pos, normal, view, light_dir, hit) -> tuple[torch.Tensor, torch.Tensor]:
        """Shade host arrays of the ground-truth renders (no shadows) →
        (rgb, hit) on the device."""
        l = np.asarray(light_dir, np.float32)
        l = l / np.linalg.norm(l)
        dev = self.device

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

        rgb = evaluate_shading(self.brdf.basecolor, AMBIENT, self.sun_color, self.brdf, t(l),
                               -t(view), t(normal))
        hit_t = torch.from_numpy(hit).to(dev)
        return torch.where(hit_t[:, None], torch.clamp(rgb, 0.0, 1.0), 0.0), hit_t

    def _render_mesh_raytrace(self, o, d, light_dir):
        """Ground truth by BVH ray casts and flat triangle normals."""
        t, tri = self.bvh.raytrace(o, d)
        hit = np.isfinite(t)
        pos = o + t[:, None] * d
        tris = self.triangles[np.maximum(tri, 0)]
        n = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
        n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-9)
        return self._shade_host(pos, n, d, light_dir, hit)

    def _render_mesh_sdf(self, o, d, n_trace_steps: int, light_dir):
        """Ground truth by a sphere trace of the mesh's own SDF (half the
        steps) with 6-tap BVH normals (ESDFGroundTruthMode::SpheretracedMesh)."""
        t = np.zeros(len(o), np.float32)
        alive = np.ones(len(o), bool)
        for _ in range(n_trace_steps // 2):
            if not alive.any():
                break
            pos = o[alive] + t[alive, None] * d[alive]
            dist = self.bvh.signed_distance(np.clip(pos, 0.0, 1.0), mode=self.sdf_mode)
            t[alive] += dist
            done = (np.abs(dist) < 5e-4) | (t[alive] > 2.0)
            idx = np.nonzero(alive)[0]
            alive[idx[done]] = False
        hit = (t < 2.0) & (t > 0)
        pos = o + t[:, None] * d
        eps = 1e-3
        taps = [self.bvh.signed_distance(np.clip(pos + eps * np.eye(3)[a], 0, 1),
                                         mode=self.sdf_mode)
                - self.bvh.signed_distance(np.clip(pos - eps * np.eye(3)[a], 0, 1),
                                           mode=self.sdf_mode) for a in range(3)]
        n = np.stack(taps, -1) / (2 * eps)
        n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-9)
        return self._shade_host(pos, n, d, light_dir, hit)
