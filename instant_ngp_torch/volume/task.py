"""Volume primitive: a NanoVDB density grid → a neural field (pos → (rgb,
σ)) (port of ``instant_ngp_tpu/volume/task.py``; reference
testbed_volume.cu).

  * the grid's index box is fitted into [0, 1]³ keeping its aspect; a 128³
    world-space bitgrid marks the cells that hold density above 1e-3
    (load_volume, :674-697), and delta-tracking events count only there
  * albedo 0.95, scattering 0, distance scale 1/100 (testbed.h:980-982);
    the procedural sun and sky light the paths
  * each step's batch is traced through the ground-truth grid: up to 4
    vertices (position, jittered density) a path, each with its attempt's
    terminal radiance as rgb target (``tracking.generate_batch``: kernel L
    on the card, one launch a step); L2 loss over the 4 outputs, averaged
    over the valid vertices; the model runs kernels A and B forward and F
    and E backward
  * ``render``: the learned field by transmittance tracking through the
    bitgrid, the model run on each iteration's event rays (kernels A and B),
    or the ground truth by a Woodcock path trace of the grid
    (``tracking.trace_gt``: kernel M, the rays in chunks)
  * ``compute_density_mse``: learned σ against the grid on random points.

The grid (f32) and the bitgrid (uint8) live on the device; the random
numbers come from the task's ``torch.Generator`` (``generator``), so a seed
gives the same run on one device, but not the JAX package's run: a test
hands both packages the same draws.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
from torch.func import functional_call

from ..io.nanovdb import read_nvdb_dense
from ..models.factory import autoconfig_grid_encoding
from ..models.network import NetworkTask
from ..ops.raymarch import ray_intersect_aabb
from ..render.camera import pinhole_rays
from . import tracking
from .tracking import MAX_TRAIN_VERTICES, proc_envmap

BITGRID_RES = 128
RENDER_ITERS = 192  # the learned render's lockstep iterations
GT_CHUNK = 1 << 16  # rays a ground-truth trace takes at once: 256 · 5 · 4 B of draws a ray
MSE_SEED = 99


def occupancy_bitgrid(dense: np.ndarray) -> np.ndarray:
    """The 128³ world-space bitgrid (bool) of a grid fitted into [0, 1]³:
    the cell under each voxel centre with density > 1e-3."""
    res = np.asarray(dense.shape)
    ii, jj, kk = np.nonzero(dense > 1e-3)
    extent = res / float(res.max())
    centers = (np.stack([ii, jj, kk], -1) + 0.5) / res
    world = (0.5 - extent / 2) + centers * extent
    cell = np.clip((world * 128.0 + 0.5).astype(np.int32), 0, 127)
    bitgrid = np.zeros((BITGRID_RES,) * 3, bool)
    bitgrid[cell[:, 0], cell[:, 1], cell[:, 2]] = True
    return bitgrid


class VolumeTask(NetworkTask):
    """A neural volume of one density grid: the model, the optimizer and
    its state, the traced batches, the step, ``render`` and
    ``compute_density_mse``. The constructor follows the JAX package's
    (task.py:50-122)."""

    def __init__(self, nvdb_path_or_grid, config: dict, device="cuda", seed: int = 1337,
                 batch_size: int = 1 << 17, albedo: float = 0.95, scattering: float = 0.0,
                 inv_distance_scale: float = 100.0):
        if isinstance(nvdb_path_or_grid, (str, Path)):
            dense, _ = read_nvdb_dense(nvdb_path_or_grid)
        else:
            dense = np.asarray(nvdb_path_or_grid, np.float32)
        self.device = torch.device(device)
        self.grid_res = np.array(dense.shape)
        longest = float(self.grid_res.max())
        self.world2index_scale = longest
        extent = self.grid_res / longest
        self.aabb_min = (0.5 - extent / 2).astype(np.float32)
        self.aabb_max = (0.5 + extent / 2).astype(np.float32)
        self.aabb_min_t = torch.from_numpy(self.aabb_min).to(self.device)
        self.aabb_max_t = torch.from_numpy(self.aabb_max).to(self.device)
        self.density_grid = torch.from_numpy(np.ascontiguousarray(dense)).to(self.device)
        self.global_majorant = float(dense.max())
        # divisions by these constants are f32 reciprocal multiplies, as the
        # JAX package's compiled code computes them (and a CUDA tensor's
        # division by a Python scalar)
        self.inv_majorant = float(np.float32(1.0) / np.float32(self.global_majorant))
        self.inv_extent = np.float32(1.0) / (self.aabb_max - self.aabb_min)
        self._inv_extent_t = torch.from_numpy(self.inv_extent).to(self.device)
        self.bitgrid = torch.from_numpy(occupancy_bitgrid(dense).astype(np.uint8)).to(self.device)
        self.albedo = albedo
        self.scattering = scattering
        self.distance_scale = 1.0 / max(inv_distance_scale, 0.01)
        self.batch_size = batch_size
        self.up_dir = np.array([0.0, 1.0, 0.0], np.float32)
        self.sun_dir = np.array([0.577, 0.577, 0.577], np.float32)
        self.sky_col = np.array([0.35, 0.55, 0.85], np.float32)
        self._res_i = torch.as_tensor(self.grid_res, dtype=torch.int32, device=self.device)
        self._res_f = self._res_i.to(torch.float32)

        self.network_config = config  # as given, before the grid's autoconfiguration
        config = dict(config)
        config["encoding"] = autoconfig_grid_encoding(
            config.get("encoding", {}), "volume", volume_world2index_scale=self.world2index_scale)
        self.config = config
        self._init_network(config, 3, 4, seed, "L2")
        self.generator = torch.Generator(device=self.device).manual_seed(seed ^ 0x0DD)
        self.use_kernels = True

    @property
    def scale(self) -> float:
        """The mean free path over the majorant's: distance_scale / majorant,
        rounded to f32 as the JAX package's f32 arithmetic rounds it."""
        return float(np.float32(self.distance_scale / self.global_majorant))

    def set_use_kernels(self, flag: bool) -> None:
        """True (default): the model runs kernels A, B, E and F, the batch
        kernel L and the ground-truth render kernel M on CUDA tensors.
        False: their plain versions."""
        self.model.set_use_kernels(flag)
        self.use_kernels = flag

    # --- ground-truth reads ---
    def _voxel(self, idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(the flat grid index of voxel indices (n, 3) int32, clamped into
        the grid; whether each lies inside it)."""
        res = self._res_i
        inb = torch.all((idx >= 0) & (idx < res), dim=-1)
        idx = torch.minimum(torch.clamp(idx, min=0), res - 1).to(torch.int64)
        r1, r2 = int(self.grid_res[1]), int(self.grid_res[2])
        return (idx[:, 0] * r1 + idx[:, 1]) * r2 + idx[:, 2], inb

    def _take(self, idx: torch.Tensor) -> torch.Tensor:
        """The grid at voxel indices (n, 3) int32; 0 outside the grid."""
        flat, inb = self._voxel(idx)
        return torch.where(inb, self.density_grid.reshape(-1)[flat], 0.0)

    def _rel(self, pos: torch.Tensor) -> torch.Tensor:
        return (pos - self.aabb_min_t) * self._inv_extent_t

    def _nearest_index(self, pos: torch.Tensor) -> torch.Tensor:
        """The voxel under world positions (n, 3): floor of the index."""
        return torch.floor(self._rel(pos) * self._res_f).to(torch.int32)

    def _jittered_index(self, pos: torch.Tensor, jitter: torch.Tensor) -> torch.Tensor:
        """The voxel floor(index − 0.5 + jitter), jitter (n, 3) in [0, 1)."""
        return torch.floor(self._rel(pos) * self._res_f - 0.5 + jitter).to(torch.int32)

    def _grid_density_at(self, pos: torch.Tensor) -> torch.Tensor:
        """The density at world positions (n, 3): the nearest voxel (floor)."""
        return self._take(self._nearest_index(pos))

    def _grid_density_at_jittered(self, pos: torch.Tensor, jitter: torch.Tensor) -> torch.Tensor:
        """The density at the voxel floor(index − 0.5 + jitter): a stochastic
        trilinear read (reference testbed_volume.cu:135-137)."""
        return self._take(self._jittered_index(pos, jitter))

    def _bitgrid_cell(self, pos: torch.Tensor) -> torch.Tensor:
        """The flat bitgrid cell of world positions (n, 3); the index
        truncates toward zero before the clip, as ``astype(int32)`` does."""
        cell = torch.clamp((pos * 128.0 + 0.5).to(torch.int32), 0, BITGRID_RES - 1).to(torch.int64)
        return (cell[:, 0] * BITGRID_RES + cell[:, 1]) * BITGRID_RES + cell[:, 2]

    def _bitgrid_at(self, pos: torch.Tensor) -> torch.Tensor:
        """The bitgrid's cell at world positions (n, 3) (bool)."""
        return self.bitgrid.reshape(-1)[self._bitgrid_cell(pos)] != 0

    # --- training ---
    def generate_batch(self, draws: tracking.BatchDraws):
        """(pts (B, 3), tgt (B, 4), valid (B,)) of the draws: kernel L, or
        its plain version where the kernels are off or on the CPU."""
        fn = tracking.generate_batch if self.use_kernels else tracking.generate_batch_plain
        return fn(self, draws)

    def step_gradients(self, pts: torch.Tensor, tgt: torch.Tensor,
                       valid: torch.Tensor) -> tuple[list[torch.Tensor], torch.Tensor]:
        """Forward and backward of one step on a batch (task.py:279-294):
        the per-row mean of L2 over the 4 outputs, summed over the valid
        rows over their count (at least 1). (grads in ``param_list`` order,
        the loss)."""
        with torch.enable_grad():
            pred = self.model(pts).to(torch.float32)
            per = torch.mean(self.loss(tgt, pred), dim=-1)
            v = valid.to(torch.float32)
            loss = torch.sum(per * v) / torch.clamp(torch.sum(v), min=1.0)
            grads = torch.autograd.grad(loss, self.model.param_list())
        return list(grads), loss.detach()

    def train(self, n_steps: int = 1) -> float:
        """n steps, each on a fresh batch traced from the task's generator.
        Returns the last step's loss (the one host read)."""
        loss = None
        for _ in range(n_steps):
            draws = tracking.draw_batch(self.generator, self.batch_size // MAX_TRAIN_VERTICES)
            loss = self.train_step(*self.generate_batch(draws))
            self.training_step += 1
        return float(loss) if loss is not None else 0.0

    # --- inference ---
    def _field(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        return functional_call(self.model, params, (x,)).to(torch.float32)

    @torch.no_grad()
    def compute_density_mse(self, n_samples: int = 1 << 18, positions=None) -> float:
        """Learned σ against the grid's nearest voxel on uniform points of the
        box (task.py:442-452): ``positions`` (n, 3), else n_samples drawn from
        seed 99."""
        if positions is None:
            g = torch.Generator(device=self.device).manual_seed(MSE_SEED)
            u = torch.rand((n_samples, 3), generator=g, device=self.device)
            positions = u * (self.aabb_max_t - self.aabb_min_t) + self.aabb_min_t
        pos = torch.as_tensor(positions, dtype=torch.float32, device=self.device)
        gt = self._grid_density_at(pos)
        pred = self._field(self.inference_params(), pos)[:, 3]
        return float(torch.mean((gt - pred) ** 2))

    def render_rays(self, params: dict, o: torch.Tensor, d: torch.Tensor, uniforms=None):
        """The learned field by transmittance (delta) tracking
        (volume_render_kernel_step, testbed_volume.cu:376-438; task.py:
        316-363): exponential free flights through the bitgrid; at each event
        in an occupied cell the network's (rgb, σ) adds alpha = min(σ /
        majorant, 1) · (1 − opacity); a ray ends at opacity 0.99 or when it
        leaves the box; then the envmap fills the rest. The model runs only
        on each iteration's event rays (its rows are independent, so each
        ray's result is the JAX package's, which runs it on every ray). The
        loop stops once no ray is alive. ``uniforms`` (192, R) in [1e-7, 1),
        else one draw a ray an iteration from the generator. o, d (R, 3)
        f32 → (rgb (R, 3), opacity (R,))."""
        R = o.shape[0]
        tmin, tmax = ray_intersect_aabb(o, d, self.aabb_min_t, self.aabb_max_t)
        pos = o + tmin[:, None] * d
        rgb = torch.zeros_like(o)
        col_a = torch.zeros(R, device=o.device)
        idx = torch.nonzero(tmax > tmin).reshape(-1)
        for i in range(RENDER_ITERS):
            if idx.numel() == 0:
                break
            if uniforms is None:
                u = torch.rand(R, generator=self.generator, device=o.device)
                u = torch.clamp(u * (1.0 - tracking.GT_U_MIN) + tracking.GT_U_MIN,
                                min=tracking.GT_U_MIN)
            else:
                u = uniforms[i]
            dt = -torch.log(u[idx]) * self.scale
            p = pos[idx] + dt[:, None] * d[idx]
            pos[idx] = p
            inside = torch.all((p >= self.aabb_min_t) & (p <= self.aabb_max_t), dim=-1)
            event = inside & self._bitgrid_at(p)
            ev = idx[event]
            if ev.numel():
                out = self._field(params, p[event])
                extinction = torch.clamp(torch.clamp(out[:, 3], min=0.0) * self.inv_majorant,
                                         max=1.0)
                alpha = extinction * (1.0 - col_a[ev])
                rgb[ev] = rgb[ev] + alpha[:, None] * torch.clamp(out[:, :3], min=0.0)
                col_a[ev] = col_a[ev] + alpha
            idx = idx[inside & (col_a[idx] <= 0.99)]
        bg = proc_envmap(d, self.up_dir, self.sun_dir, self.sky_col)
        return rgb + (1.0 - col_a)[:, None] * bg, col_a

    def render_rays_gt(self, o: torch.Tensor, d: torch.Tensor, draws=None):
        """The ground truth of rays o, d (R, 3) f32 (``tracking.trace_gt``:
        kernel M on the card) → (rgb (R, 3), alpha (R,)). ``draws`` (256, 5,
        R), else drawn from the generator a chunk of GT_CHUNK rays at a time
        (the draws of a 1920x1080 frame would be 10 GB)."""
        trace = tracking.trace_gt if self.use_kernels else tracking.trace_gt_plain
        if draws is not None:
            return trace(self, o, d, draws)
        parts = [trace(self, o[s:s + GT_CHUNK], d[s:s + GT_CHUNK],
                       tracking.draw_gt(self.generator, min(GT_CHUNK, o.shape[0] - s)))
                 for s in range(0, o.shape[0], GT_CHUNK)]
        return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])

    @torch.no_grad()
    def render(self, width: int, height: int, camera_matrix, fov: float = 50.0,
               ground_truth: bool = False) -> torch.Tensor:
        """A frame (H, W, 4) f32 on the device: linear rgb and opacity, of
        the learned field or of the ground truth (task.py:415-440)."""
        o, d = pinhole_rays(width, height, camera_matrix, fov, self.device)
        d = d.to(torch.float32)
        if ground_truth:
            rgb, alpha = self.render_rays_gt(o, d)
        else:
            rgb, alpha = self.render_rays(self.inference_params(), o, d)
        return torch.cat([rgb, alpha[:, None]], -1).reshape(height, width, 4)
