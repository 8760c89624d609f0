"""NeRF rendering from a snapshot (port of the render side of
``instant_ngp_tpu/nerf/task.py``; reference testbed_nerf.cu:1894-2150).

A frame renders in windows: march a K = 8 sample window for the alive
rays (kernel C), evaluate the model on the valid samples (kernels A and
B), composite the window (kernel D), and repeat while any ray is alive.
Alive rays and valid samples are compacted with plain index ops between
the steps. A ray stays alive while it is transparent enough, has scene
left and made marching progress in its last window.

``composite_window`` launches kernel D (``csrc/composite.cu``) on CUDA
tensors and runs ``composite_window_plain`` on CPU tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import cuda_lib
from ..common import (
    MAX_DEPTH,
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
from ..models.nerf_network import NerfNetwork
from ..ops.raymarch import ray_intersect_aabb
from ..render.camera import uv_to_ray_cam
from .occupancy import _bitfield_from_density, _skip_chain
from .sampler import MarchConfig, march_rays, march_rays_plain

EPS_T = 1e-4  # transmittance early-stop (reference EPSILON, testbed_nerf.cu:919)
# rays per render pass: bounds the (rays, K) window buffers of a large frame
RENDER_CHUNK = 1 << 18
ACTIVATION_CODES = {NerfActivation.NONE: 0, NerfActivation.RELU: 1,
                    NerfActivation.LOGISTIC: 2, NerfActivation.EXPONENTIAL: 3}


def composite_window_plain(out, ts, dts, valid, t, t_exit, T, rgb, depth, alive, tmax, cost,
                           eps_t: float, rgb_activation: NerfActivation,
                           density_activation: NerfActivation):
    """Composite one (R, K) window of network outputs onto the rays'
    running (T, rgb, depth). The weight of sample k is (1 − e^{−τ_k})·T·
    e^{−Σ_{j<k} τ_j} with τ = σ·dt. Returns the new (t, T, rgb, depth,
    alive, cost)."""
    rgb_s = network_to_rgb(out[..., :3].to(torch.float32), rgb_activation)
    sigma = network_to_density(out[..., 3].to(torch.float32), density_activation)
    sigma = torch.where(valid, sigma, 0.0)
    tau = sigma * dts
    T_cum = T[:, None] * torch.exp(-torch.cumsum(tau, dim=-1) + tau)
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
                     density_activation: NerfActivation):
    """See ``composite_window_plain``. CPU tensors run the plain version;
    CUDA tensors launch kernel D (one thread per ray)."""
    if out.device.type == "cpu":
        return composite_window_plain(out, ts, dts, valid, t, t_exit, T, rgb, depth, alive, tmax,
                                      cost, eps_t, rgb_activation, density_activation)
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
        cuda_lib.launch("composite_window", out.data_ptr(), ts.data_ptr(), dts.data_ptr(),
                        valid.data_ptr(), t.data_ptr(), t_exit.data_ptr(), T.data_ptr(),
                        rgb.data_ptr(), depth.data_ptr(), alive.data_ptr(), tmax.data_ptr(),
                        cost.data_ptr(), R, K, eps_t, ACTIVATION_CODES[rgb_activation],
                        ACTIVATION_CODES[density_activation], T_new.data_ptr(),
                        rgb_new.data_ptr(), depth_new.data_ptr(), alive_new.data_ptr(),
                        cost_new.data_ptr())
    return t_exit, T_new, rgb_new, depth_new, alive_new, cost_new


class NerfTask:
    """The render-side state of a NeRF scene: model, occupancy skip chain,
    aabb and crop box, and the render loop. Built from a snapshot's
    dataset block by ``Testbed.load_snapshot``."""

    def __init__(self, dataset: NerfDataset, config: dict, device):
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
        if dataset.render_aabb_to_local is not None and not np.allclose(
                dataset.render_aabb_to_local, np.eye(3)):
            raise NotImplementedError("rotated render crop boxes are not ported yet")
        self._aabb_t = (self._t(self.aabb_min), self._t(self.aabb_max))
        self.training_step = 0
        self.use_kernels = True
        g = NERF_GRIDSIZE
        self.set_density_grid(torch.zeros((self.max_cascade + 1, g, g, g), dtype=torch.float32))

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def set_density_grid(self, density: torch.Tensor) -> None:
        """Take a (n_cascades, G, G, G) float density grid: derive the
        bitfield and the skip chain the marcher reads."""
        density = density.to(self.device, torch.float32)
        mean = torch.mean(torch.clamp(density[0], min=0.0))
        self.skipmip = _skip_chain(_bitfield_from_density(density, mean)).contiguous()

    def set_use_kernels(self, flag: bool) -> None:
        """True (default): the render path runs the four CUDA kernels on
        CUDA tensors. False: it runs their plain versions, which is the
        reference a kernel render is checked against on the card."""
        self.use_kernels = flag
        self.model.set_use_kernels(flag)

    def _prep_rays(self, uv, wh, fl, pp, xform):
        """Ray generation through the dataset lens, clipped to the render
        crop box and the near plane → (o, d, tmin, tmax)."""
        R = uv.shape[0]
        dir_cam, o_off = uv_to_ray_cam(
            uv, (wh[0], wh[1]), fl[None, :].expand(R, 2), pp[None, :].expand(R, 2),
            lens_mode=LensMode(self.dataset.lens_mode),
            lens_params=self._t(self.dataset.lens_params))
        d = dir_cam @ xform[:, :3].T
        o = xform[:, 3].expand(d.shape) + o_off @ xform[:, :3].T
        d = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-12)
        tmin, tmax = self._crop_tminmax(o, d)
        tmin = torch.clamp(tmin, min=self.render_near_distance)
        return o, d, tmin, tmax

    def _crop_tminmax(self, o, d):
        """Ray interval inside scene AABB ∩ render crop box."""
        tmin, tmax = _aabb_entry(o, d, *self._aabb_t)
        t2min, t2max = _aabb_entry(o, d, self._t(self.render_aabb_min),
                                   self._t(self.render_aabb_max))
        return torch.maximum(tmin, t2min), torch.minimum(tmax, t2max)

    def _march_window(self, o, d, t, alive, tmax):
        """March one K-sample window from t for the alive rays (dead rays
        start at MAX_DEPTH, so they emit nothing)."""
        cfg = MarchConfig(n_march_iters=self.render_march_iters,
                          max_samples_per_ray=self.render_samples_per_window,
                          cone_angle=self.cone_angle, max_mip=self.max_cascade)
        jitter = torch.full_like(t, 0.5)
        t_in = torch.where(alive, t, MAX_DEPTH)
        march = march_rays if self.use_kernels else march_rays_plain
        ts, dts, valid, t_exit, n_valid = march(
            o, d, self.skipmip, self.aabb_min, self.aabb_max, jitter, cfg,
            t_init=t_in)
        valid = valid & alive[:, None]
        n_valid = torch.where(alive, n_valid, 0)
        return ts, dts, valid, t_exit, n_valid

    def _eval_window(self, o, d, ts, valid):
        """Network outputs (R, K, 4) on the valid samples of a window,
        zero elsewhere. Only the valid samples are evaluated."""
        R, K = ts.shape
        aabb_min, aabb_max = self._aabb_t
        pos = fma(ts[..., None], d[:, None, :], o[:, None, :])
        pos_w = ((pos - aabb_min) / (aabb_max - aabb_min)).reshape(R * K, 3)
        dirs = warp_direction(d)[:, None, :].expand(R, K, 3).reshape(R * K, 3)
        sel = torch.nonzero(valid.reshape(-1)).squeeze(1)
        out = torch.zeros((R * K, 4), dtype=torch.float32, device=o.device)
        if sel.numel() > 0:
            out[sel] = self.model(pos_w[sel], dirs[sel])
        return out.reshape(R, K, 4)

    def _composite_window(self, out, ts, dts, valid, t, t_exit, T, rgb, depth, alive, tmax,
                          cost, eps_t=EPS_T):
        composite = composite_window if self.use_kernels else composite_window_plain
        return composite(out, ts, dts, valid.contiguous(), t, t_exit, T, rgb, depth,
                         alive.contiguous(), tmax, cost, eps_t, self.rgb_activation,
                         self.density_activation)

    @torch.no_grad()
    def _render_rays(self, o, d, tminmax=None, max_rounds: int = 64):
        """Render rays → (rgb (R, 3), alpha (R,), depth (R,), cost (R,)):
        windows of march + eval + composite on the alive rays, compacted
        before each window."""
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
        for _ in range(max_rounds):
            idx = torch.nonzero(alive).squeeze(1)
            if idx.numel() == 0:
                break
            o_c, d_c, t_c, tmax_c = o[idx].contiguous(), d[idx].contiguous(), t[idx], tmax[idx]
            alive_c = torch.ones_like(idx, dtype=torch.bool)
            ts, dts, valid, t_exit, _ = self._march_window(o_c, d_c, t_c, alive_c, tmax_c)
            out = self._eval_window(o_c, d_c, ts, valid)
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
               render_mode: str = "shade") -> torch.Tensor:
        """Render a frame → (H, W, 4) f32 RGBA tensor on the task's device.
        Pixel centers, the dataset's lens. Shade mode, spp 1 and no depth
        of field are what this slice ports."""
        if render_mode != "shade" or spp != 1:
            raise NotImplementedError("only shade mode at spp 1 is ported yet")
        if focal_length is None:
            fl = 0.5 * height / math.tan(0.5 * math.radians(fov))
            focal_length = (fl, fl)
        xform = self._t(camera_matrix)
        ys, xs = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
        xs = xs.reshape(-1).astype(np.float32)
        ys = ys.reshape(-1).astype(np.float32)
        uv = torch.from_numpy(np.stack([(xs + 0.5) / width, (ys + 0.5) / height], -1)
                              .astype(np.float32)).to(self.device)
        wh = self._t([width, height])
        fl, pp = self._t(focal_length), self._t(principal_point)
        rgbs, alphas = [], []
        for i in range(0, uv.shape[0], RENDER_CHUNK):
            o, d, tmin, tmax = self._prep_rays(uv[i:i + RENDER_CHUNK], wh, fl, pp, xform)
            rgb, alpha, _, _ = self._render_rays(o, d, tminmax=(tmin, tmax))
            rgbs.append(rgb)
            alphas.append(alpha)
        rgb, alpha = torch.cat(rgbs), torch.cat(alphas)
        bg = self._t(background)
        rgb = rgb + (1.0 - alpha)[:, None] * bg[None, :3] * (bg[3] if len(bg) > 3 else 1.0)
        if to_srgb:
            rgb = linear_to_srgb(torch.clamp(rgb, min=0.0))
        return torch.cat([rgb, alpha[:, None]], -1).reshape(height, width, 4)


def _aabb_entry(o, d, aabb_min, aabb_max):
    return ray_intersect_aabb(o, d, aabb_min, aabb_max)
