"""NeRF training (port of the training half of
``instant_ngp_tpu/nerf/task.py``, task.py:78-87, 592-1168, 1170-1200,
1372-1464, 2421-2448; reference train_nerf, testbed_nerf.cu:2704-3382).

One step: pick (image, pixel) pairs, snap them to pixel centers, generate
rays through the dataset lens and the camera state (kernel I reads the
distortion map), each at its image's size and, for a moving camera, at its
pixel's shutter time between the start and end transforms; or read the
supplied rays (kernel I's row gather); march the occupancy grid (kernel C),
read the pixels against a random background (scaled by the views' exposure;
the trained environment map composited over it, kernel I's bilinear entry),
evaluate the model on the valid samples packed to a fixed capacity (kernels
A and B; the views' latents join the rgb MLP), composite with the loss of
the task's train mode, the depth objective and their backward in one pass
(kernel G), backpropagate through the MLPs (kernel F) into the hash tables
(kernel E) and, where the camera is optimized, into the samples' positions
(kernel K) and the rays, the distortion map and the environment map
(kernel H) and the exposure; take an optimizer step of the model and an
Adam step of the camera state, and deposit the per-ray loss into the error
map (kernel H), weighted by the view's sharpness where asked. The step has
no host sync: the sample capacity is fixed, and the grid's mean density
stays on the device.

The random numbers of a step come in as tensors (``StepDraws``, drawn by
``draw_step`` from a ``torch.Generator``), so a test can hand in the JAX
package's draws. Functions take the ``NerfTask`` whose state they train.
"""

from __future__ import annotations

import dataclasses
import math
import warnings

import numpy as np
import torch

from .. import cuda_lib
from ..common import (
    ACTIVATION_CODES,
    EPS_T,
    NERF_CASCADES,
    NERF_GRIDSIZE,
    NERF_MIN_OPTICAL_THICKNESS,
    LensMode,
    LossType,
    NerfActivation,
    clip_grad,
    linear_to_srgb,
    network_to_density,
    network_to_density_grad,
    network_to_rgb,
    network_to_rgb_grad,
    srgb_to_linear,
)
from ..ops.compaction import compact_gather, expand_gather, prefix_compaction_maps
from ..ops.gather import take_rows, take_rows_plain
from ..ops.losses import HUBER_ALPHA, loss_and_grads, loss_type_from_string
from ..ops.raymarch import mip_from_pos
from ..ops.scatter import scatter_add_rows_, scatter_add_rows_plain_
from ..parallel import sharding
from ..render.camera import camera_slerp, so3_exp, uv_to_ray_cam
from .occupancy import OccupancyGrid, draw_grid_update, update_grid
from .sampler import march_rays, march_rays_plain

MIN_PDF = 0.01  # per-axis error-CDF smoothing (reference MIN_PDF)
MIN_PMF_IMG = 0.1  # image-CDF smoothing (reference MIN_PMF)
# kernel G's codes of the losses and train modes (csrc/composite_train.cu)
LOSS_CODES = {LossType.L2: 0, LossType.HUBER: 1, LossType.L1: 2, LossType.MAPE: 3,
              LossType.SMAPE: 4, LossType.LOGL1: 5, LossType.RELATIVE_L2: 6}
MODE_CODES = {"nerf": 0, "rfl": 1, "rflrelax": 2}
INV_LOSS_SCALE = 1.0 / 128.0  # the reference's fp16 loss scale (testbed.h:311)


@dataclasses.dataclass
class NerfTrainState:
    """What a training step changes besides the model's parameters: the
    optimizer state (None until the first step, ``NerfTask.optimizer_state``),
    the occupancy grid, the accumulated error map (n_images, EH, EW), the
    camera offsets (name → f32 tensor, ``NerfTask.cam_offsets``) and their
    optimizer's state (None until a step optimizes them), and with
    ``include_sharpness_in_error`` the sharpest view seen per occupancy cell
    (NERF_CASCADES, G, G, G) (reference sharpness_grid,
    testbed_nerf.cu:2709-2723)."""

    opt_state: dict | None
    grid: OccupancyGrid
    error_map: torch.Tensor
    cam: dict = dataclasses.field(default_factory=dict)
    cam_opt: dict | None = None
    sharp_grid: torch.Tensor | None = None


@dataclasses.dataclass
class StepDraws:
    """Random inputs of one step: image (R,) int64, uv (R, 2) in [0, 1),
    pdf (R,) of the pick relative to uniform, march jitter (R,), the
    background's uniform sRGB (R, 3), with ``max_level_rand_training`` each
    ray's level cap 2·U[0, 1) (R,) (task.py:849-851), and for a moving
    camera each ray's motion-blur time U[0, 1) (R,) (task.py:865-875)."""

    img_idx: torch.Tensor
    uv: torch.Tensor
    pdf: torch.Tensor
    jitter: torch.Tensor
    bg: torch.Tensor
    max_level: torch.Tensor | None = None
    motion_time: torch.Tensor | None = None


def error_map_res(n_rays_per_batch: int, n_images: int, img_res) -> tuple[int, int]:
    """Error-map (EH, EW) from the ray budget (reference
    testbed_nerf.cu:2754-2758), evaluated once at the mid-schedule
    interval as the JAX package does."""
    n_samples_per_image = 648 * n_rays_per_batch / max(n_images, 1)
    r = int(math.sqrt(math.sqrt(n_samples_per_image)) * 3.5)
    w, h = img_res
    return (max(8, min(r, h, 128)), max(8, min(r, w, 128)))


def _bin(cdf: torch.Tensor, idx: torch.Tensor):
    """The CDF value before bin idx of each row, and the bin's mass."""
    prev = torch.where(idx > 0, torch.gather(cdf, 1, torch.clamp(idx - 1, min=0)[:, None])[:, 0],
                       0.0)
    return prev, torch.gather(cdf, 1, idx[:, None])[:, 0] - prev


def sample_pixels(task, u_img: torch.Tensor, uv_u: torch.Tensor, use_cdf: bool):
    """(image, uv, pdf) from uniforms (task.py:763-840). Without the error
    CDF: a uniform image and uv. With it: the image from the smoothed image
    CDF (if ``sample_image_proportional_to_error``) and the pixel half
    uniformly, half from the per-image 2-D CDF (if
    ``sample_focal_plane_proportional_to_error``; reference sample_cdf_2d /
    pdf_2d, nerf_device.cuh:497-553); inverse CDFs are compare-counts."""
    n_img = task.dataset.n_images
    R = u_img.shape[0]
    img_on = task.use_error_map and use_cdf and task.sample_image_proportional_to_error
    uv_on = task.use_error_map and use_cdf and task.sample_focal_plane_proportional_to_error
    ones = torch.ones((R,), dtype=torch.float32, device=uv_u.device)
    if img_on:
        img = torch.clamp(torch.sum(task.cdf_img[None, :] < u_img[:, None], dim=1), 0, n_img - 1)
        pdf_img = task.pmf_img[img] * n_img
    else:
        img, pdf_img = torch.clamp((u_img * n_img).to(torch.int64), 0, n_img - 1), ones
    if not uv_on:
        return img, uv_u, pdf_img
    eh, ew = task.error_map_res
    ux, uy = uv_u[:, 0], uv_u[:, 1]
    use_uniform = ux < 0.5
    ux_c = (ux - 0.5) * 2.0
    cdf_y = task.cdf_y[img]
    y_idx = torch.clamp(torch.sum(cdf_y < uy[:, None], dim=1), 0, eh - 1)
    prev_y, pmf_y = _bin(cdf_y, y_idx)
    frac_y = torch.clamp((uy - prev_y) / torch.clamp(pmf_y, min=1e-12), 0.0, 1.0)
    cdf_x = task.cdf_x[img, y_idx]
    x_idx = torch.clamp(torch.sum(cdf_x < ux_c[:, None], dim=1), 0, ew - 1)
    prev_x, pmf_x = _bin(cdf_x, x_idx)
    frac_x = torch.clamp((ux_c - prev_x) / torch.clamp(pmf_x, min=1e-12), 0.0, 1.0)
    uv_cdf = torch.stack([(x_idx + frac_x) / ew, (y_idx + frac_y) / eh], dim=-1)
    uv_uni = torch.stack([ux * 2.0, uy], dim=-1)
    uv = torch.where(use_uniform[:, None], uv_uni, uv_cdf)
    # pdf_2d at the final uv, for both branches
    py = torch.clamp((uv[:, 1] * eh).to(torch.int64), 0, eh - 1)
    px = torch.clamp((uv[:, 0] * ew).to(torch.int64), 0, ew - 1)
    pmf_y_at = _bin(task.cdf_y[img], py)[1]
    pmf_x_at = _bin(task.cdf_x[img, py], px)[1]
    uv_pdf = 0.5 + pmf_x_at * pmf_y_at * (eh * ew) * 0.5
    return img, uv, pdf_img * uv_pdf


def draw_step(task, generator: torch.Generator, n_rays: int, use_cdf: bool) -> StepDraws:
    dev = generator.device
    u_img = torch.rand((n_rays,), generator=generator, device=dev)
    uv_u = torch.rand((n_rays, 2), generator=generator, device=dev)
    img, uv, pdf = sample_pixels(task, u_img, uv_u, use_cdf)
    jitter = torch.rand((n_rays,), generator=generator, device=dev)
    bg = torch.rand((n_rays, 3), generator=generator, device=dev)
    max_level = None
    if task.max_level_rand_training:
        max_level = 2.0 * torch.rand((n_rays,), generator=generator, device=dev)
    motion_time = None
    if task.has_motion:
        motion_time = torch.rand((n_rays,), generator=generator, device=dev)
    return StepDraws(img, uv, pdf, jitter, bg, max_level, motion_time)


def image_size(task, img_idx: torch.Tensor):
    """Each ray's image (w, h) as f32 (R,) tensors where the images differ
    in size, else the dataset's as floats."""
    if task.img_wh is None:
        w, h = task.dataset.resolution
        return float(w), float(h)
    wh = task.img_wh[img_idx].to(torch.float32)
    return wh[:, 0], wh[:, 1]


def pixel_index(uv: torch.Tensor, w, h) -> tuple[torch.Tensor, torch.Tensor]:
    """The pixel (px, py) (R,) int64 under uv in an image of (w, h) pixels
    (numbers or (R,) tensors), clamped to the image."""
    px = torch.floor(uv[:, 0] * w).to(torch.int64)
    py = torch.floor(uv[:, 1] * h).to(torch.int64)
    if not torch.is_tensor(w):
        return torch.clamp(px, 0, int(w) - 1), torch.clamp(py, 0, int(h) - 1)
    return (torch.minimum(torch.clamp(px, min=0), w.to(torch.int64) - 1),
            torch.minimum(torch.clamp(py, min=0), h.to(torch.int64) - 1))


def read_pixels(task, img_idx: torch.Tensor, uv: torch.Tensor):
    """Nearest-pixel read at each image's own size → (premultiplied linear
    RGBA (R, 4), ok (R,)); magenta with alpha 0 marks a masked pixel
    (reference read_rgba, common_device.cuh:846-869)."""
    px, py = pixel_index(uv, *image_size(task, img_idx))
    raw = task.images[img_idx, py, px]
    if task.dataset.is_hdr:
        return raw.to(torch.float32), torch.ones(raw.shape[0], dtype=torch.bool, device=raw.device)
    rgba = raw.to(torch.float32) / 255.0
    masked = (raw[:, 0] == 255) & (raw[:, 1] == 0) & (raw[:, 2] == 255) & (raw[:, 3] == 0)
    rgb = srgb_to_linear(rgba[:, :3]) * rgba[:, 3:4]
    return torch.cat([rgb, rgba[:, 3:4]], dim=-1), ~masked


def supplied_rays(task, img_idx: torch.Tensor, uv: torch.Tensor):
    """The supplied rays (o, d) under uv, from the (N·H·W, 6) table at the
    canvas's size (kernel I's row gather on the card), d normalized
    (task.py:624-634; the lens, the transforms and the camera state are
    bypassed, reference testbed_nerf.cu:2381)."""
    w, h = task.dataset.resolution
    px, py = pixel_index(uv, w, h)
    idx = ((img_idx * h + py) * w + px).to(torch.int32)
    take = take_rows if task.use_kernels else take_rows_plain
    r = take(task.rays, idx)
    d = r[:, 3:]
    return r[:, :3], d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-12)


def generate_rays(task, img_idx: torch.Tensor, uv: torch.Tensor, cam: dict | None = None,
                  motion_time: torch.Tensor | None = None):
    """uv → world rays (o, d) through the dataset's lens and the images'
    camera transforms at each image's own size (task.py:615-678), or the
    supplied rays where the dataset has them. A moving camera's transform is
    ``camera_slerp`` of the start and end transforms at the pixel's time
    clamp(rs·(1, u, v, motion_time), 0, 1), rs the view's rolling shutter.
    With the camera state ``cam`` (name → tensor, differentiable where its
    leaves require grad): the focal lengths scaled by 1 + cam["focal"] where
    the focal length is optimized, the distortion map's offsets at uv added
    to the camera-space direction's xy where the state holds one, and where
    the extrinsics are optimized so3_exp(cam["rot"]) applied before the
    image's rotation and cam["pos"] added to its origin."""
    if task.rays is not None:
        return supplied_rays(task, img_idx, uv)
    w, h = image_size(task, img_idx)
    xform = task.xforms[img_idx]
    if task.has_motion:
        rs = task.rolling_shutter[img_idx]
        if motion_time is None:
            motion_time = torch.zeros_like(uv[:, 0])
        pixel_t = torch.clamp(rs[:, 0] + rs[:, 1] * uv[:, 0] + rs[:, 2] * uv[:, 1]
                              + rs[:, 3] * motion_time, 0.0, 1.0)
        xform = camera_slerp(xform, task.xforms_end[img_idx], pixel_t)
    focal = task.focals[img_idx]
    if cam is not None and task.optimize_focal_length:
        focal = focal * (1.0 + cam["focal"])[None, :]
    dir_cam, o_off = uv_to_ray_cam(uv, (w, h), focal, task.principals[img_idx],
                                   lens_mode=LensMode(task.dataset.lens_mode),
                                   lens_params=task.lens_params)
    if cam is not None and "distortion" in cam:
        from .task import distortion_read

        off = distortion_read(cam["distortion"], uv, task.use_kernels)
        dir_cam = torch.cat([dir_cam[:, :2] + off, dir_cam[:, 2:]], dim=-1)
    rot = xform[:, :, :3]
    o = xform[:, :, 3]
    if cam is not None and task.optimize_extrinsics:
        rot = torch.einsum("rij,rjk->rik", so3_exp(cam["rot"][img_idx]), rot)
        o = o + cam["pos"][img_idx]
    d = torch.einsum("rij,rj->ri", rot, dir_cam)
    o = o + torch.einsum("rij,rj->ri", rot, o_off)
    d = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-12)
    return o, d


# ---------------------------------------------------------------------------
# composite + loss + backward (kernel G and its plain version)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DepthTerm:
    """The depth objective of a step (task.py:1021-1037): per-ray target
    depths (R,) f32 (0: none), its weight λ and its loss."""

    target: torch.Tensor
    lam: float
    loss_type: LossType


def composite_train_plain(out, ts, dts, valid, target, bg, pixel_ok, mean_density,
                          near_distance: float, reg_scale: float, inv_n_rays: float,
                          loss_type: LossType, rgb_activation: NerfActivation,
                          density_activation: NerfActivation, mode: str = "nerf",
                          want_dtarget: bool = False, depth: DepthTerm | None = None,
                          want_dbg: bool = False, want_depth: bool = False):
    """The training composite of an (R, K) window of raw network outputs
    ``out`` (R, K, 4), its loss and its gradient, in train mode ``mode``.

    Forward (task.py:743-761, 937-940): T_k = exp(−Σ_{j≤k} τ_j + τ_k),
    w_k = (1 − e^{−τ_k})·T_k, rgb = Σ w_k·c_k, plus T_final·bg where
    T_final ≥ EPS_T; the per-ray loss mean_c(loss(target, rgb))·ok in every
    mode (the error map's deposit). Backward of the mode's objective
    (task.py:930-990) plus Σ stopgrad(coeff)·clip(σ_logit, ±30) (the density
    regularizers, task.py:1004-1020):

    - "nerf": mean(per-ray loss). With G = d objective / d rgb, dτ_k =
      G·(T_{k+1}·c_k − suffix_k), suffix_k = rgb − Σ_{j≤k} w_j c_j.
    - "rfl": the loss composited over the samples, Σ_k w_k·ℓ(target, c_k) +
      T_final·ℓ(target, bg), averaged like the per-ray loss: the same suffix
      identity with each sample's channel-summed loss L_k in place of c_k.
    - "rflrelax": each sample judged on lerp(rgb behind it, c_k, α_k) with
      stop-gradient coefficients: d/d c_k = T_k·α_k·ℓ'(lerp_k) and d/d σ_k
      = σ'·dt·⟨ℓ'(lerp_k), T_after·c_k − suffix_k⟩, both ·ok/(3R), where
      rgb behind = suffix_k / max(T_after, 1e-6), T_after = T_k − w_k.

    With ``depth``, the objective gains λ·mean(ℓ_d(target depth, depth)·
    [target depth > 0]), depth = Σ w_k·t_k, in every mode: dτ_k gains
    D·(T_{k+1}·t_k − depth suffix_k), D = d objective / d depth. The per-ray
    loss stays photometric.

    Returns (per-ray loss (R,), d objective / d out (R, K, 4), d objective
    / d target (R, 3) with ``want_dtarget`` (summed over the samples in the
    RFL modes), d objective / d bg (R, 3) with ``want_dbg`` (zeros in
    rflrelax, whose coefficients are stop-gradients), the depth (R,) with
    ``want_depth``), None in each slot not asked for."""
    x, s = out[..., :3], out[..., 3]
    c = network_to_rgb(x, rgb_activation)
    sigma = torch.where(valid, network_to_density(s, density_activation), 0.0)
    tau = sigma * dts
    T = torch.exp(-torch.cumsum(tau, dim=-1) + tau)
    e = torch.exp(-tau)
    w = (1.0 - e) * T
    wc = w[..., None] * c
    T_final = torch.exp(-torch.sum(tau, dim=-1))
    bg_w = torch.where(T_final >= EPS_T, T_final, 0.0)
    rgb = torch.sum(wc, dim=1) + bg_w[:, None] * bg
    ok = pixel_ok.to(out.dtype)
    loss, lp, lt = loss_and_grads(loss_type, target, rgb)
    per_ray = torch.mean(loss, dim=-1) * ok
    # cotangent of each ray's channel-mean, in the order JAX's autodiff forms it
    ct = (inv_n_rays * ok / 3.0)[:, None]
    suffix = rgb[:, None, :] - torch.cumsum(wc, dim=1)
    dgrad = network_to_density_grad(s, density_activation)
    tgt = target[:, None, :].expand_as(c)
    dtarget = dbg = None
    if mode == "nerf":
        if loss_type == LossType.HUBER:
            d = rgb - target
            cth = ct / 5.0
            G = torch.where(torch.abs(d) > HUBER_ALPHA, cth * torch.sign(d),
                            cth * (5.0 * d) + cth * d * 5.0)
        elif loss_type == LossType.L2:
            d = rgb - target
            G = ct * d + ct * d
        else:
            G = ct * lp
        dtau = torch.sum(G[:, None, :] * ((T * e)[..., None] * c - suffix), dim=-1)
        ds = torch.where(valid, dtau * dts * dgrad, 0.0)
        dc = G[:, None, :] * w[..., None]
        if want_dtarget:
            dtarget = ct * lt
        dbg = G * bg_w[:, None]
    elif mode == "rfl":
        l_s, lp_s, lt_s = loss_and_grads(loss_type, tgt, c)
        L = torch.sum(l_s, dim=-1)
        l_bg, lp_bg, lt_bg = loss_and_grads(loss_type, target, bg)
        comp = torch.sum(w * L, dim=1) + bg_w * torch.sum(l_bg, dim=-1)
        suffix_l = comp[:, None] - torch.cumsum(w * L, dim=1)
        dtau = ct * ((T * e) * L - suffix_l)
        ds = torch.where(valid, dtau * dts * dgrad, 0.0)
        dc = ct[:, None, :] * w[..., None] * lp_s
        if want_dtarget:
            dtarget = ct * (torch.sum(w[..., None] * lt_s, dim=1) + bg_w[:, None] * lt_bg)
        dbg = ct * bg_w[:, None] * lp_bg
    elif mode == "rflrelax":
        alpha = 1.0 - e
        T_after = T - w
        rgb_bg = suffix / torch.clamp(T_after, min=1e-6)[..., None]
        lerp = (1.0 - alpha[..., None]) * rgb_bg + alpha[..., None] * c
        _, g_local, lt_s = loss_and_grads(loss_type, tgt, lerp)
        coef = (T * valid)[..., None] * ct[:, None, :]
        dc = coef * alpha[..., None] * g_local
        dsig = torch.sum(g_local * (T_after[..., None] * c - suffix), dim=-1)
        ds = dsig * dts * valid * ct * dgrad
        if want_dtarget:
            dtarget = torch.sum(coef * lt_s, dim=1)
        dbg = torch.zeros_like(bg)
    else:
        raise ValueError(f"unknown train mode {mode!r}")
    depth_ray = torch.sum(w * ts, dim=1) if depth is not None or want_depth else None
    if depth is not None:
        _, dlp, _ = loss_and_grads(depth.loss_type, depth.target, depth_ray)
        D = torch.where(depth.target > 0, depth.lam * inv_n_rays * dlp, 0.0)
        suffix_d = depth_ray[:, None] - torch.cumsum(w * ts, dim=1)
        ds = ds + torch.where(valid, D[:, None] * ((T * e) * ts - suffix_d) * dts * dgrad, 0.0)
    foggy = mean_density < NERF_MIN_OPTICAL_THICKNESS
    coeff = (torch.where(foggy & (s < 0.0), -1e-4, 0.0)
             + torch.where((s > -10.0) & (ts < near_distance), 1e-4, 0.0))
    ds = ds + coeff * valid * reg_scale * clip_grad(s, -30.0, 30.0)
    dx = dc * network_to_rgb_grad(x, rgb_activation)
    dout = torch.cat([dx, ds[..., None]], dim=-1)
    return (per_ray, dout, dtarget if want_dtarget else None, dbg if want_dbg else None,
            depth_ray if want_depth else None)


def composite_train(out, ts, dts, valid, target, bg, pixel_ok, mean_density,
                    near_distance: float, reg_scale: float, inv_n_rays: float,
                    loss_type: LossType, rgb_activation: NerfActivation,
                    density_activation: NerfActivation, mode: str = "nerf",
                    want_dtarget: bool = False, depth: DepthTerm | None = None,
                    want_dbg: bool = False, want_depth: bool = False):
    """See ``composite_train_plain``. CPU tensors run the plain version;
    CUDA tensors launch kernel G (a warp per ray, a lane per sample: the
    forward's sums as warp scans, the backward from the forward's state;
    where K > 64 that state of the samples past 64 goes to a scratch
    buffer allocated here at the size the kernel's library gives), for
    every loss and train mode, with the depth term and outputs as asked."""
    args = (out, ts, dts, valid, target, bg, pixel_ok, mean_density, near_distance, reg_scale,
            inv_n_rays, loss_type, rgb_activation, density_activation, mode, want_dtarget)
    if out.device.type == "cpu":
        return composite_train_plain(*args, depth=depth, want_dbg=want_dbg,
                                     want_depth=want_depth)
    R, K = ts.shape
    mean_density = mean_density.reshape(1)
    cuda_lib.check_cuda(out, ts, dts, target, bg, mean_density, dtype=torch.float32)
    cuda_lib.check_cuda(valid, pixel_ok, dtype=torch.bool)
    if out.shape != (R, K, 4) or target.shape != (R, 3) or bg.shape != (R, 3):
        raise ValueError(f"composite shapes out {tuple(out.shape)}, target "
                         f"{tuple(target.shape)}, bg {tuple(bg.shape)} for ({R}, {K})")
    if out.data_ptr() % 16:
        raise ValueError("kernel G reads out's rows as float4: out must be 16-byte aligned")
    if depth is not None:
        cuda_lib.check_cuda(depth.target, dtype=torch.float32)
        if depth.target.shape != (R,):
            raise ValueError(f"target depths {tuple(depth.target.shape)} for {R} rays")
    per_ray = torch.empty((R,), dtype=torch.float32, device=out.device)
    dout = torch.empty_like(out)
    dtarget = torch.empty_like(target) if want_dtarget else None
    dbg = torch.empty_like(bg) if want_dbg else None
    depth_ray = torch.empty_like(per_ray) if want_depth else None
    if R > 0:
        n_scratch = cuda_lib.query("composite_train_scratch_floats", R, K)
        scratch = (torch.empty((n_scratch,), dtype=torch.float32, device=out.device)
                   if n_scratch > 0 else None)
        cuda_lib.launch("composite_train", out.data_ptr(), ts.data_ptr(), dts.data_ptr(),
                        valid.data_ptr(), target.data_ptr(), bg.data_ptr(), pixel_ok.data_ptr(),
                        mean_density.data_ptr(), R, K, near_distance, reg_scale, inv_n_rays,
                        EPS_T, LOSS_CODES[loss_type], MODE_CODES[mode],
                        ACTIVATION_CODES[rgb_activation], ACTIVATION_CODES[density_activation],
                        per_ray.data_ptr(), dout.data_ptr(), _ptr(dtarget),
                        None if depth is None else depth.target.data_ptr(),
                        0.0 if depth is None else depth.lam,
                        LOSS_CODES[LossType.L1 if depth is None else depth.loss_type],
                        _ptr(depth_ray), _ptr(dbg), _ptr(scratch))
    return per_ray, dout, dtarget, dbg, depth_ray


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MarchedBatch:
    """The rays of a step and their samples: uv after the pixel snap (R,
    2), origins and directions (R, 3), the (R, K) window ts, dts, valid and
    the per-ray sample counts n_valid (R,); ``depth``, the composite's depth
    per ray (R,), once ``step_gradients`` has made it where the step needs
    it (the sharpness-weighted deposit). On a rank of a sharded step these
    are its slice of the step's rays: ``total_rays`` is the step's whole
    count and ``before`` the valid samples of the slices before this one (a
    device scalar), so that the capacity drop and the loss are the whole
    step's."""

    uv: torch.Tensor
    o: torch.Tensor
    d: torch.Tensor
    ts: torch.Tensor
    dts: torch.Tensor
    valid: torch.Tensor
    n_valid: torch.Tensor
    depth: torch.Tensor | None = None
    total_rays: int = 0
    before: torch.Tensor | None = None


def snapped_uv(task, uv: torch.Tensor) -> torch.Tensor:
    """The picked uv, snapped to pixel centres where the task asks it."""
    if task.snap_to_pixel_centers:
        uv = (torch.floor(uv * task.resolution_t) + 0.5) / task.resolution_t
    return uv


def march_batch(task, draws: StepDraws) -> MarchedBatch:
    """Snap the picked pixels to their centers, make their rays (through the
    camera state as it stands, not differentiated) and march them through
    the occupancy grid (kernel C)."""
    uv = snapped_uv(task, draws.uv)
    with torch.no_grad():
        o, d = generate_rays(task, draws.img_idx, uv, task.cam_offsets, draws.motion_time)
    march = march_rays if task.use_kernels else march_rays_plain
    ts, dts, valid, _, n_valid = march(o, d, task.state.grid.skipmip, *task._aabb_t,
                                       draws.jitter, task.march_cfg)
    return MarchedBatch(uv, o, d, ts, dts, valid, n_valid)


def sample_inputs(task, batch: MarchedBatch, rays=None):
    """The network inputs of the window's samples: positions in the unit
    cube and warped directions, packed into ``task.compact_samples`` rows
    (valid samples beyond it are dropped, task.py:683-742). ``rays``: the
    (o, d) to place the samples on in place of the march's (the same values,
    differentiable in the camera state). Returns (pos (M, 3), dirs (M, 3),
    the compaction maps, or None when the whole (R, K) window fits)."""
    R, K = batch.ts.shape
    o, d = (batch.o, batch.d) if rays is None else rays
    pos_w, dirs = task._window_inputs(o, d, batch.ts)
    cap = task.compact_samples
    if cap is None or cap >= (batch.total_rays or R) * K:
        return pos_w, dirs, None
    if batch.before is None:
        maps = prefix_compaction_maps(batch.n_valid, K, cap)
    else:  # a rank's slice: the whole step's first cap valid samples are kept
        maps = prefix_compaction_maps(batch.n_valid, K, min(cap, R * K), cap - batch.before)
    return compact_gather(pos_w, maps).contiguous(), compact_gather(dirs, maps).contiguous(), maps


def per_sample(x: torch.Tensor | None, maps, K: int):
    """A per-ray (R, …) tensor spread to the rows ``sample_inputs`` gives:
    the (R·K) window's, or the packed rows' (row j of ray src[j] // K)."""
    if x is None:
        return None
    if maps is None:
        return x[:, None].expand(x.shape[0], K, *x.shape[1:]).reshape(-1, *x.shape[1:])
    return x[torch.div(maps.src, K, rounding_mode="floor")]


def eval_samples(task, batch: MarchedBatch, rays=None, extra=None, max_level=None,
                 f32_dw: bool = False):
    """Network outputs (R, K, 4) on the window, with autograd to the
    parameters (and to ``rays`` and the per-ray latents ``extra`` (R, E)
    where they require grad), and the validity after the capacity drop.
    ``max_level``: each ray's level cap (R,). ``f32_dw``: see
    ``MLP.forward``."""
    R, K = batch.ts.shape
    pos, dirs, maps = sample_inputs(task, batch, rays)
    out = task.model(pos, dirs, extra=per_sample(extra, maps, K),
                     max_level=per_sample(max_level, maps, K), f32_dw=f32_dw)
    if maps is None:
        return out.reshape(R, K, 4), batch.valid
    return expand_gather(out, maps).reshape(R, K, 4), batch.valid & maps.kept.reshape(R, K)


def targets(task, draws: StepDraws, uv: torch.Tensor, exposure: torch.Tensor | None = None,
            envmap: torch.Tensor | None = None, d: torch.Tensor | None = None):
    """The pixels against the step's random background → (target (R, 3),
    background (R, 3), pixel_ok (R,)), in sRGB for LDR datasets (the
    reference trains LDR in sRGB space, testbed_nerf.cu:995-999). With the
    per-image ``exposure`` (n, 3), the linear pixel is scaled by
    2^exposure first (task.py:907-922); with the (EH, EW, 4) ``envmap``,
    its read along the rays' directions ``d`` is composited over the random
    background (task.py:902-906); both differentiably."""
    texsamp, pixel_ok = read_pixels(task, draws.img_idx, uv)
    bg_linear = srgb_to_linear(draws.bg) if task.random_bg_color else torch.zeros_like(draws.bg)
    if envmap is not None:
        ev = read_envmap(envmap, d, task.use_kernels)
        bg_linear = ev[:, :3] + bg_linear * (1.0 - ev[:, 3:4])
    a = texsamp[:, 3:4]
    rgb = texsamp[:, :3]
    if exposure is not None:
        rgb = torch.exp(0.6931471805599453 * exposure[draws.img_idx]) * rgb
    if task.dataset.is_hdr:
        return rgb + (1.0 - a) * bg_linear, bg_linear, pixel_ok
    bg = linear_to_srgb(bg_linear)
    target = (linear_to_srgb(rgb / torch.clamp(a, min=1e-6)) * a
              * torch.where(a > 0, 1.0, 0.0) + (1.0 - a) * bg)
    return target, bg, pixel_ok


def step_gradients(task, draws: StepDraws, batch: MarchedBatch | None = None,
                   f32_dw: bool = False):
    """Forward and backward of one step without the update, in the task's
    train mode: returns (grads in ``param_list`` order, followed where the
    step optimizes the camera (``task.optimizes_camera``) by the camera
    leaves' in ``camera_keys`` order; per-ray loss (R,); the marched batch).
    ``batch`` is the step's march when it was already made. ``f32_dw``: the
    MLPs' gradients are their f32 sums, not yet rounded to bf16.

    The march runs on the camera state as it stands; where the extrinsics
    or the focal length are optimized the rays are made again from leaves
    that require grad, so the samples' positions and directions carry the
    gradient to them (through kernels F's dX and K), the march's ts kept
    (task.py:923-926). The exposure and the environment map reach the
    objective through the targets and the background: kernel G gives d
    objective / d target and d objective / d bg, and autograd takes them on.
    With depth maps and ``depth_supervision_lambda`` > 0 kernel G adds the
    depth objective. Leaves the step does not reach get zeros."""
    R = draws.img_idx.shape[0]
    if batch is None:
        batch = march_batch(task, draws)
    params = task.model.param_list()
    cam_on = task.optimizes_camera()
    keys = task.camera_keys() if cam_on else []
    with torch.enable_grad():
        leaves = {k: task.cam_offsets[k].detach().requires_grad_(True) for k in keys}
        exposure = leaves["exposure"] if cam_on and task.optimize_exposure else None
        envmap = leaves.get("envmap")
        target, bg, pixel_ok = targets(task, draws, batch.uv, exposure, envmap, batch.d)
        rays = None
        if cam_on and (task.optimize_extrinsics or task.optimize_focal_length):
            rays = generate_rays(task, draws.img_idx, batch.uv, leaves, draws.motion_time)
        extra = leaves["extra"][draws.img_idx] if "extra" in leaves else None
        out, valid = eval_samples(task, batch, rays, extra, draws.max_level, f32_dw)
        composite = composite_train if task.use_kernels else composite_train_plain
        want_dtarget = exposure is not None or envmap is not None
        want_depth = task.state.sharp_grid is not None and task.use_error_map
        per_ray, dout, dtarget, dbg, batch.depth = composite(
            out.detach().contiguous(), batch.ts, batch.dts, valid.contiguous(),
            target.detach().contiguous(), bg.detach().contiguous(), pixel_ok.contiguous(),
            task.state.grid.mean_density, task.training_near_distance,
            task.density_reg_scale * INV_LOSS_SCALE,
            float(np.float32(1.0) / np.float32(batch.total_rays or R)),
            task.loss_type, task.rgb_activation, task.density_activation, task.train_mode,
            want_dtarget=want_dtarget, depth=depth_term(task, draws.img_idx, batch.uv),
            want_dbg=envmap is not None, want_depth=want_depth)
        outputs, cotangents = [out], [dout]
        if dtarget is not None:
            outputs.append(target)
            cotangents.append(dtarget)
        if dbg is not None:
            outputs.append(bg)
            cotangents.append(dbg)
        wrt = params + [leaves[k] for k in keys]
        grads = torch.autograd.grad(outputs, wrt, grad_outputs=cotangents, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for g, x in zip(grads, wrt)]
    return grads, per_ray, batch


def depth_term(task, img_idx: torch.Tensor, uv: torch.Tensor) -> DepthTerm | None:
    """The step's depth objective where the dataset has depth maps and
    ``depth_supervision_lambda`` > 0: the target depth under uv at the
    canvas's size (task.py:1021-1037), λ and the ``depth_loss_type``."""
    if task.depths is None or task.depth_supervision_lambda <= 0:
        return None
    px, py = pixel_index(uv, *task.dataset.resolution)
    return DepthTerm(task.depths[img_idx, py, px].contiguous(),
                     float(task.depth_supervision_lambda),
                     loss_type_from_string(task.depth_loss_type))


def read_envmap(envmap: torch.Tensor, d: torch.Tensor, use_kernel: bool = True) -> torch.Tensor:
    """The (R, 4) lat-long environment map (EH, EW, 4) along unit
    directions d (R, 3) (task.py:2451-2461): uv = (atan2(x, z)/2π + ½,
    asin(y)/π + ½), read bilinearly through kernel I's bilinear entry,
    its gradient a deposit through kernel H (``bilinear_read_differentiable``)."""
    from ..ops.gather import bilinear_read_differentiable

    eh, ew = envmap.shape[:2]
    theta = torch.atan2(d[:, 0], d[:, 2])
    phi = torch.asin(torch.clamp(d[:, 1], -1.0, 1.0))
    uv = torch.stack([theta / (2.0 * math.pi) + 0.5, phi / math.pi + 0.5], dim=-1)
    return bilinear_read_differentiable(envmap.reshape(eh * ew, 4), (ew, eh), uv.contiguous(),
                                        use_kernel)


@torch.no_grad()
def sharpness_factor(task, img_idx, uv, o, d, depth) -> torch.Tensor:
    """The sharpness weight of each ray's deposit (task.py:1104-1135): the
    view's sharpness under uv is max-scattered into the sharp grid at the
    cell of the ray's expected hit (``scatter_reduce_``, as the JAX package's
    ``.at[].max``), and the deposit is scaled by max(sharp / max(sharp, the
    cell's before), 0.01) where the hit is inside the aabb, else 1."""
    smap = task.sharpness
    sh, sw = smap.shape[1:]
    sx, sy = pixel_index(uv, sw, sh)
    sharp = smap[img_idx, sy, sx] + 1e-6
    hit = o + depth[:, None] * d
    aabb_min, aabb_max = task._aabb_t
    in_aabb = torch.all((hit >= aabb_min) & (hit <= aabb_max), dim=-1)
    mip = torch.clamp(mip_from_pos(hit, task.max_cascade), 0, NERF_CASCADES - 1).to(torch.int64)
    p = (hit - 0.5) * torch.exp2(-mip.to(torch.float32))[:, None] + 0.5
    cell = torch.clamp(torch.floor(p * NERF_GRIDSIZE).to(torch.int64), 0, NERF_GRIDSIZE - 1)
    flat = ((mip * NERF_GRIDSIZE + cell[:, 0]) * NERF_GRIDSIZE + cell[:, 1]) * NERF_GRIDSIZE \
        + cell[:, 2]
    grid = task.state.sharp_grid.view(-1)
    old = grid[flat]
    grid.scatter_reduce_(0, flat, torch.where(in_aabb, sharp, 0.0), "amax")
    factor = torch.clamp(sharp / torch.maximum(sharp, old), min=0.01)
    return torch.where(in_aabb, factor, 1.0)


def error_deposit(task, img_idx, uv, per_ray, pdf, factor=None):
    """The bilinear deposit of loss / pdf (times ``factor`` (R,) where
    given, the sharpness weight) into the 4 error-map cells around uv
    (reference compute_loss kernel deposit_val, testbed_nerf.cu:1041-1070):
    flat cell indices (4R,) and values (4R, 1) of the (n_images, EH, EW)
    map."""
    eh, ew = task.error_map_res
    deposit = per_ray / torch.clamp(pdf, min=1e-6)
    if factor is not None:
        deposit = deposit * factor
    size = task.error_map_wh
    pos = torch.clamp(uv * size - 0.5, min=0.0)
    pos = torch.minimum(pos, size - 1.0 - 1e-4)
    pi = pos.to(torch.int64)
    pw = pos - pi
    px0 = torch.clamp(pi[:, 0], 0, ew - 2)
    py0 = torch.clamp(pi[:, 1], 0, eh - 2)
    base = (img_idx * eh + py0) * ew + px0
    corners = torch.cat([base, base + 1, base + ew, base + ew + 1])
    wx, wy = pw[:, 0], pw[:, 1]
    vals = torch.cat([(1 - wx) * (1 - wy) * deposit, wx * (1 - wy) * deposit,
                      (1 - wx) * wy * deposit, wx * wy * deposit])
    return corners, vals[:, None]


def deposit_error(task, img_idx, uv, per_ray, pdf, factor=None) -> None:
    """Add the step's ``error_deposit`` straight into the error map, in
    place (kernel H), as the JAX step's ``error_map.at[corners].add``."""
    corners, vals = error_deposit(task, img_idx, uv, per_ray, pdf, factor)
    scatter_ = scatter_add_rows_ if task.use_kernels else scatter_add_rows_plain_
    scatter_(task.state.error_map.view(-1, 1), corners, vals)


def shard_step(task, draws: StepDraws, group):
    """A rank's share of a sharded step (``task.mesh``): its contiguous
    slice of the step's draws (every rank drew the whole step's from the
    same generator), marched, with the step's ray count and the valid
    samples of the slices before it (one all-gather of a count), so that
    ``sample_inputs`` keeps the whole step's first ``compact_samples``."""
    R = draws.img_idx.shape[0]
    local = StepDraws(**{f.name: sharding.shard_batch(getattr(draws, f.name), group)
                         for f in dataclasses.fields(draws)})
    batch = march_batch(task, local)
    rank, _ = sharding.rank_and_size(group)
    K = batch.ts.shape[1]
    counts = sharding.all_gather_cat(
        torch.clamp(batch.n_valid.to(torch.int64), max=K).sum().reshape(1), group)
    batch.total_rays, batch.before = R, counts[:rank].sum()
    return local, batch


def train_step(task, draws: StepDraws) -> dict:
    """One training step in place. Returns device scalars ``loss`` (mean
    per-ray loss) and ``measured_samples`` (valid samples marched).

    With ``task.mesh`` (a process group) the step is data-parallel over its
    ranks: each marches, encodes, runs the MLPs and composites its slice of
    the rays (``shard_step``), the loss normalised by the whole step's ray
    count; every gradient is summed over the group in one all-reduce, the
    MLPs' dW as their f32 sums, rounded to bf16 after it as the unsharded
    backward rounds the whole batch's, so that every rank takes the same
    optimizer step; the per-ray losses are gathered, so that every rank
    deposits the whole step's error map and reports the whole step's loss
    and sample count. A mesh without an initialised process group raises."""
    group = task.mesh
    params = task.model.param_list()
    n_net = len(task.model.density_network.weights) + len(task.model.rgb_network.weights)
    if group is None:
        grads, per_ray, batch = step_gradients(task, draws)
        n_valid = torch.sum(batch.n_valid)
    else:
        local, batch = shard_step(task, draws, group)
        grads, per_ray, batch = step_gradients(task, local, batch, f32_dw=True)
        *grads, n_valid = sharding.all_reduce_sum_list(
            [*grads, batch.n_valid.sum().reshape(())], group)  # a count ≤ 2^24: exact in f32
        grads = [g.to(torch.bfloat16).float() for g in grads[:n_net]] + grads[n_net:]
        per_ray = sharding.all_gather_cat(per_ray, group)
        if task.use_error_map and task.state.sharp_grid is not None:
            batch = dataclasses.replace(
                batch, o=sharding.all_gather_cat(batch.o, group),
                d=sharding.all_gather_cat(batch.d, group),
                depth=sharding.all_gather_cat(batch.depth, group))
        batch = dataclasses.replace(batch, uv=snapped_uv(task, draws.uv))
    cam_grads = grads[len(params):]
    grads = grads[:len(params)]
    frozen = ((params[:n_net] if not task.shall_train_network else [])
              + (params[n_net:] if not task.shall_train_encoding else []))
    kept = [p.detach().clone() for p in frozen]
    task.opt.update(grads, task.optimizer_state(), params)
    with torch.no_grad():
        for p, k in zip(frozen, kept):
            p.copy_(k)
    if cam_grads:
        update_camera(task, cam_grads)
    if task.use_error_map:
        factor = None
        if task.state.sharp_grid is not None:
            factor = sharpness_factor(task, draws.img_idx, batch.uv, batch.o, batch.d,
                                      batch.depth)
        deposit_error(task, draws.img_idx, batch.uv, per_ray, draws.pdf, factor)
    return {"loss": torch.mean(per_ray), "measured_samples": n_valid}


@torch.no_grad()
def update_camera(task, cam_grads) -> None:
    """The camera state's step (task.py:1047-1074): Adam over every leaf;
    the latents pinned where ``optimize_extra_dims`` is off (Adam's state
    still advances); then the exposure and the focal offsets take the
    decoupled decays lr·exposure_l2_reg·old and lr·intrinsic_l2_reg·old, lr
    the optimizer's base rate."""
    cam = task.cam_offsets
    keys = task.camera_keys()
    old = {k: cam[k].clone() for k in ("extra", "exposure", "focal") if k in cam}
    opt = task.camera_optimizer()
    opt.update(cam_grads, task.camera_optimizer_state(), [cam[k] for k in keys])
    if "extra" in cam and not task.optimize_extra_dims:
        cam["extra"].copy_(old["extra"])
    lr = opt.spec.learning_rate
    if task.exposure_l2_reg:
        cam["exposure"].sub_(lr * task.exposure_l2_reg * old["exposure"])
    if task.intrinsic_l2_reg:
        cam["focal"].sub_(lr * task.intrinsic_l2_reg * old["focal"])


@torch.no_grad()
def update_grid_step(task, draws, full: bool) -> None:
    """Grid update from the inference parameters (the EMA when enabled)."""
    aabb_min, aabb_max = task._aabb_t

    def density_fn(pos_world):
        return task.inference_density((pos_world - aabb_min) / (aabb_max - aabb_min))[:, 0]

    update_grid(task.state.grid, density_fn, draws, task.density_grid_decay,
                task.density_activation, full)
    if task.state.sharp_grid is not None:  # it decays with the density grid (task.py:1195-1200)
        task.state.sharp_grid.mul_(task.density_grid_decay)


def rebuild_error_cdf(error_map: torch.Tensor):
    """Sampling CDFs from the accumulated error map (reference
    construct_cdf_2d / construct_cdf_1d, testbed_nerf.cu:1532-1580,
    2791-2859), each smoothed toward uniform. (n, EH, EW) → (cdf_x (n, EH,
    EW), cdf_y (n, EH), cdf_img (n,), pmf_img (n,))."""
    n, eh, ew = error_map.shape
    dev = error_map.device
    data = error_map + 1e-10
    cdf_x = torch.cumsum(data, dim=2)
    row_tot = cdf_x[:, :, -1]
    cdf_x = ((1.0 - MIN_PDF) * cdf_x / row_tot[:, :, None]
             + MIN_PDF * (torch.arange(1, ew + 1, dtype=torch.float32, device=dev) / ew))
    cdf_y = torch.cumsum(row_tot, dim=1)
    img_tot = cdf_y[:, -1]
    cdf_y = ((1.0 - MIN_PDF) * cdf_y / img_tot[:, None]
             + MIN_PDF * (torch.arange(1, eh + 1, dtype=torch.float32, device=dev) / eh))
    cdf_img_raw = torch.cumsum(img_tot, dim=0)
    total = cdf_img_raw[-1]
    pmf_img = (1.0 - MIN_PMF_IMG) * img_tot / total + MIN_PMF_IMG / n
    cdf_img = ((1.0 - MIN_PMF_IMG) * cdf_img_raw / total
               + MIN_PMF_IMG * (torch.arange(1, n + 1, dtype=torch.float32, device=dev) / n))
    return cdf_x, cdf_y, cdf_img, pmf_img


def begin_step(task) -> StepDraws | None:
    """What is due before a step (task.py:1372-1410): every 16 steps a grid
    update (full before step 128) and the ray count adapted to the samples
    the last step marched, exact corner gradients from step
    ``exact_corners_after`` on; then the step's draws. None, with
    ``training_aborted`` set, where the last step marched no sample."""
    K = task.march_cfg.max_samples_per_ray
    if task.training_step % task.grid_update_interval == 0:
        full = task.training_step < 128
        n_cascades = task.state.grid.density.shape[0]
        update_grid_step(task, draw_grid_update(task.generator, n_cascades, full), full)
        stats = task.last_stats
        if stats is not None:
            measured = int(stats["measured_samples"])
            if measured == 0:
                warnings.warn("NeRF training generated 0 samples; aborting training "
                              "(empty occupancy grid or cameras see no scene)")
                task.training_aborted = True
                return None
            fill = measured / (task.n_rays_current * K)
            want = (task.target_batch_size // 2) / max(fill * K, 1e-3)
            task.n_rays_current = 1 << int(np.clip(np.round(np.log2(max(want, 1.0))), 11,
                                                   task.max_ray_bucket_log2))
    enc = task.model.pos_encoding
    if (task.exact_corners_after is not None
            and task.training_step >= task.exact_corners_after
            and enc.hashed_grad_corners != 8):
        enc.hashed_grad_corners = 8
        task.exact_corners_after = None
    return draw_step(task, task.generator, task.n_rays_current, task.cdf_valid)


def train(task, n_steps: int = 1) -> float:
    """n training steps (task.py:1372-1464), each after ``begin_step``, the
    error-map CDF rebuilt on a ×1.5-growing interval, and an abort when a
    batch marched no sample. Returns the last step's loss.

    The last step's stats live on the task (``task.last_stats``), so
    ``n`` calls of ``train(1)`` are one call of ``train(n)``. The JAX
    package keeps them only within a call: under its ``Testbed.frame()``,
    one step per call, the ray count never adapts and the zero-sample
    abort never fires. The port departs from it there on purpose."""
    loss = None
    for _ in range(n_steps):
        draws = begin_step(task)
        if draws is None:
            return float(task.last_stats["loss"])
        task.last_stats = train_step(task, draws)
        loss = task.last_stats["loss"]
        task.training_step += 1
        if task.use_error_map:
            task.err_steps_since += 1
            if task.err_steps_since >= task.err_interval:
                task.cdf_x, task.cdf_y, task.cdf_img, task.pmf_img = rebuild_error_cdf(
                    task.state.error_map)
                task.state.error_map.zero_()
                task.cdf_valid = True
                task.err_steps_since = 0
                task.err_interval = int(task.err_interval * 1.5)
    return float(loss) if loss is not None else 0.0
