"""NeRF training (port of the training half of
``instant_ngp_tpu/nerf/task.py``, task.py:78-87, 592-1168, 1170-1200,
1372-1464, 2421-2448; reference train_nerf, testbed_nerf.cu:2704-3382).

One step: pick (image, pixel) pairs, snap them to pixel centers, generate
rays through the dataset lens and the camera state (kernel I reads the
distortion map), march the occupancy grid (kernel C), read the pixels
against a random background (scaled by the views' exposure), evaluate the
model on the valid samples packed to a fixed capacity (kernels A and B; the
views' latents join the rgb MLP), composite with the loss of the task's
train mode and its backward in one pass (kernel G), backpropagate through
the MLPs (kernel F) into the hash tables (kernel E) and, where the camera is
optimized, into the samples' positions (kernel K) and the rays, the
distortion map (kernel H) and the exposure; take an Adam step of the model
and one of the camera state, and deposit the per-ray loss into the error
map (kernel H). The step has no host sync: the sample capacity is fixed,
and the grid's mean density stays on the device.

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
from ..ops.losses import HUBER_ALPHA, loss_and_grads
from ..ops.compaction import compact_gather, expand_gather, prefix_compaction_maps
from ..ops.scatter import scatter_add_rows_, scatter_add_rows_plain_
from ..render.camera import so3_exp, uv_to_ray_cam
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
    optimizer's state (None until a step optimizes them)."""

    opt_state: dict | None
    grid: OccupancyGrid
    error_map: torch.Tensor
    cam: dict = dataclasses.field(default_factory=dict)
    cam_opt: dict | None = None


@dataclasses.dataclass
class StepDraws:
    """Random inputs of one step: image (R,) int64, uv (R, 2) in [0, 1),
    pdf (R,) of the pick relative to uniform, march jitter (R,), the
    background's uniform sRGB (R, 3), and with ``max_level_rand_training``
    each ray's level cap 2·U[0, 1) (R,) (task.py:849-851)."""

    img_idx: torch.Tensor
    uv: torch.Tensor
    pdf: torch.Tensor
    jitter: torch.Tensor
    bg: torch.Tensor
    max_level: torch.Tensor | None = None


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
    return StepDraws(img, uv, pdf, jitter, bg, max_level)


def read_pixels(task, img_idx: torch.Tensor, uv: torch.Tensor):
    """Nearest-pixel read → (premultiplied linear RGBA (R, 4), ok (R,));
    magenta with alpha 0 marks a masked pixel (reference read_rgba,
    common_device.cuh:846-869)."""
    w, h = task.dataset.resolution
    px = torch.clamp(torch.floor(uv[:, 0] * w).to(torch.int64), 0, w - 1)
    py = torch.clamp(torch.floor(uv[:, 1] * h).to(torch.int64), 0, h - 1)
    raw = task.images[img_idx, py, px]
    if task.dataset.is_hdr:
        return raw.to(torch.float32), torch.ones(raw.shape[0], dtype=torch.bool, device=raw.device)
    rgba = raw.to(torch.float32) / 255.0
    masked = (raw[:, 0] == 255) & (raw[:, 1] == 0) & (raw[:, 2] == 255) & (raw[:, 3] == 0)
    rgb = srgb_to_linear(rgba[:, :3]) * rgba[:, 3:4]
    return torch.cat([rgb, rgba[:, 3:4]], dim=-1), ~masked


def generate_rays(task, img_idx: torch.Tensor, uv: torch.Tensor, cam: dict | None = None):
    """uv → world rays (o, d) through the dataset's lens and the images'
    camera transforms (task.py:615-678, perspective and opencv). With the
    camera state ``cam`` (name → tensor, differentiable where its leaves
    require grad): the focal lengths scaled by 1 + cam["focal"] where the
    focal length is optimized, the distortion map's offsets at uv added to
    the camera-space direction's xy where the state holds one, and where the
    extrinsics are optimized so3_exp(cam["rot"]) applied before the
    image's rotation and cam["pos"] added to its origin."""
    w, h = task.dataset.resolution
    xform = task.xforms[img_idx]
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


def composite_train_plain(out, ts, dts, valid, target, bg, pixel_ok, mean_density,
                          near_distance: float, reg_scale: float, inv_n_rays: float,
                          loss_type: LossType, rgb_activation: NerfActivation,
                          density_activation: NerfActivation, mode: str = "nerf",
                          want_dtarget: bool = False):
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

    Returns (per-ray loss (R,), d objective / d out (R, K, 4)), and with
    ``want_dtarget`` also d objective / d target (R, 3) (summed over the
    samples in the RFL modes)."""
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
    dtarget = None
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
    elif mode == "rfl":
        l_s, lp_s, lt_s = loss_and_grads(loss_type, tgt, c)
        L = torch.sum(l_s, dim=-1)
        l_bg, _, lt_bg = loss_and_grads(loss_type, target, bg)
        comp = torch.sum(w * L, dim=1) + bg_w * torch.sum(l_bg, dim=-1)
        suffix_l = comp[:, None] - torch.cumsum(w * L, dim=1)
        dtau = ct * ((T * e) * L - suffix_l)
        ds = torch.where(valid, dtau * dts * dgrad, 0.0)
        dc = ct[:, None, :] * w[..., None] * lp_s
        if want_dtarget:
            dtarget = ct * (torch.sum(w[..., None] * lt_s, dim=1) + bg_w[:, None] * lt_bg)
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
    else:
        raise ValueError(f"unknown train mode {mode!r}")
    foggy = mean_density < NERF_MIN_OPTICAL_THICKNESS
    coeff = (torch.where(foggy & (s < 0.0), -1e-4, 0.0)
             + torch.where((s > -10.0) & (ts < near_distance), 1e-4, 0.0))
    ds = ds + coeff * valid * reg_scale * clip_grad(s, -30.0, 30.0)
    dx = dc * network_to_rgb_grad(x, rgb_activation)
    dout = torch.cat([dx, ds[..., None]], dim=-1)
    return (per_ray, dout, dtarget) if want_dtarget else (per_ray, dout)


def composite_train(out, ts, dts, valid, target, bg, pixel_ok, mean_density,
                    near_distance: float, reg_scale: float, inv_n_rays: float,
                    loss_type: LossType, rgb_activation: NerfActivation,
                    density_activation: NerfActivation, mode: str = "nerf",
                    want_dtarget: bool = False):
    """See ``composite_train_plain``. CPU tensors run the plain version;
    CUDA tensors launch kernel G (a warp per ray, a lane per sample: the
    forward's sums as warp scans, the backward from the forward's state;
    where K > 64 that state of the samples past 64 goes to a scratch
    buffer allocated here at the size the kernel's library gives), for
    every loss and train mode."""
    args = (out, ts, dts, valid, target, bg, pixel_ok, mean_density, near_distance, reg_scale,
            inv_n_rays, loss_type, rgb_activation, density_activation, mode, want_dtarget)
    if out.device.type == "cpu":
        return composite_train_plain(*args)
    R, K = ts.shape
    mean_density = mean_density.reshape(1)
    cuda_lib.check_cuda(out, ts, dts, target, bg, mean_density, dtype=torch.float32)
    cuda_lib.check_cuda(valid, pixel_ok, dtype=torch.bool)
    if out.shape != (R, K, 4) or target.shape != (R, 3) or bg.shape != (R, 3):
        raise ValueError(f"composite shapes out {tuple(out.shape)}, target "
                         f"{tuple(target.shape)}, bg {tuple(bg.shape)} for ({R}, {K})")
    if out.data_ptr() % 16:
        raise ValueError("kernel G reads out's rows as float4: out must be 16-byte aligned")
    per_ray = torch.empty((R,), dtype=torch.float32, device=out.device)
    dout = torch.empty_like(out)
    dtarget = torch.empty_like(target) if want_dtarget else None
    if R > 0:
        n_scratch = cuda_lib.query("composite_train_scratch_floats", R, K)
        scratch = (torch.empty((n_scratch,), dtype=torch.float32, device=out.device)
                   if n_scratch > 0 else None)
        cuda_lib.launch("composite_train", out.data_ptr(), ts.data_ptr(), dts.data_ptr(),
                        valid.data_ptr(), target.data_ptr(), bg.data_ptr(), pixel_ok.data_ptr(),
                        mean_density.data_ptr(), R, K, near_distance, reg_scale, inv_n_rays,
                        EPS_T, LOSS_CODES[loss_type], MODE_CODES[mode],
                        ACTIVATION_CODES[rgb_activation], ACTIVATION_CODES[density_activation],
                        per_ray.data_ptr(), dout.data_ptr(),
                        None if dtarget is None else dtarget.data_ptr(),
                        None if scratch is None else scratch.data_ptr())
    return (per_ray, dout, dtarget) if want_dtarget else (per_ray, dout)


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MarchedBatch:
    """The rays of a step and their samples: uv after the pixel snap (R,
    2), origins and directions (R, 3), the (R, K) window ts, dts, valid and
    the per-ray sample counts n_valid (R,)."""

    uv: torch.Tensor
    o: torch.Tensor
    d: torch.Tensor
    ts: torch.Tensor
    dts: torch.Tensor
    valid: torch.Tensor
    n_valid: torch.Tensor


def march_batch(task, draws: StepDraws) -> MarchedBatch:
    """Snap the picked pixels to their centers, make their rays (through the
    camera state as it stands, not differentiated) and march them through
    the occupancy grid (kernel C)."""
    uv = draws.uv
    if task.snap_to_pixel_centers:
        uv = (torch.floor(uv * task.resolution_t) + 0.5) / task.resolution_t
    with torch.no_grad():
        o, d = generate_rays(task, draws.img_idx, uv, task.cam_offsets)
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
    if cap is None or cap >= R * K:
        return pos_w, dirs, None
    maps = prefix_compaction_maps(batch.n_valid, K, cap)
    return compact_gather(pos_w, maps).contiguous(), compact_gather(dirs, maps).contiguous(), maps


def per_sample(x: torch.Tensor | None, maps, K: int):
    """A per-ray (R, …) tensor spread to the rows ``sample_inputs`` gives:
    the (R·K) window's, or the packed rows' (row j of ray src[j] // K)."""
    if x is None:
        return None
    if maps is None:
        return x[:, None].expand(x.shape[0], K, *x.shape[1:]).reshape(-1, *x.shape[1:])
    return x[torch.div(maps.src, K, rounding_mode="floor")]


def eval_samples(task, batch: MarchedBatch, rays=None, extra=None, max_level=None):
    """Network outputs (R, K, 4) on the window, with autograd to the
    parameters (and to ``rays`` and the per-ray latents ``extra`` (R, E)
    where they require grad), and the validity after the capacity drop.
    ``max_level``: each ray's level cap (R,)."""
    R, K = batch.ts.shape
    pos, dirs, maps = sample_inputs(task, batch, rays)
    out = task.model(pos, dirs, extra=per_sample(extra, maps, K),
                     max_level=per_sample(max_level, maps, K))
    if maps is None:
        return out.reshape(R, K, 4), batch.valid
    return expand_gather(out, maps).reshape(R, K, 4), batch.valid & maps.kept.reshape(R, K)


def targets(task, draws: StepDraws, uv: torch.Tensor, exposure: torch.Tensor | None = None):
    """The pixels against the step's random background → (target (R, 3),
    background (R, 3), pixel_ok (R,)), in sRGB for LDR datasets (the
    reference trains LDR in sRGB space, testbed_nerf.cu:995-999). With the
    per-image ``exposure`` (n, 3), the linear pixel is scaled by
    2^exposure first (task.py:907-922), differentiably."""
    texsamp, pixel_ok = read_pixels(task, draws.img_idx, uv)
    bg_linear = srgb_to_linear(draws.bg) if task.random_bg_color else torch.zeros_like(draws.bg)
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


def step_gradients(task, draws: StepDraws, batch: MarchedBatch | None = None):
    """Forward and backward of one step without the update, in the task's
    train mode: returns (grads in ``param_list`` order, followed where the
    step optimizes the camera (``task.optimizes_camera``) by the camera
    leaves' in ``camera_keys`` order; per-ray loss (R,); the marched batch).
    ``batch`` is the step's march when it was already made.

    The march runs on the camera state as it stands; where the extrinsics
    or the focal length are optimized the rays are made again from leaves
    that require grad, so the samples' positions and directions carry the
    gradient to them (through kernels F's dX and K), the march's ts kept
    (task.py:923-926). The exposure reaches the objective through the
    targets: kernel G gives d objective / d target, and autograd takes it
    on to the exposure. Leaves the step does not reach get zeros."""
    R = draws.img_idx.shape[0]
    if batch is None:
        batch = march_batch(task, draws)
    params = task.model.param_list()
    cam_on = task.optimizes_camera()
    keys = task.camera_keys() if cam_on else []
    with torch.enable_grad():
        leaves = {k: task.cam_offsets[k].detach().requires_grad_(True) for k in keys}
        exposure = leaves["exposure"] if cam_on and task.optimize_exposure else None
        target, bg, pixel_ok = targets(task, draws, batch.uv, exposure)
        rays = None
        if cam_on and (task.optimize_extrinsics or task.optimize_focal_length):
            rays = generate_rays(task, draws.img_idx, batch.uv, leaves)
        extra = leaves["extra"][draws.img_idx] if "extra" in leaves else None
        out, valid = eval_samples(task, batch, rays, extra, draws.max_level)
        composite = composite_train if task.use_kernels else composite_train_plain
        result = composite(
            out.detach().contiguous(), batch.ts, batch.dts, valid.contiguous(),
            target.detach().contiguous(), bg.contiguous(), pixel_ok.contiguous(),
            task.state.grid.mean_density, task.training_near_distance,
            task.density_reg_scale * INV_LOSS_SCALE, float(np.float32(1.0) / np.float32(R)),
            task.loss_type, task.rgb_activation, task.density_activation, task.train_mode,
            want_dtarget=exposure is not None)
        per_ray, dout = result[:2]
        outputs, cotangents = [out], [dout]
        if exposure is not None:
            outputs.append(target)
            cotangents.append(result[2])
        wrt = params + [leaves[k] for k in keys]
        grads = torch.autograd.grad(outputs, wrt, grad_outputs=cotangents, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for g, x in zip(grads, wrt)]
    return grads, per_ray, batch


def error_deposit(task, img_idx, uv, per_ray, pdf):
    """The bilinear deposit of loss / pdf into the 4 error-map cells around
    uv (reference compute_loss kernel deposit_val,
    testbed_nerf.cu:1041-1070): flat cell indices (4R,) and values (4R, 1)
    of the (n_images, EH, EW) map."""
    eh, ew = task.error_map_res
    deposit = per_ray / torch.clamp(pdf, min=1e-6)
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


def deposit_error(task, img_idx, uv, per_ray, pdf) -> None:
    """Add the step's ``error_deposit`` straight into the error map, in
    place (kernel H), as the JAX step's ``error_map.at[corners].add``."""
    corners, vals = error_deposit(task, img_idx, uv, per_ray, pdf)
    scatter_ = scatter_add_rows_ if task.use_kernels else scatter_add_rows_plain_
    scatter_(task.state.error_map.view(-1, 1), corners, vals)


def train_step(task, draws: StepDraws) -> dict:
    """One training step in place. Returns device scalars ``loss`` (mean
    per-ray loss) and ``measured_samples`` (valid samples marched)."""
    grads, per_ray, batch = step_gradients(task, draws)
    params = task.model.param_list()
    cam_grads = grads[len(params):]
    grads = grads[:len(params)]
    n_net = len(task.model.density_network.weights) + len(task.model.rgb_network.weights)
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
        deposit_error(task, draws.img_idx, batch.uv, per_ray, draws.pdf)
    return {"loss": torch.mean(per_ray), "measured_samples": torch.sum(batch.n_valid)}


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


def train(task, n_steps: int = 1) -> float:
    """n training steps (task.py:1372-1464): a grid update every 16 steps
    (full before step 128), adaptive rays per batch from the samples the
    last step marched, exact corner gradients from step
    ``exact_corners_after`` on, the error-map CDF rebuilt on a ×1.5-growing
    interval, and an abort when a batch marched no sample. Returns the last
    step's loss.

    The last step's stats live on the task (``task.last_stats``), so
    ``n`` calls of ``train(1)`` are one call of ``train(n)``. The JAX
    package keeps them only within a call: under its ``Testbed.frame()``,
    one step per call, the ray count never adapts and the zero-sample
    abort never fires. The port departs from it there on purpose."""
    loss = None
    K = task.march_cfg.max_samples_per_ray
    for _ in range(n_steps):
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
                    return float(stats["loss"])
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
        draws = draw_step(task, task.generator, task.n_rays_current, task.cdf_valid)
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
