"""NeRF training in mode "nerf" (port of the training half of
``instant_ngp_tpu/nerf/task.py``, task.py:78-87, 592-1168, 1170-1200,
1372-1464, 2421-2448; reference train_nerf, testbed_nerf.cu:2704-3382).

One step: pick (image, pixel) pairs, snap them to pixel centers, generate
rays through the dataset lens, march the occupancy grid (kernel C), read
the pixels against a random background, evaluate the model on the valid
samples packed to a fixed capacity (kernels A and B), composite with the
Huber loss and its backward in one pass (kernel G), backpropagate through
the MLPs (kernel F) into the hash tables (kernel E), take an Adam step,
and deposit the per-ray loss into the error map (kernel H). The step has
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
from ..ops.losses import HUBER_ALPHA, huber, l2
from ..ops.compaction import compact_gather, expand_gather, prefix_compaction_maps
from ..ops.scatter import scatter_add_rows_, scatter_add_rows_plain_
from ..render.camera import uv_to_ray_cam
from .occupancy import OccupancyGrid, draw_grid_update, update_grid
from .sampler import march_rays, march_rays_plain

MIN_PDF = 0.01  # per-axis error-CDF smoothing (reference MIN_PDF)
MIN_PMF_IMG = 0.1  # image-CDF smoothing (reference MIN_PMF)
LOSS_CODES = {LossType.L2: 0, LossType.HUBER: 1}  # the losses kernel G computes
INV_LOSS_SCALE = 1.0 / 128.0  # the reference's fp16 loss scale (testbed.h:311)


@dataclasses.dataclass
class NerfTrainState:
    """What a training step changes besides the model's parameters: the
    optimizer state (None until the first step, ``NerfTask.optimizer_state``),
    the occupancy grid and the accumulated error map (n_images, EH, EW)."""

    opt_state: dict | None
    grid: OccupancyGrid
    error_map: torch.Tensor


@dataclasses.dataclass
class StepDraws:
    """Random inputs of one step: image (R,) int64, uv (R, 2) in [0, 1),
    pdf (R,) of the pick relative to uniform, march jitter (R,), and the
    background's uniform sRGB (R, 3)."""

    img_idx: torch.Tensor
    uv: torch.Tensor
    pdf: torch.Tensor
    jitter: torch.Tensor
    bg: torch.Tensor


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
    CDF and the pixel half uniformly, half from the per-image 2-D CDF
    (reference sample_cdf_2d / pdf_2d, nerf_device.cuh:497-553); inverse
    CDFs are compare-counts."""
    n_img = task.dataset.n_images
    R = u_img.shape[0]
    if not (task.use_error_map and use_cdf):
        img = torch.clamp((u_img * n_img).to(torch.int64), 0, n_img - 1)
        return img, uv_u, torch.ones((R,), dtype=torch.float32, device=uv_u.device)
    eh, ew = task.error_map_res
    img = torch.clamp(torch.sum(task.cdf_img[None, :] < u_img[:, None], dim=1), 0, n_img - 1)
    pdf_img = task.pmf_img[img] * n_img
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
    return StepDraws(img, uv, pdf, torch.rand((n_rays,), generator=generator, device=dev),
                     torch.rand((n_rays, 3), generator=generator, device=dev))


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


def generate_rays(task, img_idx: torch.Tensor, uv: torch.Tensor):
    """uv → world rays (o, d) through the dataset's lens and the images'
    camera transforms (task.py:615-678, perspective and opencv)."""
    w, h = task.dataset.resolution
    xform = task.xforms[img_idx]
    dir_cam, o_off = uv_to_ray_cam(uv, (w, h), task.focals[img_idx], task.principals[img_idx],
                                   lens_mode=LensMode(task.dataset.lens_mode),
                                   lens_params=task.lens_params)
    rot = xform[:, :, :3]
    d = torch.einsum("rij,rj->ri", rot, dir_cam)
    o = xform[:, :, 3] + torch.einsum("rij,rj->ri", rot, o_off)
    d = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-12)
    return o, d


# ---------------------------------------------------------------------------
# composite + loss + backward (kernel G and its plain version)
# ---------------------------------------------------------------------------


def composite_train_plain(out, ts, dts, valid, target, bg, pixel_ok, mean_density,
                          near_distance: float, reg_scale: float, inv_n_rays: float,
                          loss_type: LossType, rgb_activation: NerfActivation,
                          density_activation: NerfActivation):
    """The training composite of an (R, K) window of raw network outputs
    ``out`` (R, K, 4), its loss and its gradient.

    Forward (task.py:743-761, 937-940): T_k = exp(−Σ_{j≤k} τ_j + τ_k),
    w_k = (1 − e^{−τ_k})·T_k, rgb = Σ w_k·c_k, plus T_final·bg where
    T_final ≥ EPS_T; per-ray loss mean_c(loss)·ok with Huber/5 or L2. Backward, of the
    objective mean(per-ray loss) plus Σ stopgrad(coeff)·clip(σ_logit, ±30)
    (the density regularizers, task.py:1004-1020): with G = d objective /
    d rgb, dτ_k = G·(T_{k+1}·c_k − suffix_k), suffix_k = rgb − Σ_{j≤k} w_j
    c_j. Returns (per-ray loss (R,), d objective / d out (R, K, 4))."""
    x, s = out[..., :3], out[..., 3]
    c = network_to_rgb(x, rgb_activation)
    sigma = torch.where(valid, network_to_density(s, density_activation), 0.0)
    tau = sigma * dts
    T = torch.exp(-torch.cumsum(tau, dim=-1) + tau)
    e = torch.exp(-tau)
    w = (1.0 - e) * T
    wc = w[..., None] * c
    T_final = torch.exp(-torch.sum(tau, dim=-1))
    rgb = torch.sum(wc, dim=1) + torch.where(T_final >= EPS_T, T_final, 0.0)[:, None] * bg
    d = rgb - target
    ok = pixel_ok.to(torch.float32)
    # cotangents of rgb, in the order JAX's autodiff forms them
    ct = (inv_n_rays * ok / 3.0)[:, None]
    if loss_type == LossType.HUBER:
        per_ray = torch.mean(huber(target, rgb) / 5.0, dim=-1) * ok
        ct = ct / 5.0
        G = torch.where(torch.abs(d) > HUBER_ALPHA, ct * torch.sign(d),
                        ct * (5.0 * d) + ct * d * 5.0)
    elif loss_type == LossType.L2:
        per_ray = torch.mean(l2(target, rgb), dim=-1) * ok
        G = ct * d + ct * d
    else:
        raise NotImplementedError(f"training loss {loss_type.value} is not ported yet")
    suffix = rgb[:, None, :] - torch.cumsum(wc, dim=1)
    dtau = torch.sum(G[:, None, :] * ((T * e)[..., None] * c - suffix), dim=-1)
    ds = torch.where(valid, dtau * dts * network_to_density_grad(s, density_activation), 0.0)
    foggy = mean_density < NERF_MIN_OPTICAL_THICKNESS
    coeff = (torch.where(foggy & (s < 0.0), -1e-4, 0.0)
             + torch.where((s > -10.0) & (ts < near_distance), 1e-4, 0.0))
    ds = ds + coeff * valid * reg_scale * clip_grad(s, -30.0, 30.0)
    dx = G[:, None, :] * w[..., None] * network_to_rgb_grad(x, rgb_activation)
    return per_ray, torch.cat([dx, ds[..., None]], dim=-1)


def composite_train(out, ts, dts, valid, target, bg, pixel_ok, mean_density,
                    near_distance: float, reg_scale: float, inv_n_rays: float,
                    loss_type: LossType, rgb_activation: NerfActivation,
                    density_activation: NerfActivation):
    """See ``composite_train_plain``. CPU tensors run the plain version;
    CUDA tensors launch kernel G (one thread per ray, forward and backward
    over its K samples)."""
    args = (out, ts, dts, valid, target, bg, pixel_ok, mean_density, near_distance, reg_scale,
            inv_n_rays, loss_type, rgb_activation, density_activation)
    if out.device.type == "cpu":
        return composite_train_plain(*args)
    R, K = ts.shape
    if loss_type not in LOSS_CODES:
        raise NotImplementedError(f"training loss {loss_type.value} is not ported yet")
    mean_density = mean_density.reshape(1)
    cuda_lib.check_cuda(out, ts, dts, target, bg, mean_density, dtype=torch.float32)
    cuda_lib.check_cuda(valid, pixel_ok, dtype=torch.bool)
    if out.shape != (R, K, 4) or target.shape != (R, 3) or bg.shape != (R, 3):
        raise ValueError(f"composite shapes out {tuple(out.shape)}, target "
                         f"{tuple(target.shape)}, bg {tuple(bg.shape)} for ({R}, {K})")
    per_ray = torch.empty((R,), dtype=torch.float32, device=out.device)
    dout = torch.empty_like(out)
    if R > 0:
        cuda_lib.launch("composite_train", out.data_ptr(), ts.data_ptr(), dts.data_ptr(),
                        valid.data_ptr(), target.data_ptr(), bg.data_ptr(), pixel_ok.data_ptr(),
                        mean_density.data_ptr(), R, K, near_distance, reg_scale, inv_n_rays,
                        EPS_T, LOSS_CODES[loss_type], ACTIVATION_CODES[rgb_activation],
                        ACTIVATION_CODES[density_activation], per_ray.data_ptr(),
                        dout.data_ptr())
    return per_ray, dout


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
    """Snap the picked pixels to their centers, make their rays and march
    them through the occupancy grid (kernel C)."""
    uv = draws.uv
    if task.snap_to_pixel_centers:
        uv = (torch.floor(uv * task.resolution_t) + 0.5) / task.resolution_t
    o, d = generate_rays(task, draws.img_idx, uv)
    march = march_rays if task.use_kernels else march_rays_plain
    ts, dts, valid, _, n_valid = march(o, d, task.state.grid.skipmip, *task._aabb_t,
                                       draws.jitter, task.march_cfg)
    return MarchedBatch(uv, o, d, ts, dts, valid, n_valid)


def sample_inputs(task, batch: MarchedBatch):
    """The network inputs of the window's samples: positions in the unit
    cube and warped directions, packed into ``task.compact_samples`` rows
    (valid samples beyond it are dropped, task.py:683-742). Returns (pos
    (M, 3), dirs (M, 3), the compaction maps, or None when the whole
    (R, K) window fits)."""
    R, K = batch.ts.shape
    pos_w, dirs = task._window_inputs(batch.o, batch.d, batch.ts)
    cap = task.compact_samples
    if cap is None or cap >= R * K:
        return pos_w, dirs, None
    maps = prefix_compaction_maps(batch.n_valid, K, cap)
    return compact_gather(pos_w, maps).contiguous(), compact_gather(dirs, maps).contiguous(), maps


def eval_samples(task, batch: MarchedBatch):
    """Network outputs (R, K, 4) on the window, with autograd to the
    parameters, and the validity after the capacity drop."""
    R, K = batch.ts.shape
    pos, dirs, maps = sample_inputs(task, batch)
    out = task.model(pos, dirs)
    if maps is None:
        return out.reshape(R, K, 4), batch.valid
    return expand_gather(out, maps).reshape(R, K, 4), batch.valid & maps.kept.reshape(R, K)


def targets(task, draws: StepDraws, uv: torch.Tensor):
    """The pixels against the step's random background → (target (R, 3),
    background (R, 3), pixel_ok (R,)), in sRGB for LDR datasets (the
    reference trains LDR in sRGB space, testbed_nerf.cu:995-999)."""
    texsamp, pixel_ok = read_pixels(task, draws.img_idx, uv)
    bg_linear = srgb_to_linear(draws.bg) if task.random_bg_color else torch.zeros_like(draws.bg)
    a = texsamp[:, 3:4]
    if task.dataset.is_hdr:
        return texsamp[:, :3] + (1.0 - a) * bg_linear, bg_linear, pixel_ok
    bg = linear_to_srgb(bg_linear)
    target = (linear_to_srgb(texsamp[:, :3] / torch.clamp(a, min=1e-6)) * a
              * torch.where(a > 0, 1.0, 0.0) + (1.0 - a) * bg)
    return target, bg, pixel_ok


def step_gradients(task, draws: StepDraws, batch: MarchedBatch | None = None):
    """Forward and backward of one step without the update: returns
    (grads in ``param_list`` order, per-ray loss (R,), the marched batch).
    ``batch`` is the step's march when it was already made."""
    R = draws.img_idx.shape[0]
    if batch is None:
        batch = march_batch(task, draws)
    target, bg, pixel_ok = targets(task, draws, batch.uv)
    with torch.enable_grad():
        out, valid = eval_samples(task, batch)
        composite = composite_train if task.use_kernels else composite_train_plain
        per_ray, dout = composite(
            out.detach().contiguous(), batch.ts, batch.dts, valid.contiguous(),
            target.contiguous(), bg.contiguous(), pixel_ok.contiguous(),
            task.state.grid.mean_density, task.training_near_distance,
            task.density_reg_scale * INV_LOSS_SCALE, float(np.float32(1.0) / np.float32(R)),
            task.loss_type, task.rgb_activation, task.density_activation)
        grads = torch.autograd.grad(out, task.model.param_list(), grad_outputs=dout)
    return list(grads), per_ray, batch


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
    task.opt.update(grads, task.optimizer_state(), task.model.param_list())
    if task.use_error_map:
        deposit_error(task, draws.img_idx, batch.uv, per_ray, draws.pdf)
    return {"loss": torch.mean(per_ray), "measured_samples": torch.sum(batch.n_valid)}


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
