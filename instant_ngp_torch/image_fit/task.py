"""Neural image primitive: 2-D coordinate → RGB regression (port of
``instant_ngp_tpu/image_fit/task.py``; the reference's image mode,
testbed_image.cu).

  * training positions uniform, stratified, Halton or Sobol in [0, 1]²
    (testbed_image.cu:39-82); the draws (uv) are an argument of the step,
    so that tests can hand both packages the same positions
  * targets are bilinear texture reads, converted linear → sRGB unless
    ``linear_colors`` (eval_image_kernel_and_snap, :177-229)
  * L2 loss on 3 output dims, Adam with l2_reg on the MLP matrices
  * ``compute_mse`` over every pixel centre, optionally byte-quantized
    (:490-547); ``render`` per-pixel inference, optionally with ground-truth
    tiles in a checkerboard (render_image, :304-391)

The texture is one (H·W, 4) f32 tensor on the device, stored linear. Its
bilinear reads (training targets, ``compute_mse``) are
``ops.gather.bilinear_read``, one launch of kernel I's bilinear entry on the
card, equal bit for bit to the jitted JAX read (``bilinear_read_plain``
mirrors XLA's FMAs). Its nearest-texel reads (``snapped_read``, the
ground-truth tiles) are row gathers through ``ops.gather.take_rows``, kernel
I on the card. A training step makes no host sync; ``train`` reads the last
step's loss once per call.

Halton and Sobol sequences work on uint32 in the JAX package; here they are
emulated in int64 with masks.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.func import functional_call

from ..common import RandomMode, linear_to_srgb, srgb_to_linear
from ..models.factory import autoconfig_grid_encoding
from ..models.network import NetworkTask
from ..ops.gather import bilinear_read, take_rows, texel_index

_MASK32 = 0xFFFFFFFF
# pixels per inference pass of render and compute_mse (the JAX package's)
CHUNK = 1 << 17


def snapped_read(texture: torch.Tensor, resolution: tuple[int, int],
                 uv: torch.Tensor) -> torch.Tensor:
    """The texel under uv (nearest, no filtering): one row gather."""
    w, h = resolution
    x = torch.clamp(torch.floor(uv[:, 0] * w).to(torch.int64), 0, w - 1)
    y = torch.clamp(torch.floor(uv[:, 1] * h).to(torch.int64), 0, h - 1)
    return take_rows(texture, texel_index(x, y, w))


def halton(index: torch.Tensor, base: int) -> torch.Tensor:
    """Halton sequence of uint32 indices (held in int64), f32 (reference
    halton23_kernel): 32 digits for bases 2 and 3."""
    i = index.to(torch.int64) & _MASK32
    result = torch.zeros(i.shape, dtype=torch.float32, device=i.device)
    f = torch.full(i.shape, 1.0 / base, dtype=torch.float32, device=i.device)
    for _ in range(32 // max(1, int(np.log2(base)))):
        result = result + f * (i % base).to(torch.float32)
        i = i // base
        f = f / base
    return result


def _sobol_dirs() -> list[int]:
    """Direction numbers of Sobol dimension 1: m_k = m_{k-1} ⊕ 2·m_{k-1}
    (1, 3, 5, 15, 17, …), shifted to the top bits."""
    m = [1]
    for k in range(1, 32):
        m.append(m[k - 1] ^ (2 * m[k - 1]))
    return [(m[k] << (31 - k)) & _MASK32 for k in range(32)]


def sobol2d(index: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The first two Sobol dimensions of uint32 indices (held in int64):
    dim 0 the bit-reversed index (van der Corput), dim 1 the classic
    dimension-2 direction numbers in natural digit order."""
    v = index.to(torch.int64) & _MASK32
    v = ((v >> 1) & 0x55555555) | ((v & 0x55555555) << 1)
    v = ((v >> 2) & 0x33333333) | ((v & 0x33333333) << 2)
    v = ((v >> 4) & 0x0F0F0F0F) | ((v & 0x0F0F0F0F) << 4)
    v = ((v >> 8) & 0x00FF00FF) | ((v & 0x00FF00FF) << 8)
    v = ((v >> 16) | (v << 16)) & _MASK32
    scale = float(np.float32(2.0**-32))
    x0 = v.to(torch.float32) * scale
    i = index.to(torch.int64) & _MASK32
    acc = torch.zeros_like(i)
    for k, d in enumerate(_sobol_dirs()):
        acc = acc ^ (((i >> k) & 1) * d)
    return x0, acc.to(torch.float32) * scale


class ImageTask(NetworkTask):
    """A neural image: the texture, the model, the optimizer and its state,
    the step, ``render`` and ``compute_mse``. The constructor follows the
    JAX package's (task.py:120-169)."""

    def __init__(self, image: np.ndarray, is_hdr: bool, config: dict, device="cuda",
                 seed: int = 1337, batch_size: int = 1 << 18, random_mode: str = "stratified",
                 linear_colors: bool = False, snap_to_pixel_centers: bool = False):
        self.device = torch.device(device)
        self.resolution = (int(image.shape[1]), int(image.shape[0]))  # (W, H)
        self.is_hdr = is_hdr
        self.linear_colors = linear_colors
        # kept for the pyngp surface; the JAX package reads it nowhere
        self.snap_to_pixel_centers = snap_to_pixel_centers
        self.random_mode = RandomMode(random_mode).value
        self.batch_size = batch_size
        self.config = dict(config)
        self.config["encoding"] = autoconfig_grid_encoding(
            self.config.get("encoding", {}), "image", image_resolution=self.resolution)
        w, h = self.resolution
        # a copy of the image, never a view of the caller's array
        tex = torch.tensor(np.asarray(image, np.float32).reshape(w * h, -1), device=self.device)
        if not is_hdr:
            # LDR files are sRGB-encoded; the texture is stored linear
            tex[:, :3] = srgb_to_linear(tex[:, :3])
        self.texture = tex
        self._init_network(self.config, 2, 3, seed, "L2")
        self.generator = torch.Generator(device=self.device).manual_seed(seed ^ 0x5EED)

    def set_use_kernels(self, flag: bool) -> None:
        """True (default): the model runs kernels A, B, E and F on CUDA
        tensors. False: their plain versions, the reference a kernel run is
        checked against on the card. Texture reads always go through
        kernel I (``bilinear_read``, ``take_rows``), which equals its plain
        versions bit for bit either way."""
        self.model.set_use_kernels(flag)

    # --- training ---
    def draw_uniforms(self) -> Optional[torch.Tensor]:
        """The step's random draws: (batch, 2) uniforms in the random and
        stratified modes, None in the deterministic Halton and Sobol modes."""
        if self.random_mode in ("halton", "sobol"):
            return None
        return torch.rand((self.batch_size, 2), generator=self.generator, device=self.device)

    def sample_positions(self, u: Optional[torch.Tensor], step: int) -> torch.Tensor:
        """Training positions (batch, 2) of step ``step`` from the draws u
        (``draw_uniforms``); JAX ``_sample_positions``."""
        n = self.batch_size
        if self.random_mode in ("halton", "sobol"):
            idx = (torch.arange(n, device=self.device) + ((n * step) & _MASK32)) & _MASK32
            if self.random_mode == "halton":
                return torch.stack([halton(idx, 2), halton(idx, 3)], dim=-1)
            return torch.stack(sobol2d(idx), dim=-1)
        uv = u
        if self.random_mode == "stratified" and (n & (n - 1)) == 0 and (n.bit_length() - 1) % 2 == 0:
            log2s = (n.bit_length() - 1) // 2
            size = 1 << log2s
            i = torch.arange(n, device=self.device)
            xy = torch.stack([(i & (size - 1)).to(torch.float32),
                              (i >> log2s).to(torch.float32)], dim=-1)
            uv = uv / size + xy / size
        return uv

    def targets_at(self, uv: torch.Tensor) -> torch.Tensor:
        val = bilinear_read(self.texture, self.resolution, uv)[:, :3]
        return val if self.linear_colors else linear_to_srgb(val)

    def step_gradients(self, uv: torch.Tensor) -> tuple[list[torch.Tensor], torch.Tensor]:
        """Forward and backward of one step at positions uv, without the
        update: (grads in ``param_list`` order, the mean loss)."""
        target = self.targets_at(uv)
        with torch.enable_grad():
            pred = self.model(uv).to(torch.float32)
            loss = torch.mean(self.loss(target, pred))
            grads = torch.autograd.grad(loss, self.model.param_list())
        return list(grads), loss.detach()

    def train(self, n_steps: int = 1) -> float:
        """n steps; returns the last step's loss (the one host read)."""
        loss = None
        for _ in range(n_steps):
            uv = self.sample_positions(self.draw_uniforms(), self.training_step)
            loss = self.train_step(uv)
            self.training_step += 1
        return float(loss) if loss is not None else 0.0

    # --- inference / evaluation ---

    def _pixel_centers(self, start: int, stop: int, width: int, height: int) -> torch.Tensor:
        i = torch.arange(start, stop, device=self.device)
        xs, ys = i % width, i // width
        return torch.stack([(xs + 0.5) / width, (ys + 0.5) / height], dim=-1).to(torch.float32)

    @torch.no_grad()
    def render(self, width: Optional[int] = None, height: Optional[int] = None,
               gt_checkerboard: bool = False, checker_px: int = 64) -> torch.Tensor:
        """Per-pixel inference → (H, W, 3) f32 in the training colour space
        (sRGB unless ``linear_colors``). gt_checkerboard: ground-truth
        tiles (the nearest texel, computed as the JAX package does in f64)
        alternate with the prediction."""
        w = width or self.resolution[0]
        h = height or self.resolution[1]
        params = self.inference_params()
        out = torch.cat([
            functional_call(self.model, params, (self._pixel_centers(i, min(i + CHUNK, w * h), w, h),))
            for i in range(0, w * h, CHUNK)]).to(torch.float32).reshape(h, w, 3)
        if not gt_checkerboard:
            return out
        gt = take_rows(self.texture, self.gt_texels(w, h))[:, :3]
        if not self.is_hdr and not self.linear_colors:
            gt = linear_to_srgb(torch.clamp(gt, 0.0, 1.0))
        ys = torch.arange(h, device=self.device)[:, None]
        xs = torch.arange(w, device=self.device)[None, :]
        tiles = ((xs // checker_px) + (ys // checker_px)) % 2 == 0
        return torch.where(tiles[..., None], out, gt.reshape(h, w, 3))

    def gt_texels(self, width: int, height: int) -> torch.Tensor:
        """The texture rows of a width×height render's ground-truth tiles:
        the nearest texel of each pixel centre, computed as the JAX package
        does in f64; (height·width,) int32, row-major."""
        iw, ih = self.resolution
        f64 = torch.float64
        xs = torch.arange(width, device=self.device, dtype=f64)
        ys = torch.arange(height, device=self.device, dtype=f64)
        px = torch.clamp(torch.div((xs + 0.5) * iw, width, rounding_mode="floor"), 0, iw - 1)
        py = torch.clamp(torch.div((ys + 0.5) * ih, height, rounding_mode="floor"), 0, ih - 1)
        return texel_index(px.to(torch.int64)[None, :], py.to(torch.int64)[:, None],
                           iw).reshape(-1)

    @torch.no_grad()
    def compute_mse(self, quantize_to_byte: bool = False) -> float:
        """Reference compute_image_mse (testbed_image.cu:490-547): the
        targets at every pixel centre against the predictions, summed per
        chunk in f32 and over chunks in f64 on the device; one host read."""
        w, h = self.resolution
        params = self.inference_params()
        total = torch.zeros((), dtype=torch.float64, device=self.device)
        for i in range(0, w * h, CHUNK):
            uv = self._pixel_centers(i, min(i + CHUNK, w * h), w, h)
            target = self.targets_at(uv)
            pred = functional_call(self.model, params, (uv,)).to(torch.float32)
            if quantize_to_byte:
                pred = torch.floor(torch.clamp(pred, 0.0, 1.0) * 255.0 + 0.5) / 255.0
            total += torch.sum((pred - target) ** 2).to(torch.float64)
        return float(total) / (w * h * 3)
