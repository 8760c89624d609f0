"""Render buffer: progressive accumulation and tonemapping (port of
``instant_ngp_tpu/render/buffer.py``; reference CudaRenderBuffer,
render_buffer.h:162-317, render_buffer.cu).

``tonemap`` takes and returns a tensor (on the card for a frame the card
rendered). ``RenderBuffer`` accumulates host frames in numpy, as the JAX
package's does; ``tonemapped`` hands back a numpy frame.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..common import ColorSpace, TonemapCurve, linear_to_srgb


def tonemap(x: torch.Tensor, curve: TonemapCurve) -> torch.Tensor:
    """Filmic curves (reference render_buffer.cu tonemap kernels)."""
    x = torch.clamp(x, min=0.0)
    if curve == TonemapCurve.IDENTITY:
        return x
    if curve == TonemapCurve.REINHARD:
        return x / (1.0 + x)
    if curve == TonemapCurve.HABLE:
        A, B, C, D, E, F = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30

        def h(v):
            return ((v * (A * v + C * B) + D * E) / (v * (A * v + B) + D * F)) - E / F
        W = 11.2
        return h(x) / h(torch.full_like(x, W))
    if curve == TonemapCurve.ACES:
        a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
        return torch.clamp((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)
    raise ValueError(curve)


@dataclasses.dataclass
class RenderBuffer:
    """Progressive accumulation buffer (the spp accumulation of
    CudaRenderBuffer::accumulate)."""

    width: int
    height: int
    spp: int = 0
    accum: np.ndarray = None  # (H, W, 4) float32 linear
    depth: np.ndarray = None

    def __post_init__(self):
        if self.accum is None:
            self.reset()

    def reset(self) -> None:
        self.accum = np.zeros((self.height, self.width, 4), np.float32)
        self.depth = np.zeros((self.height, self.width), np.float32)
        self.spp = 0

    def accumulate(self, frame: np.ndarray, depth: np.ndarray | None = None) -> None:
        w_new = 1.0 / (self.spp + 1)
        self.accum = self.accum * (1.0 - w_new) + np.asarray(frame, np.float32) * w_new
        if depth is not None:
            self.depth = self.depth * (1.0 - w_new) + np.asarray(depth, np.float32) * w_new
        self.spp += 1

    def tonemapped(self, exposure: float = 0.0, curve: TonemapCurve = TonemapCurve.IDENTITY,
                   color_space: ColorSpace = ColorSpace.SRGB,
                   background: np.ndarray | None = None) -> np.ndarray:
        rgb = torch.from_numpy(self.accum[..., :3]) * (2.0 ** exposure)
        alpha = self.accum[..., 3:4]
        if background is not None:
            bg = torch.from_numpy(np.asarray(background, np.float32)[..., :3])
            rgb = rgb + bg * torch.from_numpy(1.0 - alpha)
        rgb = tonemap(rgb, curve)
        if color_space == ColorSpace.SRGB:
            rgb = linear_to_srgb(torch.clamp(rgb, 0.0, 1.0))
        return np.concatenate([rgb.numpy(), alpha], -1)


class DynamicResolution:
    """Render-resolution controller driven by the frame time's EMA
    (reference dynamic res, testbed.cu:3299-3395: clamped to [1/16, 1],
    hysteresis 0.8-1.2 around the target frame time)."""

    def __init__(self, target_fps: float = 20.0, half_life: float = 10.0):
        self.target_ms = 1000.0 / target_fps
        self.factor = 1.0 / 16.0
        self.alpha = 0.5 ** (1.0 / half_life)
        self.ema_ms = None

    def update(self, frame_ms: float) -> float:
        self.ema_ms = (frame_ms if self.ema_ms is None
                       else self.alpha * self.ema_ms + (1 - self.alpha) * frame_ms)
        ratio = self.ema_ms / self.target_ms
        if ratio > 1.2:
            self.factor = max(self.factor / np.sqrt(ratio), 1.0 / 16.0)
        elif ratio < 0.8:
            self.factor = min(self.factor * np.sqrt(1.0 / max(ratio, 1e-3)), 1.0)
        return self.factor
