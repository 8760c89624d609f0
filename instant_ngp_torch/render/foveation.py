"""Foveated rendering: piecewise-quadratic screen-space warps (port of
``instant_ngp_tpu/render/foveation.py``).

The reference's Foveation / FoveationPiecewiseQuadratic
(common_device.cuh:142-266): each screen axis gets a warp that is
linear (steepness `am` ≥ 1, i.e. full pixel density) in a window
around the focus point and quadratic (falling density) outside, so a
low-resolution render in warped space carries full detail where the
viewer looks. `warp` maps warped-space x → screen y; `unwarp` inverts;
`density` is dwarp/dx (the local resolution multiplier).

The constructor solves the same constrained fit as the reference
(C¹-continuous parabola-line-parabola through (0,0) and (1,1)), with
the identical 20-step bisection for the linear segment's placement.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class PiecewiseQuadratic:
    al: float = 0.0
    bl: float = 0.0
    cl: float = 0.0
    am: float = 1.0
    bm: float = 0.0
    ar: float = 0.0
    br: float = 0.0
    cr: float = 0.0
    switch_left: float = 0.0
    switch_right: float = 1.0
    inv_switch_left: float = 0.0
    inv_switch_right: float = 1.0

    @staticmethod
    def fit(center_pixel_steepness: float, center_y: float,
            center_radius: float) -> "PiecewiseQuadratic":
        self = PiecewiseQuadratic()
        am = center_pixel_steepness
        center_inverse_radius = center_radius * am
        left_sw = max(center_y - center_inverse_radius, 0.0)
        right_sw = min(center_y + center_inverse_radius, 1.0)
        d = (right_sw - left_sw) / am / 2.0

        m_min, m_max = 0.0, 1.0
        bm = 0.0
        for _ in range(20):
            m = (m_min + m_max) / 2.0
            l = m - d
            r = m + d
            bm = -((am - 1.0) * l * l) / (r * r - 2 * r + l * l + 1.0)
            l_actual = (left_sw - bm) / am
            r_actual = (right_sw - bm) / am
            if (l_actual + r_actual) / 2.0 > m:
                m_min = m
            else:
                m_max = m
        l = (left_sw - bm) / am
        r = (right_sw - bm) / am
        if (l == 0.0 and r == 1.0) or am == 1.0:
            return self  # fully linear
        den = r * r - 2 * r + l * l + 1.0
        self.switch_left, self.switch_right = l, r
        self.am = am
        self.al = (am - 1.0) / den
        self.bl = (am * (r * r - 2 * r + 1) + am * l * l + (2 - 2 * am) * l) / den
        self.cl = 0.0
        self.bm = bm = -((am - 1.0) * l * l) / den
        self.ar = -(am - 1.0) / den
        self.br = (am * (r * r + 1) - 2 * r + am * l * l) / den
        self.cr = -(am * r * r - r * r + (am - 1.0) * l * l) / den
        self.inv_switch_left = am * self.switch_left + bm
        self.inv_switch_right = am * self.switch_right + bm
        return self

    def warp(self, x):
        x = np.clip(np.asarray(x, np.float64), 0.0, 1.0)
        left = self.al * x * x + self.bl * x + self.cl
        mid = self.am * x + self.bm
        right = self.ar * x * x + self.br * x + self.cr
        return np.where(x < self.switch_left, left,
                        np.where(x > self.switch_right, right, mid))

    def unwarp(self, y):
        y = np.clip(np.asarray(y, np.float64), 0.0, 1.0)
        if self.al == 0.0 and self.ar == 0.0:
            return (y - self.bm) / self.am
        left = (np.sqrt(np.maximum(
            -4 * self.al * self.cl + 4 * self.al * y + self.bl**2, 0.0))
            - self.bl) / (2 * self.al + 1e-30)
        mid = (y - self.bm) / self.am
        right = (np.sqrt(np.maximum(
            -4 * self.ar * self.cr + 4 * self.ar * y + self.br**2, 0.0))
            - self.br) / (2 * self.ar + 1e-30)
        return np.where(y < self.inv_switch_left, left,
                        np.where(y > self.inv_switch_right, right, mid))

    def density(self, x):
        x = np.clip(np.asarray(x, np.float64), 0.0, 1.0)
        return np.where(
            x < self.switch_left, 2 * self.al * x + self.bl,
            np.where(x > self.switch_right, 2 * self.ar * x + self.br, self.am),
        )


@dataclasses.dataclass
class Foveation:
    warp_x: PiecewiseQuadratic
    warp_y: PiecewiseQuadratic

    @staticmethod
    def make(steepness=(2.0, 2.0), focus=(0.5, 0.5), radius=(0.2, 0.2)):
        return Foveation(
            PiecewiseQuadratic.fit(steepness[0], focus[0], radius[0]),
            PiecewiseQuadratic.fit(steepness[1], focus[1], radius[1]),
        )

    def warp(self, uv):
        uv = np.asarray(uv)
        return np.stack(
            [self.warp_x.warp(uv[..., 0]), self.warp_y.warp(uv[..., 1])], -1
        )

    def unwarp(self, uv):
        uv = np.asarray(uv)
        return np.stack(
            [self.warp_x.unwarp(uv[..., 0]), self.warp_y.unwarp(uv[..., 1])], -1
        )

    def density(self, uv):
        uv = np.asarray(uv)
        return self.warp_x.density(uv[..., 0]) * self.warp_y.density(uv[..., 1])


def render_foveated(task, width: int, height: int, camera_matrix, foveation: Foveation,
                    scale: float = 0.5, **render_kw) -> torch.Tensor:
    """Render at ``scale``× resolution in warped space and resample to full
    resolution (the reference renders into a warped buffer and the blit
    unwarps; render_buffer.cu's foveation path). Returns (H, W, 4) on the
    task's device; the focus region keeps about full pixel density.

    The low-resolution buffer's pixel at warped uv x shoots its ray at
    screen uv warp(x) (``NerfTask.render``'s ``uv_warp_fn``); screen pixel u
    reads the buffer bilinearly at unwarp(u), in f64 as the JAX package's
    numpy resample, then rounds to f32."""
    rw, rh = max(int(width * scale), 8), max(int(height * scale), 8)
    small = task.render(rw, rh, camera_matrix, uv_warp_fn=foveation.warp, **render_kw)
    ys_f, xs_f = np.meshgrid((np.arange(height) + 0.5) / height,
                             (np.arange(width) + 0.5) / width, indexing="ij")
    buf_uv = np.stack([foveation.warp_x.unwarp(xs_f), foveation.warp_y.unwarp(ys_f)], -1)
    px = np.clip(buf_uv[..., 0] * rw - 0.5, 0, rw - 1 - 1e-4)
    py = np.clip(buf_uv[..., 1] * rh - 0.5, 0, rh - 1 - 1e-4)
    x0, y0 = px.astype(np.int32), py.astype(np.int32)
    dev = small.device

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    fx, fy = t((px - x0)[..., None]), t((py - y0)[..., None])
    x1, y1 = t(np.minimum(x0 + 1, rw - 1)).long(), t(np.minimum(y0 + 1, rh - 1)).long()
    x0, y0 = t(x0).long(), t(y0).long()
    small = small.double()
    out = (small[y0, x0] * (1 - fx) * (1 - fy) + small[y0, x1] * fx * (1 - fy)
           + small[y1, x0] * (1 - fx) * fy + small[y1, x1] * fx * fy)
    return out.to(torch.float32)
