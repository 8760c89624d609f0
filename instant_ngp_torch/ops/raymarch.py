"""Exponential-stepping ray-march math (port of
``instant_ngp_tpu/ops/raymarch.py``; reference nerf_device.cuh:360-459).

The stepping-space warp (linear/log/linear in t), cone-angle dt, the DDA
distance to the next voxel, mip selection from float exponents and the
occupancy-skip advance, as elementwise torch on f32. The same math, in
the same operation order, runs per ray as ``__device__`` functions in
kernel C (``csrc/march.cu``).

The arithmetic is that of the reference as it is compiled, where step
decisions depend on the last bit: a division by a constant is a multiply
by its f32 reciprocal, ``(x - c) * k + c'`` is one fused multiply-add, and
with a zero cone angle the compiler also fuses the multiply-adds marked
below. The constants of a cone angle are computed once on the host in f32
(``stepping``) and shared with kernel C.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..common import MAX_CONE_STEPSIZE, MIN_CONE_STEPSIZE, NERF_GRIDSIZE, fma

_f32 = torch.float32
MIN_STEP = float(np.float32(MIN_CONE_STEPSIZE))
MAX_STEP = float(np.float32(MAX_CONE_STEPSIZE))
INV_MIN_STEP = float(np.float32(1.0) / np.float32(MIN_CONE_STEPSIZE))
INV_MAX_STEP = float(np.float32(1.0) / np.float32(MAX_CONE_STEPSIZE))


@dataclasses.dataclass(frozen=True)
class Stepping:
    """f32 constants of the stepping-space warp for one cone angle: below
    ``at`` steps are MIN_STEP, above ``bt`` MAX_STEP, in between they grow
    by the factor 1 + cone_angle (a, b: the stepping-space positions of at
    and bt)."""

    uniform: bool
    log1p_c: float
    inv_log1p_c: float
    a: float
    b: float
    at: float
    bt: float

    def as_array(self) -> list[float]:
        """The values kernel C takes, in its order."""
        return [float(self.uniform), self.log1p_c, self.inv_log1p_c, self.a, self.b, self.at,
                self.bt, MIN_STEP, INV_MIN_STEP, MAX_STEP, INV_MAX_STEP]


def stepping(cone_angle: float) -> Stepping:
    f32 = np.float32
    log1p_c = np.log1p(np.maximum(f32(cone_angle), f32(1e-10)))
    a = (np.log(f32(MIN_CONE_STEPSIZE)) - np.log(log1p_c)) / log1p_c
    b = (np.log(f32(MAX_CONE_STEPSIZE)) - np.log(log1p_c)) / log1p_c
    return Stepping(
        uniform=cone_angle <= 1e-5, log1p_c=float(log1p_c),
        inv_log1p_c=float(f32(1.0) / log1p_c), a=float(a), b=float(b),
        at=float(np.exp(f32(a) * log1p_c)), bt=float(np.exp(f32(b) * log1p_c)))


def to_stepping_space(t: torch.Tensor, cone_angle: float) -> torch.Tensor:
    """nerf_device.cuh:378-399. cone_angle may be 0 (uniform steps)."""
    t = torch.as_tensor(t, dtype=_f32)
    s = stepping(cone_angle)
    if s.uniform:
        return t * INV_MIN_STEP
    return torch.where(
        t <= s.at,
        fma(t - s.at, INV_MIN_STEP, s.a),
        torch.where(t <= s.bt, torch.log(torch.clamp(t, min=1e-30)) * s.inv_log1p_c,
                    fma(t - s.bt, INV_MAX_STEP, s.b)),
    )


def from_stepping_space(n: torch.Tensor, cone_angle: float) -> torch.Tensor:
    """nerf_device.cuh:401-422 (inverse of the above)."""
    n = torch.as_tensor(n, dtype=_f32)
    s = stepping(cone_angle)
    if s.uniform:
        return n * MIN_STEP
    return torch.where(
        n <= s.a,
        fma(n - s.a, MIN_STEP, s.at),
        torch.where(n <= s.b, torch.exp(n * s.log1p_c), fma(n - s.b, MAX_STEP, s.bt)),
    )


def advance_n_steps(t, cone_angle: float, n) -> torch.Tensor:
    if stepping(cone_angle).uniform:  # (t·inv + n)·MIN, the add fused
        return fma(t, INV_MIN_STEP, n) * MIN_STEP
    return from_stepping_space(to_stepping_space(t, cone_angle) + n, cone_angle)


def calc_dt(t, cone_angle: float) -> torch.Tensor:
    if stepping(cone_angle).uniform:  # (t·inv + 1)·MIN − t, both fused
        return fma(fma(t, INV_MIN_STEP, 1.0), MIN_STEP, -t)
    return advance_n_steps(t, cone_angle, 1.0) - t


def distance_to_next_voxel(pos, dir, idir, res) -> torch.Tensor:  # noqa: A002
    """DDA step distance (nerf_device.cuh:360-368). pos, dir, idir:
    (..., 3); res: scalar or (...) voxels across [0, 1]. Axis-parallel
    components never bound the step."""
    res = torch.as_tensor(res, dtype=_f32, device=pos.device)
    res_b = res[..., None] if res.ndim else res
    p = res_b * (pos - 0.5)
    t_ax = (torch.floor(p + 0.5 + 0.5 * torch.sign(dir)) - p) * idir
    t_ax = torch.where(torch.abs(dir) < 1e-10, torch.inf, t_ax)
    t = torch.amin(t_ax, dim=-1)
    return torch.clamp(t / res, min=0.0)


def advance_to_next_voxel(t, cone_angle: float, pos, dir, idir, mip) -> torch.Tensor:  # noqa: A002
    """nerf_device.cuh:429-440: skip forward in stepping space (ceil of
    the stepping-space distance, at least half a step)."""
    res = NERF_GRIDSIZE * torch.exp2(-mip.to(_f32))
    t_target = t + distance_to_next_voxel(pos, dir, idir, res)
    s = to_stepping_space(t, cone_angle)
    if stepping(cone_angle).uniform:  # t_target·inv − s, fused
        ds = fma(t_target, INV_MIN_STEP, -s)
    else:
        ds = to_stepping_space(t_target, cone_angle) - s
    return from_stepping_space(s + torch.ceil(torch.clamp(ds, min=0.5)), cone_angle)


def mip_from_pos(pos, max_cascade: int) -> torch.Tensor:
    """nerf_device.cuh:442-447: smallest cascade containing pos."""
    maxval = torch.amax(torch.abs(pos - 0.5), dim=-1)
    _, exponent = torch.frexp(torch.clamp(maxval, min=1e-30))
    return torch.clamp(exponent + 1, 0, max_cascade).to(torch.int32)


def mip_from_dt(dt, pos, max_cascade: int) -> torch.Tensor:
    """nerf_device.cuh:449-459: at least the cascade whose cells are
    bigger than the local step size."""
    mip = mip_from_pos(pos, max_cascade)
    dt_scaled = dt * (2 * NERF_GRIDSIZE)
    _, exponent = torch.frexp(torch.clamp(dt_scaled, min=1e-30))
    return torch.where(dt_scaled < 1.0, mip,
                       torch.clamp(torch.maximum(mip, exponent), 0, max_cascade)).to(torch.int32)


def ray_intersect_aabb(o, d, aabb_min, aabb_max):
    """Slab test → (tmin, tmax) with tmin ≥ 0. o, d: (..., 3)."""
    idir = 1.0 / torch.where(torch.abs(d) < 1e-12,
                             torch.where(d >= 0, 1e-12, -1e-12).to(d.dtype), d)
    t0 = (aabb_min - o) * idir
    t1 = (aabb_max - o) * idir
    tmin = torch.amax(torch.minimum(t0, t1), dim=-1)
    tmax = torch.amin(torch.maximum(t0, t1), dim=-1)
    return torch.clamp(tmin, min=0.0), tmax
