"""Occupancy-guided exponential ray marching (port of
``instant_ngp_tpu/nerf/sampler.py``).

Each ray walks from its start distance: an occupied step emits ``t`` into
the ray's next slot of a (R, K) bucket and advances by ``calc_dt``; an
empty step skips analytically to the next voxel of the largest empty
cascade (one skip-chain probe per step). A ray stops for good at its first
step outside the aabb, beyond MAX_DEPTH or with K samples emitted.

On CUDA tensors ``march_rays`` launches kernel C (``csrc/march.cu``, one
thread per ray); on CPU tensors it runs ``march_rays_plain``, which marches
all rays in lockstep as the JAX package does. Both give the same result: a
ray that stopped keeps its ``t`` and its count from then on.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from .. import cuda_lib
from ..common import MAX_DEPTH, NERF_CASCADES, fma
from ..ops.raymarch import (
    advance_n_steps,
    advance_to_next_voxel,
    calc_dt,
    mip_from_dt,
    ray_intersect_aabb,
    stepping,
)
from .occupancy import skip_at


@functools.lru_cache(maxsize=None)
def _stepping_c(cone_angle: float):
    """The stepping constants kernel C takes, as a host float array."""
    step = stepping(cone_angle).as_array()
    return (ctypes.c_float * len(step))(*step)


@dataclasses.dataclass(frozen=True)
class MarchConfig:
    n_march_iters: int = 192  # iterations per ray (occupied steps + skips)
    max_samples_per_ray: int = 48  # K: per-ray sample bucket
    cone_angle: float = 1.0 / 256.0
    min_mip: int = 0
    max_mip: int = 0  # max cascade index (set from dataset aabb_scale)
    dt_scale: float = 1.0


def _start(o, d, aabb_min, aabb_max, t_start_jitter, cfg, t_init):
    """t_init, else the aabb entry advanced by the jitter in stepping space."""
    if t_init is not None:
        return t_init
    tmin, _ = ray_intersect_aabb(o, d, aabb_min, aabb_max)
    return advance_n_steps(tmin, cfg.cone_angle, t_start_jitter)


def march_rays_plain(o, d, skipfield, aabb_min, aabb_max, t_start_jitter,
                     cfg: MarchConfig, t_init=None, stats: dict | None = None):
    """Lockstep march of all rays. Returns ts (R, K) (0 where invalid),
    dts (R, K), valid (R, K) bool, t_exit (R,), n_valid (R,) int32.
    ``stats``, when given, receives the iterations each ray ran (``iters``
    (R,)) and how often each chain value was read (``chain_counts``
    (NERF_CASCADES + 1,); positions outside the grid read 1)."""
    R = o.shape[0]
    K = cfg.max_samples_per_ray
    ca = cfg.cone_angle
    t = _start(o, d, aabb_min, aabb_max, t_start_jitter, cfg, t_init)
    idir = 1.0 / torch.where(torch.abs(d) < 1e-12,
                             torch.where(d >= 0, 1e-12, -1e-12).to(d.dtype), d)
    slot_iota = torch.arange(K, device=o.device)[None, :]
    n_emitted = torch.zeros((R,), dtype=torch.int32, device=o.device)
    ts = torch.zeros((R, K), dtype=torch.float32, device=o.device)
    if stats is not None:
        stats["iters"] = torch.zeros((R,), dtype=torch.int32, device=o.device)
        stats["chain_counts"] = torch.zeros((NERF_CASCADES + 1,), dtype=torch.int64,
                                            device=o.device)
    for _ in range(cfg.n_march_iters):
        pos = fma(t[:, None], d, o)
        inside = torch.all((pos >= aabb_min) & (pos <= aabb_max), dim=-1)
        ok = inside & (t < MAX_DEPTH) & (n_emitted < K)
        if not bool(ok.any()):
            break
        dt = calc_dt(t, ca) * cfg.dt_scale
        mip = torch.clamp(mip_from_dt(dt, pos, cfg.max_mip), cfg.min_mip, cfg.max_mip)
        chain = skip_at(skipfield, pos, mip)
        if stats is not None:
            stats["iters"] += ok.to(torch.int32)
            stats["chain_counts"] += torch.bincount(chain[ok].to(torch.int64),
                                                    minlength=NERF_CASCADES + 1)
        occ = chain == 0.0
        skip_mip = torch.clamp(mip + torch.clamp(chain - 1.0, min=0.0).to(torch.int32),
                               max=NERF_CASCADES - 1)
        emit = ok & occ
        write = emit[:, None] & (slot_iota == torch.clamp(n_emitted, 0, K - 1)[:, None])
        ts = torch.where(write, t[:, None], ts)
        t_next_skip = advance_to_next_voxel(t, ca, pos, d, idir, skip_mip)
        t = torch.where(ok, torch.where(occ, t + dt, t_next_skip), t)
        n_emitted = n_emitted + emit.to(torch.int32)
    valid = slot_iota < n_emitted[:, None]
    ts = torch.where(valid, ts, 0.0)
    dts = torch.where(valid, calc_dt(ts, ca) * cfg.dt_scale, 0.0)
    return ts, dts, valid, t, n_emitted


def march_rays(o, d, skipfield, aabb_min, aabb_max, t_start_jitter,
               cfg: MarchConfig, t_init=None):
    """March rays through the occupancy grid (see ``march_rays_plain``).
    o, d: (R, 3) origins and normalized directions; skipfield:
    (NERF_CASCADES, G, G, G) f32 skip chain; aabb_min/max: (3,) f32 tensors
    on the rays' device; t_start_jitter: (R,) in [0, 1) stepping-space
    start offset, unless t_init (R,) gives the start distances. CPU tensors
    run the plain version; CUDA tensors launch kernel C, which computes the
    start from the jitter itself."""
    if o.device.type == "cpu":
        return march_rays_plain(o, d, skipfield, aabb_min, aabb_max, t_start_jitter, cfg, t_init)
    from_jitter = t_init is None
    t0 = (t_start_jitter if from_jitter else t_init).to(torch.float32).contiguous()
    o, d = o.contiguous(), d.contiguous()
    cuda_lib.check_cuda(o, d, t0, skipfield, aabb_min, aabb_max, dtype=torch.float32)
    R, K = o.shape[0], cfg.max_samples_per_ray
    ts = torch.empty((R, K), dtype=torch.float32, device=o.device)
    dts = torch.empty_like(ts)
    valid = torch.empty((R, K), dtype=torch.bool, device=o.device)
    t_exit = torch.empty((R,), dtype=torch.float32, device=o.device)
    n_valid = torch.empty((R,), dtype=torch.int32, device=o.device)
    if R > 0:
        cuda_lib.launch("march_rays", o.data_ptr(), d.data_ptr(), t0.data_ptr(),
                        skipfield.data_ptr(), aabb_min.data_ptr(), aabb_max.data_ptr(),
                        ctypes.addressof(_stepping_c(cfg.cone_angle)), R, K, cfg.n_march_iters,
                        cfg.min_mip, cfg.max_mip, cfg.dt_scale, int(from_jitter),
                        ts.data_ptr(), dts.data_ptr(), valid.data_ptr(), t_exit.data_ptr(),
                        n_valid.data_ptr())
    return ts, dts, valid, t_exit, n_valid
