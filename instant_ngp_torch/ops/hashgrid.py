"""Multiresolution (hash-)grid encoding, forward (port of
``instant_ngp_tpu/ops/hashgrid.py``).

  * level scale:      s_l = 2^(l·log2(b)) · N_base − 1
  * level resolution: R_l = ceil(s_l) + 1
  * dense index while R_l^D ≤ table size, else spatial hash
    h(x) = (x₀·1 ⊻ x₁·2654435761 ⊻ x₂·805459861) mod T
  * d-linear interpolation of 2^D corners; "simplex" interpolates the 4
    corners of the Freudenthal tetrahedron on hashed 3-D levels; "nearest"
    reads one corner
  * per-level sizes aligned to multiples of 8; ``max_level`` masking

The per-level tables live in one flat (n_entries, F) f32 parameter, level
l at rows [offset_l, offset_l + size_l), the tcnn layout. On CUDA tensors
``hashgrid_encode`` launches kernel A (``csrc/hashgrid.cu``); on CPU
tensors it runs ``hashgrid_encode_plain``. The backward comes with the
training slice.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from .. import cuda_lib
from ..common import fma

# Spatial-hash primes (tiny-cuda-nn convention; the first dim uses 1 so
# that dense and hashed indices coincide along x).
_PRIMES = (1, 2654435761, 805459861, 3674653429, 2097192037, 1434869437, 2165219737)
_MASK32 = 0xFFFFFFFF
INTERPOLATIONS = {"linear": 0, "nearest": 1, "simplex": 2}


@dataclasses.dataclass(frozen=True)
class GridLevelSpec:
    scale: float
    resolution: int
    size: int  # number of feature vectors in this level's table
    offset: int  # offset (in feature vectors) into the packed flat table
    hashed: bool


def _next_multiple(v: int, m: int) -> int:
    return ((v + m - 1) // m) * m


def grid_levels(n_dims: int, n_levels: int, log2_hashmap_size: int, base_resolution: int,
                per_level_scale: float, grid_type: str = "hash") -> tuple[GridLevelSpec, ...]:
    log2_b = math.log2(per_level_scale) if n_levels > 1 else 0.0
    out = []
    offset = 0
    max_params = 2**31
    for level in range(n_levels):
        scale = 2.0 ** (level * log2_b) * base_resolution - 1.0
        res = int(math.ceil(scale)) + 1
        dense_size = res**n_dims if float(res) ** n_dims <= max_params else max_params
        size = _next_multiple(min(dense_size, max_params), 8)
        if grid_type == "tiled":
            size = min(size, base_resolution**n_dims)
        elif grid_type == "hash":
            size = min(size, 1 << log2_hashmap_size)
        hashed = grid_type == "hash" and (res**n_dims) > size
        out.append(GridLevelSpec(scale, res, size, offset, hashed))
        offset += size
    return tuple(out)


# ---------------------------------------------------------------------------
# plain version (CPU, and the reference the kernel is checked against)
# ---------------------------------------------------------------------------


def _corner_index(level: GridLevelSpec, grid: torch.Tensor, bits) -> torch.Tensor:
    """LOCAL table index (N,) int64 of one corner. grid (N, D) int64; bits:
    D ints or (N,) int tensors in {0, 1}. uint32 arithmetic is emulated in
    int64 with a mask after each multiply (torch has no uint32 multiply on
    the CPU); products wrap mod 2^64, which keeps the low 32 bits exact."""
    idx = torch.zeros_like(grid[:, 0])
    if level.hashed:
        for d in range(grid.shape[1]):
            c = (grid[:, d] + bits[d]) & _MASK32
            idx = idx ^ ((c * _PRIMES[d]) & _MASK32)
    else:
        stride = 1
        for d in range(grid.shape[1]):
            c = (grid[:, d] + bits[d]) & _MASK32
            idx = (idx + ((c * (stride & _MASK32)) & _MASK32)) & _MASK32
            stride *= level.resolution
    return idx % level.size


def _level_corners(level: GridLevelSpec, interpolation: str, x: torch.Tensor):
    """(idx (C, N) local int64, w (C, N) f32) for one level."""
    pos = fma(x, float(np.float32(level.scale)), 0.5)
    floor = torch.floor(pos)
    frac = pos - floor
    grid = floor.to(torch.int64)
    n_dims = x.shape[1]
    if interpolation == "nearest":
        t = torch.round(frac)  # half to even, as jnp.round
        bits = [t[:, d].to(torch.int64) for d in range(n_dims)]
        return _corner_index(level, grid, bits)[None], torch.ones_like(t[None, :, 0])
    if interpolation == "simplex" and level.hashed and n_dims == 3:
        t = frac
        amax = torch.argmax(t, dim=-1)  # first index on ties
        amin = torch.argmin(t, dim=-1)
        amin = torch.where(amin == amax, (amax + 1) % 3, amin)
        eye = torch.eye(3, dtype=torch.int64, device=x.device)
        b_max, b_min = eye[amax], eye[amin]
        corners = (torch.zeros_like(b_max), b_max, 1 - b_min, torch.ones_like(b_max))
        idx = torch.stack([_corner_index(level, grid, [b[:, d] for d in range(3)])
                           for b in corners])
        t_max = torch.amax(t, dim=-1)
        t_min = torch.amin(t, dim=-1)
        t_mid = torch.sum(t, dim=-1) - t_max - t_min
        return idx, torch.stack([1.0 - t_max, t_max - t_mid, t_mid - t_min, t_min])
    if interpolation not in ("linear", "simplex"):
        raise NotImplementedError(f"interpolation {interpolation!r} is not ported yet")
    t = frac
    idx_c, w_c = [], []
    for c in range(1 << n_dims):
        bits = [(c >> d) & 1 for d in range(n_dims)]
        idx_c.append(_corner_index(level, grid, bits))
        w = None
        for d in range(n_dims):
            wd = t[:, d] if bits[d] else (1.0 - t[:, d])
            w = wd if w is None else w * wd
        w_c.append(w)
    return torch.stack(idx_c), torch.stack(w_c)


def hashgrid_encode_plain(levels, interpolation: str, table: torch.Tensor,
                          x: torch.Tensor) -> torch.Tensor:
    """Encode x (N, D) in [0, 1] → (N, L·F) f32, level-major."""
    outs = []
    for level in levels:
        idx, w = _level_corners(level, interpolation, x)
        feats = table[level.offset + idx]  # (C, N, F)
        outs.append(torch.sum(w[:, :, None] * feats, dim=0))
    return torch.cat(outs, dim=-1)


# ---------------------------------------------------------------------------
# wrapper: kernel A on CUDA tensors
# ---------------------------------------------------------------------------


def hashgrid_encode(levels, interpolation: str, table: torch.Tensor,
                    x: torch.Tensor) -> torch.Tensor:
    """Encode x (N, 3) f32 with the flat table (n_entries, F) f32. CPU
    tensors run the plain version; CUDA tensors launch kernel A."""
    if x.device.type == "cpu":
        return hashgrid_encode_plain(levels, interpolation, table, x)
    cuda_lib.check_cuda(x, table, dtype=torch.float32)
    n, n_dims = x.shape
    n_features = table.shape[1]
    if n_dims != 3 or n_features not in (1, 2, 4, 8) or len(levels) > 32:
        raise ValueError(f"kernel A takes D=3, F in (1,2,4,8), ≤32 levels; got "
                         f"D={n_dims}, F={n_features}, L={len(levels)}")
    if interpolation not in INTERPOLATIONS:
        raise NotImplementedError(f"interpolation {interpolation!r} is not ported yet")
    L = len(levels)
    scale = (ctypes.c_float * L)(*[np.float32(lv.scale) for lv in levels])
    res = (ctypes.c_int * L)(*[lv.resolution for lv in levels])
    size = (ctypes.c_int * L)(*[lv.size for lv in levels])
    offset = (ctypes.c_int * L)(*[lv.offset for lv in levels])
    hashed = (ctypes.c_int * L)(*[int(lv.hashed) for lv in levels])
    out = torch.empty((n, L * n_features), dtype=torch.float32, device=x.device)
    if n > 0:
        cuda_lib.launch("hashgrid_encode_fwd", x.data_ptr(), table.data_ptr(),
                        ctypes.addressof(scale), ctypes.addressof(res), ctypes.addressof(size),
                        ctypes.addressof(offset), ctypes.addressof(hashed), L, n_features,
                        INTERPOLATIONS[interpolation], n, out.data_ptr())
    return out


class GridEncoding(nn.Module):
    """Multiresolution grid encoding of positions in [0, 1]^D.

    ``table`` is the flat (n_entries, F) f32 parameter; ``unpack_params``
    gives the per-level views the JAX package keeps as separate leaves."""

    def __init__(self, n_dims: int = 3, n_levels: int = 16, n_features_per_level: int = 2,
                 log2_hashmap_size: int = 19, base_resolution: int = 16,
                 per_level_scale: float = 2.0, interpolation: str = "linear",
                 grid_type: str = "hash", device=None):
        super().__init__()
        self.n_dims = n_dims
        self.n_levels = n_levels
        self.n_features_per_level = n_features_per_level
        self.log2_hashmap_size = log2_hashmap_size
        self.base_resolution = base_resolution
        self.per_level_scale = per_level_scale
        self.interpolation = interpolation
        self.grid_type = grid_type
        self.levels = grid_levels(n_dims, n_levels, log2_hashmap_size, base_resolution,
                                  per_level_scale, grid_type)
        self.use_kernel = True
        self.table = nn.Parameter(torch.zeros((self.n_entries, n_features_per_level),
                                              dtype=torch.float32, device=device),
                                  requires_grad=False)

    @property
    def n_dims_to_encode(self) -> int:
        return self.n_dims

    @property
    def n_entries(self) -> int:
        return self.levels[-1].offset + self.levels[-1].size

    @property
    def n_output_dims(self) -> int:
        return self.n_levels * self.n_features_per_level

    def unpack_params(self, flat=None) -> tuple:
        """Per-level (size_l, F) views of the flat table."""
        flat = self.table if flat is None else flat
        return tuple(flat[lv.offset: lv.offset + lv.size] for lv in self.levels)

    def forward(self, x: torch.Tensor, max_level: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (N, D) in [0, 1] → (N, L·F) f32. max_level: optional scalar or
        (N,) in [0, 1]; levels l ≥ max_level·L contribute zero."""
        encode = hashgrid_encode if self.use_kernel else hashgrid_encode_plain
        out = encode(self.levels, self.interpolation, self.table, x.contiguous())
        if max_level is not None:
            L, F = self.n_levels, self.n_features_per_level
            max_level = torch.as_tensor(max_level, dtype=torch.float32, device=out.device)
            lvl = torch.arange(L, dtype=torch.float32, device=out.device).repeat_interleave(F)
            if max_level.ndim == 0:
                mask = lvl[None, :] < max_level * L
            else:
                mask = lvl[None, :] < max_level[:, None] * L
            out = out * mask.to(out.dtype)
        return out


def grid_encoding_from_config(cfg: dict, n_dims: int, device=None) -> GridEncoding:
    """Build from a tcnn-style JSON encoding config."""
    otype = cfg.get("otype", "HashGrid").lower()
    if "dense" in otype:
        grid_type = "dense"
    elif "tiled" in otype:
        grid_type = "tiled"
    else:
        grid_type = cfg.get("type", "Hash").lower() if "grid" == otype else "hash"
    n_features_per_level = int(cfg.get("n_features_per_level", 2))
    if cfg.get("n_features", 0):
        n_levels = int(cfg["n_features"]) // n_features_per_level
    else:
        n_levels = int(cfg.get("n_levels", 16))
    return GridEncoding(
        n_dims=n_dims,
        n_levels=n_levels,
        n_features_per_level=n_features_per_level,
        log2_hashmap_size=int(cfg.get("log2_hashmap_size", 19)),
        base_resolution=int(cfg.get("base_resolution", 16)),
        per_level_scale=float(cfg.get("per_level_scale", 2.0)),
        interpolation=str(cfg.get("interpolation", "Linear")).lower(),
        grid_type=grid_type,
        device=device,
    )
