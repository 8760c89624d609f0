"""Multiresolution (hash-)grid encoding, forward and table gradients
(port of ``instant_ngp_tpu/ops/hashgrid.py``).

  * level scale:      s_l = 2^(l·log2(b)) · N_base − 1
  * level resolution: R_l = ceil(s_l) + 1
  * dense index while R_l^D ≤ table size, else spatial hash
    h(x) = (x₀·1 ⊻ x₁·2654435761 ⊻ x₂·805459861) mod T
  * d-linear interpolation of 2^D corners; "simplex" interpolates the 4
    corners of the Freudenthal tetrahedron on hashed 3-D levels; "nearest"
    reads one corner
  * D = 3 (NeRF) or D = 2 (the image primitive) on the kernels; the plain
    versions take any D
  * per-level sizes aligned to multiples of 8; ``max_level`` masking

The per-level tables live in one flat (n_entries, F) f32 parameter, level
l at rows [offset_l, offset_l + size_l), the tcnn layout. On CUDA tensors
``hashgrid_encode`` launches kernel A (``csrc/hashgrid.cu``) and
``hashgrid_encode_bwd`` kernel E (``csrc/hashgrid_bwd.cu``); on CPU
tensors they run ``hashgrid_encode_plain`` and
``hashgrid_encode_bwd_plain``.

Table gradients: every corner gets w_c·g (exact), or, on hashed levels
with 1 ≤ ``hashed_grad_corners`` = k < C corners, each of k draws gives
g/k to the corner picked by ``cumsum(w) < u·cdf[-1]``, where u is a hash
of the position bits plus a per-(level, draw) offset, so the draw is the
JAX package's draw bit for bit on the same x. Dense levels always take
every corner, in f32 (the JAX package sums them in a bf16 matmul splat).

Position gradient (the SDF render's analytic normals): on CUDA tensors
``hashgrid_encode_dx`` launches kernel K (the end of
``csrc/hashgrid_bwd.cu``), on CPU tensors it runs
``hashgrid_encode_dx_plain``, the JAX package's analytic d/dx in its order.
The autograd function computes the table gradient only where the table
takes one and dx only where x does, so a training step launches E alone
and the render's normals K alone.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
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
MAX_DRAWS = 8  # stochastic draws are fewer than the 8 corners of a cell
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


def _position_uniform(x: torch.Tensor) -> torch.Tensor:
    """(N,) uniform in [0, 1) from the bits of x (N, D) f32: XOR of the
    bits times the next prime, times 0x9E3779B1, top 24 bits."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & _MASK32
    h = torch.zeros_like(bits[:, 0])
    for d in range(x.shape[1]):
        h = h ^ ((bits[:, d] * _PRIMES[(d + 1) % len(_PRIMES)]) & _MASK32)
    h = (h * 0x9E3779B1) & _MASK32
    return (h >> 8).to(torch.float32) * float(2.0**-24)


def draw_offset(level: int, draw: int) -> float:
    """The per-(level, draw) offset of the stochastic corner uniform, in
    f64 on the host then rounded to f32, as the JAX package forms it."""
    return float(np.float32(((level * 7 + draw) * 0.6180339887) % 1.0))


def _stochastic(level: GridLevelSpec, n_corners: int, hashed_grad_corners: int) -> bool:
    return level.hashed and 1 <= hashed_grad_corners < n_corners


def hashgrid_encode_bwd_plain(levels, interpolation: str, x: torch.Tensor, g: torch.Tensor,
                              n_entries: int, hashed_grad_corners: int) -> torch.Tensor:
    """Table gradient (n_entries, F) f32 of the encoding of x (N, D) for
    the output cotangent g (N, L·F)."""
    n_features = g.shape[1] // len(levels)
    dtable = torch.zeros((n_entries, n_features), dtype=torch.float32, device=x.device)
    u_rand = None
    for l, level in enumerate(levels):
        idx, w = _level_corners(level, interpolation, x)
        g_l = g[:, l * n_features:(l + 1) * n_features].to(torch.float32)
        n_corners = idx.shape[0]
        if _stochastic(level, n_corners, hashed_grad_corners):
            if u_rand is None:
                u_rand = _position_uniform(x)
            k = hashed_grad_corners
            g_k = g_l * float(np.float32(1.0 / k))
            cdf = torch.cumsum(w, dim=0)
            for draw in range(k):
                u_l = torch.remainder(u_rand + draw_offset(l, draw), 1.0)
                c_sel = torch.clamp(torch.sum(cdf < (u_l * cdf[-1])[None, :], dim=0), 0,
                                    n_corners - 1)
                idx_sel = torch.gather(idx, 0, c_sel[None, :])[0]
                dtable.index_add_(0, level.offset + idx_sel, g_k)
        else:
            vals = w[:, :, None] * g_l[None, :, :]
            dtable.index_add_(0, (level.offset + idx).reshape(-1),
                              vals.reshape(-1, n_features))
    return dtable


def hashgrid_encode_dx_plain(levels, interpolation: str, table: torch.Tensor, x: torch.Tensor,
                             g: torch.Tensor) -> torch.Tensor:
    """Position gradient (N, D) f32 of the encoding of x (N, D) for the
    output cotangent g (N, L·F), in the JAX package's order (``_hge_bwd``'s
    d/dx): level by level from level 0 into zeros; per level gf_c = g·f_c
    summed over f in order, then for d-linear levels, per axis d, the sum
    over corners c = 0 … 2^D−1 of gf_c · (±Π_{d'≠d} a_{d'}) (the product in
    increasing d'), times the level scale; for simplex levels the rank
    masks pick gf1−gf0 (largest fraction), gf2−gf1 (middle) or gf3−gf2
    (smallest); nearest levels add nothing."""
    n, n_dims = x.shape
    n_features = table.shape[1]
    dx = torch.zeros((n, n_dims), dtype=torch.float32, device=x.device)
    if interpolation == "nearest":
        return dx
    for l, level in enumerate(levels):
        idx, _ = _level_corners(level, interpolation, x)
        feats = table[level.offset + idx].to(torch.float32)  # (C, N, F)
        g_l = g[:, l * n_features:(l + 1) * n_features].to(torch.float32)
        gf = g_l[None, :, 0] * feats[:, :, 0]
        for f in range(1, n_features):
            gf = gf + g_l[None, :, f] * feats[:, :, f]
        scale = float(np.float32(level.scale))
        pos = fma(x, scale, 0.5)
        t = pos - torch.floor(pos)
        if interpolation == "simplex" and level.hashed and n_dims == 3:
            amax = torch.argmax(t, dim=-1)
            amin = torch.argmin(t, dim=-1)
            amin = torch.where(amin == amax, (amax + 1) % 3, amin)
            axis = torch.arange(3, device=x.device)[None, :]
            dt = torch.where(axis == amax[:, None], (gf[1] - gf[0])[:, None],
                             torch.where(axis == amin[:, None], (gf[3] - gf[2])[:, None],
                                         (gf[2] - gf[1])[:, None]))
            dx = dx + dt * scale
            continue
        cols = []
        for d in range(n_dims):
            acc = None
            for c in range(1 << n_dims):
                prod = None
                for e in range(n_dims):
                    if e == d:
                        continue
                    a = t[:, e] if (c >> e) & 1 else (1.0 - t[:, e])
                    prod = a if prod is None else prod * a
                term = gf[c] * (prod if (c >> d) & 1 else -prod)
                acc = term if acc is None else acc + term
            cols.append(acc * scale)
        dx = dx + torch.stack(cols, dim=-1)
    return dx


# ---------------------------------------------------------------------------
# wrappers: kernels A, E and K on CUDA tensors
# ---------------------------------------------------------------------------


def divisor_magic(size: int) -> tuple[int, int]:
    """(magic, shift) with which kernel A forms v % size for every uint32 v
    without a division: t = umulhi(v, magic), q = (t + ((v − t) >> 1)) >>
    shift, v % size = v − q·size (Hacker's Delight 10-8, exact for 2 ≤ size
    < 2^32). A power-of-two size gives (0, 0): the kernel masks instead."""
    if size & (size - 1) == 0:
        return 0, 0
    log2_up = size.bit_length()  # ceil(log2 size) for a size that is no power of two
    return (((1 << 32) * ((1 << log2_up) - size)) // size + 1, log2_up - 1)


@functools.lru_cache(maxsize=None)
def _magic_arrays(levels):
    """Each level's (magic, shift) as the host uint32 arrays of kernel A's
    launch, built once per grid."""
    pairs = [divisor_magic(lv.size) for lv in levels]
    return ((ctypes.c_uint32 * len(levels))(*[m for m, _ in pairs]),
            (ctypes.c_uint32 * len(levels))(*[s for _, s in pairs]))


@functools.lru_cache(maxsize=None)
def _level_arrays(levels):
    """The levels' host arrays for a launch, built once per grid."""
    L = len(levels)
    return ((ctypes.c_float * L)(*[np.float32(lv.scale) for lv in levels]),
            (ctypes.c_int * L)(*[lv.resolution for lv in levels]),
            (ctypes.c_int * L)(*[lv.size for lv in levels]),
            (ctypes.c_int * L)(*[lv.offset for lv in levels]),
            (ctypes.c_int * L)(*[int(lv.hashed) for lv in levels]))


def _check_kernel_shapes(levels, interpolation: str, n_dims: int, n_features: int, name: str):
    """Kernels A and E take D 1 to 3 (D = 1: a slice of a Composite, as
    configs/nerf/tensor.json's third); K takes D 2 and 3."""
    dims_ok = (1, 2, 3) if name in ("A", "E") else (2, 3)
    if n_dims not in dims_ok or n_features not in (1, 2, 4, 8) or len(levels) > 32:
        raise ValueError(f"kernel {name} takes D in {dims_ok}, F in (1,2,4,8), ≤32 levels; got "
                         f"D={n_dims}, F={n_features}, L={len(levels)}")
    if interpolation not in INTERPOLATIONS:
        raise NotImplementedError(f"interpolation {interpolation!r} is not ported yet")


def hashgrid_encode(levels, interpolation: str, table: torch.Tensor,
                    x: torch.Tensor) -> torch.Tensor:
    """Encode x (N, D) f32 with the flat table (n_entries, F) f32. CPU
    tensors run the plain version; CUDA tensors launch kernel A (a block
    per 32 samples, a warp per level, the output rows staged in shared
    memory)."""
    if x.device.type == "cpu":
        return hashgrid_encode_plain(levels, interpolation, table, x)
    cuda_lib.check_cuda(x, table, dtype=torch.float32)
    n, n_dims = x.shape
    n_features = table.shape[1]
    _check_kernel_shapes(levels, interpolation, n_dims, n_features, "A")
    L = len(levels)
    arrays = (*_level_arrays(levels), *_magic_arrays(levels))
    out = torch.empty((n, L * n_features), dtype=torch.float32, device=x.device)
    if n > 0:
        cuda_lib.launch("hashgrid_encode_fwd", x.data_ptr(), table.data_ptr(),
                        *map(ctypes.addressof, arrays), n_dims, L, n_features,
                        INTERPOLATIONS[interpolation], n, out.data_ptr())
    return out


@functools.lru_cache(maxsize=None)
def _draw_offsets(n_levels: int, k: int) -> ctypes.Array:
    """draw_offset(l, d) for d < k, as the host float[L·MAX_DRAWS] of a
    launch, built once per (L, k)."""
    return (ctypes.c_float * (n_levels * MAX_DRAWS))(
        *[draw_offset(l, d) if d < k else 0.0 for l in range(n_levels) for d in range(MAX_DRAWS)])


def row_alignment(n_features: int) -> int:
    """Bytes to which kernel E's gradient rows must be aligned: a row of F
    floats is one float2 (F = 2) or one or two float4 (F = 4, 8) atomic."""
    return 4 * min(n_features, 4)


def hashgrid_encode_bwd(levels, interpolation: str, x: torch.Tensor, g: torch.Tensor,
                        n_entries: int, hashed_grad_corners: int) -> torch.Tensor:
    """See ``hashgrid_encode_bwd_plain``. CPU tensors run the plain
    version; CUDA tensors launch kernel E (a warp per 32 consecutive
    samples at one level; lanes with the same row sum their adds before
    one float2/float4 atomic into the table gradient)."""
    if x.device.type == "cpu":
        return hashgrid_encode_bwd_plain(levels, interpolation, x, g, n_entries,
                                         hashed_grad_corners)
    cuda_lib.check_cuda(x, g, dtype=torch.float32)
    n, n_dims = x.shape
    L = len(levels)
    n_features = g.shape[1] // L
    _check_kernel_shapes(levels, interpolation, n_dims, n_features, "E")
    if g.shape != (n, L * n_features):
        raise ValueError(f"cotangent {tuple(g.shape)} for {n} samples and {L} levels")
    k = hashed_grad_corners
    arrays = _level_arrays(levels)
    offsets = _draw_offsets(L, k)
    g_scale = float(np.float32(1.0 / k)) if k >= 1 else 1.0
    dtable = torch.zeros((n_entries, n_features), dtype=torch.float32, device=x.device)
    if dtable.data_ptr() % row_alignment(n_features):
        raise ValueError(f"kernel E's vector atomics need rows aligned to "
                         f"{row_alignment(n_features)} bytes")
    if n > 0:
        cuda_lib.launch("hashgrid_encode_bwd", x.data_ptr(), g.data_ptr(),
                        *map(ctypes.addressof, arrays), n_dims, L, n_features,
                        INTERPOLATIONS[interpolation], k, ctypes.addressof(offsets), g_scale, n,
                        dtable.data_ptr())
    return dtable


def hashgrid_encode_dx(levels, interpolation: str, table: torch.Tensor, x: torch.Tensor,
                       g: torch.Tensor) -> torch.Tensor:
    """See ``hashgrid_encode_dx_plain``. CPU tensors run the plain version;
    CUDA tensors launch kernel K (a thread a sample, walking the levels in
    order)."""
    if x.device.type == "cpu":
        return hashgrid_encode_dx_plain(levels, interpolation, table, x, g)
    cuda_lib.check_cuda(x, table, g, dtype=torch.float32)
    n, n_dims = x.shape
    L = len(levels)
    n_features = table.shape[1]
    _check_kernel_shapes(levels, interpolation, n_dims, n_features, "K")
    if g.shape != (n, L * n_features):
        raise ValueError(f"cotangent {tuple(g.shape)} for {n} samples and {L} levels")
    dx = torch.empty((n, n_dims), dtype=torch.float32, device=x.device)
    if n > 0:
        cuda_lib.launch("hashgrid_encode_dx", x.data_ptr(), table.data_ptr(), g.data_ptr(),
                        *map(ctypes.addressof, _level_arrays(levels)), n_dims, L, n_features,
                        INTERPOLATIONS[interpolation], n, dx.data_ptr())
    return dx


class _GridEncodeFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, enc: "GridEncoding", table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        ctx.enc = enc
        ctx.save_for_backward(table, x)
        encode = hashgrid_encode if enc.use_kernel else hashgrid_encode_plain
        return encode(enc.levels, enc.interpolation, table, x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        """The table gradient (kernel E) where the table takes one, dx
        (kernel K) where x does."""
        table, x = ctx.saved_tensors
        enc = ctx.enc
        g = g.contiguous()
        dtable = dx = None
        if ctx.needs_input_grad[1]:
            backward = hashgrid_encode_bwd if enc.use_kernel else hashgrid_encode_bwd_plain
            dtable = backward(enc.levels, enc.interpolation, x, g, enc.n_entries,
                              enc.hashed_grad_corners)
        if ctx.needs_input_grad[2]:
            encode_dx = hashgrid_encode_dx if enc.use_kernel else hashgrid_encode_dx_plain
            dx = encode_dx(enc.levels, enc.interpolation, table, x, g).to(x.dtype)
        return None, dtable, dx


class GridEncoding(nn.Module):
    """Multiresolution grid encoding of positions in [0, 1]^D.

    ``table`` is the flat (n_entries, F) f32 parameter; ``unpack_params``
    gives the per-level views the JAX package keeps as separate leaves.
    ``hashed_grad_corners`` is the number of stochastic corner draws of
    the table gradient on hashed levels; C or more (8) means exact."""

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
        self.hashed_grad_corners = 1
        self.table = nn.Parameter(torch.zeros((self.n_entries, n_features_per_level),
                                              dtype=torch.float32, device=device))

    @property
    def n_dims_to_encode(self) -> int:
        return self.n_dims

    @property
    def n_entries(self) -> int:
        return self.levels[-1].offset + self.levels[-1].size

    @property
    def n_output_dims(self) -> int:
        return self.n_levels * self.n_features_per_level

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        """Table entries uniform in [-1e-4, 1e-4] in place (tcnn convention,
        as the JAX package's ``GridEncoding.init``; different random bits)."""
        u = torch.rand(self.table.shape, generator=generator, dtype=torch.float32,
                       device=generator.device)
        self.table.copy_(u * 2e-4 - 1e-4)

    def unpack_params(self, flat=None) -> tuple:
        """Per-level (size_l, F) views of the flat table."""
        flat = self.table if flat is None else flat
        return tuple(flat[lv.offset: lv.offset + lv.size] for lv in self.levels)

    def forward(self, x: torch.Tensor, max_level: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (N, D) in [0, 1] → (N, L·F) f32. max_level: optional scalar or
        (N,) in [0, 1]; levels l ≥ max_level·L contribute zero."""
        out = _GridEncodeFunction.apply(self, self.table, x.contiguous())
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
