"""The baked sparse-cell render cache (port of ``instant_ngp_tpu/nerf/baked.py``).

A bake evaluates the model once at the 8 lattice corners of every cell the
occupancy grid marks, and packs each cell's activated [r, g, b, σ] corners
into one 64-byte bf16 row (8 corners × 4 channels). A baked render then
samples the field with one int32 index load and one row load a sample and
a trilinear sum (``query``) instead of the whole model, and composites the
activated values (``render_round``).

Cascades: one index block per occupancy cascade (cascade m spans (pos −
0.5)·2^m + 0.5 over [0, 1]), the finest baked at ``res0`` (256, twice the
occupancy grid), the outer ones at 128, degraded together until the rows
fit the cap. All index blocks live in one flat buffer with per-mip offsets.

View dependence: colours are baked with a fixed direction (``FIXED_BAKE_DIR``,
a diffuse bake) or, given ``origin``, with each corner's direction from that
camera position (exact for primary rays from it, up to a cell's angular size).

The host planning is numpy, as in the JAX package: the occupancy at each
bake resolution, the resolution ladder, ``np.argwhere``'s row order and the
flat index. The corners are evaluated on the device through the port's
model (kernels A and B), in chunks of 2^18 rows. The JAX package evaluates
through its brick cache (not ported): the values agree to the MLP's bf16.

``query`` launches kernel N (``csrc/baked.cu``) on CUDA tensors and runs
``query_plain`` on CPU tensors; the two agree to the bit. A baked render's
round after its march, ``render_round``, is one launch (``csrc/
baked_round.cu``): each sample's position, N's lookup and the activated
composite; its plain version ``render_round_plain`` is those three steps.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import cuda_lib
from ..common import (NERF_GRIDSIZE, NerfActivation, fma, network_to_density, network_to_rgb,
                      warp_direction)
from ..ops.raymarch import mip_from_pos

G = NERF_GRIDSIZE

# the direction of a fixed-direction (diffuse) bake
FIXED_BAKE_DIR = np.float32([0.5774, 0.5774, 0.5774])
BAKE_CHUNK = 1 << 18  # corner rows a bake evaluates at once


@dataclasses.dataclass
class BakedCache:
    """A flat per-cascade cell index and the packed corner-record table, on
    one device."""

    index: torch.Tensor  # (Σ_m N_m³,) int32: a row, or -1 for an empty cell
    table: torch.Tensor  # (rows_cap, 32) bf16: 8 corners × [r, g, b, σ]
    offsets: torch.Tensor  # (n_cascades,) int32: each mip block's flat offset
    res: torch.Tensor  # (n_cascades,) int32: each mip's bake resolution
    n_cascades: int
    n_rows: int  # occupied cells (≤ the table's rows)
    res_host: tuple  # ``res`` as Python ints


def cache_from_numpy(index, table, offsets, res, n_cascades: int, n_rows: int,
                     device) -> BakedCache:
    """A cache from numpy arrays in the JAX package's layout (a JAX
    ``BakedCache``'s fields through ``np.asarray``; the table's bf16 values
    carry over exactly)."""
    res = np.array(res, np.int32)
    table = np.asarray(table).astype(np.float32).reshape(-1, 32)
    return BakedCache(
        index=torch.as_tensor(np.array(index, np.int32), device=device),
        table=torch.as_tensor(table, device=device).to(torch.bfloat16),
        offsets=torch.as_tensor(np.array(offsets, np.int32), device=device),
        res=torch.as_tensor(res, device=device), n_cascades=int(n_cascades),
        n_rows=int(n_rows), res_host=tuple(int(r) for r in res))


def cells_of(cache: BakedCache, pos: torch.Tensor):
    """The lookup of positions pos (M, 3): (flat index entry (M,) int64, its
    row idx (M,) int32, -1 for an empty cell, inside the mip's box (M,),
    the fraction within the cell (M, 3))."""
    mip = mip_from_pos(pos, cache.n_cascades - 1).to(torch.int64)
    n = cache.res[mip].to(torch.int64)
    nf = n.to(torch.float32)
    p = (pos - 0.5) * torch.exp2(-mip.to(torch.float32))[:, None] + 0.5
    inb = torch.all((p >= 0.0) & (p < 1.0), dim=-1)
    u = p * nf[:, None]
    i = torch.minimum(torch.clamp(torch.floor(u).to(torch.int64), min=0), (n - 1)[:, None])
    f = torch.clamp(u - i.to(torch.float32), 0.0, 1.0)
    flat = cache.offsets[mip].to(torch.int64) + (i[:, 0] * n + i[:, 1]) * n + i[:, 2]
    return flat, cache.index[flat], inb, f


def query_plain(cache: BakedCache, pos: torch.Tensor) -> torch.Tensor:
    """The baked field at world positions pos (M, 3): (M, 4) f32 activated
    [r, g, b, σ], zero outside occupied cells and outside the mip's box.
    Kernel N's arithmetic in its order: the corners summed one after
    another, weights (wx·wy)·wz."""
    _, idx, inb, f = cells_of(cache, pos)
    row = cache.table[torch.clamp(idx, min=0).to(torch.int64)].to(torch.float32)
    row = row.reshape(-1, 8, 4)
    w = [(1.0 - f[:, a], f[:, a]) for a in range(3)]
    out = torch.zeros((pos.shape[0], 4), dtype=torch.float32, device=pos.device)
    for c in range(8):
        wc = (w[0][(c >> 2) & 1] * w[1][(c >> 1) & 1]) * w[2][c & 1]
        out = out + wc[:, None] * row[:, c]
    return torch.where(((idx >= 0) & inb)[:, None], out, 0.0)


def query(cache: BakedCache, pos: torch.Tensor) -> torch.Tensor:
    """See ``query_plain``. CPU tensors run the plain version; CUDA tensors
    launch kernel N (one thread a sample)."""
    if pos.device.type == "cpu":
        return query_plain(cache, pos)
    pos = pos.contiguous()
    cuda_lib.check_cuda(pos, dtype=torch.float32)
    cuda_lib.check_cuda(cache.index, cache.offsets, cache.res, dtype=torch.int32)
    cuda_lib.check_cuda(cache.table, dtype=torch.bfloat16)
    if pos.ndim != 2 or pos.shape[1] != 3 or cache.table.shape[1] != 32:
        raise ValueError(f"baked query of positions {tuple(pos.shape)} in a table "
                         f"{tuple(cache.table.shape)}")
    M = pos.shape[0]
    out = torch.empty((M, 4), dtype=torch.float32, device=pos.device)
    if M > 0:
        cuda_lib.launch("baked_query", pos.data_ptr(), cache.index.data_ptr(),
                        cache.table.data_ptr(), cache.offsets.data_ptr(), cache.res.data_ptr(),
                        cache.n_cascades - 1, M, out.data_ptr())
    return out


def render_round_plain(cache: BakedCache, o, d, ts, dts, valid, t, t_exit, T, rgb, depth, alive,
                       tmax, cost, eps_t: float):
    """One baked round after its march (task.py:1820-1838): the samples'
    positions o + ts·d (``common.fma``), their lookups (``query_plain``) and
    the activated composite of the (R, K) window onto the rays' state
    (``composite_window_plain(..., activated=True)``). Returns the new (t,
    T, rgb, depth, alive, cost)."""
    from .task import composite_window_plain  # task imports this module

    R, K = ts.shape
    pos = fma(ts[..., None], d[:, None, :], o[:, None, :])
    out = query_plain(cache, pos.reshape(R * K, 3)).reshape(R, K, 4)
    return composite_window_plain(out, ts, dts, valid, t, t_exit, T, rgb, depth, alive, tmax, cost,
                                  eps_t, NerfActivation.NONE, NerfActivation.NONE, activated=True)


def render_round(cache: BakedCache, o, d, ts, dts, valid, t, t_exit, T, rgb, depth, alive, tmax,
                 cost, eps_t: float):
    """See ``render_round_plain``. CPU tensors run the plain version; CUDA
    tensors launch the baked round (a lane a ray, its valid samples looked
    up a lane each): the positions and lookups bit for bit the plain
    version's, the composite within ``chip_smoke.TOL_COMPOSITE`` of it (its
    running sum of τ in the same order, its other sums in sample order),
    the alive flags equal."""
    if ts.device.type == "cpu":
        return render_round_plain(cache, o, d, ts, dts, valid, t, t_exit, T, rgb, depth, alive,
                                  tmax, cost, eps_t)
    R, K = ts.shape
    cuda_lib.check_cuda(ts, dts, t_exit, o, d, t, tmax, T, rgb, depth, cost,
                        dtype=torch.float32)
    cuda_lib.check_cuda(valid, alive, dtype=torch.bool)
    cuda_lib.check_cuda(cache.index, cache.offsets, cache.res, dtype=torch.int32)
    cuda_lib.check_cuda(cache.table, dtype=torch.bfloat16)
    if (o.shape != (R, 3) or d.shape != (R, 3) or rgb.shape != (R, 3) or valid.shape != (R, K)
            or cache.table.shape[1] != 32):
        raise ValueError(f"baked round of a ({R}, {K}) window with o {tuple(o.shape)}, d "
                         f"{tuple(d.shape)}, rgb {tuple(rgb.shape)}, valid {tuple(valid.shape)}, "
                         f"table {tuple(cache.table.shape)}")
    T_new, rgb_new, depth_new = torch.empty_like(T), torch.empty_like(rgb), torch.empty_like(depth)
    alive_new, cost_new = torch.empty_like(alive), torch.empty_like(cost)
    if R > 0:
        cuda_lib.launch("baked_round", ts.data_ptr(), dts.data_ptr(), valid.data_ptr(),
                        t_exit.data_ptr(), o.data_ptr(), d.data_ptr(), t.data_ptr(),
                        tmax.data_ptr(), T.data_ptr(), rgb.data_ptr(), depth.data_ptr(),
                        alive.data_ptr(), cost.data_ptr(), cache.index.data_ptr(),
                        cache.table.data_ptr(), cache.offsets.data_ptr(), cache.res.data_ptr(),
                        cache.n_cascades - 1, R, K, eps_t, T_new.data_ptr(), rgb_new.data_ptr(),
                        depth_new.data_ptr(), alive_new.data_ptr(), cost_new.data_ptr())
    return t_exit, T_new, rgb_new, depth_new, alive_new, cost_new


def occ_at(occ: np.ndarray, n: int) -> np.ndarray:
    """Occupancy resampled to n³: repeated up, OR-pooled down (a pooled
    cell is occupied if any child was)."""
    if n >= occ.shape[0]:
        rep = n // occ.shape[0]
        return occ.repeat(rep, 0).repeat(rep, 1).repeat(rep, 2)
    f = occ.shape[0] // n
    return occ.reshape(n, f, n, f, n, f).any((1, 3, 5))


def plan_bake(bitfield: np.ndarray, n_cascades: int, res0: int = 256,
              max_rows_log2: int = 22):
    """The host plan of a bake (baked.py:136-180): (per-mip resolutions,
    cells (rows, 3) int32, mips (rows,) int32, flat index (Σ N_m³,) int32,
    offsets (n_cascades,) int64). Resolutions start at res0 for mip 0 and G
    for the rest and degrade, the outer mips first, until the occupied
    cells fit 2^max_rows_log2; past 32³ the rows are cut at the cap."""
    occs = [np.asarray(bitfield[m]) for m in range(n_cascades)]
    max_rows = 1 << max_rows_log2
    base = [res0 if m == 0 else G for m in range(n_cascades)]
    for k0, ko in sorted(((a, b) for a in range(6) for b in range(6)),
                         key=lambda p: (p[0], p[1])):
        res = [max(base[0] >> k0, 32)] + [max(b >> ko, 32) for b in base[1:]]
        if sum(int(occ_at(occs[m], res[m]).sum()) for m in range(n_cascades)) <= max_rows:
            break
    cells, mips = [], []
    for m in range(n_cascades):
        ijk = np.argwhere(occ_at(occs[m], res[m])).astype(np.int32)
        cells.append(ijk)
        mips.append(np.full((len(ijk),), m, np.int32))
    cells = np.concatenate(cells) if cells else np.zeros((0, 3), np.int32)
    mips = np.concatenate(mips) if mips else np.zeros((0,), np.int32)
    if len(cells) > max_rows:  # the backstop: the cap unreachable even at 32³
        cells, mips = cells[:max_rows], mips[:max_rows]
    n_rows = len(cells)
    sizes = [r ** 3 for r in res]
    offsets = np.zeros(n_cascades, np.int64)
    offsets[1:] = np.cumsum(sizes)[:-1]
    index = np.full(int(np.sum(sizes)), -1, np.int32)
    res_arr = np.asarray(res, np.int64)
    n_per = res_arr[mips]
    flat = offsets[mips] + ((cells[:, 0].astype(np.int64) * n_per + cells[:, 1]) * n_per
                            + cells[:, 2])
    index[flat] = np.arange(n_rows, dtype=np.int32)
    return res, cells, mips, index, offsets


def corner_records(model_fn, cells: torch.Tensor, mips: torch.Tensor, res: torch.Tensor,
                   aabb_min: torch.Tensor, aabb_max: torch.Tensor, origin_or_dir: torch.Tensor,
                   use_origin: bool, rgb_activation, density_activation) -> torch.Tensor:
    """The activated [r, g, b, σ] at the 8 corners of each cell (C, 8, 4)
    (baked.py:214-246). ``model_fn(pos (n, 3) in the unit cube, warped
    directions (n, 3)) → (n, 4)`` logits. Corner c = 4·dx + 2·dy + dz, at
    world ((i + dc)/N − 0.5)·2^m + 0.5; the direction is ``origin_or_dir``
    or, with ``use_origin``, the unit vector from that origin."""
    dev = cells.device
    n_per = res[mips.to(torch.int64)].to(torch.float32)
    dc = torch.tensor([[(c >> 2) & 1, (c >> 1) & 1, c & 1] for c in range(8)],
                      dtype=torch.float32, device=dev)
    corner = (cells.to(torch.float32)[:, None, :] + dc[None]) / n_per[:, None, None]
    world = ((corner - 0.5) * torch.exp2(mips.to(torch.float32))[:, None, None]
             + 0.5).reshape(-1, 3)
    pos_w = (world - aabb_min) / (aabb_max - aabb_min)
    if use_origin:
        d = world - origin_or_dir
        d = d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True), min=1e-9)
    else:
        d = origin_or_dir.expand(world.shape)
    out = model_fn(pos_w, warp_direction(d))
    rgb = network_to_rgb(out[:, :3].to(torch.float32), rgb_activation)
    sigma = network_to_density(out[:, 3].to(torch.float32), density_activation)
    return torch.cat([rgb, sigma[:, None]], -1).reshape(-1, 8, 4)


@torch.no_grad()
def bake(model_fn, bitfield: np.ndarray, n_cascades: int, aabb_min, aabb_max, rgb_activation,
         density_activation, device, origin=None, res0: int = 256,
         max_rows_log2: int = 22) -> BakedCache:
    """Bake the model into a ``BakedCache`` on ``device`` (baked.py:100-211).
    bitfield: (≥ n_cascades, G, G, G) bool, the training grid's occupancy:
    its occupied cells get records, and the marcher emits samples only
    there. origin: a camera position for a per-frame view-dependent bake;
    None bakes the fixed direction. ``model_fn`` as in ``corner_records``."""
    res, cells, mips, index, offsets = plan_bake(bitfield, n_cascades, res0, max_rows_log2)
    n_rows = len(cells)
    f32 = dict(dtype=torch.float32, device=device)
    res_d = torch.as_tensor(np.asarray(res, np.int32), device=device)
    aabb = (torch.as_tensor(np.asarray(aabb_min, np.float32), **f32),
            torch.as_tensor(np.asarray(aabb_max, np.float32), **f32))
    origin_d = torch.as_tensor(np.asarray(FIXED_BAKE_DIR if origin is None else origin,
                                          np.float32), **f32)
    rows_cap = max(1024, 1 << int(np.ceil(np.log2(max(n_rows, 1)))))
    table = torch.zeros((rows_cap, 8, 4), dtype=torch.bfloat16, device=device)
    cells_d = torch.as_tensor(cells, device=device)
    mips_d = torch.as_tensor(mips, device=device)
    per_chunk = BAKE_CHUNK // 8
    for s in range(0, n_rows, per_chunk):
        table[s:min(s + per_chunk, n_rows)] = corner_records(
            model_fn, cells_d[s:s + per_chunk], mips_d[s:s + per_chunk], res_d, *aabb, origin_d,
            origin is not None, rgb_activation, density_activation).to(torch.bfloat16)
    return BakedCache(index=torch.as_tensor(index, device=device),
                      table=table.reshape(rows_cap, 32),
                      offsets=torch.as_tensor(offsets.astype(np.int32), device=device),
                      res=res_d, n_cascades=n_cascades, n_rows=n_rows,
                      res_host=tuple(int(r) for r in res))
