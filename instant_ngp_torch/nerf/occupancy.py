"""NeRF occupancy grid (port of ``instant_ngp_tpu/nerf/occupancy.py``).

The grid is dense [mip, x, y, z] with 128³ cells per cascade, each cascade
doubling the extent around the scene center. From the float density grid
come the bitfield (threshold min(0.01, mean) plus a centered OR-pooled mip
chain) and the skip chain the marcher reads.

Write side (reference update_density_grid_nerf, testbed_nerf.cu:316-397,
2476-2592): every cell is probed in a full update, else G³/8 uniform plus
G³/8 occupied-weighted cells per cascade (the JAX package's counts); the
probes' optical thickness is max-splatted into a fresh grid and merged as
max(prev·decay, probe), culled (negative) cells staying culled. The random
cells and jitter come in as tensors (``GridDraws``), so a test can hand in
the JAX package's draws. ``mark_untrained_cells`` culls the cells that no
training camera sees. Plain torch on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..common import (
    MIN_CONE_STEPSIZE,
    NERF_CASCADES,
    NERF_GRIDSIZE,
    NERF_MIN_OPTICAL_THICKNESS,
    fma,
    network_to_density,
)

G = NERF_GRIDSIZE


def _bitfield_from_density(density: torch.Tensor, mean_density) -> torch.Tensor:
    """(n_casc, G, G, G) f32 → (NERF_CASCADES, G, G, G) bool
    (testbed_nerf.cu:348-397)."""
    n_casc = density.shape[0]
    thresh = torch.clamp(torch.as_tensor(mean_density, dtype=torch.float32,
                                         device=density.device),
                         max=NERF_MIN_OPTICAL_THICKNESS)
    bits = density > thresh
    q, h = G // 4, G // 2
    levels = []
    prev = None
    for mip in range(NERF_CASCADES):
        cur = (bits[mip].clone() if mip < n_casc
               else torch.zeros((G, G, G), dtype=torch.bool, device=density.device))
        if prev is not None:
            pooled = prev.reshape(h, 2, h, 2, h, 2).any(dim=5).any(dim=3).any(dim=1)
            cur[q:q + h, q:q + h, q:q + h] |= pooled
        levels.append(cur)
        prev = cur
    return torch.stack(levels)


def _skip_chain(bitfield: torch.Tensor) -> torch.Tensor:
    """Per-cell consecutive-empty-cascade counts (f32).

    A[m, c] = 0 if cascade m is occupied at cell c, else 1 + A[m+1,
    parent(c)]: the number of nested cascades that are all empty around
    this position. The marcher turns it into an occupancy test (A == 0)
    and a maximal safe skip (cascade m + A − 1) with a single read.
    Cascade m maps onto the center half of cascade m+1, so cell i's
    parent is G/4 + i//2 per axis."""
    q = G // 4
    out = [None] * NERF_CASCADES
    a_next = None
    for m in reversed(range(NERF_CASCADES)):
        empty = ~bitfield[m]
        if a_next is None:
            a = empty.to(torch.float32)
        else:
            up = a_next[q:3 * q, q:3 * q, q:3 * q]
            for axis in range(3):
                up = torch.repeat_interleave(up, 2, dim=axis)
            a = torch.where(empty, 1.0 + up, 0.0)
        out[m] = a
        a_next = a
    return torch.stack(out)


def skip_at(skipmip: torch.Tensor, pos: torch.Tensor, mip: torch.Tensor) -> torch.Tensor:
    """The empty-chain count at (mip, cell(pos)), the marcher's single
    probe: 0 = occupied at cascade mip; a > 0 = cascades mip..mip+a−1 are
    all empty here. Out-of-grid positions return 1 (skip one voxel)."""
    mip_scale = torch.exp2(-mip.to(torch.float32))
    p = (pos - 0.5) * mip_scale[..., None] + 0.5
    i = torch.floor(p * G).to(torch.int64)
    inb = torch.all((i >= 0) & (i < G), dim=-1)
    i = torch.clamp(i, 0, G - 1)
    flat = ((mip.to(torch.int64) * G + i[..., 0]) * G + i[..., 1]) * G + i[..., 2]
    vals = skipmip.reshape(-1)[flat]
    return torch.where(inb, vals, 1.0)


class OccupancyGrid:
    """The float density grid (n_cascades, G, G, G), negative where
    culled, with its mean over cascade 0 (a 0-dim device tensor, so the
    training step reads it without a host sync), its update count and the
    skip chain derived from both. ``fresh``: no density was ever set."""

    def __init__(self, n_cascades: int, device):
        self.density = torch.zeros((n_cascades, G, G, G), dtype=torch.float32, device=device)
        self.set_density(self.density, 0.0, 0)
        self.fresh = True

    def set_density(self, density: torch.Tensor, mean_density=None, ema_step: int = 0) -> None:
        """Take a density grid; the mean is computed from it unless given."""
        self.fresh = False
        self.density = density.to(self.density.device, torch.float32)
        if mean_density is None:
            mean_density = torch.mean(torch.clamp(self.density[0], min=0.0))
        self.mean_density = torch.as_tensor(mean_density, dtype=torch.float32,
                                            device=self.density.device)
        self.ema_step = ema_step
        bits = _bitfield_from_density(self.density, self.mean_density)
        self.skipmip = _skip_chain(bits).contiguous()


@dataclasses.dataclass
class GridDraws:
    """Random inputs of one grid update. jitter (3, n) in [0, 1): per-probe
    offset within its cell. For a partial update also: u_idx, u_mip (n/2,)
    uniform cells; o_mip (n/2,) and cand (n/2, 4) candidate cells, of which
    the first occupied one (else the first) is probed."""

    jitter: torch.Tensor
    u_idx: Optional[torch.Tensor] = None
    u_mip: Optional[torch.Tensor] = None
    o_mip: Optional[torch.Tensor] = None
    cand: Optional[torch.Tensor] = None


def draw_grid_update(generator: torch.Generator, n_cascades: int, full: bool) -> GridDraws:
    dev = generator.device
    n_cells = G**3
    if full:
        n = n_cascades * n_cells
        return GridDraws(torch.rand((3, n), generator=generator, device=dev))
    n_uniform = n_cells // 8 * n_cascades

    def randint(high, shape):
        return torch.randint(0, high, shape, generator=generator, device=dev)

    return GridDraws(
        jitter=torch.rand((3, 2 * n_uniform), generator=generator, device=dev),
        u_idx=randint(n_cells, (n_uniform,)), u_mip=randint(n_cascades, (n_uniform,)),
        o_mip=randint(n_cascades, (n_uniform,)), cand=randint(n_cells, (n_uniform, 4)))


PROBE_CHUNK = 1 << 18  # probes per density-network call


def probe_cells(grid: OccupancyGrid, draws: GridDraws, full: bool):
    """(cascade (N,), cell (N,)) int64 of every probe of a grid update: all
    cells of every cascade, or the draws' uniform cells and, of each
    candidate quadruple, the first occupied cell (else the first)."""
    n_casc = grid.density.shape[0]
    n_cells = G**3
    dev = grid.density.device
    if full:
        mips = torch.arange(n_casc, device=dev).repeat_interleave(n_cells)
        idx = torch.arange(n_cells, device=dev).repeat(n_casc)
    else:
        flat = grid.density.reshape(-1)
        occ = flat[draws.o_mip[:, None] * n_cells + draws.cand] > NERF_MIN_OPTICAL_THICKNESS
        first = torch.argmax(occ.to(torch.uint8), dim=1)  # first True, else 0
        o_idx = torch.gather(draws.cand, 1, first[:, None])[:, 0]
        mips = torch.cat([draws.u_mip, draws.o_mip])
        idx = torch.cat([draws.u_idx, o_idx])
    return mips.to(dev, torch.int64), idx.to(dev, torch.int64)


def probe_positions(mips: torch.Tensor, idx: torch.Tensor, jitter: torch.Tensor) -> torch.Tensor:
    """(N, 3) positions of probes in cells idx of cascades mips, jittered
    by jitter (3, N), in the unit cube of the cascades."""
    scale = torch.exp2(mips.to(torch.float32))
    cells = ((idx // (G * G)), (idx // G) % G, idx % G)
    return torch.stack([((c.to(torch.float32) + j) / G - 0.5) * scale + 0.5
                        for c, j in zip(cells, jitter)], dim=-1)


@torch.no_grad()
def update_grid(grid: OccupancyGrid, density_fn: Callable[[torch.Tensor], torch.Tensor],
                draws: GridDraws, decay: float, density_activation, full: bool) -> None:
    """One grid update in place. density_fn: (N, 3) positions in the unit
    cube of the cascades → (N,) density logits."""
    n_casc = grid.density.shape[0]
    n_cells = G**3
    dev = grid.density.device
    mips, idx = probe_cells(grid, draws, full)
    logits = torch.empty(idx.shape, dtype=torch.float32, device=dev)
    for i in range(0, idx.shape[0], PROBE_CHUNK):
        sl = slice(i, i + PROBE_CHUNK)
        pos = probe_positions(mips[sl], idx[sl], draws.jitter[:, sl])
        logits[sl] = density_fn(pos).to(torch.float32)
    thickness = network_to_density(logits, density_activation) * MIN_CONE_STEPSIZE
    tmp = torch.zeros((n_casc * n_cells,), dtype=torch.float32, device=dev).scatter_reduce(
        0, mips * n_cells + idx, thickness, "amax").reshape(grid.density.shape)
    prev = grid.density
    new = torch.where(prev < 0.0, prev, torch.maximum(prev * decay, tmp))
    grid.set_density(new, None, grid.ema_step + 1)


CORNER_OFFSETS = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0),
                  (0, 0, 1), (1, 0, 1), (0, 1, 1), (1, 1, 1))


@torch.no_grad()
def mark_untrained_cells(n_cascades: int, resolution, focal_lengths, xforms, principal_points,
                         device) -> torch.Tensor:
    """(n_cascades, G, G, G) f32: 0 where some camera sees a corner of the
    cell in front of it and inside its frame, else -1 (reference
    mark_untrained_density_grid, testbed_nerf.cu:87-162). The arithmetic
    is the compiled reference's: the camera-space dot products and the
    projection are fused multiply-adds, and the division by the image size
    is a multiply by its f32 reciprocal."""
    w, h = resolution
    f32 = np.float32
    xf = np.asarray(xforms, f32)
    fl = np.asarray(focal_lengths, f32)
    pp = np.asarray(principal_points, f32)
    inv_w, inv_h = float(f32(1.0) / f32(w)), float(f32(1.0) / f32(h))
    ii = torch.arange(G, device=device, dtype=torch.float32)
    b = torch.meshgrid(ii, ii, ii, indexing="ij")
    out = []
    for m in range(n_cascades):
        scale = float(f32(2.0**m))
        voxel = float(f32(scale) / f32(G))
        p = [(c.reshape(-1) / G - 0.5) * scale + 0.5 for c in b]
        seen = torch.zeros(p[0].shape, dtype=torch.bool, device=device)
        for i in range(xf.shape[0]):
            R, t = xf[i, :, :3], xf[i, :, 3]
            for off in CORNER_OFFSETS:
                r = [p[a] + voxel * off[a] - float(t[a]) for a in range(3)]

                def dot(k):
                    return fma(r[2], float(R[2, k]),
                               fma(r[1], float(R[1, k]), r[0] * float(R[0, k])))

                z, lx, ly = dot(2), dot(0), dot(1)
                zi = 1.0 / torch.clamp(z, min=1e-6)
                u = fma(lx * zi * float(fl[i, 0]), inv_w, float(pp[i, 0]))
                v = fma(ly * zi * float(fl[i, 1]), inv_h, float(pp[i, 1]))
                seen |= (z > 1e-4) & (u > 0) & (u < 1) & (v > 0) & (v < 1)
        out.append(torch.where(seen, 0.0, -1.0).reshape(G, G, G))
    return torch.stack(out)
