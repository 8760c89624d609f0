"""NeRF occupancy grid, read side (port of ``instant_ngp_tpu/nerf/occupancy.py``).

The grid is dense [mip, x, y, z] with 128³ cells per cascade, each cascade
doubling the extent around the scene center. From the float density grid
of a snapshot come the bitfield (threshold min(0.01, mean) plus a centered
OR-pooled mip chain) and the skip chain the marcher reads. The grid update
comes with the training slice.
"""

from __future__ import annotations

import torch

from ..common import NERF_CASCADES, NERF_GRIDSIZE, NERF_MIN_OPTICAL_THICKNESS

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
