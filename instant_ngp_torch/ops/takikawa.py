"""Takikawa (NGLOD) feature-octree encoding (port of
``instant_ngp_tpu/ops/takikawa.py``; reference takikawa_encoding.cuh, used by
configs/sdf/takikawa.json).

Features live at the vertices of the occupied octree cells. Per level in
[start_level, depth], a dense (res+1)³ map gives each vertex of an occupied
cell its row of the flat (n_entries, F) table, or −1; a point gathers the 8
vertex rows of its cell at every level and trilerps them, a vertex outside
the octree adding zero, and the levels' features are concatenated. An XLA
composition (gathers and sums) in the JAX package: plain torch here, with the
table's gradient through the gathers (``index_put`` accumulation by
autograd).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ..geometry.octree import TriangleOctree


@dataclasses.dataclass(frozen=True)
class TakikawaLevel:
    level: int
    resolution: int
    n_vertices: int
    offset: int  # into the flat vertex-feature table


def vertex_maps(octree: TriangleOctree, start_level: int):
    """([TakikawaLevel], [(res+1)³ int32 maps, flat]) of the octree's levels
    from start_level on: each occupied cell's 8 vertices numbered in flat
    order, after the levels before."""
    levels, maps = [], []
    offset = 0
    for lv in range(start_level, octree.depth + 1):
        res = 1 << lv
        vmask = np.zeros((res + 1, res + 1, res + 1), bool)
        cells = np.argwhere(octree.levels[lv])
        for dx, dy, dz in [(0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0),
                           (0, 0, 1), (1, 0, 1), (0, 1, 1), (1, 1, 1)]:
            vmask[cells[:, 0] + dx, cells[:, 1] + dy, cells[:, 2] + dz] = True
        n_v = int(vmask.sum())
        vmap = np.full(vmask.shape, -1, np.int32)
        vmap[vmask] = np.arange(n_v, dtype=np.int32) + offset
        levels.append(TakikawaLevel(lv, res, n_v, offset))
        maps.append(vmap.reshape(-1))
        offset += n_v
    return levels, maps


class TakikawaEncoding(nn.Module):
    n_dims_to_encode = 3

    def __init__(self, octree: TriangleOctree, n_features_per_level: int = 4,
                 start_level: int = 2, device=None):
        super().__init__()
        self.octree = octree
        self.F = n_features_per_level
        self.start_level = start_level
        self.levels, maps = vertex_maps(octree, start_level)
        for i, m in enumerate(maps):
            self.register_buffer(f"vertex_map_{i}", torch.from_numpy(m.astype(np.int64)).to(device),
                                 persistent=False)
        self.n_entries = sum(lv.n_vertices for lv in self.levels)
        self.table = nn.Parameter(torch.zeros((self.n_entries, self.F), dtype=torch.float32,
                                              device=device))

    @property
    def n_output_dims(self) -> int:
        return len(self.levels) * self.F

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        """Entries uniform in [-1e-4, 1e-4] in place, as the JAX package's
        ``init`` (different random bits)."""
        u = torch.rand(self.table.shape, generator=generator, dtype=torch.float32,
                       device=generator.device)
        self.table.copy_(u * 2e-4 - 1e-4)

    def forward(self, x: torch.Tensor, max_level=None) -> torch.Tensor:
        """x (N, 3) → (N, levels·F) f32, in the JAX package's order of
        operations (the corner weights' product over dims 0, 1, 2, the
        corners summed in order 0..7)."""
        xs = [x[:, d] for d in range(3)]
        outs = []
        for i, lv in enumerate(self.levels):
            vmap = getattr(self, f"vertex_map_{i}")
            res = lv.resolution
            pos = [torch.clamp(xd, 0.0, 1.0 - 1e-6) * res for xd in xs]
            floor = [torch.floor(p) for p in pos]
            frac = [p - f for p, f in zip(pos, floor)]
            grid = [f.to(torch.int64) for f in floor]
            side = res + 1
            acc = None
            for c in range(8):
                bits = [(c >> d) & 1 for d in range(3)]
                flat = ((grid[0] + bits[0]) * side + grid[1] + bits[1]) * side + grid[2] + bits[2]
                slot = vmap[flat]
                w = None
                for d in range(3):
                    wd = frac[d] if bits[d] else (1.0 - frac[d])
                    w = wd if w is None else w * wd
                w = torch.where(slot >= 0, w, 0.0)
                term = self.table[torch.clamp(slot, min=0)] * w[:, None]
                acc = term if acc is None else acc + term
            outs.append(acc)
        return torch.cat(outs, dim=-1)
