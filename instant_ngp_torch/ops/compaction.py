"""Fixed-capacity compaction of the valid march samples (port of
``instant_ngp_tpu/ops/compaction.py``; reference
generate_training_samples_nerf, testbed_nerf.cu:691-849).

The march leaves a per-ray prefix of valid samples in an (R, K) window.
The network runs on those samples packed into ``capacity`` slots; valid
samples beyond the capacity are dropped, as the reference drops samples
that overflow its sample buffer. The maps come from an exclusive cumsum of
the per-ray counts, with no host sync: the capacity is fixed, and slots
past the last valid sample hold clamped indices whose outputs nobody
reads. Gradients flow through torch's own index autograd.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class CompactionMaps(NamedTuple):
    """src: (capacity,) flat source index of each slot (clamped past
    n_valid); dest: (R·K,) slot of each sample (clamped where not kept);
    kept: (R·K,) bool, valid samples that fit; n_valid: () live slots."""

    src: torch.Tensor
    dest: torch.Tensor
    kept: torch.Tensor
    n_valid: torch.Tensor


def prefix_compaction_maps(n_valid: torch.Tensor, K: int, capacity: int,
                           limit: torch.Tensor | None = None) -> CompactionMaps:
    """Maps for per-ray-prefix validity: sample (r, k) of the flat index
    r·K + k is valid iff k < n_valid[r]. ``limit`` (a device scalar, at most
    ``capacity`` where given): keep only the first ``limit`` valid samples,
    in ``capacity`` slots (a rank's share of a batch whose capacity the
    ranks before it have partly filled)."""
    R = n_valid.shape[0]
    device = n_valid.device
    given = limit is not None
    if not given:
        limit = capacity
    n = torch.clamp(n_valid.to(torch.int64), max=K)
    cum = torch.cumsum(n, 0)
    off = cum - n
    k_iota = torch.arange(K, device=device)[None, :]
    dest2 = off[:, None] + k_iota
    kept = ((k_iota < n[:, None]) & (dest2 < limit)).reshape(R * K)
    dest = torch.clamp(dest2, 0, capacity - 1).reshape(R * K)
    # ray of each slot: each contributing ray marks its first slot with
    # ray + 1, and a running max fills the slots after it
    contrib = (n > 0) & (off < limit)
    r1 = torch.where(contrib, torch.arange(R, device=device) + 1, 0)
    ray_start = torch.zeros((capacity,), dtype=torch.int64, device=device).scatter_reduce(
        0, torch.clamp(off, 0, capacity - 1), r1, "amax")
    ray = torch.clamp(torch.cummax(ray_start, 0).values - 1, 0, R - 1)
    src = torch.clamp(ray * K + (torch.arange(capacity, device=device) - off[ray]), 0, R * K - 1)
    n_kept = torch.clamp(cum[-1], max=limit)
    return CompactionMaps(src, dest, kept, torch.clamp(n_kept, min=0) if given else n_kept)


def compact_gather(x: torch.Tensor, maps: CompactionMaps) -> torch.Tensor:
    """y[j] = x[src[j]]: rows of x (R·K, …) packed into the capacity."""
    return x[maps.src]


def expand_gather(y: torch.Tensor, maps: CompactionMaps) -> torch.Tensor:
    """x[i] = y[dest[i]] where kept, else 0: packed rows back in place."""
    mask = maps.kept.reshape(maps.kept.shape + (1,) * (y.ndim - 1))
    return torch.where(mask, y[maps.dest], 0.0)
