"""Row scatter-add (port of ``instant_ngp_tpu/ops/scatter.py::
scatter_add_xla`` and of the Pallas scatter probes
``scripts/bench_pallas_scatter.py`` and ``scripts/bench_pallas_scatter1d.py``).

``scatter_add_rows_(out, idx, vals)`` adds row i of vals into row idx[i] of
``out`` in place, which JAX writes ``out.at[idx].add(vals)`` and returns as
a new array: the in-place update is the PyTorch idiom, and it spares a fill
and a second pass over ``out``. Rows whose index lies outside [0, size) are
dropped, as JAX drops out-of-bounds updates. ``scatter_add_rows(idx, vals,
size)`` is the same into fresh zeros. F = 1 is the flat accumulator
layout. On CUDA tensors both launch kernel H (``csrc/scatter.cu``, one
atomic per row); on CPU tensors they run the plain versions.
"""

from __future__ import annotations

import torch

from .. import cuda_lib

INDEX_BYTES = {torch.int32: 4, torch.int64: 8}


def scatter_add_rows_plain_(out: torch.Tensor, idx: torch.Tensor,
                            vals: torch.Tensor) -> torch.Tensor:
    """out (size, F) f32 += rows of vals (M, F) at idx (M,) integer, in
    place; returns out."""
    size = out.shape[0]
    idx = idx.to(torch.int64)
    keep = (idx >= 0) & (idx < size)
    out.index_add_(0, torch.where(keep, idx, 0),
                   torch.where(keep[:, None], vals.to(torch.float32), 0.0))
    return out


def scatter_add_rows_plain(idx: torch.Tensor, vals: torch.Tensor, size: int) -> torch.Tensor:
    """idx (M,) integer, vals (M, F) → (size, F) f32."""
    out = torch.zeros((size, vals.shape[1]), dtype=torch.float32, device=vals.device)
    return scatter_add_rows_plain_(out, idx, vals)


def scatter_add_rows_(out: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """See ``scatter_add_rows_plain_``. CPU tensors run the plain version;
    CUDA tensors launch kernel H: out contiguous f32 (size, F), vals
    contiguous f32 (M, F), idx contiguous int32 or int64 (M,), taken as
    they come (no copy is made)."""
    if out.device.type == "cpu":
        return scatter_add_rows_plain_(out, idx, vals)
    cuda_lib.check_cuda(out, vals, dtype=torch.float32)
    cuda_lib.check_cuda(idx)
    if idx.dtype not in INDEX_BYTES:
        raise ValueError(f"kernel H takes int32 or int64 indices, got {idx.dtype}")
    m, F = vals.shape if vals.ndim == 2 else (-1, -1)
    if out.ndim != 2 or out.shape[1] != F or idx.shape != (m,):
        raise ValueError(f"out {tuple(out.shape)}, idx {tuple(idx.shape)} and vals "
                         f"{tuple(vals.shape)} do not match")
    if m > 0:
        align = 4 * F
        vec = int(out.data_ptr() % align == 0 and vals.data_ptr() % align == 0)
        cuda_lib.launch("scatter_add_rows", idx.data_ptr(), INDEX_BYTES[idx.dtype],
                        vals.data_ptr(), m, F, vec, out.shape[0], out.data_ptr())
    return out


def scatter_add_rows(idx: torch.Tensor, vals: torch.Tensor, size: int) -> torch.Tensor:
    """See ``scatter_add_rows_plain``. CPU tensors run the plain version;
    CUDA tensors zero the output and launch kernel H. Indices of another
    integer type become int64, vals of another type or layout contiguous
    f32."""
    if vals.device.type == "cpu":
        return scatter_add_rows_plain(idx, vals, size)
    if idx.dtype not in INDEX_BYTES:
        idx = idx.to(torch.int64)
    vals = vals.to(torch.float32).contiguous()
    out = torch.zeros((size, vals.shape[1]), dtype=torch.float32, device=vals.device)
    return scatter_add_rows_(out, idx.contiguous(), vals)
