"""Row scatter-add (port of ``instant_ngp_tpu/ops/scatter.py::
scatter_add_xla`` and of the Pallas scatter probes
``scripts/bench_pallas_scatter.py`` and ``scripts/bench_pallas_scatter1d.py``).

``scatter_add_rows(idx, vals, size)`` is ``zeros(size, F).at[idx].add(vals)``:
rows whose index lies outside [0, size) are dropped, as JAX drops
out-of-bounds updates. F = 1 is the flat accumulator layout. On CUDA
tensors it launches kernel H (``csrc/scatter.cu``, f32 atomics); on CPU
tensors it runs ``scatter_add_rows_plain``.
"""

from __future__ import annotations

import torch

from .. import cuda_lib


def scatter_add_rows_plain(idx: torch.Tensor, vals: torch.Tensor, size: int) -> torch.Tensor:
    """idx (M,) integer, vals (M, F) → (size, F) f32."""
    vals = vals.to(torch.float32)
    out = torch.zeros((size, vals.shape[1]), dtype=torch.float32, device=vals.device)
    idx = idx.to(torch.int64)
    keep = (idx >= 0) & (idx < size)
    out.index_add_(0, torch.where(keep, idx, 0), torch.where(keep[:, None], vals, 0.0))
    return out


def scatter_add_rows(idx: torch.Tensor, vals: torch.Tensor, size: int) -> torch.Tensor:
    """See ``scatter_add_rows_plain``. CPU tensors run the plain version;
    CUDA tensors launch kernel H (one thread per element)."""
    if vals.device.type == "cpu":
        return scatter_add_rows_plain(idx, vals, size)
    idx = idx.to(torch.int64).contiguous()
    vals = vals.to(torch.float32).contiguous()
    cuda_lib.check_cuda(idx, dtype=torch.int64)
    cuda_lib.check_cuda(vals, dtype=torch.float32)
    if vals.ndim != 2 or idx.shape != (vals.shape[0],):
        raise ValueError(f"idx {tuple(idx.shape)} and vals {tuple(vals.shape)} do not match")
    out = torch.zeros((size, vals.shape[1]), dtype=torch.float32, device=vals.device)
    if vals.numel() > 0:
        cuda_lib.launch("scatter_add_rows", idx.data_ptr(), vals.data_ptr(), vals.shape[0],
                        vals.shape[1], size, out.data_ptr())
    return out
