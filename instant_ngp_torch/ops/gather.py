"""Row gather and summed column gather (ports of the Pallas kernels of
``scripts/bench_gather_tpu.py::make_pallas_take`` and
``scripts/bench_dyngather.py::run_one``).

``take_rows(table, idx)`` is ``jnp.take(table, idx, axis=0)`` on a (T, F)
table with int32 indices in [0, T): the image primitive's texture fetches
go through it. ``gather_cols_sum(x, idx, reps)`` is Σ_{k<reps}
``take_along_axis(x, (idx + k) % T, axis=0)``, summed in x's type from
zero in k order, as the Pallas kernel carries its sum (a bf16 sum rounds
to bf16 after every add).

On CUDA tensors they launch kernel I and kernel J (``csrc/gather.cu``); on
CPU tensors they run ``take_rows_plain`` and ``gather_cols_sum_plain``.
"""

from __future__ import annotations

import torch

from .. import cuda_lib

GATHER_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def take_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table (T, F), idx (N,) integer in [0, T) → (N, F) of table's type."""
    return table[idx]


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """See ``take_rows_plain``. CPU tensors run the plain version; CUDA
    tensors launch kernel I, which copies each row as 16-, 8- or 4-byte
    pieces and writes a zero row for an index outside [0, T)."""
    if table.device.type == "cpu":
        return take_rows_plain(table, idx)
    cuda_lib.check_cuda(table)
    cuda_lib.check_cuda(idx, dtype=torch.int32)
    if table.ndim != 2 or idx.ndim != 1:
        raise ValueError(f"kernel I takes a (T, F) table and (N,) indices, got "
                         f"{tuple(table.shape)} and {tuple(idx.shape)}")
    row_bytes = table.shape[1] * table.element_size()
    if row_bytes % 4 or table.data_ptr() % 16:
        raise ValueError(f"kernel I takes rows of a multiple of 4 bytes from a 16-byte aligned "
                         f"table, got {row_bytes} bytes at {table.data_ptr() % 16} past alignment")
    out = torch.empty((idx.shape[0], table.shape[1]), dtype=table.dtype, device=table.device)
    if idx.shape[0] > 0:
        cuda_lib.launch("take_rows", table.data_ptr(), idx.data_ptr(), idx.shape[0],
                        table.shape[0], row_bytes, out.data_ptr())
    return out


def gather_cols_sum_plain(x: torch.Tensor, idx: torch.Tensor, reps: int) -> torch.Tensor:
    """x (T, L), idx (T, L) integer → (T, L) of x's type:
    out[i, j] = Σ_{k<reps} x[(idx[i, j] + k) mod T, j]."""
    n_rows = x.shape[0]
    idx = idx.to(torch.int64)
    acc = torch.zeros_like(x)
    for k in range(reps):
        acc = acc + torch.gather(x, 0, torch.remainder(idx + k, n_rows))
    return acc


def gather_cols_sum(x: torch.Tensor, idx: torch.Tensor, reps: int) -> torch.Tensor:
    """See ``gather_cols_sum_plain``. CPU tensors run the plain version;
    CUDA tensors launch kernel J (f32 or bf16, one thread per element)."""
    if x.device.type == "cpu":
        return gather_cols_sum_plain(x, idx, reps)
    if x.dtype not in GATHER_DTYPES:
        raise ValueError(f"kernel J takes float32 or bfloat16, got {x.dtype}")
    cuda_lib.check_cuda(x)
    cuda_lib.check_cuda(idx, dtype=torch.int32)
    if x.ndim != 2 or idx.shape != x.shape:
        raise ValueError(f"kernel J takes x and idx of one (T, L) shape, got "
                         f"{tuple(x.shape)} and {tuple(idx.shape)}")
    out = torch.empty_like(x)
    if x.numel() > 0:
        cuda_lib.launch("gather_cols_sum", x.data_ptr(), idx.data_ptr(), x.shape[0], x.shape[1],
                        reps, GATHER_DTYPES[x.dtype], out.data_ptr())
    return out
