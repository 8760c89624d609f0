"""Row gather, the bilinear texture read and summed column gather (ports of
the Pallas kernels of ``scripts/bench_gather_tpu.py::make_pallas_take`` and
``scripts/bench_dyngather.py::run_one``, and of the JAX image step's
``bilinear_read``).

``take_rows(table, idx)`` is ``jnp.take(table, idx, axis=0)`` on a (T, F)
table with int32 indices in [0, T): the image primitive's nearest-texel
reads go through it. ``bilinear_read(texture, resolution, uv)`` is the
image primitive's bilinear read (its training targets and
``compute_mse``). ``gather_cols_sum(x, idx, reps)`` is Σ_{k<reps}
``take_along_axis(x, (idx + k) % T, axis=0)``, summed in x's type from
zero in k order, as the Pallas kernel carries its sum (a bf16 sum rounds
to bf16 after every add).

On CUDA tensors they launch kernel I (row gather, bilinear entry) and kernel
J (``csrc/gather.cu``); on CPU tensors they run ``take_rows_plain``,
``bilinear_read_plain`` and ``gather_cols_sum_plain``.

The JAX image step is jitted, and XLA contracts the bilinear read's
``uv * res - 0.5`` into one FMA and its weighted sum of the four corners into
three, so ``bilinear_read_plain`` computes them with ``common.fma_exact``
(one rounding, as a hardware FMA) and equals the jitted JAX read and the
card's ``fmaf`` bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import cuda_lib
from ..common import fma_exact

GATHER_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def texel_index(x: torch.Tensor, y: torch.Tensor, width: int) -> torch.Tensor:
    """Row of texel (x, y) of a row-major (H·W, C) texture, int32."""
    return (y * width + x).to(torch.int32)


def bilinear_upper(resolution: tuple[int, int]) -> tuple[float, float]:
    """The upper clamps of a bilinear read's pos per axis: res − 1.0001
    rounded to f32, as the JAX package computes them."""
    return tuple(float(np.float32(r) - np.float32(1.0 + 1e-4)) for r in resolution)


def bilinear_texels(resolution: tuple[int, int], uv: torch.Tensor):
    """The texels and weights of ``bilinear_read``: (indices (4N,) int32,
    the N reads' corners 00 then 10, 01 and 11; frac (N, 2))."""
    w, h = resolution
    # per axis with host scalars: a small tensor made on the host each step
    # would be a blocking copy to the card
    pos = torch.stack([torch.clamp(fma_exact(uv[:, d], float(r), -0.5), 0.0, hi)
                       for d, (r, hi) in enumerate(zip(resolution, bilinear_upper(resolution)))],
                      dim=-1)
    pos_int = torch.floor(pos)
    frac = pos - pos_int
    x0 = torch.clamp(pos_int[:, 0].to(torch.int64), 0, w - 2)
    y0 = torch.clamp(pos_int[:, 1].to(torch.int64), 0, h - 2)
    idx = torch.cat([texel_index(x0, y0, w), texel_index(x0 + 1, y0, w),
                     texel_index(x0, y0 + 1, w), texel_index(x0 + 1, y0 + 1, w)])
    return idx, frac


def bilinear_read_plain(texture: torch.Tensor, resolution: tuple[int, int],
                        uv: torch.Tensor) -> torch.Tensor:
    """Bilinear fetch with the reference's pixel addressing (pos·res − 0.5,
    clamped; testbed_image.cu:196-211). texture (H·W, C) row-major;
    resolution (W, H); uv (N, 2) in [0, 1], x = u along the width. The
    corners' weighted sum in the jitted JAX read's FMAs."""
    idx, frac = bilinear_texels(resolution, uv)
    v00, v10, v01, v11 = take_rows_plain(texture, idx).chunk(4)
    fx = frac[:, 0:1]
    fy = frac[:, 1:2]
    return fma_exact(fx * fy, v11, fma_exact((1 - fx) * fy, v01,
                                             fma_exact((1 - fx) * (1 - fy), v00,
                                                       fx * (1 - fy) * v10)))


def bilinear_read(texture: torch.Tensor, resolution: tuple[int, int],
                  uv: torch.Tensor) -> torch.Tensor:
    """See ``bilinear_read_plain``. CPU tensors run the plain version; CUDA
    tensors launch kernel I's bilinear entry (one thread a read: its four
    corner rows as independent 16-byte loads, weighed in the plain version's
    arithmetic, bit for bit). The entry takes an (H·W, 4) f32 texture,
    16-byte aligned, and raises on anything else."""
    if texture.device.type == "cpu":
        return bilinear_read_plain(texture, resolution, uv)
    cuda_lib.check_cuda(texture, uv, dtype=torch.float32)
    w, h = resolution
    if texture.shape != (w * h, 4) or uv.ndim != 2 or uv.shape[1] != 2 or w < 2 or h < 2:
        raise ValueError(f"kernel I's bilinear entry takes a (W·H, 4) texture of W, H >= 2 and "
                         f"(N, 2) positions, got {tuple(texture.shape)} for {resolution} and "
                         f"{tuple(uv.shape)}")
    if texture.data_ptr() % 16 or uv.data_ptr() % 8:
        raise ValueError("kernel I's bilinear entry reads 16-byte texels and 8-byte positions: "
                         "texture and uv must be aligned to them")
    out = torch.empty((uv.shape[0], 4), dtype=torch.float32, device=texture.device)
    if uv.shape[0] > 0:
        cuda_lib.launch("bilinear_read", texture.data_ptr(), uv.data_ptr(), uv.shape[0], w, h,
                        *bilinear_upper(resolution), out.data_ptr())
    return out


def take_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table (T, F), idx (N,) integer in [0, T) → (N, F) of table's type."""
    return table[idx]


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """See ``take_rows_plain``. CPU tensors run the plain version; CUDA
    tensors launch kernel I, which copies each row as 16-, 8- or 4-byte
    pieces, several a thread with their loads in flight together, and
    writes a zero row for an index outside [0, T)."""
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
