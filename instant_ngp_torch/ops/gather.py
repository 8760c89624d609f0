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
to bf16 after every add); ``idx + k`` is int32 arithmetic, as in the Pallas
kernel: it wraps past 2^31 − 1 before the floor modulo by T.

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

import ctypes
import dataclasses
import functools

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


class _BilinearReadFunction(torch.autograd.Function):
    """``bilinear_read`` differentiable in its texture: forward through
    kernel I's bilinear entry, backward a 4-corner deposit through kernel H
    (``scatter_add_rows``); the plain versions of both where ``use_kernel``
    is off or the tensors lie on the CPU."""

    @staticmethod
    def forward(ctx, texture, resolution, uv, use_kernel):
        ctx.resolution, ctx.use_kernel, ctx.n_texels = resolution, use_kernel, texture.shape[0]
        ctx.save_for_backward(uv)
        read = bilinear_read if use_kernel else bilinear_read_plain
        return read(texture, resolution, uv)

    @staticmethod
    def backward(ctx, g):
        from .scatter import scatter_add_rows, scatter_add_rows_plain

        # each corner's weight times the read's cotangent, as JAX's vjp of
        # bilinear_read forms them (image_fit/task.py:57-62), added into its texel
        (uv,) = ctx.saved_tensors
        idx, frac = bilinear_texels(ctx.resolution, uv)
        fx, fy = frac[:, 0:1], frac[:, 1:2]
        vals = torch.cat([(1 - fx) * (1 - fy) * g, fx * (1 - fy) * g, (1 - fx) * fy * g,
                          fx * fy * g])
        scatter = scatter_add_rows if ctx.use_kernel else scatter_add_rows_plain
        return scatter(idx, vals.contiguous(), ctx.n_texels), None, None, None


def bilinear_read_differentiable(texture: torch.Tensor, resolution: tuple[int, int],
                                 uv: torch.Tensor, use_kernel: bool = True) -> torch.Tensor:
    """``bilinear_read`` with a gradient with respect to the texture (the
    camera optimization's distortion map)."""
    return _BilinearReadFunction.apply(texture, resolution, uv, use_kernel)


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


SECTOR_BYTES = 32
INT32_MIN = -(1 << 31)


@dataclasses.dataclass(frozen=True)
class ColsLimits:
    """What kernel J's shared route is sized by: its block's threads
    (csrc/gather.cu's kColsThreads) and the card's SMs, shared memory a
    block may opt in to, an SM's, the runtime's reserve a block (bytes) and
    threads an SM. ``cols_limits`` reads them from the library."""

    threads: int
    n_sms: int
    smem_per_block: int
    smem_per_sm: int
    smem_reserved: int
    threads_per_sm: int


@functools.lru_cache(maxsize=None)
def cols_limits(device_index: int) -> ColsLimits:
    out = (ctypes.c_int * 6)()
    err = cuda_lib.query("gather_cols_limits", device_index, out)
    if err != 0:
        raise RuntimeError(f"kernel J's limits of device {device_index}: cudaError {err}")
    return ColsLimits(*out)


@dataclasses.dataclass(frozen=True)
class ColsPlan:
    """How kernel J covers a (T, L) problem. Both routes read each column
    from a staged copy, ``stride`` entries long, whose entry p holds
    x[p mod T, j] for p < T + max(reps, 1) − 1: a window of reps rows from
    any start in [0, T) is then contiguous.

    ``shared``: block (t, s) stages the ``cols`` columns of tile t in
    ``smem`` bytes of shared memory and sums the outputs of rows [s·rows,
    (s + 1)·rows) of them, consecutive threads on consecutive columns.
    ``transpose``: one launch writes every column's copy to an (L, stride)
    scratch tensor; a second sums the outputs from it (csrc/gather.cu says
    how each kernel's threads take their outputs)."""

    route: str
    stride: int
    cols: int = 0
    rows: int = 0
    splits: int = 0
    smem: int = 0


def transpose_plan(n_rows: int, reps: int) -> ColsPlan:
    """The transpose route: the scratch columns rounded up to 8 entries,
    32-byte aligned in f32 for the 16-byte window loads."""
    padded = n_rows + max(reps, 1) - 1
    return ColsPlan("transpose", -(-padded // 8) * 8)


@functools.lru_cache(maxsize=256)
def cols_plan(n_rows: int, n_cols: int, reps: int, elem_bytes: int,
              limits: ColsLimits) -> ColsPlan:
    """Kernel J's route and tiling for a (T, L) table of elem_bytes
    elements on a card of these limits. The shared route when a tile of one
    32-byte sector a row (8 f32 or 16 bf16 columns; fewer if L is narrower)
    and all padded rows fits a block's shared memory; its rows split over as
    many blocks as one wave holds, but no more than leaves each thread an
    output (every split stages the whole tile again). Else the transpose
    route (on an H100 the slower one at the microbenchmark's T 8–4,096 in
    f32, not at every T between: PERF.md §6)."""
    padded = n_rows + max(reps, 1) - 1
    stride = padded + (4 - padded) % 8  # ≡ 4 (mod 8): a staging warp's row halves, other banks
    cols = min(SECTOR_BYTES // elem_bytes, 1 << (n_cols - 1).bit_length())
    smem = cols * stride * elem_bytes
    if smem > limits.smem_per_block:
        return transpose_plan(n_rows, reps)
    tiles = -(-n_cols // cols)
    per_sm = min(limits.threads_per_sm // limits.threads,
                 limits.smem_per_sm // (smem + limits.smem_reserved))
    wave = max(1, limits.n_sms * per_sm // tiles)
    work = -(-n_rows * cols // limits.threads)
    rows = -(-n_rows // min(wave, work))
    return ColsPlan("shared", stride, cols, rows, -(-n_rows // rows), smem)


def staging_vec(n_cols: int, elem_bytes: int, cols: int, aligned: bool) -> int:
    """Elements a shared-route staging load takes: a 16-byte vector where
    every row of x, the tile's first column and x itself are 16-byte
    aligned and a tile row holds a vector; else one."""
    if aligned and (n_cols * elem_bytes) % 16 == 0 and cols * elem_bytes >= 16:
        return 16 // elem_bytes
    return 1


def gather_cols_sum_plain(x: torch.Tensor, idx: torch.Tensor, reps: int) -> torch.Tensor:
    """x (T, L), idx (T, L) of int32 values → (T, L) of x's type:
    out[i, j] = Σ_{k<reps} x[(idx[i, j] + k) mod T, j], the sum idx + k
    wrapped to int32 as the Pallas kernel's int32 arithmetic wraps it, the
    modulo a floor modulo, the adds in x's type from zero in k order."""
    n_rows = x.shape[0]
    idx = idx.to(torch.int64)
    acc = torch.zeros_like(x)
    for k in range(reps):
        wrapped = torch.remainder(idx + k - INT32_MIN, 1 << 32) + INT32_MIN
        acc = acc + torch.gather(x, 0, torch.remainder(wrapped, n_rows))
    return acc


def gather_cols_sum(x: torch.Tensor, idx: torch.Tensor, reps: int) -> torch.Tensor:
    """See ``gather_cols_sum_plain``. CPU tensors run the plain version;
    CUDA tensors launch kernel J on the route ``cols_plan`` picks from the
    shapes (the transpose route launches twice), bit for bit the plain
    version in f32 and bf16."""
    if x.device.type == "cpu":
        return gather_cols_sum_plain(x, idx, reps)
    if x.dtype not in GATHER_DTYPES:
        raise ValueError(f"kernel J takes float32 or bfloat16, got {x.dtype}")
    cuda_lib.check_cuda(x)
    cuda_lib.check_cuda(idx, dtype=torch.int32)
    if x.ndim != 2 or idx.shape != x.shape:
        raise ValueError(f"kernel J takes x and idx of one (T, L) shape, got "
                         f"{tuple(x.shape)} and {tuple(idx.shape)}")
    if x.numel() == 0:
        return torch.empty_like(x)
    reps = max(reps, 0)
    limits = cols_limits(x.device.index or 0)
    return gather_cols_sum_on(x, idx, reps, cols_plan(*x.shape, reps, x.element_size(), limits))


def gather_cols_sum_on(x: torch.Tensor, idx: torch.Tensor, reps: int,
                       plan: ColsPlan) -> torch.Tensor:
    """Kernel J on a given plan: ``gather_cols_sum``'s, or
    ``transpose_plan``'s where bench/composite_gather.py weighs the routes.
    x and idx as ``gather_cols_sum`` checks them, not empty, reps ≥ 0."""
    n_rows, n_cols = x.shape
    if n_cols * plan.stride >= 1 << 31:
        raise ValueError(f"kernel J indexes with int32: (T + reps) · L must be below 2^31, got "
                         f"T {n_rows}, L {n_cols}, reps {reps}")
    out = torch.empty_like(x)
    dtype, wrap_row = GATHER_DTYPES[x.dtype], INT32_MIN % n_rows
    src, vec = x, staging_vec(n_cols, x.element_size(), plan.cols, x.data_ptr() % 16 == 0)
    if plan.route == "transpose":
        src = torch.empty((n_cols, plan.stride), dtype=x.dtype, device=x.device)
        cuda_lib.launch("gather_cols_transpose", x.data_ptr(), n_rows, n_cols, reps, plan.stride,
                        dtype, src.data_ptr())
    cuda_lib.launch("gather_cols_sum", src.data_ptr(), idx.data_ptr(), n_rows, n_cols, reps,
                    wrap_row, dtype, plan.stride, plan.cols, plan.rows, plan.splits, vec,
                    out.data_ptr())
    return out
