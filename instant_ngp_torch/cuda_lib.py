"""Build, load and launch the package's CUDA kernels.

Each ``csrc/*.cu`` file compiles with its own ``nvcc``, all started
together, and the objects link into one shared library with a plain C
interface, which is loaded with ``ctypes``. Each launcher takes raw
pointers, sizes and a ``cudaStream_t`` and returns ``cudaGetLastError()``.
The library goes into ``build/instant_ngp_torch/`` at the repository root,
is built at first use and is keyed by a hash of the sources and flags, so
an edited kernel rebuilds.

There is no fast math: kernels A and C make discrete decisions from
``floorf``, ``frexpf``, ``logf`` and ``expf``. ``-fmad=false`` keeps
``a*b+c`` as two roundings, as PyTorch's elementwise ops compute it; the
kernels write ``fmaf`` only where the plain versions call ``common.fma``.
So a kernel and its plain version agree to the bit wherever their
operation order agrees.

``LAUNCHES`` counts the launches of each kernel. A wrapper adds one where
it launches its kernel and nowhere else, so a run can show that its main
path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "instant_ngp_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# argtypes of every launcher; the last argument is always the stream
SIGNATURES = {
    # x, table, level scale/res/size/offset/hashed/magic/shift (host
    # arrays), n_dims, n_levels, n_features, interpolation, n, out
    "hashgrid_encode_fwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _P, _P],
    # x (f32), w (host pointers, one f32 (in, out) layer each), dims (host
    # int[n_layers+1]), n_layers, act, out_act, n, out
    "fused_mlp": [_P, _P, _P, _I, _I, _I, _L, _P, _P],
    # o, d, t0 (start or jitter), skipmip, aabb_min, aabb_max, stepping (host
    # float[11]), R, K, n_iters, min_mip, max_mip, dt_scale, from_jitter, ts,
    # dts, valid, t_exit, n_valid
    "march_rays": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P, _P, _P, _P, _P,
                   _P],
    # out, ts, dts, valid, t, t_exit, T, rgb, depth, alive, tmax, cost, R, K,
    # eps_t, rgb_act, density_act, T_new, rgb_new, depth_new, alive_new,
    # cost_new
    "composite_window": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                         _F, _I, _I, _P, _P, _P, _P, _P, _P],
    # x, g, level scale/res/size/offset/hashed (host arrays), n_dims,
    # n_levels, n_features, interpolation, n_draws, draw offsets (host
    # float[L*8]), g_scale, n, dtable
    "hashgrid_encode_bwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _F, _L, _P,
                            _P],
    # x, table, g, level scale/res/size/offset/hashed (host arrays), n_dims,
    # n_levels, n_features, interpolation, n, dx
    "hashgrid_encode_dx": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _P, _P],
    # x (f32), w (host pointers, one f32 (in, out) layer each), g (f32), dims
    # (host int[n_layers+1]), n_layers, act, n, dx, dw (f32, zeroed), the
    # recompute's record (f32) or null
    "fused_mlp_bwd": [_P, _P, _P, _P, _I, _I, _L, _P, _P, _P, _P],
    # out, ts, dts, valid, target, bg, pixel_ok, mean_density, R, K,
    # near_distance, reg_scale, inv_n_rays, eps_t, loss, rgb_act,
    # density_act, per_ray, dout, scratch (null where K <= 64)
    "composite_train": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _F, _I, _I, _I,
                        _P, _P, _P, _P],
    # x (f32), w (host pointers), dims (host int[n_layers+1]), n_layers, act,
    # out_act, n, scratch (fused_mlp_wide_sizes' bytes), out: kernel B's wide route
    "fused_mlp_wide": [_P, _P, _P, _I, _I, _I, _L, _P, _P, _P],
    # x, w, g, dims, n_layers, act, out_act, n, scratch, dx, h buffer, dz
    # buffer (bf16, fused_mlp_wide_sizes' values), per-thread scratch (f32) or
    # null, the recompute's record or null: kernel F's wide route
    "fused_mlp_bwd_wide": [_P, _P, _P, _P, _I, _I, _I, _L, _P, _P, _P, _P, _P, _P, _P],
    # h buffer, dz buffer (what fused_mlp_bwd_wide wrote), dims, n_layers, act,
    # n, split_rows, scratch (its header), partials (f32), dw (f32, every
    # layer in turn): the wide F's weight gradient
    "fused_mlp_dw_wide": [_P, _P, _P, _I, _I, _L, _I, _P, _P, _P, _P],
    # idx, idx bytes (4 or 8), vals, m, F, vec (out and vals F-float
    # aligned), size, out (added into)
    "scatter_add_rows": [_P, _I, _P, _L, _I, _I, _L, _P, _P],
    # table, idx (int32), n, n_rows, row_bytes, out
    "take_rows": [_P, _P, _L, _L, _I, _P, _P],
    # texture ((w·h, 4) f32), uv ((n, 2) f32), n, w, h, the upper clamps of
    # pos in x and y, out ((n, 4) f32)
    "bilinear_read": [_P, _P, _L, _I, _I, _F, _F, _P, _P],
    # x, n_rows, n_cols, reps, stride, dtype (0 f32, 1 bf16), xt ((n_cols,
    # stride) scratch, the columns' padded copies)
    "gather_cols_transpose": [_P, _I, _I, _I, _I, _I, _P, _P],
    # x (or xt where cols is 0), idx (int32), n_rows, n_cols, reps, the row
    # past the int32 wrap, dtype, stride, cols, rows, splits, vec (elements a
    # staging load), out
    "gather_cols_sum": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P],
    # first spawn's draws (6, n), per-iteration draws (n_iters, 14, n), grid
    # (f32), bitgrid (uint8 128^3), constants (host float[25]), grid
    # resolution (host int[3]), n, n_iters, pts, tgt, valid: kernel L
    "volume_generate_batch": [_P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P],
    # o, d (R, 3), draws (n_iters, 5, R), grid, bitgrid, constants (host
    # float[25]), grid resolution (host int[3]), R, n_iters, rgb, alpha: kernel M
    "volume_trace_gt": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P],
}

# (argtypes, restype) of the library's functions that launch nothing
QUERIES = {
    # R, K -> the f32 scratch composite_train needs
    "composite_train_scratch_floats": ([_I, _I], _L),
    # dims (host int[n_layers+1]), n_layers, act, n, split_rows, out (host
    # int64[6]) -> cudaError: the buffers of the MLP's wide route
    "fused_mlp_wide_sizes": ([_P, _I, _I, _L, _I, _P], _I),
    # x (64, 256) f32, w (256, 128) f32, scratch, zw, zm (64, 128) f32, stream
    # -> cudaError: one product by a wgmma chain and by mma.sync chains
    "mlp_wgmma_probe": ([_P, _P, _P, _P, _P, _P], _I),
    # device, out (6 int32) -> cudaError: what kernel J's plan is sized by
    "gather_cols_limits": ([_I, _P], _I),
}

LAUNCHES = {name: 0 for name in SIGNATURES}

_lib = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libngp_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands in parallel; raise with the first failure's stderr."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    errors = []
    for cmd, proc in zip(cmds, procs):
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{' '.join(cmd[-3:])} failed ({proc.returncode}):\n{err}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))


def build() -> tuple[Path, float]:
    """Compile the kernels if the library for these sources is missing:
    one nvcc per source, all at once, then one link. Returns (path,
    seconds spent compiling; 0 when it was already built)."""
    path = library_path()
    if path.exists():
        return path, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{path.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in _sources()]
    t0 = time.perf_counter()
    _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
              for src, obj in zip(_sources(), objs)])
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]])
    os.replace(tmp, path)
    for obj in objs:
        obj.unlink()
    return path, time.perf_counter() - t0


def load() -> ctypes.CDLL:
    """The loaded kernel library, building it first if needed."""
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, f"ngp_{name}")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        for name, (argtypes, restype) in QUERIES.items():
            fn = getattr(lib, f"ngp_{name}")
            fn.argtypes, fn.restype = argtypes, restype
        _lib = lib
    return _lib


def launch(name: str, *args) -> None:
    """Launch kernel ``name`` on the current stream, count it, and raise if
    the launch was refused."""
    fn = getattr(load(), f"ngp_{name}")
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")
    LAUNCHES[name] += 1


def query(name: str, *args):
    """Call the library's function ``name``, one that launches nothing
    (``QUERIES``), and return its result."""
    return getattr(load(), f"ngp_{name}")(*args)


def check_cuda(*tensors: torch.Tensor, dtype=None) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor (of dtype)."""
    for t in tensors:
        if t.device.type != "cuda" or not t.is_contiguous():
            raise ValueError(f"kernel input must be a contiguous CUDA tensor, got "
                             f"{t.device} contiguous={t.is_contiguous()}")
        if dtype is not None and t.dtype != dtype:
            raise ValueError(f"kernel input must be {dtype}, got {t.dtype}")
