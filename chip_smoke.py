"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python chip_smoke.py

Builds the port's CUDA kernels from ``instant_ngp_torch/csrc/``, checks each
kernel against its plain PyTorch version on the card at the shapes of the
fox snapshot, then drives the port's three paths and its gather
microbenchmarks:

- render: ``data/fox_1536.ingp`` at 256x256 through ``Testbed.load_snapshot``
  and ``render``, checked to go through kernels A-D and to agree with the
  same render through the plain versions (the tiny test fixture gets the
  same check at 64x64);
- train: the snapshot's 50 views, rendered at a quarter of the dataset
  resolution without its crop box, become an in-memory ``NerfDataset``
  (fox's own photographs are not in the repository); a fresh model of
  ``bench.py::bench_fox``'s configuration trains on them for 300 steps
  through ``Testbed.frame()``, checked to go through kernels A-C and E-H,
  to lower its loss and to raise its PSNR on views 0/24/49; one step through
  the kernels is held against the same step through the plain versions,
  and kernels G and H against theirs on that step's own inputs (H in the
  path's form, added straight into the error map, and into zeros), G also on
  the 8,192-ray ceiling's step; kernel C is also held at the training march
  on the snapshot's trained grid, G on the snapshot model's outputs there
  and on random inputs at K 48, 40 and 100, two calls of G bit for bit equal,
  and H at the Pallas probes' shapes, with rows of 4 and with int32 indices;
- disk: ``io/synthetic.py``'s scene (24 train and 4 test views at 128^2)
  written to disk, loaded by ``Testbed.load_training_data`` with
  ``configs/nerf/base.json`` and trained 300 frames, checked to go through
  kernels A-C and E-H, to halve its loss, to keep every loss finite and to
  raise the PSNR of training views 0/6/12/18 and of the
  ``transforms_test.json`` views as far as the JAX package's own training
  raises them, less a margin (``MIN_DISK_GAIN_DB``); then
  ``save_snapshot`` with the optimizer state and ``load_snapshot`` into a
  Testbed with no scene (its render through kernels A-D within 40 dB of the
  saved task's) and into one holding the scene (the optimizer state and
  grid bit for bit, a second save equal to the first, 20 more frames);
- image: kernels A and E at D = 2 on the level specs of a 16384^2 image,
  kernel I at every shape of ``scripts/bench_gather_tpu.py``, its bilinear
  entry at the edges of its clamps on a non-square texture and kernel J at
  every shape of ``scripts/bench_dyngather.py`` and at ragged shapes with
  negative indices and indices near 2^31 − 1, on both of its routes, against
  their plain versions (I and J bit for bit); then an 8192^2 RGBA image made from SEED, written as a
  ``.bin`` file, is fitted with ``configs/image/base.json`` for 300 steps of
  2^18 samples through ``Testbed("image")`` and ``frame()``, checked to go
  through kernels A, B, E, F and I's bilinear entry, to lower its loss and to
  raise its PSNR; ``compute_image_mse`` and a render with ground-truth tiles
  are checked to go through both entries of I; one step through the kernels
  is held against the same step through the plain versions, both entries of
  I against theirs bit for bit at a step's positions, and a 1920x1080 render
  against the plain render;
- kernels B and F together: one ``fused_mlp`` call profiled (one device
  kernel and no PyTorch op besides the output's allocation); B's forward
  bit for bit against F's forward recompute, every layer's pre-activation,
  for both trained fox MLPs and the trained image MLP; F against its plain
  version on the trained image MLP with the rows near a ReLU tie left out;
- gather microbenchmarks: ``instant_ngp_torch.bench.gather`` at its case
  lists with few repetitions, through kernels I and J;
- sdf: a closed procedural mesh of 69,632 triangles (a torus with seeded
  bumps, ``geometry/procedural.py``; the reference's ``bunny.obj`` has 69,451)
  written as ``.obj``, loaded by ``Testbed("sdf").load_training_data`` with
  ``configs/sdf/base.json`` at full width (the BVH built from
  ``csrc/bvh.cpp`` with g++) and trained 300 frames on the batch producer's
  points, checked to go through kernels A, B, E and F and none of C, D, G,
  H and K, and to reach the JAX package's least IoU on this mesh (300 fresh
  steps, 3 seeds) less 0.02; A, B, E and F held against their plain
  versions at its shapes on the fresh and the trained model, one step's
  gradients within 1e-2 a leaf; a 256^2 render through kernels A, B, F and K
  (not E) against the plain render (hit masks differing on at most 0.5 % of
  the pixels, ≥ 40 dB over the rest), K against its plain version on that
  render's hit positions, the normals after normalization; a 1920x1080
  render timed; a snapshot with the optimizer state saved and loaded onto
  the mesh (state bit for bit, its render as above);
- volume: ``procedural_fog_volume(128)`` written as ``.nvdb`` with
  ``tests/nvdb_fixture.py``'s writer (the repository holds no NanoVDB file),
  loaded by ``Testbed("volume").load_training_data`` with
  ``configs/volume/base.json`` at full width and trained 300 frames, each on
  a fresh batch traced by kernel L, checked to go through kernels A, B, E, F
  and L and none of C, D, G, H and K, to keep every loss finite, and to lower
  the density MSE to at most the JAX package's worst over 3 seeds times
  their spread (``MAX_VOLUME_MSE``) by at least the JAX package's least fall
  over the spread of its falls (``MIN_VOLUME_GAIN``); L against its plain
  version on one step's draws (every path's vertices bit for bit, its bound
  from the draws, grid and bitgrid sectors the paths read, its device time
  back to back, warm from the generator's fill and cold), one step's gradients
  within 1e-2 a leaf, A, B, E and F against theirs at its shapes on the fresh
  and the trained model; a 256^2 learned render (A and B) against the plain
  render (≥ 40 dB) and a ground-truth render (M) against its plain version on
  the same draws (each pixel bit for bit), M also on that frame's rays with
  its own draws; L and M at sizes that are multiples neither of 4 nor of a
  block (a partial last block, draw rows not 16-byte aligned), bit for bit;
  the 256^2 and 1920x1080 frames timed; a snapshot with the
  optimizer state saved and loaded onto the grid (state bit for bit, its
  render against the saved task's);
- configs: every shipped config but volume's (25) trains at full width
  through its entry point: the image configs through ``Testbed("image")`` on
  a 1024^2 ``make_image`` for 50 frames, the SDF configs through
  ``Testbed("sdf")`` on the sdf phase's mesh (Takikawa's octree built on it)
  for 80 frames, every NeRF config at the model level as
  ``tests/test_configs_smoke.py`` drives it (20 steps of its loss and
  optimizer on 2^17 seeded rows) and ``nerf/big.json`` also through
  ``Testbed("nerf").frame()`` on the disk phase's scene for 50 frames; every
  loss finite, the image and SDF losses falling; per config and MLP, kernels
  B and F (their wide route, ``csrc/mlp_wide.cu``, past 64 wide, 8 matrices
  or relu/none) at its first training step's input and cotangent: B bit for
  bit F's recompute and within 1e-2 of its plain version's max |out|, F
  against its plain version on the rows whose ReLU masks agree, each leaf
  within 1e-2 of its own max |ref| (a check shown to refuse planted faults:
  dX zeroed or negated, one dW off by 4 %), and their device times on copies
  of their inputs read in turn (none left in L2 by the call before), beside
  their bounds, one line per config; kernels A and E at D = 1 on
  ``nerf/tensor.json``'s third slice against their plain versions. Beside the fox MLPs' checks, B and F's wide route on the same
  inputs as the narrow route they take (B bit for bit), each route timed.

Every kernel's entry in the JSON line has its error against its plain
version, its time and the plain version's (back to back), its launches on
its path, and its bound: the larger of the bytes it must move (each input
read once, each output written once; a gather counts the distinct rows it
reads) over 3.35 TB/s and its operations over the H100's peak for their
type (989 TFLOP/s bf16 on tensor cores, 67 TFLOP/s f32), and, where one
PyTorch call computes the same function, that call's time. H's entry adds
the device time per call of the kernel and of ``index_add_``
(torch.profiler), its device time per training step and the deposit's
launches per step; C's adds the plain march's iterations per ray and the
chain values read at the training march, and its device time per step.

Prints a JSON line of per-kernel results, the card's name and power limit,
and as its last line ``{"ok": true, "device": {...}}``. Any failed check
raises, so the script exits non-zero without that line. There is no CPU
path: without CUDA it fails at once.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SNAPSHOT = ROOT / "data" / "fox_1536.ingp"
# cone angle 0, perspective lens, 2 features per level, MLP widths below 16
TINY_SNAPSHOT = ROOT / "tests" / "fixtures" / "tiny_nerf.ingp"
TINY_RES = 64
SEED = 0
N_ROWS = 1 << 19  # samples for the encode and MLP checks
RES = 256  # render and march resolution

# kernel vs plain tolerances on the card, and why
TOL_ENCODE = 1e-5  # same corners and weights; only f32 summation order differs
# relative to max |out|: tensor-core and cuBLAS f32 sums differ in order and
# rounding, which can flip the bf16 rounding of a hidden unit
TOL_MLP = 1e-2
TOL_MARCH_T = 1e-5  # relative, on rays whose sample count agrees
MIN_MARCH_AGREE = 0.999  # share of rays whose n_valid agrees
TOL_COMPOSITE = 1e-5  # same formulas in the same order; exp/sum order differences only
MIN_PSNR_DB = 40.0

# the training phase: bench.py::bench_fox's task on the snapshot's rendered views
TRAIN_DOWNSCALE = 4  # views at a quarter of the dataset resolution
TRAIN_RAYS, TRAIN_K, TRAIN_ITERS = 4096, 32, 192
TARGET_BATCH = 1 << 18  # NerfTask's default: a 2^17-sample network capacity
TRAIN_STEPS = 300  # crosses the full grid updates, the CDF rebuild at 128, exact corners at 256
PROFILED_STEPS = 3  # the last steps, traced by torch.profiler
LOSS_WINDOW = 20
EVAL_VIEWS = (0, 24, 49)
N_TRAIN_ROWS = 1 << 17  # the sample capacity: rows of the E and F checks
RAGGED = 37  # kernel F also at N_TRAIN_ROWS - RAGGED rows: a ragged last tile
ZERO_ROW = 3  # an all-zero input row in kernel F's checks: every ReLU at its tie
N_SCATTER, SCATTER_SIZE = 1 << 20, 1 << 19  # scripts/bench_pallas_scatter*.py's shapes
MAX_LOSS_RATIO = 0.5  # mean loss of the last LOSS_WINDOW steps over the first's
MIN_PSNR_GAIN_DB = 6.0
# kernel vs plain tolerances of the new kernels, relative to max |ref|, and why
TOL_ENCODE_BWD = 1e-5  # same corners, weights and draws; f32 atomics sum in another order
TOL_MLP_BWD = 1e-2  # f32 sums in another order, then rounded to bf16 (1 ulp = 2^-8)
# same formulas, but d/d sigma holds rgb minus a running sum of K samples, a
# cancellation that lifts the f32 rounding of the sums (cumsum in another
# order on the card) by up to K * 2^-24 of rgb. G is held against the plain
# version evaluated in float64, within this of max |ref| plus each element's
# f32 rounding bound (composite_train_rounding): on a trained grid a sample's
# tau reaches the hundreds, and then any f32 evaluation of the formula, the
# plain version's too, is more than this from the exact value
TOL_COMPOSITE_TRAIN = 1e-4
TOL_SCATTER = 1e-5  # f32 atomics sum in another order
# one step, kernels vs plain, per parameter leaf: ||k - p|| / ||p||. Kernel B's
# outputs differ from the plain product in the last f32 bits, which can move
# a bf16 rounding of a hidden unit or a gradient (1 ulp = 2^-8) downstream
TOL_STEP_GRAD = 1e-2
TOL_STEP_LOSS = 1e-3  # relative, mean per-ray loss

# the image phase: configs/image/base.json on an image made from SEED
IMAGE_CONFIG = ROOT / "configs" / "image" / "base.json"
IMAGE_RES = 8192  # an 8192^2 RGBA image: every level of the grid is dense
CHECK_IMAGE_RES = 16384  # level specs of the D = 2 kernel checks: the top two levels hashed
N_IMAGE_ROWS = 1 << 18  # positions of the D = 2 checks: one step's batch
IMAGE_STEPS = 300
RENDER_WH = (1920, 1080)
# kernel I at every (log2 T, F, dtype) of scripts/bench_gather_tpu.py:64-66 and
# :102-112, N = 2^20 rows; the image step's own shape is checked on its texture
TAKE_CASES = ((19, 4, torch.float32), (19, 4, torch.bfloat16), (19, 16, torch.bfloat16),
              (15, 4, torch.float32), (19, 32, torch.bfloat16))
N_TAKE = 1 << 20
EDGE_TEXTURE = (1021, 517)  # (W, H) of the bilinear entry's check at its clamps
# kernel J at every case of scripts/bench_dyngather.py:68-70, bit for bit
COL_CASES = ((8, torch.float32), (64, torch.float32), (512, torch.float32),
             (4096, torch.float32), (32768, torch.float32), (4096, torch.bfloat16))
COLS, COL_REPS = 128, 8
# and beside them (T, L, dtype, indices, reps): a T that is no power of two and
# an L that is no multiple of a tile, indices negative, within COL_REPS of
# 2^31 − 1 (idx + k wraps as int32) or anywhere in int32, on the shared route
# (T ≤ 4,096; at L 13 a row is 52 bytes, so it stages one element a load) and
# on the transpose route (T 32,767; at reps 3 it loads a window an element at
# a time)
COL_EXTRA_CASES = ((4095, 100, torch.float32, "range", COL_REPS),
                   (4095, 100, torch.float32, "negative", COL_REPS),
                   (4095, 100, torch.bfloat16, "near_max", COL_REPS),
                   (7, COLS, torch.float32, "near_max", COL_REPS),
                   (4095, 13, torch.float32, "negative", COL_REPS),
                   (32767, 100, torch.float32, "int32", COL_REPS),
                   (32767, 100, torch.bfloat16, "near_max", COL_REPS),
                   (32767, 100, torch.float32, "near_max", 3))
BENCH_ITERS, BENCH_WARMUP = 10, 2  # the gather microbenchmark phase, reduced

# the least time of a kernel: H100 SXM data sheet rates
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Milliseconds per call of fn: reps calls back to back between one pair
    of CUDA events, after warmup calls, divided by reps."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_split(fn, kernel: str, reps: int = 20, attempts: int = 3,
                 per_call: int | None = None) -> dict:
    """Device milliseconds per call of fn: the durations of the card's events
    of reps calls under torch.profiler, after one warm-up call, over reps.
    ``device_ms``: all of them; ``kernel_ms``: those of the kernels whose
    name holds ``kernel`` (the rest is fills and copies); ``events_per_call``:
    how many device events a call has. A trace that caught no device event
    at all (the profiler drops one now and then) is taken again, up to
    ``attempts`` traces; then the reps calls are timed between two CUDA
    events instead, which cannot split the kernel from the rest: both
    numbers are that span, and ``timed_by`` says so. ``per_call``, where
    given, is how many kernels named ``kernel`` a call launches; then a
    trace that lost some events still counts: ``kernel_ms`` is per_call
    times the mean of the kernel's events, ``device_ms`` the sum over event
    names of each name's mean times its events a call (rounded)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [(e.name, (e.time_range.end - e.time_range.start) / 1e3 / reps)
                  for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if per_call is not None:
            by_name = {}
            for name, ms in events:
                by_name.setdefault(name, []).append(ms * reps)
            own = [ms for name, v in by_name.items() if kernel in name for ms in v]
            if own:
                return {"device_ms": sum(statistics.fmean(v) * max(1, round(len(v) / reps))
                                         for v in by_name.values()),
                        "kernel_ms": statistics.fmean(own) * per_call,
                        "events_per_call": len(events) / reps, "timed_by": "profiler"}
            continue
        if events:
            return {"device_ms": sum(ms for _, ms in events),
                    "kernel_ms": sum(ms for name, ms in events if kernel in name),
                    "events_per_call": len(events) / reps, "timed_by": "profiler"}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    print(f"torch.profiler caught no device event of {kernel} in {attempts} traces: "
          f"{ms:.4f} ms a call between CUDA events")
    return {"device_ms": ms, "kernel_ms": ms, "events_per_call": None, "timed_by": "cuda_events"}


def cold_copies(*tensors) -> itertools.cycle:
    """Copies of the tensors, enough to fill L2 twice over (at least 2, at
    most COLD_MAX_COPIES), handed out in turn and the first made first: a
    call timed on them reads its inputs from HBM, as a training step does,
    and not from L2, where the call before left its own."""
    n = min(COLD_MAX_COPIES, max(2, 1 + -(-2 * L2_BYTES // nbytes(*tensors))))
    return itertools.cycle([tuple(t.clone() for t in tensors) for _ in range(n)])


def psnr(a: torch.Tensor, b: torch.Tensor) -> float:
    mse = float(torch.mean((a[..., :3].clamp(0, 1) - b[..., :3].clamp(0, 1)) ** 2))
    return -10.0 * float(np.log10(max(mse, 1e-12)))


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: this smoke run needs an NVIDIA GPU")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {name}")
    print(f"nvidia-smi: {card}")
    print("tf32 off for matmul and cudnn: plain versions compute in full f32")
    return name, card


def phase_build() -> None:
    from instant_ngp_torch import cuda_lib

    path, seconds = cuda_lib.build()
    cuda_lib.load()
    print(f"build: {seconds:.1f} s -> {path.relative_to(ROOT)}")
    from instant_ngp_torch.ops.mlp_kernel import wgmma_rounding_probe

    probe = wgmma_rounding_probe(torch.device("cuda"))
    print(f"wgmma probe: a wgmma m64n128k16 chain over k = 256 and mma.sync m16n8k16 chains "
          f"on the same bf16 operands give {'the same f32 bits' if probe['bit_equal'] else 'other bits'}"
          f" ({probe['values_differ']} of 8192 values differ; each within "
          f"{max(probe['wgmma_rel_err'], probe['mma_rel_err']):.2e} of max |f64 product|)")
    check(probe["bit_equal"], f"wgmma does not round as mma.sync: {probe}: the routes' bit-for-bit "
                              "checks do not hold")
    counts = sass_counts(path, "HGMMA")
    wide = {k: v for k, v in counts.items() if "mlp_wide_kernel" in k or "mlp_dw_kernel" in k}
    print(f"HGMMA instructions in the SASS of the wide route's kernels: "
          f"{ {k.split('mlp_')[-1][:40]: v for k, v in wide.items()} }")
    check(len(wide) == 6 and all(v > 0 for v in wide.values()),
          f"a wide kernel has no HGMMA instruction: {wide}")
    from instant_ngp_torch.geometry import bvh

    path, seconds = bvh.build()
    bvh.load()
    print(f"build of the host BVH (g++): {seconds:.1f} s -> {path.relative_to(ROOT)}")


def sass_counts(lib: Path, opcode: str) -> dict:
    """{kernel (mangled name): instructions of ``opcode`` in its SASS} of the
    built library, from ``cuobjdump -sass``."""
    from instant_ngp_torch import cuda_lib

    cuobjdump = Path(cuda_lib._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                         timeout=300, check=True).stdout
    counts, name = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            counts[name] = 0
        elif name is not None and opcode in line:
            counts[name] += 1
    return counts


def bound(n_bytes: float, n_ops: float = 0.0, op_type: str = "float32") -> dict:
    """The least time of a kernel: its bytes over the memory rate or its
    operations over the peak rate of their type, whichever is larger."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / PEAK_OPS_PER_S[op_type] * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def grid_work(levels, interpolation: str, x: torch.Tensor) -> tuple[int, int]:
    """(distinct table rows a grid encode of x reads, Σ over levels of its
    corners per position)."""
    from instant_ngp_torch.ops.hashgrid import _level_corners

    rows, corners = 0, 0
    for lv in levels:
        idx, _ = _level_corners(lv, interpolation, x)
        rows += int(torch.unique(idx).numel())
        corners += idx.shape[0]
    return rows, corners


def record_kernel(results: list, name: str, source: str, replaces: str, err: float, ms: float,
                  plain_ms: float, bound_: dict, library_ms=None, extra: str = "",
                  **fields) -> None:
    lib = f" library {library_ms:.3f} ms" if library_ms is not None else ""
    print(f"kernel {name}: max_abs_err {err:.3e} kernel {ms:.3f} ms plain {plain_ms:.3f} ms"
          f"{lib} bound {bound_['bound_ms']:.4f} ms ({bound_['bound_by']}){extra}")
    results.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bound_,
                    "library_ms": library_ms, **fields})


def max_err(out: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(max |out - ref|, max |ref|)."""
    return float((out - ref).abs().max()), float(ref.abs().max())


def render_window_march(task, res: int, xf, kw, device):
    """The render path's first window of a res^2 view with render arguments
    kw (K 8, 64 iterations, from the crop-box entry): (march arguments,
    tmin, tmax)."""
    from instant_ngp_torch.nerf.sampler import MarchConfig

    ys, xs = torch.meshgrid(torch.arange(res, device=device), torch.arange(res, device=device),
                            indexing="ij")
    uv = torch.stack([(xs.reshape(-1) + 0.5) / res, (ys.reshape(-1) + 0.5) / res], -1).float()
    o, d, tmin, tmax = task._prep_rays(uv, task._t([res, res]), task._t(kw["focal_length"]),
                                       task._t(kw["principal_point"]), task._t(xf))
    cfg = MarchConfig(n_march_iters=task.render_march_iters,
                      max_samples_per_ray=task.render_samples_per_window,
                      cone_angle=task.cone_angle, max_mip=task.max_cascade)
    return (o, d, task.skipmip, *task._aabb_t, torch.full_like(tmin, 0.5), cfg), tmin, tmax


def training_march(task, skipmip, gen, device, n_iters: int = TRAIN_ITERS, n_rays=None, k=None):
    """The training march's arguments: n_rays (default TRAIN_RAYS) rays of
    random pixels of the task's views, random jitter, K k (default TRAIN_K),
    n_iters iterations, on the skip chain ``skipmip``."""
    from instant_ngp_torch.nerf import train as nerf_train
    from instant_ngp_torch.nerf.sampler import MarchConfig

    R, k = n_rays or TRAIN_RAYS, k or TRAIN_K
    img = torch.randint(0, task.dataset.n_images, (R,), generator=gen, device=device)
    o, d = nerf_train.generate_rays(task, img, torch.rand((R, 2), generator=gen, device=device))
    jitter = torch.rand((R,), generator=gen, device=device)
    cfg = MarchConfig(n_march_iters=n_iters, max_samples_per_ray=k,
                      cone_angle=task.cone_angle, max_mip=task.max_cascade)
    return o, d, skipmip, *task._aabb_t, jitter, cfg


def check_march(margs, t_init, what: str) -> dict:
    """Kernel C against its plain version on margs (o, d, chain, aabb_min,
    aabb_max, jitter, cfg) from t_init (None: the jittered aabb entry):
    n_valid agreement, the error on the rays that agree, times, device time
    and bound, and the plain march's iterations per ray, samples per ray and
    how often each chain value was read."""
    from instant_ngp_torch.nerf.sampler import march_rays, march_rays_plain

    outs = march_rays(*margs, t_init=t_init)
    st = {}
    refs = march_rays_plain(*margs, t_init=t_init, stats=st)
    (ts, dts, valid, t_exit, n_valid), (ts_p, dts_p, valid_p, t_exit_p, n_valid_p) = outs, refs
    same = n_valid == n_valid_p
    agree = float(same.float().mean())
    check(agree >= MIN_MARCH_AGREE, f"{what}: march n_valid agreement {agree}")
    check(bool(torch.equal(valid[same], valid_p[same])), f"{what}: march valid flags differ")
    err = max(float((a[same] - b[same]).abs().max()) for a, b in
              ((ts, ts_p), (dts, dts_p), (t_exit, t_exit_p)))
    rel = max(float(((a[same] - b[same]).abs() / b[same].abs().clamp(min=1.0)).max())
              for a, b in ((ts, ts_p), (t_exit, t_exit_p)))
    check(rel <= TOL_MARCH_T, f"{what}: march relative err {rel}")
    t_in = margs[5] if t_init is None else t_init
    return {"max_abs_err": err, "rel_err": rel, "n_valid_agree": agree,
            "ms": time_ms(lambda: march_rays(*margs, t_init=t_init)),
            "plain_ms": time_ms(lambda: march_rays_plain(*margs, t_init=t_init)),
            **device_split(lambda: march_rays(*margs, t_init=t_init), "march_rays"),
            **bound(nbytes(*margs[:2], t_in, *outs)),
            "samples_mean": float(n_valid.float().mean()),
            "iters_max": int(st["iters"].max()), "iters_mean": float(st["iters"].float().mean()),
            "chain_counts": st["chain_counts"].tolist()}


@torch.no_grad()
def kernel_checks(tb, device) -> list[dict]:
    """Each kernel of the render path against its plain version on the card,
    at fox shapes."""
    from instant_ngp_torch.common import warp_direction
    from instant_ngp_torch.nerf.sampler import march_rays
    from instant_ngp_torch.ops.hashgrid import hashgrid_encode
    from instant_ngp_torch.ops.mlp_kernel import fused_mlp

    task, model = tb.task, tb.task.model
    enc = model.pos_encoding
    gen = torch.Generator(device=device).manual_seed(SEED)
    results = []
    record = functools.partial(record_kernel, results)

    # A: hash-grid encode of N positions with the fox tables
    x = torch.rand((N_ROWS, 3), generator=gen, device=device)
    v = check_encode(enc.levels, enc.interpolation, enc.table, x, "fox")
    record("hashgrid_encode_fwd", "instant_ngp_torch/csrc/hashgrid.cu",
           "instant_ngp_tpu/ops/hashgrid.py:213", v["max_abs_err"], **headline(v))
    feats = hashgrid_encode(enc.levels, enc.interpolation, enc.table, x)

    # B: both MLPs of the model on N rows (encodings of A; SH of random dirs)
    dirs = warp_direction(torch.nn.functional.normalize(
        torch.randn((N_ROWS, 3), generator=gen, device=device), dim=-1))
    density_ws = list(model.density_network.weights)
    d_out = fused_mlp(density_ws, feats, "relu", "none")
    rgb_in = torch.cat([d_out, model.dir_encoding(dirs)], dim=-1)
    rgb_ws = list(model.rgb_network.weights)
    both = [check_mlp(ws, inp, what) for what, ws, inp in
            (("density", density_ws, feats), ("rgb", rgb_ws, rgb_in))]
    one = check_one_launch(rgb_ws, rgb_in)
    wide = {what: wide_route_fwd(ws, inp, f"fox {what}") for what, ws, inp in
            (("density", density_ws, feats), ("rgb", rgb_ws, rgb_in))}
    record("fused_mlp", "instant_ngp_torch/csrc/mlp.cu",
           "instant_ngp_tpu/ops/pallas/mlp_kernel.py:53", max(v["max_abs_err"] for v in both),
           sum(v["ms"] for v in both), sum(v["plain_ms"] for v in both),
           bound(sum(v["bytes"] for v in both), sum(v["ops"] for v in both), "bfloat16"),
           extra=f" (32->64->16 plus 32->64->64->3; max |ref| {both[0]['scale']:.3f}, "
                 f"{both[1]['scale']:.3f}; one call: {one})", one_launch=one, wide_route=wide)

    # C: march the rays of view 0 at RES^2, K = 8, 64 iterations, fox grid
    margs, tmin, tmax = render_window_march(task, RES, *view0(tb, RES), device)
    o, d = margs[:2]
    v = check_march(margs, tmin, "render window")
    ts, dts, valid, t_exit, _ = march_rays(*margs, t_init=tmin)
    record("march_rays", "instant_ngp_torch/csrc/march.cu", "instant_ngp_tpu/nerf/sampler.py:49",
           v["max_abs_err"], **headline(v),
           extra=f" (n_valid agrees on {v['n_valid_agree']:.6f} of {o.shape[0]} rays; {v})",
           variants={"render_window": v})

    # D: composite that window with the model's outputs on its samples, and
    # dense random windows, where the running sum's order shows
    v = check_composite_window(task, o, d, (ts, dts, valid, t_exit), tmin, tmax, gen)
    dense = check_composite_dense(o.shape[0], device)
    record("composite_window", "instant_ngp_torch/csrc/composite.cu",
           "instant_ngp_tpu/nerf/task.py:1853", v["max_abs_err"], **headline(v),
           extra=f" (R {o.shape[0]}, K {ts.shape[1]}; device {v['device_ms']:.4f} ms a call; "
                 f"dense random windows: {dense})",
           device_ms=v["device_ms"], variants={"render_window": v, "dense_random": dense})
    return results


def check_composite_window(task, o, d, march, tmin, tmax, gen) -> dict:
    """Kernel D against its plain version on a render window: the model's
    outputs on the march's samples (ts, dts, valid, t_exit) and a random
    running state (T, rgb, depth). Error, times, device time and bound."""
    from instant_ngp_torch.nerf.task import composite_window, composite_window_plain

    ts, dts, valid, t_exit = march
    R, device = o.shape[0], o.device
    out = task._eval_window(o, d, ts, valid)
    state = (torch.rand((R,), generator=gen, device=device),  # T
             torch.rand((R, 3), generator=gen, device=device),  # rgb
             torch.rand((R,), generator=gen, device=device))  # depth
    cargs = (out, ts, dts, valid, tmin, t_exit, *state, torch.ones_like(valid[:, 0]), tmax,
             torch.zeros_like(tmin), task.min_transmittance, task.rgb_activation,
             task.density_activation)
    k_res, p_res = composite_window(*cargs), composite_window_plain(*cargs)
    check(bool(torch.equal(k_res[4], p_res[4])), "composite alive flags differ")
    err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(k_res, p_res))
    check(err <= TOL_COMPOSITE, f"composite err {err}")
    return {"max_abs_err": err, "ms": time_ms(lambda: composite_window(*cargs)),
            "plain_ms": time_ms(lambda: composite_window_plain(*cargs)),
            **device_split(lambda: composite_window(*cargs), "composite_window"),
            **bound(nbytes(*[a for a in cargs if torch.is_tensor(a)], *k_res[1:]))}


def check_composite_dense(R: int, device, seeds: int = 4) -> dict:
    """Kernel D against its plain version on random (R, 8) windows whose
    samples reach σ = e^15 (τ up to ~7e3), where the weight's exponent
    −cumsum(τ)_k + τ_k keeps only the last bits of a large running sum:
    within TOL_COMPOSITE, alive flags equal. Also prints, unchecked, D
    against the plain version with torch.cumsum's running sum (the card's
    parallel scan) on the same windows."""
    import instant_ngp_torch.nerf.task as nerf_task
    from instant_ngp_torch.common import EPS_T, NerfActivation

    errs, scan_errs = [], []
    for seed in range(seeds):
        gen = torch.Generator(device=device).manual_seed(SEED + 10 + seed)

        def rand(*shape):
            return torch.rand(shape, generator=gen, device=device)

        t = rand(R)
        cargs = (torch.cat([rand(R, 8, 3) * 12 - 6, rand(R, 8, 1) * 31 - 15], dim=-1),
                 t[:, None] + torch.cumsum(rand(R, 8) * 2e-3, dim=1), rand(R, 8) * 2e-3 + 1e-4,
                 rand(R, 8) < 0.9, t, t + 0.05, rand(R), rand(R, 3), rand(R),
                 torch.ones(R, dtype=torch.bool, device=device), torch.full((R,), 5.0, device=device),
                 torch.zeros(R, device=device), EPS_T, NerfActivation.LOGISTIC,
                 NerfActivation.EXPONENTIAL)
        k_res = nerf_task.composite_window(*cargs)
        p_res = nerf_task.composite_window_plain(*cargs)
        check(bool(torch.equal(k_res[4], p_res[4])), "composite alive flags differ (dense)")
        errs.append(max(float((a - b).abs().max()) for a, b in zip(k_res[1:4], p_res[1:4])))
        running = nerf_task.running_sum
        nerf_task.running_sum = lambda x: torch.cumsum(x, dim=-1)
        try:
            s_res = nerf_task.composite_window_plain(*cargs)
        finally:
            nerf_task.running_sum = running
        scan_errs.append(max(float((a - b).abs().max()) for a, b in zip(k_res[1:4], s_res[1:4])))
    check(max(errs) <= TOL_COMPOSITE, f"composite err on dense windows {errs}")
    return {"max_abs_err": max(errs), "per_seed": errs, "torch_cumsum_err": scan_errs}


def view0(tb, res: int):
    """Camera and bench.py's render arguments for view 0 at res x res."""
    ds = tb.nerf_dataset
    w, h = ds.resolution
    xf = np.asarray(ds.xforms_start[0], np.float32)
    kw = dict(focal_length=(ds.focal_lengths[0, 0] * res / w, ds.focal_lengths[0, 1] * res / h),
              principal_point=tuple(ds.principal_points[0]), background=(0, 0, 0, 0))
    return xf, kw


def psnr_vs_plain(tb, frame: torch.Tensor, res: int, xf, kw) -> float:
    """PSNR of a kernel frame against the same render through the plain versions."""
    tb.task.set_use_kernels(False)
    frame_plain = tb.render_tensor(res, res, xf, **kw)
    tb.task.set_use_kernels(True)
    return psnr(frame, frame_plain)


RENDER_KERNELS = ("hashgrid_encode_fwd", "fused_mlp", "march_rays", "composite_window")
TRAIN_KERNELS = ("hashgrid_encode_fwd", "fused_mlp", "march_rays", "hashgrid_encode_bwd",
                 "fused_mlp_bwd", "composite_train", "scatter_add_rows")


def fox_train_config() -> dict:
    """bench.py::bench_fox's configuration: base.json with simplex
    interpolation and the learning-rate decay sized to its run."""
    cfg = json.loads((ROOT / "configs" / "nerf" / "base.json").read_text())
    cfg["encoding"]["interpolation"] = "Simplex"
    cfg["optimizer"]["nested"]["decay_start"] = 768
    cfg["optimizer"]["nested"]["decay_interval"] = 512
    return cfg


def render_training_set(tb):
    """The snapshot's views rendered at 1/TRAIN_DOWNSCALE of the dataset
    resolution (focal lengths scaled to match) as a uint8 sRGB
    straight-alpha NerfDataset. The snapshot is an LDR model, trained in
    sRGB, so a render's rgb is premultiplied sRGB. Fox's photographs show
    the whole room, so the views are rendered without the snapshot's crop
    box, through the scene's whole aabb, and the dataset has no crop."""
    ds, task = tb.nerf_dataset, tb.task
    w, h = ds.resolution
    w_t, h_t = w // TRAIN_DOWNSCALE, h // TRAIN_DOWNSCALE
    focals = (ds.focal_lengths * np.array([w_t / w, h_t / h])).astype(np.float32)
    images = np.empty((ds.n_images, h_t, w_t, 4), np.uint8)
    crop = task.render_aabb_min, task.render_aabb_max
    task.render_aabb_min, task.render_aabb_max = task.aabb_min, task.aabb_max
    for i in range(ds.n_images):
        frame = tb.render_tensor(w_t, h_t, ds.xforms_start[i], focal_length=tuple(focals[i]),
                                 principal_point=tuple(ds.principal_points[i]),
                                 background=(0, 0, 0, 0))
        alpha = frame[..., 3:4].clamp(0.0, 1.0)
        straight = torch.where(alpha > 0, frame[..., :3] / alpha.clamp(min=1e-6), 0.0)
        rgba = torch.cat([straight.clamp(0.0, 1.0), alpha], dim=-1)
        images[i] = (rgba * 255.0 + 0.5).to(torch.uint8).cpu().numpy()
    task.render_aabb_min, task.render_aabb_max = crop
    return dataclasses.replace(ds, images=images, focal_lengths=focals, resolution=(w_t, h_t),
                               render_aabb=None)


@torch.no_grad()
def eval_views(task, ds, views=EVAL_VIEWS) -> tuple[list[tuple[float, float]], float]:
    """bench.py::bench_fox's evaluation: the task renders each of ``views``
    against its image, both premultiplied sRGB on black. Returns ((Huber
    loss, PSNR dB) per view, the PSNR of their mean MSE)."""
    from instant_ngp_torch.ops.losses import huber

    w, h = ds.resolution
    per_view, mses = [], []
    for i in views:
        frame = task.render(w, h, ds.xforms_start[i], focal_length=tuple(ds.focal_lengths[i]),
                            principal_point=tuple(ds.principal_points[i]), background=(0, 0, 0, 0))
        gt = torch.as_tensor(ds.images[i], device=frame.device).float() / 255.0
        gt_rgb = gt[..., :3] * gt[..., 3:4]
        loss = float(torch.mean(huber(gt_rgb, frame[..., :3]) / 5.0))
        mses.append(float(torch.mean((frame[..., :3].clamp(0, 1) - gt_rgb) ** 2)))
        per_view.append((loss, psnr(frame, gt_rgb)))
    return per_view, -10.0 * float(np.log10(np.mean(mses)))


@torch.no_grad()
def train_kernel_checks(tb, task, device) -> tuple[list[dict], dict]:
    """Kernels E-H against their plain versions on the card at the training
    path's shapes, and kernel C again at the training march (against the
    snapshot's occupancy grid). Returns the records and the march's."""
    from instant_ngp_torch.common import warp_direction
    from instant_ngp_torch.nerf.sampler import march_rays
    from instant_ngp_torch.ops.hashgrid import hashgrid_encode
    from instant_ngp_torch.ops.mlp_kernel import fused_mlp

    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    results = []
    record = functools.partial(record_kernel, results)
    n = N_TRAIN_ROWS

    # E: table gradients of n positions with the fox tables, both
    # interpolations, stochastic (1 corner, the first 256 steps) and exact
    enc = task.model.pos_encoding
    x = torch.rand((n, 3), generator=gen, device=device)
    g = torch.randn((n, enc.n_output_dims), generator=gen, device=device)
    variants = {f"{interp}_corners{k}": check_encode_bwd(enc.levels, interp, x, g, enc.n_entries,
                                                          k, f"fox {interp}, {k} corner(s)")
                for interp in ("linear", "simplex") for k in (1, 8)}
    record("hashgrid_encode_bwd", "instant_ngp_torch/csrc/hashgrid_bwd.cu",
           "instant_ngp_tpu/ops/hashgrid.py:244",
           max(v["max_abs_err"] for v in variants.values()), **headline(variants["simplex_corners1"]),
           extra=f" ({n} positions, simplex 1 corner; all: {variants})", variants=variants)

    # F: both MLPs of the snapshot's model on encodings of those positions,
    # with a zero row (the ReLU tie); the rgb MLP again at a ragged n
    model = tb.task.model
    penc = model.pos_encoding
    feats = hashgrid_encode(penc.levels, penc.interpolation, penc.table.detach(), x)
    feats[ZERO_ROW] = 0.0
    density_ws = [w.detach() for w in model.density_network.weights]
    rgb_ws = [w.detach() for w in model.rgb_network.weights]
    dirs = warp_direction(torch.nn.functional.normalize(
        torch.randn((n, 3), generator=gen, device=device), dim=-1))
    rgb_in = torch.cat([fused_mlp(density_ws, feats), model.dir_encoding(dirs)], dim=-1)
    rgb_in[ZERO_ROW] = 0.0
    variants = {}
    for what, ws, inp in (("density", density_ws, feats), ("rgb", rgb_ws, rgb_in),
                          (f"rgb_n{n - RAGGED}", rgb_ws, rgb_in[:n - RAGGED])):
        g = torch.randn((inp.shape[0], ws[-1].shape[1]), generator=gen, device=device)
        variants[what] = check_mlp_bwd(ws, inp, g, f"fox {what}")
    both = [variants["density"], variants["rgb"]]
    gen_w = torch.Generator(device=device).manual_seed(SEED + 6)
    wide = {what: wide_route_bwd(ws, inp, torch.randn((n, ws[-1].shape[1]), generator=gen_w,
                                                      device=device), f"fox {what}")
            for what, ws, inp in (("density", density_ws, feats), ("rgb", rgb_ws, rgb_in))}
    record("fused_mlp_bwd", "instant_ngp_torch/csrc/mlp_bwd.cu",
           "instant_ngp_tpu/ops/pallas/mlp_kernel.py:106",
           max(v["max_abs_err"] for v in variants.values()), sum(v["ms"] for v in both),
           sum(v["plain_ms"] for v in both),
           bound(sum(v["bytes"] for v in both), sum(v["ops"] for v in both), "bfloat16"),
           extra=f" ({n} rows, 32->64->16 plus 32->64->64->3: dX and every dW; all: {variants})",
           variants=variants, wide_route=wide)

    # C at the training march: rays of random pixels of the training views,
    # on the snapshot's (trained) occupancy grid
    R = TRAIN_RAYS
    margs = training_march(task, tb.task.skipmip, gen, device)
    o, d = margs[:2]
    march = {f"train_{k}": v for k, v in check_march(margs, None, "training march").items()}
    print(f"kernel march_rays at the training march ({R} rays, K {TRAIN_K}, {TRAIN_ITERS} iters, "
          f"random jitter, the snapshot's grid): {march}")
    ts, dts, valid, _, _ = march_rays(*margs)

    # G: the snapshot model's outputs on those samples against random pixels;
    # random outputs at K 48 (the JAX NerfTask default), K 40 (a ragged chunk
    # of 8, foggy grid) and K 100 (the forward state of samples past 64 kept
    # in the wrapper's scratch), made from SEED
    out = tb.task._eval_window(o, d, ts, valid)
    variants = {f"snapshot_R{R}": check_composite_train(composite_train_args(
        task, out, ts, dts, valid, *random_pixels(R, gen), tb.task.state.grid.mean_density))}
    seed_gen = torch.Generator(device=device).manual_seed(SEED)
    for k, foggy in ((48, False), (40, True), (100, False)):
        gargs = seed_composite_train_args(task, R, k, seed_gen, None if foggy else
                                          tb.task.state.grid.mean_density)
        variants[f"seed_R{R}_K{k}"] = check_composite_train(gargs)
    g = variants[f"snapshot_R{R}"]
    record("composite_train", "instant_ngp_torch/csrc/composite_train.cu",
           "instant_ngp_tpu/nerf/task.py:683", max(v["max_abs_err"] for v in variants.values()),
           g["ms"], g["plain_ms"], {k: g[k] for k in ("bound_ms", "bound_by")},
           extra=f" (R {R}, K {TRAIN_K}, Huber: per-ray loss and d/d out; all: {variants})",
           variants=variants, device_ms=g["device_ms"])

    # H: the Pallas probes' shapes, (2^20, 2) rows into 2^19, and flat; rows
    # of 4 (one float4 atomic) and int32 indices
    idx = torch.randint(0, SCATTER_SIZE, (N_SCATTER,), generator=gen, device=device)
    vals = torch.randn((N_SCATTER, 2), generator=gen, device=device)
    flat_idx = (idx[:, None] * 2 + torch.arange(2, device=device)).reshape(-1)
    vals4 = torch.randn((N_SCATTER, 4), generator=gen, device=device)
    variants = {layout: check_scatter(*args, layout) for layout, args in (
        ("probe_rows", (idx, vals, SCATTER_SIZE)),
        ("probe_flat", (flat_idx, vals.reshape(-1, 1), 2 * SCATTER_SIZE)),
        ("probe_rows_f4", (idx, vals4, SCATTER_SIZE)),
        ("probe_rows_int32", (idx.to(torch.int32), vals, SCATTER_SIZE)))}
    rows = variants["probe_rows"]
    record("scatter_add_rows", "instant_ngp_torch/csrc/scatter.cu",
           "scripts/bench_pallas_scatter.py:25",
           max(v["max_abs_err"] for v in variants.values()), rows["ms"], rows["plain_ms"],
           {k: rows[k] for k in ("bound_ms", "bound_by")}, rows["library_ms"],
           extra=f" (2^20 rows of 2 into 2^19; all: {variants})", variants=variants,
           **{k: rows[k] for k in H_DEVICE_KEYS})
    return results, march


def encode_bwd_bound(levels, interpolation: str, x: torch.Tensor, g: torch.Tensor,
                     n_entries: int, corners: int) -> dict:
    """Kernel E's least time: x and g read once, the whole table gradient
    written once; per position and level, C corner rows of F multiply-adds,
    or k rows of F adds where k < C draws stand in for the C corners."""
    from instant_ngp_torch.ops.hashgrid import _level_corners

    n, F = x.shape[0], g.shape[1] // len(levels)
    ops = 0
    for lv in levels:
        C = _level_corners(lv, interpolation, x[:1])[0].shape[0]
        ops += n * F * (corners if lv.hashed and 1 <= corners < C else 2 * C)
    return bound(nbytes(x, g) + n_entries * F * 4, ops)


def mlp_bwd_ops(ws, n: int) -> int:
    """The backward's products: the forward again for its masks, dX and
    every dW, 2·n·in·out operations each."""
    return 3 * 2 * n * sum(w.numel() for w in ws)


def check_mlp(ws, inp, what: str) -> dict:
    """Kernel B against its plain version on (ws, inp): error, its max |ref|,
    times, and the bytes and operations of its bound."""
    from instant_ngp_torch.ops.mlp_kernel import fused_mlp, fused_mlp_plain

    out, ref = fused_mlp(ws, inp, "relu", "none"), fused_mlp_plain(ws, inp, "relu", "none")
    err, scale = max_err(out, ref)
    check(err <= TOL_MLP * max(1.0, scale), f"B {what}: err {err} at max |ref| {scale}")
    n_bytes, n_ops = nbytes(inp, out, *ws), 2 * inp.shape[0] * sum(w.numel() for w in ws)
    return {"max_abs_err": err, "scale": scale,
            "ms": time_ms(lambda: fused_mlp(ws, inp, "relu", "none")),
            "plain_ms": time_ms(lambda: fused_mlp_plain(ws, inp, "relu", "none")),
            **bound(n_bytes, n_ops, "bfloat16"), "bytes": n_bytes, "ops": n_ops}


def check_mlp_bwd(ws, inp, g, what: str) -> dict:
    """Kernel F against its plain version on (ws, inp, g): error over dX and
    every dW, times, and the bytes and operations of its bound."""
    from instant_ngp_torch.ops.mlp_kernel import fused_mlp_bwd, fused_mlp_bwd_plain

    (dx, dws), (dx_p, dws_p) = fused_mlp_bwd(ws, inp, g), fused_mlp_bwd_plain(ws, inp, g)
    errs = []
    for out, ref in zip([dx, *dws], [dx_p, *dws_p]):
        err, scale = max_err(out, ref)
        check(err <= TOL_MLP_BWD * max(1.0, scale), f"F {what}: err {err} at max |ref| {scale}")
        errs.append(err)
    zero = ZERO_ROW < inp.shape[0] and not bool(inp[ZERO_ROW].any())
    check(not zero or bool(torch.equal(dx[ZERO_ROW], dx_p[ZERO_ROW])),
          f"F {what}: dX of the zero row (the ReLU tie) differs")
    n_bytes = nbytes(inp, g, *ws, dx, *dws)
    return {"max_abs_err": max(errs), "ms": time_ms(lambda: fused_mlp_bwd(ws, inp, g)),
            "plain_ms": time_ms(lambda: fused_mlp_bwd_plain(ws, inp, g)),
            **bound(n_bytes, mlp_bwd_ops(ws, inp.shape[0]), "bfloat16"),
            "bytes": n_bytes, "ops": mlp_bwd_ops(ws, inp.shape[0])}


def route_times(call: dict, kernels: dict) -> dict:
    """Device ms of each route's call (``call``: route -> call, each on
    ``cold_copies`` of its inputs), traced narrow, wide, wide, narrow: per
    route the kernel's (``<route>_kernel_ms``, the kernel named
    ``kernels[route]``) and the whole call's (``<route>_call_ms``, with the
    wide route's packing and F's dW launch)."""
    out = {f"{route}_{k}": [] for route in call for k in ("kernel_ms", "call_ms")}
    for route in ("narrow", "wide", "wide", "narrow"):
        v = device_split(call[route], kernels[route], per_call=1)
        out[f"{route}_kernel_ms"].append(v["kernel_ms"])
        out[f"{route}_call_ms"].append(v["device_ms"])
    return out


def wide_route_fwd(ws, inp, what: str) -> dict:
    """Kernel B's wide route (``csrc/mlp_wide.cu``) on a narrow MLP's inputs
    (relu/none), beside the narrow route (``csrc/mlp.cu``) the wrapper gives
    it: the two outputs bit for bit (the same mma order), and the routes'
    device times (``route_times``)."""
    from instant_ngp_torch.ops import mlp_kernel as mk

    dims = (ws[0].shape[0], *[w.shape[1] for w in ws])
    check(mk.is_narrow(dims, 1, 0, backward=False), f"B {what}: {dims} takes the wide route")
    narrow, wide = (mk._launch_fwd(ws, inp, dims, 1, 0, route) for route in (True, False))
    check(torch.equal(narrow, wide), f"B {what}: the wide route differs from the narrow one in "
                                     f"{int((narrow != wide).any(dim=1).sum())} rows")
    copies = cold_copies(inp)
    call = {route: lambda on_narrow=route == "narrow": mk._launch_fwd(
                ws, next(copies)[0], dims, 1, 0, on_narrow) for route in ("narrow", "wide")}
    out = {"dims": dims, "rows": inp.shape[0], "bit_equal": True,
           **route_times(call, {"narrow": "fused_mlp_kernel", "wide": "mlp_wide_kernel"})}
    print(f"kernel fused_mlp {what} ({dims}, {inp.shape[0]} rows), narrow / wide route: device "
          f"{out['narrow_kernel_ms']} / {out['wide_kernel_ms']} ms (calls {out['narrow_call_ms']}"
          f" / {out['wide_call_ms']}); outputs bit for bit")
    return out


def wide_route_bwd(ws, inp, g, what: str) -> dict:
    """Kernel F's wide route on a narrow MLP's inputs and cotangent, beside
    the narrow route: each leaf within TOL_MLP_BWD of the narrow route's max
    |leaf| (``mlp_bwd_agrees``), and the routes' device times."""
    from instant_ngp_torch.ops import mlp_kernel as mk

    dims = (ws[0].shape[0], *[w.shape[1] for w in ws])
    check(mk.is_narrow(dims, 1, 0, backward=True), f"F {what}: {dims} takes the wide route")
    (dx_n, dws_n), (dx_w, dws_w) = (mk._launch_bwd(ws, inp, g, dims, 1, 0, narrow=route)
                                    for route in (True, False))
    leaves = mlp_bwd_leaves([dx_w, *dws_w], [dx_n, *dws_n])
    check(mlp_bwd_agrees(leaves), f"F {what}: the wide route is off the narrow one: {leaves}")
    copies = cold_copies(inp, g)
    call = {route: lambda on_narrow=route == "narrow": mk._launch_bwd(
                ws, *next(copies), dims, 1, 0, narrow=on_narrow) for route in ("narrow", "wide")}
    out = {"dims": dims, "rows": inp.shape[0], "max_rel_err": max(v["rel"] for v in leaves),
           **route_times(call, {"narrow": "mlp_bwd_kernel", "wide": "mlp_wide_kernel"})}
    print(f"kernel fused_mlp_bwd {what} ({dims}, {inp.shape[0]} rows), narrow / wide route: "
          f"device {out['narrow_kernel_ms']} / {out['wide_kernel_ms']} ms (calls "
          f"{out['narrow_call_ms']} / {out['wide_call_ms']}); leaves within "
          f"{out['max_rel_err']:.2e} of max |narrow|")
    return out


def check_one_launch(ws, inp) -> dict:
    """One fused_mlp call on the card under torch.profiler: one device
    kernel, kernel B, and no PyTorch op besides the output's allocation
    (no copy, cast, pad or concatenation of x or of the weights)."""
    from torch.profiler import ProfilerActivity, profile

    from instant_ngp_torch.ops.mlp_kernel import fused_mlp

    fused_mlp(ws, inp)
    torch.cuda.synchronize()
    # a trace with no device event at all is a dropped trace: take it again
    for _ in range(10):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fused_mlp(ws, inp)
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if kernels:
            break
    ops = sorted({e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU
                  and e.name.startswith("aten::")})
    check(len(kernels) == 1 and KERNEL_NAMES["fused_mlp"] in kernels[0],
          f"one fused_mlp call ran the device kernels {kernels}")
    check(set(ops) <= {"aten::empty"}, f"one fused_mlp call ran the PyTorch ops {ops}")
    return {"device_kernels": kernels, "torch_ops": ops}


WIDE_F_KERNELS = ("pack_layer", "mlp_wide_kernel", "mlp_dw_kernel", "dw_reduce")


def check_wide_f_launches(ws, x, g, act: str, out_act: str) -> dict:
    """One wide F call on the card under torch.profiler: its device kernels
    are the port's (the packing, F's kernel, the dW kernel and its
    reduction: no library product such as cuBLAS's), and it makes no
    PyTorch matrix product."""
    from torch.profiler import ProfilerActivity, profile

    from instant_ngp_torch.ops.mlp_kernel import fused_mlp_bwd

    fused_mlp_bwd(ws, x, g, act, out_act)
    torch.cuda.synchronize()
    # a trace with no device event at all is a dropped trace: take it again (in
    # one run of the whole script three traces in a row were dropped here)
    for _ in range(10):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fused_mlp_bwd(ws, x, g, act, out_act)
            torch.cuda.synchronize()
        kernels = sorted({e.name for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA})
        if kernels:
            break
    ops = sorted({e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU
                  and e.name.startswith("aten::")})
    foreign = [k for k in kernels if not any(n in k for n in WIDE_F_KERNELS)]
    check(bool(kernels) and not foreign, f"a wide F call ran device kernels not the port's: {foreign}")
    matmuls = [o for o in ops if o in ("aten::mm", "aten::matmul", "aten::bmm", "aten::addmm")]
    check(not matmuls, f"a wide F call ran PyTorch matrix products: {matmuls}")
    return {"device_kernels": [k[:60] for k in kernels], "torch_ops": ops}


def dw_bound(hs, dzs, dims) -> dict:
    """The dW kernel's least time: h_i and dz_i read once as the bf16 values
    F wrote (dz_i as its terms where it has three), every dW written in f32;
    two operations a product of each term's bf16 values."""
    terms = [int(dz.ne(dz.to(torch.bfloat16).float()).any()) * 2 + 1 for dz in dzs]
    n = hs[0].shape[0]
    n_bytes = 2 * n * sum(h.shape[1] + dz.shape[1] * t for h, dz, t in zip(hs, dzs, terms)) + \
        4 * sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    n_ops = 2 * n * sum(a * b * t for a, b, t in zip(dims[:-1], dims[1:], terms))
    return {**bound(n_bytes, n_ops, "bfloat16"), "bytes": n_bytes, "ops": n_ops}


def check_wide_dw(ws, x, g, act: str, out_act: str, what: str) -> dict:
    """The wide F's dW kernel on the h_i and dz_i F's first launch wrote,
    against ``mlp_dw_plain`` on the same values, every dW_i within
    TOL_MLP_BWD of its own max |ref|, and equal to the dW ``fused_mlp_bwd``
    returns (the same kernel, no atomics: the same bits); its device time
    (both of its kernels), the plain version's, and ``torch.mm`` of the same
    f32 products, one a layer (the library yardstick, which the port does
    not call)."""
    from instant_ngp_torch.ops import mlp_kernel as mk

    dims = (ws[0].shape[0], *[w.shape[1] for w in ws])
    n = x.shape[0]
    hs, dzs, bufs = mk.wide_intermediates(ws, x, g, act, out_act)
    dws = mk.wide_dw(bufs, dims, act, n)
    refs = [mk.mlp_dw_plain(h, dz) for h, dz in zip(hs, dzs)]
    rels = []
    for i, (o, r) in enumerate(zip(dws, refs)):
        err, scale = max_err(o, r)
        rels.append(err / scale if scale > 0 else (0.0 if err == 0 else float("inf")))
        check(err <= TOL_MLP_BWD * scale, f"dW {what}: layer {i} err {err} at max |ref| {scale}")
    _, dws_call = mk.fused_mlp_bwd(ws, x, g, act, out_act)
    check(all(torch.equal(a, b) for a, b in zip(dws, dws_call)),
          f"dW {what}: the dW kernel's bits differ between two calls")
    dev = device_split(lambda: mk.wide_dw(bufs, dims, act, n), "dw", reps=CONFIG_REPS)
    lib = device_split(lambda: [torch.mm(h.T, dz) for h, dz in zip(hs, dzs)], "",
                       reps=CONFIG_REPS)
    return {"max_abs_err": max(float((o - r).abs().max()) for o, r in zip(dws, refs)),
            "max_rel_err": max(rels), "ms": dev["device_ms"],
            "plain_ms": time_ms(lambda: [mk.mlp_dw_plain(h, dz) for h, dz in zip(hs, dzs)],
                                reps=CONFIG_REPS, warmup=1),
            "library_ms": lib["device_ms"], **dw_bound(hs, dzs, dims)}


def check_fwd_bwd_pair(ws, inp, what: str) -> dict:
    """Kernel B's forward against kernel F's forward recompute on (ws,
    inp): every layer's f32 pre-activation bit for bit (B through the
    first i layers with output activation none, against F's record), so
    that F differentiates the network B ran."""
    from instant_ngp_torch.ops.mlp_kernel import fused_mlp, mlp_recompute

    zs = mlp_recompute(ws, inp)
    for i, z in enumerate(zs):
        zb = fused_mlp(ws[:i + 1], inp, "relu", "none")
        rows = int((zb != z).any(dim=1).sum())
        check(torch.equal(zb, z), f"{what}: B and F's recompute differ at layer {i} in {rows} rows")
    print(f"kernels B and F ({what}, {inp.shape[0]} rows): the pre-activations of all {len(zs)} "
          f"layers equal bit for bit")
    return {"rows": inp.shape[0], "layers": len(zs), "bit_equal": True}


def near_tie_rows(ws, inp) -> torch.Tensor:
    """(N,) bool: rows of inp where a hidden pre-activation z of the plain
    forward lies within one bf16 step of 0, |z| ≤ 2^-7 · max_k |h_k| ·
    max_k |w_k|: one bf16 step of an input h_k (≤ 2^-7 |h_k|) moves z by at
    most that much. Kernel F's tensor-core sums and the plain version's
    matmul can round an upstream hidden value a step apart, so such a row's
    ReLU mask may differ between the two, and its dX by a whole branch."""
    def bf16(t):
        return t.to(torch.bfloat16).float()

    h = bf16(inp)
    near = torch.zeros(inp.shape[0], dtype=torch.bool, device=inp.device)
    for w in ws[:-1]:
        wb = bf16(w)
        z = h @ wb
        step = 2.0**-7 * h.abs().amax(dim=1, keepdim=True) * wb.abs().amax(dim=0, keepdim=True)
        near |= (z.abs() <= step).any(dim=1)
        h = bf16(torch.clamp(z, min=0.0))
    return near


def check_mlp_bwd_trained(ws, inp, g, what: str) -> dict:
    """Kernel F against its plain version on a trained MLP's inputs, the
    rows near a ReLU tie (``near_tie_rows``) left out; every row whose ReLU
    mask differs between F's recompute and the plain forward must be one of
    them."""
    from instant_ngp_torch.ops.mlp_kernel import fused_mlp_plain, mlp_recompute

    near = near_tie_rows(ws, inp)
    flipped = torch.zeros_like(near)
    for i, zk in enumerate(mlp_recompute(ws, inp)[:-1]):
        zp = fused_mlp_plain(ws[:i + 1], inp, "relu", "none")
        flipped |= ((zk > 0) != (zp > 0)).any(dim=1) | ((zk == 0) != (zp == 0)).any(dim=1)
    check(not bool((flipped & ~near).any()),
          f"{what}: {int((flipped & ~near).sum())} rows whose ReLU mask differs are not masked")
    keep = ~near
    v = check_mlp_bwd(ws, inp[keep].contiguous(), g[keep].contiguous(), what)
    v["masked_rows"], v["mask_differs_rows"] = int(near.sum()), int(flipped.sum())
    print(f"kernel fused_mlp_bwd on {what} ({inp.shape[0]} rows; {v['masked_rows']} within one "
          f"bf16 step of a ReLU tie left out, {v['mask_differs_rows']} of them with a ReLU mask "
          f"that differs): max_abs_err {v['max_abs_err']:.3e} kernel {v['ms']:.3f} ms plain "
          f"{v['plain_ms']:.3f} ms")
    return v


def composite_train_args(task, out, ts, dts, valid, target, bg, pixel_ok,
                         mean_density) -> tuple:
    """Kernel G's arguments for a window's network outputs (R, K, 4), its
    march and its pixels, with the task's loss, activations and regularizer,
    as ``nerf_train.step_gradients`` forms them."""
    from instant_ngp_torch.nerf import train as nerf_train

    R = ts.shape[0]
    return (out.contiguous(), ts.contiguous(), dts.contiguous(), valid.contiguous(),
            target.contiguous(), bg.contiguous(), pixel_ok.contiguous(), mean_density,
            task.training_near_distance, task.density_reg_scale * nerf_train.INV_LOSS_SCALE,
            float(np.float32(1.0) / np.float32(R)), task.loss_type, task.rgb_activation,
            task.density_activation)


def random_pixels(R: int, gen) -> tuple:
    """R random target pixels and backgrounds, 5 % of the pixels masked."""
    return (torch.rand((R, 3), generator=gen, device=gen.device),
            torch.rand((R, 3), generator=gen, device=gen.device),
            torch.rand((R,), generator=gen, device=gen.device) > 0.05)


def seed_composite_train_args(task, R: int, K: int, gen, mean_density=None) -> tuple:
    """Kernel G's arguments on random inputs: outputs N(0, 2^2), a valid
    prefix of 0..K samples a ray, distances from 0.05 (some nearer than the
    near distance) in random steps, random dts; mean_density None: a foggy
    grid (0, below the optical-thickness floor)."""
    device = gen.device
    n_valid = torch.randint(0, K + 1, (R, 1), generator=gen, device=device)
    valid = torch.arange(K, device=device)[None, :] < n_valid
    steps = torch.rand((R, K), generator=gen, device=device) * 0.03
    ts = torch.where(valid, 0.05 + torch.cumsum(steps, dim=1), 0.0)
    dts = torch.where(valid, torch.rand((R, K), generator=gen, device=device) * 0.02 + 0.002, 0.0)
    out = torch.randn((R, K, 4), generator=gen, device=device) * 2.0
    if mean_density is None:
        mean_density = torch.zeros((), device=device)
    return composite_train_args(task, out, ts, dts, valid, *random_pixels(R, gen), mean_density)


@torch.no_grad()
def composite_train_rounding(gargs) -> torch.Tensor:
    """A first-order bound on the f32 rounding error of each element of G's
    d/d out (R, K, 4), in float64 from G's inputs: gamma_K = K·2^-24 times
    the magnitudes that G's f32 sums and exponents carry. The exponent
    −cumsum(tau)_k + tau_k of T_k carries u·S_k, S the inclusive cumsum,
    whatever the order of the sum, so T_k, e_k and w_k carry a relative
    (1 + S_k)·gamma_K; rgb carries their sum E of the w_k·|c_k| so weighted;
    G = d loss / d rgb carries its slope times E (rgb − target cancels where
    the model fits); the suffix rgb − Σ_{j≤k} w_j·c_j carries the rounding
    of both sums and the errors of the w_j past k."""
    from instant_ngp_torch.common import (EPS_T, network_to_density, network_to_density_grad,
                                          network_to_rgb, network_to_rgb_grad)
    from instant_ngp_torch.ops.losses import HUBER_ALPHA, LossType

    out, ts, dts, valid, target, bg, pixel_ok = (a.double() if a.dtype == torch.float32 else a
                                                  for a in gargs[:7])
    inv_n_rays, loss_type, rgb_act, density_act = gargs[10:14]
    K = ts.shape[1]
    x, s = out[..., :3], out[..., 3]
    c = network_to_rgb(x, rgb_act)
    tau = torch.where(valid, network_to_density(s, density_act), 0.0) * dts
    S = torch.cumsum(tau, dim=1)
    T, e = torch.exp(-S + tau), torch.exp(-tau)
    w = (1.0 - e) * T
    wc, w_abs_c = w[..., None] * c, w[..., None] * c.abs()
    T_final = torch.exp(-S[:, -1])
    rgb = wc.sum(dim=1) + torch.where(T_final >= EPS_T, T_final, 0.0)[:, None] * bg
    rgb_mag = w_abs_c.sum(dim=1) + T_final[:, None] * bg.abs()
    cond = 1.0 + S
    carried = torch.cumsum(w_abs_c * cond[..., None], dim=1)
    E = carried[:, -1] + T_final[:, None] * bg.abs() * cond[:, -1:]
    ct = (inv_n_rays * pixel_ok.double() / 3.0)[:, None]
    d = rgb - target
    if loss_type == LossType.HUBER:
        small = d.abs() <= HUBER_ALPHA
        G, slope = torch.where(small, 2.0 * ct * d, ct / 5.0 * torch.sign(d)), 2.0 * ct * small
    else:
        G, slope = 2.0 * ct * d, 2.0 * ct.expand_as(d)
    Tec = (T * e)[..., None] * c
    suffix = rgb[:, None, :] - torch.cumsum(wc, dim=1)
    suffix_err = (rgb_mag[:, None, :] + torch.cumsum(w_abs_c, dim=1)
                  + E[:, None, :] - carried + Tec.abs() * cond[..., None])
    ds = (dts * network_to_density_grad(s, density_act)).abs() * torch.sum(
        (slope * E)[:, None, :] * (Tec - suffix).abs() + G.abs()[:, None, :] * suffix_err, dim=-1)
    dx = (((slope * E)[:, None, :] + G.abs()[:, None, :] * cond[..., None]) * w[..., None]
          * network_to_rgb_grad(x, rgb_act).abs())
    return K * 2.0 ** -24 * torch.cat([dx, ds[..., None]], dim=-1)


def check_composite_train(gargs) -> dict:
    """Kernel G against its plain version evaluated in float64 on gargs:
    within TOL_COMPOSITE_TRAIN of max |ref|, d/d out within that plus each
    element's f32 rounding bound; the f32 plain version's distance from the
    same reference is reported beside. A second call bit for bit equal to
    the first. Returns error, times, device time and bound."""
    from instant_ngp_torch.nerf import train as nerf_train

    errs, plain_errs, used = [], [], []
    outs = nerf_train.composite_train(*gargs)
    again = nerf_train.composite_train(*gargs)
    R, K = gargs[1].shape
    check(all(torch.equal(a, b) for a, b in zip(outs, again)),
          f"G R {R} K {K}: two calls on the same inputs differ")
    exact = nerf_train.composite_train_plain(*[
        a.double() if torch.is_tensor(a) and a.dtype == torch.float32 else a for a in gargs])
    rounding = composite_train_rounding(gargs)
    plain = nerf_train.composite_train_plain(*gargs)
    for i, (k_out, p_out, x_out) in enumerate(zip(outs, plain, exact)):
        err, scale = max_err(k_out, x_out)
        plain_errs.append(max_err(p_out, x_out)[0])
        allowed = TOL_COMPOSITE_TRAIN * scale + (rounding if i == 1 else 0.0)
        worst = float(((k_out.double() - x_out).abs() / allowed).max())
        used.append(worst)
        check(worst <= 1.0, f"G R {R} K {K}: output {i} at {worst:.3f} of its allowance (err "
                            f"{err} at max |ref| {scale}, the f32 plain version's {plain_errs[-1]})")
        errs.append(err)
    scale = float(exact[1].abs().max())
    return {"shape": f"R {R}, K {K}", "max_abs_err": max(errs), "plain_f32_err": max(plain_errs),
            "allowance_used": max(used), "rounding_max_share": float(rounding.max()) / scale,
            "rounding_over_tol": int((rounding > TOL_COMPOSITE_TRAIN * scale).sum()),
            "ms": time_ms(lambda: nerf_train.composite_train(*gargs)),
            "plain_ms": time_ms(lambda: nerf_train.composite_train_plain(*gargs)),
            **device_split(lambda: nerf_train.composite_train(*gargs), "composite_train"),
            **bound(nbytes(*[a for a in gargs if torch.is_tensor(a)], *outs))}


# kernel H's device time per call under the profiler, all of it and its
# kernel alone, and the same of the library call (zeros + index_add_)
H_DEVICE_KEYS = ("device_ms", "kernel_device_ms", "library_device_ms", "library_kernel_device_ms")


def check_scatter(idx, vals, size: int, what: str, into=None) -> dict:
    """Kernel H against its plain version: into zeros (``scatter_add_rows``),
    or, given the (size, F) map ``into``, added into a copy of it in place
    (``scatter_add_rows_``, the training path's form); beside it the library
    call, index_add_ into zeros or in place. Error, times back to back and
    device times (H_DEVICE_KEYS); the bound reads idx and vals once and
    writes the output once (in place: reads and writes the rows idx hits)."""
    from instant_ngp_torch.ops import scatter as sc

    idx64, F = idx.to(torch.int64), vals.shape[1]
    if into is None:
        out, ref = sc.scatter_add_rows(idx, vals, size), sc.scatter_add_rows_plain(idx, vals, size)
        out_bytes = size * F * 4

        def kernel():
            return sc.scatter_add_rows(idx, vals, size)

        def plain():
            return sc.scatter_add_rows_plain(idx, vals, size)

        def library():  # one PyTorch call beside the zeroed output both make
            return torch.zeros((size, F), device=vals.device).index_add_(0, idx64, vals)
    else:
        out = sc.scatter_add_rows_(into.clone(), idx, vals)
        ref = sc.scatter_add_rows_plain_(into.clone(), idx, vals)
        out_bytes = 2 * int(torch.unique(idx).numel()) * F * 4
        work = into.clone()

        def kernel():
            return sc.scatter_add_rows_(work, idx, vals)

        def plain():
            return sc.scatter_add_rows_plain_(work, idx, vals)

        def library():
            return work.index_add_(0, idx64, vals)
    err, scale = max_err(out, ref)
    check(err <= TOL_SCATTER * max(1.0, scale), f"H {what} err {err} at max |ref| {scale}")
    k, lib = device_split(kernel, "scatter_add"), device_split(library, "index")
    return {"max_abs_err": err, "ms": time_ms(kernel), "plain_ms": time_ms(plain),
            "library_ms": time_ms(library), "device_ms": k["device_ms"],
            "kernel_device_ms": k["kernel_ms"], "library_device_ms": lib["device_ms"],
            "library_kernel_device_ms": lib["kernel_ms"],
            **bound(nbytes(idx, vals) + out_bytes, vals.numel())}


def step_check(task, device, what: str = "fox") -> dict:
    """One training step's gradients through the kernels against the same
    step through the plain versions, at the main path's ray count and at
    the adaptive ceiling, where the step packs its valid samples into the
    capacity. Then kernels G and H against their plain versions on the main
    path's step's own inputs: its window's composite and its error-map
    deposit, and G on the ceiling's step too. Returns those checks by kernel
    name (G at the ceiling as ``composite_train_ceiling``); ``what`` names
    the path in what it prints."""
    from instant_ngp_torch.nerf import train as nerf_train

    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    ceiling = 1 << task.max_ray_bucket_log2
    K = task.march_cfg.max_samples_per_ray
    check(ceiling * K > task.compact_samples, "the ceiling's step does not pack its samples")
    for n_rays in dict.fromkeys((ceiling, task.n_rays_current)):
        draws = nerf_train.draw_step(task, gen, n_rays, task.cdf_valid)
        batch = nerf_train.march_batch(task, draws)
        step_gradients_check(task, draws, batch, what)
        if n_rays == ceiling:
            at_ceiling = check_composite_train(step_composite_args(task, draws, batch))
    return {**main_path_checks(task, draws, batch, what), "composite_train_ceiling": at_ceiling}


def step_gradients_check(task, draws, batch, what: str) -> None:
    """The step's gradients and loss, kernels against plain versions, from
    the same state, draws and march, with stochastic (1 corner) and exact
    table gradients."""
    from instant_ngp_torch.nerf import train as nerf_train

    R, K = batch.ts.shape
    packed = (f", {int(batch.n_valid.sum())} valid samples packed into {task.compact_samples} rows"
              if R * K > task.compact_samples else "")
    enc = task.model.pos_encoding
    corners_before = enc.hashed_grad_corners
    for corners in (1, 8):
        enc.hashed_grad_corners = corners
        runs = {}
        for use_kernels in (True, False):
            task.set_use_kernels(use_kernels)
            runs[use_kernels] = nerf_train.step_gradients(task, draws, batch)[:2]
        task.set_use_kernels(True)
        (grads, per_ray), (grads_p, per_ray_p) = runs[True], runs[False]
        errs = [float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))
                for a, b in zip(grads, grads_p)]
        loss, loss_p = float(per_ray.mean()), float(per_ray_p.mean())
        loss_err = abs(loss - loss_p) / abs(loss_p)
        print(f"{what} train step kernels vs plain, {corners} corner(s), {R} rays{packed}: "
              f"grad ||k - p|| / ||p|| per leaf {[f'{e:.2e}' for e in errs]}, "
              f"loss {loss:.6f} vs {loss_p:.6f}")
        check(all(e <= TOL_STEP_GRAD for e in errs), f"step gradients differ: {errs}")
        check(loss_err <= TOL_STEP_LOSS, f"step loss differs: {loss} vs {loss_p}")
    enc.hashed_grad_corners = corners_before


def step_composite_args(task, draws, batch) -> tuple:
    """Kernel G's arguments of a step: the network outputs on its window
    (after packing) and its targets."""
    from instant_ngp_torch.nerf import train as nerf_train

    with torch.no_grad():
        out, valid = nerf_train.eval_samples(task, batch)
    return composite_train_args(task, out, batch.ts, batch.dts, valid,
                                *nerf_train.targets(task, draws, batch.uv),
                                task.state.grid.mean_density)


def main_path_checks(task, draws, batch, what: str) -> dict:
    """Kernels G and H against their plain versions on a step's own inputs."""
    from instant_ngp_torch.nerf import train as nerf_train

    gargs = step_composite_args(task, draws, batch)
    main = {"composite_train": check_composite_train(gargs)}
    main["fwd_bwd_pair"] = nerf_pair_checks(task, batch, what)
    per_ray = nerf_train.composite_train(*gargs)[0]
    corners, vals = nerf_train.error_deposit(task, draws.img_idx, batch.uv, per_ray, draws.pdf)
    emap = task.state.error_map.reshape(-1, 1)
    size = emap.shape[0]
    # the path's form, straight into the map, and into zeros as the probes run
    zeros = check_scatter(corners, vals, size, "error-map deposit into zeros")
    main["scatter_add_rows"] = {"shape": f"{corners.shape[0]} rows of 1 into the {size}-cell map",
                                **check_scatter(corners, vals, size, "error-map deposit", emap),
                                "into_zeros": zeros}
    for name in ("composite_train", "scatter_add_rows"):
        v = main[name]
        print(f"kernel {name} on the {what} main path's step ({v['shape']}): max_abs_err "
              f"{v['max_abs_err']:.3e} kernel {v['ms']:.3f} ms plain {v['plain_ms']:.3f} ms")
    v = main["composite_train"]
    print(f"G on the {what} step against float64: the f32 plain version's error "
          f"{v['plain_f32_err']:.3e}, {v['allowance_used']:.4f} of G's allowance used; the "
          f"rounding bound passes {TOL_COMPOSITE_TRAIN} of max |ref| on {v['rounding_over_tol']} "
          f"elements, at most {v['rounding_max_share']:.4f} of it")
    return main


@torch.no_grad()
def nerf_pair_checks(task, batch, what: str) -> dict:
    """check_fwd_bwd_pair for both MLPs of the trained model on a step's
    own inputs: the encodings of its samples, and the density output beside
    the SH encoding of their directions."""
    from instant_ngp_torch.nerf import train as nerf_train
    from instant_ngp_torch.ops.hashgrid import hashgrid_encode
    from instant_ngp_torch.ops.mlp_kernel import fused_mlp

    model = task.model
    enc = model.pos_encoding
    pos, dirs, _ = nerf_train.sample_inputs(task, batch)
    feats = hashgrid_encode(enc.levels, enc.interpolation, enc.table.detach(), pos)
    density_ws = [w.detach() for w in model.density_network.weights]
    rgb_ws = [w.detach() for w in model.rgb_network.weights]
    rgb_in = torch.cat([fused_mlp(density_ws, feats), model.dir_encoding(dirs)], dim=-1)
    return {"density": check_fwd_bwd_pair(density_ws, feats, f"trained {what} density MLP"),
            "rgb": check_fwd_bwd_pair(rgb_ws, rgb_in, f"trained {what} rgb MLP")}


# each launcher's kernel function, as the profiler names it
KERNEL_NAMES = {"hashgrid_encode_fwd": "hashgrid_encode_kernel", "fused_mlp": "fused_mlp_kernel",
                "march_rays": "march_rays_kernel", "composite_window": "composite_window_kernel",
                "hashgrid_encode_bwd": "hashgrid_bwd_kernel", "fused_mlp_bwd": "mlp_bwd_kernel",
                "composite_train": "composite_train_kernel",
                "scatter_add_rows": "scatter_add_kernel", "take_rows": "take_rows_kernel",
                "bilinear_read": "bilinear_read_kernel",
                "gather_cols_sum": "gather_cols_sum_",
                "gather_cols_transpose": "gather_cols_transpose",
                "hashgrid_encode_dx": "hashgrid_dx_kernel",
                "volume_generate_batch": "volume_generate_batch_kernel",
                "volume_trace_gt": "volume_trace_gt_kernel"}


def profile_frames(trainer, events_seen: dict | None = None) -> tuple[float, float, list, dict]:
    """(wall ms, device busy ms, top device items (name, ms), device ms per
    frame of each port kernel by launcher) of PROFILED_STEPS training frames
    under torch.profiler; busy is the union of the device events'
    intervals, None where the profiler dropped the trace (no device event
    at all: ``busy_text`` says "not measured"). ``events_seen``, where given,
    gets each launcher's number of device events in the trace: a frame's ms
    counts only the launches the trace caught."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED_STEPS):
            trainer.frame()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end) for e in events):
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    by_name: dict = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    kernels = {launcher: sum(ms for name, ms in by_name.items() if sub in name) / PROFILED_STEPS
               for launcher, sub in KERNEL_NAMES.items()}
    if events_seen is not None:
        events_seen.update({launcher: sum(sub in e.name for e in events)
                            for launcher, sub in KERNEL_NAMES.items()})
    return (wall_ms, busy_us / 1e3 if events else None, [(name[:80], ms) for name, ms in top],
            kernels)


def busy_text(wall_ms: float, busy_ms) -> str:
    """A profiled window's device busy time and idle share, for a print."""
    if busy_ms is None:
        return "device busy and idle share not measured (the profiler dropped the trace)"
    return f"device busy {busy_ms:.3f} ms, idle share {1.0 - busy_ms / wall_ms:.3f}"


def train_phase(tb, device, card) -> tuple[list[dict], dict, dict, dict]:
    """The training path. Returns (the E-H records, the training march's
    record, the launches of the training run, B against F's recompute on
    the trained model)."""
    from instant_ngp_torch import cuda_lib
    from instant_ngp_torch.nerf.task import NerfTask
    from instant_ngp_torch.testbed import Testbed

    t0 = time.perf_counter()
    ds = render_training_set(tb)
    print(f"training set: {ds.n_images} views at {ds.resolution[0]}x{ds.resolution[1]}, "
          f"rendered in {time.perf_counter() - t0:.2f} s")
    trainer = Testbed("nerf", device=device)
    trainer.nerf_dataset, trainer.network_config = ds, fox_train_config()
    trainer.task = NerfTask(ds, trainer.network_config, device, seed=SEED,
                            target_batch_size=TARGET_BATCH, n_rays_per_batch=TRAIN_RAYS,
                            max_samples_per_ray=TRAIN_K, n_march_iters=TRAIN_ITERS)
    task = trainer.task
    results, march = train_kernel_checks(tb, task, device)
    before = eval_views(task, ds)

    # the main path: TRAIN_STEPS frames, the last PROFILED_STEPS traced
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    step_ms, n_rays, fills = [], [], []
    for _ in range(TRAIN_STEPS - PROFILED_STEPS):
        t0 = time.perf_counter()
        trainer.frame()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        n_rays.append(task.n_rays_current)  # the count this step marched
        if task.training_step % task.grid_update_interval == 0:  # what sizes the next count
            fills.append(int(task.last_stats["measured_samples"]) / (n_rays[-1] * TRAIN_K))
    wall_ms, busy_ms, top, step_kernels = profile_frames(trainer)
    torch.cuda.synchronize()
    launches = dict(cuda_lib.LAUNCHES)
    print(f"train launches: {launches}")
    print(f"train device ms per step by port kernel (last {PROFILED_STEPS} steps): {step_kernels}")
    march["train_step_device_ms"] = step_kernels["march_rays"]
    losses = trainer.loss_graph
    first, last = np.mean(losses[:LOSS_WINDOW]), np.mean(losses[-LOSS_WINDOW:])
    print(f"train {len(losses)} steps: median {statistics.median(step_ms):.3f} ms/step "
          f"(min {min(step_ms):.3f}, max {max(step_ms):.3f}) on {card}; loss first "
          f"{LOSS_WINDOW} {first:.6f}, last {LOSS_WINDOW} {last:.6f}")
    compacted = sum(r * TRAIN_K > task.compact_samples for r in n_rays)
    print(f"rays per batch at steps 0, 16, 32, ...: {n_rays[::task.grid_update_interval]}; "
          f"valid samples per ray slot at steps 15, 31, ...: {[round(f, 4) for f in fills]}; "
          f"{compacted} of {len(n_rays)} steps packed their samples into "
          f"{task.compact_samples} rows")
    print(f"profiled {PROFILED_STEPS} steps: wall {wall_ms:.3f} ms, {busy_text(wall_ms, busy_ms)}; "
          f"top device items (ms): {top}")
    check(not task.training_aborted and len(losses) == TRAIN_STEPS, "training stopped early")
    check(all(np.isfinite(losses)), "a training loss is not finite")
    check(last <= MAX_LOSS_RATIO * first, f"loss fell from {first} to {last} only")
    check(all(launches[k] > 0 for k in TRAIN_KERNELS), f"a kernel was not launched: {launches}")

    main = step_check(task, device)
    pair = main.pop("fwd_bwd_pair")
    at_ceiling = main.pop("composite_train_ceiling")
    for r in results:
        if r["name"] in main:
            take_main_path(r, main[r["name"]])
        if r["name"] == "composite_train":
            r["variants"]["step_ceiling"] = at_ceiling
            r["max_abs_err"] = max(r["max_abs_err"], at_ceiling["max_abs_err"])
        if r["name"] == "scatter_add_rows":
            r["deposit_launches_per_step"] = launches["scatter_add_rows"] / TRAIN_STEPS
            r["step_device_ms"] = step_kernels["scatter_add_rows"]
    after = eval_views(task, ds)
    for i, (lb, pb), (la, pa) in zip(EVAL_VIEWS, before[0], after[0]):
        print(f"view {i}: loss {lb:.6f} -> {la:.6f}, PSNR {pb:.2f} -> {pa:.2f} dB")
    print(f"views {EVAL_VIEWS}: PSNR of the mean MSE {before[1]:.2f} -> {after[1]:.2f} dB")
    check(after[1] - before[1] >= MIN_PSNR_GAIN_DB,
          f"PSNR rose from {before[1]:.2f} to {after[1]:.2f} dB only")
    return results, march, launches, pair


# the disk phase: io/synthetic.py's scene at its defaults (24 train and 4
# test views, 512 integration steps, seed 7) but at DISK_RES^2: at its
# 256^2 the generator takes more than 60 s on the card machine's host
DISK_RES = 128
DISK_STEPS = 300
DISK_MORE_STEPS = 20  # frames after the snapshot loads onto the scene
DISK_TRAIN_VIEWS = (0, 6, 12, 18)
# PSNR gains over the 4 test views and DISK_TRAIN_VIEWS. Both packages start a
# render ray on its crop-box face, and about half of the object's pixels of
# test view 2 and training views 12 and 18 render transparent (ROADMAP.md
# Queue 3), which caps the gains. The JAX package's own gains under this
# protocol at DISK_RES^2, seeds 1337 / 1 / 2 (tests/compare_disk_training.py
# --package jax, CPU); the port is held to the least of them less its spread
# on the card (test split 3.34-4.26 dB, training views 5.35-5.64 over 4 runs)
JAX_DISK_GAINS_DB = {"test": (3.94, 3.77, 4.13), "train": (5.43, 5.47, 5.50)}
MIN_DISK_GAIN_DB = {"test": min(JAX_DISK_GAINS_DB["test"]) - 1.0,
                    "train": min(JAX_DISK_GAINS_DB["train"]) - 0.5}
MIN_LOADED_PSNR_DB = 40.0  # a scene-free load's render against the saved task's


def paeth_decode_ms(res: int) -> float:
    """Milliseconds to decode one res^2 RGBA PNG whose every row uses the
    Paeth filter, the slowest of ``io/png.py``'s paths (a loop a byte)."""
    from instant_ngp_torch.io.png import decode_png, encode_png

    rng = np.random.default_rng(SEED)
    data = encode_png(rng.integers(0, 256, (res, res, 4), dtype=np.uint8), filter_type=4)
    t0 = time.perf_counter()
    decode_png(data)
    return (time.perf_counter() - t0) * 1e3


def split_psnr(task, test) -> tuple[float, float]:
    """PSNR of the mean MSE over every view of the test split and over
    DISK_TRAIN_VIEWS, each rendered at spp 1 on black against its image
    (both premultiplied sRGB)."""
    return (eval_views(task, test, range(test.n_images))[1],
            eval_views(task, task.dataset, DISK_TRAIN_VIEWS)[1])


def state_bits_equal(saved, loaded) -> None:
    """The loaded task's parameters (the saved ones rounded to fp16),
    optimizer state and, for NeRF, density grid (rounded to fp16) against
    the saved task's, bit for bit."""
    fp16 = lambda t: t.detach().to(torch.float16).to(torch.float32)  # noqa: E731
    for a, b in zip(saved.model.param_list(), loaded.model.param_list()):
        check(torch.equal(fp16(a), b.detach()), "a loaded parameter differs from the saved fp16")
    nerf = hasattr(saved, "state")
    so, lo = (saved.state.opt_state, loaded.state.opt_state) if nerf else (saved.opt_state,
                                                                          loaded.opt_state)
    check(so["step"] == lo["step"] and saved.training_step == loaded.training_step,
          f"steps {so['step']}/{saved.training_step} against {lo['step']}/{loaded.training_step}")
    check(so.keys() == lo.keys(), f"optimizer states {sorted(so)} against {sorted(lo)}")
    for key in ("m", "v", "ema"):
        check(all(torch.equal(a, b) for a, b in zip(so.get(key, ()), lo.get(key, ()))),
              f"the loaded optimizer's {key} differs")
    if nerf:
        check(torch.equal(fp16(saved.state.grid.density), loaded.state.grid.density),
              "the loaded density grid differs from the saved fp16")


def disk_kernel_checks(task, device) -> dict:
    """Kernels A-C and E-H against their plain versions at the disk path's
    shapes: the trained scene's grid and tables, linear interpolation, its
    K and march iterations, its last ray count. The step's gradients and G
    and H on a step's own inputs (``step_check``); C on a step's march
    arguments; A, B, E and F on that step's packed samples, F with the rows
    near a ReLU tie left out (``check_mlp_bwd_trained``). Returns {kernel
    name: {variant: check}}."""
    from instant_ngp_torch.nerf import train as nerf_train
    from instant_ngp_torch.ops.hashgrid import hashgrid_encode
    from instant_ngp_torch.ops.mlp_kernel import fused_mlp

    main = step_check(task, device, "disk")
    out = {"composite_train": {"disk_step": main["composite_train"],
                               "disk_step_ceiling": main["composite_train_ceiling"]},
           "scatter_add_rows": {"disk_step": main["scatter_add_rows"]},
           "fwd_bwd_pair": main["fwd_bwd_pair"]}
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    draws = nerf_train.draw_step(task, gen, task.n_rays_current, task.cdf_valid)
    batch = nerf_train.march_batch(task, draws)
    cfg = task.march_cfg
    margs = (batch.o, batch.d, task.state.grid.skipmip, *task._aabb_t, draws.jitter, cfg)
    march = check_march(margs, None, "disk step march")
    out["march_rays"] = {"disk_step": march}
    with torch.no_grad():
        pos, dirs, _ = nerf_train.sample_inputs(task, batch)
        model, enc = task.model, task.model.pos_encoding
        table = enc.table.detach()
        out["hashgrid_encode_fwd"] = {"disk_step": check_encode(
            enc.levels, enc.interpolation, table, pos, "disk step")}
        g = torch.randn((pos.shape[0], enc.n_output_dims), generator=gen, device=device)
        out["hashgrid_encode_bwd"] = {f"disk_step_corners{k}": check_encode_bwd(
            enc.levels, enc.interpolation, pos, g, enc.n_entries, k, f"disk step, {k} corner(s)")
            for k in (1, 8)}
        feats = hashgrid_encode(enc.levels, enc.interpolation, table, pos)
        density_ws = [w.detach() for w in model.density_network.weights]
        rgb_ws = [w.detach() for w in model.rgb_network.weights]
        rgb_in = torch.cat([fused_mlp(density_ws, feats), model.dir_encoding(dirs)], dim=-1)
        out["fused_mlp"], out["fused_mlp_bwd"] = {}, {}
        for what, ws, inp in (("density", density_ws, feats), ("rgb", rgb_ws, rgb_in)):
            out["fused_mlp"][f"disk_step_{what}"] = check_mlp(ws, inp, f"disk step {what}")
            g = torch.randn((inp.shape[0], ws[-1].shape[1]), generator=gen, device=device)
            # a trained MLP: the rows within a bf16 step of a ReLU tie left out
            out["fused_mlp_bwd"][f"disk_step_{what}"] = check_mlp_bwd_trained(
                ws, inp, g, f"disk step {what}")
    errs = {k: max(v["max_abs_err"] for v in vs.values())
            for k, vs in out.items() if k != "fwd_bwd_pair"}
    print(f"disk kernels vs plain at the step's shapes ({batch.o.shape[0]} rays, K "
          f"{cfg.max_samples_per_ray}, {cfg.n_march_iters} iterations, {pos.shape[0]} packed "
          f"samples, {enc.interpolation} interpolation): march n_valid agrees on "
          f"{march['n_valid_agree']:.6f}, max_abs_err by kernel {errs}")
    return out


def disk_phase(device, card, scene_dir: Path) -> tuple[dict, dict, dict]:
    """A scene from disk through the entry points a user calls: generate it,
    ``load_training_data``, DISK_STEPS frames, ``save_snapshot`` with the
    optimizer state, then ``load_snapshot`` into a Testbed with no scene
    (render) and into one holding the scene (state bit for bit, a second
    save equal to the first, DISK_MORE_STEPS more frames). Then the kernels
    against their plain versions at this path's shapes: the loaded render
    (whole frame, and C and D on its first window) and the trained task's
    step (``disk_kernel_checks``). The scene is generated into scene_dir,
    where the configs phase trains nerf/big.json on it. Returns the launches
    of the training run and of the loaded render, and those checks by kernel
    name."""
    from instant_ngp_torch import cuda_lib
    from instant_ngp_torch.io.nerf_loader import load_nerf
    from instant_ngp_torch.io.synthetic import generate_synthetic_dataset
    from instant_ngp_torch.nerf.sampler import march_rays
    from instant_ngp_torch.snapshot import load_snapshot_file
    from instant_ngp_torch.testbed import Testbed

    scratch = ROOT / "build"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        t0 = time.perf_counter()
        scene, test_json = generate_synthetic_dataset(scene_dir, res=DISK_RES)
        gen_s = time.perf_counter() - t0
        tb = Testbed("nerf", device=device)
        t0 = time.perf_counter()
        tb.load_training_data(scene)
        load_s = time.perf_counter() - t0
        task = tb.task
        test = load_nerf(test_json)
        print(f"disk scene: {task.dataset.n_images} train and {test.n_images} test views at "
              f"{DISK_RES}x{DISK_RES}, generated in {gen_s:.2f} s, loaded by "
              f"load_training_data in {load_s:.2f} s; a {DISK_RES}^2 RGBA PNG of Paeth rows "
              f"decodes in {paeth_decode_ms(DISK_RES):.1f} ms")
        before = split_psnr(task, test)

        # the main path: DISK_STEPS frames, the last PROFILED_STEPS traced
        torch.cuda.synchronize()
        cuda_lib.reset_launches()
        K = task.march_cfg.max_samples_per_ray
        step_ms, n_rays, measured = [], [], []
        for i in range(DISK_STEPS - PROFILED_STEPS):
            t0 = time.perf_counter()
            tb.frame()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            n_rays.append(task.n_rays_current)
            measured.append(int(task.last_stats["measured_samples"]))
            check(bool(np.isfinite(tb.loss_graph[-1])),
                  f"disk training step {i} has a non-finite loss {tb.loss_graph[-1]}")
        wall_ms, busy_ms, top, step_kernels = profile_frames(tb)
        torch.cuda.synchronize()
        launches = dict(cuda_lib.LAUNCHES)
        losses = tb.loss_graph
        bad = [i for i, v in enumerate(losses) if not np.isfinite(v)]
        check(not bad, f"disk training steps {bad} have a non-finite loss")
        check(not task.training_aborted and len(losses) == DISK_STEPS, "disk training stopped")
        first, last = np.mean(losses[:LOSS_WINDOW]), np.mean(losses[-LOSS_WINDOW:])
        packed = sum(r * K > task.compact_samples for r in n_rays)
        dropped = sum(m > task.compact_samples for m in measured)
        print(f"disk launches: {launches}")
        print(f"disk train {len(losses)} steps: median {statistics.median(step_ms):.3f} ms/step "
              f"(min {min(step_ms):.3f}, max {max(step_ms):.3f}) on {card}; loss first "
              f"{LOSS_WINDOW} {first:.6f}, last {LOSS_WINDOW} {last:.6f}")
        print(f"disk rays per batch at steps 0, 16, 32, ...: {n_rays[::task.grid_update_interval]};"
              f" valid samples at steps 0, 16, 32, ...: {measured[::task.grid_update_interval]}; "
              f"{packed} of {len(n_rays)} steps packed their {K}-sample windows into "
              f"{task.compact_samples} rows, {dropped} of them dropped samples past it")
        print(f"disk profiled {PROFILED_STEPS} steps: wall {wall_ms:.3f} ms, "
              f"{busy_text(wall_ms, busy_ms)}; device ms per step by "
              f"port kernel: {step_kernels}; top device items (ms): {top}")
        check(last <= MAX_LOSS_RATIO * first, f"disk loss fell from {first} to {last} only")
        check(all(launches[k] > 0 for k in TRAIN_KERNELS), f"a kernel was not launched: {launches}")
        after = split_psnr(task, test)
        print(f"disk test split ({test.n_images} views): PSNR {before[0]:.2f} -> {after[0]:.2f} "
              f"dB; training views {DISK_TRAIN_VIEWS}: {before[1]:.2f} -> {after[1]:.2f} dB")
        for i, split in enumerate(("test", "train")):
            check(after[i] - before[i] >= MIN_DISK_GAIN_DB[split],
                  f"disk {split} PSNR rose from {before[i]:.2f} to {after[i]:.2f} dB only, "
                  f"the JAX package's by {JAX_DISK_GAINS_DB[split]} dB")

        path = Path(tmp) / "scene.ingp"
        t0 = time.perf_counter()
        tb.save_snapshot(path, include_optimizer_state=True)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        bare = Testbed("nerf", device=device)
        bare.load_snapshot(path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        view = dict(focal_length=tuple(test.focal_lengths[0]),
                    principal_point=tuple(test.principal_points[0]), background=(0, 0, 0, 0))
        w, h = test.resolution
        # the saved task renders through its parameter EMA, which the optimizer
        # state carries at full precision; its grid is rounded to fp16 in the file
        ref = task.render(w, h, test.xforms_start[0], **view)
        torch.cuda.synchronize()
        cuda_lib.reset_launches()
        frame = bare.render_tensor(w, h, test.xforms_start[0], **view)
        torch.cuda.synchronize()
        render_launches = dict(cuda_lib.LAUNCHES)
        check(all(render_launches[k] > 0 for k in RENDER_KERNELS),
              f"a kernel was not launched: {render_launches}")
        check(bool(torch.isfinite(frame).all()), "the loaded render has non-finite values")
        db = psnr(frame, ref)
        print(f"disk snapshot: {path.stat().st_size} bytes, saved in {save_s:.3f} s, loaded "
              f"without the scene in {load_s:.3f} s; its render of test view 0 against the "
              f"saved task's: PSNR {db:.2f} dB")
        check(db >= MIN_LOADED_PSNR_DB, f"the loaded render's PSNR {db:.2f} dB")
        xf = test.xforms_start[0]
        db = psnr_vs_plain(bare, frame, w, xf, view)
        print(f"disk loaded render {w}x{h} kernel vs plain: PSNR {db:.2f} dB")
        check(db >= MIN_PSNR_DB, f"disk loaded render kernel vs plain PSNR {db}")
        margs, tmin, tmax = render_window_march(bare.task, w, xf, view, device)
        window = check_march(margs, tmin, "disk render window")
        marched = march_rays(*margs, t_init=tmin)[:4]
        gen = torch.Generator(device=device).manual_seed(SEED + 4)
        composite = check_composite_window(bare.task, *margs[:2], marched, tmin, tmax, gen)

        onto = Testbed("nerf", device=device)
        onto.load_training_data(scene)
        t0 = time.perf_counter()
        onto.load_snapshot(path)
        torch.cuda.synchronize()
        print(f"disk load_snapshot onto the scene: {time.perf_counter() - t0:.3f} s")
        check(np.array_equal(onto.task.dataset.images, task.dataset.images),
              "load_snapshot dropped the loaded scene's images")
        state_bits_equal(task, onto.task)
        again = Path(tmp) / "again.ingp"
        onto.save_snapshot(again, include_optimizer_state=True)
        first, second = load_snapshot_file(path), load_snapshot_file(again)
        # the key order, then every value but the loss, which a load leaves to the
        # loss meter as the JAX package's does: the binary fields byte by byte
        check(list(first) == list(second) and list(first["snapshot"]) == list(second["snapshot"]),
              "the second save's keys differ from the first's")
        first["snapshot"].pop("loss"), second["snapshot"].pop("loss")
        differ = [k for k in first["snapshot"] if first["snapshot"][k] != second["snapshot"][k]]
        check(first == second, f"the second save differs from the first (snapshot keys {differ})")
        for i in range(DISK_MORE_STEPS):
            onto.frame()
            check(bool(np.isfinite(onto.loss_graph[-1])),
                  f"step {i} after the load has a non-finite loss {onto.loss_graph[-1]}")
        print(f"disk load onto the scene: optimizer state and grid bit for bit, the second save "
              f"equal to the first but for the loss; {DISK_MORE_STEPS} more frames, last loss "
              f"{onto.loss_graph[-1]:.6f}")
    checks = disk_kernel_checks(task, device)
    checks["march_rays"]["disk_render_window"] = window
    checks["composite_window"] = {"disk_render_window": composite}
    return launches, render_launches, checks


IMAGE_KERNELS = ("hashgrid_encode_fwd", "fused_mlp", "hashgrid_encode_bwd", "fused_mlp_bwd",
                 "bilinear_read")
# compute_image_mse (bilinear targets) and a render with ground-truth tiles (nearest texels)
IMAGE_EVAL_KERNELS = ("hashgrid_encode_fwd", "fused_mlp", "bilinear_read", "take_rows")
BENCH_KERNELS = ("take_rows", "gather_cols_sum", "gather_cols_transpose")


def image_levels(res: int):
    """The grid levels configs/image/base.json autoconfigures for a res^2 image."""
    from instant_ngp_torch.config import load_network_config
    from instant_ngp_torch.models.factory import autoconfig_grid_encoding
    from instant_ngp_torch.ops.hashgrid import grid_encoding_from_config

    cfg = autoconfig_grid_encoding(load_network_config(IMAGE_CONFIG)["encoding"], "image",
                                   image_resolution=(res, res))
    return grid_encoding_from_config(cfg, 2, device="meta")


def check_encode(levels, interpolation: str, table, x, what: str, floor: float = 1.0) -> dict:
    """Kernel A against its plain version on (table, x), within TOL_ENCODE
    of max(floor, max |ref|): error, times, bound."""
    from instant_ngp_torch.ops.hashgrid import hashgrid_encode, hashgrid_encode_plain

    args = (levels, interpolation, table, x)
    out, ref = hashgrid_encode(*args), hashgrid_encode_plain(*args)
    err, scale = max_err(out, ref)
    check(err <= TOL_ENCODE * max(floor, scale), f"A {what}: err {err} at max |ref| {scale}")
    rows, corners = grid_work(levels, interpolation, x)
    F = table.shape[1]
    return {"max_abs_err": err, "scale": scale, "ms": time_ms(lambda: hashgrid_encode(*args)),
            "plain_ms": time_ms(lambda: hashgrid_encode_plain(*args)),
            **bound(nbytes(x, out) + rows * F * 4, x.shape[0] * corners * 2 * F)}


def check_encode_bwd(levels, interpolation: str, x, g, n_entries: int, corners: int,
                     what: str, floor: float = 1.0) -> dict:
    """Kernel E against its plain version, within TOL_ENCODE_BWD of
    max(floor, max |ref|): error, times, bound."""
    from instant_ngp_torch.ops.hashgrid import hashgrid_encode_bwd, hashgrid_encode_bwd_plain

    args = (levels, interpolation, x, g, n_entries, corners)
    err, scale = max_err(hashgrid_encode_bwd(*args), hashgrid_encode_bwd_plain(*args))
    check(err <= TOL_ENCODE_BWD * max(floor, scale), f"E {what}: err {err} at max |ref| {scale}")
    return {"max_abs_err": err, "scale": scale, "ms": time_ms(lambda: hashgrid_encode_bwd(*args)),
            "plain_ms": time_ms(lambda: hashgrid_encode_bwd_plain(*args)),
            **encode_bwd_bound(levels, interpolation, x, g, n_entries, corners)}


def check_take(table, idx, what: str) -> dict:
    """Kernel I against its plain version (exactly equal) and
    torch.index_select, the library call: times and bound (the distinct
    rows read once, the indices read and the rows written once)."""
    from instant_ngp_torch.ops.gather import take_rows, take_rows_plain

    out = take_rows(table, idx)
    check(bool(torch.equal(out, take_rows_plain(table, idx))), f"I {what}: differs from plain")
    row_bytes = table.shape[1] * table.element_size()
    return {"max_abs_err": 0.0, "ms": time_ms(lambda: take_rows(table, idx)),
            "plain_ms": time_ms(lambda: take_rows_plain(table, idx)),
            "library_ms": time_ms(lambda: torch.index_select(table, 0, idx)),
            "device_ms": device_split(lambda: take_rows(table, idx), "take_rows")["device_ms"],
            **bound(nbytes(idx, out) + int(torch.unique(idx).numel()) * row_bytes)}


def grid_sample_read(texture, resolution, uv):
    """The library call for a bilinear read: torch's grid_sample on a
    channels-last view of the texture (no copy), with the same pixel
    addressing (uv·res − 0.5, align_corners=False) and a border clamp. It
    differs from the read only past pos = res − 1.0001, where the read
    clamps and grid_sample does not. Returns a function of no arguments, and
    the grid made once outside it. Timed only; the port never calls it."""
    w, h = resolution
    tex = texture.view(1, h, w, texture.shape[1]).permute(0, 3, 1, 2)
    grid = (uv * 2.0 - 1.0).view(1, 1, -1, 2)
    return lambda: torch.nn.functional.grid_sample(tex, grid, mode="bilinear",
                                                   padding_mode="border", align_corners=False)


def check_bilinear(texture, resolution, uv, what: str) -> dict:
    """Kernel I's bilinear entry against its plain version, bit for bit:
    times, device time, the library call's time (grid_sample) and bound
    (the positions read once, the distinct texels of their corners read
    once, the reads written once)."""
    from instant_ngp_torch.ops.gather import bilinear_read, bilinear_read_plain, bilinear_texels

    out, ref = bilinear_read(texture, resolution, uv), bilinear_read_plain(texture, resolution, uv)
    differ = int((out != ref).any(dim=1).sum())
    check(differ == 0, f"I bilinear {what}: {differ} of {uv.shape[0]} reads differ from plain")
    idx, _ = bilinear_texels(resolution, uv)
    row_bytes = texture.shape[1] * texture.element_size()
    return {"max_abs_err": 0.0, "ms": time_ms(lambda: bilinear_read(texture, resolution, uv)),
            "plain_ms": time_ms(lambda: bilinear_read_plain(texture, resolution, uv)),
            "library_ms": time_ms(grid_sample_read(texture, resolution, uv)),
            "device_ms": device_split(lambda: bilinear_read(texture, resolution, uv),
                                      "bilinear_read")["device_ms"],
            **bound(nbytes(uv, out) + int(torch.unique(idx).numel()) * row_bytes)}


def edge_positions(resolution) -> torch.Tensor:
    """Positions on the edges of a bilinear read's clamps: u and v each in
    {0, 1e-7, 1 − 1e-7, 1}, a few pixel centres and texel corners near both
    borders, and the positions whose pos falls on, and just past, the upper
    clamp res − 1.0001 (every pair of them, as f32)."""
    axes = []
    for r in resolution:
        hi = np.float32(r) - np.float32(1.0 + 1e-4)
        px = np.array([0, 1, 2, r // 2, r - 2, r - 1], np.float64)
        vals = [0.0, 1e-7, 1.0 - 1e-7, 1.0, *((px + 0.5) / r), *(px / r), *((px + 1.0) / r),
                (float(hi) + 0.5) / r, (float(hi) + 0.5) / r + 1e-6]
        axes.append(np.array(vals, np.float32))
    u, v = np.meshgrid(*axes)
    return torch.from_numpy(np.stack([u.ravel(), v.ravel()], -1))


def check_cols(x, idx, reps: int, what: str) -> dict:
    """Kernel J against its plain version, bit for bit in f32 and bf16 (the
    same adds in the same order, a bf16 sum rounded after every add):
    times and bound (x, idx and out once each)."""
    from instant_ngp_torch.ops.gather import gather_cols_sum, gather_cols_sum_plain

    out, ref = gather_cols_sum(x, idx, reps), gather_cols_sum_plain(x, idx, reps)
    bits = torch.int16 if x.element_size() == 2 else torch.int32
    differ = int((out.view(bits) != ref.view(bits)).sum())
    check(differ == 0, f"J {what}: {differ} of {x.numel()} outputs differ from plain")
    return {"max_abs_err": 0.0, "ms": time_ms(lambda: gather_cols_sum(x, idx, reps)),
            "plain_ms": time_ms(lambda: gather_cols_sum_plain(x, idx, reps)),
            **bound(nbytes(x, idx, out), reps * x.numel())}


def cols_route(call) -> str:
    """The route one call of kernel J's wrapper took, as its launches show
    it: ``transpose`` where it launched the transpose, else ``shared``."""
    from instant_ngp_torch import cuda_lib

    before = cuda_lib.LAUNCHES["gather_cols_transpose"]
    call()
    return "transpose" if cuda_lib.LAUNCHES["gather_cols_transpose"] > before else "shared"


def col_indices(kind: str, t: int, cols: int, gen, device) -> torch.Tensor:
    """(t, cols) int32 indices of kernel J's checks: in [0, t), negative,
    within COL_REPS of 2^31 − 1, or anywhere in int32."""
    lo, hi = {"range": (0, t), "negative": (-(1 << 31), 0),
              "near_max": ((1 << 31) - 1 - COL_REPS, 1 << 31), "int32": (-(1 << 31), 1 << 31)}[kind]
    return torch.randint(lo, hi, (t, cols), generator=gen, device=device,
                         dtype=torch.int64).to(torch.int32)


def check_cols_case(t: int, cols: int, dtype, kind: str, reps: int, gen, device) -> dict:
    """check_cols on a random (t, cols) table, with the route the wrapper
    took (which must be the one its plan names) and the device time per
    call (every kernel of the call)."""
    from instant_ngp_torch.ops import gather

    x = torch.randn((t, cols), generator=gen, device=device).to(dtype)
    idx = col_indices(kind, t, cols, gen, device)
    what = f"T {t} L {cols} {str(dtype)[6:]} {kind} reps {reps}"
    v = check_cols(x, idx, reps, what)
    v["route"] = cols_route(lambda: gather.gather_cols_sum(x, idx, reps))
    planned = gather.cols_plan(t, cols, reps, x.element_size(),
                               gather.cols_limits(x.device.index or 0)).route
    check(v["route"] == planned, f"J {what}: took the {v['route']} route, planned {planned}")
    v["device_ms"] = device_split(lambda: gather.gather_cols_sum(x, idx, reps),
                                  "gather_cols")["device_ms"]
    print(f"J {what}: bit for bit, route {v['route']}, device {v['device_ms']:.5f} ms, "
          f"back to back {v['ms']:.4f} ms, bound {v['bound_ms']:.5f} ms")
    return v


def take_main_path(r: dict, v: dict) -> None:
    """Make the main path's check v the headline of kernel record r."""
    r["variants"]["main_path"] = v
    for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", *H_DEVICE_KEYS):
        if key in v or key in r:
            r[key] = v.get(key)
    r["max_abs_err"] = max(r["max_abs_err"], v["max_abs_err"])


def headline(v: dict) -> dict:
    """record_kernel's time, bound and library arguments from one check."""
    return {"ms": v["ms"], "plain_ms": v["plain_ms"],
            "bound_": {k: v[k] for k in ("bound_ms", "bound_by")}, "library_ms": v.get("library_ms")}


@torch.no_grad()
def gather_kernel_checks(device) -> list[dict]:
    """Kernels A and E at D = 2 on the level specs of a CHECK_IMAGE_RES^2
    image, I at every shape of bench_gather_tpu.py and J at every shape of
    bench_dyngather.py, each against its plain version."""
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    results = []
    record = functools.partial(record_kernel, results)
    enc = image_levels(CHECK_IMAGE_RES)
    n_hashed = sum(lv.hashed for lv in enc.levels)
    table = torch.rand((enc.n_entries, enc.n_features_per_level), generator=gen,
                       device=device) * 2.0 - 1.0
    x = torch.rand((N_IMAGE_ROWS, 2), generator=gen, device=device)
    g = torch.randn((N_IMAGE_ROWS, enc.n_output_dims), generator=gen, device=device)
    what = f"{CHECK_IMAGE_RES}^2 levels ({enc.n_entries} rows, {n_hashed} hashed)"
    variants = {"check": check_encode(enc.levels, enc.interpolation, table, x, what)}
    record("hashgrid_encode_fwd_d2", "instant_ngp_torch/csrc/hashgrid.cu",
           "instant_ngp_tpu/ops/hashgrid.py:213", variants["check"]["max_abs_err"],
           **headline(variants["check"]), extra=f" (D = 2, {N_IMAGE_ROWS} positions, {what})",
           variants=variants, counter="hashgrid_encode_fwd", path="image")
    variants = {f"corners{k}": check_encode_bwd(enc.levels, enc.interpolation, x, g,
                                                enc.n_entries, k, f"{what}, {k} corner(s)")
                for k in (1, 4)}
    record("hashgrid_encode_bwd_d2", "instant_ngp_torch/csrc/hashgrid_bwd.cu",
           "instant_ngp_tpu/ops/hashgrid.py:244",
           max(v["max_abs_err"] for v in variants.values()), **headline(variants["corners1"]),
           extra=f" (D = 2, {what}; all: {variants})", variants=variants,
           counter="hashgrid_encode_bwd", path="image")
    del table

    variants = {}
    for log2_t, f, dtype in TAKE_CASES:
        t = 1 << log2_t
        table = torch.randn((t, f), generator=gen, device=device).to(dtype)
        idx = torch.randint(0, t, (N_TAKE,), generator=gen, device=device, dtype=torch.int32)
        variants[f"T2^{log2_t}_F{f}_{str(dtype)[6:]}"] = check_take(table, idx, f"T 2^{log2_t}")
    record("take_rows", "instant_ngp_torch/csrc/gather.cu", "scripts/bench_gather_tpu.py:75", 0.0,
           **headline(variants["T2^19_F4_float32"]), extra=f" (2^20 rows; all: {variants})",
           variants=variants, path="image_eval",
           device_ms=variants["T2^19_F4_float32"]["device_ms"])

    # kernel I's bilinear entry at the edges of its clamps on a non-square texture
    res = EDGE_TEXTURE
    texture = torch.rand((res[0] * res[1], 4), generator=gen, device=device)
    edges = check_bilinear(texture, res, edge_positions(res).to(device),
                           f"edge positions, {res[0]}x{res[1]}")
    record("bilinear_read", "instant_ngp_torch/csrc/gather.cu",
           "instant_ngp_tpu/image_fit/task.py:34", 0.0, **headline(edges),
           extra=f" (edge positions on a {res[0]}x{res[1]} texture)",
           variants={"edges": edges}, path="image", device_ms=edges["device_ms"])

    variants = {f"T{t}_{str(dtype)[6:]}":
                check_cols_case(t, COLS, dtype, "range", COL_REPS, gen, device)
                for t, dtype in COL_CASES}
    variants.update({f"T{t}_L{cols}_{str(dtype)[6:]}_{kind}_reps{reps}":
                     check_cols_case(t, cols, dtype, kind, reps, gen, device)
                     for t, cols, dtype, kind, reps in COL_EXTRA_CASES})
    check({v["route"] for v in variants.values()} == {"shared", "transpose"},
          "J's checks did not take both routes")
    record("gather_cols_sum", "instant_ngp_torch/csrc/gather.cu", "scripts/bench_dyngather.py:34",
           0.0, **headline(variants["T4096_float32"]),
           extra=f" (reps {COL_REPS}; all: {variants})", variants=variants, path="bench",
           device_ms=variants["T4096_float32"]["device_ms"])
    return results


def make_image(res: int, seed: int) -> np.ndarray:
    """A (res, res, 3) linear image in [0, 1] with detail at every octave:
    per channel a sum of separable sinusoids, one per octave from one cycle
    per image down to a 4-pixel period (a (res, n) @ (n, res) product), then
    random disks of every radius from res/4 down to 2 pixels, 2^o of radius
    res/2^(o+1), blended over it."""
    rng = np.random.default_rng(seed)
    n_oct = int(np.log2(res)) - 1
    t = ((np.arange(res) + 0.5) / res).astype(np.float32)
    img = np.empty((res, res, 3), np.float32)
    for c in range(3):
        waves = []
        for _ in range(2):  # along y, then along x
            freq = 2.0 ** np.arange(n_oct) * rng.uniform(0.7, 1.0, n_oct)
            phase = rng.uniform(0.0, 2.0 * np.pi, n_oct)
            waves.append(np.sin(2.0 * np.pi * t[:, None] * freq + phase).astype(np.float32))
        img[..., c] = 0.5 + (waves[0] * np.float32(0.4 / n_oct)) @ waves[1].T
    for o in range(1, n_oct):
        r = res / 2 ** (o + 1)
        for _ in range(2 ** o):
            cx, cy = rng.uniform(0.0, res, 2)
            color, a = rng.uniform(0.0, 1.0, 3).astype(np.float32), np.float32(rng.uniform(0.3, 0.8))
            x0, x1 = max(int(cx - r), 0), min(int(cx + r) + 1, res)
            y0, y1 = max(int(cy - r), 0), min(int(cy + r) + 1, res)
            yy, xx = np.ogrid[y0:y1, x0:x1]
            inside = (xx + 0.5 - cx) ** 2 + (yy + 0.5 - cy) ** 2 <= r * r
            box = img[y0:y1, x0:x1]
            box[inside] = box[inside] * (1.0 - a) + color * a
    return img


def image_main_path_checks(task, uv: torch.Tensor, device) -> dict:
    """Kernels A, E and I's bilinear entry against their plain versions on
    the image task's own tables and texture, at a step's positions; and
    take_rows at the texels of the step's bilinear corners, which the step
    no longer gathers by row (a variant of take_rows's record)."""
    from instant_ngp_torch.ops.gather import bilinear_texels

    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    enc = task.model.encoding
    table = enc.table.detach()
    g = torch.randn((uv.shape[0], enc.n_output_dims), generator=gen, device=device)
    idx, _ = bilinear_texels(task.resolution, uv)
    main = {"hashgrid_encode_fwd_d2": check_encode(enc.levels, enc.interpolation, table, uv,
                                                   "image step"),
            "hashgrid_encode_bwd_d2": check_encode_bwd(enc.levels, enc.interpolation, uv, g,
                                                       enc.n_entries, enc.hashed_grad_corners,
                                                       "image step"),
            "take_rows_image_step": check_take(task.texture, idx, "image step texels"),
            "bilinear_read": check_bilinear(task.texture, task.resolution, uv, "image step")}
    for name, v in main.items():
        print(f"kernel {name} on the image step ({uv.shape[0]} positions, {idx.shape[0]} texels "
              f"of {task.texture.shape[0]}): max_abs_err {v['max_abs_err']:.3e} kernel "
              f"{v['ms']:.3f} ms plain {v['plain_ms']:.3f} ms bound {v['bound_ms']:.4f} ms")
    return main


@torch.no_grad()
def image_first_step_mlp_check(task, device) -> dict:
    """Kernel F against its plain version on the image task's first step:
    its 2^18 stratified positions (the task's generator is rewound after
    the draw), the encodings of the fresh table with one row zeroed (the
    ReLU tie), the fresh MLP. Held before training: a trained MLP can put a
    pre-activation so near 0 that the bf16 rounding of an upstream hidden
    value decides its sign, and kernel F's tensor-core recompute and the
    plain version's matmul may round that value apart; that row's dX then
    differs by a whole ReLU branch (PERF.md §6). The inputs here are the
    same in every run; the one-step check holds F on the trained state."""
    from instant_ngp_torch.ops.hashgrid import hashgrid_encode

    rng_state = task.generator.get_state()
    uv = task.sample_positions(task.draw_uniforms(), task.training_step)
    task.generator.set_state(rng_state)
    enc = task.model.encoding
    feats = hashgrid_encode(enc.levels, enc.interpolation, enc.table.detach(), uv)
    feats[ZERO_ROW] = 0.0
    ws = [w.detach() for w in task.model.network.weights]
    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    g = torch.randn((uv.shape[0], ws[-1].shape[1]), generator=gen, device=device)
    v = check_mlp_bwd(ws, feats, g, "image first step")
    print(f"kernel fused_mlp_bwd on the image task's first step ({uv.shape[0]} positions): "
          f"max_abs_err {v['max_abs_err']:.3e} kernel {v['ms']:.3f} ms plain {v['plain_ms']:.3f} "
          f"ms bound {v['bound_ms']:.4f} ms")
    return v


@torch.no_grad()
def image_trained_mlp_checks(task, uv: torch.Tensor, device) -> dict:
    """On the trained image task, at a step's positions uv: kernel B
    against F's recompute bit for bit, and F against its plain version with
    the rows near a ReLU tie left out."""
    from instant_ngp_torch.ops.hashgrid import hashgrid_encode

    enc = task.model.encoding
    feats = hashgrid_encode(enc.levels, enc.interpolation, enc.table.detach(), uv)
    ws = [w.detach() for w in task.model.network.weights]
    gen = torch.Generator(device=device).manual_seed(SEED + 6)
    g = torch.randn((uv.shape[0], ws[-1].shape[1]), generator=gen, device=device)
    return {"fwd_bwd_pair": check_fwd_bwd_pair(ws, feats, "trained image MLP"),
            "fused_mlp_bwd_trained": check_mlp_bwd_trained(ws, feats, g, "the trained image MLP")}


def image_step_check(task) -> torch.Tensor:
    """One step's gradients and loss through the kernels against the same
    step through the plain versions, from the same state and positions.
    Returns the positions."""
    uv = task.sample_positions(task.draw_uniforms(), task.training_step)
    runs = {}
    for use_kernels in (True, False):
        task.set_use_kernels(use_kernels)
        runs[use_kernels] = task.step_gradients(uv)
    task.set_use_kernels(True)
    (grads, loss), (grads_p, loss_p) = runs[True], runs[False]
    errs = [float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))
            for a, b in zip(grads, grads_p)]
    loss, loss_p = float(loss), float(loss_p)
    print(f"image step kernels vs plain, {uv.shape[0]} positions: grad ||k - p|| / ||p|| per "
          f"leaf {[f'{e:.2e}' for e in errs]}, loss {loss:.6f} vs {loss_p:.6f}")
    check(all(e <= TOL_STEP_GRAD for e in errs), f"image step gradients differ: {errs}")
    check(abs(loss - loss_p) <= TOL_STEP_LOSS * abs(loss_p),
          f"image step loss differs: {loss} vs {loss_p}")
    return uv


def image_phase(device, card) -> tuple[dict, dict, dict]:
    """The image path through its entry points. Returns (the main path's
    kernel checks by record name, the launches of the training run, those
    of the evaluation: compute_image_mse and a render with ground-truth
    tiles)."""
    from instant_ngp_torch import cuda_lib
    from instant_ngp_torch.io.image import save_image
    from instant_ngp_torch.testbed import Testbed

    t0 = time.perf_counter()
    img = make_image(IMAGE_RES, SEED)
    print(f"image: {IMAGE_RES}x{IMAGE_RES} made from seed {SEED} in "
          f"{time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    scratch = ROOT / "build"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        path = Path(tmp) / "image.bin"
        save_image(path, img)
        del img
        tb = Testbed("image", device=device)
        tb.reload_network_from_file(IMAGE_CONFIG)
        t0 = time.perf_counter()
        tb.load_training_data(path)
        torch.cuda.synchronize()
        print(f"load_training_data ({path.stat().st_size} bytes of .bin): "
              f"{time.perf_counter() - t0:.2f} s")
    task = tb.task
    enc = task.model.encoding
    n_params = sum(p.numel() for p in task.model.param_list())
    print(f"image model: {enc.n_levels} levels x {enc.n_features_per_level} features, "
          f"{enc.n_entries} table rows ({sum(lv.hashed for lv in enc.levels)} hashed), "
          f"{n_params} parameters, batch {task.batch_size}")
    psnr_before = -10.0 * float(np.log10(tb.compute_image_mse()))
    f_check = image_first_step_mlp_check(task, device)

    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    step_ms = []
    for _ in range(IMAGE_STEPS - PROFILED_STEPS):
        t0 = time.perf_counter()
        tb.frame()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    wall_ms, busy_ms, top, step_kernels = profile_frames(tb)
    torch.cuda.synchronize()
    launches = dict(cuda_lib.LAUNCHES)
    print(f"image launches: {launches}")
    print(f"image device ms per step by port kernel (last {PROFILED_STEPS} steps): {step_kernels}")
    losses = tb.loss_graph
    first, last = np.mean(losses[:LOSS_WINDOW]), np.mean(losses[-LOSS_WINDOW:])
    print(f"image {len(losses)} steps: median {statistics.median(step_ms):.3f} ms/step "
          f"(min {min(step_ms):.3f}, max {max(step_ms):.3f}) on {card}; loss first "
          f"{LOSS_WINDOW} {first:.6f}, last {LOSS_WINDOW} {last:.6f}")
    print(f"image profiled {PROFILED_STEPS} steps: wall {wall_ms:.3f} ms, "
          f"{busy_text(wall_ms, busy_ms)}; top device items (ms): "
          f"{top}")
    check(len(losses) == IMAGE_STEPS and all(np.isfinite(losses)), "an image loss is not finite")
    check(last <= MAX_LOSS_RATIO * first, f"image loss fell from {first} to {last} only")
    check(all(launches[k] > 0 for k in IMAGE_KERNELS), f"a kernel was not launched: {launches}")

    # evaluation: compute_image_mse reads its targets through the bilinear
    # entry, a render with ground-truth tiles reads nearest texels through take_rows
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    mse = tb.compute_image_mse()
    mse_s = time.perf_counter() - t0
    gt_frame = task.render(*RENDER_WH, gt_checkerboard=True)
    torch.cuda.synchronize()
    eval_launches = dict(cuda_lib.LAUNCHES)
    print(f"image evaluation launches (compute_image_mse, a render with ground-truth tiles): "
          f"{eval_launches}")
    check(all(eval_launches[k] > 0 for k in IMAGE_EVAL_KERNELS),
          f"a kernel was not launched: {eval_launches}")
    check(tuple(gt_frame.shape) == (RENDER_WH[1], RENDER_WH[0], 3) and
          bool(torch.isfinite(gt_frame).all()), "the ground-truth checkerboard frame")
    # take_rows at the texels of those tiles, the one shape its path gives it
    gt_idx = task.gt_texels(*RENDER_WH)
    gt_take = check_take(task.texture, gt_idx, f"ground-truth tiles {RENDER_WH[0]}x{RENDER_WH[1]}")
    print(f"kernel take_rows on the ground-truth tiles ({gt_idx.shape[0]} texels of "
          f"{task.texture.shape[0]}): bit for bit; kernel {gt_take['ms']:.3f} ms plain "
          f"{gt_take['plain_ms']:.3f} ms index_select {gt_take['library_ms']:.3f} ms device "
          f"{gt_take['device_ms']:.4f} ms bound {gt_take['bound_ms']:.4f} ms")
    psnr_after = -10.0 * float(np.log10(mse))
    print(f"image PSNR (compute_image_mse over {IMAGE_RES}^2 pixels) {psnr_before:.2f} -> "
          f"{psnr_after:.2f} dB; compute_image_mse {mse_s:.3f} s")
    check(psnr_after - psnr_before >= MIN_PSNR_GAIN_DB,
          f"image PSNR rose from {psnr_before:.2f} to {psnr_after:.2f} dB only")

    uv = image_step_check(task)
    main = {**image_main_path_checks(task, uv, device), "fused_mlp_bwd": f_check,
            **image_trained_mlp_checks(task, uv, device), "take_rows": gt_take}

    w, h = RENDER_WH
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frame = tb.render_tensor(w, h)
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - t0) * 1e3
    check(tuple(frame.shape) == (h, w, 4), f"image frame shape {tuple(frame.shape)}")
    check(bool(torch.isfinite(frame).all()), "image frame has non-finite values")
    task.set_use_kernels(False)
    frame_plain = tb.render_tensor(w, h)
    task.set_use_kernels(True)
    db = psnr(frame, frame_plain)
    print(f"image render {w}x{h}: {frame_ms:.3f} ms on {card}; kernel vs plain PSNR {db:.2f} dB")
    check(db >= MIN_PSNR_DB, f"image render kernel vs plain PSNR {db}")
    print(f"image phase max_memory_allocated {torch.cuda.max_memory_allocated()} bytes")
    return main, launches, eval_launches


# the sdf phase: configs/sdf/base.json at full width on a procedural closed
# mesh the size of the reference's bunny.obj (69,451 triangles; no scanned
# mesh is in the repository)
SDF_CONFIG = ROOT / "configs" / "sdf" / "base.json"
SDF_GRID = (256, 136)  # (u, v) of geometry/procedural.bumpy_torus: 69,632 triangles
SDF_STEPS = 300
SDF_IOU_SAMPLES = 1 << 21
# the JAX package's IoU after 300 steps of fresh batches on this mesh, seeds
# 1337 / 1 / 2 (tests/compare_sdf_training.py --package jax, on the CPU)
JAX_SDF_IOU = (0.9976924148083312, 0.9912448160094793, 0.9962556000318108)
MIN_SDF_IOU = min(JAX_SDF_IOU) - 0.02
SDF_RES = 256  # the kernel-vs-plain render and the snapshot's render
SDF_FRAME_WH = (1920, 1080)
# Discrete decisions flip on the network's last bits: the trace's hit tests
# and the step it stops at, the back-facing test of the shading and the shadow
# trace's stop. After 300 steps the field's analytic normal jumps between the
# finest cells (2048^3, hashed), so two traces that stop 1e-4 apart can shade
# a pixel differently. A pixel is decided apart where the hit masks differ or
# a channel differs by more than SDF_FLIP; such pixels may be this share of
# the frame, and the frames hold MIN_PSNR_DB over the rest.
MAX_SDF_MASK_DIFF = 0.005
SDF_FLIP = 0.05
# the render's analytic normals, kernels vs plain after normalization, at
# every hit whose input gradient exceeds NORMAL_FLOOR on either side (as the
# CPU test), save at most MAX_SDF_MASK_DIFF of them near a ReLU tie
MIN_NORMAL_COSINE = 0.9999
NORMAL_FLOOR = 1e-3
TOL_DX = 1e-6  # K against its plain version, of max |dx|: the same order, so bit for bit
SDF_KERNELS = ("hashgrid_encode_fwd", "fused_mlp", "hashgrid_encode_bwd", "fused_mlp_bwd")
SDF_RENDER_KERNELS = ("hashgrid_encode_fwd", "fused_mlp", "fused_mlp_bwd", "hashgrid_encode_dx")
NERF_ONLY_KERNELS = ("march_rays", "composite_window", "composite_train", "scatter_add_rows")


def frame_ms(fn) -> tuple[float, torch.Tensor]:
    """(host milliseconds of one call after a warm-up call, synchronized;
    its result)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def snapshot_round_trip(tb, mode: str, data: Path, snap: Path, render) -> dict:
    """``save_snapshot`` with the optimizer state, ``load_snapshot`` onto a
    fresh Testbed over the same data, and the loaded state held bit for bit
    against the saved one (parameters in fp16). ``render(testbed)`` gives a
    frame: the loaded Testbed's, and the saved one's with its parameters
    rounded to fp16 as the file holds them, the frame the loaded state must
    give. Returns the loaded Testbed, both frames and the times."""
    from instant_ngp_torch.testbed import Testbed

    t0 = time.perf_counter()
    tb.save_snapshot(snap, include_optimizer_state=True)
    save_s = time.perf_counter() - t0
    onto = Testbed(mode, device=tb.device)
    onto.camera_matrix = tb.camera_matrix
    onto.load_training_data(data)
    t0 = time.perf_counter()
    onto.load_snapshot(snap)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    state_bits_equal(tb.task, onto.task)
    loaded = render(onto)
    params = tb.task.model.param_list()
    kept = [p.detach().clone() for p in params]
    with torch.no_grad():
        for p in params:
            p.copy_(p.to(torch.float16).to(torch.float32))
    ref16 = render(tb)
    with torch.no_grad():
        for p, k in zip(params, kept):
            p.copy_(k)
    return {"onto": onto, "loaded": loaded, "ref16": ref16, "save_s": save_s, "load_s": load_s,
            "bytes": snap.stat().st_size}


def sdf_frame_parity(frame: torch.Tensor, ref: torch.Tensor) -> tuple[float, float, float]:
    """(share of pixels whose hit masks differ, share decided apart: masks,
    or a channel more than SDF_FLIP apart; PSNR over the rest)."""
    masks = (frame[..., 3] > 0.5) != (ref[..., 3] > 0.5)
    apart = masks | ((frame[..., :3] - ref[..., :3]).abs().amax(-1) > SDF_FLIP)
    return float(masks.float().mean()), float(apart.float().mean()), psnr(frame[~apart],
                                                                           ref[~apart])


def sdf_camera() -> np.ndarray:
    """The sdf phase's view: from above the torus's plane, looking at the
    cube's centre; columns right, down, forward, origin."""
    eye = np.array([0.5, 1.3, -0.3])
    fwd = (0.5 - eye) / np.linalg.norm(0.5 - eye)
    right = np.cross(fwd, [0.0, 1.0, 0.0])
    right /= np.linalg.norm(right)
    return np.stack([right, np.cross(fwd, right), fwd, eye], 1).astype(np.float32)


def check_encode_dx(levels, table, x, g, what: str) -> dict:
    """Kernel K against its plain version: error, times, bound (x, g, the
    distinct corner rows and dx moved once; per position and level, C·2F
    flops of dots and D·C·4 of the products)."""
    from instant_ngp_torch.ops.hashgrid import hashgrid_encode_dx, hashgrid_encode_dx_plain

    args = (levels, "linear", table, x, g)
    out, ref = hashgrid_encode_dx(*args), hashgrid_encode_dx_plain(*args)
    err, scale = max_err(out, ref)
    equal = int((out == ref).all(dim=1).sum())
    check(err <= TOL_DX * scale, f"K {what}: err {err} at max |ref| {scale}")
    rows, corners = grid_work(levels, "linear", x)
    F, D = table.shape[1], x.shape[1]
    ops = x.shape[0] * corners * (2 * F + 4 * D)
    print(f"kernel hashgrid_encode_dx on {what} ({x.shape[0]} positions): {equal} rows bit for "
          f"bit, max_abs_err {err:.3e} at max |dx| {scale:.3e}")
    return {"max_abs_err": err, "equal_rows": equal, "rows": x.shape[0],
            "ms": time_ms(lambda: hashgrid_encode_dx(*args)),
            "plain_ms": time_ms(lambda: hashgrid_encode_dx_plain(*args)),
            **bound(nbytes(x, g, out) + rows * F * 4, ops)}


def model_kernel_checks(task, pts, cotangent, what: str, trained: bool) -> dict:
    """Kernels A, B, E and F against their plain versions at a task's step
    shapes, on one batch: A on its positions, B and F on their encodings
    with the loss's cotangent (``cotangent(out)``), E on F's dX. F on a
    trained MLP leaves out the rows near a ReLU tie
    (``check_mlp_bwd_trained``). Returns {kernel name: {variant: check}}."""
    from instant_ngp_torch.ops.hashgrid import hashgrid_encode
    from instant_ngp_torch.ops.mlp_kernel import fused_mlp, fused_mlp_bwd

    enc, ws = task.model.encoding, [w.detach() for w in task.model.network.weights]
    table = enc.table.detach()
    feats = hashgrid_encode(enc.levels, enc.interpolation, table, pts)
    g_out = cotangent(fused_mlp(ws, feats)).contiguous()
    g_enc = fused_mlp_bwd(ws, feats, g_out)[0]
    out = {"hashgrid_encode_fwd": {what: check_encode(enc.levels, enc.interpolation, table, pts,
                                                      what)},
           "fused_mlp": {what: check_mlp(ws, feats, what)},
           "hashgrid_encode_bwd": {what: check_encode_bwd(
               enc.levels, enc.interpolation, pts, g_enc, enc.n_entries,
               enc.hashed_grad_corners, what)}}
    check_f = check_mlp_bwd_trained if trained else check_mlp_bwd
    out["fused_mlp_bwd"] = {what: check_f(ws, feats, g_out, what)}
    for name, v in out.items():
        print(f"kernel {name} at the {what} step's shapes: max_abs_err "
              f"{v[what]['max_abs_err']:.3e} kernel {v[what]['ms']:.3f} ms plain "
              f"{v[what]['plain_ms']:.3f} ms bound {v[what]['bound_ms']:.4f} ms")
    return out


def sdf_model_checks(task, pts, target, what: str, trained: bool) -> dict:
    """``model_kernel_checks`` at the SDF step's shapes (2^16 positions, 14
    levels × 2 features, D 3, linear, 1 corner; MLP 28→64→64→1) with the
    MAPE loss's cotangent, d mean(MAPE) / d pred, the denominator detached."""
    def cotangent(out):
        pred = out[:, 0]
        return (torch.sign(pred - target) / (torch.abs(pred) + 1e-2) / pts.shape[0])[:, None]

    return model_kernel_checks(task, pts, cotangent, what, trained)


def volume_model_checks(task, pts, tgt, valid, what: str, trained: bool) -> dict:
    """``model_kernel_checks`` at the volume step's shapes (2^17 positions,
    16 levels × 2 features, D 3, linear; MLP 32→64→64→4) with the masked L2
    loss's cotangent, 2 (pred − tgt) · valid / (4 · max(Σ valid, 1))."""
    v = valid.to(torch.float32)[:, None]
    return model_kernel_checks(
        task, pts, lambda out: 2.0 * (out - tgt) * v / (4.0 * torch.clamp(v.sum(), min=1.0)),
        what, trained)


def task_step_gradients_check(task, *batch, what: str = "sdf") -> None:
    """One step's gradients and loss, kernels against plain versions, from
    the same state and batch (an SDF or a volume task's)."""
    runs = {}
    for use_kernels in (True, False):
        task.set_use_kernels(use_kernels)
        runs[use_kernels] = task.step_gradients(*batch)
    task.set_use_kernels(True)
    (grads, loss), (grads_p, loss_p) = runs[True], runs[False]
    errs = [float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))
            for a, b in zip(grads, grads_p)]
    print(f"{what} train step kernels vs plain, {batch[0].shape[0]} points: grad ||k - p|| / ||p|| "
          f"per leaf {[f'{e:.2e}' for e in errs]}, loss {float(loss):.6f} vs {float(loss_p):.6f}")
    check(all(e <= TOL_STEP_GRAD for e in errs), f"{what} step gradients differ: {errs}")
    check(abs(float(loss) - float(loss_p)) <= TOL_STEP_LOSS * abs(float(loss_p)),
          f"{what} step loss differs: {float(loss)} vs {float(loss_p)}")


def sdf_normals_check(task, hits) -> dict:
    """The render's analytic normals at its hits (``SdfTask._gradient``,
    normalized as ``_normals`` does), kernels A, B, F and K against the
    plain versions: the cosine must reach MIN_NORMAL_COSINE at every hit
    whose gradient exceeds NORMAL_FLOOR on either side, save hits whose MLP
    lies within a bf16 step of a ReLU tie (``near_tie_rows``: F and the
    plain backward may take the two sides of it); those may be at most
    MAX_SDF_MASK_DIFF of the hits. The hits below the floor are counted."""
    from instant_ngp_torch.ops.hashgrid import hashgrid_encode_plain

    params = task.inference_params()
    grads = {}
    for use_kernels in (True, False):
        task.set_use_kernels(use_kernels)
        grads[use_kernels] = task._gradient(params, hits)
    task.set_use_kernels(True)
    gk, gp = grads[True], grads[False]
    nk, np_ = gk.norm(dim=-1), gp.norm(dim=-1)
    cos = torch.sum(gk * gp, -1) / (torch.clamp(nk, min=1e-9) * torch.clamp(np_, min=1e-9))
    enc = task.model.encoding
    feats = hashgrid_encode_plain(enc.levels, enc.interpolation, enc.table.detach(), hits)
    near = near_tie_rows([w.detach() for w in task.model.network.weights], feats)
    above = torch.maximum(nk, np_) > NORMAL_FLOOR
    low = above & (cos < MIN_NORMAL_COSINE)
    field = task.sdf(hits)

    def least(t, mask):
        return float(t[mask].min()) if bool(mask.any()) else None

    def most(t, mask):
        return float(t[mask].max()) if bool(mask.any()) else None

    v = {"hits": hits.shape[0], "above_floor": int(above.sum()),
         "min_cosine": least(cos, above), "min_cosine_not_near_tie": least(cos, above & ~near),
         "near_tie": int((above & near).sum()), "low": int(low.sum()),
         "low_not_near_tie": int((low & ~near).sum()), "below_floor": int((~above).sum()),
         "max_grad_below_floor": most(torch.maximum(nk, np_), ~above),
         "max_abs_field_below_floor": most(field.abs(), ~above),
         "min_cosine_below_floor": least(cos, ~above),
         "zero_grad": int(((nk == 0) | (np_ == 0)).sum())}
    print(f"sdf normals at {v['hits']} hits, kernels vs plain: {v['above_floor']} with |grad| > "
          f"{NORMAL_FLOOR}, cosine min {v['min_cosine']} ({v['min_cosine_not_near_tie']} away "
          f"from a ReLU tie); {v['near_tie']} within a bf16 step of a tie; {v['low']} below "
          f"{MIN_NORMAL_COSINE}, {v['low_not_near_tie']} of them away from a tie; "
          f"{v['below_floor']} with |grad| <= {NORMAL_FLOOR} on both sides (largest "
          f"{v['max_grad_below_floor']}, |field| there at most {v['max_abs_field_below_floor']}, "
          f"cosine min {v['min_cosine_below_floor']}, {v['zero_grad']} exactly 0 on a side)")
    if v["low"]:
        i = torch.nonzero(low).reshape(-1)[:8]
        print(f"sdf normals below {MIN_NORMAL_COSINE}: cosine {cos[i].tolist()}, |grad| kernels "
              f"{nk[i].tolist()} plain {np_[i].tolist()}, field {field[i].tolist()}, near a tie "
              f"{near[i].tolist()}")
    check(v["low_not_near_tie"] == 0 and v["low"] <= MAX_SDF_MASK_DIFF * v["hits"],
          f"sdf normals: {v['low']} hits below {MIN_NORMAL_COSINE}, {v['low_not_near_tie']} of "
          f"them away from a ReLU tie")
    return v


def sdf_phase(device, card) -> tuple[dict, dict, dict, dict]:
    """The SDF path through the entry points a user calls: a procedural mesh
    written as .obj, ``Testbed("sdf").load_training_data`` with
    configs/sdf/base.json, SDF_STEPS frames on the batch producer's points,
    the IoU before and after, then renders (SDF_RES^2 kernels against plain,
    1920x1080 timed) and a snapshot round trip. Kernels A, B, E and F are
    held against their plain versions at this path's shapes on a fresh and
    on the trained model, K on the render's hit positions. Returns (the
    launches of the training run, those of the render, the checks by kernel
    name, K's check)."""
    from instant_ngp_torch import cuda_lib
    from instant_ngp_torch.geometry.procedural import bumpy_torus, write_obj
    from instant_ngp_torch.testbed import Testbed

    scratch = ROOT / "build"
    scratch.mkdir(exist_ok=True)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        t0 = time.perf_counter()
        v, f = bumpy_torus(*SDF_GRID, seed=SEED)
        path = Path(tmp) / "torus.obj"
        write_obj(path, v, f)
        print(f"sdf mesh: a bumpy torus of {len(f)} triangles from seed {SEED}, made and written "
              f"as .obj ({path.stat().st_size} bytes) in {time.perf_counter() - t0:.2f} s")
        tb = Testbed("sdf", device=device)
        tb.reload_network_from_file(SDF_CONFIG)
        t0 = time.perf_counter()
        tb.load_training_data(path)
        torch.cuda.synchronize()
        task = tb.task
        enc = task.model.encoding
        print(f"sdf load_training_data: {time.perf_counter() - t0:.3f} s, the BVH built in "
              f"{task.bvh_build_s:.3f} s; {enc.n_levels} levels x {enc.n_features_per_level} "
              f"features, {enc.n_entries} table rows ({sum(lv.hashed for lv in enc.levels)} "
              f"hashed), MLP {[tuple(w.shape) for w in task.model.network.weights]}, batch "
              f"{task.batch_size}")
        t0 = time.perf_counter()
        iou_before = tb.calculate_iou(SDF_IOU_SAMPLES)
        iou_s = time.perf_counter() - t0
        fresh_batch = task.to_device(task.generate_training_batch())
        checks = sdf_model_checks(task, *fresh_batch, "sdf_fresh", trained=False)

        torch.cuda.synchronize()
        cuda_lib.reset_launches()
        step_ms = []
        for _ in range(SDF_STEPS - PROFILED_STEPS):
            t0 = time.perf_counter()
            tb.frame()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        wall_ms, busy_ms, top, step_kernels = profile_frames(tb)
        torch.cuda.synchronize()
        launches = dict(cuda_lib.LAUNCHES)
        losses = tb.loss_graph
        print(f"sdf launches: {launches}")
        print(f"sdf {len(losses)} steps: median {statistics.median(step_ms):.3f} ms/step (min "
              f"{min(step_ms):.3f}, max {max(step_ms):.3f}) on {card}; loss first "
              f"{LOSS_WINDOW} {np.mean(losses[:LOSS_WINDOW]):.6f}, last {LOSS_WINDOW} "
              f"{np.mean(losses[-LOSS_WINDOW:]):.6f}")
        print(f"sdf batch producer: {task.batches_produced} batches at "
              f"{task.producer_seconds / max(task.batches_produced, 1) * 1e3:.1f} ms a batch; "
              f"{task.fresh_batches} steps took a fresh batch, {task.reused_batches} reused the "
              f"last")
        print(f"sdf profiled {PROFILED_STEPS} steps: wall {wall_ms:.3f} ms, "
              f"{busy_text(wall_ms, busy_ms)}; device ms per step by "
              f"port kernel: {step_kernels}; top device items (ms): {top}")
        check(len(losses) == SDF_STEPS and all(np.isfinite(losses)), "an SDF loss is not finite")
        check(task.fresh_batches == SDF_STEPS and task.reused_batches == 0,
              "a frame's step did not wait for a fresh batch")
        check(all(launches[k] > 0 for k in SDF_KERNELS), f"a kernel was not launched: {launches}")
        check(all(launches[k] == 0 for k in (*NERF_ONLY_KERNELS, "hashgrid_encode_dx")),
              f"the SDF step launched a kernel it does not run: {launches}")
        t0 = time.perf_counter()
        iou_after = tb.calculate_iou(SDF_IOU_SAMPLES)
        print(f"sdf IoU ({SDF_IOU_SAMPLES} points): {iou_before:.6f} -> {iou_after:.6f} (the "
              f"JAX package's after {SDF_STEPS} fresh steps: {JAX_SDF_IOU}, gate {MIN_SDF_IOU:.4f})"
              f"; calculate_iou {iou_s:.3f} s the first time (the BVH's side of every point), "
              f"{time.perf_counter() - t0:.3f} s after")
        check(iou_after >= MIN_SDF_IOU, f"sdf IoU {iou_after} below {MIN_SDF_IOU}")

        batch = task.to_device(task.generate_training_batch())
        task_step_gradients_check(task, *batch)
        for name, v in sdf_model_checks(task, *batch, "sdf_trained", trained=True).items():
            checks[name].update(v)

        # the render: SDF_RES^2 through the kernels, then through the plain versions
        tb.camera_matrix = sdf_camera()
        torch.cuda.synchronize()
        cuda_lib.reset_launches()
        frame = tb.render_tensor(SDF_RES, SDF_RES)
        torch.cuda.synchronize()
        render_launches = dict(cuda_lib.LAUNCHES)
        print(f"sdf render launches: {render_launches}")
        check(all(render_launches[k] > 0 for k in SDF_RENDER_KERNELS),
              f"a kernel was not launched: {render_launches}")
        check(all(render_launches[k] == 0 for k in (*NERF_ONLY_KERNELS, "hashgrid_encode_bwd")),
              f"the SDF render launched a kernel it does not run: {render_launches}")
        check(tuple(frame.shape) == (SDF_RES, SDF_RES, 4) and bool(torch.isfinite(frame).all()),
              "the SDF frame")
        hit_share = float(frame[..., 3].mean())
        check(hit_share > 0.05, f"the SDF frame hits {hit_share} of its pixels")
        task.set_use_kernels(False)
        frame_plain = tb.render_tensor(SDF_RES, SDF_RES)
        task.set_use_kernels(True)
        masks, apart, db = sdf_frame_parity(frame, frame_plain)
        same = (frame[..., 3] > 0.5) == (frame_plain[..., 3] > 0.5)
        print(f"sdf render {SDF_RES}x{SDF_RES} kernel vs plain: hit masks differ on {masks:.5f} "
              f"of the pixels, {apart:.5f} decided apart, PSNR {db:.2f} dB over the rest (over "
              f"the pixels whose masks agree {psnr(frame[same], frame_plain[same]):.2f} dB, all "
              f"pixels {psnr(frame, frame_plain):.2f} dB); hits {hit_share:.4f}")
        check(apart <= MAX_SDF_MASK_DIFF and db >= MIN_PSNR_DB,
              f"sdf render kernel vs plain: {apart} decided apart, PSNR {db}")

        # K on the render's hit positions, with the cotangent F's dX gives it
        from instant_ngp_torch.ops.mlp_kernel import fused_mlp_bwd
        from instant_ngp_torch.ops.hashgrid import hashgrid_encode

        hits = task.hit_positions(SDF_RES, SDF_RES, tb.camera_matrix, tb.fov)
        ws = [w.detach() for w in task.model.network.weights]
        table = enc.table.detach()
        feats = hashgrid_encode(enc.levels, enc.interpolation, table, hits)
        g_enc = fused_mlp_bwd(ws, feats, torch.ones((hits.shape[0], 1), device=device))[0]
        k_check = check_encode_dx(enc.levels, table, hits, g_enc, f"the {SDF_RES}^2 render's hits")
        k_check["normals"] = sdf_normals_check(task, hits)

        w, h = SDF_FRAME_WH
        big_ms, big = frame_ms(lambda: tb.render_tensor(w, h))
        check(tuple(big.shape) == (h, w, 4) and bool(torch.isfinite(big).all()), "the SDF frame")
        print(f"sdf render {w}x{h} (sun, soft shadows, analytic normals): {big_ms:.3f} ms on "
              f"{card}; hits {float(big[..., 3].mean()):.4f}")

        rt = snapshot_round_trip(tb, "sdf", path, Path(tmp) / "torus.ingp",
                                 lambda t: t.render_tensor(SDF_RES, SDF_RES))
        loaded, ref16 = rt["loaded"], rt["ref16"]
        _, apart, db = sdf_frame_parity(loaded, ref16)
        _, apart32, db32 = sdf_frame_parity(loaded, frame)
        print(f"sdf snapshot: {rt['bytes']} bytes, saved in {rt['save_s']:.3f} s, loaded onto "
              f"the mesh in {rt['load_s']:.3f} s; parameters (fp16) and optimizer state bit for bit; "
              f"its render against the saved task's with fp16 parameters: {apart:.5f} of the "
              f"pixels decided apart, PSNR {db:.2f} dB over the rest (all pixels "
              f"{psnr(loaded, ref16):.2f} dB); against the saved task's own (f32 parameters): "
              f"{apart32:.5f} apart, {db32:.2f} dB")
        check(apart <= MAX_SDF_MASK_DIFF and db >= MIN_LOADED_PSNR_DB,
              f"the loaded SDF render: {apart} decided apart, PSNR {db}")
        for t in (tb, rt["onto"]):
            t.task.stop_producer()
    print(f"sdf phase: {time.perf_counter() - t_phase:.1f} s")
    return launches, render_launches, checks, k_check


VOLUME_CONFIG = ROOT / "configs" / "volume" / "base.json"
VOLUME_RES = 128  # procedural_fog_volume's grid: 128^3
VOLUME_STEPS = 300
VOLUME_MSE_SAMPLES = 1 << 18  # compute_density_mse's default
# the JAX package's compute_density_mse before and after 300 steps on this
# grid with configs/volume/base.json at full width and the task's
# 2^17-vertex batch, seeds 1337 / 1 / 2, on the CPU:
#   JAX_PLATFORMS=cpu python tests/compare_volume_training.py --package jax --seeds 1337 1 2
JAX_VOLUME_MSE_BEFORE = (0.10692566633224487, 0.10692349821329117, 0.1069207414984703)
JAX_VOLUME_MSE = (0.09697291254997253, 0.09557631611824036, 0.09254146367311478)
JAX_VOLUME_GAIN = tuple(b - a for b, a in zip(JAX_VOLUME_MSE_BEFORE, JAX_VOLUME_MSE))


def seed_spread(values) -> float:
    """1 + (max - min) / min of the JAX package's seeds: the margin a run of
    the port gets, as one more draw of that spread (the packages draw their
    weights and batches from different generators)."""
    return 1.0 + (max(values) - min(values)) / min(values)


# the gates: the MSE after at most the JAX package's worst times its seeds'
# spread (1.0479), and its fall from before at least the JAX package's least
# fall (0.00995) over its seeds' spread of falls (1.4448), 0.00689, so a run
# that trains but recovers well under the JAX package's gain is refused; the
# port's own 3 seeds on the card read 0.0926-0.0949 after
MAX_VOLUME_MSE = max(JAX_VOLUME_MSE) * seed_spread(JAX_VOLUME_MSE)
MIN_VOLUME_GAIN = min(JAX_VOLUME_GAIN) / seed_spread(JAX_VOLUME_GAIN)
VOLUME_RENDER_RES = 256  # the kernel-vs-plain renders and the snapshot's
VOLUME_FRAME_WH = (1920, 1080)
VOLUME_RAGGED = 3  # paths and rays short of a multiple of 4 and of a block
# Kernels L and M run the plain versions' arithmetic in the same order (no
# FMA contraction, accurate logf, sqrtf and division; PyTorch's CUDA ops
# compute each of them alike), so every path, ray and ground-truth pixel must
# agree bit for bit, as every run on the card has read.
# Their operations, counted from csrc/volume.cu for each kind of
# path-iteration a tracking.ReadCensus counts, and once a path ("path": the
# first spawn and the last envmap for L, the box entry and the envmap for M);
# each f32 add, multiply, divide, compare, min or max, floor, sqrt and log is
# one, index arithmetic is not counted: the least work of the bound
VOLUME_L_OPS = {"path": 107, "live": 22, "event": 22, "scatter": 24, "died": 29, "respawn": 78}
VOLUME_M_OPS = {"path": 69, "live": 21, "event": 16, "scatter": 16}
# what L's and M's records say of their second design (csrc/volume.cu)
VOLUME_DESIGN = ("draws staged a stage ahead in each thread's shared-memory ring, look-ahead "
                 "windows with predicated bitgrid and grid reads")
VOLUME_KERNELS = ("hashgrid_encode_fwd", "fused_mlp", "hashgrid_encode_bwd", "fused_mlp_bwd",
                  "volume_generate_batch")
VOLUME_RENDER_KERNELS = ("hashgrid_encode_fwd", "fused_mlp")


def load_nvdb_writer():
    """``tests/nvdb_fixture.py``'s writer, imported by path: the package has
    no .nvdb writer, and the repository no .nvdb file."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("nvdb_fixture",
                                                  ROOT / "tests" / "nvdb_fixture.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.write_nvdb


def volume_camera() -> np.ndarray:
    """``bench.py::bench_volume``'s view: from -z at the box's centre."""
    return np.concatenate([np.eye(3, dtype=np.float32),
                           np.array([[0.5], [0.5], [-1.3]], np.float32)], 1)


def seeded_render(tb, *args, **kwargs) -> torch.Tensor:
    """A Testbed render with its task's generator reseeded first: two renders
    of one state draw the same numbers."""
    tb.task.generator.manual_seed(SEED)
    frame = tb.render_tensor(*args, **kwargs)
    torch.cuda.synchronize()
    return frame


def census_bound(census, n_paths: int, ops: dict, *tensors) -> dict:
    """A path tracer's bound from what its plain version's census counted:
    the sectors it touched of the draws, the grid and the bitgrid, plus the
    tensors read or written whole, against ``ops`` of each kind counted."""
    read, counts = census.bytes_read(), census.counts
    n_bytes = sum(read.values()) + nbytes(*tensors)
    n_ops = n_paths * ops["path"] + sum(c * ops[k] for k, c in counts.items())
    return {**bound(n_bytes, n_ops), "bytes": n_bytes, "ops": n_ops, "bytes_read": read,
            "counts": counts}


def census_text(v: dict, all_draws) -> str:
    read = v["bytes_read"]
    return (f"bound {v['bound_ms']:.5f} ms ({v['bound_by']}: {v['bytes']} bytes, {v['ops']} "
            f"operations; sectors read of the draws {read['draws']} of {nbytes(all_draws)} bytes, "
            f"of the grid {read.get('grid', 0)}, of the bitgrid {read.get('bitgrid', 0)}; "
            f"path-iterations {v['counts']})")


def check_generate_batch(task, draws, gen=None) -> dict:
    """Kernel L against its plain version on one step's draws: every path's
    4 vertices (positions, targets, valid flags) bit for bit, the error,
    both times and L's device time back to back on these draws, and its
    bound (the sectors of the draws, grid and bitgrid that the paths read,
    as the plain version's census counts them, the first spawn's draws, the
    batch written once). With ``gen``, also L's device time warm, on draws
    the generator has just made (as a training step calls it), and cold, on
    these draws after another draw buffer has been read (none of them in
    L2)."""
    from instant_ngp_torch.volume import tracking

    out = tracking.generate_batch(task, draws)
    census = tracking.ReadCensus()
    ref = tracking.generate_batch_plain(task, draws, census)
    n = draws.n_paths
    equal = torch.ones(n, dtype=torch.bool, device=draws.first.device)
    for a, b in zip(out, ref):
        equal &= (a == b).reshape(n, -1).all(-1)
    share = int(equal.sum()) / n  # counted exactly: a mean's 1 / n rounds
    err = max(max_err(out[0], ref[0])[0], max_err(out[1], ref[1])[0])
    valid_share = float(out[2].float().mean())
    check(bool(equal.all()), f"L: {share} of the paths bit for bit")
    split = device_split(lambda: tracking.generate_batch(task, draws), "volume_generate_batch",
                         reps=10, per_call=1)
    v = {"max_abs_err": err, "bit_equal_paths": share, "paths": n, "valid_share": valid_share,
         "ms": time_ms(lambda: tracking.generate_batch(task, draws)),
         "plain_ms": time_ms(lambda: tracking.generate_batch_plain(task, draws), reps=2,
                             warmup=1),
         "device_ms": split["kernel_ms"], "timed_by": split["timed_by"],
         **census_bound(census, n, VOLUME_L_OPS, draws.first, *out)}
    when = ""
    if gen is not None:
        other = tracking.draw_batch(gen, n)
        for key, fn in (("warm", lambda: tracking.generate_batch(
                            task, tracking.draw_batch(gen, n))),
                        ("cold", lambda: (other.per_iter.sum(),
                                          tracking.generate_batch(task, draws)))):
            v[f"device_ms_{key}"] = device_split(fn, "volume_generate_batch", reps=10,
                                                 per_call=1)["kernel_ms"]
        del other
        when = f", warm from a fill {v['device_ms_warm']:.4f}, cold {v['device_ms_cold']:.4f}"
    print(f"kernel volume_generate_batch ({n} paths x {draws.per_iter.shape[0]} iterations): "
          f"{share:.6f} of the paths bit for bit, max_abs_err {err:.3e}; {valid_share:.4f} of the "
          f"vertices valid; device {v['device_ms']:.4f} ms back to back ({v['timed_by']}){when}; "
          f"{census_text(v, draws.per_iter)}")
    return v


def check_ragged(task, gen, o, d) -> dict:
    """Kernels L and M at sizes that are multiples neither of 4 nor of a
    block (VOLUME_RAGGED paths, and rays, short of 2^15 and 2^16): a partial
    last block, and draw rows that are not 16-byte aligned. Every path and
    ray bit for bit against the plain versions, and their device times."""
    from instant_ngp_torch.volume import tracking

    n = task.batch_size // tracking.MAX_TRAIN_VERTICES - VOLUME_RAGGED
    draws = tracking.draw_batch(gen, n)
    out = tracking.generate_batch(task, draws)
    ref = tracking.generate_batch_plain(task, draws)
    l_equal = all(torch.equal(a, b) for a, b in zip(out, ref))
    r = o.shape[0] - VOLUME_RAGGED
    o, d, gt = o[:r].contiguous(), d[:r].contiguous(), tracking.draw_gt(gen, r)
    m_equal = all(torch.equal(a, b) for a, b in zip(tracking.trace_gt(task, o, d, gt),
                                                    tracking.trace_gt_plain(task, o, d, gt)))
    v = {"paths": n, "rays": r, "l_bit_equal": l_equal, "m_bit_equal": m_equal,
         "l_device_ms": device_split(lambda: tracking.generate_batch(task, draws),
                                     "volume_generate_batch", reps=10, per_call=1)["kernel_ms"],
         "m_device_ms": device_split(lambda: tracking.trace_gt(task, o, d, gt), "volume_trace_gt",
                                     reps=10, per_call=1)["kernel_ms"]}
    print(f"kernels L and M at ragged sizes ({n} paths, {r} rays): L "
          f"{'bit for bit' if l_equal else 'NOT bit for bit'}, device {v['l_device_ms']:.4f} ms; M "
          f"{'bit for bit' if m_equal else 'NOT bit for bit'}, device {v['m_device_ms']:.4f} ms")
    check(l_equal and m_equal, f"L or M at ragged sizes: {v}")
    return v


def check_trace_gt(task, o, d, draws) -> dict:
    """Kernel M against its plain version on one frame's rays and draws:
    every ray's rgb and alpha bit for bit, the error, times, M's device
    time, and its bound (the sectors of the draws, grid and bitgrid that the
    rays read, as the plain version's census counts them, the rays read and
    rgb and alpha written once)."""
    from instant_ngp_torch.volume import tracking

    out = tracking.trace_gt(task, o, d, draws)
    census = tracking.ReadCensus()
    ref = tracking.trace_gt_plain(task, o, d, draws, census)
    equal = (out[0] == ref[0]).all(-1) & (out[1] == ref[1])
    share = int(equal.sum()) / o.shape[0]  # counted exactly: a mean's 1 / n rounds
    err = max(max_err(out[0], ref[0])[0], max_err(out[1], ref[1])[0])
    check(bool(equal.all()), f"M: {share} of the rays bit for bit")
    split = device_split(lambda: tracking.trace_gt(task, o, d, draws), "volume_trace_gt",
                         per_call=1)
    v = {"max_abs_err": err, "bit_equal_rays": share, "rays": o.shape[0],
         "alpha_mean": float(out[1].mean()),
         "ms": time_ms(lambda: tracking.trace_gt(task, o, d, draws)),
         "plain_ms": time_ms(lambda: tracking.trace_gt_plain(task, o, d, draws), reps=2,
                             warmup=1),
         "device_ms": split["kernel_ms"], "timed_by": split["timed_by"],
         **census_bound(census, o.shape[0], VOLUME_M_OPS, o, d, *out)}
    print(f"kernel volume_trace_gt ({o.shape[0]} rays x {draws.shape[0]} iterations): "
          f"{share:.6f} of the rays bit for bit, max_abs_err {err:.3e}; alpha mean "
          f"{v['alpha_mean']:.4f}; device {v['device_ms']:.4f} ms ({v['timed_by']}); "
          f"{census_text(v, draws)}")
    return v


def volume_phase(device, card) -> tuple[dict, dict, dict, dict, dict, dict]:
    """The volume path through the entry points a user calls: a procedural
    cloud written as .nvdb, ``Testbed("volume").load_training_data`` with
    configs/volume/base.json, VOLUME_STEPS frames (each on a fresh batch
    traced by kernel L), the density MSE before and after; then L against its
    plain version on one step's draws, one step's gradients kernels against
    plain, A, B, E and F against their plain versions at this path's shapes
    on the fresh and the trained model, a VOLUME_RENDER_RES^2 learned render
    (kernels A and B) and
    ground-truth render (kernel M) each against its plain version on the
    same draws, 1920x1080 frames timed, and a snapshot round trip. Returns
    (the launches of the training run, of the learned render, of the
    ground-truth render, the checks of A, B, E and F by kernel name, L's
    check, M's check)."""
    from instant_ngp_torch import cuda_lib
    from instant_ngp_torch.io.nanovdb import procedural_fog_volume
    from instant_ngp_torch.render.camera import pinhole_rays
    from instant_ngp_torch.testbed import Testbed
    from instant_ngp_torch.volume import tracking

    scratch = ROOT / "build"
    scratch.mkdir(exist_ok=True)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        t0 = time.perf_counter()
        grid = procedural_fog_volume(VOLUME_RES)
        path = load_nvdb_writer()(Path(tmp) / "fog.nvdb", grid)
        print(f"volume grid: procedural_fog_volume({VOLUME_RES}), written as .nvdb "
              f"({path.stat().st_size} bytes) in {time.perf_counter() - t0:.2f} s")
        tb = Testbed("volume", device=device)
        tb.reload_network_from_file(VOLUME_CONFIG)
        t0 = time.perf_counter()
        tb.load_training_data(path)
        torch.cuda.synchronize()
        task = tb.task
        enc = task.model.encoding
        print(f"volume load_training_data: {time.perf_counter() - t0:.3f} s; majorant "
              f"{task.global_majorant:.4f}, {float(task.bitgrid.float().mean()):.4f} of the "
              f"bitgrid occupied; {enc.n_levels} levels x {enc.n_features_per_level} features, "
              f"{enc.n_entries} table rows ({sum(lv.hashed for lv in enc.levels)} hashed), MLP "
              f"{[tuple(w.shape) for w in task.model.network.weights]}, batch {task.batch_size}")
        mse_before = task.compute_density_mse(VOLUME_MSE_SAMPLES)
        gen = torch.Generator(device=device).manual_seed(SEED + 13)
        n_paths = task.batch_size // tracking.MAX_TRAIN_VERTICES
        checks = volume_model_checks(task, *task.generate_batch(tracking.draw_batch(gen, n_paths)),
                                     "volume_fresh", trained=False)

        torch.cuda.synchronize()
        cuda_lib.reset_launches()
        step_ms = []
        for _ in range(VOLUME_STEPS - PROFILED_STEPS):
            t0 = time.perf_counter()
            tb.frame()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        seen = {}
        wall_ms, busy_ms, top, step_kernels = profile_frames(tb, seen)
        torch.cuda.synchronize()
        launches = dict(cuda_lib.LAUNCHES)
        losses = tb.loss_graph
        print(f"volume launches: {launches}")
        print(f"volume {len(losses)} steps: median {statistics.median(step_ms):.3f} ms/step (min "
              f"{min(step_ms):.3f}, max {max(step_ms):.3f}) on {card}; loss first "
              f"{LOSS_WINDOW} {np.mean(losses[:LOSS_WINDOW]):.6f}, last {LOSS_WINDOW} "
              f"{np.mean(losses[-LOSS_WINDOW:]):.6f}")
        print(f"volume profiled {PROFILED_STEPS} steps: wall {wall_ms:.3f} ms, "
              f"{busy_text(wall_ms, busy_ms)}; device ms per step by port kernel: "
              f"{step_kernels}; top device items (ms): {top}")
        check(len(losses) == VOLUME_STEPS and all(np.isfinite(losses)),
              "a volume loss is not finite")
        check(all(launches[k] > 0 for k in VOLUME_KERNELS), f"a kernel was not launched: {launches}")
        check(all(launches[k] == 0 for k in (*NERF_ONLY_KERNELS, "hashgrid_encode_dx")),
              f"the volume step launched a kernel it does not run: {launches}")
        mse_after = task.compute_density_mse(VOLUME_MSE_SAMPLES)
        print(f"volume density MSE ({VOLUME_MSE_SAMPLES} points): {mse_before:.6f} -> "
              f"{mse_after:.6f}, a fall of {mse_before - mse_after:.6f} (the JAX package's after "
              f"{VOLUME_STEPS} steps: {JAX_VOLUME_MSE}, falls {JAX_VOLUME_GAIN}; gates: after at "
              f"most {MAX_VOLUME_MSE:.6f}, a fall of at least {MIN_VOLUME_GAIN:.6f})")
        check(mse_before - mse_after >= MIN_VOLUME_GAIN and mse_after <= MAX_VOLUME_MSE,
              f"volume density MSE {mse_before} -> {mse_after}, gates {MAX_VOLUME_MSE} and a fall "
              f"of {MIN_VOLUME_GAIN}")

        # L against its plain version; one step, and A, B, E and F, kernels
        # against plain on the trained model
        draws = tracking.draw_batch(gen, n_paths)
        l_check = check_generate_batch(task, draws, gen)
        l_check["device_ms_per_step"] = step_kernels["volume_generate_batch"]
        l_check["profiled_events"] = seen["volume_generate_batch"]
        l_check["device_ms_per_event"] = (step_kernels["volume_generate_batch"] * PROFILED_STEPS
                                          / max(seen["volume_generate_batch"], 1))
        l_check["step_ms"] = statistics.median(step_ms)
        print(f"L device ms: a step of the profiled frames {l_check['device_ms_per_step']:.4f} "
              f"({l_check['profiled_events']} of its {PROFILED_STEPS} launches in the trace, "
              f"{l_check['device_ms_per_event']:.4f} each), warm from a fill "
              f"{l_check['device_ms_warm']:.4f}, cold {l_check['device_ms_cold']:.4f}, back to "
              f"back on one step's draws {l_check['device_ms']:.4f}")
        batch = task.generate_batch(draws)
        del draws
        task_step_gradients_check(task, *batch, what="volume")
        for name, v in volume_model_checks(task, *batch, "volume_trained", trained=True).items():
            checks[name].update(v)
        del batch

        # the renders: learned through A and B, ground truth through M, each
        # against the plain versions on the same draws
        tb.camera_matrix = volume_camera()
        res = VOLUME_RENDER_RES
        cuda_lib.reset_launches()
        frame = seeded_render(tb, res, res)
        render_launches = dict(cuda_lib.LAUNCHES)
        cuda_lib.reset_launches()
        gt = seeded_render(tb, res, res, ground_truth=True)
        gt_launches = dict(cuda_lib.LAUNCHES)
        print(f"volume render launches: learned {render_launches}, ground truth {gt_launches}")
        check(all(render_launches[k] > 0 for k in VOLUME_RENDER_KERNELS)
              and render_launches["volume_trace_gt"] == 0,
              f"the learned render's launches: {render_launches}")
        check(gt_launches["volume_trace_gt"] > 0
              and sum(gt_launches.values()) == gt_launches["volume_trace_gt"],
              f"the ground-truth render's launches: {gt_launches}")
        for f in (frame, gt):
            check(tuple(f.shape) == (res, res, 4) and bool(torch.isfinite(f).all()),
                  "a volume frame")
        task.set_use_kernels(False)
        frame_plain = seeded_render(tb, res, res)
        gt_plain = seeded_render(tb, res, res, ground_truth=True)
        task.set_use_kernels(True)
        db = psnr(frame, frame_plain)
        gt_equal = float((gt == gt_plain).all(-1).float().mean())
        opacity = float(frame[..., 3].mean())
        print(f"volume render {res}x{res} learned, kernels vs plain: PSNR {db:.2f} dB, "
              f"{float((frame == frame_plain).all(-1).float().mean()):.6f} of the pixels bit for "
              f"bit, opacity {opacity:.4f}; ground truth (M) vs plain: {gt_equal:.6f} of the "
              f"pixels bit for bit, alpha mean {float(gt[..., 3].mean()):.4f}")
        check(db >= MIN_PSNR_DB, f"volume learned render kernel vs plain PSNR {db}")
        check(gt_equal == 1.0, f"volume ground truth: {gt_equal} of pixels equal")
        check(opacity > 0.01, f"the learned volume frame's opacity {opacity}")
        render_mse = float(torch.mean((frame[..., :3] - gt[..., :3]) ** 2))
        o, d = pinhole_rays(res, res, tb.camera_matrix, tb.fov, device)
        m_check = check_trace_gt(task, o, d.to(torch.float32),
                                 tracking.draw_gt(gen, o.shape[0]))
        l_check["ragged"] = m_check["ragged"] = check_ragged(task, gen, o, d.to(torch.float32))
        w, h = VOLUME_FRAME_WH
        times = {}
        for key, wh, kw in (("learned_ms", (res, res), {}),
                            ("ground_truth_ms", (res, res), {"ground_truth": True}),
                            ("learned_big_ms", (w, h), {}),
                            ("ground_truth_big_ms", (w, h), {"ground_truth": True})):
            times[key], f = frame_ms(lambda: tb.render_tensor(*wh, **kw))
            check(tuple(f.shape) == (wh[1], wh[0], 4) and bool(torch.isfinite(f).all()),
                  f"the volume frame of {key}")
        print(f"volume frames on {card}: {res}x{res} learned {times['learned_ms']:.3f} ms, ground "
              f"truth {times['ground_truth_ms']:.3f} ms; {w}x{h} learned "
              f"{times['learned_big_ms']:.3f} ms, ground truth {times['ground_truth_big_ms']:.3f} "
              f"ms; learned vs ground truth {res}x{res} render MSE {render_mse:.6f} (reported, "
              f"bench.py::bench_volume's figure)")
        m_check.update(times, render_mse=render_mse)

        rt = snapshot_round_trip(tb, "volume", path, Path(tmp) / "fog.ingp",
                                 lambda t: seeded_render(t, res, res))
        loaded, ref16 = rt["loaded"], rt["ref16"]
        db = psnr(loaded, ref16)
        print(f"volume snapshot: {rt['bytes']} bytes, saved in {rt['save_s']:.3f} s, loaded onto "
              f"the grid in {rt['load_s']:.3f} s; parameters (fp16) and optimizer state bit for bit; "
              f"its render against the saved task's with fp16 parameters: PSNR {db:.2f} dB, "
              f"{'bit for bit' if torch.equal(loaded, ref16) else 'not bit for bit'}; against "
              f"the saved task's own (f32 parameters) {psnr(loaded, frame):.2f} dB")
        check(db >= MIN_LOADED_PSNR_DB, f"the loaded volume render: PSNR {db}")
    print(f"volume phase: {time.perf_counter() - t_phase:.1f} s")
    return launches, render_launches, gt_launches, checks, l_check, m_check


CONFIGS_DIR = ROOT / "configs"
CONFIG_IMAGE_RES = 1024
CONFIG_IMAGE_FRAMES = 50
CONFIG_SDF_FRAMES = 80  # MAPE on the wide configs rises for ~30 steps before it falls
CONFIG_NERF_STEPS = 20
CONFIG_NERF_ROWS = 1 << 17
CONFIG_BIG_FRAMES = 50
CONFIG_LOSS_WINDOW = 10
CONFIG_REPS = 5  # calls a device-time trace of a config's B or F takes
# B and F's device times in the configs phase and beside the narrow route
# are taken on copies of their inputs read in turn (``cold_copies``), so that
# each call's inputs come from HBM as in a training step, not from L2
L2_BYTES = 50 << 20  # the H100's L2
COLD_MAX_COPIES = 16
# The one cut: nerf/densegrid.json's 8 dense levels from 16 at scale 2 end at
# 2048^3; capped at 2^31 rows a level they hold 3,374,616,576 rows x 4 f32
# (50.3 GiB), 201 GiB with Adam's moments and the EMA. Its finest level is
# cut to 512^3 (scale 32^(1/7)): 8 levels x 4 features, the MLPs' widths, kept.
CONFIG_CUTS = {"nerf/densegrid.json": {"per_level_scale": 32.0 ** (1.0 / 7.0)}}
# B and F on a config's MLP: one route each, narrow or wide
MLP_KERNELS = {"narrow": ("fused_mlp", "fused_mlp_bwd"),
               "wide": ("fused_mlp_wide", "fused_mlp_bwd_wide", "fused_mlp_dw_wide")}


def config_files() -> list[tuple[str, Path]]:
    """(mode, path) of every shipped config but volume's."""
    return [(mode, p) for mode in ("image", "sdf", "nerf")
            for p in sorted((CONFIGS_DIR / mode).glob("*.json"))]


class FirstStepInputs:
    """Forward hooks that keep, from the first call with autograd on (a
    training step's forward), each MLP's input x and, through a tensor hook
    on its output, the cotangent g the step's backward gives it; and the
    position encoding's input x."""

    def __init__(self, mlps: dict, encoding):
        self.mlps, self.seen = mlps, {}
        self.handles = [mlp.register_forward_hook(functools.partial(self._hook, label))
                        for label, mlp in mlps.items()]
        self.handles.append(encoding.register_forward_hook(functools.partial(self._hook, "enc")))

    def _hook(self, label, module, args, out):
        if label in self.seen or not torch.is_grad_enabled():
            return
        if label == "enc":
            self.seen[label] = {"x": args[0].detach().clone()}
        elif out.requires_grad:
            self.seen[label] = {"x": args[0].detach().clone()}
            out.register_hook(lambda g: self.seen[label].setdefault("g", g.detach().clone()))

    def remove(self) -> dict:
        for h in self.handles:
            h.remove()
        check(all("g" in self.seen.get(k, {}) for k in self.mlps) and "enc" in self.seen,
              f"a first training step fed no input or cotangent to {sorted(self.mlps)}")
        return self.seen


def mask_differs(ws, x, act: str, zs) -> torch.Tensor:
    """(N,) bool: rows where a hidden ReLU mask (z > 0, z == 0) of kernel F's
    recompute (zs) differs from the plain forward's; none where the hidden
    activation is not ReLU."""
    from instant_ngp_torch.ops.mlp_kernel import fused_mlp_plain

    differs = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    if act.lower() != "relu":
        return differs
    for i, zk in enumerate(zs[:-1]):
        zp = fused_mlp_plain(ws[:i + 1], x, act, "none")
        differs |= ((zk > 0) != (zp > 0)).any(dim=1) | ((zk == 0) != (zp == 0)).any(dim=1)
    return differs


def mlp_bwd_leaves(outs, refs) -> list[dict]:
    """Kernel F's leaves (dX, then dW per layer) against the plain
    version's: max |out - ref| (``err``), max |ref| (``scale``) and their
    ratio (``rel``)."""
    leaves = []
    for i, (o, r) in enumerate(zip(outs, refs)):
        err, scale = max_err(o, r)
        leaves.append({"leaf": "dX" if i == 0 else f"dW{i - 1}", "err": err, "scale": scale,
                       "rel": err / scale if scale > 0 else (0.0 if err == 0 else float("inf"))})
    return leaves


def mlp_bwd_agrees(leaves) -> bool:
    """Every leaf within TOL_MLP_BWD of its own max |ref|, with no floor: a
    training step's cotangent is about 1/N, so dX and dW lie orders of
    magnitude below 1, and an absolute floor would pass any answer."""
    return all(v["err"] <= TOL_MLP_BWD * v["scale"] for v in leaves)


def planted_faults(dx, dws):
    """(what, the leaves with one fault planted): dX zeroed, dX negated, and
    each dW in turn off by 4·TOL_MLP_BWD of itself. ``mlp_bwd_agrees`` must
    refuse every one."""
    yield "dX zero", [torch.zeros_like(dx), *dws]
    yield "dX negated", [-dx, *dws]
    for j, dw in enumerate(dws):
        yield (f"dW{j} scaled by {1 + 4 * TOL_MLP_BWD}",
               [dx, *dws[:j], dw * (1 + 4 * TOL_MLP_BWD), *dws[j + 1:]])


def config_mlp_checks(mlp, x: torch.Tensor, g: torch.Tensor, what: str) -> dict:
    """Kernels B and F on one MLP of a config at its first training step's
    input and cotangent: B's forward bit for bit against F's recompute, every
    layer's pre-activation; B within TOL_MLP of its plain version's max
    |out|; F against its plain version on the rows whose ReLU masks agree
    between F's recompute and the plain forward (``near_tie_rows`` counts
    how many lie within one bf16 step of a tie; every row whose mask differs
    must be one of them), each leaf within TOL_MLP_BWD of its own max |ref|
    (``mlp_bwd_agrees``), and that check refusing every ``planted_faults``
    of F's answer; the device time of each on ``cold_copies`` of its inputs
    (a trace of CONFIG_REPS calls: ``kernel_ms`` of the kernel,
    ``device_ms`` of all the call's device work), the plain versions' times
    (back to back) and the bounds."""
    from instant_ngp_torch.ops import mlp_kernel as mk

    ws = [w.detach() for w in mlp.weights]
    act, out_act = mlp.activation, mlp.output_activation
    dims = (ws[0].shape[0], *[w.shape[1] for w in ws])
    codes = mk.ACTIVATIONS[act.lower()], mk.ACTIVATIONS[out_act.lower()]
    routes = ["narrow" if mk.is_narrow(dims, *codes, backward=b) else "wide" for b in (False, True)]
    zs = mk.mlp_recompute(ws, x, act, out_act)
    for i, z in enumerate(zs):
        zb = mk.fused_mlp(ws[:i + 1], x, act, "none")
        check(torch.equal(zb, z), f"{what}: B and F's recompute differ at layer {i} in "
                                  f"{int((zb != z).any(dim=1).sum())} rows")
    out, ref = mk.fused_mlp(ws, x, act, out_act), mk.fused_mlp_plain(ws, x, act, out_act)
    err_b, scale_b = max_err(out, ref)
    check(err_b <= TOL_MLP * scale_b, f"B {what}: err {err_b} at max |ref| {scale_b}")
    flipped = mask_differs(ws, x, act, zs)
    near = near_tie_rows(ws, x) if act.lower() == "relu" else flipped
    check(not bool((flipped & ~near).any()),
          f"{what}: {int((flipped & ~near).sum())} rows whose ReLU mask differs lie past a tie")
    keep = ~flipped
    xk, gk = x[keep].contiguous(), g[keep].contiguous()
    (dx, dws), (dx_p, dws_p) = (mk.fused_mlp_bwd(ws, xk, gk, act, out_act),
                                mk.fused_mlp_bwd_plain(ws, xk, gk, act, out_act))
    leaves = mlp_bwd_leaves([dx, *dws], [dx_p, *dws_p])
    check(mlp_bwd_agrees(leaves), f"F {what}: a leaf past {TOL_MLP_BWD} of its max |ref|: {leaves}")
    faults = 0
    for fault, outs in planted_faults(dx, dws):
        check(not mlp_bwd_agrees(mlp_bwd_leaves(outs, [dx_p, *dws_p])),
              f"F {what}: the check passes a planted fault, {fault}")
        faults += 1
    n, n_w = x.shape[0], sum(w.numel() for w in ws)
    xs, xgs = cold_copies(x), cold_copies(x, g)
    b_dev = device_split(lambda: mk.fused_mlp(ws, *next(xs), act, out_act), "mlp",
                         reps=CONFIG_REPS, per_call=1)
    f_dev = device_split(lambda: mk.fused_mlp_bwd(ws, *next(xgs), act, out_act),
                         "mlp_wide_kernel" if routes[1] == "wide" else "mlp", reps=CONFIG_REPS,
                         per_call=1)
    del xs, xgs
    wide_f = {}
    if routes[1] == "wide":
        wide_f["dw"] = check_wide_dw(ws, xk, gk, act, out_act, what)
        wide_f["launches"] = check_wide_f_launches(ws, xk, gk, act, out_act)
    b_bound = bound(nbytes(x, out, *ws), 2 * n * n_w, "bfloat16")
    # x, g and the weights read, dX and every dW written, f32
    f_bound = bound(4 * (2 * x.numel() + g.numel() + 2 * n_w), mlp_bwd_ops(ws, n), "bfloat16")
    # the wide F's design floor: that, and its h_i and dz_i (bf16, dz_{L-1} as
    # three terms) written once and read once by the dW kernel, over the HBM rate
    inter = 2 * 2 * n * (sum(dims[:-1]) + sum(dims[1:-1]) + 3 * dims[-1])
    f_floor_ms = (4 * (2 * x.numel() + g.numel() + 2 * n_w) + inter) / HBM_BYTES_PER_S * 1e3
    return {"dims": dims, "activations": (act, out_act), "rows": n, "routes": routes,
            "bit_equal_layers": len(zs), "b_err": err_b, "b_scale": scale_b,
            "b_rel": err_b / scale_b, "f_err": max(v["err"] for v in leaves),
            "f_rel": max(v["rel"] for v in leaves), "f_leaves": leaves,
            "planted_faults_refused": faults,
            "mask_differs_rows": int(flipped.sum()), "near_tie_rows": int(near.sum()),
            "b_kernel_ms": b_dev["kernel_ms"], "b_device_ms": b_dev["device_ms"],
            "f_kernel_ms": f_dev["kernel_ms"], "f_device_ms": f_dev["device_ms"],
            "timed_by": (b_dev["timed_by"], f_dev["timed_by"]),
            "events_per_call": (b_dev["events_per_call"], f_dev["events_per_call"]),
            "b_plain_ms": time_ms(lambda: mk.fused_mlp_plain(ws, x, act, out_act),
                                  reps=CONFIG_REPS, warmup=1),
            "f_plain_ms": time_ms(lambda: mk.fused_mlp_bwd_plain(ws, x, g, act, out_act),
                                  reps=CONFIG_REPS, warmup=1),
            "b_bound_ms": b_bound["bound_ms"], "b_bound_by": b_bound["bound_by"],
            "f_bound_ms": f_bound["bound_ms"], "f_bound_by": f_bound["bound_by"],
            "f_floor_ms": f_floor_ms if routes[1] == "wide" else None, **wide_f}


def grid_slice_checks(enc, x: torch.Tensor, density, seen: dict, what: str) -> dict:
    """Kernels A and E at D = 1: nerf/tensor.json's third slice, a 1-D grid
    over z, on the first training step's positions x; E on that slice's
    cotangent, the density MLP's dX (kernel F) at the step's own input and
    cotangent (``seen``, as ``FirstStepInputs`` keeps them). Each is held
    within its tolerance of its plain version's max |ref| with no floor (the
    values lie far below 1: E's near 1e-3). Returns {kernel name: {variant:
    check}}."""
    from instant_ngp_torch.ops import mlp_kernel as mk

    ws = [w.detach() for w in density.weights]
    dx = mk.fused_mlp_bwd(ws, seen["x"], seen["g"], density.activation,
                          density.output_activation)[0]
    check(enc.begins is not None, f"{what}: the Composite has no explicit slices")
    col = 0
    for b, grid in zip(enc.begins, enc.nested):
        if grid.n_dims_to_encode == 1:
            break
        col += grid.n_output_dims
    check(grid.n_dims_to_encode == 1, f"{what}: no 1-D grid among the slices")
    x1 = x[:, b:b + 1].contiguous()
    g1 = dx[:, col:col + grid.n_output_dims].contiguous()
    table = grid.table.detach()
    out = {"hashgrid_encode_fwd": {what: check_encode(grid.levels, grid.interpolation, table, x1,
                                                      what, floor=0.0)},
           "hashgrid_encode_bwd": {what: check_encode_bwd(
               grid.levels, grid.interpolation, x1, g1, grid.n_entries,
               grid.hashed_grad_corners, what, floor=0.0)}}
    for name, v in out.items():
        print(f"kernel {name} at D = 1 ({what}, {x1.shape[0]} positions, {len(grid.levels)} "
              f"levels): max_abs_err {v[what]['max_abs_err']:.3e} of max |ref| "
              f"{v[what]['scale']:.3e}, kernel {v[what]['ms']:.4f} ms, plain "
              f"{v[what]['plain_ms']:.3f} ms, bound {v[what]['bound_ms']:.4f} ms")
    return out


def nerf_model_run(cfg: dict, device) -> tuple:
    """configs/nerf/*.json at the model level, as tests/test_configs_smoke.py
    drives it: ``NerfNetwork.from_config``, fresh weights from SEED, and a
    trainer of CONFIG_NERF_STEPS steps of the config's loss and optimizer on
    CONFIG_NERF_ROWS seeded positions, directions and targets. Returns (the
    model's MLPs by label, the trainer, which returns the losses)."""
    from instant_ngp_torch.models.nerf_network import NerfNetwork
    from instant_ngp_torch.ops.losses import loss_fn, loss_type_from_string
    from instant_ngp_torch.ops.optimizers import Optimizer, OptimizerSpec

    model = NerfNetwork.from_config(cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    model.init(gen)
    pos, dirs, target = (torch.rand((CONFIG_NERF_ROWS, k), generator=gen, device=device)
                         for k in (3, 3, 4))
    lfn = loss_fn(loss_type_from_string(cfg.get("loss", {}).get("otype", "L2")))
    opt = Optimizer(OptimizerSpec.from_config(cfg.get("optimizer", {})), model.matrix_mask())
    params = model.param_list()
    state = opt.init(params)

    def train() -> list[float]:
        losses = []
        for _ in range(CONFIG_NERF_STEPS):
            loss = torch.mean(lfn(target, model(pos, dirs)))
            grads = torch.autograd.grad(loss, params)
            with torch.no_grad():
                opt.update(list(grads), state, params)
            losses.append(loss.detach())
        return [float(v) for v in torch.stack(losses).cpu()]

    return {"density": model.density_network, "rgb": model.rgb_network}, train, model.pos_encoding


def encoding_times(enc, x: torch.Tensor) -> dict | None:
    """Device ms of a position encoding that is no grid (plain torch; grids
    are kernels A and E, timed by the other phases) on x, its input at a
    training step: its forward, and for one with a table (Takikawa) the
    forward and the table's gradient, also between CUDA events. None for a
    grid or a Composite of grids."""
    from instant_ngp_torch.ops.encodings import Composite
    from instant_ngp_torch.ops.hashgrid import GridEncoding

    if isinstance(enc, GridEncoding) or (
            isinstance(enc, Composite) and all(isinstance(e, GridEncoding) for e in enc.nested)):
        return None
    rows = x.shape[0]
    with torch.no_grad():
        out = {"encoding": type(enc).__name__, "rows": rows,
               "forward_ms": device_split(lambda: enc(x), "", reps=CONFIG_REPS)["device_ms"]}
    tables = [p for p in enc.parameters()]
    if tables:
        g = torch.ones((rows, enc.n_output_dims), device=x.device)

        def step():
            return torch.autograd.grad(enc(x), tables, grad_outputs=g)

        out["forward_backward_ms"] = device_split(step, "", reps=CONFIG_REPS)["device_ms"]
        out["forward_backward_events_ms"] = time_ms(step, reps=CONFIG_REPS, warmup=1)
    return out


def testbed_run(mode: str, path: Path, data: Path, frames: int, device):
    """The user's path: ``Testbed(mode)``, ``reload_network_from_file`` and
    ``load_training_data``; the trainer runs ``frames`` frames. Returns (the
    task's MLPs by label, the trainer, the Testbed)."""
    from instant_ngp_torch.testbed import Testbed

    tb = Testbed(mode, device=device)
    tb.reload_network_from_file(path)
    tb.load_training_data(data)
    model = tb.task.model
    mlps = ({"density": model.density_network, "rgb": model.rgb_network} if mode == "nerf"
            else {"net": model.network})
    enc = model.pos_encoding if mode == "nerf" else model.encoding

    def train() -> list[float]:
        for _ in range(frames):
            tb.frame()
        return list(tb.loss_graph[-frames:])

    return mlps, train, tb, enc


def configs_phase(device, card, scene: Path) -> tuple[dict, dict, dict]:
    """Every shipped config but volume's trains at full width on the card
    through its entry point: the image configs through Testbed("image") on
    make_image(CONFIG_IMAGE_RES, SEED) for CONFIG_IMAGE_FRAMES frames, the SDF
    configs through Testbed("sdf") on the sdf phase's mesh for
    CONFIG_SDF_FRAMES frames, every NeRF config at the model level
    (``nerf_model_run``) and nerf/big.json also through Testbed("nerf") on the
    disk phase's scene for CONFIG_BIG_FRAMES frames. Each run is driven with
    the launch counts set to 0 just before it and read just after; every loss
    must be finite, and the image and SDF runs' last CONFIG_LOSS_WINDOW must
    average below their first. Then, per config and MLP, kernels B and F at
    the first step's input and cotangent (``config_mlp_checks``), one printed
    line each; kernels A and E on nerf/tensor.json's 1-D slice
    (``grid_slice_checks``). Returns (the launches summed over the runs, the
    checks by run label, A and E's checks at D = 1)."""
    from instant_ngp_torch import cuda_lib
    from instant_ngp_torch.config import load_network_config
    from instant_ngp_torch.geometry.procedural import bumpy_torus, write_obj
    from instant_ngp_torch.io.image import save_image

    t_phase = time.perf_counter()
    launches = {name: 0 for name in cuda_lib.LAUNCHES}
    results, slice_checks = {}, None
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        image = Path(tmp) / "image.bin"
        save_image(image, make_image(CONFIG_IMAGE_RES, SEED))
        v, f = bumpy_torus(*SDF_GRID, seed=SEED)
        mesh = Path(tmp) / "torus.obj"
        write_obj(mesh, v, f)
        runs = [(f"{m}/{p.name}", m, p) for m, p in config_files()]
        runs.append(("nerf/big.json frame()", "nerf_frames", CONFIGS_DIR / "nerf" / "big.json"))
        for label, mode, path in runs:
            t0 = time.perf_counter()
            tb = None
            if mode == "nerf":
                cfg = load_network_config(path, mode="nerf")
                cfg["encoding"] = {**cfg["encoding"], **CONFIG_CUTS.get(label, {})}
                mlps, train, enc = nerf_model_run(cfg, device)
            elif mode == "nerf_frames":
                mlps, train, tb, enc = testbed_run("nerf", path, scene, CONFIG_BIG_FRAMES,
                                                   device)
            else:
                frames = CONFIG_IMAGE_FRAMES if mode == "image" else CONFIG_SDF_FRAMES
                mlps, train, tb, enc = testbed_run(mode, path, image if mode == "image" else mesh,
                                                   frames, device)
            setup_s = time.perf_counter() - t0
            hooks = FirstStepInputs(mlps, enc)
            torch.cuda.synchronize()
            cuda_lib.reset_launches()
            t0 = time.perf_counter()
            losses = train()
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            run_launches = dict(cuda_lib.LAUNCHES)
            inputs = hooks.remove()
            if tb is not None and mode == "sdf":
                tb.task.stop_producer()
            for k, n in run_launches.items():
                launches[k] += n
            check(all(np.isfinite(losses)), f"{label}: a loss is not finite: {losses}")
            first = float(np.mean(losses[:CONFIG_LOSS_WINDOW]))
            last = float(np.mean(losses[-CONFIG_LOSS_WINDOW:]))
            if mode in ("image", "sdf"):
                check(last < first, f"{label}: the loss rose from {first} to {last}")
            mlp_checks = {}
            for name, mlp in mlps.items():
                v = config_mlp_checks(mlp, inputs[name]["x"], inputs[name]["g"], f"{label} {name}")
                b_name, f_name = MLP_KERNELS[v["routes"][0]][0], MLP_KERNELS[v["routes"][1]][1]
                check(run_launches[b_name] > 0 and run_launches[f_name] > 0,
                      f"{label} {name}: {b_name} or {f_name} was not launched: {run_launches}")
                check(v["routes"][1] != "wide" or run_launches["fused_mlp_dw_wide"] > 0,
                      f"{label} {name}: the wide F's dW kernel was not launched: {run_launches}")
                mlp_checks[name] = v
                rels = ", ".join(f"{u['leaf']} {u['rel']:.1e}" for u in v["f_leaves"])
                print(f"config {label} {name}: widths {v['dims']}, {len(v['dims']) - 1} matrices, "
                      f"{v['activations'][0]}/{v['activations'][1]}, routes B {v['routes'][0]} "
                      f"F {v['routes'][1]}; {v['rows']} first-step rows: B {v['b_kernel_ms']:.4f}"
                      f" ms (call {v['b_device_ms']:.4f}, plain {v['b_plain_ms']:.4f}, bound "
                      f"{v['b_bound_ms']:.4f} {v['b_bound_by']}), F {v['f_kernel_ms']:.4f} ms "
                      f"(call {v['f_device_ms']:.4f}, plain {v['f_plain_ms']:.4f}, bound "
                      f"{v['f_bound_ms']:.4f} {v['f_bound_by']}); B = F's recompute bit for bit "
                      f"on {v['bit_equal_layers']} layers, B err {v['b_err']:.3e} "
                      f"({v['b_rel']:.2e} of max |ref|), F err {v['f_err']:.3e} (of max |ref| "
                      f"at most {v['f_rel']:.2e}: {rels}; "
                      f"{v['planted_faults_refused']} planted faults refused; "
                      f"{v['mask_differs_rows']} rows with a differing ReLU mask left out; "
                      f"{v['near_tie_rows']} near a tie)")
                if "dw" in v:
                    d = v["dw"]
                    print(f"config {label} {name}: F's dW kernel {d['ms']:.4f} ms (plain "
                          f"{d['plain_ms']:.4f}, torch.mm {d['library_ms']:.4f}, bound "
                          f"{d['bound_ms']:.4f} {d['bound_by']}), within {d['max_rel_err']:.2e} of "
                          f"mlp_dw_plain's max |ref|; F's design floor {v['f_floor_ms']:.4f} ms; "
                          f"a wide F call's device kernels {v['launches']['device_kernels']}")
            if label == "nerf/tensor.json":
                slice_checks = grid_slice_checks(enc, inputs["enc"]["x"], mlps["density"],
                                                 inputs["density"], label)
            enc_ms = encoding_times(enc, inputs["enc"]["x"])
            if enc_ms is not None:
                print(f"config {label} encoding: {enc_ms}")
            print(f"config {label}: loss {losses[0]:.6f} -> {losses[-1]:.6f} (mean of the first "
                  f"{CONFIG_LOSS_WINDOW} {first:.6f}, last {last:.6f}) in {len(losses)} steps; "
                  f"set-up {setup_s:.2f} s, training {train_s:.2f} s; launches "
                  f"{ {k: n for k, n in run_launches.items() if n} }")
            results[label] = {"mlps": mlp_checks, "encoding": enc_ms, "loss_first": losses[0],
                              "loss_last": losses[-1], "steps": len(losses),
                              "train_s": train_s, "launches": run_launches}
            del mlps, train, tb, hooks, inputs, enc
            torch.cuda.empty_cache()
    from instant_ngp_torch.ops.encodings import TriangleWave

    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    tri = encoding_times(TriangleWave(12, 3),
                         torch.rand((CONFIG_NERF_ROWS, 3), generator=gen, device=device))
    print(f"encoding TriangleWave, on no config's path: {tri}")
    print(f"configs phase: {len(results)} runs in {time.perf_counter() - t_phase:.1f} s on "
          f"{card}; launches {launches}")
    check(len(results) == 26, f"{len(results)} config runs for 25 configs and nerf/big's frames")
    check(slice_checks is not None, "no run held A and E at D = 1")
    check(all(launches[k] > 0 for k in (*MLP_KERNELS["narrow"], *MLP_KERNELS["wide"],
                                        "hashgrid_encode_fwd", "hashgrid_encode_bwd")),
          f"a kernel was not launched: {launches}")
    return launches, results, slice_checks


def config_records(results: dict) -> list[dict]:
    """The JSON records of the wide route's B and F: the headline is the
    widest config, image/oneblob.json (256 -> 128 x 8 -> 3, 2^18 rows); the
    error, absolute and relative to max |ref| (F's: per leaf), is the largest
    over every config that took the route; every config's MLP is a
    variant."""
    records = []
    for i, (name, kernel) in enumerate((("fused_mlp_wide", "b"), ("fused_mlp_bwd_wide", "f"))):
        variants = {f"{label} {m}": v for label, r in results.items()
                    for m, v in r["mlps"].items() if v["routes"][i] == "wide"}
        head = results["image/oneblob.json"]["mlps"]["net"]
        records.append({
            "name": name, "route": "cuda", "source": "instant_ngp_torch/csrc/mlp_wide.cu",
            "replaces": ("instant_ngp_tpu/ops/pallas/mlp_kernel.py:53" if kernel == "b" else
                         "instant_ngp_tpu/ops/pallas/mlp_kernel.py:106"),
            "max_abs_err": max(v[f"{kernel}_err"] for v in variants.values()),
            "max_rel_err": max(v[f"{kernel}_rel"] for v in variants.values()),
            "ms": head[f"{kernel}_kernel_ms"], "plain_ms": head[f"{kernel}_plain_ms"],
            "bound_ms": head[f"{kernel}_bound_ms"], "bound_by": head[f"{kernel}_bound_by"],
            "library_ms": None, "call_device_ms": head[f"{kernel}_device_ms"],
            "path": "configs", "variants": variants})
        print(f"kernel {name}: max_abs_err {records[-1]['max_abs_err']:.3e} (of max |ref| at most "
              f"{records[-1]['max_rel_err']:.2e}) kernel "
              f"{records[-1]['ms']:.4f} ms plain {records[-1]['plain_ms']:.4f} ms bound "
              f"{records[-1]['bound_ms']:.4f} ms ({records[-1]['bound_by']}) at image/oneblob.json;"
              f" {len(variants)} MLPs of the configs took the route")
    records[-1]["source"] = "instant_ngp_torch/csrc/mlp_wide_bwd.cu"
    records[-1]["floor_ms"] = head["f_floor_ms"]
    # F's second launch, dW: its own record, the same configs as variants
    variants = {f"{label} {m}": v["dw"] for label, r in results.items()
                for m, v in r["mlps"].items() if "dw" in v}
    head = results["image/oneblob.json"]["mlps"]["net"]["dw"]
    records.append({
        "name": "fused_mlp_dw_wide", "route": "cuda", "source": "instant_ngp_torch/csrc/mlp_wide_dw.cu",
        "replaces": "instant_ngp_tpu/ops/pallas/mlp_kernel.py:106",
        "max_abs_err": max(v["max_abs_err"] for v in variants.values()),
        "max_rel_err": max(v["max_rel_err"] for v in variants.values()),
        "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": head["library_ms"], "path": "configs",
        "variants": variants})
    print(f"kernel fused_mlp_dw_wide: max_abs_err {records[-1]['max_abs_err']:.3e} (of max |ref| at "
          f"most {records[-1]['max_rel_err']:.2e}) kernel {head['ms']:.4f} ms plain "
          f"{head['plain_ms']:.4f} ms torch.mm {head['library_ms']:.4f} ms bound "
          f"{head['bound_ms']:.4f} ms ({head['bound_by']}) at image/oneblob.json; {len(variants)} "
          f"MLPs of the configs took it")
    return records



def gather_phase() -> dict:
    """``instant_ngp_torch.bench.gather`` at its case lists, few repetitions.
    Returns its launches."""
    from instant_ngp_torch import cuda_lib
    from instant_ngp_torch.bench import gather as bench_gather

    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    lines = bench_gather.run(iters=BENCH_ITERS, warmup=BENCH_WARMUP, seed=SEED)
    torch.cuda.synchronize()
    launches = dict(cuda_lib.LAUNCHES)
    print(f"gather microbenchmarks: {len(lines)} lines, launches {launches}")
    n_cases = (len(bench_gather.TAKE_LIBRARY_CASES) + len(bench_gather.TAKE_KERNEL_CASES) + 1
               + len(bench_gather.ONEHOT_LOG2_T) + len(bench_gather.COL_CASES))
    check(len(lines) == n_cases, f"{len(lines)} microbenchmark lines for {n_cases} cases")
    check(all(launches[k] > 0 for k in BENCH_KERNELS), f"a kernel was not launched: {launches}")
    return launches


def main() -> None:
    name, card = phase_device()
    phase_build()
    from instant_ngp_torch import cuda_lib
    from instant_ngp_torch.testbed import Testbed

    device = torch.device("cuda")
    t0 = time.perf_counter()
    tb = Testbed("nerf", device=device)
    tb.load_snapshot(SNAPSHOT)
    print(f"load_snapshot: {time.perf_counter() - t0:.2f} s")
    results = kernel_checks(tb, device)

    tiny = Testbed("nerf", device=device)
    tiny.load_snapshot(TINY_SNAPSHOT)
    xf, kw = view0(tiny, TINY_RES)
    frame = tiny.render_tensor(TINY_RES, TINY_RES, xf, **kw)
    db = psnr_vs_plain(tiny, frame, TINY_RES, xf, kw)
    print(f"tiny fixture {TINY_RES}x{TINY_RES} kernel vs plain: PSNR {db:.2f} dB")
    check(db >= MIN_PSNR_DB, f"tiny fixture kernel vs plain PSNR {db}")

    # the render path: a 256x256 frame of view 0 with bench.py's arguments
    xf, kw = view0(tb, RES)
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    frame = tb.render_tensor(RES, RES, xf, **kw)
    torch.cuda.synchronize()
    render_launches = dict(cuda_lib.LAUNCHES)
    print(f"render launches: {render_launches}")
    check(all(render_launches[k] > 0 for k in RENDER_KERNELS),
          f"a kernel was not launched: {render_launches}")
    check(tuple(frame.shape) == (RES, RES, 4), f"frame shape {tuple(frame.shape)}")
    check(bool(torch.isfinite(frame).all()), "frame has non-finite values")
    alpha_mean = float(frame[..., 3].mean())
    check(alpha_mean > 0.05, f"alpha mean {alpha_mean}")

    db = psnr_vs_plain(tb, frame, RES, xf, kw)
    print(f"render kernel vs plain: PSNR {db:.2f} dB, alpha mean {alpha_mean:.4f}")
    check(db >= MIN_PSNR_DB, f"kernel vs plain PSNR {db}")

    t0 = time.perf_counter()
    tb.render_tensor(RES, RES, xf, **kw)
    torch.cuda.synchronize()
    frame_s = time.perf_counter() - t0
    print(f"render {RES}x{RES}: {frame_s * 1e3:.2f} ms, {RES * RES / frame_s / 1e6:.3f} Mrays/s "
          f"on {card}")

    # the training path
    train_results, march, train_launches, nerf_pair = train_phase(tb, device, card)
    results += train_results

    # a scene from disk: train, save, load without and with the scene; the
    # configs phase trains nerf/big.json on it too
    (ROOT / "build").mkdir(exist_ok=True)
    scenes = tempfile.TemporaryDirectory(dir=ROOT / "build")
    scene = Path(scenes.name) / "scene"
    disk_launches, disk_render_launches, disk_checks = disk_phase(device, card, scene)
    disk_pair = disk_checks.pop("fwd_bwd_pair")
    for r in results:  # the disk path's checks are variants of each record
        for variant, v in disk_checks.get(r["name"], {}).items():
            r.setdefault("variants", {})[variant] = v
            r["max_abs_err"] = max(r["max_abs_err"], v["max_abs_err"])

    # the image path and the gather microbenchmarks
    results += gather_kernel_checks(device)
    image_main, image_launches, image_eval_launches = image_phase(device, card)
    # kernel F's record stays the fox MLPs'; the image checks are variants
    f_image = image_main.pop("fused_mlp_bwd")
    f_trained = image_main.pop("fused_mlp_bwd_trained")
    image_pair = image_main.pop("fwd_bwd_pair")
    take_image_step = image_main.pop("take_rows_image_step")
    for r in results:
        if r["name"] == "fused_mlp_bwd":
            r["variants"]["image_first_step"] = f_image
            r["variants"]["image_trained"] = f_trained
            r["max_abs_err"] = max(r["max_abs_err"], f_image["max_abs_err"],
                                   f_trained["max_abs_err"])
        if r["name"] == "fused_mlp":
            r["fwd_bwd_pair"] = {"fox_trained": nerf_pair, "disk_trained": disk_pair,
                                 "image_trained": image_pair}
        if r["name"] == "take_rows":
            r["variants"]["image_step_texels"] = take_image_step
        if r["name"] in image_main:
            take_main_path(r, image_main[r["name"]])
    bench_launches = gather_phase()

    # the SDF path: its shapes of A, B, E and F are variants of their records
    sdf_launches, sdf_render_launches, sdf_checks, k_check = sdf_phase(device, card)
    for r in results:
        for variant, v in sdf_checks.get(r["name"], {}).items():
            r.setdefault("variants", {})[variant] = v
            r["max_abs_err"] = max(r["max_abs_err"], v["max_abs_err"])
    # the volume path: kernels L and M, and A, B, E and F at its shapes
    (volume_launches, volume_render_launches, volume_gt_launches, volume_checks, l_check,
     m_check) = volume_phase(device, card)
    for r in results:
        for variant, v in volume_checks.get(r["name"], {}).items():
            r.setdefault("variants", {})[variant] = v
            r["max_abs_err"] = max(r["max_abs_err"], v["max_abs_err"])
    # every shipped config but volume's: the wide route of B and F
    try:
        config_launches, config_checks, slice_checks = configs_phase(device, card, scene)
    finally:
        scenes.cleanup()
    for r in results:  # A and E at D = 1 are variants of their records
        for variant, v in slice_checks.get(r["name"], {}).items():
            r.setdefault("variants", {})[variant] = v
            r["max_abs_err"] = max(r["max_abs_err"], v["max_abs_err"])
    results += config_records(config_checks)
    record_kernel(results, "hashgrid_encode_dx", "instant_ngp_torch/csrc/hashgrid_bwd.cu",
                  "instant_ngp_tpu/ops/hashgrid.py:333", k_check["max_abs_err"],
                  **headline(k_check),
                  extra=f" ({k_check['equal_rows']} of {k_check['rows']} rows bit for bit)",
                  path="sdf_render", variants={"sdf_render_hits": k_check})
    record_kernel(results, "volume_generate_batch", "instant_ngp_torch/csrc/volume.cu",
                  "instant_ngp_tpu/volume/task.py:160", l_check["max_abs_err"], **headline(l_check),
                  extra=f" ({l_check['bit_equal_paths']:.6f} of the paths bit for bit; device "
                        f"{l_check['device_ms_per_step']:.4f} ms a step)",
                  path="volume", device_ms=l_check["device_ms"],
                  device_ms_per_step=l_check["device_ms_per_step"],
                  device_ms_warm=l_check["device_ms_warm"],
                  device_ms_cold=l_check["device_ms_cold"], redesigned=VOLUME_DESIGN,
                  variants={"volume_step": l_check})
    record_kernel(results, "volume_trace_gt", "instant_ngp_torch/csrc/volume.cu",
                  "instant_ngp_tpu/volume/task.py:365", m_check["max_abs_err"], **headline(m_check),
                  extra=f" ({m_check['bit_equal_rays']:.6f} of the rays bit for bit; device "
                        f"{m_check['device_ms']:.4f} ms at {VOLUME_RENDER_RES}^2)",
                  path="volume_gt", device_ms=m_check["device_ms"], redesigned=VOLUME_DESIGN,
                  variants={f"volume_render_{VOLUME_RENDER_RES}": m_check})

    paths = {"render": render_launches, "train": train_launches, "disk": disk_launches,
             "disk_render": disk_render_launches, "image": image_launches,
             "image_eval": image_eval_launches, "bench": bench_launches, "sdf": sdf_launches,
             "sdf_render": sdf_render_launches, "volume": volume_launches,
             "volume_render": volume_render_launches, "volume_gt": volume_gt_launches,
             "configs": config_launches}
    for r in results:
        if r["name"] == "march_rays":
            r.update(march)
        counter = r.pop("counter", r["name"])
        path = r.pop("path", None)
        for path_name, counts in paths.items():
            r[f"{path_name}_launches"] = counts[counter]
        # launches: those of the record's own path; for the kernels of the NeRF
        # paths, the training run's where it runs them, else the render's
        r["launches"] = (paths[path][counter] if path is not None
                         else train_launches[counter] or render_launches[counter])
        if r["name"] == "gather_cols_sum":  # the transpose route's first launch
            r["transpose_launches"] = bench_launches["gather_cols_transpose"]
    print(json.dumps({"kernels": results}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.exit(0)
