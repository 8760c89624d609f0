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
  path's form, added straight into the error map, and into zeros); kernel C
  is also held at the training march on the snapshot's trained grid, and H
  at the Pallas probes' shapes, with rows of 4 and with int32 indices;
- image: kernels A and E at D = 2 on the level specs of a 16384^2 image,
  kernel I at every shape of ``scripts/bench_gather_tpu.py`` and kernel J at
  every shape of ``scripts/bench_dyngather.py`` against their plain versions;
  then an 8192^2 RGBA image made from SEED, written as a ``.bin`` file, is
  fitted with ``configs/image/base.json`` for 300 steps of 2^18 samples
  through ``Testbed("image")`` and ``frame()``, checked to go through kernels
  A, B, E, F and I, to lower its loss and to raise its PSNR; one step through
  the kernels is held against the same step through the plain versions, and
  a 1920x1080 render against the plain render;
- kernels B and F together: one ``fused_mlp`` call profiled (one device
  kernel and no PyTorch op besides the output's allocation); B's forward
  bit for bit against F's forward recompute, every layer's pre-activation,
  for both trained fox MLPs and the trained image MLP; F against its plain
  version on the trained image MLP with the rows near a ReLU tie left out;
- gather microbenchmarks: ``instant_ngp_torch.bench.gather`` at its case
  lists with few repetitions, through kernels I and J.

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
# order on the card) by up to K * 2^-24 of rgb
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
# kernel J at every case of scripts/bench_dyngather.py:68-70
COL_CASES = ((8, torch.float32), (64, torch.float32), (512, torch.float32),
             (4096, torch.float32), (32768, torch.float32), (4096, torch.bfloat16))
COLS, COL_REPS = 128, 8
TOL_GATHER_COLS_F32 = 1e-6  # relative; the same adds in the same order
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


def device_split(fn, kernel: str, reps: int = 20) -> dict:
    """Device milliseconds per call of fn: the durations of the card's events
    of reps calls under torch.profiler, after one warm-up call, over reps.
    ``device_ms``: all of them; ``kernel_ms``: those of the kernels whose
    name holds ``kernel`` (the rest is fills and copies)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [(e.name, (e.time_range.end - e.time_range.start) / 1e3 / reps) for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    return {"device_ms": sum(ms for _, ms in events),
            "kernel_ms": sum(ms for name, ms in events if kernel in name)}


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


def render_window_march(tb, device):
    """The render path's first window of view 0 at RES^2 (K 8, 64
    iterations, from the crop-box entry): (march arguments, tmin, tmax)."""
    from instant_ngp_torch.nerf.sampler import MarchConfig

    task, ds = tb.task, tb.nerf_dataset
    w, h = ds.resolution
    fl = task._t([ds.focal_lengths[0, 0] * RES / w, ds.focal_lengths[0, 1] * RES / h])
    ys, xs = torch.meshgrid(torch.arange(RES, device=device), torch.arange(RES, device=device),
                            indexing="ij")
    uv = torch.stack([(xs.reshape(-1) + 0.5) / RES, (ys.reshape(-1) + 0.5) / RES], -1).float()
    o, d, tmin, tmax = task._prep_rays(uv, task._t([RES, RES]), fl,
                                       task._t(ds.principal_points[0]),
                                       task._t(ds.xforms_start[0]))
    cfg = MarchConfig(n_march_iters=task.render_march_iters,
                      max_samples_per_ray=task.render_samples_per_window,
                      cone_angle=task.cone_angle, max_mip=task.max_cascade)
    return (o, d, task.skipmip, *task._aabb_t, torch.full_like(tmin, 0.5), cfg), tmin, tmax


def training_march(task, skipmip, gen, device, n_iters: int = TRAIN_ITERS):
    """The training march's arguments: TRAIN_RAYS rays of random pixels of
    the task's views, random jitter, K TRAIN_K, n_iters iterations, on the
    skip chain ``skipmip``."""
    from instant_ngp_torch.nerf import train as nerf_train
    from instant_ngp_torch.nerf.sampler import MarchConfig

    R = TRAIN_RAYS
    img = torch.randint(0, task.dataset.n_images, (R,), generator=gen, device=device)
    o, d = nerf_train.generate_rays(task, img, torch.rand((R, 2), generator=gen, device=device))
    jitter = torch.rand((R,), generator=gen, device=device)
    cfg = MarchConfig(n_march_iters=n_iters, max_samples_per_ray=TRAIN_K,
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
    from instant_ngp_torch.nerf.task import composite_window, composite_window_plain
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
    record("fused_mlp", "instant_ngp_torch/csrc/mlp.cu",
           "instant_ngp_tpu/ops/pallas/mlp_kernel.py:53", max(v["max_abs_err"] for v in both),
           sum(v["ms"] for v in both), sum(v["plain_ms"] for v in both),
           bound(sum(v["bytes"] for v in both), sum(v["ops"] for v in both), "bfloat16"),
           extra=f" (32->64->16 plus 32->64->64->3; max |ref| {both[0]['scale']:.3f}, "
                 f"{both[1]['scale']:.3f}; one call: {one})", one_launch=one)

    # C: march the rays of view 0 at RES^2, K = 8, 64 iterations, fox grid
    margs, tmin, tmax = render_window_march(tb, device)
    o, d = margs[:2]
    v = check_march(margs, tmin, "render window")
    ts, dts, valid, t_exit, _ = march_rays(*margs, t_init=tmin)
    record("march_rays", "instant_ngp_torch/csrc/march.cu", "instant_ngp_tpu/nerf/sampler.py:49",
           v["max_abs_err"], **headline(v),
           extra=f" (n_valid agrees on {v['n_valid_agree']:.6f} of {o.shape[0]} rays; {v})",
           variants={"render_window": v})

    # D: composite that window with the model's outputs on its samples
    R = o.shape[0]
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
    record("composite_window", "instant_ngp_torch/csrc/composite.cu",
           "instant_ngp_tpu/nerf/task.py:1853", err, time_ms(lambda: composite_window(*cargs)),
           time_ms(lambda: composite_window_plain(*cargs)),
           bound(nbytes(*[a for a in cargs if torch.is_tensor(a)], *k_res[1:])))
    return results


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
def eval_views(task, ds) -> tuple[list[tuple[float, float]], float]:
    """bench.py::bench_fox's evaluation: the task renders each EVAL_VIEWS
    view against its training image, both premultiplied sRGB on black.
    Returns ((Huber loss, PSNR dB) per view, the PSNR of their mean MSE)."""
    from instant_ngp_torch.ops.losses import huber

    w, h = ds.resolution
    per_view, mses = [], []
    for i in EVAL_VIEWS:
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
    from instant_ngp_torch.nerf import train as nerf_train
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
    record("fused_mlp_bwd", "instant_ngp_torch/csrc/mlp_bwd.cu",
           "instant_ngp_tpu/ops/pallas/mlp_kernel.py:106",
           max(v["max_abs_err"] for v in variants.values()), sum(v["ms"] for v in both),
           sum(v["plain_ms"] for v in both),
           bound(sum(v["bytes"] for v in both), sum(v["ops"] for v in both), "bfloat16"),
           extra=f" ({n} rows, 32->64->16 plus 32->64->64->3: dX and every dW; all: {variants})",
           variants=variants)

    # C at the training march: rays of random pixels of the training views,
    # on the snapshot's (trained) occupancy grid
    R = TRAIN_RAYS
    margs = training_march(task, tb.task.skipmip, gen, device)
    o, d = margs[:2]
    march = {f"train_{k}": v for k, v in check_march(margs, None, "training march").items()}
    print(f"kernel march_rays at the training march ({R} rays, K {TRAIN_K}, {TRAIN_ITERS} iters, "
          f"random jitter, the snapshot's grid): {march}")
    ts, dts, valid, _, _ = march_rays(*margs)

    # G: the snapshot model's outputs on those samples against random pixels
    out = tb.task._eval_window(o, d, ts, valid)
    target = torch.rand((R, 3), generator=gen, device=device)
    bg = torch.rand((R, 3), generator=gen, device=device)
    pixel_ok = torch.rand((R,), generator=gen, device=device) > 0.05
    gargs = (out, ts, dts, valid.contiguous(), target, bg, pixel_ok,
             tb.task.state.grid.mean_density, task.training_near_distance,
             task.density_reg_scale * nerf_train.INV_LOSS_SCALE, 1.0 / R, task.loss_type,
             task.rgb_activation, task.density_activation)
    g = check_composite_train(gargs)
    record("composite_train", "instant_ngp_torch/csrc/composite_train.cu",
           "instant_ngp_tpu/nerf/task.py:743", g["max_abs_err"], g["ms"], g["plain_ms"],
           {k: g[k] for k in ("bound_ms", "bound_by")},
           extra=f" (R {R}, K {TRAIN_K}, Huber: per-ray loss and d/d out)",
           variants={f"snapshot_R{R}": g})

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


def check_one_launch(ws, inp) -> dict:
    """One fused_mlp call on the card under torch.profiler: one device
    kernel, kernel B, and no PyTorch op besides the output's allocation
    (no copy, cast, pad or concatenation of x or of the weights)."""
    from torch.profiler import ProfilerActivity, profile

    from instant_ngp_torch.ops.mlp_kernel import fused_mlp

    fused_mlp(ws, inp)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fused_mlp(ws, inp)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    ops = sorted({e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU
                  and e.name.startswith("aten::")})
    check(len(kernels) == 1 and KERNEL_NAMES["fused_mlp"] in kernels[0],
          f"one fused_mlp call ran the device kernels {kernels}")
    check(set(ops) <= {"aten::empty"}, f"one fused_mlp call ran the PyTorch ops {ops}")
    return {"device_kernels": kernels, "torch_ops": ops}


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


def check_composite_train(gargs) -> dict:
    """Kernel G against its plain version on gargs: error and times."""
    from instant_ngp_torch.nerf import train as nerf_train

    errs = []
    outs = nerf_train.composite_train(*gargs)
    for k_out, p_out in zip(outs, nerf_train.composite_train_plain(*gargs)):
        err, scale = max_err(k_out, p_out)
        check(err <= TOL_COMPOSITE_TRAIN * scale, f"G err {err} at max |ref| {scale}")
        errs.append(err)
    return {"max_abs_err": max(errs), "ms": time_ms(lambda: nerf_train.composite_train(*gargs)),
            "plain_ms": time_ms(lambda: nerf_train.composite_train_plain(*gargs)),
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


def step_check(task, device) -> dict:
    """One training step's gradients through the kernels against the same
    step through the plain versions, at the main path's ray count and at
    the adaptive ceiling, where the step packs its valid samples into the
    capacity. Then kernels G and H against their plain versions on the main
    path's step's own inputs: its window's composite and its error-map
    deposit. Returns those two checks by kernel name."""
    from instant_ngp_torch.nerf import train as nerf_train

    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    ceiling = 1 << task.max_ray_bucket_log2
    check(ceiling * TRAIN_K > task.compact_samples, "the ceiling's step does not pack its samples")
    for n_rays in dict.fromkeys((ceiling, task.n_rays_current)):
        draws = nerf_train.draw_step(task, gen, n_rays, task.cdf_valid)
        batch = nerf_train.march_batch(task, draws)
        step_gradients_check(task, draws, batch)
    return main_path_checks(task, draws, batch)


def step_gradients_check(task, draws, batch) -> None:
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
        print(f"train step kernels vs plain, {corners} corner(s), {R} rays{packed}: "
              f"grad ||k - p|| / ||p|| per leaf {[f'{e:.2e}' for e in errs]}, "
              f"loss {loss:.6f} vs {loss_p:.6f}")
        check(all(e <= TOL_STEP_GRAD for e in errs), f"step gradients differ: {errs}")
        check(loss_err <= TOL_STEP_LOSS, f"step loss differs: {loss} vs {loss_p}")
    enc.hashed_grad_corners = corners_before


def main_path_checks(task, draws, batch) -> dict:
    """Kernels G and H against their plain versions on a step's own inputs."""
    from instant_ngp_torch.nerf import train as nerf_train

    R, K = batch.ts.shape
    with torch.no_grad():
        out, valid = nerf_train.eval_samples(task, batch)
    target, bg, pixel_ok = nerf_train.targets(task, draws, batch.uv)
    gargs = (out.contiguous(), batch.ts, batch.dts, valid.contiguous(), target.contiguous(),
             bg.contiguous(), pixel_ok.contiguous(), task.state.grid.mean_density,
             task.training_near_distance, task.density_reg_scale * nerf_train.INV_LOSS_SCALE,
             float(np.float32(1.0) / np.float32(R)), task.loss_type, task.rgb_activation,
             task.density_activation)
    main = {"composite_train": {"shape": f"R {R}, K {K}", **check_composite_train(gargs)}}
    main["fwd_bwd_pair"] = nerf_pair_checks(task, batch)
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
        print(f"kernel {name} on the main path's step ({v['shape']}): max_abs_err "
              f"{v['max_abs_err']:.3e} kernel {v['ms']:.3f} ms plain {v['plain_ms']:.3f} ms")
    return main


@torch.no_grad()
def nerf_pair_checks(task, batch) -> dict:
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
    return {"density": check_fwd_bwd_pair(density_ws, feats, "trained fox density MLP"),
            "rgb": check_fwd_bwd_pair(rgb_ws, rgb_in, "trained fox rgb MLP")}


# each launcher's kernel function, as the profiler names it
KERNEL_NAMES = {"hashgrid_encode_fwd": "hashgrid_encode_kernel", "fused_mlp": "fused_mlp_kernel",
                "march_rays": "march_rays_kernel", "composite_window": "composite_window_kernel",
                "hashgrid_encode_bwd": "hashgrid_bwd_kernel", "fused_mlp_bwd": "mlp_bwd_kernel",
                "composite_train": "composite_train_kernel",
                "scatter_add_rows": "scatter_add_kernel", "take_rows": "take_rows_kernel",
                "gather_cols_sum": "gather_cols_sum_kernel"}


def profile_frames(trainer) -> tuple[float, float, list, dict]:
    """(wall ms, device busy ms, top device items (name, ms), device ms per
    frame of each port kernel by launcher) of PROFILED_STEPS training frames
    under torch.profiler; busy is the union of the device events'
    intervals."""
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
    return wall_ms, busy_us / 1e3, [(name[:80], ms) for name, ms in top], kernels


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
    print(f"profiled {PROFILED_STEPS} steps: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, "
          f"idle share {1.0 - busy_ms / wall_ms:.3f}; top device items (ms): {top}")
    check(not task.training_aborted and len(losses) == TRAIN_STEPS, "training stopped early")
    check(all(np.isfinite(losses)), "a training loss is not finite")
    check(last <= MAX_LOSS_RATIO * first, f"loss fell from {first} to {last} only")
    check(all(launches[k] > 0 for k in TRAIN_KERNELS), f"a kernel was not launched: {launches}")

    main = step_check(task, device)
    pair = main.pop("fwd_bwd_pair")
    for r in results:
        if r["name"] in main:
            take_main_path(r, main[r["name"]])
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


IMAGE_KERNELS = ("hashgrid_encode_fwd", "fused_mlp", "hashgrid_encode_bwd", "fused_mlp_bwd",
                 "take_rows")
BENCH_KERNELS = ("take_rows", "gather_cols_sum")


def image_levels(res: int):
    """The grid levels configs/image/base.json autoconfigures for a res^2 image."""
    from instant_ngp_torch.config import load_network_config
    from instant_ngp_torch.models.factory import autoconfig_grid_encoding
    from instant_ngp_torch.ops.hashgrid import grid_encoding_from_config

    cfg = autoconfig_grid_encoding(load_network_config(IMAGE_CONFIG)["encoding"], "image",
                                   image_resolution=(res, res))
    return grid_encoding_from_config(cfg, 2, device="meta")


def check_encode(levels, interpolation: str, table, x, what: str) -> dict:
    """Kernel A against its plain version on (table, x): error, times, bound."""
    from instant_ngp_torch.ops.hashgrid import hashgrid_encode, hashgrid_encode_plain

    args = (levels, interpolation, table, x)
    out, ref = hashgrid_encode(*args), hashgrid_encode_plain(*args)
    err, scale = max_err(out, ref)
    check(err <= TOL_ENCODE * max(1.0, scale), f"A {what}: err {err} at max |ref| {scale}")
    rows, corners = grid_work(levels, interpolation, x)
    F = table.shape[1]
    return {"max_abs_err": err, "ms": time_ms(lambda: hashgrid_encode(*args)),
            "plain_ms": time_ms(lambda: hashgrid_encode_plain(*args)),
            **bound(nbytes(x, out) + rows * F * 4, x.shape[0] * corners * 2 * F)}


def check_encode_bwd(levels, interpolation: str, x, g, n_entries: int, corners: int,
                     what: str) -> dict:
    """Kernel E against its plain version: error, times, bound."""
    from instant_ngp_torch.ops.hashgrid import hashgrid_encode_bwd, hashgrid_encode_bwd_plain

    args = (levels, interpolation, x, g, n_entries, corners)
    err, scale = max_err(hashgrid_encode_bwd(*args), hashgrid_encode_bwd_plain(*args))
    check(err <= TOL_ENCODE_BWD * max(1.0, scale), f"E {what}: err {err} at max |ref| {scale}")
    return {"max_abs_err": err, "ms": time_ms(lambda: hashgrid_encode_bwd(*args)),
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
            **bound(nbytes(idx, out) + int(torch.unique(idx).numel()) * row_bytes)}


def check_cols(x, idx, what: str) -> dict:
    """Kernel J against its plain version: f32 to TOL_GATHER_COLS_F32 of
    max |ref|, bf16 exactly (both round after every add)."""
    from instant_ngp_torch.ops.gather import gather_cols_sum, gather_cols_sum_plain

    out, ref = gather_cols_sum(x, idx, COL_REPS), gather_cols_sum_plain(x, idx, COL_REPS)
    err, scale = max_err(out.float(), ref.float())
    if x.dtype == torch.bfloat16:
        check(bool(torch.equal(out, ref)), f"J {what}: differs from plain")
    check(err <= TOL_GATHER_COLS_F32 * scale, f"J {what}: err {err} at max |ref| {scale}")
    return {"max_abs_err": err, "ms": time_ms(lambda: gather_cols_sum(x, idx, COL_REPS)),
            "plain_ms": time_ms(lambda: gather_cols_sum_plain(x, idx, COL_REPS)),
            **bound(nbytes(x, idx, out), COL_REPS * x.numel())}


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
           variants=variants, path="image")

    variants = {}
    for t, dtype in COL_CASES:
        x = torch.randn((t, COLS), generator=gen, device=device).to(dtype)
        idx = torch.randint(0, t, (t, COLS), generator=gen, device=device, dtype=torch.int32)
        variants[f"T{t}_{str(dtype)[6:]}"] = check_cols(x, idx, f"T {t} {dtype}")
    record("gather_cols_sum", "instant_ngp_torch/csrc/gather.cu", "scripts/bench_dyngather.py:34",
           max(v["max_abs_err"] for v in variants.values()), **headline(variants["T4096_float32"]),
           extra=f" (L {COLS}, reps {COL_REPS}; all: {variants})", variants=variants, path="bench")
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
    """Kernels A, E and I against their plain versions on the image task's
    own tables and texture, at a step's positions and texels."""
    from instant_ngp_torch.image_fit.task import bilinear_texels

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
            "take_rows": check_take(task.texture, idx, "image step")}
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


def image_phase(device, card) -> tuple[dict, dict]:
    """The image path through its entry points. Returns (the main path's
    kernel checks by record name, the launches of the training run)."""
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
    print(f"image profiled {PROFILED_STEPS} steps: wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms, idle share {1.0 - busy_ms / wall_ms:.3f}; top device items (ms): "
          f"{top}")
    check(len(losses) == IMAGE_STEPS and all(np.isfinite(losses)), "an image loss is not finite")
    check(last <= MAX_LOSS_RATIO * first, f"image loss fell from {first} to {last} only")
    check(all(launches[k] > 0 for k in IMAGE_KERNELS), f"a kernel was not launched: {launches}")

    t0 = time.perf_counter()
    mse = tb.compute_image_mse()
    mse_s = time.perf_counter() - t0
    psnr_after = -10.0 * float(np.log10(mse))
    print(f"image PSNR (compute_image_mse over {IMAGE_RES}^2 pixels) {psnr_before:.2f} -> "
          f"{psnr_after:.2f} dB; compute_image_mse {mse_s:.3f} s")
    check(psnr_after - psnr_before >= MIN_PSNR_GAIN_DB,
          f"image PSNR rose from {psnr_before:.2f} to {psnr_after:.2f} dB only")

    uv = image_step_check(task)
    main = {**image_main_path_checks(task, uv, device), "fused_mlp_bwd": f_check,
            **image_trained_mlp_checks(task, uv, device)}

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
    return main, launches


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

    # the image path and the gather microbenchmarks
    results += gather_kernel_checks(device)
    image_main, image_launches = image_phase(device, card)
    # kernel F's record stays the fox MLPs'; the image checks are variants
    f_image = image_main.pop("fused_mlp_bwd")
    f_trained = image_main.pop("fused_mlp_bwd_trained")
    image_pair = image_main.pop("fwd_bwd_pair")
    for r in results:
        if r["name"] == "fused_mlp_bwd":
            r["variants"]["image_first_step"] = f_image
            r["variants"]["image_trained"] = f_trained
            r["max_abs_err"] = max(r["max_abs_err"], f_image["max_abs_err"],
                                   f_trained["max_abs_err"])
        if r["name"] == "fused_mlp":
            r["fwd_bwd_pair"] = {"fox_trained": nerf_pair, "image_trained": image_pair}
        if r["name"] in image_main:
            take_main_path(r, image_main[r["name"]])
    bench_launches = gather_phase()

    paths = {"render": render_launches, "train": train_launches, "image": image_launches,
             "bench": bench_launches}
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
    print(json.dumps({"kernels": results}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.exit(0)
