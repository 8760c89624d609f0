"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python chip_smoke.py

Builds the port's CUDA kernels from ``instant_ngp_torch/csrc/``, checks each
kernel against its plain PyTorch version on the card at the shapes of the
fox snapshot, then renders ``data/fox_1536.ingp`` at 256x256 through
``Testbed.load_snapshot`` and ``render`` and checks that the render went
through all four kernels and agrees with the same render through the plain
versions; the tiny test fixture gets the same kernel-vs-plain render check
at 64x64. Prints a JSON line of per-kernel results, the card's name and
power limit, and as its last line ``{"ok": true, "device": {...}}``. Any
failed check raises, so the script exits non-zero without that line. There
is no CPU path: without CUDA it fails at once.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
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


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of fn over reps runs, each timed by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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


def kernel_checks(tb, device) -> list[dict]:
    """Each kernel against its plain version on the card, at fox shapes."""
    from instant_ngp_torch.common import warp_direction
    from instant_ngp_torch.nerf.sampler import MarchConfig, march_rays, march_rays_plain
    from instant_ngp_torch.nerf.task import composite_window, composite_window_plain
    from instant_ngp_torch.ops.hashgrid import hashgrid_encode, hashgrid_encode_plain
    from instant_ngp_torch.ops.mlp_kernel import fused_mlp, fused_mlp_plain

    task, model = tb.task, tb.task.model
    enc = model.pos_encoding
    gen = torch.Generator(device=device).manual_seed(SEED)
    results = []

    def record(name, source, replaces, err, ms, plain_ms, extra=""):
        print(f"kernel {name}: max_abs_err {err:.3e} kernel {ms:.3f} ms plain {plain_ms:.3f} ms"
              f"{extra}")
        results.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})

    # A: hash-grid encode of N positions with the fox tables
    x = torch.rand((N_ROWS, 3), generator=gen, device=device)
    args = (enc.levels, enc.interpolation, enc.table, x)
    feats, ref = hashgrid_encode(*args), hashgrid_encode_plain(*args)
    err = float((feats - ref).abs().max())
    check(err <= TOL_ENCODE * max(1.0, float(ref.abs().max())), f"encode err {err}")
    record("hashgrid_encode_fwd", "instant_ngp_torch/csrc/hashgrid.cu",
           "instant_ngp_tpu/ops/hashgrid.py:213", err,
           time_ms(lambda: hashgrid_encode(*args)), time_ms(lambda: hashgrid_encode_plain(*args)))

    # B: both MLPs of the model on N rows (encodings of A; SH of random dirs)
    dirs = warp_direction(torch.nn.functional.normalize(
        torch.randn((N_ROWS, 3), generator=gen, device=device), dim=-1))
    density_ws = list(model.density_network.weights)
    d_out = fused_mlp(density_ws, feats, "relu", "none")
    rgb_in = torch.cat([d_out, model.dir_encoding(dirs)], dim=-1)
    rgb_ws = list(model.rgb_network.weights)
    errs, scales, ms, plain_ms = [], [], 0.0, 0.0
    for ws, inp in ((density_ws, feats), (rgb_ws, rgb_in)):
        out, ref = fused_mlp(ws, inp, "relu", "none"), fused_mlp_plain(ws, inp, "relu", "none")
        err, scale = float((out - ref).abs().max()), float(ref.abs().max())
        check(err <= TOL_MLP * max(1.0, scale), f"mlp err {err} at max |ref| {scale}")
        errs.append(err)
        scales.append(scale)
        ms += time_ms(lambda: fused_mlp(ws, inp, "relu", "none"))
        plain_ms += time_ms(lambda: fused_mlp_plain(ws, inp, "relu", "none"))
    record("fused_mlp", "instant_ngp_torch/csrc/mlp.cu",
           "instant_ngp_tpu/ops/pallas/mlp_kernel.py:53", max(errs), ms, plain_ms,
           f" (32->64->16 plus 32->64->64->3; max |ref| {scales[0]:.3f}, {scales[1]:.3f})")

    # C: march the rays of view 0 at RES^2, K = 8, 64 iterations, fox grid
    ds = tb.nerf_dataset
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
    margs = (o, d, task.skipmip, task.aabb_min, task.aabb_max,
             torch.full_like(tmin, 0.5), cfg)
    ts, dts, valid, t_exit, n_valid = march_rays(*margs, t_init=tmin)
    ts_p, dts_p, _, t_exit_p, n_valid_p = march_rays_plain(*margs, t_init=tmin)
    same = n_valid == n_valid_p
    agree = float(same.float().mean())
    check(agree >= MIN_MARCH_AGREE, f"march n_valid agreement {agree}")
    err = max(float((a[same] - b[same]).abs().max()) for a, b in
              ((ts, ts_p), (dts, dts_p), (t_exit, t_exit_p)))
    rel = max(float(((a[same] - b[same]).abs() / b[same].abs().clamp(min=1.0)).max())
              for a, b in ((ts, ts_p), (t_exit, t_exit_p)))
    check(rel <= TOL_MARCH_T, f"march relative err {rel}")
    record("march_rays", "instant_ngp_torch/csrc/march.cu", "instant_ngp_tpu/nerf/sampler.py:49",
           err, time_ms(lambda: march_rays(*margs, t_init=tmin)),
           time_ms(lambda: march_rays_plain(*margs, t_init=tmin), reps=10),
           f" (n_valid agrees on {agree:.6f} of {o.shape[0]} rays)")

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
           time_ms(lambda: composite_window_plain(*cargs)))
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
    frame_plain = tb.render(res, res, xf, **kw)
    tb.task.set_use_kernels(True)
    return psnr(frame, frame_plain)


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
    db = psnr_vs_plain(tiny, tiny.render(TINY_RES, TINY_RES, xf, **kw), TINY_RES, xf, kw)
    print(f"tiny fixture {TINY_RES}x{TINY_RES} kernel vs plain: PSNR {db:.2f} dB")
    check(db >= MIN_PSNR_DB, f"tiny fixture kernel vs plain PSNR {db}")

    # the main path: a 256x256 frame of view 0 with bench.py's arguments
    xf, kw = view0(tb, RES)
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    frame = tb.render(RES, RES, xf, **kw)
    torch.cuda.synchronize()
    launches = dict(cuda_lib.LAUNCHES)
    print(f"render launches: {launches}")
    check(all(n > 0 for n in launches.values()), f"a kernel was not launched: {launches}")
    check(tuple(frame.shape) == (RES, RES, 4), f"frame shape {tuple(frame.shape)}")
    check(bool(torch.isfinite(frame).all()), "frame has non-finite values")
    alpha_mean = float(frame[..., 3].mean())
    check(alpha_mean > 0.05, f"alpha mean {alpha_mean}")

    db = psnr_vs_plain(tb, frame, RES, xf, kw)
    print(f"render kernel vs plain: PSNR {db:.2f} dB, alpha mean {alpha_mean:.4f}")
    check(db >= MIN_PSNR_DB, f"kernel vs plain PSNR {db}")

    t0 = time.perf_counter()
    tb.render(RES, RES, xf, **kw)
    torch.cuda.synchronize()
    frame_s = time.perf_counter() - t0
    print(f"render {RES}x{RES}: {frame_s * 1e3:.2f} ms, {RES * RES / frame_s / 1e6:.3f} Mrays/s "
          f"on {card}")

    for r in results:
        r["launches"] = launches[r["name"]]
    print(json.dumps({"kernels": results}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.exit(0)
