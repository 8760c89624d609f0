"""Kernels H (row scatter-add) and C (occupancy-grid ray march) of one
source tree, at the shapes of their paths, timed back to back and by device
time; and an old/new comparison of two trees.

    python instant_ngp_torch/bench/march_scatter.py [--root DIR]
    python instant_ngp_torch/bench/march_scatter.py --ab OLD_DIR [--logs DIR] [--repeat N]

``--root DIR`` (default: this checkout) imports ``instant_ngp_torch`` from
DIR, builds its kernels into DIR/build, checks H and C against their plain
versions with this checkout's ``chip_smoke.py`` checks and tolerances, and
prints one JSON line. The cases:

- H at the three shapes it is timed at: 2^20 rows of 2 into 2^19
  (``scripts/bench_pallas_scatter.py``), the flat 2^21 rows into 2^20
  (``scripts/bench_pallas_scatter1d.py``) and the error-map deposit, the
  bilinear corners of 4,096 rays (16,384 rows of 1) into a 50 x 53 x 53 map
  (fox's 50 views at chip_smoke.py's ray count); beside each, ``zeros`` +
  ``index_add_``. Where the tree has the accumulating form
  ``scatter_add_rows_``, also that form on the deposit beside an in-place
  ``index_add_``, and H at F = 4 and with int32 indices;
- C at the training march (4,096 rays of random pixels of fox's views, K
  32, random jitter) at 48, 96 and 192 iterations, and at the render window
  (view 0 at 256^2, K 8, 64 iterations, from the crop-box entry), on the
  fox snapshot's occupancy grid, with the plain march's iterations per ray
  and the chain values it read (where the tree's plain march counts them;
  an older tree's cases are its kernel's times alone, its own
  ``chip_smoke.py`` holds that kernel against its plain version).

Each case has its time back to back (``chip_smoke.time_ms``) and, under
torch.profiler, its device time per call (``device_ms``) and that of the
kernel alone (``kernel_ms``; the rest is fills). ``--ab OLD_DIR`` compares
OLD_DIR with this checkout through ``bench/ab.py`` (old, new, new, old: each
tree's ``chip_smoke.py`` and this script; with ``--repeat N`` then N
``nerf_repeat`` runs per tree and turn, in the same order), writes the
outputs under DIR (default build/march_ab/) and prints one JSON line per
run. Without a card it raises.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]  # this checkout
SEED = 0
N_SCATTER, SCATTER_SIZE = 1 << 20, 1 << 19
DEPOSIT_RAYS, DEPOSIT_IMAGES, DEPOSIT_RES = 4096, 50, 53
MARCH_ITERS = (48, 96, 192)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def deposit_case(gen, device):
    """The error-map deposit of DEPOSIT_RAYS rays (``nerf/train.py::
    error_deposit``'s cells and weights for random views, pixels and
    losses): (corners (4R,) int64, values (4R, 1), map cells)."""
    import torch

    R, n, e = DEPOSIT_RAYS, DEPOSIT_IMAGES, DEPOSIT_RES
    img = torch.randint(0, n, (R,), generator=gen, device=device)
    uv = torch.rand((R, 2), generator=gen, device=device)
    deposit = torch.rand((R,), generator=gen, device=device) ** 4
    pos = torch.clamp(torch.clamp(uv * e - 0.5, min=0.0), max=e - 1.0 - 1e-4)
    pi = pos.to(torch.int64)
    w = pos - pi
    base = (img * e + torch.clamp(pi[:, 1], 0, e - 2)) * e + torch.clamp(pi[:, 0], 0, e - 2)
    corners = torch.cat([base, base + 1, base + e, base + e + 1])
    wx, wy = w[:, 0], w[:, 1]
    vals = (torch.cat([(1 - wx) * (1 - wy), wx * (1 - wy), (1 - wx) * wy, wx * wy])
            * deposit.repeat(4))
    return corners, vals[:, None].contiguous(), n * e * e


def scatter_cases(cs, gen, device) -> dict:
    import torch

    from instant_ngp_torch.ops import scatter

    idx = torch.randint(0, SCATTER_SIZE, (N_SCATTER,), generator=gen, device=device)
    vals = torch.randn((N_SCATTER, 2), generator=gen, device=device)
    flat = (idx[:, None] * 2 + torch.arange(2, device=device)).reshape(-1)
    corners, dvals, cells = deposit_case(gen, device)
    cases = {"probe_rows": (idx, vals, SCATTER_SIZE),
             "probe_flat": (flat, vals.reshape(-1, 1), 2 * SCATTER_SIZE),
             "deposit": (corners, dvals, cells)}
    if hasattr(scatter, "scatter_add_rows_"):
        cases["probe_rows_f4"] = (idx, torch.randn((N_SCATTER, 4), generator=gen, device=device),
                                  SCATTER_SIZE)
        cases["probe_rows_int32"] = (idx.to(torch.int32), vals, SCATTER_SIZE)
    out = {name: cs.check_scatter(*args, name) for name, args in cases.items()}
    if hasattr(scatter, "scatter_add_rows_"):
        emap = torch.rand((cells, 1), generator=gen, device=device)
        out["deposit_in_place"] = cs.check_scatter(corners, dvals, cells, "deposit in place", emap)
    return out


def march_case(cs, margs, t_init, what: str) -> dict:
    """chip_smoke.check_march where the tree's plain march counts its
    iterations; else kernel C's times alone."""
    from instant_ngp_torch.nerf.sampler import march_rays, march_rays_plain

    if "stats" in inspect.signature(march_rays_plain).parameters:
        return cs.check_march(margs, t_init, what)

    def kernel():
        return march_rays(*margs, t_init=t_init)

    return {"ms": cs.time_ms(kernel), **cs.device_split(kernel, "march_rays")}


def march_cases(cs, tb, gen, device) -> dict:
    task = tb.task
    out = {}
    for n_iters in MARCH_ITERS:
        margs = cs.training_march(task, task.skipmip, gen, device, n_iters)
        out[f"train_iters{n_iters}"] = march_case(cs, margs, None, f"{n_iters} iterations")
    margs, tmin, _ = cs.render_window_march(tb, device)
    out["render_window"] = march_case(cs, margs, tmin, "render window")
    return out


def run(root: Path) -> dict:
    sys.path.insert(0, str(root))
    import torch

    from instant_ngp_torch import cuda_lib
    from instant_ngp_torch.testbed import Testbed

    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: this benchmark needs an NVIDIA GPU")
    cs = _chip_smoke()
    _, build_s = cuda_lib.build()
    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(SEED)
    tb = Testbed("nerf", device=device)
    tb.load_snapshot(cs.SNAPSHOT)
    with torch.no_grad():
        return {"root": str(root), "device": torch.cuda.get_device_name(0), "build_s": build_s,
                "H": scatter_cases(cs, gen, device),
                "C": march_cases(cs, tb, gen, device)}


def summarize(res: dict) -> dict:
    """One --ab line's entries: per case [ms, device_ms, kernel ms]."""
    return {f"{k}:{case}": [v["ms"], v["device_ms"], v.get("kernel_ms", v.get("kernel_device_ms"))]
            for k in ("H", "C") for case, v in res[k].items()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--ab", type=Path, default=None, metavar="OLD_DIR")
    ap.add_argument("--logs", type=Path, default=HERE / "build" / "march_ab", metavar="DIR")
    ap.add_argument("--repeat", type=int, default=0, metavar="N")
    args = ap.parse_args()
    if args.ab is not None:
        sys.path.insert(0, str(HERE))
        from instant_ngp_torch.bench.ab import ab

        ab(args.ab.resolve(), HERE, args.logs.resolve(), Path(__file__).resolve(), summarize,
           args.repeat)
        return
    print(json.dumps(run(args.root.resolve())))


if __name__ == "__main__":
    main()
