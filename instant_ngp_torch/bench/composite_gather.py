"""Kernels G (training composite + loss + backward) and I (row gather, and the
image step's bilinear read) of one source tree, at the shapes of their paths,
timed back to back and by device time, with kernels D and J beside them; and
an old/new comparison of two trees.

    python instant_ngp_torch/bench/composite_gather.py [--root DIR]
    python instant_ngp_torch/bench/composite_gather.py --ab OLD_DIR [--logs DIR] [--repeat N]

``--root DIR`` (default: this checkout) imports ``instant_ngp_torch`` from
DIR, builds its kernels into DIR/build, checks each kernel against its plain
version with this checkout's ``chip_smoke.py`` checks and tolerances, and
prints one JSON line. The cases:

- G on the fox snapshot's trained model, its outputs on the training march
  (rays of random pixels of fox's views, random jitter, 192 iterations, on
  the snapshot's grid) against random pixels, as ``chip_smoke.py`` holds G:
  4,096 rays at K 32 (the NeRF step), the 8,192-ray ceiling at K 32, and
  4,096 rays at K 48 (the JAX ``NerfTask`` default); and 4,096 rays at K 40
  on random outputs (a ragged chunk of 8);
- I: ``take_rows`` at the image step's 2^20 texels (the bilinear corners of
  2^18 stratified positions) of a random 8192^2 RGBA f32 texture (1 GiB),
  at the texels of a 1920x1080 render's ground-truth tiles of it (where the
  tree has ``ImageTask.gt_texels``), and at every ``chip_smoke.TAKE_CASES``
  case (2^20 random rows), beside ``torch.index_select``; and the image
  step's whole target read, ``image_fit.task.bilinear_read`` on those
  positions, every kernel of the call (and, where the tree has the bilinear
  entry, its plain version and ``grid_sample``, the library call);
- D at the 256^2 render window of view 0 (65,536 rays, K 8), and J at every
  ``chip_smoke.COL_CASES`` case (both of its launches on the transpose
  route), with the route it took and, where that was the shared route, the
  device time of the transpose route on the same inputs.

Each case has its time back to back (``chip_smoke.time_ms``), its device
time per call under torch.profiler (``device_ms``: every kernel of the call;
``kernel_ms``: the kernel's own; ``events_per_call``: the device kernels a
call runs), its bound and its error against the plain version. ``--ab
OLD_DIR`` compares OLD_DIR with this checkout through ``bench/ab.py`` (old,
new, new, old: each tree's ``chip_smoke.py`` and this script; with
``--repeat N`` then N ``nerf_repeat`` runs per tree and turn, in the same
order), writes the outputs under DIR (default build/composite_gather_ab/) and
prints one JSON line per run. Without a card it raises.
"""

from __future__ import annotations

import argparse
import functools
import importlib.util
import json
import sys
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parents[2]  # this checkout
SEED = 0
G_CASES = (("step_R4096_K32", 4096, 32), ("ceiling_R8192_K32", 8192, 32),
           ("R4096_K48", 4096, 48))
RAGGED_K = 40
IMAGE_RES, N_IMAGE = 8192, 1 << 18


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def g_case(cs, gargs) -> dict:
    from instant_ngp_torch.nerf import train as nerf_train

    v = cs.check_composite_train(gargs)
    return {**v, **cs.device_split(lambda: nerf_train.composite_train(*gargs), "composite_train")}


def g_cases(cs, tb, gen, device) -> dict:
    from instant_ngp_torch.nerf.sampler import march_rays

    task = tb.task
    out = {}
    for name, n_rays, k in G_CASES:
        margs = cs.training_march(task, task.skipmip, gen, device, n_rays=n_rays, k=k)
        ts, dts, valid, _, _ = march_rays(*margs)
        net_out = task._eval_window(margs[0], margs[1], ts, valid)
        gargs = cs.composite_train_args(task, net_out, ts, dts, valid,
                                        *cs.random_pixels(n_rays, gen),
                                        task.state.grid.mean_density)
        out[name] = {"rays": n_rays, "K": k, **g_case(cs, gargs)}
    gargs = cs.seed_composite_train_args(task, 4096, RAGGED_K, gen, task.state.grid.mean_density)
    out[f"seed_R4096_K{RAGGED_K}"] = {"rays": 4096, "K": RAGGED_K, **g_case(cs, gargs)}
    return out


def take_case(cs, table, idx, what: str) -> dict:
    """take_rows against its plain version; device times of the kernel and
    of the library call, index_select."""
    import torch

    from instant_ngp_torch.ops.gather import take_rows

    return {**cs.check_take(table, idx, what),
            **cs.device_split(lambda: take_rows(table, idx), "take_rows"),
            "library_device_ms": cs.device_split(lambda: torch.index_select(table, 0, idx),
                                                 "index")["device_ms"]}


def i_cases(cs, gen, device) -> dict:
    import torch

    from instant_ngp_torch.bench.bwd_kernels import stratified
    from instant_ngp_torch.image_fit import task as image_task
    from instant_ngp_torch.ops import gather

    res = (IMAGE_RES, IMAGE_RES)
    texture = torch.rand((IMAGE_RES * IMAGE_RES, 4), generator=gen, device=device)
    uv = stratified(N_IMAGE, gen, device)
    # the corners' indices: in ops.gather since the bilinear entry, in the task before
    texels = getattr(gather, "bilinear_texels", None) or image_task.bilinear_texels
    idx, _ = texels(res, uv)
    out = {"image_step_texels": take_case(cs, texture, idx, "image step texels")}
    gt_texels = getattr(image_task.ImageTask, "gt_texels", None)
    if gt_texels is not None:  # the texels of a render's ground-truth tiles, where the tree has it
        task = SimpleNamespace(resolution=res, device=device)
        out["gt_tiles"] = take_case(cs, texture, gt_texels(task, *cs.RENDER_WH),
                                    "ground-truth tiles")
    for log2_t, f, dtype in cs.TAKE_CASES:
        t = 1 << log2_t
        table = torch.randn((t, f), generator=gen, device=device).to(dtype)
        rows = torch.randint(0, t, (cs.N_TAKE,), generator=gen, device=device, dtype=torch.int32)
        out[f"T2^{log2_t}_F{f}_{str(dtype)[6:]}"] = take_case(cs, table, rows, f"T 2^{log2_t}")

    def read():
        return image_task.bilinear_read(texture, res, uv)

    whole = {"ms": cs.time_ms(read), **cs.device_split(read, "")}
    if hasattr(gather, "bilinear_read_plain"):
        whole.update(cs.check_bilinear(texture, res, uv, "image step"))
        whole["kernel_ms"] = cs.device_split(read, "bilinear_read")["kernel_ms"]
        whole["library_device_ms"] = cs.device_split(cs.grid_sample_read(texture, res, uv),
                                                     "grid_sampler")["device_ms"]
    out["bilinear_read_image_step"] = whole
    return out


def d_case(cs, tb, gen, device) -> dict:
    from instant_ngp_torch.nerf.sampler import march_rays

    margs, tmin, tmax = cs.render_window_march(tb, device)
    ts, dts, valid, t_exit, _ = march_rays(*margs, t_init=tmin)
    return {"rays": ts.shape[0], "K": ts.shape[1],
            **cs.check_composite_window(tb.task, margs[0], margs[1], (ts, dts, valid, t_exit),
                                        tmin, tmax, gen)}


# J between the microbenchmark's T 512 and 4,096, where the routes' times cross
J_BETWEEN = ((1024, "float32"), (2048, "float32"), (2048, "bfloat16"))


def j_cases(cs, gen, device) -> dict:
    """J at every chip_smoke.COL_CASES case and at J_BETWEEN; ``kernel_ms``
    is every J launch of the call (the transpose route launches twice),
    ``transpose_ms`` the transpose's share of it, ``route`` the one the
    tree's wrapper took, as its launches show it (none before the routes).
    Where it took the shared route, ``transpose_route_ms`` is the device
    time of the same call on the transpose route (``gather.transpose_plan``),
    held bit for bit too."""
    import torch

    from instant_ngp_torch.ops import gather

    routes = hasattr(gather, "transpose_plan")
    reps, out = cs.COL_REPS, {}
    for t, dtype in (*cs.COL_CASES, *((t, getattr(torch, d)) for t, d in J_BETWEEN)):
        x = torch.randn((t, cs.COLS), generator=gen, device=device).to(dtype)
        idx = torch.randint(0, t, (t, cs.COLS), generator=gen, device=device, dtype=torch.int32)
        call = functools.partial(gather.gather_cols_sum, x, idx, reps)
        v = out[f"T{t}_{str(dtype)[6:]}"] = {
            **cs.check_cols(x, idx, reps, f"T {t} {dtype}"),
            **cs.device_split(call, "gather_cols"),
            "transpose_ms": cs.device_split(call, "gather_cols_transpose")["kernel_ms"],
            "route": cs.cols_route(call) if routes else None}
        if v["route"] == "shared":
            plan = gather.transpose_plan(t, reps)
            forced = functools.partial(gather.gather_cols_sum_on, x, idx, reps, plan)
            bits = torch.int16 if x.element_size() == 2 else torch.int32
            cs.check(torch.equal(forced().view(bits), call().view(bits)),
                     f"J T {t} {dtype}: the transpose route differs from the shared route")
            v["transpose_route_ms"] = cs.device_split(forced, "gather_cols")["device_ms"]
    return out


def run(root: Path) -> dict:
    sys.path.insert(0, str(root))
    import torch

    from instant_ngp_torch import cuda_lib
    from instant_ngp_torch.testbed import Testbed

    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: this benchmark needs an NVIDIA GPU")
    cs = _chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    _, build_s = cuda_lib.build()
    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(SEED)
    tb = Testbed("nerf", device=device)
    tb.load_snapshot(cs.SNAPSHOT)
    with torch.no_grad():
        return {"root": str(root), "device": torch.cuda.get_device_name(0), "build_s": build_s,
                "G": g_cases(cs, tb, gen, device), "I": i_cases(cs, gen, device),
                "D": {"render_window": d_case(cs, tb, gen, device)},
                "J": j_cases(cs, gen, device)}


def summarize(res: dict) -> dict:
    """One --ab line's entries: per case [ms, device_ms, kernel_ms]; and J's
    device ms on the transpose route where its wrapper took the shared one."""
    line = {f"{k}:{case}": [v["ms"], v["device_ms"], v["kernel_ms"]]
            for k in ("G", "I", "D", "J") for case, v in res[k].items()}
    line.update({f"J_transpose_route:{case}": v["transpose_route_ms"]
                 for case, v in res["J"].items() if "transpose_route_ms" in v})
    return line


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--ab", type=Path, default=None, metavar="OLD_DIR")
    ap.add_argument("--logs", type=Path, default=HERE / "build" / "composite_gather_ab",
                    metavar="DIR")
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
