"""Kernels A (hash-grid encode forward) and B (fused MLP forward) of one
source tree, at every shape of their paths, timed back to back and by device
time; and an old/new comparison of two trees.

    python instant_ngp_torch/bench/fwd_kernels.py [--root DIR]
    python instant_ngp_torch/bench/fwd_kernels.py --ab OLD_DIR [--logs DIR] [--repeat N]

``--root DIR`` (default: this checkout) imports ``instant_ngp_torch`` from
DIR, builds its kernels into DIR/build, checks A and B against their plain
versions with this checkout's ``chip_smoke.py`` checks and tolerances, and
prints one JSON line. The shapes, on the fox snapshot's tables and MLPs:

- ``nerf_step``: the training march's 2^17 samples (4,096 rays of random
  pixels of fox's views, K 32, 192 iterations, on the snapshot's grid): A,
  then both MLPs on its features and the rays' SH encodings;
- ``probes``: 2^18 grid-update probes (random cells of every cascade,
  jittered, mapped into the aabb as ``update_grid_step`` maps them): A and
  the density MLP;
- ``render``: 2^19 random positions (``chip_smoke.py``'s check): A and both
  MLPs;
- ``image_step``: a step's 2^18 stratified positions on the grid
  ``configs/image/base.json`` autoconfigures for an 8192^2 image (16 dense
  levels, a random table): A and the 32->64->64->3 MLP;
- ``image16384``: 2^18 random positions on the 16384^2 levels (the top two
  hashed): A; its MLP shape is ``image_step``'s.

Each case has its time back to back (``chip_smoke.time_ms``), its device
time per call under torch.profiler (``device_ms``: every kernel of the call,
``kernel_ms``: the kernel's own), its bound and its error against the plain
version. ``--ab OLD_DIR`` compares OLD_DIR with this checkout through
``bench/ab.py`` (old, new, new, old: each tree's ``chip_smoke.py`` and this
script; with ``--repeat N`` then N ``nerf_repeat`` runs per tree and turn,
in the same order), writes the outputs under DIR (default build/fwd_ab/)
and prints one JSON line per run. Without a card it raises.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]  # this checkout
SEED = 0
N_PROBES, N_RENDER, N_IMAGE = 1 << 18, 1 << 19, 1 << 18
GRID_RES = 128  # the occupancy grid's cells per axis


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def probe_positions(task, n: int, gen, device):
    """n grid-update probes: random cells of random cascades, jittered, in
    the unit cube of the aabb (``update_grid`` and ``update_grid_step``)."""
    import torch

    g = GRID_RES
    mip = torch.randint(0, task.max_cascade + 1, (n,), generator=gen, device=device)
    cell = torch.randint(0, g, (n, 3), generator=gen, device=device)
    jitter = torch.rand((n, 3), generator=gen, device=device)
    pos = ((cell.float() + jitter) / g - 0.5) * torch.exp2(mip.float())[:, None] + 0.5
    aabb_min, aabb_max = task._aabb_t
    return ((pos - aabb_min) / (aabb_max - aabb_min)).contiguous()


def encode_case(cs, levels, interpolation: str, table, x, what: str) -> dict:
    from instant_ngp_torch.ops.hashgrid import hashgrid_encode

    v = cs.check_encode(levels, interpolation, table, x, what)
    return {**{k: v[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms")},
            **cs.device_split(lambda: hashgrid_encode(levels, interpolation, table, x),
                              "hashgrid_encode")}


def mlp_case(cs, nets, what: str) -> dict:
    """B on each (weights, input) of ``nets`` (one forward of the model):
    the error, the times and the bound summed over the MLPs."""
    from instant_ngp_torch.ops.mlp_kernel import fused_mlp

    out = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "device_ms": 0.0,
           "kernel_ms": 0.0}
    for ws, inp in nets:
        v = cs.check_mlp(ws, inp, what)
        dev = cs.device_split(lambda: fused_mlp(ws, inp), "fused_mlp")
        out["max_abs_err"] = max(out["max_abs_err"], v["max_abs_err"])
        for k in ("ms", "plain_ms", "bound_ms"):
            out[k] += v[k]
        for k in ("device_ms", "kernel_ms"):
            out[k] += dev[k]
    return out


def fox_cases(cs, tb, gen, device) -> tuple[dict, dict]:
    import torch

    from instant_ngp_torch.common import warp_direction
    from instant_ngp_torch.nerf.sampler import march_rays
    from instant_ngp_torch.ops.hashgrid import hashgrid_encode
    from instant_ngp_torch.ops.mlp_kernel import fused_mlp

    task, model = tb.task, tb.task.model
    enc = model.pos_encoding
    table = enc.table.detach()
    density_ws = [w.detach() for w in model.density_network.weights]
    rgb_ws = [w.detach() for w in model.rgb_network.weights]

    def model_nets(pos, dirs=None):
        feats = hashgrid_encode(enc.levels, enc.interpolation, table, pos)
        if dirs is None:  # the density path alone
            return [(density_ws, feats)]
        rgb_in = torch.cat([fused_mlp(density_ws, feats), model.dir_encoding(dirs)], dim=-1)
        return [(density_ws, feats), (rgb_ws, rgb_in)]

    margs = cs.training_march(task, task.skipmip, gen, device)
    ts = march_rays(*margs)[0]
    pos, dirs = task._window_inputs(margs[0], margs[1], ts)
    render_pos = torch.rand((N_RENDER, 3), generator=gen, device=device)
    render_dirs = warp_direction(torch.nn.functional.normalize(
        torch.randn((N_RENDER, 3), generator=gen, device=device), dim=-1))
    probes = probe_positions(task, N_PROBES, gen, device)
    a, b = {}, {}
    for name, p, nets in (("nerf_step", pos, model_nets(pos, dirs)),
                          ("probes", probes, model_nets(probes)),
                          ("render", render_pos, model_nets(render_pos, render_dirs))):
        a[name] = {"rows": p.shape[0],
                   **encode_case(cs, enc.levels, enc.interpolation, table, p, f"fox {name}")}
        b[name] = {"rows": p.shape[0], **mlp_case(cs, nets, f"fox {name}")}
    return a, b


def image_cases(cs, gen, device) -> tuple[dict, dict]:
    import torch

    from instant_ngp_torch.bench.bwd_kernels import mlp_weights, stratified
    from instant_ngp_torch.ops.hashgrid import hashgrid_encode

    a, b = {}, {}
    ws = mlp_weights((32, 64, 64, 3), gen, device)
    for name, res, x in (("image_step", 8192, stratified(N_IMAGE, gen, device)),
                         ("image16384", 16384, torch.rand((N_IMAGE, 2), generator=gen,
                                                          device=device))):
        enc = cs.image_levels(res)
        table = torch.rand((enc.n_entries, enc.n_features_per_level), generator=gen,
                           device=device) * 2.0 - 1.0
        a[name] = {"rows": x.shape[0],
                   **encode_case(cs, enc.levels, enc.interpolation, table, x, name)}
        if name == "image_step":
            feats = hashgrid_encode(enc.levels, enc.interpolation, table, x)
            b[name] = {"rows": x.shape[0], **mlp_case(cs, [(ws, feats)], name)}
        del table
    return a, b


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
        a, b = fox_cases(cs, tb, gen, device)
        a_img, b_img = image_cases(cs, gen, device)
    return {"root": str(root), "device": torch.cuda.get_device_name(0), "build_s": build_s,
            "A": {**a, **a_img}, "B": {**b, **b_img}}


def summarize(res: dict) -> dict:
    """One --ab line's entries: per case [ms, device_ms, kernel_ms]."""
    return {f"{k}:{case}": [v["ms"], v["device_ms"], v["kernel_ms"]]
            for k in ("A", "B") for case, v in res[k].items()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--ab", type=Path, default=None, metavar="OLD_DIR")
    ap.add_argument("--logs", type=Path, default=HERE / "build" / "fwd_ab", metavar="DIR")
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
