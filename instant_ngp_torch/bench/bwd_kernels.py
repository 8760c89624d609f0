"""Kernels E (hash-grid table gradients), F (fused MLP backward) and K (the
hash grid's d/dx) of one source tree, at the shapes of their paths, timed
back to back; and an old/new comparison of two trees.

    python instant_ngp_torch/bench/bwd_kernels.py [--root DIR]
    python instant_ngp_torch/bench/bwd_kernels.py --dx [--root DIR]
    python instant_ngp_torch/bench/bwd_kernels.py --ab OLD_DIR [--dx] [--logs DIR]
    python instant_ngp_torch/bench/bwd_kernels.py --count

``--root DIR`` (default: this checkout) imports ``instant_ngp_torch`` from
DIR, builds its kernels into DIR/build, checks E and F against their plain
versions with ``chip_smoke.py``'s checks and tolerances (this checkout's
``chip_smoke.py``), and prints one JSON line of their times. The cases:

- E on the image step's 2^18 stratified positions (``ImageTask.sample_
  positions``' formula, 512 x 512 strata in row-major order) with the grid
  ``configs/image/base.json`` autoconfigures for an 8192^2 image (16 dense
  levels); on 2^18 random positions with the 16384^2 levels (the top two
  hashed), 1 and 4 corners; and on 2^17 random positions with fox's grid
  (``configs/nerf/base.json`` at aabb_scale 4), linear and simplex, 1 and 8
  corners;
- F on 2^17 rows of the two fox MLPs (32->64->16, 32->64->64->3), on the
  image step's 2^18 rows of 32->64->64->3 and on 2^17 - 37 rows of
  32->64->64->3 (a ragged last tile); every input has a zero row.

``--wide`` runs instead kernel F's wide route (csrc/mlp_wide_bwd.cu, then its
dW launch, csrc/mlp_wide_dw.cu) at the widths and rows of every config MLP
that takes it with a time in PERF.md (``WIDE_CASES``: image/oneblob and
image/frequency at 2^18 rows, sdf/oneblob and sdf/frequency at 2^16, nerf/
big's two MLPs, nerf/frequency's and nerf/none's density MLP at 2^17), relu/
none, on random inputs from SEED: each leaf against the plain version on the
rows whose ReLU masks agree, the device time of F's kernel (``kernel_ms``)
and of the whole call (``device_ms``: the packing, F, the dW kernel and its
reduction; in a tree before the dW kernel, the f32 dW products) on copies of
the inputs read in turn.

``--wide --act NAME [NAME ...]`` runs F's wide route instead at
``ACT_SHAPES`` (fox's rgb MLP and image/oneblob's widths, 2^17 rows) under
each activation NAME: hidden (none as output), as output (relu hidden), a
mixed pair (``MIXED_PAIRS``) where both are named, and relu hidden with none
as output on the wide route (``_launch_bwd(...,
narrow=False)``: fox's rgb widths take the narrow route otherwise), each
case's leaves against the plain version (reported, not gated: chip_smoke.py
holds them to the float64 contract) and a digest of its outputs' bytes
(``digest``), so that two trees' lines show whether the kernels' outputs
are equal bit for bit.

``--dx`` runs instead kernel K (csrc/hashgrid_bwd.cu) on the surface points
of an SDF frame: the BVH ray cast of ``geometry/procedural.bumpy_torus``
(256 x 136, seed 0, normalized as ``SdfTask`` loads it) from
``chip_smoke.sdf_camera()`` at the Testbed's fov, the hits in pixel order,
at 256^2 and 1920x1080 (``DX_SHAPES``), with configs/sdf/base.json's grid
(14 levels x 2, 2^18 rows a hashed level) and a table and cotangent random
from SEED, so that two trees see the same inputs without training. Each
shape: K bit for bit against its plain version on every row, back to back
ms, device and kernel ms from torch.profiler warm (the same inputs call
after call) and cold (copies that fill L2 twice over, in turn), each after
~30 ms of matrix products (``working_clock``), the plain version's ms and
the byte bound.

Weights, inputs and cotangents are random from SEED. ``--ab OLD_DIR``
compares OLD_DIR with this checkout through ``bench/ab.py`` (old, new, new,
old: each tree's ``chip_smoke.py`` and this script; with ``--wide``, ``--dx``
or ``--no-smoke`` only this script), writes the outputs under DIR (default
build/bwd_ab/) and prints each case's times (and, with the smoke runs, the
NeRF and image step times) of each run. Without a card it raises.

``--count`` runs on the CPU: for the image step's 2^18 stratified positions
(seed-0 uniforms) on the 8192^2 grid, per level and in all, the row-adds of
kernel E's exact corners, those left after its warp sums, and the adds into
each level's hottest row.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]  # this checkout
SEED = 0
N_FOX, N_IMAGE = 1 << 17, 1 << 18
RAGGED = 37
FOX_AABB_SCALE = 4
DX_SHAPES = {"hits256": (256, 256), "hits1920x1080": (1920, 1080)}
DX_MESH = (256, 136)  # bumpy_torus's grid: 69,632 triangles
SDF_FOV = 50.625  # the Testbed's vertical field of view
# the wide route's config MLPs (relu/none): name -> (widths, rows)
WIDE_CASES = {"image_oneblob": ((256,) + (128,) * 8 + (3,), 1 << 18),
              "image_frequency": ((48,) + (128,) * 8 + (3,), 1 << 18),
              "sdf_oneblob": ((192,) + (128,) * 8 + (1,), 1 << 16),
              "sdf_frequency": ((72,) + (128,) * 8 + (1,), 1 << 16),
              "nerf_big_density": ((32, 128, 128, 16), 1 << 17),
              "nerf_big_rgb": ((32, 128, 128, 128, 3), 1 << 17),
              "nerf_frequency_density": ((72,) + (128,) * 4 + (16,), 1 << 17),
              "nerf_none_density": ((3,) + (128,) * 4 + (16,), 1 << 17)}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fox_levels():
    """fox's grid: configs/nerf/base.json's encoding at aabb_scale 4."""
    from instant_ngp_torch.models.factory import autoconfig_grid_encoding
    from instant_ngp_torch.ops.hashgrid import grid_encoding_from_config

    cfg = json.loads((HERE / "configs" / "nerf" / "base.json").read_text())["encoding"]
    cfg = autoconfig_grid_encoding(cfg, "nerf", aabb_scale=FOX_AABB_SCALE)
    return grid_encoding_from_config(cfg, 3, device="meta")


def stratified(n: int, gen, device):
    """ImageTask.sample_positions' stratified positions for n = 4^k draws."""
    import torch

    size = 1 << ((n.bit_length() - 1) // 2)
    i = torch.arange(n, device=device)
    xy = torch.stack([(i & (size - 1)).float(), (i >> (size.bit_length() - 1)).float()], dim=-1)
    return torch.rand((n, 2), generator=gen, device=device) / size + xy / size


def row_add_counts(levels, interpolation: str, x, warp: int = 32) -> list[dict]:
    """Per level: kernel E's row-adds at exact corners (samples × corners),
    those left when each warp of ``warp`` consecutive samples sums equal
    rows per corner slot (as the kernel does) and across its slots, and the
    adds into the level's hottest row."""
    import torch

    from instant_ngp_torch.ops.hashgrid import _level_corners

    warp_id = torch.arange(x.shape[0], device=x.device) // warp
    counts = []
    for lv in levels:
        idx, _ = _level_corners(lv, interpolation, x)  # (corners, samples)
        counts.append({
            "resolution": lv.resolution, "rows": lv.size, "adds": idx.numel(),
            "after_warp_sum": sum(int(torch.unique(warp_id * lv.size + row).numel())
                                  for row in idx),
            "after_warp_sum_any_slot": int(torch.unique(warp_id * lv.size + idx).numel()),
            "hottest_row": int(torch.bincount(idx.reshape(-1), minlength=lv.size).max())})
    return counts


def count() -> dict:
    """row_add_counts of the image step at 8192^2, on the CPU."""
    sys.path.insert(0, str(HERE))
    import torch

    enc = _chip_smoke().image_levels(8192)
    x = stratified(N_IMAGE, torch.Generator().manual_seed(SEED), "cpu")
    levels = row_add_counts(enc.levels, enc.interpolation, x)
    return {"adds": sum(c["adds"] for c in levels),
            "after_warp_sum": sum(c["after_warp_sum"] for c in levels),
            "after_warp_sum_any_slot": sum(c["after_warp_sum_any_slot"] for c in levels),
            "levels": levels}


def mlp_weights(dims, gen, device):
    import torch

    return [torch.randn((a, b), generator=gen, device=device) * (2.0 / a) ** 0.5
            for a, b in zip(dims[:-1], dims[1:])]


def wide_inputs(dims, n: int, gen, device):
    """Weights, an input in [0, 1) and a cotangent of a loss's size (1/N)."""
    import torch

    ws = mlp_weights(dims, gen, device)
    x = torch.rand((n, dims[0]), generator=gen, device=device)
    g = torch.randn((n, dims[-1]), generator=gen, device=device) / n
    return ws, x, g


def run_wide(root: Path) -> dict:
    """F's wide route at ``WIDE_CASES``: see the module's docstring."""
    sys.path.insert(0, str(root))
    import torch

    from instant_ngp_torch import cuda_lib
    from instant_ngp_torch.ops.mlp_kernel import fused_mlp_bwd, fused_mlp_bwd_plain, mlp_recompute

    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: this benchmark needs an NVIDIA GPU")
    cs = _chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    _, build_s = cuda_lib.build()
    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(SEED)
    out = {"root": str(root), "device": torch.cuda.get_device_name(0), "build_s": build_s, "F": {}}
    for name, (dims, n) in WIDE_CASES.items():
        ws, x, g = wide_inputs(dims, n, gen, device)
        keep = ~cs.mask_differs(ws, x, "relu", mlp_recompute(ws, x))
        xk, gk = x[keep].contiguous(), g[keep].contiguous()
        dx, dws = fused_mlp_bwd(ws, xk, gk)
        dx_p, dws_p = fused_mlp_bwd_plain(ws, xk, gk)
        leaves = cs.mlp_bwd_leaves([dx, *dws], [dx_p, *dws_p])
        cs.check(cs.mlp_bwd_agrees(leaves), f"F {name}: a leaf past its tolerance: {leaves}")
        copies = cs.cold_copies(x, g)
        dev = cs.device_split(lambda: fused_mlp_bwd(ws, *next(copies)), "mlp_wide_kernel",
                              reps=10, per_call=1)
        out["F"][name] = {"dims": dims, "rows": n, "max_rel_err": max(v["rel"] for v in leaves),
                          "kernel_ms": dev["kernel_ms"], "device_ms": dev["device_ms"],
                          "timed_by": dev["timed_by"]}
        del copies
    return out


# --act's widths and rows: fox's rgb MLP and image/oneblob's (a deep 128-wide MLP)
ACT_SHAPES = {"fox_rgb": ((32, 64, 64, 3), 1 << 17), "oneblob": ((256,) + (128,) * 8 + (3,), 1 << 17)}
MIXED_PAIRS = (("sine", "tanh"),)  # as chip_smoke.MIXED_PAIRS


def act_cases(acts) -> dict:
    """name -> (dims, rows, hidden, output activation) of --act: each
    activation hidden and as output at each ACT_SHAPES, relu/none there, and
    each pair of MIXED_PAIRS (hidden, output) whose two activations are given."""
    cases = {}
    for shape, (dims, n) in ACT_SHAPES.items():
        cases[f"relu {shape}"] = (dims, n, "relu", "none")
        for act in acts:
            cases[f"{act} hidden {shape}"] = (dims, n, act, "none")
            cases[f"{act} output {shape}"] = (dims, n, "relu", act)
        for hidden, out in MIXED_PAIRS:
            if hidden in acts and out in acts:
                cases[f"{hidden} hidden {out} output {shape}"] = (dims, n, hidden, out)
    return cases


def digest(*tensors) -> str:
    """The first 16 hex digits of the SHA-256 of the tensors' bytes."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def run_acts(root: Path, acts) -> dict:
    """F's wide route at ``act_cases(acts)``: see the module's docstring."""
    sys.path.insert(0, str(root))
    import torch

    from instant_ngp_torch import cuda_lib
    from instant_ngp_torch.ops import mlp_kernel as mk

    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: this benchmark needs an NVIDIA GPU")
    cs = _chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    _, build_s = cuda_lib.build()
    device = torch.device("cuda")
    out = {"root": str(root), "device": torch.cuda.get_device_name(0), "build_s": build_s, "F": {}}
    for name, (dims, n, act, out_act) in act_cases(acts).items():
        gen = torch.Generator(device=device).manual_seed(SEED)  # the same inputs in every case
        ws, x, g = wide_inputs(dims, n, gen, device)
        codes = mk.ACTIVATIONS[act], mk.ACTIVATIONS[out_act]

        def call(xx, gg):
            return mk._launch_bwd(ws, xx, gg, dims, *codes, narrow=False)

        keep = ~cs.mask_differs(ws, x, act, mk.mlp_recompute(ws, x, act, out_act))
        dx, dws = call(x, g)
        sha = digest(dx, *dws)
        xk, gk = x[keep].contiguous(), g[keep].contiguous()
        dx, dws = call(xk, gk)
        dx_p, dws_p = mk.fused_mlp_bwd_plain(ws, xk, gk, act, out_act)
        leaves = cs.mlp_bwd_leaves([dx, *dws], [dx_p, *dws_p])
        copies = cs.cold_copies(x, g)
        dev = cs.device_split(lambda: call(*next(copies)), "mlp_wide_kernel", reps=10, per_call=1)
        out["F"][name] = {"dims": dims, "rows": n, "activations": (act, out_act), "digest": sha,
                          "max_rel_err": max(v["rel"] for v in leaves),
                          "kernel_ms": dev["kernel_ms"], "device_ms": dev["device_ms"],
                          "timed_by": dev["timed_by"]}
        del copies
    return out


def sdf_encoding():
    """configs/sdf/base.json's grid as ``SdfTask`` autoconfigures it."""
    from instant_ngp_torch.models.factory import autoconfig_grid_encoding
    from instant_ngp_torch.ops.hashgrid import grid_encoding_from_config

    cfg = json.loads((HERE / "configs" / "sdf" / "base.json").read_text())["encoding"]
    return grid_encoding_from_config(autoconfig_grid_encoding(cfg, "sdf"), 3, device="meta")


def mesh_hits(width: int, height: int, device):
    """The surface points of the BVH ray cast of the SDF phase's mesh from
    its camera, (n, 3) f32 on device in pixel order."""
    import numpy as np
    import torch

    from instant_ngp_torch.geometry.bvh import TriangleBvh
    from instant_ngp_torch.geometry.mesh_io import normalize_to_unit_cube
    from instant_ngp_torch.geometry.procedural import bumpy_torus
    from instant_ngp_torch.render.camera import pinhole_rays

    v, f = bumpy_torus(*DX_MESH, seed=SEED)
    tris, _, _ = normalize_to_unit_cube(v[f])
    o, d = pinhole_rays(width, height, _chip_smoke().sdf_camera(), SDF_FOV, "cpu")
    o, d = o.numpy(), d.to(torch.float32).numpy()
    t, _ = TriangleBvh(tris).raytrace(o, d)
    hit = np.isfinite(t)
    pos = (o[hit] + t[hit, None] * d[hit]).astype(np.float32)
    return torch.from_numpy(pos).to(device).contiguous()


def dx_inputs(width: int, height: int, device) -> tuple:
    """(levels, table, x, g) of ``--dx`` at one frame size."""
    import torch

    enc = sdf_encoding()
    gen = torch.Generator(device=device).manual_seed(SEED)
    table = torch.rand((enc.n_entries, enc.n_features_per_level), generator=gen,
                       device=device) * 2.0 - 1.0
    x = mesh_hits(width, height, device)
    g = torch.randn((x.shape[0], enc.n_output_dims), generator=gen, device=device)
    return enc.levels, table, x, g


def working_clock(device) -> None:
    """~30 ms of f32 matrix products on the card, ahead of a timing, so that
    it runs at its working clock and not at the one it idles at."""
    import torch

    a = torch.ones((4096, 4096), device=device)
    for _ in range(10):
        a @ a


def run_dx(root: Path) -> dict:
    """K at ``DX_SHAPES``: see the module's docstring."""
    sys.path.insert(0, str(root))
    import torch

    from instant_ngp_torch import cuda_lib
    from instant_ngp_torch.ops.hashgrid import hashgrid_encode_dx

    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: this benchmark needs an NVIDIA GPU")
    cs = _chip_smoke()
    _, build_s = cuda_lib.build()
    device = torch.device("cuda")
    out = {"root": str(root), "device": torch.cuda.get_device_name(0), "build_s": build_s, "K": {}}
    with torch.no_grad():
        for name, (w, h) in DX_SHAPES.items():
            levels, table, x, g = dx_inputs(w, h, device)
            working_clock(device)
            v = cs.check_encode_dx(levels, "linear", table, x, g, f"{name} (BVH hits)")
            copies = cs.cold_copies(table, x, g)
            working_clock(device)
            cold = cs.device_split(
                lambda: hashgrid_encode_dx(levels, "linear", *next(copies)), "hashgrid_dx_kernel",
                per_call=1)
            del copies
            out["K"][name] = {**{k: v[k] for k in ("rows", "equal_rows", "ms", "plain_ms",
                                                   "bound_ms", "device_ms", "kernel_ms")},
                              "device_ms_cold": cold["device_ms"],
                              "kernel_ms_cold": cold["kernel_ms"], "timed_by": v["timed_by"]}
    return out


def run(root: Path) -> dict:
    sys.path.insert(0, str(root))
    import torch

    from instant_ngp_torch import cuda_lib
    from instant_ngp_torch.ops.hashgrid import hashgrid_encode_bwd
    from instant_ngp_torch.ops.mlp_kernel import fused_mlp_bwd

    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: this benchmark needs an NVIDIA GPU")
    cs = _chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    _, build_s = cuda_lib.build()
    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(SEED)
    out = {"root": str(root), "device": torch.cuda.get_device_name(0), "build_s": build_s,
           "E": {}, "F": {}}

    def e_case(name, enc, x, corners):
        g = torch.randn((x.shape[0], enc.n_output_dims), generator=gen, device=device)
        args = (enc.levels, enc.interpolation, x, g, enc.n_entries, corners)
        v = cs.check_encode_bwd(*args, name)
        out["E"][name] = {**{k: v[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms")},
                          **cs.device_split(lambda: hashgrid_encode_bwd(*args), "hashgrid_bwd")}

    with torch.no_grad():
        enc = cs.image_levels(8192)
        e_case("image8192_stratified", enc, stratified(N_IMAGE, gen, device), 1)
        enc = cs.image_levels(16384)
        x = torch.rand((N_IMAGE, 2), generator=gen, device=device)
        for k in (1, 4):
            e_case(f"image16384_random_corners{k}", enc, x, k)
        enc = fox_levels()
        x = torch.rand((N_FOX, 3), generator=gen, device=device)
        for interp in ("linear", "simplex"):
            enc.interpolation = interp
            for k in (1, 8):
                e_case(f"fox_{interp}_corners{k}", enc, x, k)

        for name, dims, n in (("fox_density", (32, 64, 16), N_FOX), ("fox_rgb", (32, 64, 64, 3), N_FOX),
                              ("image", (32, 64, 64, 3), N_IMAGE),
                              ("rgb_ragged", (32, 64, 64, 3), N_FOX - RAGGED)):
            ws = mlp_weights(dims, gen, device)
            inp = torch.randn((n, dims[0]), generator=gen, device=device)
            inp[cs.ZERO_ROW] = 0.0
            g = torch.randn((n, dims[-1]), generator=gen, device=device)
            v = cs.check_mlp_bwd(ws, inp, g, name)
            out["F"][name] = {**{k: v[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms")},
                              **cs.device_split(lambda: fused_mlp_bwd(ws, inp, g), "mlp_bwd")}
    return out


def summarize(res: dict) -> dict:
    """One --ab line's entries: each case's back-to-back ms; with --wide,
    each case's [kernel_ms, device_ms]; with --dx, each case's [ms,
    kernel_ms, kernel_ms_cold, device_ms, device_ms_cold]."""
    if "K" in res:
        return {f"K:{case}": [v[k] for k in ("ms", "kernel_ms", "kernel_ms_cold", "device_ms",
                                             "device_ms_cold")] for case, v in res["K"].items()}
    if "E" not in res:
        return {f"F:{case}": [v["kernel_ms"], v["device_ms"], *([v["digest"]] if "digest" in v else [])]
                for case, v in res["F"].items()}
    return {f"{k}:{case}": v["ms"] for k in ("E", "F") for case, v in res[k].items()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--ab", type=Path, default=None, metavar="OLD_DIR")
    ap.add_argument("--logs", type=Path, default=HERE / "build" / "bwd_ab", metavar="DIR")
    ap.add_argument("--count", action="store_true")
    ap.add_argument("--no-smoke", action="store_true",
                    help="--ab without each tree's chip_smoke.py run")
    ap.add_argument("--wide", action="store_true", help="F's wide route at WIDE_CASES only")
    ap.add_argument("--act", nargs="+", default=None, metavar="NAME",
                    help="with --wide: the wide F at ACT_SHAPES under these activations")
    ap.add_argument("--dx", action="store_true", help="kernel K at DX_SHAPES only")
    args = ap.parse_args()
    if args.count:
        print(json.dumps(count()))
        return
    if args.ab is not None:
        sys.path.insert(0, str(HERE))
        from instant_ngp_torch.bench.ab import ab

        mode = ("--wide",) if args.wide else ("--dx",) if args.dx else ()
        if args.act:
            mode += ("--act", *args.act)
        ab(args.ab.resolve(), HERE, args.logs.resolve(), Path(__file__).resolve(), summarize,
           smoke=not (mode or args.no_smoke), args=mode)
        return
    if args.wide and args.act:
        print(json.dumps(run_acts(args.root.resolve(), args.act)))
        return
    runner = run_wide if args.wide else run_dx if args.dx else run
    print(json.dumps(runner(args.root.resolve())))


if __name__ == "__main__":
    main()
