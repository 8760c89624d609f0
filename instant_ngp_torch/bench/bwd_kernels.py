"""Kernels E (hash-grid table gradients) and F (fused MLP backward) of one
source tree, at the shapes of their paths, timed back to back; and an
old/new comparison of two trees.

    python instant_ngp_torch/bench/bwd_kernels.py [--root DIR]
    python instant_ngp_torch/bench/bwd_kernels.py --ab OLD_DIR [--logs DIR]
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

Weights, inputs and cotangents are random from SEED. ``--ab OLD_DIR``
compares OLD_DIR with this checkout through ``bench/ab.py`` (old, new, new,
old: each tree's ``chip_smoke.py`` and this script), writes the outputs
under DIR (default build/bwd_ab/) and prints E's and F's times and the NeRF
and image step times of each run. Without a card it raises.

``--count`` runs on the CPU: for the image step's 2^18 stratified positions
(seed-0 uniforms) on the 8192^2 grid, per level and in all, the row-adds of
kernel E's exact corners, those left after its warp sums, and the adds into
each level's hottest row.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]  # this checkout
SEED = 0
N_FOX, N_IMAGE = 1 << 17, 1 << 18
RAGGED = 37
FOX_AABB_SCALE = 4


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
    """One --ab line's entries: each case's back-to-back ms."""
    return {f"{k}:{case}": v["ms"] for k in ("E", "F") for case, v in res[k].items()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--ab", type=Path, default=None, metavar="OLD_DIR")
    ap.add_argument("--logs", type=Path, default=HERE / "build" / "bwd_ab", metavar="DIR")
    ap.add_argument("--count", action="store_true")
    args = ap.parse_args()
    if args.count:
        print(json.dumps(count()))
        return
    if args.ab is not None:
        sys.path.insert(0, str(HERE))
        from instant_ngp_torch.bench.ab import ab

        ab(args.ab.resolve(), HERE, args.logs.resolve(), Path(__file__).resolve(), summarize)
        return
    print(json.dumps(run(args.root.resolve())))


if __name__ == "__main__":
    main()
