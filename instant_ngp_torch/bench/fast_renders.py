"""The baked and slab renders of one source tree on the fox snapshot: frame
times and device time of each, the baked round's parts and kernel O, and an
old/new comparison of two trees.

    python instant_ngp_torch/bench/fast_renders.py [--root DIR] [--frames N]
    python instant_ngp_torch/bench/fast_renders.py --ab OLD_DIR [--order old,new,new,old]

``--root DIR`` (default: this checkout) imports ``instant_ngp_torch`` from
DIR, builds its kernels into DIR/build and prints one JSON line:

- ``frames``: fox's view 0 through ``Testbed.render`` (as ``chip_smoke.py``'s
  ``fast_renders`` phase renders it) at ``render_quality`` "baked" and "slab"
  (deferred), at ``chip_smoke.FAST_RES``² and ``chip_smoke.RENDER_WH``: after
  a warm frame, the host ms of N frames between synchronizes (each, and
  their median), and the device ms of one frame (the sum of its device
  events under torch.profiler) with its event count;
- ``round``: the first round of the baked render's 2^18-ray chunk at the
  middle of the 1920x1080 frame, before its compaction (the window of
  ``chip_smoke.check_baked_round``): device ms of the samples' positions
  (``common.fma``'s f64 ops), of kernel N on them and, in a tree that
  composites through kernel D's activated mode, of that launch; in a tree
  with ``baked.render_round``, of the round kernel. And the whole of it
  after the march, back to back and by device time: the positions, N and D
  in the first kind of tree, the round in the second;
- ``warp``: kernel O's device ms on the 1920x1080 frame's warp, deferred (C
  8) and diffuse (C 5).

``--ab OLD_DIR`` runs this script on OLD_DIR and on this checkout in the
order given (default old, new, new, old), prints each run's line with its
tree, then per tree the median of each number over its runs. Without a card
it raises.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parents[2]  # this checkout


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def frames(cs, tb, n: int) -> dict:
    """Host ms of n frames and device ms of one, per quality and size."""
    sizes = {"256": (cs.FAST_RES, cs.FAST_RES), "1080p": cs.RENDER_WH}
    out = {}
    for quality in ("baked", "slab"):
        tb.render_quality = quality
        for k, wh in sizes.items():
            tb.render(*wh)  # the bake, the allocator's blocks
            ms = []
            for _ in range(n):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tb.render(*wh)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            dev = cs.device_split(lambda: tb.render(*wh), "", reps=1)
            out[f"{quality}_{k}"] = {"ms": ms, "ms_median": statistics.median(ms),
                                     "device_ms": dev["device_ms"],
                                     "events": dev["events_per_call"],
                                     "timed_by": dev["timed_by"]}
    tb.render_quality = "exact"
    return out


def round_parts(cs, task, device) -> dict:
    """The baked round's parts at the 1080p middle chunk's first round."""
    from instant_ngp_torch.common import fma
    from instant_ngp_torch.nerf import baked
    from instant_ngp_torch.nerf.task import composite_window

    xf, _ = cs.view0_wh(task, *cs.RENDER_WH)
    cache = task._get_baked(origin=xf[:, 3])
    o, d, tmin, tmax = cs.middle_chunk_rays(task, cs.RENDER_WH, device)
    args = cs.first_round(task, cache, o, d, tmin, tmax)
    ts, dts, valid, state = args[3], args[4], args[5], args[6:14]
    R, K = ts.shape

    def positions():
        return fma(ts[..., None], d[:, None, :], o[:, None, :]).reshape(R * K, 3).contiguous()

    pos = positions()
    out = {"rays": R, "K": K, "valid_samples": int(valid.sum()),
           "positions_device_ms": cs.device_split(positions, "elementwise")["device_ms"],
           "n_device_ms": cs.device_split(lambda: baked.query(cache, pos),
                                          "baked_query")["kernel_ms"]}
    if hasattr(baked, "render_round"):
        def whole():
            return baked.render_round(*args)

        out["round_device_ms"] = cs.device_split(whole, "baked_round")["kernel_ms"]
    else:
        samples = baked.query(cache, pos).reshape(R, K, 4)
        act = (task.min_transmittance, task.rgb_activation, task.density_activation, True)
        out["d_activated_device_ms"] = cs.device_split(
            lambda: composite_window(samples, ts, dts, valid, *state, *act),
            "composite_window")["kernel_ms"]

        def whole():
            s = baked.query(cache, positions()).reshape(R, K, 4)
            return composite_window(s, ts, dts, valid, *state, *act)

    dev = cs.device_split(whole, "")
    out.update({"whole_ms": cs.time_ms(whole), "whole_device_ms": dev["device_ms"],
                "whole_events": dev["events_per_call"]})
    return out


def warp(cs, tb) -> dict:
    """Kernel O's device ms on the 1080p frame's deferred and diffuse warps."""
    from instant_ngp_torch.nerf import slab

    task, out = tb.task, {}
    tb.render_quality = "slab"
    for name, deferred in (("deferred_c8", True), ("diffuse_c5", False)):
        task.slab_deferred_vd = deferred
        tb.render(*cs.RENDER_WH)  # the bake
        keep, orig = cs.first_call(slab, "warp_composite", lambda a: True)
        try:
            tb.render(*cs.RENDER_WH)
        finally:
            slab.warp_composite = orig
        args, kw = keep["args"], keep["kwargs"]
        dev = cs.device_split(lambda: slab.warp_composite(*args, **kw), "slab_warp")
        out[name] = {"kernel_ms": dev["kernel_ms"], "C": args[3].shape[1] // 4,
                     "ms": cs.time_ms(lambda: slab.warp_composite(*args, **kw))}
    task.slab_deferred_vd = True
    tb.render_quality = "exact"
    return out


def run(root: Path, n_frames: int) -> dict:
    sys.path.insert(0, str(root))
    import instant_ngp_torch
    from instant_ngp_torch import cuda_lib
    from instant_ngp_torch.testbed import Testbed

    package = Path(instant_ngp_torch.__file__).resolve().parents[1]
    if package != root:
        raise RuntimeError(f"instant_ngp_torch came from {package}, not {root}: run this file "
                           f"as a script (not with -m) to take another tree's package")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: this benchmark needs an NVIDIA GPU")
    cs = _chip_smoke()
    _, card = cs.phase_device()
    device = torch.device("cuda")
    _, build_s = cuda_lib.build()
    tb = Testbed("nerf", device=device)
    tb.load_snapshot(cs.SNAPSHOT)
    tb.set_camera_to_training_view(0)
    result = {"tree": "new" if root == HERE else "old", "card": card, "build_s": build_s,
              "frames": frames(cs, tb, n_frames), "round": round_parts(cs, tb.task, device),
              "warp": warp(cs, tb), "device": torch.cuda.get_device_name(0)}
    return result


def _numbers(line: dict, prefix: str = "") -> dict:
    """The line's numbers, flattened to dotted keys."""
    out = {}
    for k, v in line.items():
        if isinstance(v, dict):
            out.update(_numbers(v, f"{prefix}{k}."))
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            out[f"{prefix}{k}"] = v
    return out


def ab(old: Path, order: list[str], n_frames: int) -> None:
    by_tree = {"old": [], "new": []}
    for tag in order:
        root = {"old": old, "new": HERE}[tag]
        proc = subprocess.run([sys.executable, __file__, "--root", str(root), "--frames",
                               str(n_frames)], capture_output=True, text=True, timeout=1500)
        lines = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
        if proc.returncode != 0 or not lines:
            raise RuntimeError(f"the {tag} tree's run exited {proc.returncode}: "
                               f"{proc.stderr[-3000:]}")
        print(json.dumps({"run_tree": tag, **lines[-1]}), flush=True)
        by_tree[tag].append(_numbers(lines[-1]))
    for tag, runs in by_tree.items():
        keys = sorted(set().union(*runs)) if runs else []
        print(json.dumps({"tree": tag, "runs": len(runs), "median": {
            k: statistics.median(r[k] for r in runs if k in r) for k in keys}}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--ab", type=Path, default=None, metavar="OLD_DIR")
    ap.add_argument("--order", default="old,new,new,old")
    args = ap.parse_args()
    if args.ab is not None:
        ab(args.ab.resolve(), args.order.split(","), args.frames)
        return
    print(json.dumps(run(args.root.resolve(), args.frames)), flush=True)


if __name__ == "__main__":
    main()
