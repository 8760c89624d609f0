"""Repeat ``chip_smoke.py``'s NeRF training run and report every run whose
loss or parameters stop being finite.

    python -m instant_ngp_torch.bench.nerf_repeat [--runs N] [--steps S] [--root DIR]
    python -m instant_ngp_torch.bench.nerf_repeat --ab OLD_DIR [--order old,new,new,old] [--runs N]

Loads the fox snapshot, renders its 50 views as the training set (as
``chip_smoke.py`` does), then trains ``chip_smoke.py``'s configuration from
seed 0 N times through ``Testbed.frame()``. The kernels' atomics sum in a
different order each run, so runs from the same seed differ in their last
bits. After each step it checks the step's loss and every parameter; at
the first step where one is not finite it prints the step and the leaves
that are not, and ends that run. A run that reaches its end then trains
``chip_smoke.PROFILED_STEPS`` more frames under torch.profiler
(``chip_smoke.profile_frames``). One JSON line per run, with the median
host ms of its frames (``Testbed.frame()`` alone, as ``chip_smoke.py``'s
train phase times it) and the profiled frames' wall, device busy and idle
share, then a summary line. Without a card it raises.

``--root DIR`` (default: this checkout) imports ``instant_ngp_torch`` from
DIR, which builds its kernels into DIR/build; the configuration, snapshot
and training set are this checkout's ``chip_smoke.py``'s. ``--ab OLD_DIR``
runs this script with ``--root`` OLD_DIR, this checkout, this checkout,
OLD_DIR, each in its own process on the same card, prints their lines and
then, per tree, the medians of its runs' step medians and idle shares.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run(n_runs: int, steps: int, root: Path = ROOT) -> list[dict]:
    sys.path.insert(0, str(root))
    import instant_ngp_torch
    from instant_ngp_torch.nerf.task import NerfTask
    from instant_ngp_torch.testbed import Testbed

    package = Path(instant_ngp_torch.__file__).resolve().parents[1]
    if package != root:
        raise RuntimeError(f"instant_ngp_torch came from {package}, not {root}: run this file "
                           f"as a script (not with -m) to take another tree's package")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: this benchmark needs an NVIDIA GPU")
    cs = _chip_smoke()
    device = torch.device("cuda")
    tb = Testbed("nerf", device=device)
    tb.load_snapshot(cs.SNAPSHOT)
    ds = cs.render_training_set(tb)
    results = []
    for i in range(n_runs):
        trainer = Testbed("nerf", device=device)
        trainer.nerf_dataset, trainer.network_config = ds, cs.fox_train_config()
        trainer.task = NerfTask(ds, trainer.network_config, device, seed=cs.SEED,
                                target_batch_size=cs.TARGET_BATCH, n_rays_per_batch=cs.TRAIN_RAYS,
                                max_samples_per_ray=cs.TRAIN_K, n_march_iters=cs.TRAIN_ITERS)
        params = dict(trainer.task.model.named_parameters())
        t0 = time.perf_counter()
        result = {"run": i, "steps": 0, "first_bad_step": None, "bad_leaves": []}
        frame_ms = []
        for step in range(steps):
            t1 = time.perf_counter()
            trainer.frame()
            frame_ms.append((time.perf_counter() - t1) * 1e3)
            result["steps"] = step + 1
            bad = [name for name, p in params.items() if not bool(torch.isfinite(p).all())]
            if trainer.task.training_aborted or bad or not math.isfinite(trainer.loss_graph[-1]):
                result.update(first_bad_step=step, bad_leaves=bad,
                              loss=trainer.loss_graph[-1], aborted=trainer.task.training_aborted)
                break
        result["loss_last"] = trainer.loss_graph[-1]
        result["seconds"] = time.perf_counter() - t0
        result["step_ms_median"] = statistics.median(frame_ms)
        if result["first_bad_step"] is None:
            wall, busy, _, _ = cs.profile_frames(trainer)
            result.update(profiled_wall_ms=wall, profiled_busy_ms=busy,
                          idle_share=None if busy is None else 1.0 - busy / wall)
        print(json.dumps(result), flush=True)
        results.append(result)
    return results


def ab(old: Path, order: list[str], n_runs: int, steps: int) -> None:
    """OLD_DIR and this checkout in ``order``: see the docstring."""
    by_tree = {"old": [], "new": []}
    for tag in order:
        root = {"old": old, "new": ROOT}[tag]
        proc = subprocess.run([sys.executable, __file__, "--root", str(root), "--runs",
                               str(n_runs), "--steps", str(steps)], capture_output=True,
                              text=True, timeout=1800)
        lines = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
        for line in lines:
            print(json.dumps({"tree": tag, **line}), flush=True)
        if proc.returncode != 0:
            raise RuntimeError(f"the {tag} tree's runs exited {proc.returncode}: "
                               f"{proc.stderr[-3000:]}")
        by_tree[tag] += [ln for ln in lines if "run" in ln]
    for tag, runs in by_tree.items():
        idle = [r["idle_share"] for r in runs if r.get("idle_share") is not None]
        print(json.dumps({"tree": tag, "runs": len(runs),
                          "step_ms_median_of_runs": statistics.median(
                              r["step_ms_median"] for r in runs),
                          "idle_share_median_of_runs": statistics.median(idle) if idle else None,
                          "device": torch.cuda.get_device_name(0)}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--root", type=Path, default=ROOT)
    ap.add_argument("--ab", type=Path, default=None, metavar="OLD_DIR")
    ap.add_argument("--order", default="old,new,new,old")
    args = ap.parse_args()
    if args.ab is not None:
        ab(args.ab.resolve(), args.order.split(","), args.runs, args.steps)
        return
    results = run(args.runs, args.steps, args.root.resolve())
    bad = [r["run"] for r in results if r["first_bad_step"] is not None]
    print(json.dumps({"runs": len(results), "not_finite": len(bad), "bad_runs": bad,
                      "device": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
