"""Repeat ``chip_smoke.py``'s NeRF training run and report every run whose
loss or parameters stop being finite.

    python -m instant_ngp_torch.bench.nerf_repeat [--runs N] [--steps S]

Loads the fox snapshot, renders its 50 views as the training set (as
``chip_smoke.py`` does), then trains ``chip_smoke.py``'s configuration from
seed 0 N times through ``Testbed.frame()``. The kernels' atomics sum in a
different order each run, so runs from the same seed differ in their last
bits. After each step it checks the step's loss and every parameter; at
the first step where one is not finite it prints the step and the leaves
that are not, and ends that run. One JSON line per run, then a summary
line. Without a card it raises.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run(n_runs: int, steps: int) -> list[dict]:
    from instant_ngp_torch.nerf.task import NerfTask
    from instant_ngp_torch.testbed import Testbed

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
        for step in range(steps):
            trainer.frame()
            result["steps"] = step + 1
            bad = [name for name, p in params.items() if not bool(torch.isfinite(p).all())]
            if trainer.task.training_aborted or bad or not math.isfinite(trainer.loss_graph[-1]):
                result.update(first_bad_step=step, bad_leaves=bad,
                              loss=trainer.loss_graph[-1], aborted=trainer.task.training_aborted)
                break
        result["loss_last"] = trainer.loss_graph[-1]
        result["seconds"] = time.perf_counter() - t0
        print(json.dumps(result), flush=True)
        results.append(result)
    return results


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--steps", type=int, default=300)
    args = ap.parse_args()
    results = run(args.runs, args.steps)
    bad = [r["run"] for r in results if r["first_bad_step"] is not None]
    print(json.dumps({"runs": len(results), "not_finite": len(bad), "bad_runs": bad,
                      "device": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
