"""Train the volume of ``chip_smoke.py``'s volume phase with one package, for
several seeds, and print its density MSE before and after training.

    JAX_PLATFORMS=cpu python tests/compare_volume_training.py --package jax --seeds 1337 1 2
    python tests/compare_volume_training.py --package port --device cuda --seeds 1337 1 2

The grid is ``procedural_fog_volume(chip_smoke.VOLUME_RES)`` (128^3), the
network ``configs/volume/base.json`` at full width, and the batch the
task's default of 2^17 vertices a step, as ``Testbed("volume")`` builds it.
For each seed (the task's ``seed``: the network's initialization and the
generator of the delta-tracked batches) the package trains ``--steps``
steps (300) through ``VolumeTask.train`` and takes ``compute_density_mse``
at ``chip_smoke.VOLUME_MSE_SAMPLES`` points before and after. The packages
draw their parameters and batches from different generators, so a seed
gives each package its own run. Prints one JSON line a seed. The JAX
package takes ~35 minutes a seed on the CPU (8 cores); the port on the card
a few seconds after its kernels' build.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import VOLUME_MSE_SAMPLES, VOLUME_RES  # noqa: E402


def run_jax(grid, config, seed: int, steps: int) -> dict:
    from instant_ngp_tpu.volume.task import VolumeTask

    task = VolumeTask(grid, config, seed=seed)
    mse0 = task.compute_density_mse(VOLUME_MSE_SAMPLES)
    losses = [task.train(1) for _ in range(steps)]
    return {"mse_before": mse0, "mse_after": task.compute_density_mse(VOLUME_MSE_SAMPLES),
            "losses": losses}


def run_port(grid, config, seed: int, steps: int, device: str) -> dict:
    import torch

    from instant_ngp_torch.volume.task import VolumeTask

    task = VolumeTask(grid, config, device=device, seed=seed)
    mse0 = task.compute_density_mse(VOLUME_MSE_SAMPLES)
    losses = [task.train(1) for _ in range(steps)]
    if device != "cpu":
        torch.cuda.synchronize()
    return {"mse_before": mse0, "mse_after": task.compute_density_mse(VOLUME_MSE_SAMPLES),
            "losses": losses}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("jax", "port"), required=True)
    ap.add_argument("--device", default="cpu", help="the port's device")
    ap.add_argument("--seeds", type=int, nargs="+", default=[1337, 1, 2])
    ap.add_argument("--steps", type=int, default=300)
    args = ap.parse_args()
    from instant_ngp_torch.config import default_config
    from instant_ngp_torch.io.nanovdb import procedural_fog_volume

    config = default_config("volume")
    grid = procedural_fog_volume(VOLUME_RES)
    for seed in args.seeds:
        t0 = time.perf_counter()
        if args.package == "jax":
            r = run_jax(grid, config, seed, args.steps)
        else:
            r = run_port(grid, config, seed, args.steps, args.device)
        losses = r.pop("losses")
        print(json.dumps({"package": args.package, "seed": seed, "steps": args.steps, **r,
                          "loss_first": losses[0], "loss_last": losses[-1],
                          "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
