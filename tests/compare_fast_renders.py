"""The fast renders of the fox snapshot in both packages on the CPU.

    JAX_PLATFORMS=cpu python tests/compare_fast_renders.py [--res 48] [--slab_res 64 48]
        [--baked_res 64]

Renders fox's view 0 at res² through the JAX package and the port (plain
versions) with render_quality "slab" (deferred, then diffuse) and "baked",
their bakes cut to the given resolutions so that the CPU finishes in a few
minutes, and prints each frame's PSNR against the port's exact frame (with
the crop box, as the exact render clips to it) and the two packages' frames
against each other. The slab render ignores the crop box in both packages.
"""

import argparse
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from instant_ngp_tpu.testbed import Testbed as JaxTestbed  # noqa: E402
from instant_ngp_torch.testbed import Testbed  # noqa: E402

SNAPSHOT = ROOT / "data" / "fox_1536.ingp"


def psnr(a, b) -> float:
    mse = float(np.mean((np.clip(a[..., :3], 0, 1) - np.clip(b[..., :3], 0, 1)) ** 2))
    return -10.0 * np.log10(max(mse, 1e-12))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=48)
    ap.add_argument("--slab_res", type=int, nargs=2, default=(64, 48))
    ap.add_argument("--baked_res", type=int, default=64)
    args = ap.parse_args()
    ours = Testbed("nerf", device="cpu")
    ours.load_snapshot(SNAPSHOT)
    theirs = JaxTestbed("nerf")
    theirs.load_snapshot(str(SNAPSHOT))
    ds = ours.nerf_dataset
    w, h = ds.resolution
    res = args.res
    xf = np.asarray(ds.xforms_start[0], np.float32)
    kw = dict(focal_length=(ds.focal_lengths[0, 0] * res / w, ds.focal_lengths[0, 1] * res / h),
              principal_point=tuple(ds.principal_points[0]))
    exact = ours.task.render(res, res, xf, **kw).numpy()
    for task in (ours.task, theirs.task):
        task.slab_res0, task.slab_res_outer = args.slab_res
        task.baked_res0 = args.baked_res
    for name, quality, deferred in (("slab deferred", "slab", True),
                                    ("slab diffuse", "slab", False), ("baked", "baked", True)):
        frames = []
        for task in (ours.task, theirs.task):
            task.slab_deferred_vd, task._slab_cache = deferred, None
            t0 = time.perf_counter()
            frames.append(np.asarray(task.render(res, res, xf, render_quality=quality, **kw)))
            print(f"{name} {'port' if task is ours.task else 'jax'}: {time.perf_counter() - t0:.1f} s"
                  f", PSNR against the exact frame {psnr(frames[-1], exact):.2f} dB")
        print(f"{name}: port against jax {psnr(*frames):.2f} dB")


if __name__ == "__main__":
    main()
