"""Train one generated scene from disk with one package, for several seeds,
and print the PSNR of the held-out ``transforms_test.json`` views and of
training views before and after training.

    JAX_PLATFORMS=cpu python tests/compare_disk_training.py --package jax --seeds 1337 1 2
    python tests/compare_disk_training.py --package port --device cuda --seeds 1337 1 2

The scene is ``io/synthetic.py``'s at its defaults but ``--res``
(``chip_smoke.DISK_RES``, 128). For each seed (``Testbed.seed``: the
network's initialization and the training draws) the package loads it with
``Testbed("nerf").load_training_data`` (``configs/nerf/base.json``) and runs
``frame()`` ``--frames`` times. Every view is rendered by the package's own
render at spp 1 on black and held against its image, both premultiplied
sRGB (``chip_smoke.eval_views``' protocol). Prints one JSON line a seed: the
PSNR of the mean MSE before and after training, and each view's. The port's
lines also give, for the test views, the share of the object's pixels (image
alpha > 0) whose ray starts on the crop box's face at a point that rounds to
just outside the aabb: the march stops there and the pixel renders
transparent, in both packages (ROADMAP.md Queue 3). The JAX package takes
about 15 minutes a seed on 8 CPU cores.
"""

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from instant_ngp_torch.common import fma  # noqa: E402
from instant_ngp_torch.io.nerf_loader import load_nerf  # noqa: E402
from instant_ngp_torch.io.synthetic import generate_synthetic_dataset  # noqa: E402

TRAIN_VIEWS = (0, 6, 12, 18)


def view_kwargs(ds, i) -> dict:
    return dict(focal_length=tuple(ds.focal_lengths[i]),
                principal_point=tuple(ds.principal_points[i]), background=(0, 0, 0, 0))


def split_psnr(package, task, ds, views):
    mses = []
    for i in views:
        w, h = ds.resolution
        frame = task.render(w, h, ds.xforms_start[i], **view_kwargs(ds, i))
        frame = np.asarray(frame) if package == "jax" else frame.cpu().numpy()
        gt = ds.images[i].astype(np.float32) / 255.0
        mses.append(float(np.mean((np.clip(frame[..., :3], 0, 1)
                                   - gt[..., :3] * gt[..., 3:4]) ** 2)))
    return (-10 * np.log10(np.mean(mses)), [round(-10 * np.log10(m), 2) for m in mses])


@torch.no_grad()
def face_lost_share(task, ds) -> float:
    """Share of the object's pixels of ``ds``'s views whose render ray
    starts outside the aabb: the port's ``_prep_rays`` and the march's
    inside test on its first position."""
    lost = hit = 0
    amin, amax = task._aabb_t
    for i in range(ds.n_images):
        w, h = ds.resolution
        ys, xs = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
        uv = torch.stack([(xs.reshape(-1) + 0.5) / w, (ys.reshape(-1) + 0.5) / h], -1).float()
        kw = view_kwargs(ds, i)
        o, d, tmin, tmax = task._prep_rays(uv.to(task.device), task._t([w, h]),
                                           task._t(kw["focal_length"]),
                                           task._t(kw["principal_point"]),
                                           task._t(ds.xforms_start[i]))
        pos = fma(tmin[:, None], d, o)
        outside = ~torch.all((pos >= amin) & (pos <= amax), dim=-1)
        obj = torch.from_numpy(ds.images[i][..., 3].reshape(-1) > 0).to(task.device) & (tmax > tmin)
        lost += int((outside & obj).sum())
        hit += int(obj.sum())
    return lost / max(hit, 1)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("jax", "port"), required=True)
    ap.add_argument("--seeds", type=int, nargs="+", default=[1337])
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--frames", type=int, default=300)
    ap.add_argument("--device", default="cpu", help="the port's device")
    args = ap.parse_args()
    if args.package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from instant_ngp_tpu.testbed import Testbed
    else:
        from instant_ngp_torch.testbed import Testbed
    with tempfile.TemporaryDirectory() as tmp:
        scene, test_json = generate_synthetic_dataset(Path(tmp) / "scene", res=args.res)
        test = load_nerf(test_json)
        for seed in args.seeds:
            tb = Testbed("nerf") if args.package == "jax" else Testbed("nerf", device=args.device)
            tb.seed = seed
            tb.load_training_data(str(scene))
            task = tb.task
            out = {"package": args.package, "seed": seed, "res": args.res,
                   "frames": args.frames,
                   "test_before": split_psnr(args.package, task, test, range(test.n_images)),
                   "train_before": split_psnr(args.package, task, task.dataset, TRAIN_VIEWS)}
            if args.package == "port":
                out["test_face_lost_share"] = face_lost_share(task, test)
            t0 = time.perf_counter()
            for _ in range(args.frames):
                tb.frame()
            out["train_s"] = time.perf_counter() - t0
            out["test_after"] = split_psnr(args.package, task, test, range(test.n_images))
            out["train_after"] = split_psnr(args.package, task, task.dataset, TRAIN_VIEWS)
            out["test_gain_db"] = out["test_after"][0] - out["test_before"][0]
            print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
