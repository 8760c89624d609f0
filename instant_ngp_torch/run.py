"""Train, evaluate and render a scene from the command line (port of
``scripts/run.py``): the same flags, defaults and printed lines, driving the
port's ``Testbed`` on the card.

    python -m instant_ngp_torch.run --scene data/scene --n_steps 1000 \\
        --test_transforms data/scene/transforms_test.json \\
        --screenshot_transforms data/scene/transforms_test.json --screenshot_dir shots \\
        --save_snapshot scene.ingp
    python -m instant_ngp_torch.run --load_snapshot data/fox_1536.ingp --n_steps 0 \
        --save_mesh fox.ply --marching_cubes_res 256 --optimize_mesh_steps 25
    python -m instant_ngp_torch.run ... --device cpu  # the plain versions, no card

The evaluation of ``--test_transforms`` is the reference's protocol
(run.py:257-317): every view rendered at spp 8 on black with a minimum
transmittance of 1e-4, against its image premultiplied in linear colour and
taken back to sRGB; PSNR, SSIM and ꟻLIP per view and their means.

As in ``scripts/run.py``, ``--mode``, ``--near_distance``, ``--exposure`` and
``--screenshot_spp`` are parsed and never read, and screenshots render at
spp 1. ``--save_mesh`` writes the marching-cubes mesh (PLY by the suffix,
else OBJ) after the snapshot is saved, optimised ``--optimize_mesh_steps``
steps. ``--train_mode rfl`` trains nerf for ``--rfl_warmup_steps`` steps, then
RFL; ``rflrelax`` trains RflRelax from ``--rflrelax_begin_step`` to
``--rflrelax_end_step`` and nerf around it (scripts/run.py:108-118); each
switch prints ``train_mode=<mode> from step <n>``. ``--nerf_compatibility``
sets what the port's NeRF task has (no cone stepping, no random background,
nerf mode); a run whose training stops (a
step that marched no sample) ends its loop, where ``scripts/run.py`` would
spin on it.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from pathlib import Path

import numpy as np
import torch

from . import pyngp as ngp
from .common import linear_to_srgb
from .io.image import save_image
from .io.nerf_loader import load_nerf
from .metrics import flip, mse_to_psnr, ssim
from .render.camera_path import CameraPath, render_video_frames
from .testbed import premultiplied_srgb


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Train/eval neural graphics primitives on the GPU")
    p.add_argument("--scene", "--training_data", default="",
                   help="scene path (dir/json/obj/exr/nvdb)")
    p.add_argument("--mode", default="", help="(deprecated; inferred from scene)")
    p.add_argument("--network", default="", help="network config json")
    p.add_argument("--load_snapshot", default="", help="load snapshot before training")
    p.add_argument("--save_snapshot", default="", help="save snapshot after training")
    p.add_argument("--n_steps", type=int, default=-1, help="training steps (default 35000)")
    p.add_argument("--batch_size", type=int, default=1 << 18)
    p.add_argument("--nerf_compatibility", action="store_true",
                   help="match original-NeRF params (no cone stepping, fixed background) for "
                        "synthetic-scene PSNR comparisons")
    p.add_argument("--test_transforms", default="", help="transforms.json for PSNR eval")
    p.add_argument("--screenshot_transforms", default="", help="render screenshots from transforms")
    p.add_argument("--screenshot_frames", nargs="*", help="which frames to screenshot")
    p.add_argument("--screenshot_dir", default="", help="output dir for screenshots")
    p.add_argument("--screenshot_spp", type=int, default=16)
    p.add_argument("--width", type=int, default=0)
    p.add_argument("--height", type=int, default=0)
    p.add_argument("--save_mesh", default="", help="marching-cubes mesh output path")
    p.add_argument("--marching_cubes_res", type=int, default=256)
    p.add_argument("--optimize_mesh_steps", type=int, default=0,
                   help="vertex-position optimization steps before export")
    # camera-path video: the frames are written as PNGs, the sequence the
    # reference pipes into ffmpeg
    p.add_argument("--video_camera_path", default="",
                   help="camera path json (saved by CameraPath.save)")
    p.add_argument("--video_n_seconds", type=float, default=1.0)
    p.add_argument("--video_fps", type=int, default=30)
    p.add_argument("--video_spp", type=int, default=2)
    p.add_argument("--video_output", default="video_frames",
                   help="output directory for the PNG frame sequence")
    p.add_argument("--near_distance", type=float, default=-1)
    p.add_argument("--exposure", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=1337)
    p.add_argument("--train_mode", default="nerf", choices=["nerf", "rfl", "rflrelax"],
                   help="NeRF / Radiance Field Loss / relaxed RFL")
    p.add_argument("--rfl_warmup_steps", type=int, default=1000,
                   help="steps of NeRF mode before switching to RFL")
    p.add_argument("--rflrelax_begin_step", type=int, default=10000)
    p.add_argument("--rflrelax_end_step", type=int, default=25000)
    p.add_argument("--device", default="cuda",
                   help="torch device of the run (cpu runs the kernels' plain versions)")
    return p.parse_args(argv)


def scheduled_train_mode(args, step: int) -> str | None:
    """The train mode of the frame at ``step`` (scripts/run.py:108-118):
    ``rfl`` after ``--rfl_warmup_steps`` steps of nerf; ``rflrelax`` inside
    [``--rflrelax_begin_step``, ``--rflrelax_end_step``), nerf around it; None
    for ``--train_mode nerf`` (the task's mode is left as it is)."""
    if args.train_mode == "rflrelax":
        return "rflrelax" if args.rflrelax_begin_step <= step < args.rflrelax_end_step else "nerf"
    if args.train_mode == "rfl":
        return "nerf" if step <= args.rfl_warmup_steps else "rfl"
    return None


def save_mesh(testbed, path: str, res: int, optimize_steps: int) -> None:
    """``--save_mesh`` (scripts/run.py:135-151): marching cubes at ``res``,
    the vertices optimised ``optimize_steps`` steps (NeRF; their colours
    stay those of the extracted vertices), written as PLY by the suffix or
    else OBJ."""
    from .geometry.marching_cubes import extract_mesh, optimise_mesh
    from .geometry.mesh_io import save_obj, save_ply

    verts, faces, colors = extract_mesh(testbed.task, res=res)
    if optimize_steps > 0 and verts.shape[0]:
        verts = optimise_mesh(testbed.task, verts, faces, n_steps=optimize_steps)
    (save_ply if path.endswith(".ply") else save_obj)(path, verts, faces, colors)
    print(f"saved mesh {path} ({verts.shape[0]} verts, {faces.shape[0]} faces)")


def evaluate(task, test_transforms) -> tuple[list[float], list[float], list[float]]:
    """The reference's evaluation of a transforms file (run.py:257-317):
    PSNR, SSIM and ꟻLIP of each view, printed as it goes."""
    test_ds = load_nerf(test_transforms)
    task.min_transmittance = 1e-4
    psnrs, ssims, flips = [], [], []
    for i in range(test_ds.n_images):
        w, h = test_ds.resolution
        frame = task.render(w, h, test_ds.xforms_start[i],
                            focal_length=tuple(test_ds.focal_lengths[i]),
                            principal_point=tuple(test_ds.principal_points[i]),
                            spp=8, background=(0, 0, 0, 0))
        img = test_ds.images[i].astype(np.float32)
        if not test_ds.is_hdr:
            gt = premultiplied_srgb(img / 255.0)
        else:
            gt = linear_to_srgb(torch.from_numpy(np.ascontiguousarray(img[..., :3]))).numpy()
        pred = torch.clamp(frame[..., :3], 0, 1).cpu().numpy()
        mse = float(np.mean((pred - gt) ** 2))
        psnrs.append(mse_to_psnr(mse))
        ssims.append(ssim(gt, pred))
        flips.append(flip(gt, pred))
        print(f"  view {i}: psnr={psnrs[-1]:.2f} ssim={ssims[-1]:.3f} flip={flips[-1]:.4f}",
              flush=True)
    return psnrs, ssims, flips


def main(argv=None) -> None:
    args = parse_args(argv)
    testbed = ngp.Testbed(device=args.device)
    testbed.seed = args.seed
    testbed.training_batch_size = args.batch_size

    if args.network:
        testbed.reload_network_from_file(args.network)
    if args.scene:
        testbed.load_training_data(args.scene)
    if args.load_snapshot:
        testbed.load_snapshot(args.load_snapshot)

    if args.nerf_compatibility and testbed.mode == ngp.TestbedMode.NERF:
        # run.py:164-189: sRGB blending is the LDR default already; no cone
        # stepping and no random background
        print("NeRF compatibility mode enabled")
        task = testbed.task
        task.cone_angle = 0.0
        task.march_cfg = dataclasses.replace(task.march_cfg, cone_angle=0.0)
        task.random_bg_color = False
        task.train_mode = "nerf"

    n_steps = args.n_steps if args.n_steps >= 0 else 35000
    if n_steps > 0:
        print(f"training {n_steps} steps...")
        t0 = time.time()
        last_print = 0
        mode = None
        while testbed.training_step < n_steps:
            scheduled = scheduled_train_mode(args, testbed.training_step)
            if scheduled is not None:
                testbed.task.train_mode = scheduled
                if scheduled != mode:
                    print(f"train_mode={scheduled} from step {testbed.training_step}", flush=True)
                    mode = scheduled
            testbed.frame()
            if not testbed.shall_train:
                print(f"training stopped at step {testbed.training_step}: a step marched no "
                      "sample", flush=True)
                break
            if testbed.training_step - last_print >= 100:
                last_print = testbed.training_step
                el = time.time() - t0
                print(f"iteration={testbed.training_step} loss={testbed.loss:.6f} "
                      f"({testbed.training_step / el:.1f} steps/s)", flush=True)
        print(f"trained in {time.time() - t0:.1f}s final loss={testbed.loss:.6f}")

    if args.save_snapshot:
        testbed.save_snapshot(args.save_snapshot)
        print(f"saved snapshot {args.save_snapshot}")

    if args.save_mesh:
        save_mesh(testbed, args.save_mesh, args.marching_cubes_res, args.optimize_mesh_steps)

    if args.test_transforms:
        print(f"evaluating {args.test_transforms}")
        psnrs, ssims, flips = evaluate(testbed.task, args.test_transforms)
        print(f"PSNR={np.mean(psnrs):.2f} [min={np.min(psnrs):.2f} max={np.max(psnrs):.2f}] "
              f"SSIM={np.mean(ssims):.3f} FLIP={np.mean(flips):.4f}")

    if args.video_camera_path:
        path = CameraPath.load(args.video_camera_path)
        n_frames = max(int(args.video_n_seconds * args.video_fps), 1)
        w = args.width or 1920
        h = args.height or 1080
        os.makedirs(args.video_output, exist_ok=True)
        frames = render_video_frames(testbed.task, path, n_frames, w, h, spp=args.video_spp)
        for i, frame in enumerate(frames):
            save_image(Path(args.video_output) / f"{i:05d}.png", frame[..., :3])
        print(f"wrote {len(frames)} video frames to {args.video_output}/ "
              f"(encode with: ffmpeg -framerate {args.video_fps} -i %05d.png out.mp4)")

    if args.screenshot_transforms:
        os.makedirs(args.screenshot_dir or ".", exist_ok=True)
        shot_ds = load_nerf(args.screenshot_transforms)
        frames = ([int(f) for f in args.screenshot_frames] if args.screenshot_frames
                  else range(shot_ds.n_images))
        for i in frames:
            w = args.width or shot_ds.resolution[0]
            h = args.height or shot_ds.resolution[1]
            frame = testbed.task.render(
                w, h, shot_ds.xforms_start[i],
                focal_length=tuple(shot_ds.focal_lengths[i] * np.array([w, h])
                                   / shot_ds.resolution),
                principal_point=tuple(shot_ds.principal_points[i]))
            out = Path(args.screenshot_dir or ".") / f"{i:04d}.png"
            save_image(out, frame[..., :3].cpu().numpy())
            print(f"wrote {out}")


if __name__ == "__main__":
    main()
