"""The multi-process dry run of the data-parallel NeRF (the port's counterpart
of the JAX package's ``dryrun_multichip`` and ``dryrun_multihost``).

``dryrun_multichip(n)`` starts n processes (gloo on the CPU, or NCCL with
one card a rank) that join one ``torch.distributed`` group over TCP on
127.0.0.1, and each builds the same tiny NeRF (a 4-level grid, 16-wide MLPs,
two random 16² views) with the group as ``task.mesh``:

* ``task.train(2)``: a grid update and two sharded steps; the ray batch must
  divide over the ranks and the steps must have issued all-reduces;
* a ``dp_render`` frame of 16 rays a rank, the same through the bake, and a
  16² slab frame whose warp is pixel-sharded;

and rank 0 prints ``dryrun_multichip(n) OK: loss=…``. Several hosts run
the same code: start ``python -m instant_ngp_torch.parallel.dryrun --worker
--init tcp://<host of rank 0>:<port> --world N --rank R`` on each.

    python -m instant_ngp_torch.parallel.dryrun --n 2 --device cpu
    python -m instant_ngp_torch.parallel.dryrun --n 1 --device cuda
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[2]


def tiny_nerf_config() -> dict:
    """The dry run's network: a 4-level 2^12 grid, 16-wide MLPs of one
    hidden layer, SH-4 directions, Huber and Adam."""
    return {
        "loss": {"otype": "Huber"},
        "optimizer": {"otype": "Adam", "learning_rate": 1e-2, "beta1": 0.9, "beta2": 0.99,
                      "epsilon": 1e-15, "l2_reg": 1e-6},
        "encoding": {"otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2,
                     "log2_hashmap_size": 12, "base_resolution": 4},
        "network": {"otype": "FullyFusedMLP", "activation": "ReLU", "output_activation": "None",
                    "n_neurons": 16, "n_hidden_layers": 1},
        "dir_encoding": {"otype": "SphericalHarmonics", "degree": 4},
        "rgb_network": {"otype": "FullyFusedMLP", "activation": "ReLU",
                        "output_activation": "None", "n_neurons": 16, "n_hidden_layers": 1},
    }


def synthetic_dataset(n_images: int = 2, w: int = 16, h: int = 16):
    """n random w×h views from (0.5, 0.5, −0.7) looking along +z."""
    from ..io.nerf_loader import NerfDataset

    rng = np.random.default_rng(0)
    images = rng.integers(0, 255, (n_images, h, w, 4), dtype=np.uint8)
    xforms = np.zeros((n_images, 3, 4), np.float32)
    for i in range(n_images):
        xforms[i, :, :3] = np.eye(3)
        xforms[i, :, 3] = (0.5, 0.5, -0.7)
    return NerfDataset(images=images, is_hdr=False, xforms_start=xforms,
                       xforms_end=xforms.copy(),
                       focal_lengths=np.full((n_images, 2), 20.0, np.float32),
                       principal_points=np.full((n_images, 2), 0.5, np.float32),
                       rolling_shutter=np.zeros((n_images, 4), np.float32), resolution=(w, h),
                       aabb_scale=1)


def tiny_task(world: int, device):
    """The dry run's ``NerfTask``: 32 rays a rank, 4 samples a ray."""
    from ..nerf.task import NerfTask

    return NerfTask(synthetic_dataset(), tiny_nerf_config(), device,
                    n_rays_per_batch=world * 32, max_samples_per_ray=4, n_march_iters=8)


def run_worker(init_method: str, world: int, rank: int, device: str = "cuda") -> float:
    """One rank of the dry run (see the module's docstring), on card
    ``rank`` (NCCL), or on the CPU (gloo) where ``device`` is "cpu". Returns
    the loss of the last step."""
    from . import sharding

    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        dev = torch.device("cpu")
    dist.init_process_group("nccl" if device == "cuda" else "gloo", init_method=init_method,
                            world_size=world, rank=rank)
    try:
        group = dist.group.WORLD
        task = tiny_task(world, dev)
        task.mesh = group
        sharding.replicate(list(task.model.parameters()), group)
        before = sharding.COLLECTIVES["all_reduce"]
        loss = task.train(2)  # a grid update and two sharded steps
        n_ar = sharding.COLLECTIVES["all_reduce"] - before
        assert np.isfinite(loss), f"non-finite loss {loss}"
        n_rays = task.n_rays_current
        assert n_rays % world == 0, f"ray batch {n_rays} does not divide over {world} ranks"
        assert n_ar > 0, "the sharded steps issued no all-reduce"
        n_par = sum(p.numel() for p in task.model.param_list())
        say = print if rank == 0 else (lambda *a, **k: None)
        say(f"# scaling: rays/rank={n_rays // world}, grad all-reduce payload≈"
            f"{n_par * 4 / 1e6:.2f} MB/step, {n_ar} all-reduces in 2 steps", flush=True)

        o = torch.tensor([[0.5, 0.5, -0.7]], device=dev).repeat(world * 16, 1)
        d = torch.tensor([[0.0, 0.0, 1.0]], device=dev).repeat(world * 16, 1)
        rgb, alpha, depth = sharding.dp_render(lambda a, b: task._render_rays(a, b)[:3],
                                               group)(o, d)
        assert rgb.shape == (world * 16, 3) and bool(torch.isfinite(rgb).all())
        cache = task.bake(res0=64)
        rgb_b, _, _ = sharding.dp_render(
            lambda a, b: task._render_rays(a, b, baked_cache=cache)[:3], group)(o, d)
        assert bool(torch.isfinite(rgb_b).all())

        task.slab_res0, task.slab_res_outer = 32, 16
        ds = task.dataset
        frame = task.render(16, 16, ds.xforms_start[0], focal_length=(20.0, 20.0),
                            background=(0, 0, 0, 0), render_quality="slab")
        assert tuple(frame.shape) == (16, 16, 4) and bool(torch.isfinite(frame).all()), \
            "sharded slab render produced a bad frame"
        say(f"# sharded slab warp over {world} ranks: {tuple(frame.shape)} finite", flush=True)
        say(f"dryrun_multichip({world}) OK: loss={loss:.5f}", flush=True)
        return loss
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_multichip(n: int, device: str = "cuda", timeout: float = 600.0) -> str:
    """Run the dry run in n fresh processes on this host (ranks 0..n−1 over
    tcp://127.0.0.1), one card a rank over NCCL, or gloo on the CPU where
    ``device`` is "cpu"; raises if a rank fails or the host has fewer than n
    cards. Returns rank 0's output."""
    if device == "cuda" and torch.cuda.device_count() < n:
        raise RuntimeError(f"dryrun_multichip({n}) on cuda needs {n} cards, "
                           f"this host has {torch.cuda.device_count()}")
    init = f"tcp://127.0.0.1:{free_port()}"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), *filter(None, [os.environ.get("PYTHONPATH")])]))
    procs = [subprocess.Popen([sys.executable, "-m", "instant_ngp_torch.parallel.dryrun",
                               "--worker", "--init", init, "--world", str(n), "--rank", str(r),
                               "--device", device], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    rcs = [p.returncode for p in procs]
    if any(rcs):
        raise RuntimeError(f"dryrun_multichip({n}) ranks exited {rcs}:\n" + "\n".join(outs))
    print(outs[0], end="", flush=True)
    return outs[0]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="multi-process dry run of the data-parallel NeRF")
    p.add_argument("--n", type=int, default=2, help="processes to start on this host")
    p.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    p.add_argument("--worker", action="store_true", help="run one rank (--init, --world, --rank)")
    p.add_argument("--init", default="", help="tcp://host:port of rank 0")
    p.add_argument("--world", type=int, default=1)
    p.add_argument("--rank", type=int, default=0)
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu for the gloo dry run")
    if args.worker:
        torch.set_num_threads(1)
        run_worker(args.init, args.world, args.rank, args.device)
    else:
        dryrun_multichip(args.n, args.device)


if __name__ == "__main__":
    main()
