"""Train the SDF of ``chip_smoke.py``'s procedural mesh with one package, for
several seeds, and print its IoU before and after training.

    JAX_PLATFORMS=cpu python tests/compare_sdf_training.py --package jax --seeds 1337 1 2
    python tests/compare_sdf_training.py --package port --device cuda --seeds 1337 1 2
    python tests/compare_sdf_training.py --package port --device cuda --frames --seeds 1 2
    JAX_PLATFORMS=cpu python tests/compare_sdf_training.py --package both --seeds 1 --every 25

The mesh is ``geometry/procedural.bumpy_torus`` at ``chip_smoke.SDF_GRID``
(69,632 triangles) from ``chip_smoke.SEED``. For each seed (the task's
``seed``: the network's initialization and the batches' generator) the
package builds its ``SdfTask`` with ``configs/sdf/base.json`` and takes
``--steps`` steps (300), each on a fresh batch from
``generate_training_batch`` (the batches are the same in both packages for
one seed). ``--jax-init`` starts the port from the JAX package's initial
parameters for the seed (the packages draw them from different generators),
so that both train the same model on the same batches. With ``--frames``
the port trains as a user does instead: ``Testbed("sdf")`` on the mesh
written as ``.obj`` and ``frame()``, each step waiting for the producer
thread's next batch; the line then counts the fresh steps. The IoU is
``calculate_iou`` at ``chip_smoke.SDF_IOU_SAMPLES`` points (seed 4242) before
and after. After training, the field's input gradient (the render's analytic
normal) is taken at 2^14 points on the mesh, area-weighted from their own
seed: the line gives the share whose |gradient| is at most
``chip_smoke.NORMAL_FLOOR`` and the median |gradient| and |field| there. Prints one
JSON line a seed. The JAX package takes about 10 minutes a seed on 8 CPU
cores.

``--package both`` trains, on the CPU and on the same batches, three runs in
lockstep: the JAX package from its initial parameters, the port from the
same parameters, and the JAX package again from those parameters each moved
by one f32 ulp in a random direction (the control: how fast a difference
at the level of f32 rounding grows under this training). Every ``--every``
steps it prints a line with each run's flat share and median |gradient|,
and the relative L2 distance of the port's and the control's parameters
(MLP and table apart) from the first run's.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import NORMAL_FLOOR, SDF_GRID, SDF_IOU_SAMPLES, SEED  # noqa: E402

SURFACE_POINTS, SURFACE_SEED = 1 << 14, 4243


def mesh_triangles() -> np.ndarray:
    from instant_ngp_torch.geometry.procedural import bumpy_torus

    v, f = bumpy_torus(*SDF_GRID, seed=SEED)
    return v[f]


def surface_points(task) -> np.ndarray:
    """SURFACE_POINTS points on the task's normalized mesh, area-weighted,
    from SURFACE_SEED (the same in both packages)."""
    rng = np.random.default_rng(SURFACE_SEED)
    ti = np.minimum(np.searchsorted(task.tri_cdf, rng.random(SURFACE_POINTS)),
                    len(task.triangles) - 1)
    b = rng.random((SURFACE_POINTS, 2))
    b[b.sum(1) > 1] = 1 - b[b.sum(1) > 1]
    t = task.triangles[ti]
    return (t[:, 0] + (t[:, 1] - t[:, 0]) * b[:, :1] + (t[:, 2] - t[:, 0]) * b[:, 1:]).astype(
        np.float32)


def flat_share(grad: np.ndarray, field: np.ndarray) -> dict:
    """The share of surface points whose |gradient| ≤ NORMAL_FLOOR, and the
    median |gradient| and |field| over all of them."""
    norm = np.linalg.norm(grad, axis=-1)
    return {"flat_share": float(np.mean(norm <= NORMAL_FLOOR)),
            "median_grad": float(np.median(norm)),
            "median_abs_field": float(np.median(np.abs(field)))}


def run_jax(tris, config, seed: int, steps: int) -> dict:
    import jax
    import jax.numpy as jnp

    from instant_ngp_tpu.sdf.task import SdfTask

    task = SdfTask(tris, config, seed=seed)
    iou0 = task.calculate_iou(SDF_IOU_SAMPLES)
    losses = []
    for _ in range(steps):
        pts, d = task.generate_training_batch()
        task.params, task.opt_state, loss = task._jit_step(task.params, task.opt_state,
                                                           jnp.asarray(pts), jnp.asarray(d))
        losses.append(float(loss))
    pts = surface_points(task)
    grad_fn = jax.jit(jax.vmap(jax.grad(
        lambda p, xi: task.model(p, xi[None]).astype(jnp.float32)[0, 0], argnums=1),
        in_axes=(None, 0)))
    grad = np.asarray(grad_fn(task.inference_params, jnp.asarray(pts)))
    return {"iou_before": iou0, "iou_after": task.calculate_iou(SDF_IOU_SAMPLES),
            **flat_share(grad, task.sdf(pts)), "losses": losses}


def port_flat_share(task) -> dict:
    import torch

    pts = surface_points(task)
    x = torch.from_numpy(pts).to(task.device)
    return flat_share(task._gradient(task.inference_params(), x).cpu().numpy(),
                      task.sdf(x).cpu().numpy())


def run_port(tris, config, seed: int, steps: int, device: str, jax_init: bool) -> dict:
    import torch

    from instant_ngp_torch.sdf.task import SdfTask

    task = SdfTask(tris, config, device=device, seed=seed)
    if jax_init:
        import jax

        from instant_ngp_tpu.sdf.task import SdfTask as JaxSdfTask
        from instant_ngp_torch.models.network import params_from_jax

        params_from_jax(task.model, jax.tree.map(np.asarray, JaxSdfTask(tris, config,
                                                                        seed=seed).params))
    iou0 = task.calculate_iou(SDF_IOU_SAMPLES)
    losses = []
    for _ in range(steps):
        batch = task.to_device(task.generate_training_batch())
        losses.append(float(task.train_step(*batch)))
        task.training_step += 1
    if device != "cpu":
        torch.cuda.synchronize()
    return {"iou_before": iou0, "iou_after": task.calculate_iou(SDF_IOU_SAMPLES),
            **port_flat_share(task), "losses": losses}


def _leaves(tree) -> dict:
    return {"net": [np.asarray(w, np.float32) for w in tree["net"]],
            "enc": [np.asarray(t, np.float32) for t in tree["enc"]]}


def rel_distance(a: dict, b: dict) -> dict:
    """||a - b|| / ||b|| over the MLP's matrices and over the table."""
    return {k: float(np.sqrt(sum(np.sum((x - y).astype(np.float64) ** 2)
                                 for x, y in zip(a[k], b[k])))
                     / np.sqrt(sum(np.sum(y.astype(np.float64) ** 2) for y in b[k])))
            for k in ("net", "enc")}


def run_lockstep(tris, config, seed: int, steps: int, every: int) -> None:
    import jax
    import jax.numpy as jnp
    import torch

    from instant_ngp_tpu.sdf.task import SdfTask as JaxSdfTask
    from instant_ngp_torch.models.network import params_from_jax, params_to_numpy
    from instant_ngp_torch.sdf.task import SdfTask

    ref = JaxSdfTask(tris, config, seed=seed)
    ctl = JaxSdfTask(tris, config, seed=seed)
    rng = np.random.default_rng(seed + 1)
    ctl.params = jax.tree.map(
        lambda p: jnp.asarray(np.nextafter(np.asarray(p, np.float32), np.where(
            rng.random(np.shape(p)) < 0.5, -np.inf, np.inf).astype(np.float32))), ref.params)
    port = SdfTask(tris, config, device="cpu", seed=seed)
    params_from_jax(port.model, jax.tree.map(np.asarray, ref.params))
    pts0 = surface_points(ref)
    grad_fn = jax.jit(jax.vmap(jax.grad(
        lambda p, xi: ref.model(p, xi[None]).astype(jnp.float32)[0, 0], argnums=1),
        in_axes=(None, 0)))

    def jax_flat(task):
        g = np.asarray(grad_fn(task.inference_params, jnp.asarray(pts0)))
        return flat_share(g, task.sdf(pts0))

    t0 = time.perf_counter()
    for step in range(steps + 1):
        if step % every == 0:
            r = _leaves(jax.tree.map(np.asarray, ref.params))
            line = {"seed": seed, "step": step, "jax": jax_flat(ref),
                    "port": port_flat_share(port), "control": jax_flat(ctl),
                    "port_distance": rel_distance(_leaves(params_to_numpy(port.model)), r),
                    "control_distance": rel_distance(
                        _leaves(jax.tree.map(np.asarray, ctl.params)), r),
                    "seconds": time.perf_counter() - t0}
            print(json.dumps(line), flush=True)
        if step == steps:
            break
        pts, d = ref.generate_training_batch()
        jp, jd = jnp.asarray(pts), jnp.asarray(d)
        ref.params, ref.opt_state, _ = ref._jit_step(ref.params, ref.opt_state, jp, jd)
        ctl.params, ctl.opt_state, _ = ctl._jit_step(ctl.params, ctl.opt_state, jp, jd)
        port.train_step(torch.from_numpy(pts), torch.from_numpy(d))
        port.training_step += 1
    port.stop_producer()


def run_port_frames(tris, config, seed: int, steps: int, device: str) -> dict:
    import tempfile

    import torch

    from instant_ngp_torch.geometry.procedural import write_obj
    from instant_ngp_torch.testbed import Testbed

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "mesh.obj"
        verts = tris.reshape(-1, 3)
        write_obj(path, verts, np.arange(len(verts)).reshape(-1, 3))
        tb = Testbed("sdf", device=device)
        tb.seed = seed
        tb.reload_network_from_json(config)
        tb.load_training_data(path)
    try:
        iou0 = tb.calculate_iou(SDF_IOU_SAMPLES)
        for _ in range(steps):
            tb.frame()
        if device != "cpu":
            torch.cuda.synchronize()
        return {"iou_before": iou0, "iou_after": tb.calculate_iou(SDF_IOU_SAMPLES),
                "fresh_steps": tb.task.fresh_batches, **port_flat_share(tb.task),
                "losses": tb.loss_graph}
    finally:
        tb.task.stop_producer()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("jax", "port", "both"), required=True)
    ap.add_argument("--device", default="cpu", help="the port's device")
    ap.add_argument("--seeds", type=int, nargs="+", default=[1337, 1, 2])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--every", type=int, default=25,
                    help="with --package both: steps between two lines")
    ap.add_argument("--jax-init", action="store_true",
                    help="the port from the JAX package's initial parameters for the seed")
    ap.add_argument("--frames", action="store_true",
                    help="the port through Testbed.frame() and its batch producer")
    args = ap.parse_args()
    from instant_ngp_torch.config import default_config

    config = default_config("sdf")
    tris = mesh_triangles()
    for seed in args.seeds:
        t0 = time.perf_counter()
        if args.package == "both":
            run_lockstep(tris, config, seed, args.steps, args.every)
            continue
        if args.package == "jax":
            r = run_jax(tris, config, seed, args.steps)
        elif args.frames:
            r = run_port_frames(tris, config, seed, args.steps, args.device)
        else:
            r = run_port(tris, config, seed, args.steps, args.device, args.jax_init)
        losses = r.pop("losses")
        print(json.dumps({"package": args.package, "seed": seed, "steps": args.steps,
                          "frames": args.frames, "jax_init": args.jax_init, **r,
                          "loss_first": losses[0],
                          "loss_last": losses[-1], "seconds": time.perf_counter() - t0}),
              flush=True)


if __name__ == "__main__":
    main()
