"""Repeat ``chip_smoke.py``'s NeRF training run and report every run whose
loss or parameters stop being finite, with the stage of the step that
first made a value that is not.

    python -m instant_ngp_torch.bench.nerf_repeat [--runs N] [--steps S] [--root DIR]
    python -m instant_ngp_torch.bench.nerf_repeat --ab OLD_DIR [--order old,new,new,old] [--runs N]
    python -m instant_ngp_torch.bench.nerf_repeat --replay FILE [FILE ...] [--root DIR]

Loads the fox snapshot, renders its 50 views as the training set (as
``chip_smoke.py`` does), then trains ``chip_smoke.py``'s configuration from
seed 0 N times through ``Testbed.frame()``. The kernels' atomics sum in a
different order each run, so runs from the same seed differ in their last
bits. Before each step it keeps the training state (``StepState``: the
parameters, the optimizer state, the occupancy grid, the error map and its
CDFs, the schedule's counters and the generator's state); after it, it
checks the step's loss and every parameter. At the first step where one is
not finite it replays the step from the state before it stage by stage,
kernels against the plain versions (march → encode → MLP → G → F of each
MLP → E → the optimizer, ``replay_step``), prints the first stage whose
output is not finite, saves that state with the step's draws under this
checkout's ``build/nerf_repeat/`` as ``<tree>_run<i>_step<s>.pt``
(``torch.save``; tree "new" for this checkout, "old" for another
``--root``), and ends that run. A run that reaches its end then trains
``chip_smoke.PROFILED_STEPS`` more frames under torch.profiler
(``chip_smoke.profile_frames``). One JSON line per run, with the median
host ms of its frames (``Testbed.frame()`` alone, as ``chip_smoke.py``'s
train phase times it, but with the keep's device copies queued just
before each) and the profiled frames' wall, device busy and idle share,
then a summary line; before the runs, one line with the wall ms of
``chip_smoke.RES``² renders of the snapshot's view 0 (``render_ms``).
``--replay`` restores each saved state into a fresh
task of the configuration and replays its step. Without a card it raises.

``--root DIR`` (default: this checkout) imports ``instant_ngp_torch`` from
DIR, which builds its kernels into DIR/build; the configuration, snapshot
and training set are this checkout's ``chip_smoke.py``'s. ``--ab OLD_DIR``
runs this script with ``--root`` OLD_DIR, this checkout, this checkout,
OLD_DIR, each in its own process on the same card, prints their lines and
then, per tree, the medians of its runs' step medians, idle shares and
processes' render medians.
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


class StepState:
    """A task's training state: ``keep`` copies it into buffers made at the
    first call (the parameters, the optimizer state, the occupancy grid,
    the error map and its CDFs), beside the host's counters and the
    generator's state; ``restore`` goes back to it; ``save`` and ``load``
    write it, with a step's draws, to a file and read it back."""

    HOST = ("training_step", "n_rays_current", "cdf_valid", "err_interval", "err_steps_since",
            "exact_corners_after", "last_stats")

    def __init__(self):
        self.buffers: dict[str, list[torch.Tensor]] | None = None

    @staticmethod
    def _live(task) -> dict[str, list[torch.Tensor]]:
        grid, opt = task.state.grid, task.state.opt_state
        return {"params": list(task.model.param_list()),
                **{f"opt.{k}": v for k, v in opt.items() if isinstance(v, list)},
                "grid": [grid.density, grid.mean_density, grid.skipmip],
                "error_map": [task.state.error_map],
                "cdf": [task.cdf_x, task.cdf_y, task.cdf_img, task.pmf_img]}

    def keep(self, task) -> None:
        with torch.no_grad():
            live = self._live(task)
            if self.buffers is None:
                self.buffers = {k: [t.detach().clone() for t in v] for k, v in live.items()}
            else:
                for k, v in live.items():
                    for dst, src in zip(self.buffers[k], v):
                        dst.copy_(src)
        grid = task.state.grid
        self.host = {k: getattr(task, k) for k in self.HOST}
        self.host.update(opt_step=task.state.opt_state["step"], ema_step=grid.ema_step,
                         fresh=grid.fresh, corners=task.model.pos_encoding.hashed_grad_corners)
        self.generator = task.generator.get_state()

    def restore(self, task) -> None:
        with torch.no_grad():
            for k, v in self._live(task).items():
                for dst, src in zip(v, self.buffers[k]):
                    dst.copy_(src)
        host = dict(self.host)
        task.state.opt_state["step"] = host.pop("opt_step")
        grid = task.state.grid
        grid.ema_step, grid.fresh = host.pop("ema_step"), host.pop("fresh")
        task.model.pos_encoding.hashed_grad_corners = host.pop("corners")
        for k, v in host.items():
            setattr(task, k, v)
        task.generator.set_state(self.generator)

    def save(self, path: Path, draws) -> None:
        path.parent.mkdir(parents=True, exist_ok=True)
        torch.save({"buffers": self.buffers, "host": self.host, "generator": self.generator,
                    "draws": None if draws is None else vars(draws)}, path)

    @classmethod
    def load(cls, path: Path) -> "StepState":
        saved = torch.load(path, map_location="cpu", weights_only=False)
        kept = cls()
        kept.buffers, kept.host, kept.generator = (saved["buffers"], saved["host"],
                                                   saved["generator"])
        return kept


def _given(outs) -> list:
    return [t for t in outs if t is not None]


def _finite(*tensors) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in _given(tensors))


def _largest_finite(*tensors) -> float:
    return max((float(t.float().abs().nan_to_num(0.0, 0.0, 0.0).max()) for t in _given(tensors)
                if t.numel()), default=0.0)


def _grad_spies(model) -> tuple[dict, list]:
    """Forward hooks on the model's two MLPs that keep the gradient of each
    one's input as the backward makes it: d rgb-MLP input and d density-MLP
    input (the encoded features). Returns (that dict, the hooks' handles)."""
    seen = {}

    def spy(name):
        def hook(module, inputs, output):
            if inputs[0].requires_grad:
                inputs[0].register_hook(lambda g: seen.__setitem__(name, g))
        return hook

    return seen, [model.rgb_network.register_forward_hook(spy("rgb")),
                  model.density_network.register_forward_hook(spy("density"))]


def replay_step(task, kept: StepState) -> tuple[str | None, object, list]:
    """The step after ``kept`` again, from it, once through the kernels and
    once through the plain versions, stage by stage: what is due before it
    and its draws (``nerf/train.begin_step``), the march (C), the sample
    encoding (A), the MLPs (B), the composite (G: the per-ray loss and d/d
    out; the valid samples' smallest rgb and largest density logit beside
    it), the backward of the rgb MLP (F: d/d its input and its weights),
    of the density MLP (F: d/d the features and its weights) and of the
    encoding (E: the tables), and the optimizer. Returns (the first stage
    whose output is not finite through the kernels, or None; the draws;
    one line a stage: finite through the kernels and through the plain
    versions, their largest difference and the kernels' largest finite
    magnitude)."""
    from instant_ngp_torch.nerf import train as nerf_train

    model = task.model
    n_density, n_rgb = len(model.density_network.weights), len(model.rgb_network.weights)
    lines, first, draws = [], None, None
    outs = {}
    for use_kernels in (True, False):
        kept.restore(task)
        task.set_use_kernels(use_kernels)
        draws = nerf_train.begin_step(task)
        stage = {"grid": (task.state.grid.density,)}
        batch = nerf_train.march_batch(task, draws)
        stage["march"] = (batch.ts, batch.dts)
        with torch.no_grad():
            pos, dirs, _ = nerf_train.sample_inputs(task, batch)
            stage["encode"] = (model.pos_encoding(pos),)
            stage["mlp"] = (model(pos, dirs),)
            out, valid = nerf_train.eval_samples(task, batch, max_level=draws.max_level)
            target, bg, ok = nerf_train.targets(task, draws, batch.uv)
            R = batch.ts.shape[0]
            composite = (nerf_train.composite_train if use_kernels
                         else nerf_train.composite_train_plain)
            stage["composite"] = composite(
                out.contiguous(), batch.ts, batch.dts, valid.contiguous(), target.contiguous(),
                bg.contiguous(), ok.contiguous(), task.state.grid.mean_density,
                task.training_near_distance,
                task.density_reg_scale * nerf_train.INV_LOSS_SCALE,
                1.0 / R, task.loss_type, task.rgb_activation, task.density_activation,
                task.train_mode)
            stage["logits"] = (out[valid][:, :3].amin(), out[valid][:, 3].amax())
        seen, hooks = _grad_spies(model)
        try:
            grads, _, _ = nerf_train.step_gradients(task, draws, batch)
        finally:
            for h in hooks:
                h.remove()
        stage["backward_rgb_mlp"] = (seen.get("rgb"), *grads[n_density:n_density + n_rgb])
        stage["backward_density_mlp"] = (seen.get("density"), *grads[:n_density])
        stage["backward_encode"] = tuple(grads[n_density + n_rgb:])
        params = [p.detach().clone() for p in model.param_list()]
        state = {k: ([t.clone() for t in v] if isinstance(v, list) else v)
                 for k, v in task.state.opt_state.items()}
        task.opt.update(grads, state, params)
        stage["optimizer"] = tuple(params)
        outs[use_kernels] = stage
    task.set_use_kernels(True)
    kept.restore(task)
    for name, kernel_out in outs[True].items():
        plain_out = outs[False][name]
        ok_k, ok_p = _finite(*kernel_out), _finite(*plain_out)
        diff = max((float((a.float() - b.float()).abs().nan_to_num(float("inf")).max())
                    for a, b in zip(_given(kernel_out), _given(plain_out))
                    if a.shape == b.shape and a.numel()), default=0.0)
        extra = ""
        if name == "logits":  # the valid samples' smallest rgb logit and largest density logit
            extra = f" (kernels: rgb min {float(kernel_out[0]):.4g}, density max " \
                    f"{float(kernel_out[1]):.4g})"
        lines.append(f"{name}: kernels finite {ok_k}, plain finite {ok_p}, max |k - p| "
                     f"{diff:.3e}, largest finite |k| {_largest_finite(*kernel_out):.3e}{extra}")
        if first is None and not ok_k:
            first = name
    return first, draws, lines


def _trainer(cs, ds, device):
    """A Testbed with a fresh NerfTask on ``ds`` in ``chip_smoke.py``'s
    training configuration, from its seed."""
    from instant_ngp_torch.nerf.task import NerfTask
    from instant_ngp_torch.testbed import Testbed

    trainer = Testbed("nerf", device=device)
    trainer.nerf_dataset, trainer.network_config = ds, cs.fox_train_config()
    trainer.task = NerfTask(ds, trainer.network_config, device, seed=cs.SEED,
                            target_batch_size=cs.TARGET_BATCH, n_rays_per_batch=cs.TRAIN_RAYS,
                            max_samples_per_ray=cs.TRAIN_K, n_march_iters=cs.TRAIN_ITERS)
    return trainer


def _setup(root: Path):
    """Import ``instant_ngp_torch`` from ``root`` and render the training
    set on the card → (this checkout's ``chip_smoke`` module, the dataset,
    the device, the tree's tag: "new" for this checkout, else "old")."""
    sys.path.insert(0, str(root))
    import instant_ngp_torch
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
    return cs, cs.render_training_set(tb), device, "new" if root == ROOT else "old", tb


def render_ms(cs, tb, frames: int = 5) -> list[float]:
    """Wall ms of each of ``frames`` renders of the snapshot's view 0 at
    ``chip_smoke.RES``² (the frame ``chip_smoke.py``'s render phase times),
    after one warm frame."""
    xf, kw = cs.view0(tb, cs.RES)
    tb.task.render(cs.RES, cs.RES, xf, **kw)
    out = []
    for _ in range(frames):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tb.task.render(cs.RES, cs.RES, xf, **kw)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def run(n_runs: int, steps: int, root: Path = ROOT) -> list[dict]:
    cs, ds, device, tree, tb = _setup(root)
    frames = render_ms(cs, tb)
    print(json.dumps({"render_ms_median": statistics.median(frames), "render_ms": frames}),
          flush=True)
    results = []
    for i in range(n_runs):
        trainer = _trainer(cs, ds, device)
        params = dict(trainer.task.model.named_parameters())
        t0 = time.perf_counter()
        result = {"run": i, "steps": 0, "first_bad_step": None, "bad_leaves": []}
        frame_ms = []
        kept = StepState()
        for step in range(steps):
            if trainer.task.state.opt_state is not None:
                kept.keep(trainer.task)
            t1 = time.perf_counter()
            trainer.frame()
            frame_ms.append((time.perf_counter() - t1) * 1e3)
            result["steps"] = step + 1
            bad = [name for name, p in params.items() if not bool(torch.isfinite(p).all())]
            if trainer.task.training_aborted or bad or not math.isfinite(trainer.loss_graph[-1]):
                result.update(first_bad_step=step, bad_leaves=bad,
                              loss=trainer.loss_graph[-1], aborted=trainer.task.training_aborted)
                if kept.buffers is not None and not trainer.task.training_aborted:
                    stage, draws, lines = replay_step(trainer.task, kept)
                    # under this checkout whichever tree ran
                    path = ROOT / "build" / "nerf_repeat" / f"{tree}_run{i}_step{step}.pt"
                    kept.save(path, draws)
                    print("\n".join(f"run {i} step {step} replay {ln}" for ln in lines),
                          flush=True)
                    result.update(first_bad_stage=stage, saved=str(path))
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


def replay_files(paths: list[Path], root: Path = ROOT) -> list[dict]:
    """Each saved state of ``paths`` restored into a fresh task of the
    training configuration (after one frame, which makes the optimizer's
    state) and its step replayed (``replay_step``): its lines, then one
    JSON line a file."""
    cs, ds, device, tree, _ = _setup(root)
    trainer = _trainer(cs, ds, device)
    trainer.frame()
    results = []
    for path in paths:
        stage, _, lines = replay_step(trainer.task, StepState.load(path))
        print("\n".join(f"{tree} tree, {path.name}: {ln}" for ln in lines), flush=True)
        results.append({"replay": path.name, "tree": tree, "first_bad_stage": stage})
        print(json.dumps(results[-1]), flush=True)
    return results


def ab(old: Path, order: list[str], n_runs: int, steps: int) -> None:
    """OLD_DIR and this checkout in ``order``: see the docstring."""
    by_tree, renders = {"old": [], "new": []}, {"old": [], "new": []}
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
        renders[tag] += [ln["render_ms_median"] for ln in lines if "render_ms_median" in ln]
    for tag, runs in by_tree.items():
        idle = [r["idle_share"] for r in runs if r.get("idle_share") is not None]
        print(json.dumps({"tree": tag, "runs": len(runs),
                          "step_ms_median_of_runs": statistics.median(
                              r["step_ms_median"] for r in runs),
                          "idle_share_median_of_runs": statistics.median(idle) if idle else None,
                          "render_ms_median_of_processes": statistics.median(renders[tag]),
                          "device": torch.cuda.get_device_name(0)}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--root", type=Path, default=ROOT)
    ap.add_argument("--ab", type=Path, default=None, metavar="OLD_DIR")
    ap.add_argument("--order", default="old,new,new,old")
    ap.add_argument("--replay", type=Path, nargs="+", default=None, metavar="FILE")
    args = ap.parse_args()
    if args.ab is not None:
        ab(args.ab.resolve(), args.order.split(","), args.runs, args.steps)
        return
    if args.replay is not None:
        replay_files(args.replay, args.root.resolve())
        return
    results = run(args.runs, args.steps, args.root.resolve())
    bad = [r["run"] for r in results if r["first_bad_step"] is not None]
    print(json.dumps({"runs": len(results), "not_finite": len(bad), "bad_runs": bad,
                      "device": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
