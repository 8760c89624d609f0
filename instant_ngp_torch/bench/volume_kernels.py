"""Kernels L (the delta-tracked training batch) and M (the ground-truth
Woodcock trace) of one source tree, at the volume path's shapes, as device
time; and an old/new comparison of two trees.

    python instant_ngp_torch/bench/volume_kernels.py [--root DIR]
    python instant_ngp_torch/bench/volume_kernels.py --ab OLD_DIR [--logs DIR]

``--root DIR`` (default: this checkout) imports ``instant_ngp_torch`` from
DIR, builds its kernels into DIR/build, and on ``procedural_fog_volume(128)``
with ``configs/volume/base.json`` holds each case bit for bit against its
plain version with this checkout's ``chip_smoke.py`` checks, and prints one
JSON line. The cases:

- L at the training step's shapes, 2^15 paths x 192 iterations, three ways:
  warm, on draws the generator has just made (as a training step calls it);
  cold, after a second draw buffer has been read, so none of the draws is in
  L2; back to back, calls on the same draws (``chip_smoke.py``'s checks);
- M on the 65,536 rays of a 256^2 frame and on two chunks of a 1920x1080
  frame: the whole one at its middle (65,536 rays; the top and bottom rows
  mostly miss the box) and its partial last one (41,984);
- L in training: ``VolumeTask.train`` steps profiled as ``chip_smoke.py``
  profiles its frames: L's ms a step, the launches the trace caught, and its
  ms an event;
- L at 2^15 - 3 paths and M at 65,531 rays: sizes that are neither multiples
  of 4 nor of a block (a partial last block, draw rows not 16-byte aligned).

Each case has its device time per call (torch.profiler, one kernel a call),
its census bound (the sectors of the draws, grid and bitgrid its plain
version's paths read, ``chip_smoke.census_bound``) and, for this checkout's
design, the bytes its kernel reads (``design_bytes``: the staged rows of
every stage a thread fills, the rows read at their use, and the rest as the
census counts it). ``--ab OLD_DIR`` runs OLD_DIR and this checkout in the
order old, new, new, old through ``bench/ab.py`` (without ``chip_smoke.py``
runs), writes the outputs under DIR (default build/volume_ab/) and prints one
JSON line per run. Without a card it raises.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import re
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]  # this checkout
SEED = 0
GRID_RES = 128
N_PATHS = 1 << 15
RAGGED = 3  # paths (and rays, + 2) short of a multiple of 4 and of a block
RENDER_RES = 256
FRAME_WH = (1920, 1080)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_constants(root: Path = HERE) -> dict[str, int]:
    """The ``constexpr int k... = N;`` constants of root's ``csrc/volume.cu``."""
    src = (root / "instant_ngp_torch" / "csrc" / "volume.cu").read_text()
    return {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}


def staged_iterations(live, n_iters: int, stage: int, depth: int):
    """(n,) the iterations whose staged rows each thread fills, from its
    path's live iterations (n,): it walks stage s while its path is live at
    the stage's start, and fills the stages up to ``depth`` past the last it
    walks; a thread whose path is never live (M's rays that miss the box)
    fills none."""
    import torch

    n_stages = -(-n_iters // stage)
    last = torch.clamp(-(-live // stage) - 1, min=0, max=max(n_stages - 1, 0))
    upto = torch.clamp((last + depth) * stage, max=n_iters)
    return torch.where(live > 0, upto, 0)


def design_bytes(census, shape, rows: int, stage: int, depth: int, *tensors) -> dict:
    """The bytes this checkout's kernel reads and writes: the rows each
    thread stages for every stage it fills, the draws' other sectors the
    census marks (the rows read at their use), the grid's and bitgrid's
    sectors as the census counts them, and the tensors read or written
    whole."""
    from instant_ngp_torch.volume.tracking import ReadCensus

    n_iters, per_iter, n = shape
    upto = staged_iterations(census.per_path("live"), n_iters, stage, depth)
    staged = int(upto.sum()) * rows * 4
    per = ReadCensus.SECTOR_BYTES // 4
    sector_row = (((census.touched["draws"].nonzero()[:, 0] * per) // n) % per_iter)
    at_use = int((sector_row >= rows).sum()) * ReadCensus.SECTOR_BYTES
    read = census.bytes_read()
    whole = sum(t.numel() * t.element_size() for t in tensors)
    total = staged + at_use + read.get("grid", 0) + read.get("bitgrid", 0) + whole
    return {"design_bytes": total, "staged_bytes": staged, "at_use_bytes": at_use}


def l_case(cs, task, draws, what: str, consts: dict | None, gen=None) -> dict:
    """L bit for bit, its device time back to back on the same draws and,
    with ``gen``, warm from a fill and cold, and its census bound
    (``chip_smoke.check_generate_batch``)."""
    from instant_ngp_torch.volume import tracking

    print(f"L {what}", flush=True)
    v = cs.check_generate_batch(task, draws, gen)
    if consts is not None and "kStage" in consts:
        census = tracking.ReadCensus()
        out = tracking.generate_batch_plain(task, draws, census)
        v.update(design_bytes(census, tuple(draws.per_iter.shape), consts["kBatchStaged"],
                              consts["kStage"], consts["kBatchDepth"], draws.first, *out))
    return v


def l_training(cs, task, steps: int = 20) -> dict:
    """L's device time in training: ``task.train(1)`` steps (each makes its
    draws and runs L, A, B, F, E and Adam), then PROFILED_STEPS more under
    ``chip_smoke.profile_frames``: L's ms a step (the trace's L events over
    the steps), how many of its launches the trace caught, and its ms an
    event."""
    import types

    task.train(steps)
    seen = {}
    trainer = types.SimpleNamespace(frame=lambda: task.train(1))
    _, _, _, kernels = cs.profile_frames(trainer, seen)
    events = seen["volume_generate_batch"]
    per_step = kernels["volume_generate_batch"]
    return {"device_ms_per_step": per_step, "events": events, "steps": cs.PROFILED_STEPS,
            "device_ms_per_event": per_step * cs.PROFILED_STEPS / max(events, 1)}


def m_case(cs, task, o, d, draws, what: str, consts: dict | None) -> dict:
    """M bit for bit, its device time (draws cold: 335 MB a chunk) and
    census bound (``chip_smoke.check_trace_gt``)."""
    from instant_ngp_torch.volume import tracking

    print(f"M {what}", flush=True)
    v = cs.check_trace_gt(task, o, d, draws)
    if consts is not None and "kStage" in consts:
        census = tracking.ReadCensus()
        out = tracking.trace_gt_plain(task, o, d, draws, census)
        v.update(design_bytes(census, tuple(draws.shape), consts["kGtStaged"], consts["kStage"],
                              consts["kGtDepth"], o, d, *out))
    return v


def run(root: Path) -> dict:
    sys.path.insert(0, str(root))
    import torch

    from instant_ngp_torch import cuda_lib
    from instant_ngp_torch.io.nanovdb import procedural_fog_volume
    from instant_ngp_torch.render.camera import pinhole_rays
    from instant_ngp_torch.volume import tracking
    from instant_ngp_torch.volume.task import GT_CHUNK, VolumeTask

    cs = _chip_smoke()
    name, card = cs.phase_device()  # raises without a card
    _, build_s = cuda_lib.build()
    consts = kernel_constants(root)
    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(SEED)
    config = json.loads((root / "configs" / "volume" / "base.json").read_text())
    task = VolumeTask(procedural_fog_volume(GRID_RES), config, device=device)
    cam = cs.volume_camera()
    out = {"root": str(root), "device": name, "card": card, "build_s": build_s,
           "design": {k: v for k, v in consts.items()
                      if k in ("kWindow", "kStage", "kBatchDepth", "kGtDepth", "kBatchStaged",
                               "kGtStaged")}}
    with torch.no_grad():
        draws = tracking.draw_batch(gen, N_PATHS)
        L = {"step": l_case(cs, task, draws, "step", consts, gen)}
        L["ragged"] = l_case(cs, task, tracking.draw_batch(gen, N_PATHS - RAGGED), "ragged",
                             consts)
        L["training"] = l_training(cs, task)
        print(f"L in training: {L['training']}", flush=True)
        del draws
        M = {}
        o, d = pinhole_rays(RENDER_RES, RENDER_RES, cam, 50.0, device)
        M["render_256"] = m_case(cs, task, o, d.to(torch.float32),
                                 tracking.draw_gt(gen, o.shape[0]), "256^2", consts)
        r = o.shape[0] - RAGGED - 2
        M["ragged"] = m_case(cs, task, o[:r].contiguous(), d[:r].to(torch.float32).contiguous(),
                             tracking.draw_gt(gen, r), "ragged", consts)
        o, d = pinhole_rays(*FRAME_WH, cam, 50.0, device)
        mid = o.shape[0] // 2 // GT_CHUNK * GT_CHUNK
        last = (o.shape[0] - 1) // GT_CHUNK * GT_CHUNK
        for name, s, e in (("frame_chunk", mid, mid + GT_CHUNK),
                           ("frame_last_chunk", last, o.shape[0])):
            M[name] = m_case(cs, task, o[s:e].contiguous(), d[s:e].to(torch.float32).contiguous(),
                             tracking.draw_gt(gen, e - s), name, consts)
    return {**out, "L": L, "M": M}


KEYS = ("device_ms", "device_ms_warm", "device_ms_cold", "bound_ms", "bytes", "design_bytes",
        "device_ms_per_step", "events", "device_ms_per_event")


def summarize(res: dict) -> dict:
    """One --ab line's entries: per case [device ms (back to back, warm,
    cold for L's step), bound ms, census bytes, design bytes, and for L in
    training its ms a step, the events caught, its ms an event]."""
    return {f"{k}:{case}": [v.get(key) for key in KEYS]
            for k in ("L", "M") for case, v in res[k].items()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--ab", type=Path, default=None, metavar="OLD_DIR")
    ap.add_argument("--logs", type=Path, default=HERE / "build" / "volume_ab", metavar="DIR")
    args = ap.parse_args()
    if args.ab is not None:
        sys.path.insert(0, str(HERE))
        from instant_ngp_torch.bench.ab import ab

        ab(args.ab.resolve(), HERE, args.logs.resolve(), Path(__file__).resolve(), summarize,
           smoke=False)
        return
    res = run(args.root.resolve())
    print(json.dumps(res, default=str))


if __name__ == "__main__":
    main()
