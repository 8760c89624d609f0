"""Old/new comparison of two source trees on one card, shared by the bench
scripts' ``--ab OLD_DIR``.

In the order old, new, new, old it runs each tree's ``chip_smoke.py`` (its
step and render times) and a bench script with ``--root`` set to that tree
(its JSON line, summarised by the caller), and prints one JSON line per run.
With ``repeat`` it then runs ``python -m instant_ngp_torch.bench.nerf_repeat
--runs repeat`` in each tree, again old, new, new, old, and prints the time of
every 300-step run and, per tree, their quartiles. Every output is written
under ``logs``.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
from pathlib import Path
from typing import Callable

STEP_LINES = {"nerf_ms_per_step": r"^train \d+ steps: median ([\d.]+) ms/step",
              "image_ms_per_step": r"^image \d+ steps: median ([\d.]+) ms/step",
              "nerf_profiled": r"^profiled \d+ steps: wall ([\d.]+) ms, device busy ([\d.]+) ms",
              "image_profiled": r"^image profiled \d+ steps: wall ([\d.]+) ms, device busy ([\d.]+) ms",
              "render_ms": r"^render \d+x\d+: ([\d.]+) ms"}


def _json_lines(stdout: str) -> list[dict]:
    return [json.loads(ln) for ln in stdout.splitlines() if ln.startswith("{")]


def ab(old: Path, new: Path, logs: Path, script: Path, summarize: Callable[[dict], dict],
       repeat: int = 0) -> None:
    order = (("old", old), ("new", new), ("new", new), ("old", old))
    logs.mkdir(parents=True, exist_ok=True)
    for i, (tag, root) in enumerate(order):
        smoke = subprocess.run([sys.executable, "chip_smoke.py"], cwd=root, capture_output=True,
                               text=True, timeout=1200)
        (logs / f"{i}_{tag}_chip_smoke.log").write_text(smoke.stdout + smoke.stderr)
        line = {"run": i, "tree": tag, "chip_smoke_rc": smoke.returncode}
        for key, pattern in STEP_LINES.items():
            m = re.search(pattern, smoke.stdout, re.M)
            line[key] = [float(v) for v in m.groups()] if m else None
        bench = subprocess.run([sys.executable, str(script), "--root", str(root)],
                               capture_output=True, text=True, timeout=900)
        (logs / f"{i}_{tag}_{script.stem}.log").write_text(bench.stdout + bench.stderr)
        lines = _json_lines(bench.stdout)
        if bench.returncode == 0 and lines:
            line.update(summarize(lines[-1]))
        else:
            line[f"{script.stem}_rc"] = bench.returncode
        print(json.dumps(line), flush=True)
    if not repeat:
        return
    seconds = {"old": [], "new": []}
    for i, (tag, root) in enumerate(order):
        rep = subprocess.run([sys.executable, "-m", "instant_ngp_torch.bench.nerf_repeat",
                              "--runs", str(repeat)], cwd=root, capture_output=True, text=True,
                             timeout=1800)
        (logs / f"{i}_{tag}_nerf_repeat.log").write_text(rep.stdout + rep.stderr)
        runs = [r for r in _json_lines(rep.stdout) if "run" in r]
        seconds[tag] += [r["seconds"] for r in runs]
        print(json.dumps({"nerf_repeat": i, "tree": tag, "rc": rep.returncode,
                          "seconds": [r["seconds"] for r in runs],
                          "not_finite": sum(r["first_bad_step"] is not None for r in runs)}),
              flush=True)
    for tag, s in seconds.items():
        q = statistics.quantiles(s, n=4) if len(s) > 1 else s * 3
        print(json.dumps({"nerf_repeat_tree": tag, "runs": len(s),
                          "seconds_q1_median_q3": q}), flush=True)
