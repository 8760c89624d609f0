"""Design measurements of the wide B and F under the five generic activations
(``csrc/mlp_wide*_generic.cu``): variants of the kernels built from patched
copies of ``csrc/``, each timed on the card in a process of its own.

    python instant_ngp_torch/bench/act_variants.py [--logs DIR] [NAME ...]

The variants (default: all):

- ``kernel``: this checkout's sources as they are: each generic kernel takes
  the five, one instantiation a kind picked per layer, each inline at every
  value;
- ``sine_rolled``: as ``kernel``, but sine's hidden values taken one at a
  time through a per-thread array (local memory), so that ``sinf`` and
  ``cosf`` (which branch into their slow argument reduction at every value)
  appear once a layer width;
- ``units``: no timing, the build of the other design, a kernel of each of
  the five in a unit of its own: every source compiled at once as
  ``cuda_lib.build`` does, the three generic ones five times each with
  ``NGP_GENERIC_SWITCH`` cut to one activation (15 units), against every
  source as it is, in the same call.

A timed variant's copy is built by ``cuda_lib`` into DIR/<name>/, then: the
wide kernels' stack bytes and local stores (``cuobjdump``), and B and F at
``bench/bwd_kernels.act_cases`` of the five (device ms of the kernel,
torch.profiler, and the digest of its outputs; ``digests_equal_first``:
whether they equal the first variant's, as they must, since the variants
compute the same values). One JSON line a variant, all of them written to
DIR/variants.json. Without a card it raises.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]  # this checkout
CSRC = HERE / "instant_ngp_torch" / "csrc"
ACTS = ("tanh", "leakyrelu", "squareplus", "softplus", "sine")
GENERIC_SOURCES = ("mlp_wide_generic.cu", "mlp_wide_bwd_generic.cu", "mlp_wide_bwd256_generic.cu")
CODES = {"leakyrelu": "kLeakyRelu", "sine": "kSine", "squareplus": "kSquareplus",
         "softplus": "kSoftplus", "tanh": "kTanh"}

# sine's hidden values one at a time, at the head of hidden_generic
SINE_ROLLED = """
    if constexpr (kAct == kSine) {
        float h[N / 2];
#pragma unroll
        for (int v = 0; v < N / 2; ++v) h[v] = acc[v];
#pragma unroll 1
        for (int v = 0; v < N / 2; ++v) {
            if (kBwd) s[(size_t)v * c.stride] = act_grad(h[v], kAct);
            h[v] = activate(h[v], kAct);
        }
#pragma unroll
        for (int kb = 0; kb < N / 16; ++kb) {
            if (kb * 16 < kn) {
#pragma unroll
                for (int e = 0; e < 4; ++e) a[kb][e] = pack_bf16(h[8 * kb + 2 * e], h[8 * kb + 2 * e + 1]);
            }
        }
        return;
    }
"""


def patched_csrc(dest: Path, variant: str, act: str | None = None) -> Path:
    """A copy of csrc/ at dest with the variant's patch (and, for a unit of
    ``units``, NGP_GENERIC_SWITCH cut to ``act``)."""
    if dest.exists():
        shutil.rmtree(dest)
    shutil.copytree(CSRC, dest)
    header = dest / "mlp_wide.cuh"
    src = header.read_text()
    if variant == "sine_rolled":
        head = re.search(r"void hidden_generic\([^{]*\{\n", src)
        src = src[:head.end()] + SINE_ROLLED + src[head.end():]
    if act is not None:
        start = src.index("#define NGP_GENERIC_SWITCH(ACT, CALL)")
        end = src.index("\n\n", start)
        src = src[:start] + f"#define NGP_GENERIC_SWITCH(ACT, CALL) CALL({CODES[act]});" + src[end:]
    header.write_text(src)
    return dest


def run_variant(name: str, csrc: Path, build_dir: Path) -> dict:
    """In this process: build csrc's copy into build_dir and time B and F at
    the five's act_cases."""
    sys.path.insert(0, str(HERE))
    import torch

    from instant_ngp_torch import cuda_lib

    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: this benchmark needs an NVIDIA GPU")
    cuda_lib.CSRC, cuda_lib.BUILD_DIR = csrc, build_dir
    path, build_s = cuda_lib.build()
    from instant_ngp_torch.bench import bwd_kernels, fwd_kernels

    cs = fwd_kernels._chip_smoke()
    cuobjdump = Path(cuda_lib._nvcc()).with_name("cuobjdump")
    usage = subprocess.run([str(cuobjdump), "--dump-resource-usage", str(path)], capture_output=True,
                           text=True, check=True).stdout
    stack, label = {}, None
    for line in usage.splitlines():
        if "Function" in line:
            label = cs.wide_kernel_label(line)
        elif label is not None and "STACK" in line:
            stack[label] = int(re.search(r"STACK:(\d+)", line).group(1))
    stl = {cs.wide_kernel_label(k): v for k, v in cs.sass_counts(path, "STL").items()
           if cs.wide_kernel_label(k) is not None}
    b = fwd_kernels.run_acts(HERE, ACTS)["B"]
    f = bwd_kernels.run_acts(HERE, ACTS)["F"]
    return {"variant": name, "device": torch.cuda.get_device_name(0), "build_s": build_s,
            "unit_s": {k: v for k, v in cuda_lib.SOURCE_SECONDS.items() if "mlp_wide" in k},
            "stack": stack, "local_stores": stl,
            "B_ms": {k: v["kernel_ms"] for k, v in b.items()},
            "F_ms": {k: v["kernel_ms"] for k, v in f.items()},
            "digests": {k: [b[k]["digest"], f[k]["digest"]] for k in b}}


def units_build(logs: Path) -> dict:
    """The build of a unit a generic activation against this checkout's, in
    one call: each set compiled at once as cuda_lib.build compiles (every
    source, the generic ones once or five times), nothing linked."""
    sys.path.insert(0, str(HERE))
    from instant_ngp_torch import cuda_lib

    nvcc = cuda_lib._nvcc()
    out = {"variant": "units"}
    copies = {act: patched_csrc(logs / "units" / f"csrc_{act}", "kernel", act) for act in ACTS}
    for label in ("kernel", "units"):
        objs = logs / label / "obj"
        objs.mkdir(parents=True, exist_ok=True)
        jobs = []
        for src in sorted(CSRC.glob("*.cu")):
            if label == "units" and src.name in GENERIC_SOURCES:
                jobs += [(f"{src.stem}[{act}]", copies[act] / src.name) for act in ACTS]
            else:
                jobs.append((src.stem, src))
        t0 = time.perf_counter()
        ends, _ = cuda_lib._run_all([[nvcc, *cuda_lib.NVCC_FLAGS, "-c", "-o", str(objs / f"{n}.o"), str(s)]
                                     for n, s in jobs])
        out[label] = {"wall_s": time.perf_counter() - t0, "units": len(jobs),
                      "unit_s": {n: e for (n, _), e in zip(jobs, ends) if "mlp_wide" in n}}
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--logs", type=Path, default=HERE / "build" / "act_variants", metavar="DIR")
    ap.add_argument("--one", nargs=3, metavar=("NAME", "CSRC", "BUILD_DIR"), help=argparse.SUPPRESS)
    ap.add_argument("names", nargs="*", default=["kernel", "sine_rolled", "units"])
    args = ap.parse_args()
    if args.one:  # one timed variant, in a process of its own
        name, csrc, build_dir = args.one
        print(json.dumps(run_variant(name, Path(csrc), Path(build_dir))))
        return
    logs = args.logs.resolve()
    logs.mkdir(parents=True, exist_ok=True)
    lines = []
    for name in args.names:
        if name == "units":
            line = units_build(logs)
        else:
            csrc = patched_csrc(logs / name / "csrc", name)
            run = subprocess.run([sys.executable, __file__, "--one", name, str(csrc), str(logs / name / "build")],
                                 capture_output=True, text=True, timeout=1800)
            (logs / f"{name}.log").write_text(run.stdout + run.stderr)
            found = [ln for ln in run.stdout.splitlines() if ln.startswith("{")]
            line = json.loads(found[-1]) if run.returncode == 0 and found else {"variant": name,
                                                                                 "rc": run.returncode}
        if "digests" in line and lines and "digests" in lines[0]:
            line["digests_equal_first"] = line["digests"] == lines[0]["digests"]
        lines.append(line)
        print(json.dumps(line), flush=True)
    (logs / "variants.json").write_text(json.dumps(lines, indent=1))


if __name__ == "__main__":
    main()
