"""Design measurements of kernels L and M (``csrc/volume.cu``): variants of
this checkout's source, each built alone with nvcc, held bit for bit against
the plain versions and timed on the card, in one process.

    python instant_ngp_torch/bench/volume_variants.py [--old DIR] [--logs DIR] [NAME ...]

A variant is the source with a few of its lines substituted (an anchor that
is missing raises). The variants (default: all; ``old`` with ``--old``):

- ``kernel``: the source as it is;
- ``window1``, ``window2``, ``window8``, ``window16``: look-ahead windows of
  1 (the draws staged, no look-ahead), 2, 8 and 16 iterations;
- ``stage8``, ``stage32``: ring stages of 8 and 32 iterations (depths that
  keep ~40-48 KB a block);
- ``stage16_depth1``, ``turns_staged``: one stage of 16 iterations in
  flight, without and with the scatter normal staged too (L: rows 0-7, M:
  all 5), so that a turn reads shared memory, not device memory;
- ``grid_at_occupied``, ``grid_in_box``: both kernels' grid reads at the
  occupied slots after the bitgrid's bytes, or at the slots in the box with
  them;
- ``packed``: the bitgrid read as a bit-packed copy, 32 cells a 32-bit word,
  made from ``VolumeTask.bitgrid`` (cell c: bit c % 32 of word c / 32);
- ``bulk``: the draws staged by the block: one thread issues 1-D bulk
  asynchronous copies of each stage's row segments on an mbarrier a stage,
  and the block walks its stages in step (``__syncthreads_or``), refilling a
  slot once every thread has walked it (run on 16-byte aligned sizes only);
- ``probe``: the kernel with per-thread counters and ``clock64`` spans kept
  in shared memory and written out once (the passes, the bitgrid and grid
  lookups issued and those whose slot was walked, the cycles of the window's
  reads, of the walk, between passes, of the fills and of whole stages);
- ``old``: DIR's ``csrc/volume.cu`` (``--old DIR``), e.g. the parent tree's.

On ``procedural_fog_volume(128)`` each variant runs L on 2^15 paths x 192
iterations (and 2^15 - 3 paths) and M on a 256^2 frame's 65,536 rays (and
65,531), every path and ray against the plain version, then its time per call
between CUDA events, each call after another draw buffer has been read
(``L_ms``, ``M_ms``: the draws cold) or, for L, after the generator has
refilled its draws (``L_warm_ms``). One JSON line a variant, all of them
written to DIR/variants.json. Without a card it raises.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]
SOURCE = HERE / "instant_ngp_torch" / "csrc" / "volume.cu"
SEED = 0
N_PATHS = 1 << 15
RAGGED = 3
RES = 256
REPS = 10


def sub(src: str, pairs) -> str:
    for a, b in pairs:
        if a not in src:
            raise ValueError(f"anchor not in the source: {a!r}")
        src = src.replace(a, b)
    return src


def shape(window: int, stage: int, depth_l: int, depth_m: int):
    return [("constexpr int kWindow = 4;", f"constexpr int kWindow = {window};"),
            ("constexpr int kStage = 16;", f"constexpr int kStage = {stage};"),
            ("constexpr int kBatchDepth = 2;", f"constexpr int kBatchDepth = {depth_l};"),
            ("constexpr int kGtDepth = 3;", f"constexpr int kGtDepth = {depth_m};")]


TURNS = [("constexpr int kBatchStaged = 5;", "constexpr int kBatchStaged = 8;"),
         ("constexpr int kGtStaged = 2;", "constexpr int kGtStaged = 5;")]
GRID_L = "den[j] = ldg_if(occ[j] && inb, grid + v, 0.0f);"
GRID_M = "extinction[j] = ldg_if(in[j] && inb, grid + v, 0.0f) * p.inv_majorant;"
GRID_AT_OCCUPIED = [(GRID_M, GRID_M.replace("in[j] && inb", "occ[j] && inb"))]
GRID_IN_BOX = [(GRID_L, GRID_L.replace("occ[j] && inb", "in[j] && inb"))]

PACKED = [("byte[j] = ldg_if(in[j], bits + bitgrid_cell(c));",
           "{ const int cell = bitgrid_cell(c); uint32_t word = 0;\n"
           "        asm(\"{\\n.reg .pred p;\\nsetp.ne.b32 p, %2, 0;\\n@p ld.global.nc.u32 %0, [%1];\\n}\\n\"\n"
           "            : \"+r\"(word) : \"l\"(reinterpret_cast<const uint32_t*>(bits) + (cell >> 5)),"
           " \"r\"((int)in[j]));\n"
           "        byte[j] = (word >> (cell & 31)) & 1u; }")]

BULK_RING = r'''template <int kRows, int kThreads, int kDepth>
struct DrawRing {
    static constexpr size_t kFloats = (size_t)kDepth * kRows * kStage * kThreads;
    static constexpr size_t kBytes = kFloats * sizeof(float) + kDepth * sizeof(uint64_t);

    float* buf;
    float* col;
    uint64_t* full;
    const float* draws;
    int per_iter, n, n_iters, n_stages, i, base, count;

    __device__ DrawRing(float* smem, const float* draws_, int per_iter_, int n_, int n_iters_, int i_)
        : buf(smem), col(smem + threadIdx.x), full(reinterpret_cast<uint64_t*>(smem + kFloats)),
          draws(draws_), per_iter(per_iter_), n(n_), n_iters(n_iters_),
          n_stages((n_iters_ + kStage - 1) / kStage), i(i_), base(blockIdx.x * kThreads),
          count(min(kThreads, n_ - (int)blockIdx.x * kThreads)) {}

    __device__ const float* src(int it, int r) const {
        return draws + ((size_t)it * per_iter + r) * n + i;
    }
    __device__ float at(int s, int r, int j) const {
        return col[(((s % kDepth) * kRows + r) * kStage + j) * kThreads];
    }
    __device__ float get(int s, int r, int j) const {
        return r < kRows ? at(s, r, j) : *src(s * kStage + j, r);
    }
    __device__ void fill(int s) {
        if (threadIdx.x != 0 || s >= n_stages) return;
        const int m = min(kStage, n_iters - s * kStage);
        uint64_t* bar = &full[s % kDepth];
        const uint32_t bytes = (uint32_t)(count * sizeof(float));
        wg::mbar_expect_tx(bar, bytes * kRows * m);
        float* dst = buf + (s % kDepth) * kRows * kStage * kThreads;
        for (int r = 0; r < kRows; ++r)
            for (int j = 0; j < m; ++j)
                wg::bulk_copy(dst + (r * kStage + j) * kThreads,
                              draws + ((size_t)(s * kStage + j) * per_iter + r) * n + base, bytes, bar);
    }
    __device__ void start() {
        if (threadIdx.x == 0) {
            for (int d = 0; d < kDepth; ++d) wg::mbar_init(&full[d], 1);
            wg::mbar_init_fence();
        }
        __syncthreads();
        for (int s = 0; s < kDepth; ++s) fill(s);
    }
    __device__ void wait(int s) const { wg::mbar_wait(&full[s % kDepth], (s / kDepth) & 1); }
    __device__ void drain(int s) const {
        for (int t = s + 1; t < min(s + kDepth, n_stages); ++t) wait(t);
    }
};

'''


def bulk(src: str) -> str:
    a = src.index("template <int kRows, int kThreads, int kDepth>\nstruct DrawRing {")
    b = src.index("using BatchRing")
    src = src[:a] + BULK_RING + src[b:]
    return sub(src, [
        ("#include <stdint.h>\n", "#include <stdint.h>\n\n#include \"wgmma.cuh\"\n"),
        # the mbarriers take M's ring past 48 KB: the launch opts in
        ("static_assert(BatchRing::kBytes <= 48 * 1024 && GtRing::kBytes <= 48 * 1024",
         "static_assert(BatchRing::kBytes <= 48 * 1024"),
        ("    const Params p = make_params(params, res);\n    const int blocks = (R + kGtThreads - 1) / kGtThreads;",
         "    cudaFuncSetAttribute(volume_trace_gt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,\n"
         "                         (int)GtRing::kBytes);\n"
         "    const Params p = make_params(params, res);\n    const int blocks = (R + kGtThreads - 1) / kGtThreads;"),
        ("    if (i >= n) return;\n    BatchRing ring(smem, draws, kBatchDraws, n, n_iters, i);\n"
         "    ring.start();\n    BatchPath q;\n    {",
         "    BatchRing ring(smem, draws, kBatchDraws, n, n_iters, i);\n    ring.start();\n"
         "    BatchPath q;\n    if (i < n) {"),
        ("    q.done = false;\n    for (int s = 0; s < ring.n_stages && !q.done; ++s) {\n"
         "        ring.wait();\n        batch_stage(q, ring, s, grid, bits, p);\n"
         "        if (!q.done) ring.fill(s + kBatchDepth);\n    }\n    ring.drain();\n",
         "    q.done = i >= n;\n    for (int s = 0; s < ring.n_stages; ++s) {\n        ring.wait(s);\n"
         "        if (!q.done) batch_stage(q, ring, s, grid, bits, p);\n"
         "        if (!__syncthreads_or(!q.done)) { ring.drain(s); break; }\n"
         "        ring.fill(s + kBatchDepth);\n    }\n    if (i >= n) return;\n"),
        ("    if (i >= R) return;\n    GtRing ring(smem, draws, kGtDraws, R, n_iters, i);\n    GtRay q;\n"
         "    const float org[3] = {o[3 * i], o[3 * i + 1], o[3 * i + 2]};",
         "    GtRing ring(smem, draws, kGtDraws, R, n_iters, i);\n    GtRay q;\n"
         "    const int ii = min(i, R - 1);\n"
         "    const float org[3] = {o[3 * ii], o[3 * ii + 1], o[3 * ii + 2]};"),
        ("q.dir[k] = d[3 * i + k];", "q.dir[k] = d[3 * ii + k];"),
        ("    q.alive = tmax > tmin;", "    q.alive = i < R && tmax > tmin;"),
        ("    if (q.alive) ring.start();\n    for (int s = 0; s < ring.n_stages && q.alive; ++s) {\n"
         "        ring.wait();\n        gt_stage(q, ring, s, grid, bits, p);\n"
         "        if (q.alive) ring.fill(s + kGtDepth);\n    }\n    ring.drain();\n",
         "    ring.start();\n    for (int s = 0; s < ring.n_stages; ++s) {\n        ring.wait(s);\n"
         "        if (q.alive) gt_stage(q, ring, s, grid, bits, p);\n"
         "        if (!__syncthreads_or(q.alive)) { ring.drain(s); break; }\n"
         "        ring.fill(s + kGtDepth);\n    }\n    if (i >= R) return;\n"),
    ])


# the probe's counters (per thread, summed): what each index holds
PROBE_KEYS = ("passes", "bitgrid_issued", "grid_issued", "bitgrid_used", "grid_used",
              "slots_walked", "between_passes_cycles", "stage_cycles", "window_reads_cycles",
              "unused", "walk_cycles", "wait_cycles", "unused2", "unused3", "fill_cycles",
              "fills")
PROBE_PRELUDE = r"""
__device__ unsigned long long g_probe[65536 * 16];
__shared__ unsigned int s_probe[128][16];
__device__ __forceinline__ void probe_add(int k, long long v) { s_probe[threadIdx.x][k] += (unsigned)v; }
"""
PROBE_TAIL = r"""
#include <string.h>
extern "C" int ngp_volume_probe(void* out, int reset) {
    static unsigned long long host[65536 * 16];
    if (reset) {
        memset(host, 0, sizeof host);
        return (int)cudaMemcpyToSymbol(g_probe, host, sizeof host);
    }
    const cudaError_t e = cudaMemcpyFromSymbol(host, g_probe, sizeof host);
    unsigned long long* o = (unsigned long long*)out;
    for (int k = 0; k < 16; ++k) o[k] = 0;
    for (int t = 0; t < 65536; ++t)
        for (int k = 0; k < 16; ++k) o[k] += host[t * 16 + k];
    return (int)e;
}
"""


def probe(src: str) -> str:
    count = ("{ int a_ = 0, b_ = 0, c_ = 0, d_ = 0;\n"
             "          for (int j = 0; j < kWindow; ++j) { a_ += in[j]; b_ += occ[j];"
             " if (j < next) { c_ += in[j]; d_ += occ[j]; } }\n"
             "          const long long t_d = clock64(); probe_add(0, 1); probe_add(1, a_);"
             " probe_add(2, b_); probe_add(3, c_); probe_add(4, d_); probe_add(5, next);\n"
             "          probe_add(8, t_b - t_a); probe_add(10, t_d - t_b); t_prev = t_d; }\n"
             "        start += next;")
    dep = ("        { float s_ = 0; for (int j = 0; j < kWindow; ++j) s_ += %s[j] + (float)byte[j];"
           " asm volatile(\"\" ::\"f\"(s_)); }\n        const long long t_b = clock64();\n")
    init = "\n    for (int k = 0; k < 16; ++k) s_probe[threadIdx.x][k] = 0;\n"
    flush = ("    ring.drain();\n"
             "    for (int k = 0; k < 16; ++k) g_probe[i * 16 + k] = s_probe[threadIdx.x][k];\n")
    walk_l = "        // the walk, up to the first slot that turns the path or ends its\n"
    walk_m = "        // the walk, up to the first slot that turns the ray or ends it; a\n"
    src = sub(src, [
        ("namespace {\n", "namespace {\n" + PROBE_PRELUDE),
        ("        start += next;", count),
        ("for (int start = 0; start < m && !q.done;) {",
         "long long t_prev = 0;\n    for (int start = 0; start < m && !q.done;) {"),
        ("for (int start = 0; start < m && q.alive;) {",
         "long long t_prev = 0;\n    for (int start = 0; start < m && q.alive;) {"),
        ("        int slot[kWindow];",
         "        const long long t_a = clock64();\n        if (t_prev) probe_add(6, t_a - t_prev);\n"
         "        int slot[kWindow];"),
        (walk_l, dep % "den" + walk_l),
        (walk_m, dep % "extinction" + walk_m),
        ("ring.wait();", "{ const long long t_w = clock64(); ring.wait(); probe_add(11, clock64() - t_w); }"),
        ("batch_stage(q, ring, s, grid, bits, p);",
         "{ const long long t_s = clock64(); batch_stage(q, ring, s, grid, bits, p);"
         " probe_add(7, clock64() - t_s); }"),
        ("gt_stage(q, ring, s, grid, bits, p);",
         "{ const long long t_s = clock64(); gt_stage(q, ring, s, grid, bits, p);"
         " probe_add(7, clock64() - t_s); }"),
        ("ring.fill(s + kBatchDepth);",
         "{ const long long t_f = clock64(); ring.fill(s + kBatchDepth);"
         " probe_add(14, clock64() - t_f); probe_add(15, 1); }"),
        ("ring.fill(s + kGtDepth);",
         "{ const long long t_f = clock64(); ring.fill(s + kGtDepth);"
         " probe_add(14, clock64() - t_f); probe_add(15, 1); }"),
        ("    ring.drain();\n", flush),
        ("    const int i = blockIdx.x * kBatchThreads + threadIdx.x;",
         "    const int i = blockIdx.x * kBatchThreads + threadIdx.x;" + init),
        ("    const int i = blockIdx.x * kGtThreads + threadIdx.x;",
         "    const int i = blockIdx.x * kGtThreads + threadIdx.x;" + init),
        # the counters' 8 KB of static shared memory take M past 48 KB: opt in
        ("    const Params p = make_params(params, res);\n    const int blocks = (R + kGtThreads - 1) / kGtThreads;",
         "    cudaFuncSetAttribute(volume_trace_gt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,\n"
         "                         (int)GtRing::kBytes);\n"
         "    const Params p = make_params(params, res);\n    const int blocks = (R + kGtThreads - 1) / kGtThreads;"),
    ])
    return src + PROBE_TAIL


def variants(old: Path | None) -> dict[str, str]:
    src = SOURCE.read_text()
    out = {"kernel": src,
           "window1": sub(src, shape(1, 16, 2, 3)),
           "window2": sub(src, shape(2, 16, 2, 3)),
           "window8": sub(src, shape(8, 16, 2, 3)),
           "window16": sub(src, shape(16, 16, 2, 3)),
           "stage8": sub(src, shape(4, 8, 4, 6)),
           "stage32": sub(src, shape(4, 32, 1, 1)),
           "stage16_depth1": sub(src, shape(4, 16, 1, 1)),
           "turns_staged": sub(src, shape(4, 16, 1, 1) + TURNS),
           "grid_at_occupied": sub(src, GRID_AT_OCCUPIED),
           "grid_in_box": sub(src, GRID_IN_BOX),
           "packed": sub(src, PACKED),
           "bulk": bulk(src),
           "probe": probe(src)}
    if old is not None:
        out["old"] = (old / "instant_ngp_torch" / "csrc" / "volume.cu").read_text()
    return out


def build(sources: dict[str, str], out: Path) -> dict:
    """Each variant's library, all nvcc runs at once: {name: (CDLL, ptxas
    lines)}; a variant that does not build raises."""
    from instant_ngp_torch import cuda_lib

    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu, so = out / f"volume_{name}.cu", out / f"libvolume_{name}.so"
        cu.write_text(text)
        cmd = [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-I", str(SOURCE.parent), "-Xptxas", "-v",
               "-shared", "-o", str(so), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stderr=subprocess.PIPE, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} did not build:\n{err[-3000:]}")
        lib = ctypes.CDLL(str(so))
        for fn in ("volume_generate_batch", "volume_trace_gt"):
            f = getattr(lib, f"ngp_{fn}")
            f.argtypes, f.restype = cuda_lib.SIGNATURES[fn], ctypes.c_int
        libs[name] = (lib, [ln.strip() for ln in err.splitlines() if "registers" in ln])
    return libs


def run_l(lib, task, draws, bits):
    import torch

    from instant_ngp_torch.volume import tracking

    n, n_iters = draws.first.shape[1], draws.per_iter.shape[0]
    dev = draws.first.device
    pts = torch.empty((4 * n, 3), device=dev)
    tgt = torch.empty((4 * n, 4), device=dev)
    valid = torch.empty((4 * n,), dtype=torch.bool, device=dev)
    params, res = tracking._params_c(task)
    err = lib.ngp_volume_generate_batch(
        draws.first.data_ptr(), draws.per_iter.data_ptr(), task.density_grid.data_ptr(),
        bits.data_ptr(), ctypes.addressof(params), ctypes.addressof(res), n, n_iters,
        pts.data_ptr(), tgt.data_ptr(), valid.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"cudaError {err}")
    return pts, tgt, valid


def run_m(lib, task, o, d, draws, bits):
    import torch

    from instant_ngp_torch.volume import tracking

    R = o.shape[0]
    rgb = torch.empty((R, 3), device=o.device)
    alpha = torch.empty((R,), device=o.device)
    params, res = tracking._params_c(task)
    err = lib.ngp_volume_trace_gt(
        o.data_ptr(), d.data_ptr(), draws.data_ptr(), task.density_grid.data_ptr(), bits.data_ptr(),
        ctypes.addressof(params), ctypes.addressof(res), R, draws.shape[0], rgb.data_ptr(),
        alpha.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"cudaError {err}")
    return rgb, alpha


def equal_share(out, ref) -> float:
    import torch

    n = ref[-1].shape[0]
    eq = torch.ones(n, dtype=torch.bool, device=ref[0].device)
    for a, b in zip(out, ref):
        eq &= (a == b).reshape(n, -1).all(-1)
    return float(eq.float().mean())


def refill(gen, draws) -> None:
    """``tracking.draw_batch``'s fills, into the draws in place."""
    from instant_ngp_torch.volume import tracking as t

    first, it = draws.first, draws.per_iter
    first[:3].normal_(generator=gen)
    first[3:].uniform_(generator=gen)
    it[:, t.ZETA1:t.SCATTER].uniform_(generator=gen)
    it[:, t.SCATTER:t.RESPAWN_UNIFORM].normal_(generator=gen)
    it[:, t.RESPAWN_UNIFORM:].uniform_(generator=gen)


def timed(before, fn) -> float:
    """ms of one call of fn between CUDA events, before() ahead of each; the
    mean of REPS calls after one warm-up."""
    import torch

    fn()
    total = 0.0
    for _ in range(REPS):
        before()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / REPS


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, default=None, metavar="DIR")
    ap.add_argument("--logs", type=Path, default=HERE / "build" / "volume_variants", metavar="DIR")
    ap.add_argument("names", nargs="*")
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))
    import numpy as np
    import torch

    from instant_ngp_torch.io.nanovdb import procedural_fog_volume
    from instant_ngp_torch.render.camera import pinhole_rays
    from instant_ngp_torch.volume import tracking
    from instant_ngp_torch.volume.task import VolumeTask

    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: this benchmark needs an NVIDIA GPU")
    sources = variants(args.old)
    if args.names:
        sources = {k: sources[k] for k in args.names}
    libs = build(sources, args.logs)
    dev = torch.device("cuda")
    config = json.loads((HERE / "configs" / "volume" / "base.json").read_text())
    task = VolumeTask(procedural_fog_volume(128), config, device=dev)
    words = task.bitgrid.reshape(-1, 32).to(torch.int64) << torch.arange(32, device=dev)
    words = words.sum(-1)
    packed = torch.where(words < 2 ** 31, words, words - 2 ** 32).to(torch.int32)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    draws, other = tracking.draw_batch(gen, N_PATHS), tracking.draw_batch(gen, N_PATHS)
    warm = tracking.BatchDraws(draws.first.clone(), draws.per_iter.clone())
    ragged = tracking.draw_batch(gen, N_PATHS - RAGGED)
    cam = np.concatenate([np.eye(3, dtype=np.float32), np.array([[0.5], [0.5], [-1.3]], np.float32)],
                         1)
    o, d = pinhole_rays(RES, RES, cam, 50.0, dev)
    d = d.to(torch.float32)
    gt = tracking.draw_gt(gen, o.shape[0])
    r = o.shape[0] - RAGGED - 2
    o_r, d_r, gt_r = o[:r].contiguous(), d[:r].contiguous(), tracking.draw_gt(gen, r)
    ref = {"L": tracking.generate_batch_plain(task, draws),
           "L_ragged": tracking.generate_batch_plain(task, ragged),
           "M": tracking.trace_gt_plain(task, o, d, gt),
           "M_ragged": tracking.trace_gt_plain(task, o_r, d_r, gt_r)}
    cold = lambda: other.per_iter.sum()  # noqa: E731
    results = {}
    for name, (lib, ptxas) in libs.items():
        bits = packed if name == "packed" else task.bitgrid
        v = {"ptxas": ptxas}
        if name == "probe":
            arr = (ctypes.c_ulonglong * 16)()
            lib.ngp_volume_probe.argtypes = [ctypes.c_void_p, ctypes.c_int]
            for case, fn, n in (("L", lambda: run_l(lib, task, draws, bits), N_PATHS),
                                ("M", lambda: run_m(lib, task, o, d, gt, bits), o.shape[0])):
                lib.ngp_volume_probe(None, 1)
                v[f"{case}_bit_equal"] = equal_share(fn(), ref[case])
                torch.cuda.synchronize()
                lib.ngp_volume_probe(ctypes.addressof(arr), 0)
                c = dict(zip(PROBE_KEYS, list(arr)))
                v[case] = {"per_thread": {k: c[k] / n for k in PROBE_KEYS if "unused" not in k},
                           "bitgrid_used_share": c["bitgrid_used"] / max(c["bitgrid_issued"], 1),
                           "grid_used_share": c["grid_used"] / max(c["grid_issued"], 1)}
        else:
            v["L_bit_equal"] = equal_share(run_l(lib, task, draws, bits), ref["L"])
            v["M_bit_equal"] = equal_share(run_m(lib, task, o, d, gt, bits), ref["M"])
            if name != "bulk":  # bulk copies need 16-byte rows
                v["L_ragged_bit_equal"] = equal_share(run_l(lib, task, ragged, bits),
                                                      ref["L_ragged"])
                v["M_ragged_bit_equal"] = equal_share(run_m(lib, task, o_r, d_r, gt_r, bits),
                                                      ref["M_ragged"])
            v["L_ms"] = timed(cold, lambda: run_l(lib, task, draws, bits))
            v["L_warm_ms"] = timed(lambda: refill(gen, warm), lambda: run_l(lib, task, warm, bits))
            v["M_ms"] = timed(cold, lambda: run_m(lib, task, o, d, gt, bits))
        results[name] = v
        print(json.dumps({"variant": name, **v}), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card)
    (args.logs / "variants.json").write_text(json.dumps({"card": card, "variants": results},
                                                         indent=1))


if __name__ == "__main__":
    main()
