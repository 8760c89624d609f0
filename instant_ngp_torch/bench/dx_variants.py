"""Design measurements of kernel K (the hash grid's d/dx, the end of
``csrc/hashgrid_bwd.cu``): variants of this checkout's source, each built
alone with nvcc, held bit for bit against the plain version and timed on the
card, in one process.

    python instant_ngp_torch/bench/dx_variants.py [--old DIR] [--logs DIR] [NAME ...]

The variants (default: all; ``old`` with ``--old``):

- ``kernel``: the source as it is: a block of 32 samples, warps over the
  levels, each lane's x and g read straight from device memory, a shared
  (L, 32, D) tile of the levels' terms summed per sample in level order;
- ``staged``: x and g staged in shared memory first by the block with
  16-byte loads (g rows padded so that a level's vector reads hit distinct
  banks), a barrier, then the levels;
- ``x_staged``: x alone staged so, g read straight;
- ``sample_major``: no shared tile: 16 lanes a sample, one level a lane (a
  second pass past 16 levels), the level table copied to shared memory, the
  terms summed in level order by shuffles into the first lane;
- ``warps16``: up to 16 warps a block, so that at 14 levels each warp
  takes one level (2 blocks an SM);
- ``pairs``: at F = 2, the two corners of a cell that differ in x read as
  one aligned 16-byte load where their rows are an aligned pair (an even
  first index: half the hashed cells, every dense one whose first index is
  even), the second row loaded alone otherwise (needs a 16-byte aligned
  table);
- ``blocks6``, ``blocks8``: the launch bounds ask for 6 or 8 blocks an SM
  (at most 40 or 32 registers a thread), not 4;
- ``predicated``: the level's kind (hashed or dense, a power-of-two size or
  not) a run-time value, not a template argument behind a warp-uniform
  branch: the compiler then predicates both kinds' index arithmetic and
  issues it on every level;
- ``two_levels``, ``two_levels_blocks3``: ``predicated`` with a warp taking
  two of its levels at once, every corner-row load of both issued before
  the first dot (with 4 or 3 blocks an SM, at most 64 or 85 registers a
  thread);
- ``old``: DIR's ``csrc/hashgrid_bwd.cu`` (``--old DIR``), e.g. the parent
  tree's: a thread a sample, walking the levels in order.

Inputs are ``bwd_kernels.py --dx``'s (the BVH hits of the SDF phase's mesh
at 256^2 and 1920x1080, configs/sdf/base.json's grid, a table and cotangent
random from SEED). Each variant: the rows bit for bit the plain version, and
the kernel's device time from torch.profiler warm (the same inputs call after
call) and cold (after a write of a buffer twice L2's size), in two rounds (the
variants in turn, then in reverse), each measurement after ~30 ms of matrix
products so that the card runs at its working clock; ptxas's registers and
spills. One JSON line a variant, all of them written to DIR/variants.json.
Without a card it raises.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]
SOURCE = HERE / "instant_ngp_torch" / "csrc" / "hashgrid_bwd.cu"
KERNEL = "hashgrid_dx_kernel"
REPS = 20


def sub(src: str, pairs) -> str:
    for a, b in pairs:
        if a not in src:
            raise ValueError(f"anchor not in the source: {a!r}")
        src = src.replace(a, b)
    return src


STAGE_HELPERS = """// the staged g row's stride in floats: L·F, or L·F + vec where L·F / vec
// is even, so that 32 lanes' vector reads at one level hit distinct banks
__host__ __device__ inline int dx_row_stride(int lf, int vec) {
    return (lf / vec) % 2 ? lf : lf + vec;
}

// count floats of src, rows of `width` back to back, into dst's rows of
// `stride`, by the whole block: 16-byte loads where src is 16-byte aligned
__device__ __forceinline__ void dx_stage(float* __restrict__ dst, const float* __restrict__ src,
                                         int count, int width, int stride) {
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(src) & 15u) == 0) {
        const float4* s4 = reinterpret_cast<const float4*>(src);
        for (int i = threadIdx.x; i < (count >> 2); i += blockDim.x) {
            const float4 q = __ldg(s4 + i);
            const float v[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const int e = 4 * i + k, r = e / width;
                dst[r * stride + (e - r * width)] = v[k];
            }
        }
        done = count & ~3;
    }
    for (int e = done + threadIdx.x; e < count; e += blockDim.x) {
        const int r = e / width;
        dst[r * stride + (e - r * width)] = __ldg(src + e);
    }
}

"""
KERNEL_HEAD = "template <int D, int F>\n__global__ void __launch_bounds__(kDxWarps * 32, kDxMinBlocks)"
DIRECT_READS = """    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
    if (lane < rows) {
        const long long s = s0 + lane;
        float pos[D];
#pragma unroll
        for (int d = 0; d < D; ++d) pos[d] = __ldg(x + s * D + d);
        const float* __restrict__ gs = g + s * ((long long)n_levels * F);
"""


def staged(stage_g: bool):
    """x, and with stage_g g too, staged in shared memory by the block with
    16-byte loads before the levels (g rows padded: ``dx_row_stride``)."""
    g_rows = "dx_row_stride(n_levels * F, F < 4 ? F : 4)" if stage_g else "0"
    reads = f"""    const int lf = n_levels * F, rs = {g_rows};
    float* xs = cs + n_levels * kDxTile * D;  // (32, D) positions
    float* gst = xs + kDxTile * D;            // (32, rs) cotangent rows
    dx_stage(xs, x + s0 * D, rows * D, D, D);
    {"dx_stage(gst, g + s0 * lf, rows * lf, lf, rs);" if stage_g else "(void)gst; (void)lf;"}
    __syncthreads();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
    if (lane < rows) {{
        const long long s = s0 + lane;
        float pos[D];
#pragma unroll
        for (int d = 0; d < D; ++d) pos[d] = xs[lane * D + d];
        const float* __restrict__ gs = {"gst + lane * rs" if stage_g else "g + s * ((long long)n_levels * F)"};
"""
    out = [(KERNEL_HEAD, STAGE_HELPERS + KERNEL_HEAD),
           ("    extern __shared__ float cs[];", "    extern __shared__ __align__(16) float cs[];"),
           (DIRECT_READS, reads),
           ("    const size_t smem = dx_smem_bytes(D, n_levels);  // at most 12 KB",
            f"    const size_t smem = dx_smem_bytes(D, n_levels) + sizeof(float) * kDxTile * "
            f"(D + {g_rows});")]
    if stage_g:
        out.append(("            dx_load<F, true>(gs + l * F, gl);",
                    "            dx_load<F, false>(gs + l * F, gl);"))
    return out


TWO_LEVELS_HELPERS = """// one level's gathered state: fractions, simplex ranks and corner rows
template <int D, int F>
struct DxGather {
    float t[D];
    float rows[1 << D][F];
    int amax, amin;
    bool simplex;
};

template <int D, int F>
__device__ __forceinline__ void dx_gather(const DxLevel& lv, bool simplex, const float (&pos)[D],
                                          DxGather<D, F>& st) {
    int gr[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
        const float p = fmaf(pos[d], lv.scale, 0.5f);
        const float fl = floorf(p);
        st.t[d] = p - fl;
        gr[d] = (int)fl;
    }
    st.simplex = false;
    if constexpr (D == 3) {
        if (simplex && lv.hashed) {
            const float* t = st.t;
            int amax = 0, amin = 0;
            if (t[1] > t[amax]) amax = 1;
            if (t[2] > t[amax]) amax = 2;
            if (t[1] < t[amin]) amin = 1;
            if (t[2] < t[amin]) amin = 2;
            if (amin == amax) amin = (amax + 1) % 3;
            st.amax = amax;
            st.amin = amin;
            st.simplex = true;
            const int bits[4] = {0, 1 << amax, 7 ^ (1 << amin), 7};
#pragma unroll
            for (int c = 0; c < 4; ++c)
                dx_load<F, true>(lv.tab + (size_t)dx_corner<D, true, true>(lv, gr, bits[c]) * F,
                                 st.rows[c]);
            return;
        }
    }
#pragma unroll
    for (int c = 0; c < (1 << D); ++c)
        dx_load<F, true>(lv.tab + (size_t)dx_corner<D, true, true>(lv, gr, c) * F, st.rows[c]);
}

template <int D, int F>
__device__ __forceinline__ void dx_terms(const DxGather<D, F>& st, float scale,
                                         const float (&gl)[F], float (&out)[D]) {
    constexpr int kC = 1 << D;
    const float* t = st.t;
    if constexpr (D == 3) {
        if (st.simplex) {
            float gf[4];
#pragma unroll
            for (int c = 0; c < 4; ++c) gf[c] = dx_dot<F>(gl, st.rows[c]);
#pragma unroll
            for (int d = 0; d < D; ++d) {
                const float dt = d == st.amax ? gf[1] - gf[0] : d == st.amin ? gf[3] - gf[2]
                                                                             : gf[2] - gf[1];
                out[d] = dt * scale;
            }
            return;
        }
    }
    float gf[kC];
#pragma unroll
    for (int c = 0; c < kC; ++c) gf[c] = dx_dot<F>(gl, st.rows[c]);
#pragma unroll
    for (int d = 0; d < D; ++d) {
        float col = 0.0f;
#pragma unroll
        for (int c = 0; c < kC; ++c) {
            float prod = 1.0f;
            bool first = true;
#pragma unroll
            for (int e = 0; e < D; ++e) {
                if (e == d) continue;
                const float a = ((c >> e) & 1) ? t[e] : 1.0f - t[e];
                prod = first ? a : prod * a;
                first = false;
            }
            const float term = gf[c] * (((c >> d) & 1) ? prod : -prod);
            col = c == 0 ? term : col + term;
        }
        out[d] = col * scale;
    }
}

"""
TWO_LEVELS_LOOP = """        for (int l = warp; l < n_levels; l += warps) {
            const DxLevel lv = {lt.scale[l], lt.res[l], lt.size[l], lt.magic[l], lt.shift[l],
                                lt.hashed[l] != 0, table + (size_t)lt.offset[l] * F};
            float gl[F];
            dx_load<F, true>(gs + l * F, gl);
            float c[D];
            const bool simplex = interp == kSimplex, pow2 = lv.magic == 0;
            dx_level<D, F, true, true>(lv, simplex, pos, gl, c);
#pragma unroll
            for (int d = 0; d < D; ++d) cs[(l * kDxTile + lane) * D + d] = c[d];
        }
"""
TWO_LEVELS = [
    (KERNEL_HEAD, TWO_LEVELS_HELPERS + KERNEL_HEAD),
    (TWO_LEVELS_LOOP, """        for (int l = warp; l < n_levels; l += 2 * warps) {
            const int m = l + warps < n_levels ? l + warps : l;  // the warp's next level
            const DxLevel la = {lt.scale[l], lt.res[l], lt.size[l], lt.magic[l], lt.shift[l],
                                lt.hashed[l] != 0, table + (size_t)lt.offset[l] * F};
            const DxLevel lb = {lt.scale[m], lt.res[m], lt.size[m], lt.magic[m], lt.shift[m],
                                lt.hashed[m] != 0, table + (size_t)lt.offset[m] * F};
            float ga[F], gb[F];
            dx_load<F, true>(gs + l * F, ga);
            dx_load<F, true>(gs + m * F, gb);
            DxGather<D, F> sa, sb;
            dx_gather<D, F>(la, interp == kSimplex, pos, sa);
            dx_gather<D, F>(lb, interp == kSimplex, pos, sb);
            float ca[D], cb[D];
            dx_terms<D, F>(sa, la.scale, ga, ca);
            dx_terms<D, F>(sb, lb.scale, gb, cb);
#pragma unroll
            for (int d = 0; d < D; ++d) {
                cs[(l * kDxTile + lane) * D + d] = ca[d];
                cs[(m * kDxTile + lane) * D + d] = cb[d];
            }
        }
"""),
]


DISPATCH = """            if (lv.hashed) {  // the level's kind is warp-uniform: a branch, not predication
                if (pow2) dx_level<D, F, true, true>(lv, simplex, pos, gl, c);
                else dx_level<D, F, true, false>(lv, simplex, pos, gl, c);
            } else {
                if (pow2) dx_level<D, F, false, true>(lv, simplex, pos, gl, c);
                else dx_level<D, F, false, false>(lv, simplex, pos, gl, c);
            }
"""
PREDICATED = [
    ("    if constexpr (kPow2) return v & (lv.size - 1u);",
     "    if (lv.magic == 0) return v & (lv.size - 1u);"),
    ("idx = kHashed ? c0", "idx = lv.hashed ? c0"),
    ("""    if constexpr (D == 3 && kHashed) {
        if (simplex) {""", """    if constexpr (D == 3) {
        if (simplex && lv.hashed) {"""),
    (DISPATCH, "            dx_level<D, F, true, true>(lv, simplex, pos, gl, c);\n"),
]


def min_blocks(n: int):
    return [("constexpr int kDxMinBlocks = 4;", f"constexpr int kDxMinBlocks = {n};")]


WARPS16 = [("constexpr int kDxWarps = 8;", "constexpr int kDxWarps = 16;"),
           ("constexpr int kDxMinBlocks = 4;", "constexpr int kDxMinBlocks = 2;")]

PAIRS = [("""    float rows[kC][F];
#pragma unroll
    for (int c = 0; c < kC; ++c)
        dx_load<F, true>(lv.tab + (size_t)dx_corner<D, kHashed, kPow2>(lv, gr, c) * F, rows[c]);
""", """    float rows[kC][F];
    if constexpr (F == 2) {
#pragma unroll
        for (int c = 0; c < kC; c += 2) {
            const uint32_t i0 = dx_corner<D, kHashed, kPow2>(lv, gr, c);
            const uint32_t i1 = dx_corner<D, kHashed, kPow2>(lv, gr, c + 1);
            const float4 q = __ldg(reinterpret_cast<const float4*>(lv.tab + (size_t)(i0 & ~1u) * 2));
            const bool odd = (i0 & 1u) != 0u;
            rows[c][0] = odd ? q.z : q.x;
            rows[c][1] = odd ? q.w : q.y;
            if ((i0 ^ i1) == 1u) {
                rows[c + 1][0] = odd ? q.x : q.z;
                rows[c + 1][1] = odd ? q.y : q.w;
            } else {
                dx_load<F, true>(lv.tab + (size_t)i1 * F, rows[c + 1]);
            }
        }
    } else {
#pragma unroll
        for (int c = 0; c < kC; ++c)
            dx_load<F, true>(lv.tab + (size_t)dx_corner<D, kHashed, kPow2>(lv, gr, c) * F,
                             rows[c]);
    }
""")]

SAMPLE_MAJOR = r"""constexpr int kDxLanes = 16;  // lanes a sample, a level a lane

template <int D, int F>
__global__ void __launch_bounds__(256)
hashgrid_dx_kernel(const float* __restrict__ x, const float* __restrict__ table,
                   const float* __restrict__ g, DxTable lt, int n_levels, int interp,
                   long long n, float* __restrict__ dx) {
    __shared__ DxTable sl;  // lanes index the level arrays by level
    for (int i = threadIdx.x; i < (int)(sizeof(DxTable) / 4); i += blockDim.x)
        reinterpret_cast<uint32_t*>(&sl)[i] = reinterpret_cast<const uint32_t*>(&lt)[i];
    __syncthreads();
    const int j = threadIdx.x & (kDxLanes - 1);
    const long long s = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / kDxLanes;
    if (s >= n) return;  // the sample's 16 lanes leave together
    const unsigned mask = 0xffffu << (threadIdx.x & 16);
    const int lf = n_levels * F;
    float pos[D], acc[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
        pos[d] = __ldg(x + s * D + d);
        acc[d] = 0.0f;
    }
    for (int base = 0; base < n_levels; base += kDxLanes) {
        const int l = base + j;
        float c[D];
#pragma unroll
        for (int d = 0; d < D; ++d) c[d] = 0.0f;
        if (l < n_levels && interp != kNearest) {
            const DxLevel lv = {sl.scale[l], sl.res[l], sl.size[l], sl.magic[l], sl.shift[l],
                                sl.hashed[l] != 0, table + (size_t)sl.offset[l] * F};
            float gl[F];
            dx_load<F, true>(g + s * lf + l * F, gl);
            const bool simplex = interp == kSimplex, pow2 = lv.magic == 0;
""" + DISPATCH + r"""        }
        const int m = n_levels - base < kDxLanes ? n_levels - base : kDxLanes;
        for (int k = 0; k < m; ++k) {
#pragma unroll
            for (int d = 0; d < D; ++d) acc[d] = acc[d] + __shfl_sync(mask, c[d], k, kDxLanes);
        }
    }
    if (j == 0) {
#pragma unroll
        for (int d = 0; d < D; ++d) dx[s * D + d] = acc[d];
    }
}

template <int D, int F>
int launch_dx_f(const float* xp, const float* tp, const float* gp, const DxTable& lt,
                int n_levels, int interp, long long n, float* dxp, cudaStream_t st) {
    const long long blocks = (n * kDxLanes + 255) / 256;
    hashgrid_dx_kernel<D, F><<<(unsigned)blocks, 256, 0, st>>>(xp, tp, gp, lt, n_levels, interp,
                                                               n, dxp);
    return (int)cudaGetLastError();
}

"""


def sample_major(src: str) -> str:
    """The source with K's kernel and its launcher replaced by SAMPLE_MAJOR."""
    start = src.index("template <int D, int F>\n__global__ void __launch_bounds__(kDxWarps")
    end = src.index("template <int D>\nint launch_dx(")
    return src[:start] + SAMPLE_MAJOR + src[end:]


def variants(old: Path | None) -> dict[str, str]:
    src = SOURCE.read_text()
    out = {"kernel": src, "staged": sub(src, staged(True)), "x_staged": sub(src, staged(False)),
           "sample_major": sample_major(src), "warps16": sub(src, WARPS16),
           "pairs": sub(src, PAIRS), "blocks6": sub(src, min_blocks(6)),
           "blocks8": sub(src, min_blocks(8)), "predicated": sub(src, PREDICATED),
           "two_levels": sub(src, PREDICATED + TWO_LEVELS),
           "two_levels_blocks3": sub(src, PREDICATED + TWO_LEVELS + min_blocks(3))}
    if old is not None:
        out["old"] = (old / "instant_ngp_torch" / "csrc" / "hashgrid_bwd.cu").read_text()
    return out


def takes_magic(src: str) -> bool:
    """Whether the source's K launcher takes kernel A's magic and shift
    arrays (this design) or not (the earlier kernel, a thread a sample)."""
    m = re.search(r'extern "C" int ngp_hashgrid_encode_dx\(([^)]*)\)', src)
    return "magic" in m.group(1)


def build(sources: dict[str, str], out: Path) -> dict:
    """Each variant's library, all nvcc runs at once: {name: (the launcher,
    whether it takes the magic arrays, ptxas lines)}; a variant that does not
    build raises."""
    from instant_ngp_torch import cuda_lib

    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu, so = out / f"dx_{name}.cu", out / f"libdx_{name}.so"
        cu.write_text(text)
        cmd = [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o", str(so),
               str(cu)]
        procs[name] = (subprocess.Popen(cmd, stderr=subprocess.PIPE, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} did not build:\n{err[-3000:]}")
        magic = takes_magic(sources[name])
        fn = ctypes.CDLL(str(so)).ngp_hashgrid_encode_dx
        args = cuda_lib.SIGNATURES["hashgrid_encode_dx"]
        fn.argtypes = args if magic else args[:8] + args[10:]
        fn.restype = ctypes.c_int
        ptxas = [ln.strip() for ln in err.splitlines()
                 if "registers" in ln or "spill" in ln or KERNEL in ln]
        libs[name] = (fn, magic, ptxas)
    return libs


def launcher(fn, magic: bool, levels, table, x, g):
    """A call of one variant's K on (table, x, g) into a fresh dx."""
    import torch

    from instant_ngp_torch.ops import hashgrid as hg

    arrays = hg._level_arrays(levels) + (hg._magic_arrays(levels) if magic else ())
    ptrs = [ctypes.addressof(a) for a in arrays]
    n, n_dims = x.shape

    def call():
        dx = torch.empty((n, n_dims), device=x.device)
        err = fn(x.data_ptr(), table.data_ptr(), g.data_ptr(), *ptrs, n_dims, len(levels),
                 table.shape[1], hg.INTERPOLATIONS["linear"], n, dx.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"cudaError {err}")
        return dx
    return call


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, default=None, metavar="DIR")
    ap.add_argument("--logs", type=Path, default=HERE / "build" / "dx_variants", metavar="DIR")
    ap.add_argument("names", nargs="*")
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))
    import torch

    from instant_ngp_torch.bench.bwd_kernels import (DX_SHAPES, _chip_smoke, dx_inputs,
                                                      working_clock)
    from instant_ngp_torch.ops.hashgrid import hashgrid_encode_dx_plain

    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: this benchmark needs an NVIDIA GPU")
    cs = _chip_smoke()
    sources = variants(args.old)
    if args.names:
        sources = {k: sources[k] for k in args.names}
    libs = build(sources, args.logs)
    dev = torch.device("cuda")
    flush = torch.empty(2 * cs.L2_BYTES // 4, device=dev)
    inputs = {}
    for shape, (w, h) in DX_SHAPES.items():
        levels, table, x, g = dx_inputs(w, h, dev)
        inputs[shape] = (levels, table, x, g, hashgrid_encode_dx_plain(levels, "linear", table, x, g))
    spin = functools.partial(working_clock, dev)

    # two rounds, the variants in turn and then in reverse, each measurement after a spin
    order = list(libs) + list(reversed(list(libs)))
    rounds = {name: {shape: [] for shape in inputs} for name in libs}
    for name in order:
        fn, magic, _ = libs[name]
        for shape, (levels, table, x, g, ref) in inputs.items():
            call = launcher(fn, magic, levels, table, x, g)
            out = call()
            spin()
            warm = cs.device_split(call, KERNEL, reps=REPS, per_call=1)
            spin()
            cold = cs.device_split(lambda: (flush.add_(1.0), call()), KERNEL, reps=REPS,
                                   per_call=1)
            rounds[name][shape].append({"bit_equal_rows": cs.bit_equal_rows(out, ref),
                                        "warm": warm["kernel_ms"], "cold": cold["kernel_ms"],
                                        "timed_by": [warm["timed_by"], cold["timed_by"]]})
    results = {}
    for name, (_, _, ptxas) in libs.items():
        v = {"ptxas": ptxas}
        for shape, rs in rounds[name].items():
            v[shape] = {"rows": inputs[shape][2].shape[0],
                        "bit_equal_rows": min(r["bit_equal_rows"] for r in rs),
                        "kernel_ms_warm": sum(r["warm"] for r in rs) / len(rs),
                        "kernel_ms_cold": sum(r["cold"] for r in rs) / len(rs),
                        "rounds_warm": [r["warm"] for r in rs],
                        "rounds_cold": [r["cold"] for r in rs],
                        "timed_by": sorted({t for r in rs for t in r["timed_by"]})}
        results[name] = v
        print(json.dumps({"variant": name, **v}), flush=True)
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                             "--format=csv,noheader"], capture_output=True, text=True,
                            timeout=60).stdout.strip()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card)
    print(f"SM clock after the runs, and its maximum: {clocks}")
    (args.logs / "variants.json").write_text(json.dumps({"card": card, "clocks": clocks,
                                                         "variants": results}, indent=1))


if __name__ == "__main__":
    main()
