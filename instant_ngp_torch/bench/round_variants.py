"""Design measurements of the baked round (``csrc/baked_round.cu``):
variants built alone with nvcc, held against the round's plain version and
timed on the card, in one process.

    python instant_ngp_torch/bench/round_variants.py [--logs DIR] [NAME ...]

The variants (default: all):

- ``kernel``: this checkout's ``csrc/baked_round.cu`` as it is: the
  ray_lane design (a warp 32 rays; the window in passes of 4 samples a ray,
  each staged in shared memory a lane an element (coalesced), its valid
  samples listed and looked up a lane a listed sample, then each lane
  composites its own ray's samples in order, as kernel D's loop), the
  ray's state read at the start;
- ``half_warp``: a half-warp a ray, a lane a sample of a chunk of 16: each
  lane loads its sample's ts, dts and valid (coalesced) and makes its own
  lookup, forms τ_0 + … + τ_k in order from the half-warp's 16 values in
  shared memory, and lanes 0-3 sum the weighted [r, g, b, t] over the chunk
  in sample order;
- ``ray_lane_pass8``: the ray_lane design with passes of 8 samples and the
  ray's state read after the passes; and as it with 2 warps a block
  (``ray_lane_w2``), passes of 16 samples and 2 warps a block
  (``ray_lane_pass16``), the composite's loop unrolled over the pass
  (``ray_lane_unroll``), at most 40 registers a thread (``ray_lane_regs40``),
  passes of 4 (``ray_lane_pass4``; with 40 registers:
  ``ray_lane_pass4_regs40``), the state read at the start
  (``ray_lane_early``; with passes of 4 or 2: ``ray_lane_pass4_early``,
  ``ray_lane_pass2_early``);
- ``*_no_lookup``: ``kernel``, ``half_warp`` and ``ray_lane_pass8`` without
  the lookups (every sample empty): what the lookups cost in each (their
  outputs are not compared).

Inputs are ``chip_smoke.py``'s: the fox snapshot's baked bake at view 0's
position, the first round of the 1920x1080 baked frame's middle 2^18-ray
chunk before its compaction (``chip_smoke.first_round``) and its next round
compacted as the render runs it (``chip_smoke.baked_round_at``). Each
variant: within ``chip_smoke.TOL_COMPOSITE`` of the plain version with the
alive flags equal (and whether it equals this checkout's kernel bit for
bit), its device time per call from torch.profiler in two rounds (the
variants in turn, then in reverse), and ptxas's registers and spills. One
JSON line a variant, all of them written to DIR/variants.json. Without a
card it raises.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]  # this checkout
CSRC = HERE / "instant_ngp_torch" / "csrc"
KERNEL = "baked_round"
REPS = 20

# a half-warp a ray, a lane a sample (this checkout's first design of the round)
HALF_WARP = r'''
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "baked.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 16;                    // a half-warp a ray
constexpr int kRaysPerBlock = kThreads / kLanes;
constexpr int kHalfStride = 4 * kLanes + 4;   // floats of a half's products, padded

__global__ void __launch_bounds__(kThreads) baked_round_kernel(
    const float* __restrict__ ts, const float* __restrict__ dts, const uint8_t* __restrict__ valid,
    const float* __restrict__ t_exit, const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ t, const float* __restrict__ tmax, const float* __restrict__ T,
    const float* __restrict__ rgb, const float* __restrict__ depth,
    const uint8_t* __restrict__ alive, const float* __restrict__ cost,
    const int32_t* __restrict__ index, const uint4* __restrict__ table,
    const int32_t* __restrict__ offsets, const int32_t* __restrict__ res, int max_mip, int R,
    int K, float eps_t, float* __restrict__ T_new, float* __restrict__ rgb_new,
    float* __restrict__ depth_new, uint8_t* __restrict__ alive_new,
    float* __restrict__ cost_new) {
    __shared__ float s_tau[kWarps][32];
    __shared__ __align__(16) float s_prod[kWarps][2 * kHalfStride];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int half = lane >> 4, sub = lane & (kLanes - 1);
    const unsigned half_mask = 0xffffu << (kLanes * half);
    const long long rl = (long long)blockIdx.x * kRaysPerBlock + (threadIdx.x >> 4);
    const bool ray = rl < R;  // every lane takes part in the shuffles; only real rays load
    const int r = ray ? (int)rl : 0;
    double od[3] = {0.0, 0.0, 0.0}, dd[3] = {0.0, 0.0, 0.0};
    float Tr = 0.0f;
    if (ray) {
        for (int a = 0; a < 3; ++a) {
            od[a] = (double)o[3 * r + a];
            dd[a] = (double)d[3 * r + a];
        }
        Tr = T[r];
    }
    float* prod = &s_prod[warp][half * kHalfStride];
    float carry = 0.0f, acc = 0.0f;  // carry: the running sum; acc: lane sub's channel
    int n_valid = 0;
    for (int c0 = 0; c0 < K; c0 += kLanes) {
        const int n = min(kLanes, K - c0);
        const size_t i = (size_t)r * K + c0 + sub;
        float tk = 0.0f, dtk = 0.0f;
        bool v = false;
        if (ray && sub < n) {
            tk = ts[i];
            dtk = dts[i];
            v = valid[i] != 0;
        }
        float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (v) {
            s = ngp_baked::sample((float)((double)tk * dd[0] + od[0]),
                                  (float)((double)tk * dd[1] + od[1]),
                                  (float)((double)tk * dd[2] + od[2]), index, table, offsets, res,
                                  max_mip);
        }
        const float tau = (v ? s.w : 0.0f) * dtk;
        s_tau[warp][lane] = tau;
        __syncwarp();
        float cs = carry;
        const int last = min(sub, n - 1);
#pragma unroll
        for (int j = 0; j < kLanes; ++j) {
            if (j <= last) cs = cs + s_tau[warp][kLanes * half + j];
        }
        const float weight = (1.0f - expf(-tau)) * (Tr * expf(-cs + tau));
        reinterpret_cast<float4*>(prod)[sub] =
            make_float4(weight * s.x, weight * s.y, weight * s.z, weight * tk);
        __syncwarp();
        if (sub < 4) {
            for (int j = 0; j < n; ++j) acc = acc + prod[4 * j + sub];
        }
        carry = __shfl_sync(0xffffffffu, cs, kLanes * half + n - 1);
        n_valid += __popc(__ballot_sync(0xffffffffu, v) & half_mask);
        __syncwarp();
    }
    if (!ray) return;
    if (sub < 3) {
        rgb_new[3 * r + sub] = rgb[3 * r + sub] + acc;
    } else if (sub == 3) {
        depth_new[r] = depth[r] + acc;
    } else if (sub == 4) {
        const float Tn = Tr * expf(-carry);
        T_new[r] = Tn;
        alive_new[r] = (alive[r] != 0) && Tn >= eps_t && t_exit[r] < tmax[r] && t_exit[r] > t[r];
        cost_new[r] = cost[r] + (float)n_valid;
    }
}

}  // namespace

extern "C" int ngp_baked_round(const void* ts, const void* dts, const void* valid,
                               const void* t_exit, const void* o, const void* d, const void* t,
                               const void* tmax, const void* T, const void* rgb, const void* depth,
                               const void* alive, const void* cost, const void* index,
                               const void* table, const void* offsets, const void* res,
                               int max_mip, int R, int K, float eps_t, void* T_new, void* rgb_new,
                               void* depth_new, void* alive_new, void* cost_new, void* stream) {
    const int blocks = (R + kRaysPerBlock - 1) / kRaysPerBlock;
    baked_round_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(ts), static_cast<const float*>(dts),
        static_cast<const uint8_t*>(valid), static_cast<const float*>(t_exit),
        static_cast<const float*>(o), static_cast<const float*>(d), static_cast<const float*>(t),
        static_cast<const float*>(tmax), static_cast<const float*>(T),
        static_cast<const float*>(rgb), static_cast<const float*>(depth),
        static_cast<const uint8_t*>(alive), static_cast<const float*>(cost),
        static_cast<const int32_t*>(index), static_cast<const uint4*>(table),
        static_cast<const int32_t*>(offsets), static_cast<const int32_t*>(res), max_mip, R, K,
        eps_t, static_cast<float*>(T_new), static_cast<float*>(rgb_new),
        static_cast<float*>(depth_new), static_cast<uint8_t*>(alive_new),
        static_cast<float*>(cost_new));
    return (int)cudaGetLastError();
}
'''

# the ray_lane design with passes of 8 samples and the ray's state read after them
RAY_LANE_PASS8 = r'''
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "baked.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kPass = 8;         // samples a ray a pass
constexpr int kRow = kPass + 1;  // a ray's row of a pass in shared memory, padded
constexpr int kCells = 32 * kRow;

struct WarpTile {
    float ts[kCells];
    float tau[kCells];  // dt, then tau
    float rgb[3][kCells];
    float o[96], d[96];         // the warp's rays
    uint16_t list[32 * kPass];  // the pass's valid samples (their cells)
    uint8_t vmask[32];          // each ray's valid samples in the pass
};

__global__ void __launch_bounds__(kThreads) baked_round_kernel(
    const float* __restrict__ ts, const float* __restrict__ dts, const uint8_t* __restrict__ valid,
    const float* __restrict__ t_exit, const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ t, const float* __restrict__ tmax, const float* __restrict__ T,
    const float* __restrict__ rgb, const float* __restrict__ depth,
    const uint8_t* __restrict__ alive, const float* __restrict__ cost,
    const int32_t* __restrict__ index, const uint4* __restrict__ table,
    const int32_t* __restrict__ offsets, const int32_t* __restrict__ res, int max_mip, int R,
    int K, float eps_t, float* __restrict__ T_new, float* __restrict__ rgb_new,
    float* __restrict__ depth_new, uint8_t* __restrict__ alive_new,
    float* __restrict__ cost_new) {
    __shared__ WarpTile tiles[kWarps];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    WarpTile& s = tiles[warp];
    const long long r0 = ((long long)blockIdx.x * kWarps + warp) * 32;
    if (r0 >= R) return;  // the whole warp: only warp-level barriers below
    const int nr = (int)min(32LL, (long long)R - r0);
    for (int e = lane; e < 3 * nr; e += 32) {
        s.o[e] = o[3 * r0 + e];
        s.d[e] = d[3 * r0 + e];
    }
    const bool ray = lane < nr;
    const long long r = r0 + lane;
    const float Tr = ray ? T[r] : 0.0f;
    float cs = 0.0f, acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_d = 0.0f;
    int n_valid = 0;
    for (int c0 = 0; c0 < K; c0 += kPass) {
        const int n = min(kPass, K - c0);
        int n_list = 0;
#pragma unroll
        for (int e0 = 0; e0 < 32 * kPass; e0 += 32) {  // 1. stage and list
            const int e = e0 + lane;
            const int ry = e / kPass, k = e % kPass;
            float tk = 0.0f, dtk = 0.0f;
            bool v = false;
            if (ry < nr && k < n) {
                const size_t i = (size_t)(r0 + ry) * K + c0 + k;
                tk = ts[i];
                dtk = dts[i];
                v = valid[i] != 0;
            }
            const int cell = ry * kRow + k;
            s.ts[cell] = tk;
            if (v) {
                s.tau[cell] = dtk;
            } else {
                s.tau[cell] = 0.0f * dtk;
                s.rgb[0][cell] = s.rgb[1][cell] = s.rgb[2][cell] = 0.0f;
            }
            const unsigned vb = __ballot_sync(0xffffffffu, v);
            if (v) s.list[n_list + __popc(vb & ((1u << lane) - 1u))] = (uint16_t)cell;
            n_list += __popc(vb);
            if (k == 0) s.vmask[ry] = (uint8_t)((vb >> lane) & ((1u << kPass) - 1u));
        }
        __syncwarp();
        for (int q = lane; q < n_list; q += 32) {  // 2. the valid samples' lookups
            const int cell = s.list[q];
            const int ry = cell / kRow;
            const double tk = (double)s.ts[cell];
            const float4 smp = ngp_baked::sample(
                (float)(tk * (double)s.d[3 * ry] + (double)s.o[3 * ry]),
                (float)(tk * (double)s.d[3 * ry + 1] + (double)s.o[3 * ry + 1]),
                (float)(tk * (double)s.d[3 * ry + 2] + (double)s.o[3 * ry + 2]), index, table,
                offsets, res, max_mip);
            s.tau[cell] = smp.w * s.tau[cell];
            s.rgb[0][cell] = smp.x;
            s.rgb[1][cell] = smp.y;
            s.rgb[2][cell] = smp.z;
        }
        __syncwarp();
        if (ray) {  // 3. the composite of the lane's ray, in sample order
            for (int k = 0; k < n; ++k) {
                const int cell = lane * kRow + k;
                const float tau = s.tau[cell];
                cs = cs + tau;
                const float weight = (1.0f - expf(-tau)) * (Tr * expf(-cs + tau));
                acc_r = acc_r + weight * s.rgb[0][cell];
                acc_g = acc_g + weight * s.rgb[1][cell];
                acc_b = acc_b + weight * s.rgb[2][cell];
                acc_d = acc_d + weight * s.ts[cell];
            }
            n_valid += __popc(s.vmask[lane]);
        }
        __syncwarp();
    }
    if (!ray) return;
    const float Tn = Tr * expf(-cs);
    T_new[r] = Tn;
    rgb_new[3 * r + 0] = rgb[3 * r + 0] + acc_r;
    rgb_new[3 * r + 1] = rgb[3 * r + 1] + acc_g;
    rgb_new[3 * r + 2] = rgb[3 * r + 2] + acc_b;
    depth_new[r] = depth[r] + acc_d;
    alive_new[r] = (alive[r] != 0) && Tn >= eps_t && t_exit[r] < tmax[r] && t_exit[r] > t[r];
    cost_new[r] = cost[r] + (float)n_valid;
}

}  // namespace

extern "C" int ngp_baked_round(const void* ts, const void* dts, const void* valid,
                               const void* t_exit, const void* o, const void* d, const void* t,
                               const void* tmax, const void* T, const void* rgb, const void* depth,
                               const void* alive, const void* cost, const void* index,
                               const void* table, const void* offsets, const void* res,
                               int max_mip, int R, int K, float eps_t, void* T_new, void* rgb_new,
                               void* depth_new, void* alive_new, void* cost_new, void* stream) {
    const int blocks = (R + kThreads - 1) / kThreads;
    baked_round_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(ts), static_cast<const float*>(dts),
        static_cast<const uint8_t*>(valid), static_cast<const float*>(t_exit),
        static_cast<const float*>(o), static_cast<const float*>(d), static_cast<const float*>(t),
        static_cast<const float*>(tmax), static_cast<const float*>(T),
        static_cast<const float*>(rgb), static_cast<const float*>(depth),
        static_cast<const uint8_t*>(alive), static_cast<const float*>(cost),
        static_cast<const int32_t*>(index), static_cast<const uint4*>(table),
        static_cast<const int32_t*>(offsets), static_cast<const int32_t*>(res), max_mip, R, K,
        eps_t, static_cast<float*>(T_new), static_cast<float*>(rgb_new),
        static_cast<float*>(depth_new), static_cast<uint8_t*>(alive_new),
        static_cast<float*>(cost_new));
    return (int)cudaGetLastError();
}
'''

# tweaks of RAY_LANE_PASS8: (name, [(text, replacement), ...])
RAY_LANE_TWEAKS = {
    # 2 warps a block, not 4
    "ray_lane_w2": [("constexpr int kWarps = 4;", "constexpr int kWarps = 2;")],
    # passes of 16 samples a ray (twice the shared memory a warp), 2 warps a block
    "ray_lane_pass16": [("constexpr int kWarps = 4;", "constexpr int kWarps = 2;"),
                        ("constexpr int kPass = 8; ", "constexpr int kPass = 16;"),
                        ("uint8_t vmask[32];", "uint16_t vmask[32];"),
                        ("s.vmask[ry] = (uint8_t)(", "s.vmask[ry] = (uint16_t)(")],
    # the composite's loop unrolled over the pass
    "ray_lane_unroll": [("            for (int k = 0; k < n; ++k) {\n                const int cell",
                         "#pragma unroll\n            for (int k = 0; k < kPass; ++k) {\n"
                         "                if (k >= n) break;\n                const int cell")],
    # at most 40 registers a thread (12 blocks an SM)
    "ray_lane_regs40": [("__launch_bounds__(kThreads) baked_round_kernel",
                         "__launch_bounds__(kThreads, 12) baked_round_kernel")],
    # passes of 4 samples: half the shared memory a warp
    "ray_lane_pass4": [("constexpr int kPass = 8; ", "constexpr int kPass = 4; ")],
    # passes of 4 samples and at most 40 registers a thread: 12 blocks an SM
    "ray_lane_pass4_regs40": [("constexpr int kPass = 8; ", "constexpr int kPass = 4; "),
                              ("__launch_bounds__(kThreads) baked_round_kernel",
                               "__launch_bounds__(kThreads, 12) baked_round_kernel")],
    # the ray's state read at the start, not after the passes
    "ray_lane_early": [("    const float Tr = ray ? T[r] : 0.0f;\n",
                        "    const float Tr = ray ? T[r] : 0.0f;\n"
                        "    float st[8] = {};\n"
                        "    uint8_t al = 0;\n"
                        "    if (ray) {\n"
                        "        st[0] = rgb[3 * r]; st[1] = rgb[3 * r + 1]; st[2] = rgb[3 * r + 2];\n"
                        "        st[3] = depth[r]; st[4] = t_exit[r]; st[5] = tmax[r]; st[6] = t[r];\n"
                        "        st[7] = cost[r]; al = alive[r];\n"
                        "    }\n"),
                       ("    rgb_new[3 * r + 0] = rgb[3 * r + 0] + acc_r;\n"
                        "    rgb_new[3 * r + 1] = rgb[3 * r + 1] + acc_g;\n"
                        "    rgb_new[3 * r + 2] = rgb[3 * r + 2] + acc_b;\n"
                        "    depth_new[r] = depth[r] + acc_d;\n"
                        "    alive_new[r] = (alive[r] != 0) && Tn >= eps_t && t_exit[r] < tmax[r] && t_exit[r] > t[r];\n"
                        "    cost_new[r] = cost[r] + (float)n_valid;\n",
                        "    rgb_new[3 * r + 0] = st[0] + acc_r;\n"
                        "    rgb_new[3 * r + 1] = st[1] + acc_g;\n"
                        "    rgb_new[3 * r + 2] = st[2] + acc_b;\n"
                        "    depth_new[r] = st[3] + acc_d;\n"
                        "    alive_new[r] = (al != 0) && Tn >= eps_t && st[4] < st[5] && st[4] > st[6];\n"
                        "    cost_new[r] = st[7] + (float)n_valid;\n")],
}
RAY_LANE_TWEAKS["ray_lane_pass4_early"] = (RAY_LANE_TWEAKS["ray_lane_pass4"]
                                           + RAY_LANE_TWEAKS["ray_lane_early"])
RAY_LANE_TWEAKS["ray_lane_pass2_early"] = (
    [("constexpr int kPass = 8; ", "constexpr int kPass = 2; ")]
    + RAY_LANE_TWEAKS["ray_lane_early"])

# (design, the text that makes its lookups, the same with no lookup)
NO_LOOKUP = {
    "half_warp": ("        if (v) {\n            s = ngp_baked::sample(",
                  "        if (false) {\n            s = ngp_baked::sample("),
    "kernel": ("for (int q = lane; q < n_list; q += 32)", "for (int q = lane; q < 0; q += 32)"),
    "ray_lane_pass8": ("for (int q = lane; q < n_list; q += 32)",
                       "for (int q = lane; q < 0; q += 32)"),
}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def variants() -> dict[str, str]:
    """{name: source}: this checkout's kernel, the half_warp design, the
    ray_lane design with passes of 8 and its tweaks, and the lookup-free
    ablations."""
    out = {"kernel": (CSRC / "baked_round.cu").read_text(), "half_warp": HALF_WARP,
           "ray_lane_pass8": RAY_LANE_PASS8}
    for name, subs in RAY_LANE_TWEAKS.items():
        src = RAY_LANE_PASS8
        for a, b in subs:
            if a not in src:
                raise RuntimeError(f"variant {name}: {a!r} is not in the source")
            src = src.replace(a, b)
        out[name] = src
    for name, (a, b) in NO_LOOKUP.items():
        if a not in out[name]:
            raise RuntimeError(f"variant {name}: its lookup is not where the ablation expects")
        out[f"{name}_no_lookup"] = out[name].replace(a, b)
    return out


def build(sources: dict[str, str], out: Path) -> dict:
    """Each variant's launcher, all nvcc runs at once: {name: (launcher,
    ptxas lines)}; a variant that does not build raises."""
    from instant_ngp_torch import cuda_lib

    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu, so = out / f"round_{name}.cu", out / f"libround_{name}.so"
        cu.write_text(text)
        cmd = [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(CSRC),
               "-shared", "-o", str(so), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stderr=subprocess.PIPE, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} did not build:\n{err[-3000:]}")
        fn = ctypes.CDLL(str(so)).ngp_baked_round
        fn.argtypes = cuda_lib.SIGNATURES[KERNEL]
        fn.restype = ctypes.c_int
        ptxas = [ln.strip() for ln in err.splitlines() if "registers" in ln or "spill" in ln]
        libs[name] = (fn, ptxas)
    return libs


def launcher(fn, args):
    """A call of one variant on ``baked.render_round``'s arguments."""
    import torch

    cache, o, d, ts, dts, valid, t, t_exit, T, rgb, depth, alive, tmax, cost, eps_t = args
    R, K = ts.shape

    def call():
        outs = (torch.empty_like(T), torch.empty_like(rgb), torch.empty_like(depth),
                torch.empty_like(alive), torch.empty_like(cost))
        err = fn(ts.data_ptr(), dts.data_ptr(), valid.data_ptr(), t_exit.data_ptr(), o.data_ptr(),
                 d.data_ptr(), t.data_ptr(), tmax.data_ptr(), T.data_ptr(), rgb.data_ptr(),
                 depth.data_ptr(), alive.data_ptr(), cost.data_ptr(), cache.index.data_ptr(),
                 cache.table.data_ptr(), cache.offsets.data_ptr(), cache.res.data_ptr(),
                 cache.n_cascades - 1, R, K, eps_t, *(x.data_ptr() for x in outs),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"cudaError {err}")
        return (t_exit, *outs)
    return call


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--logs", type=Path, default=HERE / "build" / "round_variants", metavar="DIR")
    ap.add_argument("names", nargs="*")
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))
    import numpy as np
    import torch

    from instant_ngp_torch.nerf import baked
    from instant_ngp_torch.testbed import Testbed

    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: this benchmark needs an NVIDIA GPU")
    cs = _chip_smoke()
    _, card = cs.phase_device()
    sources = variants()
    if args.names:
        sources = {k: sources[k] for k in args.names}
    libs = build(sources, args.logs)
    dev = torch.device("cuda")
    tb = Testbed("nerf", device=dev)
    tb.load_snapshot(cs.SNAPSHOT)
    task = tb.task
    cache = task._get_baked(origin=np.asarray(task.dataset.xforms_start[0], np.float32)[:, 3])
    o, d, tmin, tmax = cs.middle_chunk_rays(task, cs.RENDER_WH, dev)
    inputs = {"first_round": cs.first_round(task, cache, o, d, tmin, tmax),
              "second_round": cs.baked_round_at(task, cache, o, d, tmin, tmax, 1)[1]}
    refs = {k: baked.render_round_plain(*a) for k, a in inputs.items()}
    kernel_out = {k: launcher(libs["kernel"][0], a)() for k, a in inputs.items()} \
        if "kernel" in libs else None

    order = list(libs) + list(reversed(list(libs)))
    rounds = {name: {k: [] for k in inputs} for name in libs}
    for name in order:
        fn, _ = libs[name]
        for k, a in inputs.items():
            call = launcher(fn, a)
            rounds[name][k].append(cs.device_split(call, KERNEL, reps=REPS, per_call=1)["kernel_ms"])
    results = {}
    for name, (fn, ptxas) in libs.items():
        v = {"ptxas": ptxas}
        for k, a in inputs.items():
            out = launcher(fn, a)()
            ref = refs[k]
            v[k] = {"rays": a[3].shape[0], "kernel_ms": sum(rounds[name][k]) / len(rounds[name][k]),
                    "rounds": rounds[name][k]}
            if not name.endswith("_no_lookup"):
                v[k]["alive_equal"] = bool(torch.equal(out[4], ref[4]))
                v[k]["max_abs_err"] = max(float((x.float() - y.float()).abs().max())
                                          for x, y in zip(out, ref))
                v[k]["within_tol"] = v[k]["alive_equal"] and v[k]["max_abs_err"] <= cs.TOL_COMPOSITE
                if kernel_out is not None:
                    v[k]["kernel_bit_equal"] = all(torch.equal(x, y)
                                                   for x, y in zip(out, kernel_out[k]))
        results[name] = v
        print(json.dumps({"variant": name, **v}), flush=True)
    print(card)
    (args.logs / "variants.json").write_text(json.dumps({"card": card, "variants": results},
                                                        indent=1))


if __name__ == "__main__":
    main()
