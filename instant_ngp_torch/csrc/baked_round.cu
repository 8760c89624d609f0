// The baked round: one launch a round of the baked render, after the march.
//
// Replaces the rest of instant_ngp_tpu/nerf/task.py::NerfTask.
// _render_round_baked (task.py:1820-1838) once kernel C has marched the
// window: each sample's position, its baked lookup (baked.py::query) and the
// activated composite (_composite_window(activated=True), task.py:1853).
// Plain version: instant_ngp_torch/nerf/baked.py::render_round_plain, which
// is common.fma -> query_plain -> composite_window_plain(activated=True).
//
// Per sample k of a ray, in the plain version's arithmetic:
//   - the position o + ts_k * d as common.fma computes it: the f64 product
//     and sum, rounded once to f32 (bit for bit; a hardware f32 FMA could
//     differ in the last bit, and at a cell face that picks another row);
//   - kernel N's lookup, ngp_baked::sample (csrc/baked.cuh), bit for bit;
//   - kernel D's activated composite: tau = sigma * dt, the running sum of
//     tau taken sample after sample in f32 (a dense sample's tau ~ 1e3
//     leaves only the sum's last bits in the weight's exponent, so the
//     order is kept: a one-ulp change moves a weight by ~1e-4 of itself),
//     the weight (1 - e^-tau) * T * e^(-cs + tau), and the weighted rgb and
//     depth sums taken in sample order. So the round equals kernel D's old
//     loop on N's output bit for bit; against the plain version (whose
//     sums of rgb, depth and the final tau go through torch.sum) it is held
//     within chip_smoke.TOL_COMPOSITE, the alive flags equal.
// An invalid sample makes no lookup: its tau is 0 * dt and its row zero, so
// its weight is 0 and it adds nothing, as in the plain version, where the
// zero weight multiplies a finite row.
//
// What bounds it on an H100: bytes. A round reads ts, dts and valid (9 B a
// sample), the ray's o, d and state, 4 B for each distinct index entry and
// 64 B for each distinct row its valid samples touch, and writes the state:
// ~64 MB at the 1080p baked frame's middle 2^18-ray chunk (K 16). Before
// this kernel the round wrote an (R*K, 3) positions tensor (through f64
// intermediates) and an (R, K, 4) window, and read both back.
//
// Design: a warp 32 rays, a lane a ray, the window in passes of kPass
// samples a ray. Each pass:
//   1. the warp stages the pass's ts, dts and valid in shared memory, a
//      lane an element (coalesced: a ray's samples are contiguous), and
//      lists its valid samples (a ballot a step);
//   2. the warp makes the listed samples' lookups, a lane a listed sample:
//      ceil(valid / 32) steps a pass, where a lane a sample of the pass
//      would take kPass (27 % of the samples are valid in the 1080p
//      frame's first round);
//   3. each lane composites its own ray's samples in order from shared
//      memory, kernel D's old loop, the running sum in a register carried
//      to the next pass (rows padded to kPass + 1 floats: no bank conflict).
// The ray's state is read at the start, so that its loads overlap the
// passes. Passes of 4 samples keep a warp's tile at 4.2 KB and the kernel
// at 56 registers, so that ~36 warps share an SM; on that first round
// (bench/round_variants.py) passes of 8 were 1.2x slower, of 2 1.1x, and
// a half-warp a ray with a lane a sample (its running sums formed in order
// from the half's 16 values), which makes every lookup step of the window,
// 2.0x slower.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "baked.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kPass = 4;         // samples a ray a pass
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
    // the ray's state, read now so that its loads overlap the passes
    float Tr = 0.0f, rgb_in[3] = {0.0f, 0.0f, 0.0f}, depth_in = 0.0f, cost_in = 0.0f;
    bool go_on = false;
    if (ray) {
        Tr = T[r];
        for (int c = 0; c < 3; ++c) rgb_in[c] = rgb[3 * r + c];
        depth_in = depth[r];
        cost_in = cost[r];
        go_on = alive[r] != 0 && t_exit[r] < tmax[r] && t_exit[r] > t[r];
    }
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
    rgb_new[3 * r + 0] = rgb_in[0] + acc_r;
    rgb_new[3 * r + 1] = rgb_in[1] + acc_g;
    rgb_new[3 * r + 2] = rgb_in[2] + acc_b;
    depth_new[r] = depth_in + acc_d;
    alive_new[r] = go_on && Tn >= eps_t;
    cost_new[r] = cost_in + (float)n_valid;
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
