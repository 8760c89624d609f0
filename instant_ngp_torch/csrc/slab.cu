// Kernel O: the slab renderer's screen warp.
//
// Replaces instant_ngp_tpu/nerf/slab.py::_warp_composite (the per-pixel
// baseplane-to-screen warp of the swept layers and their front-to-back
// composite). Plain version: instant_ngp_torch/nerf/slab.py::
// warp_composite_plain, which this kernel follows operation for operation.
//
// Per pixel: the dominant-axis group of its direction (argmax |d| with the
// first axis winning ties, then the sign), and for each of the 2*nc - 1
// layers in composite order: the layer's baseplane plane coordinate and
// window from the group's tables, the pixel's (u, v) on that plane, one
// quad-packed bf16 row (the 2x2 texel neighbourhood, 4 x C channels), the
// bilinear sum, the empty layer (T = 1, the rest 0) outside the window, and
// the composite a-over-b (channel 3 is transmittance, the others add
// weighted by the front's T). Then the background, and the output layout
// [rgb, alpha, depth] or, with deferred-shading features (C > 5),
// [rgb, alpha, depth, T, features...].
//
// What bounds it on an H100: bytes. A pixel reads its direction (12 B) and
// one 4*C*2-byte row a layer (40 B at C 5, 64 B at C 8) from a table of
// 6 * B0^2 rows (6 * 1024^2 * 64 B = 403 MB at 1080p with features, far
// past L2), and writes (C + 1) * 4 B. The row reads are random in the
// table but neighbouring pixels read neighbouring rows.
//
// Design: one thread a pixel, its C channels in registers (C is a template
// parameter, 5 to 8), the arithmetic operation for operation the plain
// version's, so the two agree to the bit. The data moves in wide words:
//   - the quad row as vector loads, 16-byte words at C 6 and 8 (48 and
//     64 B), 8-byte words at C 5 and 7 (40 and 56 B), unpacked into bf16
//     values in registers (the wrapper requires the tables so aligned);
//   - the block's directions come in, and its outputs go out, through
//     shared memory as contiguous 16-byte words (4-byte words where the
//     block's span is not 16-byte aligned: a pixel-sharded slice, the last
//     block), where a thread a pixel would read 12 B and write 20-36 B at
//     a stride of its own.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // pixels a block
constexpr int kMaxOut = 9;     // output channels at C 8

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// the 4 * C bf16 values of a quad row as 2 * C 32-bit words, in vector loads
template <int C>
__device__ __forceinline__ void load_row(const uint16_t* row, uint32_t (&w)[2 * C]) {
    if constexpr (C % 2 == 0) {
        const uint4* p = reinterpret_cast<const uint4*>(row);
#pragma unroll
        for (int q = 0; q < C / 2; ++q) {
            const uint4 v = p[q];
            w[4 * q] = v.x;
            w[4 * q + 1] = v.y;
            w[4 * q + 2] = v.z;
            w[4 * q + 3] = v.w;
        }
    } else {
        const uint2* p = reinterpret_cast<const uint2*>(row);
#pragma unroll
        for (int q = 0; q < C; ++q) {
            const uint2 v = p[q];
            w[2 * q] = v.x;
            w[2 * q + 1] = v.y;
        }
    }
}

// the row's i-th bf16 value (i a compile-time constant after unrolling)
template <int C>
__device__ __forceinline__ float row_at(const uint32_t (&w)[2 * C], int i) {
    return (i & 1) ? bf16_hi(w[i >> 1]) : bf16_lo(w[i >> 1]);
}

// count floats from src to dst, by the block's threads: 16-byte words where
// both ends are 16-byte aligned and count is a multiple of 4, else floats
__device__ __forceinline__ void block_copy(float* dst, const float* src, int count) {
    if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) & 15) == 0 &&
        count % 4 == 0) {
        for (int q = threadIdx.x; q < count / 4; q += kThreads)
            reinterpret_cast<float4*>(dst)[q] = reinterpret_cast<const float4*>(src)[q];
    } else {
        for (int e = threadIdx.x; e < count; e += kThreads) dst[e] = src[e];
    }
}

template <int C>
__global__ void __launch_bounds__(kThreads) slab_warp_kernel(
    const float* __restrict__ dirs, long long N, float ex, float ey, float ez,
    const uint16_t* __restrict__ outer_pk, const uint16_t* __restrict__ l_pk,
    const float* __restrict__ zb_tab, const float* __restrict__ win_lo,
    const float* __restrict__ win_hi, const float* __restrict__ bg, int B0, int Bo, int nc,
    float* __restrict__ out) {
    constexpr int out_ch = C > 5 ? C + 1 : 5;
    __shared__ __align__(16) float s_io[kThreads * kMaxOut];  // directions in, outputs out
    const long long n0 = (long long)blockIdx.x * kThreads;
    const int nb = (int)min((long long)kThreads, N - n0);
    const int tid = threadIdx.x;
    block_copy(s_io, dirs + 3 * n0, 3 * nb);
    __syncthreads();
    float d0 = 0.0f, d1 = 0.0f, d2 = 0.0f;
    if (tid < nb) {
        d0 = s_io[3 * tid];
        d1 = s_io[3 * tid + 1];
        d2 = s_io[3 * tid + 2];
    }
    __syncthreads();  // s_io is the outputs' from here
    if (tid < nb) {
        const float a0 = fabsf(d0), a1 = fabsf(d1), a2 = fabsf(d2);
        const bool is0 = (a0 >= a1) && (a0 >= a2);
        const bool is1 = (!is0) && (a1 >= a2);
        const float d_a = is0 ? d0 : (is1 ? d1 : d2);
        const float du = is0 ? d1 : (is1 ? d2 : d0);
        const float dv = is0 ? d2 : (is1 ? d0 : d1);
        const float e_a = is0 ? ex : (is1 ? ey : ez);
        const float e_u = is0 ? ey : (is1 ? ez : ex);
        const float e_v = is0 ? ez : (is1 ? ex : ey);
        const int g = (is0 ? 0 : (is1 ? 2 : 4)) + (d_a < 0.0f ? 1 : 0);
        const int n_layers = 2 * nc - 1;
        const int mid = nc - 1;

        float acc[C];
        for (int li = 0; li < n_layers; ++li) {
            const uint16_t* pk;
            int B;
            long long row_base;
            if (li == mid) {
                pk = l_pk;
                B = B0;
                row_base = (long long)g * B0 * B0;
            } else {
                const int oi = li < mid ? li : li - 1;
                pk = outer_pk;
                B = Bo;
                row_base = ((long long)g * (n_layers - 1) + oi) * Bo * Bo;
            }
            const int t = g * n_layers + li;
            const float zb = zb_tab[t];
            const float lo0 = win_lo[2 * t], lo1 = win_lo[2 * t + 1];
            const float hi0 = win_hi[2 * t], hi1 = win_hi[2 * t + 1];
            const float s = (zb - e_a) / d_a;
            const float u = e_u + du * s;
            const float v = e_v + dv * s;
            const float fB = (float)B;
            const float ui = (u - lo0) / (hi0 - lo0) * fB - 0.5f;
            const float vi = (v - lo1) / (hi1 - lo1) * fB - 0.5f;
            const int i0 = min(max((int)floorf(ui), 0), B - 1);
            const int j0 = min(max((int)floorf(vi), 0), B - 1);
            const float fu = fminf(fmaxf(ui - (float)i0, 0.0f), 1.0f);
            const float fv = fminf(fmaxf(vi - (float)j0, 0.0f), 1.0f);
            const bool inside = ui >= -0.5f && ui <= fB - 0.5f && vi >= -0.5f && vi <= fB - 0.5f;
            float lay[C];
            if (inside) {
                uint32_t w[2 * C];
                load_row<C>(pk + (row_base + (long long)i0 * B + j0) * (4 * C), w);
                const float w00 = (1.0f - fu) * (1.0f - fv);
                const float w01 = (1.0f - fu) * fv;
                const float w10 = fu * (1.0f - fv);
                const float w11 = fu * fv;
#pragma unroll
                for (int c = 0; c < C; ++c) {
                    lay[c] = w00 * row_at<C>(w, c) + w01 * row_at<C>(w, C + c) +
                             w10 * row_at<C>(w, 2 * C + c) + w11 * row_at<C>(w, 3 * C + c);
                }
            } else {
#pragma unroll
                for (int c = 0; c < C; ++c) lay[c] = c == 3 ? 1.0f : 0.0f;
            }
            if (li == 0) {
#pragma unroll
                for (int c = 0; c < C; ++c) acc[c] = lay[c];
            } else {
                const float Ta = acc[3];
#pragma unroll
                for (int c = 0; c < C; ++c) acc[c] = c == 3 ? Ta * lay[3] : acc[c] + Ta * lay[c];
            }
        }
        const float bga = bg[3];
        float* o = s_io + tid * out_ch;
        o[0] = acc[0] + acc[3] * bg[0] * bga;
        o[1] = acc[1] + acc[3] * bg[1] * bga;
        o[2] = acc[2] + acc[3] * bg[2] * bga;
        o[3] = 1.0f - acc[3] * (1.0f - bga);
        o[4] = acc[4];
        if (C > 5) {
            o[5] = acc[3];
#pragma unroll
            for (int c = 5; c < C; ++c) o[c + 1] = acc[c];
        }
    }
    __syncthreads();
    block_copy(out + n0 * out_ch, s_io, nb * out_ch);
}

}  // namespace

extern "C" int ngp_slab_warp(const void* dirs, long long N, float ex, float ey, float ez,
                             const void* outer_pk, const void* l_pk, const void* zb_tab,
                             const void* win_lo, const void* win_hi, const void* bg, int B0,
                             int Bo, int nc, int C, void* out, void* stream) {
    const unsigned blocks = (unsigned)((N + kThreads - 1) / kThreads);
    auto s = static_cast<cudaStream_t>(stream);
    const auto* dp = static_cast<const float*>(dirs);
    const auto* opk = static_cast<const uint16_t*>(outer_pk);
    const auto* lpk = static_cast<const uint16_t*>(l_pk);
    const auto* zb = static_cast<const float*>(zb_tab);
    const auto* lo = static_cast<const float*>(win_lo);
    const auto* hi = static_cast<const float*>(win_hi);
    const auto* b = static_cast<const float*>(bg);
    auto* o = static_cast<float*>(out);
    switch (C) {
        case 5: slab_warp_kernel<5><<<blocks, kThreads, 0, s>>>(dp, N, ex, ey, ez, opk, lpk, zb, lo, hi, b, B0, Bo, nc, o); break;
        case 6: slab_warp_kernel<6><<<blocks, kThreads, 0, s>>>(dp, N, ex, ey, ez, opk, lpk, zb, lo, hi, b, B0, Bo, nc, o); break;
        case 7: slab_warp_kernel<7><<<blocks, kThreads, 0, s>>>(dp, N, ex, ey, ez, opk, lpk, zb, lo, hi, b, B0, Bo, nc, o); break;
        case 8: slab_warp_kernel<8><<<blocks, kThreads, 0, s>>>(dp, N, ex, ey, ez, opk, lpk, zb, lo, hi, b, B0, Bo, nc, o); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
