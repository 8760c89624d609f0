// Kernel A: hash-grid encode, forward.
//
// Replaces instant_ngp_tpu/ops/hashgrid.py::_encode_fwd_impl (per-level
// math in _corner_setup, _corner_index, _simplex_corners, _level_corners).
// Plain version: instant_ngp_torch/ops/hashgrid.py::hashgrid_encode_plain.
//
// What bounds it on an H100: each (sample, level) reads 4 (simplex) or 8
// (trilinear) random table rows of F floats (16 bytes at F = 4) from a
// table of 51 MB on the fox model, which nearly fits the 50 MB L2. The
// arithmetic is a few dozen flops per row, so the kernel waits on
// dependent gathers: it is latency-bound, not bandwidth-bound.
//
// Simple design: one thread per (sample, level), consecutive threads on
// consecutive levels of one sample, so a warp's position loads broadcast
// and its output writes are contiguous. A thread computes its corners,
// issues all its row loads (one 16-byte load per row at F = 4) and sums
// them in corner order. The levels' (scale, resolution, size, offset,
// hashed) travel as a kernel parameter struct, i.e. in constant memory.
//
// Index arithmetic is bit-exact with the JAX package: uint32 multiply and
// XOR with the tcnn primes, then % size (size is not a power of two on
// dense levels). x * scale + 0.5 is one fmaf, as the reference's compiled
// code contracts it; the library is built with -fmad=false so no other
// expression is contracted. Simplex applies to hashed levels only, with
// argmax/argmin taking the first index and amin = (amax + 1) % 3 on ties.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 32;
constexpr int kLinear = 0, kNearest = 1, kSimplex = 2;

struct LevelTable {
    float scale[kMaxLevels];
    uint32_t res[kMaxLevels];
    uint32_t size[kMaxLevels];
    uint32_t offset[kMaxLevels];
    int hashed[kMaxLevels];
};

__device__ __forceinline__ uint32_t corner_index(bool hashed, uint32_t res, uint32_t size,
                                                 const int g[3], int b0, int b1, int b2) {
    const uint32_t c0 = (uint32_t)(g[0] + b0);
    const uint32_t c1 = (uint32_t)(g[1] + b1);
    const uint32_t c2 = (uint32_t)(g[2] + b2);
    uint32_t idx;
    if (hashed) {
        idx = (c0 * 1u) ^ (c1 * 2654435761u) ^ (c2 * 805459861u);
    } else {
        idx = c0 + c1 * res + c2 * (res * res);
    }
    return idx % size;
}

template <int F>
struct Row {
    float v[F];
};

template <int F>
__device__ __forceinline__ Row<F> load_row(const float* __restrict__ tab, uint32_t idx) {
    Row<F> r;
    const float* p = tab + (size_t)idx * F;
    if constexpr (F == 4) {
        const float4 q = __ldg(reinterpret_cast<const float4*>(p));
        r.v[0] = q.x; r.v[1] = q.y; r.v[2] = q.z; r.v[3] = q.w;
    } else if constexpr (F == 2) {
        const float2 q = __ldg(reinterpret_cast<const float2*>(p));
        r.v[0] = q.x; r.v[1] = q.y;
    } else {
#pragma unroll
        for (int f = 0; f < F; ++f) r.v[f] = __ldg(p + f);
    }
    return r;
}

template <int F>
__global__ void hashgrid_encode_kernel(const float* __restrict__ x, const float* __restrict__ table,
                                       LevelTable lv, int n_levels, int interp, long long n,
                                       float* __restrict__ out) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n * n_levels) return;
    const long long s = i / n_levels;
    const int l = (int)(i - s * n_levels);
    const float scale = lv.scale[l];
    const uint32_t res = lv.res[l], size = lv.size[l];
    const bool hashed = lv.hashed[l] != 0;
    const float* __restrict__ tab = table + (size_t)lv.offset[l] * F;

    float t[3];
    int g[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
        const float p = fmaf(x[s * 3 + d], scale, 0.5f);
        const float fl = floorf(p);
        t[d] = p - fl;
        g[d] = (int)fl;
    }

    float acc[F];
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = 0.0f;

    if (interp == kNearest) {
        const Row<F> r = load_row<F>(tab, corner_index(hashed, res, size, g, (int)rintf(t[0]),
                                                       (int)rintf(t[1]), (int)rintf(t[2])));
#pragma unroll
        for (int f = 0; f < F; ++f) acc[f] = r.v[f];
    } else if (interp == kSimplex && hashed) {
        int amax = 0, amin = 0;
        if (t[1] > t[amax]) amax = 1;
        if (t[2] > t[amax]) amax = 2;
        if (t[1] < t[amin]) amin = 1;
        if (t[2] < t[amin]) amin = 2;
        if (amin == amax) amin = (amax + 1) % 3;
        const float t_max = fmaxf(fmaxf(t[0], t[1]), t[2]);
        const float t_min = fminf(fminf(t[0], t[1]), t[2]);
        const float t_mid = ((t[0] + t[1]) + t[2]) - t_max - t_min;
        const float w[4] = {1.0f - t_max, t_max - t_mid, t_mid - t_min, t_min};
        // corners 000, e_max, 1 - e_min, 111
        const uint32_t idx[4] = {
            corner_index(hashed, res, size, g, 0, 0, 0),
            corner_index(hashed, res, size, g, amax == 0, amax == 1, amax == 2),
            corner_index(hashed, res, size, g, amin != 0, amin != 1, amin != 2),
            corner_index(hashed, res, size, g, 1, 1, 1),
        };
        Row<F> rows[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) rows[c] = load_row<F>(tab, idx[c]);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
#pragma unroll
            for (int f = 0; f < F; ++f) acc[f] = acc[f] + w[c] * rows[c].v[f];
        }
    } else {
        Row<F> rows[8];
        float w[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
            const int b0 = c & 1, b1 = (c >> 1) & 1, b2 = (c >> 2) & 1;
            w[c] = ((b0 ? t[0] : 1.0f - t[0]) * (b1 ? t[1] : 1.0f - t[1])) * (b2 ? t[2] : 1.0f - t[2]);
            rows[c] = load_row<F>(tab, corner_index(hashed, res, size, g, b0, b1, b2));
        }
#pragma unroll
        for (int c = 0; c < 8; ++c) {
#pragma unroll
            for (int f = 0; f < F; ++f) acc[f] = acc[f] + w[c] * rows[c].v[f];
        }
    }
    float* __restrict__ o = out + s * ((long long)n_levels * F) + (long long)l * F;
#pragma unroll
    for (int f = 0; f < F; ++f) o[f] = acc[f];
}

}  // namespace

extern "C" int ngp_hashgrid_encode_fwd(const void* x, const void* table, const void* scale,
                                       const void* res, const void* size, const void* offset,
                                       const void* hashed, int n_levels, int n_features,
                                       int interp, long long n, void* out, void* stream) {
    if (n_levels < 1 || n_levels > kMaxLevels) return (int)cudaErrorInvalidValue;
    LevelTable lv;
    for (int l = 0; l < n_levels; ++l) {
        lv.scale[l] = static_cast<const float*>(scale)[l];
        lv.res[l] = (uint32_t) static_cast<const int*>(res)[l];
        lv.size[l] = (uint32_t) static_cast<const int*>(size)[l];
        lv.offset[l] = (uint32_t) static_cast<const int*>(offset)[l];
        lv.hashed[l] = static_cast<const int*>(hashed)[l];
    }
    const int threads = 256;
    const long long total = n * n_levels;
    const unsigned blocks = (unsigned)((total + threads - 1) / threads);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* xp = static_cast<const float*>(x);
    const float* tp = static_cast<const float*>(table);
    float* op = static_cast<float*>(out);
    switch (n_features) {
        case 1: hashgrid_encode_kernel<1><<<blocks, threads, 0, st>>>(xp, tp, lv, n_levels, interp, n, op); break;
        case 2: hashgrid_encode_kernel<2><<<blocks, threads, 0, st>>>(xp, tp, lv, n_levels, interp, n, op); break;
        case 4: hashgrid_encode_kernel<4><<<blocks, threads, 0, st>>>(xp, tp, lv, n_levels, interp, n, op); break;
        case 8: hashgrid_encode_kernel<8><<<blocks, threads, 0, st>>>(xp, tp, lv, n_levels, interp, n, op); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
