// Kernel A: hash-grid encode, forward, in 2 or 3 dimensions.
//
// Replaces instant_ngp_tpu/ops/hashgrid.py::_encode_fwd_impl (per-level
// math in _corner_setup, _corner_index, _simplex_corners, _level_corners).
// Plain version: instant_ngp_torch/ops/hashgrid.py::hashgrid_encode_plain.
//
// What bounds it on an H100: each (sample, level) reads 2^D (d-linear),
// 4 (simplex) or 1 (nearest) random table rows of F floats from a table
// of 51 MB on the fox model, which nearly fits the 50 MB L2, and of
// 257 MB on an 8192^2 image. The arithmetic is a few dozen flops per row,
// so the kernel waits on dependent gathers: it is latency-bound, not
// bandwidth-bound.
//
// Simple design: one thread per (sample, level), consecutive threads on
// consecutive levels of one sample, so a warp's position loads broadcast
// and its output writes are contiguous. A thread computes its corners,
// issues all its row loads (one 16-byte load per row at F = 4) and sums
// them in corner order. The levels' (scale, resolution, size, offset,
// hashed) travel as a kernel parameter struct, i.e. in constant memory.
// The dimension D is a template parameter: D = 3 for NeRF, D = 2 for the
// image primitive (4 corners, hash c0 ^ c1 * 2654435761, dense index
// c0 + c1 * res).
//
// Index arithmetic is bit-exact with the JAX package: uint32 multiply and
// XOR with the tcnn primes, then % size (size is not a power of two on
// dense levels). x * scale + 0.5 is one fmaf, as the reference's compiled
// code contracts it; the library is built with -fmad=false so no other
// expression is contracted. Simplex applies to hashed 3-D levels only,
// with argmax/argmin taking the first index and amin = (amax + 1) % 3 on
// ties.

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

// corner of the cell at grid g offset by bit d of `bits` along axis d
template <int D>
__device__ __forceinline__ uint32_t corner_index(bool hashed, uint32_t res, uint32_t size,
                                                 const int g[D], int bits) {
    const uint32_t c0 = (uint32_t)(g[0] + (bits & 1));
    const uint32_t c1 = (uint32_t)(g[1] + ((bits >> 1) & 1));
    uint32_t idx;
    if constexpr (D == 3) {
        const uint32_t c2 = (uint32_t)(g[2] + ((bits >> 2) & 1));
        idx = hashed ? (c0 * 1u) ^ (c1 * 2654435761u) ^ (c2 * 805459861u)
                     : c0 + c1 * res + c2 * (res * res);
    } else {
        idx = hashed ? (c0 * 1u) ^ (c1 * 2654435761u) : c0 + c1 * res;
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

template <int D, int F>
__global__ void hashgrid_encode_kernel(const float* __restrict__ x, const float* __restrict__ table,
                                       LevelTable lv, int n_levels, int interp, long long n,
                                       float* __restrict__ out) {
    constexpr int C = 1 << D;
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n * n_levels) return;
    const long long s = i / n_levels;
    const int l = (int)(i - s * n_levels);
    const float scale = lv.scale[l];
    const uint32_t res = lv.res[l], size = lv.size[l];
    const bool hashed = lv.hashed[l] != 0;
    const float* __restrict__ tab = table + (size_t)lv.offset[l] * F;

    float t[D];
    int g[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
        const float p = fmaf(x[s * D + d], scale, 0.5f);
        const float fl = floorf(p);
        t[d] = p - fl;
        g[d] = (int)fl;
    }

    float acc[F];
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = 0.0f;

    if (interp == kNearest) {
        int bits = 0;
#pragma unroll
        for (int d = 0; d < D; ++d) bits |= (int)rintf(t[d]) << d;
        const Row<F> r = load_row<F>(tab, corner_index<D>(hashed, res, size, g, bits));
#pragma unroll
        for (int f = 0; f < F; ++f) acc[f] = r.v[f];
    } else if (D == 3 && interp == kSimplex && hashed) {
        // runs at D = 3 only, where t[D - 1] is t[2]
        int amax = 0, amin = 0;
        if (t[1] > t[amax]) amax = 1;
        if (t[D - 1] > t[amax]) amax = 2;
        if (t[1] < t[amin]) amin = 1;
        if (t[D - 1] < t[amin]) amin = 2;
        if (amin == amax) amin = (amax + 1) % 3;
        const float t_max = fmaxf(fmaxf(t[0], t[1]), t[D - 1]);
        const float t_min = fminf(fminf(t[0], t[1]), t[D - 1]);
        const float t_mid = ((t[0] + t[1]) + t[D - 1]) - t_max - t_min;
        const float w[4] = {1.0f - t_max, t_max - t_mid, t_mid - t_min, t_min};
        // corners 000, e_max, 1 - e_min, 111
        const uint32_t idx[4] = {
            corner_index<D>(hashed, res, size, g, 0),
            corner_index<D>(hashed, res, size, g, 1 << amax),
            corner_index<D>(hashed, res, size, g, 7 ^ (1 << amin)),
            corner_index<D>(hashed, res, size, g, 7),
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
        Row<F> rows[C];
        float w[C];
#pragma unroll
        for (int c = 0; c < C; ++c) {
            float wc = (c & 1) ? t[0] : 1.0f - t[0];
#pragma unroll
            for (int d = 1; d < D; ++d) wc = wc * (((c >> d) & 1) ? t[d] : 1.0f - t[d]);
            w[c] = wc;
            rows[c] = load_row<F>(tab, corner_index<D>(hashed, res, size, g, c));
        }
#pragma unroll
        for (int c = 0; c < C; ++c) {
#pragma unroll
            for (int f = 0; f < F; ++f) acc[f] = acc[f] + w[c] * rows[c].v[f];
        }
    }
    float* __restrict__ o = out + s * ((long long)n_levels * F) + (long long)l * F;
#pragma unroll
    for (int f = 0; f < F; ++f) o[f] = acc[f];
}

template <int D>
int launch_encode(const float* xp, const float* tp, const LevelTable& lv, int n_levels,
                  int n_features, int interp, long long n, float* op, cudaStream_t st) {
    const int threads = 256;
    const long long total = n * n_levels;
    const unsigned blocks = (unsigned)((total + threads - 1) / threads);
    switch (n_features) {
        case 1: hashgrid_encode_kernel<D, 1><<<blocks, threads, 0, st>>>(xp, tp, lv, n_levels, interp, n, op); break;
        case 2: hashgrid_encode_kernel<D, 2><<<blocks, threads, 0, st>>>(xp, tp, lv, n_levels, interp, n, op); break;
        case 4: hashgrid_encode_kernel<D, 4><<<blocks, threads, 0, st>>>(xp, tp, lv, n_levels, interp, n, op); break;
        case 8: hashgrid_encode_kernel<D, 8><<<blocks, threads, 0, st>>>(xp, tp, lv, n_levels, interp, n, op); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ngp_hashgrid_encode_fwd(const void* x, const void* table, const void* scale,
                                       const void* res, const void* size, const void* offset,
                                       const void* hashed, int n_dims, int n_levels,
                                       int n_features, int interp, long long n, void* out,
                                       void* stream) {
    if (n_levels < 1 || n_levels > kMaxLevels) return (int)cudaErrorInvalidValue;
    LevelTable lv;
    for (int l = 0; l < n_levels; ++l) {
        lv.scale[l] = static_cast<const float*>(scale)[l];
        lv.res[l] = (uint32_t) static_cast<const int*>(res)[l];
        lv.size[l] = (uint32_t) static_cast<const int*>(size)[l];
        lv.offset[l] = (uint32_t) static_cast<const int*>(offset)[l];
        lv.hashed[l] = static_cast<const int*>(hashed)[l];
    }
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* xp = static_cast<const float*>(x);
    const float* tp = static_cast<const float*>(table);
    float* op = static_cast<float*>(out);
    switch (n_dims) {
        case 2: return launch_encode<2>(xp, tp, lv, n_levels, n_features, interp, n, op, st);
        case 3: return launch_encode<3>(xp, tp, lv, n_levels, n_features, interp, n, op, st);
        default: return (int)cudaErrorInvalidValue;
    }
}
