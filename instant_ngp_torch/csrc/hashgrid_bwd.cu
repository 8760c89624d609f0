// Kernel E: hash-grid encode, backward: table gradients, in 2 or 3
// dimensions; and kernel K (at the end of this file): the position
// gradient d/dx.
//
// Replaces the table-gradient half of instant_ngp_tpu/ops/hashgrid.py::
// _hge_bwd (hashgrid.py:244-331): the stochastic-corner scatter on hashed
// levels, the sort-merge reduction of exact corners, and the bf16 matmul
// splat of dense levels (splat_dense), all as one f32 scatter-add here.
// Plain version: instant_ngp_torch/ops/hashgrid.py::hashgrid_encode_bwd_plain.
//
// What bounds it on an H100: each (sample, level) adds C (2^D d-linear, 4
// simplex, 1 nearest; k draws on a stochastic hashed level) rows of F
// floats into the gradient table (51 MB on fox, 257 MB on an 8192^2 image)
// with atomics. A few flops per row: the kernel is bound by its atomics.
// Two kinds of row-add cost differently. On the coarse levels a batch that
// is ordered in space (the image's stratified batch, row-major; the NeRF
// batch, the K samples of a ray in a row) sends many adds to the same few
// rows, and adds to one address serialize in L2: one thread per (sample,
// level) with f32 atomics took 3.2 ms on the image step, against 1.2 ms on
// random positions of the same levels. On the fine levels (a 134 MB level
// at 8192^2) the adds go to mostly distinct rows, each a read-modify-write
// of an L2 sector that is rarely cached: after aggregation these are what
// is left, and they bound the kernel.
//
// Design:
// - Level-major warps. A block is one level and 256 consecutive samples;
//   consecutive blocks take the levels in turn, so the blocks in flight
//   spread over all levels. A warp's 32 lanes are 32 consecutive samples at
//   one level, so on a spatially ordered batch neighbouring lanes land in
//   the same coarse cells.
// - Warp aggregation before the atomic. For each corner slot (or draw) the
//   lanes find their peers with the same row (__match_any_sync), sum the
//   peers' w·g over the peer mask with shuffles into the lowest peer, and
//   only that lane issues the add. Lanes past n take part in every warp
//   collective with a row no table has, and add nothing.
// - Vector atomics: a row of F = 2 or 4 is one float2/float4 atomicAdd
//   (sm_90, global memory), F = 8 two float4; rows start at offset·F floats,
//   which the wrapper checks to be 8- or 16-byte aligned.
// A thread recomputes its level's corners and weights exactly as kernel A
// does, then either adds w_c·g to every corner (exact), or, for 1 <= k < C
// draws on a hashed level, adds g/k to the corner picked by cumsum(w)_c <
// u·cdf[C-1] per draw. u is the JAX package's position-hash uniform plus the
// per-(level, draw) offset the host computes in f64, rounded to f32: the
// draw is the reference's draw bit for bit on the same x. Atomics and the
// warp sums make the sum order vary from run to run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 32;
constexpr int kMaxDraws = 8;
constexpr int kLinear = 0, kNearest = 1, kSimplex = 2;
constexpr int kThreads = 256;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr uint32_t kNoRow = 0xffffffffu;  // the row of a lane past n: sizes are < 2^31

struct LevelTable {
    float scale[kMaxLevels];
    uint32_t res[kMaxLevels];
    uint32_t size[kMaxLevels];
    uint32_t offset[kMaxLevels];
    int hashed[kMaxLevels];
    float draw_offset[kMaxLevels * kMaxDraws];
};

// corner of the cell at grid g offset by bit d of `bits` along axis d
template <int D>
__device__ __forceinline__ uint32_t corner_index(bool hashed, uint32_t res, uint32_t size,
                                                 const int g[D], int bits) {
    const uint32_t c0 = (uint32_t)(g[0] + (bits & 1));
    if constexpr (D == 1) {
        return c0 % size;  // the first prime is 1: hashed or not, the index is c0
    } else {
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
}

// Sums v over the lanes of the warp whose row equals this lane's, into the
// lowest of them, and returns true there. Every lane of the warp must call
// it. A tree over the peers' ranks: in round j, each peer of rank r with
// r % 2^(j+1) == 0 adds the value of the next peer still in the game.
template <int F>
__device__ __forceinline__ bool sum_over_peers(uint32_t row, float v[F]) {
    const int lane = threadIdx.x & 31;
    const unsigned below = (1u << lane) - 1u;
    unsigned peers = __match_any_sync(kFullMask, row);
    const bool leader = (peers & below) == 0u;
    int rank = __popc(peers & below);
    peers &= ~(below | (1u << lane));  // the peers above this lane
    while (__any_sync(kFullMask, peers != 0u)) {
        const int next = __ffs(peers);  // 1 + the lane of the next peer above; 0 if none
        const int src = next > 0 ? next - 1 : lane;
#pragma unroll
        for (int f = 0; f < F; ++f) {
            const float t = __shfl_sync(kFullMask, v[f], src);
            if (next > 0) v[f] += t;
        }
        peers &= __ballot_sync(kFullMask, (rank & 1) == 0);  // odd ranks have given theirs
        rank >>= 1;
    }
    return leader;
}

template <int F>
__device__ __forceinline__ void add_row(float* __restrict__ tab, uint32_t idx, const float v[F]) {
    float* p = tab + (size_t)idx * F;
    if constexpr (F == 1) {
        atomicAdd(p, v[0]);
    } else if constexpr (F == 2) {
        atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
    } else {
#pragma unroll
        for (int q = 0; q < F; q += 4)
            atomicAdd(reinterpret_cast<float4*>(p + q),
                      make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]));
    }
}

// One warp-aggregated add of v (scaled by w) to `row`; row kNoRow adds nothing.
template <int F>
__device__ __forceinline__ void warp_add(float* __restrict__ tab, uint32_t row, float w,
                                         const float g[F]) {
    float v[F];
#pragma unroll
    for (int f = 0; f < F; ++f) v[f] = w * g[f];
    if (sum_over_peers<F>(row, v) && row != kNoRow) add_row<F>(tab, row, v);
}

// uniform in [0, 1) from the bits of the position (hashgrid.py:273-279):
// the XOR of bits(x_d) times the prime after axis d's, times 0x9E3779B1
template <int D>
__device__ __forceinline__ float position_uniform(const float* __restrict__ xs) {
    const uint32_t primes[3] = {2654435761u, 805459861u, 3674653429u};
    uint32_t h = 0u;
#pragma unroll
    for (int d = 0; d < D; ++d) h = h ^ (__float_as_uint(xs[d]) * primes[d]);
    h = h * 0x9E3779B1u;
    return (float)(h >> 8) * 5.9604644775390625e-08f;  // 2^-24
}

template <int D, int F>
__global__ void __launch_bounds__(kThreads)
hashgrid_bwd_kernel(const float* __restrict__ x, const float* __restrict__ g, LevelTable lv,
                    int n_levels, int interp, int n_draws, float g_scale, long long n,
                    float* __restrict__ dtable) {
    constexpr int kC = 1 << D;
    const int l = (int)(blockIdx.x % (unsigned)n_levels);
    const long long s = (long long)(blockIdx.x / (unsigned)n_levels) * kThreads + threadIdx.x;
    // lanes past n stay for the warp collectives: position 0, cotangent 0, no row
    const bool valid = s < n;
    const long long sc = valid ? s : 0;
    const float scale = lv.scale[l];
    const uint32_t res = lv.res[l], size = lv.size[l];
    const bool hashed = lv.hashed[l] != 0;
    float* __restrict__ tab = dtable + (size_t)lv.offset[l] * F;

    float gl[F];
    const float* gp = g + sc * ((long long)n_levels * F) + (long long)l * F;
#pragma unroll
    for (int f = 0; f < F; ++f) gl[f] = valid ? gp[f] : 0.0f;

    float t[D];
    int gr[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
        const float p = fmaf(x[sc * D + d], scale, 0.5f);
        const float fl = floorf(p);
        t[d] = p - fl;
        gr[d] = (int)fl;
    }

    if (interp == kNearest) {
        int bits = 0;
#pragma unroll
        for (int d = 0; d < D; ++d) bits |= (int)rintf(t[d]) << d;
        const uint32_t row = valid ? corner_index<D>(hashed, res, size, gr, bits) : kNoRow;
        warp_add<F>(tab, row, 1.0f, gl);
        return;
    }
    uint32_t idx[kC > 4 ? kC : 4];
    float w[kC > 4 ? kC : 4];
    int C;
    if (D == 3 && interp == kSimplex && hashed) {
        // runs at D = 3 only, where t[D - 1] is t[2]
        int amax = 0, amin = 0;
        if (t[1 % D] > t[amax]) amax = 1;
        if (t[D - 1] > t[amax]) amax = 2;
        if (t[1 % D] < t[amin]) amin = 1;
        if (t[D - 1] < t[amin]) amin = 2;
        if (amin == amax) amin = (amax + 1) % 3;
        const float t_max = fmaxf(fmaxf(t[0], t[1 % D]), t[D - 1]);
        const float t_min = fminf(fminf(t[0], t[1 % D]), t[D - 1]);
        const float t_mid = ((t[0] + t[1 % D]) + t[D - 1]) - t_max - t_min;
        w[0] = 1.0f - t_max; w[1] = t_max - t_mid; w[2] = t_mid - t_min; w[3] = t_min;
        // corners 000, e_max, 1 - e_min, 111
        idx[0] = corner_index<D>(hashed, res, size, gr, 0);
        idx[1] = corner_index<D>(hashed, res, size, gr, 1 << amax);
        idx[2] = corner_index<D>(hashed, res, size, gr, 7 ^ (1 << amin));
        idx[3] = corner_index<D>(hashed, res, size, gr, 7);
        C = 4;
    } else {
#pragma unroll
        for (int c = 0; c < kC; ++c) {
            float wc = (c & 1) ? t[0] : 1.0f - t[0];
#pragma unroll
            for (int d = 1; d < D; ++d) wc = wc * (((c >> d) & 1) ? t[d] : 1.0f - t[d]);
            w[c] = wc;
            idx[c] = corner_index<D>(hashed, res, size, gr, c);
        }
        C = kC;
    }
    // C and the branch below are the same for the whole warp: one level

    if (hashed && n_draws >= 1 && n_draws < C) {
        // stochastic corners (hashgrid.py:283-309): k draws of g/k each
        float cdf[kC > 4 ? kC : 4];
        float acc = 0.0f;
        for (int c = 0; c < C; ++c) {
            acc = acc + w[c];
            cdf[c] = acc;
        }
        float gk[F];
#pragma unroll
        for (int f = 0; f < F; ++f) gk[f] = gl[f] * g_scale;
        const float u = position_uniform<D>(x + sc * D);
        for (int k = 0; k < n_draws; ++k) {
            const float u_l = fmodf(u + lv.draw_offset[l * kMaxDraws + k], 1.0f);
            const float thr = u_l * cdf[C - 1];
            int c_sel = 0;
            for (int c = 0; c < C; ++c) c_sel += cdf[c] < thr ? 1 : 0;
            c_sel = c_sel > C - 1 ? C - 1 : c_sel;
            warp_add<F>(tab, valid ? idx[c_sel] : kNoRow, 1.0f, gk);
        }
        return;
    }
    for (int c = 0; c < C; ++c) warp_add<F>(tab, valid ? idx[c] : kNoRow, w[c], gl);
}

template <int D>
int launch_bwd(const float* xp, const float* gp, const LevelTable& lv, int n_levels,
               int n_features, int interp, int n_draws, float g_scale, long long n, float* dp,
               cudaStream_t st) {
    const long long chunks = (n + kThreads - 1) / kThreads;
    if (chunks * n_levels > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const unsigned blocks = (unsigned)(chunks * n_levels);
    switch (n_features) {
        case 1: hashgrid_bwd_kernel<D, 1><<<blocks, kThreads, 0, st>>>(xp, gp, lv, n_levels, interp, n_draws, g_scale, n, dp); break;
        case 2: hashgrid_bwd_kernel<D, 2><<<blocks, kThreads, 0, st>>>(xp, gp, lv, n_levels, interp, n_draws, g_scale, n, dp); break;
        case 4: hashgrid_bwd_kernel<D, 4><<<blocks, kThreads, 0, st>>>(xp, gp, lv, n_levels, interp, n_draws, g_scale, n, dp); break;
        case 8: hashgrid_bwd_kernel<D, 8><<<blocks, kThreads, 0, st>>>(xp, gp, lv, n_levels, interp, n_draws, g_scale, n, dp); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Kernel K: hash-grid encode, backward: the analytic position gradient d/dx.
//
// Replaces the d/dx half of instant_ngp_tpu/ops/hashgrid.py::_hge_bwd
// (hashgrid.py:333-373, tcnn's dy_dx): per level, gf_c = g · f_c (the
// cotangent against corner c's feature row), then
//   d-linear: dx_d += (Σ_c gf_c · sign_d(c) · Π_{d'≠d} a_{d'}) · scale
//   simplex (hashed 3-D levels): dx_d += (gf1−gf0, gf3−gf2 or gf2−gf1, as
//             axis d holds the largest, smallest or middle fraction) · scale
//   nearest: nothing (dt/dx = 0).
// Plain version: instant_ngp_torch/ops/hashgrid.py::hashgrid_encode_dx_plain.
// It runs where the SDF render takes its analytic normals, on the hit
// positions of a frame.
//
// What bounds it on an H100: each (sample, level) reads 2^D (or 4) random
// corner rows of F floats, as kernel A does, and a few dozen flops; it is
// bound by its dependent gathers, and its byte bound counts x, g, the
// distinct rows read and dx written.
//
// Design: a thread a sample walks the levels in order from level 0, so dx
// accumulates in the JAX package's order without a reduction; the corners
// go c = 0 … 2^D−1, each gf_c an f-ordered dot, and the product over d' in
// increasing d'. Corner indices, weights and the simplex rank masks are
// computed as kernel E computes them (ties: the first index is the max, the
// first the min, and amin = (amax + 1) % 3 where they coincide). The forward
// keeps no residuals, so the corner rows are gathered again; the tables do
// not change between forward and backward. With -fmad=false K equals its
// plain version bit for bit.

template <int D, int F>
__global__ void __launch_bounds__(kThreads)
hashgrid_dx_kernel(const float* __restrict__ x, const float* __restrict__ table,
                   const float* __restrict__ g, LevelTable lv, int n_levels, int interp,
                   long long n, float* __restrict__ dx) {
    constexpr int kC = 1 << D;
    const long long s = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (s >= n) return;
    float xs[D], acc[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
        xs[d] = x[s * D + d];
        acc[d] = 0.0f;
    }
    const float* __restrict__ gs = g + s * ((long long)n_levels * F);
    if (interp != kNearest) {
        for (int l = 0; l < n_levels; ++l) {
            const float scale = lv.scale[l];
            const uint32_t res = lv.res[l], size = lv.size[l];
            const bool hashed = lv.hashed[l] != 0;
            const float* __restrict__ tab = table + (size_t)lv.offset[l] * F;
            float gl[F];
#pragma unroll
            for (int f = 0; f < F; ++f) gl[f] = gs[l * F + f];
            float t[D];
            int gr[D];
#pragma unroll
            for (int d = 0; d < D; ++d) {
                const float p = fmaf(xs[d], scale, 0.5f);
                const float fl = floorf(p);
                t[d] = p - fl;
                gr[d] = (int)fl;
            }
            if (D == 3 && interp == kSimplex && hashed) {
                int amax = 0, amin = 0;
                if (t[1] > t[amax]) amax = 1;
                if (t[D - 1] > t[amax]) amax = 2;
                if (t[1] < t[amin]) amin = 1;
                if (t[D - 1] < t[amin]) amin = 2;
                if (amin == amax) amin = (amax + 1) % 3;
                const int bits[4] = {0, 1 << amax, 7 ^ (1 << amin), 7};
                float gf[4];
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    const uint32_t idx = corner_index<D>(hashed, res, size, gr, bits[c]);
                    const float* row = tab + (size_t)idx * F;
                    float v = gl[0] * __ldg(row);
#pragma unroll
                    for (int f = 1; f < F; ++f) v = v + gl[f] * __ldg(row + f);
                    gf[c] = v;
                }
#pragma unroll
                for (int d = 0; d < D; ++d) {
                    const float dt = d == amax ? gf[1] - gf[0] : d == amin ? gf[3] - gf[2]
                                                                           : gf[2] - gf[1];
                    acc[d] = acc[d] + dt * scale;
                }
                continue;
            }
            float gf[kC];
#pragma unroll
            for (int c = 0; c < kC; ++c) {
                const float* row = tab + (size_t)corner_index<D>(hashed, res, size, gr, c) * F;
                float v = gl[0] * __ldg(row);
#pragma unroll
                for (int f = 1; f < F; ++f) v = v + gl[f] * __ldg(row + f);
                gf[c] = v;
            }
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
                acc[d] = acc[d] + col * scale;
            }
        }
    }
#pragma unroll
    for (int d = 0; d < D; ++d) dx[s * D + d] = acc[d];
}

template <int D>
int launch_dx(const float* xp, const float* tp, const float* gp, const LevelTable& lv,
              int n_levels, int n_features, int interp, long long n, float* dxp,
              cudaStream_t st) {
    const long long blocks_ll = (n + kThreads - 1) / kThreads;
    if (blocks_ll > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const unsigned blocks = (unsigned)blocks_ll;
    switch (n_features) {
        case 1: hashgrid_dx_kernel<D, 1><<<blocks, kThreads, 0, st>>>(xp, tp, gp, lv, n_levels, interp, n, dxp); break;
        case 2: hashgrid_dx_kernel<D, 2><<<blocks, kThreads, 0, st>>>(xp, tp, gp, lv, n_levels, interp, n, dxp); break;
        case 4: hashgrid_dx_kernel<D, 4><<<blocks, kThreads, 0, st>>>(xp, tp, gp, lv, n_levels, interp, n, dxp); break;
        case 8: hashgrid_dx_kernel<D, 8><<<blocks, kThreads, 0, st>>>(xp, tp, gp, lv, n_levels, interp, n, dxp); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ngp_hashgrid_encode_bwd(const void* x, const void* g, const void* scale,
                                       const void* res, const void* size, const void* offset,
                                       const void* hashed, int n_dims, int n_levels,
                                       int n_features, int interp, int n_draws,
                                       const void* draw_offset, float g_scale, long long n,
                                       void* dtable, void* stream) {
    if (n_levels < 1 || n_levels > kMaxLevels) return (int)cudaErrorInvalidValue;
    LevelTable lv;
    for (int l = 0; l < n_levels; ++l) {
        lv.scale[l] = static_cast<const float*>(scale)[l];
        lv.res[l] = (uint32_t) static_cast<const int*>(res)[l];
        lv.size[l] = (uint32_t) static_cast<const int*>(size)[l];
        lv.offset[l] = (uint32_t) static_cast<const int*>(offset)[l];
        lv.hashed[l] = static_cast<const int*>(hashed)[l];
        for (int k = 0; k < kMaxDraws; ++k)
            lv.draw_offset[l * kMaxDraws + k] = static_cast<const float*>(draw_offset)[l * kMaxDraws + k];
    }
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* xp = static_cast<const float*>(x);
    const float* gp = static_cast<const float*>(g);
    float* dp = static_cast<float*>(dtable);
    switch (n_dims) {
        case 1: return launch_bwd<1>(xp, gp, lv, n_levels, n_features, interp, n_draws, g_scale, n, dp, st);
        case 2: return launch_bwd<2>(xp, gp, lv, n_levels, n_features, interp, n_draws, g_scale, n, dp, st);
        case 3: return launch_bwd<3>(xp, gp, lv, n_levels, n_features, interp, n_draws, g_scale, n, dp, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

// Kernel K's launcher: x (n, D), the flat table (rows, F), g (n, L·F), the
// level arrays (host), dx (n, D) out.
extern "C" int ngp_hashgrid_encode_dx(const void* x, const void* table, const void* g,
                                      const void* scale, const void* res, const void* size,
                                      const void* offset, const void* hashed, int n_dims,
                                      int n_levels, int n_features, int interp, long long n,
                                      void* dx, void* stream) {
    if (n_levels < 1 || n_levels > kMaxLevels) return (int)cudaErrorInvalidValue;
    LevelTable lv{};  // K reads no draw offsets
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
    const float* gp = static_cast<const float*>(g);
    float* dxp = static_cast<float*>(dx);
    switch (n_dims) {
        case 2: return launch_dx<2>(xp, tp, gp, lv, n_levels, n_features, interp, n, dxp, st);
        case 3: return launch_dx<3>(xp, tp, gp, lv, n_levels, n_features, interp, n, dxp, st);
        default: return (int)cudaErrorInvalidValue;
    }
}
