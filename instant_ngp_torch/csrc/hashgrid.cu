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
// bandwidth-bound, and what it can do is keep many row loads in flight
// and spend few instructions around them.
//
// Design: a block takes 32 consecutive samples and every level. Each warp
// takes one level at a time, so the level's constants are one broadcast
// read and its corner rows fall in one table region; each lane takes one
// sample and issues all its corner loads before the first sum. The
// positions come in once per block through shared memory, and the (32, L·F)
// output tile is staged in shared memory and written out with coalesced
// 16-byte stores (a level-major thread mapping would scatter the output
// rows). Registers are capped (__launch_bounds__) so that an SM holds 32
// warps at D = 3 and 64 at D = 2: the gathers need warps in flight. Two
// samples a lane, all their loads issued together, measured no faster at
// D = 2 and slower at D = 3, where 128 registers a thread halved the warps. The dimension D is a
// template parameter: D = 3 for NeRF, D = 2 for the image primitive (4
// corners, hash c0 ^ c1 * 2654435761, dense index c0 + c1 * res).
//
// Index arithmetic is bit-exact with the JAX package: uint32 multiply and
// XOR with the tcnn primes, then % size. The % is a mask where size is a
// power of two (every hashed level) and otherwise an exact multiply-shift
// by the invariant divisor: q = (t + ((v - t) >> 1)) >> shift with t =
// umulhi(v, magic), magic and shift computed on the host per level
// (ops/hashgrid.py::divisor_magic, checked against % on the CPU). x * scale
// + 0.5 is one fmaf, as the reference's compiled code contracts it; the
// library is built with -fmad=false so no other expression is contracted.
// Simplex applies to hashed 3-D levels only, with argmax/argmin taking the
// first index and amin = (amax + 1) % 3 on ties.
// Smoothstep (code 3) is the d-linear case with each axis' fraction f
// replaced by f·f·(3 − 2f) (the plain version's order: (f·f)·(3 − 2f)), in
// both modes; the stochastic mode draws from those weights.
//
// Stochastic-corner mode (the template flag kStochastic; entry
// ngp_hashgrid_encode_fwd_stochastic): the fast render's inference encode,
// replacing instant_ngp_tpu/ops/hashgrid.py::GridEncoding.encode_infer
// (stochastic_corner=True, bricks=None). Plain version:
// ops/hashgrid.py::hashgrid_encode_stochastic_plain. A hashed level with
// more than one corner loads ONE row, the first corner whose running sum of
// weights (f32, corner order) is not below u·(sum of all), and writes it as
// the level's features; nearest levels read their corner as above, and dense
// levels sum the corners' rows as a chain of FMAs from corner 0's product
// (the order of XLA's einsum on the CPU in the JAX package). u is
// made from the f32 bits of the sample's position (XOR of bits·prime[d+1],
// times 0x9E3779B1, top 24 bits · 2^-24) plus the level's offset
// l·0.6180339887 (f64, rounded to f32), mod 1 (fmodf, exact). Bound: the
// same dependent gathers, at 1 row for every hashed level in place of 4
// or 8, so the bytes fall to what the dense levels and the output need.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 32;
constexpr int kNearest = 1, kSimplex = 2, kSmoothstep = 3;  // interpolation codes; 0 is linear
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 32;  // samples per block, one a lane

struct LevelTable {
    float scale[kMaxLevels];
    uint32_t res[kMaxLevels];
    uint32_t size[kMaxLevels];
    uint32_t offset[kMaxLevels];
    uint32_t magic[kMaxLevels];  // 0: size is a power of two and % size is a mask
    uint32_t shift[kMaxLevels];
    int hashed[kMaxLevels];
};

// one level's constants; the level is warp-uniform
struct Level {
    float scale;
    uint32_t res, size, magic, shift;
    bool hashed;
    const float* tab;
};

__device__ __forceinline__ uint32_t mod_size(uint32_t v, const Level& lv) {
    if (lv.magic == 0) return v & (lv.size - 1u);
    const uint32_t t = __umulhi(v, lv.magic);
    const uint32_t q = (t + ((v - t) >> 1)) >> lv.shift;
    return v - q * lv.size;
}

// corner of the cell at grid g offset by bit d of `bits` along axis d
template <int D>
__device__ __forceinline__ uint32_t corner_index(const Level& lv, const int g[D], int bits) {
    const uint32_t c0 = (uint32_t)(g[0] + (bits & 1));
    if constexpr (D == 1) {
        return mod_size(c0, lv);
    } else {
    const uint32_t c1 = (uint32_t)(g[1] + ((bits >> 1) & 1));
    uint32_t idx;
    if constexpr (D == 3) {
        const uint32_t c2 = (uint32_t)(g[2] + ((bits >> 2) & 1));
        idx = lv.hashed ? (c0 * 1u) ^ (c1 * 2654435761u) ^ (c2 * 805459861u)
                        : c0 + c1 * lv.res + c2 * (lv.res * lv.res);
    } else {
        idx = lv.hashed ? (c0 * 1u) ^ (c1 * 2654435761u) : c0 + c1 * lv.res;
    }
    return mod_size(idx, lv);
    }
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

// the first corner whose running weight sum is not below u·(sum of all),
// clamped to the last: JAX's sum(cumsum(w) < u·cumsum(w)[-1])
template <int C>
__device__ __forceinline__ int pick_corner(const float (&w)[C], float u) {
    float cdf[C];
    cdf[0] = w[0];
#pragma unroll
    for (int c = 1; c < C; ++c) cdf[c] = cdf[c - 1] + w[c];
    const float thr = u * cdf[C - 1];
    int sel = 0;
#pragma unroll
    for (int c = 0; c < C; ++c) sel += cdf[c] < thr ? 1 : 0;
    return sel < C - 1 ? sel : C - 1;
}

// the encoding of one position at one level: every corner row load is
// issued before the first sum. kStochastic: a hashed level loads the one
// corner pick_corner draws with the level's uniform u.
template <int D, int F, bool kStochastic = false>
__device__ __forceinline__ void encode_level(const Level& lv, int interp, const float (&pos)[D],
                                             float u, float (&acc)[F]) {
    constexpr int C = 1 << D;
    float t[D];
    int g[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
        const float p = fmaf(pos[d], lv.scale, 0.5f);
        const float fl = floorf(p);
        t[d] = p - fl;
        g[d] = (int)fl;
        if (interp == kSmoothstep) t[d] = (t[d] * t[d]) * (3.0f - 2.0f * t[d]);
    }
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = 0.0f;

    if (interp == kNearest) {
        int bits = 0;
#pragma unroll
        for (int d = 0; d < D; ++d) bits |= (int)rintf(t[d]) << d;
        const Row<F> r = load_row<F>(lv.tab, corner_index<D>(lv, g, bits));
#pragma unroll
        for (int f = 0; f < F; ++f) acc[f] = r.v[f];
        return;
    }
    if constexpr (D == 3) {
        if (interp == kSimplex && lv.hashed) {
            // first index of the max and of the min, as argmax/argmin
            int amax = 0, amin = 0;
            float vmax = t[0], vmin = t[0];
            if (t[1] > vmax) { amax = 1; vmax = t[1]; }
            if (t[2] > vmax) amax = 2;
            if (t[1] < vmin) { amin = 1; vmin = t[1]; }
            if (t[2] < vmin) amin = 2;
            if (amin == amax) amin = (amax + 1) % 3;
            const float t_max = fmaxf(fmaxf(t[0], t[1]), t[2]);
            const float t_min = fminf(fminf(t[0], t[1]), t[2]);
            const float t_mid = ((t[0] + t[1]) + t[2]) - t_max - t_min;
            const float w[4] = {1.0f - t_max, t_max - t_mid, t_mid - t_min, t_min};
            const int cbits[4] = {0, 1 << amax, 7 ^ (1 << amin), 7};
            if constexpr (kStochastic) {
                const Row<F> r = load_row<F>(lv.tab, corner_index<D>(lv, g, cbits[pick_corner<4>(w, u)]));
#pragma unroll
                for (int f = 0; f < F; ++f) acc[f] = r.v[f];
                return;
            }
            // corners 000, e_max, 1 - e_min, 111
            const Row<F> rows[4] = {
                load_row<F>(lv.tab, corner_index<D>(lv, g, 0)),
                load_row<F>(lv.tab, corner_index<D>(lv, g, 1 << amax)),
                load_row<F>(lv.tab, corner_index<D>(lv, g, 7 ^ (1 << amin))),
                load_row<F>(lv.tab, corner_index<D>(lv, g, 7)),
            };
#pragma unroll
            for (int c = 0; c < 4; ++c) {
#pragma unroll
                for (int f = 0; f < F; ++f) acc[f] = acc[f] + w[c] * rows[c].v[f];
            }
            return;
        }
    }
    float w[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
        float wc = (c & 1) ? t[0] : 1.0f - t[0];
#pragma unroll
        for (int d = 1; d < D; ++d) wc = wc * (((c >> d) & 1) ? t[d] : 1.0f - t[d]);
        w[c] = wc;
    }
    if constexpr (kStochastic) {
        if (lv.hashed) {
            const Row<F> r = load_row<F>(lv.tab, corner_index<D>(lv, g, pick_corner<C>(w, u)));
#pragma unroll
            for (int f = 0; f < F; ++f) acc[f] = r.v[f];
            return;
        }
    }
    Row<F> rows[C];
#pragma unroll
    for (int c = 0; c < C; ++c) rows[c] = load_row<F>(lv.tab, corner_index<D>(lv, g, c));
    if constexpr (kStochastic) {
        // a chain of FMAs from corner 0's product, as the plain version
#pragma unroll
        for (int f = 0; f < F; ++f) acc[f] = w[0] * rows[0].v[f];
#pragma unroll
        for (int c = 1; c < C; ++c) {
#pragma unroll
            for (int f = 0; f < F; ++f) acc[f] = fmaf(w[c], rows[c].v[f], acc[f]);
        }
        return;
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
        for (int f = 0; f < F; ++f) acc[f] = acc[f] + w[c] * rows[c].v[f];
    }
}

// padding of a staged output row, in floats: a lane's F-float store then
// falls in distinct banks
template <int F>
constexpr int kRowPad = F >= 4 ? 4 : F;

// the stochastic mode's uniform in [0, 1) from the bits of a position
template <int D>
__device__ __forceinline__ float position_uniform(const float (&pos)[D]) {
    constexpr uint32_t kPrimes[4] = {1u, 2654435761u, 805459861u, 3674653429u};
    uint32_t h = 0u;
#pragma unroll
    for (int d = 0; d < D; ++d) h ^= __float_as_uint(pos[d]) * kPrimes[d + 1];
    h *= 0x9E3779B1u;
    return (float)(h >> 8) * 5.9604644775390625e-08f;  // 2^-24
}

template <int D, int F, bool kStochastic>
__global__ void __launch_bounds__(kThreads, D <= 2 ? 8 : 4)
hashgrid_encode_kernel(const float* __restrict__ x, const float* __restrict__ table, LevelTable lt,
                       int n_levels, int interp, long long n, float* __restrict__ out) {
    extern __shared__ __align__(16) float smem[];
    const int lf = n_levels * F;
    const int rs = lf + kRowPad<F>;
    float* xs = smem;              // (kTile, D) positions
    float* os = smem + kTile * D;  // (kTile, rs) output rows
    const long long s0 = (long long)blockIdx.x * kTile;
    const int rows = (int)(n - s0 < kTile ? n - s0 : kTile);
    for (int i = threadIdx.x; i < rows * D; i += kThreads) xs[i] = x[s0 * D + i];
    __syncthreads();

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    float pos[D];
#pragma unroll
    for (int d = 0; d < D; ++d) pos[d] = lane < rows ? xs[lane * D + d] : 0.0f;
    const float u_pos = kStochastic ? position_uniform<D>(pos) : 0.0f;
    for (int l = warp; l < n_levels; l += kWarps) {
        const Level lv = {lt.scale[l], lt.res[l], lt.size[l], lt.magic[l], lt.shift[l],
                          lt.hashed[l] != 0, table + (size_t)lt.offset[l] * F};
        float u = 0.0f;
        if constexpr (kStochastic) u = fmodf(u_pos + (float)((double)l * 0.6180339887), 1.0f);
        float acc[F];
        encode_level<D, F, kStochastic>(lv, interp, pos, u, acc);
        if (lane < rows) {
            float* o = os + lane * rs + l * F;
            if constexpr (F % 4 == 0) {
#pragma unroll
                for (int f = 0; f < F; f += 4)
                    *reinterpret_cast<float4*>(o + f) =
                        make_float4(acc[f], acc[f + 1], acc[f + 2], acc[f + 3]);
            } else if constexpr (F == 2) {
                *reinterpret_cast<float2*>(o) = make_float2(acc[0], acc[1]);
            } else {
#pragma unroll
                for (int f = 0; f < F; ++f) o[f] = acc[f];
            }
        }
    }
    __syncthreads();

    // the tile's rows are contiguous in the output: write them in order
    float* o = out + s0 * lf;
    const int total = rows * lf;
    if ((lf & 3) == 0) {
        for (int e = threadIdx.x * 4; e < total; e += kThreads * 4) {
            const int r = e / lf;
            const float* q = os + r * rs + (e - r * lf);
            *reinterpret_cast<float4*>(o + e) = make_float4(q[0], q[1], q[2], q[3]);
        }
    } else {
        for (int e = threadIdx.x; e < total; e += kThreads) {
            const int r = e / lf;
            o[e] = os[r * rs + (e - r * lf)];
        }
    }
}

template <int D, int F, bool kStochastic>
int launch_df(const float* xp, const float* tp, const LevelTable& lt, int n_levels, int interp,
              long long n, float* op, cudaStream_t st) {
    // at most 32 x (3 + 32·8 + 4) floats, under the 48 KB a block has without an opt-in
    const size_t smem = sizeof(float) * (size_t)kTile * (D + n_levels * F + kRowPad<F>);
    const unsigned blocks = (unsigned)((n + kTile - 1) / kTile);
    hashgrid_encode_kernel<D, F, kStochastic><<<blocks, kThreads, smem, st>>>(
        xp, tp, lt, n_levels, interp, n, op);
    return (int)cudaGetLastError();
}

template <int D, bool kStochastic>
int launch_encode(const float* xp, const float* tp, const LevelTable& lt, int n_levels,
                  int n_features, int interp, long long n, float* op, cudaStream_t st) {
    switch (n_features) {
        case 1: return launch_df<D, 1, kStochastic>(xp, tp, lt, n_levels, interp, n, op, st);
        case 2: return launch_df<D, 2, kStochastic>(xp, tp, lt, n_levels, interp, n, op, st);
        case 4: return launch_df<D, 4, kStochastic>(xp, tp, lt, n_levels, interp, n, op, st);
        case 8: return launch_df<D, 8, kStochastic>(xp, tp, lt, n_levels, interp, n, op, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

template <bool kStochastic>
int encode_entry(const void* x, const void* table, const void* scale, const void* res,
                 const void* size, const void* offset, const void* hashed, const void* magic,
                 const void* shift, int n_dims, int n_levels, int n_features, int interp,
                 long long n, void* out, void* stream) {
    if (n_levels < 1 || n_levels > kMaxLevels) return (int)cudaErrorInvalidValue;
    LevelTable lt;
    for (int l = 0; l < n_levels; ++l) {
        lt.scale[l] = static_cast<const float*>(scale)[l];
        lt.res[l] = (uint32_t) static_cast<const int*>(res)[l];
        lt.size[l] = (uint32_t) static_cast<const int*>(size)[l];
        lt.offset[l] = (uint32_t) static_cast<const int*>(offset)[l];
        lt.hashed[l] = static_cast<const int*>(hashed)[l];
        lt.magic[l] = static_cast<const uint32_t*>(magic)[l];
        lt.shift[l] = static_cast<const uint32_t*>(shift)[l];
    }
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* xp = static_cast<const float*>(x);
    const float* tp = static_cast<const float*>(table);
    float* op = static_cast<float*>(out);
    switch (n_dims) {
        case 1: return launch_encode<1, kStochastic>(xp, tp, lt, n_levels, n_features, interp, n, op, st);
        case 2: return launch_encode<2, kStochastic>(xp, tp, lt, n_levels, n_features, interp, n, op, st);
        case 3: return launch_encode<3, kStochastic>(xp, tp, lt, n_levels, n_features, interp, n, op, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// scale, res, size, offset, magic, shift, hashed: host arrays of n_levels
extern "C" int ngp_hashgrid_encode_fwd(const void* x, const void* table, const void* scale,
                                       const void* res, const void* size, const void* offset,
                                       const void* hashed, const void* magic, const void* shift,
                                       int n_dims, int n_levels, int n_features, int interp,
                                       long long n, void* out, void* stream) {
    return encode_entry<false>(x, table, scale, res, size, offset, hashed, magic, shift, n_dims,
                               n_levels, n_features, interp, n, out, stream);
}

// the stochastic-corner mode, with the same arguments
extern "C" int ngp_hashgrid_encode_fwd_stochastic(const void* x, const void* table,
                                                  const void* scale, const void* res,
                                                  const void* size, const void* offset,
                                                  const void* hashed, const void* magic,
                                                  const void* shift, int n_dims, int n_levels,
                                                  int n_features, int interp, long long n,
                                                  void* out, void* stream) {
    return encode_entry<true>(x, table, scale, res, size, offset, hashed, magic, shift, n_dims,
                              n_levels, n_features, interp, n, out, stream);
}
