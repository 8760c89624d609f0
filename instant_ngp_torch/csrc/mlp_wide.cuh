// Shared code of kernel B's and F's wide route (csrc/mlp_wide.cu describes
// the design; csrc/mlp_wide_bwd.cu and csrc/mlp_wide_dw.cu hold kernel F's two
// launches): the layer records, the packing kernel, the forward and backward
// layers on wgmma, the persistent kernel and its host-side plan. Each source
// includes it and instantiates what it launches, so the three compile in
// parallel.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <vector>

#include "wgmma.cuh"

// 1 in the translation units of the five generic activations (csrc/
// mlp_wide_generic.cu, mlp_wide_bwd_generic.cu, mlp_wide_bwd256_generic.cu):
// their kernels' hidden layers take leakyrelu, sine, squareplus, softplus or
// tanh; the others' take relu, none, sigmoid and exponential
#ifndef NGP_GENERIC_ACT
#define NGP_GENERIC_ACT 0
#endif

namespace {

constexpr int kMaxWidth = 256;
constexpr int kStageBytes = 32768;  // one stage of the forward's ring: a chunk of a layer's weights
constexpr int kMaxStages = 6;
constexpr int kMinStages = 4;
constexpr int kTile = 64;  // rows a consumer warpgroup owns; rows of the dW kernel's k tile
// activation codes (ops/mlp_kernel.py ACTIVATIONS; 0 is none); the last five
// are the generic ones
constexpr int kRelu = 1, kSigmoid = 2, kExp = 3, kLeakyRelu = 4, kSine = 5, kSquareplus = 6,
              kSoftplus = 7, kTanh = 8;
// the hidden activations a kernel takes (its template argument kHid): none,
// relu, sigmoid and exponential, or the five generic ones
constexpr int kShipped = -1, kGeneric = -2;
constexpr int kHidden = NGP_GENERIC_ACT ? kGeneric : kShipped;  // this unit's

// whether a call takes the kGeneric kernels: by its hidden activation (both
// sets take every output activation)
__host__ __device__ inline bool uses_generic(int act) { return act >= kLeakyRelu; }

// per layer i, from the widths: d_in, d_out; K and N of the forward's product
// (pad16(d_in), wgmma N of d_out) and of the backward's (pad16(d_out), wgmma N
// of d_in); byte offsets of the two packed layouts; their chunk rows; column
// of z_{i+1} in the recompute's record; column of h_i in an h tile (64-
// aligned); column of dz_i in a dz tile; dz_i's terms (1 or 3); this layer's
// word offset in the per-thread scratch
enum {
    L_DIN, L_DOUT, L_KIN, L_NOUT, L_KOUT, L_NIN, L_FOFF, L_BOFF, L_FROWS, L_BROWS,
    L_ZCOL, L_HCOL, L_DZCOL, L_TERMS, L_SCR, kLayerInts
};

__host__ __device__ inline int pad16(int v) { return (v + 15) / 16 * 16; }
__host__ __device__ inline int pad64(int v) { return (v + 63) / 64 * 64; }
// the wgmma N a width takes: 16, 32, 64, 128 or 256
__host__ __device__ inline int wgn(int v) {
    int p = 16;
    while (p < v) p *= 2;
    return p;
}
// K rows of a chunk of an (N x K) operand: as many 16-row steps as fill a stage
__host__ __device__ inline int chunk_rows(int k, int n) {
    int r = kStageBytes / (2 * n) / 16 * 16;
    return r < k ? r : k;
}

// bytes before the packed weights: the widths d_0 .. d_L, 16-byte aligned
__host__ __device__ inline int header_bytes(int n_layers) { return ((n_layers + 1) * 4 + 15) / 16 * 16; }

struct Totals {
    int fwd_bytes, bwd_bytes;  // of the two packed layouts
    int hw, zw;                // columns of an h tile and of a dz tile
    int scr_words;             // per consumer thread
};

// every layer's record (kLayerInts ints each) from the widths d and the hidden
// activation; the backward offsets follow the forward layouts
__host__ __device__ inline Totals layer_records(const int* d, int n_layers, int act, int* rec) {
    Totals t = {0, 0, 0, 0, 0};
    int zcol = 0;
    for (int i = 0; i < n_layers; ++i) {
        int* r = rec + kLayerInts * i;
        const bool last = i == n_layers - 1;
        r[L_DIN] = d[i];
        r[L_DOUT] = d[i + 1];
        r[L_KIN] = pad16(d[i]);
        r[L_NOUT] = wgn(d[i + 1]);
        r[L_KOUT] = pad16(d[i + 1]);
        r[L_NIN] = wgn(d[i]);
        r[L_FROWS] = chunk_rows(r[L_KIN], r[L_NOUT]);
        r[L_BROWS] = chunk_rows(r[L_KOUT], r[L_NIN]);
        r[L_FOFF] = t.fwd_bytes;
        t.fwd_bytes += 2 * r[L_KIN] * r[L_NOUT];
        r[L_BOFF] = t.bwd_bytes;
        t.bwd_bytes += 2 * r[L_KOUT] * r[L_NIN];
        r[L_ZCOL] = zcol;
        zcol += d[i + 1];
        r[L_HCOL] = t.hw;
        t.hw += pad64(d[i]);
        r[L_TERMS] = last || act >= kSigmoid ? 3 : 1;  // dz_i is an f32 value under all but relu/none
        r[L_DZCOL] = t.zw;
        t.zw += r[L_NOUT] * r[L_TERMS];
        // act'(z_{i+1}) of a hidden layer (dz_i in its place under every
        // activation but relu and none), dz_{L-1} of the last: N / 2 values a thread
        const int vals = r[L_NOUT] / 2;
        r[L_SCR] = t.scr_words;
        t.scr_words += last ? vals : act == kRelu ? (vals + 15) / 16 : act == 0 ? 0 : vals;
    }
    for (int i = 0; i < n_layers; ++i) rec[kLayerInts * i + L_BOFF] += t.fwd_bytes;
    return t;
}

// element offset of (k, n) in a packed (N x K) K-major operand laid out in
// chunks of r rows of K: within a chunk of kr rows, core matrix (n / 8, kl / 8)
// at ((n / 8)·(kr / 8) + kl / 8)·64, row n % 8, column kl % 8
__host__ __device__ inline int packed_offset(int k, int n, int kk, int nn, int r) {
    const int c = k / r, kl = k - c * r;
    const int kr = kk - c * r < r ? kk - c * r : r;
    return c * r * nn + ((n >> 3) * (kr >> 3) + (kl >> 3)) * 64 + (n & 7) * 8 + (kl & 7);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_round(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// term q (0 hi, 1 mid, 2 lo) of kernel F's exact three-term bf16 split of v
__device__ __forceinline__ float split_term(float v, int q) {
    const float hi = bf16_round(v);
    if (q == 0) return hi;
    const float r = v - hi;
    const float mid = bf16_round(r);
    return q == 1 ? mid : r - mid;
}

// jax.nn.softplus = logaddexp(v, 0)
__device__ __forceinline__ float softplus(float v) { return fmaxf(v, 0.0f) + log1pf(expf(-fabsf(v))); }

// the activation as the JAX package's activation_fn computes it
__device__ __forceinline__ float activate(float v, int act) {
    switch (act) {
        case kRelu: return fmaxf(v, 0.0f);
        case kSigmoid: return 1.0f / (1.0f + expf(-v));
        case kExp: return expf(v);
        case kLeakyRelu: return v > 0.0f ? v : 0.01f * v;
        case kSine: return sinf(v);
        case kSquareplus: return 0.5f * (v + sqrtf(v * v + 4.0f));
        case kSoftplus: return softplus(v);
        case kTanh: return tanhf(v);
        default: return v;
    }
}

// d act / d z at the f32 pre-activation z, as JAX differentiates it
// (leakyrelu: 0.01 at 0, where jnp.where takes its false branch; softplus:
// logaddexp's custom jvp e^(z - softplus(z)); tanh: (1 + t)(1 - t))
__device__ __forceinline__ float act_grad(float z, int act) {
    switch (act) {
        case kRelu: return z > 0.0f ? 1.0f : (z == 0.0f ? 0.5f : 0.0f);
        case kSigmoid: {
            const float s = activate(z, kSigmoid);
            return s * (1.0f - s);
        }
        case kExp: return expf(z);
        case kLeakyRelu: return z > 0.0f ? 1.0f : 0.01f;
        case kSine: return cosf(z);
        case kSquareplus: return 0.5f * (1.0f + z / sqrtf(z * z + 4.0f));
        case kSoftplus: return expf(z - softplus(z));
        case kTanh: {
            const float t = tanhf(z);
            return (1.0f + t) * (1.0f - t);
        }
        default: return 1.0f;
    }
}

// Where each activation is compiled in. Given the kind at run time inside a
// fully unrolled loop, the compiler evaluates every kind (two exponentials
// and a division) for every value and selects; so a hidden layer takes one
// instantiation a kind, picked once per layer: none, relu, sigmoid or
// exponential in the kShipped kernels (NGP_ACT_SWITCH), one of the five in
// the kGeneric ones (NGP_GENERIC_SWITCH), each inline at every value. The
// two sets stay in kernels of their own, so that the shipped kernels hold
// none of the five's hidden code. A unit a generic activation, its kernels
// taking the shipped kinds and its own (15 units), was the other design:
// each unit holds the whole kernel again, the build took more than twice as
// long as with one generic unit a source, and its kernels ran no faster
// than these (PERF.md §6). The output layer takes the kernel's own hidden
// kinds inline (a kGeneric kernel's: none) and any other, a mixed pair's
// among them, through out_rolled and last_dz_rolled: the pre-activations
// staged in memory (B's output, F's scratch) and activated there in a loop
// that is not unrolled, one loop a kind.
#define NGP_ACT_SWITCH(ACT, CALL)                \
    switch (ACT) {                               \
        case kRelu: CALL(kRelu); break;          \
        case kSigmoid: CALL(kSigmoid); break;    \
        case kExp: CALL(kExp); break;            \
        default: CALL(0); break;                 \
    }

// the five generic activations, each compiled in
#define NGP_GENERIC_SWITCH(ACT, CALL)                     \
    switch (ACT) {                                        \
        case kLeakyRelu: CALL(kLeakyRelu); break;         \
        case kSine: CALL(kSine); break;                   \
        case kSquareplus: CALL(kSquareplus); break;       \
        case kSoftplus: CALL(kSoftplus); break;           \
        default: CALL(kTanh); break;                      \
    }

// an output activation that a kernel's rolled loops take: the five, and in
// a kGeneric kernel relu, sigmoid and exponential too (kHid in scope)
#define NGP_ROLLED_SWITCH(ACT, CALL)                      \
    if constexpr (kHid == kGeneric) {                     \
        switch (ACT) {                                    \
            case kRelu: CALL(kRelu); break;               \
            case kSigmoid: CALL(kSigmoid); break;         \
            case kExp: CALL(kExp); break;                 \
            default: NGP_GENERIC_SWITCH(ACT, CALL)        \
        }                                                 \
    } else {                                              \
        NGP_GENERIC_SWITCH(ACT, CALL)                     \
    }

// layer i's f32 (din, dout) weights w into the packed bf16 layouts, zero-padded:
// fwd (N = wgmma N of dout, K = pad16(din)), W^T K-major; bwd (N = wgmma N of
// din, K = pad16(dout)), W K-major, where not null. Block 0 also writes the
// widths this launch knows into the header.
struct PackDims {
    int din, dout, kin, nout, frows, kout, nin, brows;
};

__global__ void pack_layer(const float* __restrict__ w, const PackDims pd, __nv_bfloat16* fwd, __nv_bfloat16* bwd,
                           int* header, int i, int last) {
    const int din = pd.din, dout = pd.dout, kin = pd.kin, nout = pd.nout, kout = pd.kout, nin = pd.nin;
    const int n_f = kin * nout, n_all = n_f + (bwd != nullptr ? kout * nin : 0);
    if (blockIdx.x == 0 && threadIdx.x == 0) {
        header[i] = din;
        if (last) header[i + 1] = dout;
    }
    for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n_all; e += gridDim.x * blockDim.x) {
        if (e < n_f) {
            const int k = e / nout, o = e - k * nout;
            fwd[packed_offset(k, o, kin, nout, pd.frows)] =
                __float2bfloat16_rn(o < dout && k < din ? w[k * dout + o] : 0.0f);
        } else {
            const int e2 = e - n_f, k = e2 / nin, o = e2 - k * nin;
            bwd[packed_offset(k, o, kout, nin, pd.brows)] =
                __float2bfloat16_rn(o < din && k < dout ? w[o * dout + k] : 0.0f);
        }
    }
}

struct Params {
    const float* x;            // (n, d_0) f32
    const unsigned char* pk;   // header (the widths) and the packed weights
    int L, act, out_act;
    long long n;
    float* out;                // B: (n, d_L)
    const float* g;            // F: (n, d_L)
    float* dx;                 // F: (n, d_0)
    __nv_bfloat16* hbuf;       // F: h_i, (n / 64 tiles, 64 x hw), MN-major
    __nv_bfloat16* dzbuf;      // F: dz_i, (n / 64 tiles, 64 x zw), MN-major, 1 or 3 terms
    float* zf;                 // the recompute's pre-activations, layer by layer (n, d_{i+1}), or null
    float* gscr;               // the per-thread scratch where it is not in shared memory
    int hw, zw, scr_words, n_stages, scr_in_smem;
};

// one consumer thread's place: its rows, the ring, its scratch
struct Ctx {
    unsigned char* stages;
    uint64_t* full;
    uint64_t* empty;
    int n_stages;
    uint32_t q;        // chunks consumed so far
    int wtid;          // thread in the warpgroup
    int warp, gq, tig;
    long long r0, r1;  // the thread's two rows
    long long t64;     // the warpgroup's 64-row tile
    bool live;         // the tile holds a row below n
    float* scr;        // scr[w * stride]: word w of this thread
    int stride;
};

__device__ __forceinline__ void release(const Ctx& c, int s) {
    if (c.wtid == 0) wg::mbar_arrive(&c.empty[s]);
}

// acc += a · B over K = k rows, B streamed from the ring in chunks of `rows`
// rows: for each chunk, wait for it, issue its k16 steps, and release the
// chunk before it once that one's products are done
template <int N, int kMaxK>
__device__ __forceinline__ void run_products(float (&acc)[N / 2], uint32_t (&a)[kMaxK / 16][4], int k, int rows,
                                             Ctx& c) {
    int left = 0, loc = 0, cur = 0, pend = -1;
    uint32_t sbo = 0;
    const unsigned char* base = nullptr;
#pragma unroll
    for (int v = 0; v < N / 2; ++v) wg::fence_reg(acc[v]);
    wg::fence();
#pragma unroll
    for (int kb = 0; kb < kMaxK / 16; ++kb) {
        if (kb * 16 < k) {
            if (left == 0) {
                if (kb > 0) {
                    wg::commit();
                    if (pend >= 0) {
                        wg::wait<1>();
                        release(c, pend);
                    }
                    pend = cur;
                }
                cur = (int)(c.q % (uint32_t)c.n_stages);
                wg::mbar_wait(&c.full[cur], (c.q / (uint32_t)c.n_stages) & 1u);
                ++c.q;
                const int kr = k - kb * 16 < rows ? k - kb * 16 : rows;
                left = kr / 16;
                loc = 0;
                sbo = (uint32_t)kr * 16;
                base = c.stages + (size_t)cur * kStageBytes;
            }
            wg::Wgmma<N>::rs(acc, a[kb], wg::desc(base + loc * 256, 128, sbo), 1);
            ++loc;
            --left;
        }
    }
    wg::commit();
    wg::wait<0>();
    if (pend >= 0) release(c, pend);
    release(c, cur);
#pragma unroll
    for (int v = 0; v < N / 2; ++v) wg::fence_reg(acc[v]);
#pragma unroll
    for (int kb = 0; kb < kMaxK / 16; ++kb)
#pragma unroll
        for (int e = 0; e < 4; ++e) wg::fence_reg(a[kb][e]);
}

// the pair (v0, v1) into columns c, c + 1 of row r of the (n, w) f32 array z
__device__ __forceinline__ void store_pair(float* z, long long r, int c, long long n, int w, float v0, float v1) {
    if (r < n && c < w) z[r * w + c] = v0;
    if (r < n && c + 1 < w) z[r * w + c + 1] = v1;
}

// a packed bf16 pair of the warpgroup's row rb + gq (rb in 0..63, a multiple of
// 8) and columns cb + 2·tig (cb a multiple of 8) into an MN-major 64-row tile
__device__ __forceinline__ void tile_store(__nv_bfloat16* tile, int rb, int cb, uint32_t v, const Ctx& c) {
    *reinterpret_cast<uint32_t*>(tile + ((cb >> 3) * 8 + (rb >> 3)) * 64 + c.gq * 8 + 2 * c.tig) = v;
}

// A fragments a[kb], kb < k / 16, into an MN-major tile (rows past n zero)
template <int kMaxK>
__device__ __forceinline__ void store_frags(__nv_bfloat16* tile, const uint32_t (&a)[kMaxK / 16][4], int k,
                                            long long n, const Ctx& c) {
    const bool ok0 = c.r0 < n, ok1 = c.r1 < n;
#pragma unroll
    for (int kb = 0; kb < kMaxK / 16; ++kb) {
        if (kb * 16 < k) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const bool ok = e & 1 ? ok1 : ok0;
                tile_store(tile, 16 * c.warp + (e & 1) * 8, 16 * kb + (e >> 1) * 8, ok ? a[kb][e] : 0u, c);
            }
        }
    }
}

// the three bf16 terms of f32 values v (accumulator layout, columns < w) into
// three MN-major tile planes of nn columns each (rows past n zero)
template <int N>
__device__ __forceinline__ void store_terms(__nv_bfloat16* tile, const float (&v)[N / 2], int w, int nn, long long n,
                                            const Ctx& c) {
    const bool ok0 = c.r0 < n, ok1 = c.r1 < n;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
        if (j * 8 < w) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const bool ok = h ? ok1 : ok0;
                const float x0 = v[4 * j + 2 * h], x1 = v[4 * j + 2 * h + 1];
#pragma unroll
                for (int q = 0; q < 3; ++q)
                    tile_store(tile + q * 64 * nn, 16 * c.warp + 8 * h, 8 * j,
                               ok ? pack_bf16(split_term(x0, q), split_term(x1, q)) : 0u, c);
            }
        }
    }
}

// x rows r0, r1 of the tile rounded to bf16 into the A fragments of layer 0
template <int kMaxK>
__device__ __forceinline__ void load_x(uint32_t (&a)[kMaxK / 16][4], const float* __restrict__ x, int d0, int k,
                                       long long n, const Ctx& c) {
#pragma unroll
    for (int kb = 0; kb < kMaxK / 16; ++kb) {
        if (kb * 16 < k) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const long long r = e & 1 ? c.r1 : c.r0;
                const int col = 16 * kb + (e >> 1) * 8 + 2 * c.tig;
                if ((d0 & 1) == 0) {  // one 8-byte load a pair
                    const float2 v = r < n && col < d0 ? *reinterpret_cast<const float2*>(x + r * d0 + col)
                                                       : make_float2(0.0f, 0.0f);
                    a[kb][e] = pack_bf16(v.x, v.y);
                } else {
                    const float v0 = r < n && col < d0 ? x[r * d0 + col] : 0.0f;
                    const float v1 = r < n && col + 1 < d0 ? x[r * d0 + col + 1] : 0.0f;
                    a[kb][e] = pack_bf16(v0, v1);
                }
            }
        }
    }
}

// act'(z) of every accumulator value into the scratch (every activation but
// relu and none)
template <int N, int kAct>
__device__ __forceinline__ void save_grad(const float (&acc)[N / 2], float* s, const Ctx& c) {
#pragma unroll
    for (int v = 0; v < N / 2; ++v) s[(size_t)v * c.stride] = act_grad(acc[v], kAct);
}

// the next layer's A fragments a[kb], kb < kn / 16: the activation of the
// accumulators, rounded to bf16 (fragment e holds values 8kb + 2e, 8kb + 2e + 1)
template <int N, int kMaxK, int kAct>
__device__ __forceinline__ void next_frags(const float (&acc)[N / 2], uint32_t (&a)[kMaxK / 16][4], int kn) {
#pragma unroll
    for (int kb = 0; kb < N / 16; ++kb) {
        if (kb * 16 < kn) {
#pragma unroll
            for (int e = 0; e < 4; ++e)
                a[kb][e] = pack_bf16(activate(acc[8 * kb + 2 * e], kAct), activate(acc[8 * kb + 2 * e + 1], kAct));
        }
    }
}

// B's output: the output activation of the accumulators, columns < dout
template <int N, int kAct>
__device__ __forceinline__ void write_out(const float (&acc)[N / 2], const Params& p, int dout, const Ctx& c) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
        if (j * 8 < dout) {
            const int col = 8 * j + 2 * c.tig;
            store_pair(p.out, c.r0, col, p.n, dout, activate(acc[4 * j], kAct), activate(acc[4 * j + 1], kAct));
            store_pair(p.out, c.r1, col, p.n, dout, activate(acc[4 * j + 2], kAct),
                       activate(acc[4 * j + 3], kAct));
        }
    }
}

// B's output under an output activation kAct its kernel's hidden layers do
// not take (NGP_ROLLED_SWITCH): the values write_out<N, 0> wrote (columns
// 8j + 2·tig + (v & 1) of rows r0 (v & 3 < 2) and r1, 8j < dout), each read
// back and activated in place, one at a time
template <int kAct>
__device__ __forceinline__ void out_rolled(const Params& p, int dout, const Ctx& c) {
#pragma unroll 1
    for (int v = 0; v < 4 * ((dout + 7) / 8); ++v) {
        const long long r = (v & 3) < 2 ? c.r0 : c.r1;
        const int col = 8 * (v >> 2) + 2 * c.tig + (v & 1);
        if (r < p.n && col < dout) {
            float* o = p.out + r * dout + col;
            *o = activate(*o, kAct);
        }
    }
}

// F's dz_{L-1} = g·act_out'(z_L) in place of the accumulators and into the
// scratch s (zero past n rows and dout columns)
template <int N, int kAct>
__device__ __forceinline__ void last_dz(float (&acc)[N / 2], const Params& p, int dout, float* s, const Ctx& c) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const long long r = e < 2 ? c.r0 : c.r1;
            const int col = 8 * j + 2 * c.tig + (e & 1);
            const float gv = r < p.n && col < dout ? p.g[r * dout + col] * act_grad(acc[4 * j + e], kAct) : 0.0f;
            acc[4 * j + e] = gv;
            s[(size_t)(4 * j + e) * c.stride] = gv;
        }
    }
}

// last_dz's values under such an output activation kAct, over the vals
// pre-activations the caller staged in the scratch s, one at a time
template <int kAct>
__device__ __forceinline__ void last_dz_rolled(const Params& p, int dout, int vals, float* s, const Ctx& c) {
#pragma unroll 1
    for (int v = 0; v < vals; ++v) {
        const long long r = (v & 3) < 2 ? c.r0 : c.r1;
        const int col = 8 * (v >> 2) + 2 * c.tig + (v & 1);
        float* sv = s + (size_t)v * c.stride;
        *sv = r < p.n && col < dout ? p.g[r * dout + col] * act_grad(*sv, kAct) : 0.0f;
    }
}

// A generic hidden activation kAct on every accumulator value of a kGeneric
// kernel: the next layer's A fragments (as next_frags) and, in F, act'(z)
// into the scratch (as save_grad), value by value, so that what the two
// share (tanh z, softplus(z), sine's argument reduction) lives for one
// value, not a layer. Inline at every value, sine included: sine's values
// one at a time through a per-thread array instead gave the kernel a stack
// and slowed every activation's F, 1.2x at fox's rgb widths and 1.65x at
// image/oneblob's (bench/act_variants.py, sine_rolled).
template <int N, int kMaxK, bool kBwd, int kAct>
__device__ __forceinline__ void hidden_generic(const float (&acc)[N / 2], uint32_t (&a)[kMaxK / 16][4], int kn,
                                               float* s, const Ctx& c) {
#pragma unroll
    for (int kb = 0; kb < N / 16; ++kb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int v = 8 * kb + 2 * e;
            if (kBwd) {
                s[(size_t)v * c.stride] = act_grad(acc[v], kAct);
                s[(size_t)(v + 1) * c.stride] = act_grad(acc[v + 1], kAct);
            }
            if (kb * 16 < kn) a[kb][e] = pack_bf16(activate(acc[v], kAct), activate(acc[v + 1], kAct));
        }
    }
}

// one forward layer: z = h_i·W_i into acc (N = the layer's wgmma N), then the
// record, and the next layer's A fragments (hidden) or the output (B) or
// dz_{L-1} (F); kHid: the kernel's hidden activation (kShipped or a code)
template <int N, int kMaxK, bool kBwd, int kHid>
__device__ __forceinline__ void fwd_layer(const int* rec, const int* rec_next, bool last, const Params& p,
                                          uint32_t (&a)[kMaxK / 16][4], Ctx& c) {
    float acc[N / 2];
#pragma unroll
    for (int v = 0; v < N / 2; ++v) acc[v] = 0.0f;
    run_products<N, kMaxK>(acc, a, rec[L_KIN], rec[L_FROWS], c);
    const int dout = rec[L_DOUT];
    const long long n = p.n;
    if (p.zf != nullptr) {
        float* z = p.zf + n * rec[L_ZCOL];
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
            if (j * 8 < dout) {
                const int col = 8 * j + 2 * c.tig;
                store_pair(z, c.r0, col, n, dout, acc[4 * j], acc[4 * j + 1]);
                store_pair(z, c.r1, col, n, dout, acc[4 * j + 2], acc[4 * j + 3]);
            }
        }
    }
    if (!last) {
        const int kn = rec[L_KOUT];
        float* s = c.scr + (size_t)rec[L_SCR] * c.stride;  // act'(z_{i+1}) for F's dh chain
        if constexpr (kHid == kGeneric) {
#define NGP_HIDDEN(K) hidden_generic<N, kMaxK, kBwd, K>(acc, a, kn, s, c)
            NGP_GENERIC_SWITCH(p.act, NGP_HIDDEN)
#undef NGP_HIDDEN
        } else {
            if (kBwd) {
                if (p.act == kRelu) {
#pragma unroll
                    for (int v0 = 0; v0 < N / 2; v0 += 16) {
                        uint32_t word = 0;
#pragma unroll
                        for (int u = 0; u < 16; ++u) {
                            if (v0 + u < N / 2) {
                                const float z = acc[v0 + u];
                                word |= (z > 0.0f ? 2u : (z == 0.0f ? 1u : 0u)) << (2 * u);
                            }
                        }
                        s[(size_t)(v0 / 16) * c.stride] = __uint_as_float(word);
                    }
                } else if (p.act == kSigmoid) {
                    save_grad<N, kSigmoid>(acc, s, c);
                } else if (p.act == kExp) {
                    save_grad<N, kExp>(acc, s, c);
                }
            }
#define NGP_NEXT(K) next_frags<N, kMaxK, K>(acc, a, kn)
            NGP_ACT_SWITCH(p.act, NGP_NEXT)
#undef NGP_NEXT
        }
        if (kBwd && c.live)  // h_{i+1} for the dW kernel
            store_frags<kMaxK>(p.hbuf + (size_t)c.t64 * kTile * p.hw + kTile * rec_next[L_HCOL], a, kn, n, c);
        return;
    }
    // the output layer: the kinds the kernel's hidden layers take compiled in
    // (a kGeneric kernel: none alone), any other through a rolled loop (B's
    // in the kernel, after the last layer)
    const int oa = p.out_act;
    if (!kBwd) {
        if (kHid == kShipped && oa == kRelu)
            write_out<N, kRelu>(acc, p, dout, c);
        else if (kHid == kShipped && oa == kSigmoid)
            write_out<N, kSigmoid>(acc, p, dout, c);
        else if (kHid == kShipped && oa == kExp)
            write_out<N, kExp>(acc, p, dout, c);
        else
            write_out<N, 0>(acc, p, dout, c);
        return;
    }
    // F: dz_{L-1} = g·act_out'(z_L), f32: into the scratch and, as three terms, the dz buffer
    float* s = c.scr + (size_t)rec[L_SCR] * c.stride;
    if (oa == 0) {
        last_dz<N, 0>(acc, p, dout, s, c);
    } else if (kHid == kShipped && oa == kRelu) {
        last_dz<N, kRelu>(acc, p, dout, s, c);
    } else if (kHid == kShipped && oa == kSigmoid) {
        last_dz<N, kSigmoid>(acc, p, dout, s, c);
    } else if (kHid == kShipped && oa == kExp) {
        last_dz<N, kExp>(acc, p, dout, s, c);
    } else {
#pragma unroll
        for (int v = 0; v < N / 2; ++v) s[(size_t)v * c.stride] = acc[v];
#define NGP_DZ(K) last_dz_rolled<K>(p, dout, N / 2, s, c)
        NGP_ROLLED_SWITCH(oa, NGP_DZ)
#undef NGP_DZ
#pragma unroll
        for (int v = 0; v < N / 2; ++v) acc[v] = s[(size_t)v * c.stride];
    }
    if (c.live)
        store_terms<N>(p.dzbuf + (size_t)c.t64 * kTile * p.zw + kTile * rec[L_DZCOL], acc, rec[L_KOUT], N, n, c);
}

// one layer of the dh chain: dh_i = dz_i·W_i^T into acc (N = wgmma N of
// d_in), dz_i entering as one bf16 term (in a) or three (from the scratch);
// then dz_{i-1} (into a, or the scratch) and the dz buffer, or dX. Under a
// generic hidden activation (kHid kGeneric) every dz_i is three terms.
template <int N, int kMaxK, int kHid>
__device__ __forceinline__ void bwd_layer(const int* rec, const int* rec_prev, const Params& p,
                                          uint32_t (&a)[kMaxK / 16][4], Ctx& c) {
    float acc[N / 2];
#pragma unroll
    for (int v = 0; v < N / 2; ++v) acc[v] = 0.0f;
    const int kout = rec[L_KOUT], terms = rec[L_TERMS];
    const long long n = p.n;
    for (int t = 0; t < terms; ++t) {
        if (terms == 3) {  // term t of the f32 dz_i, from the scratch
            const float* s = c.scr + (size_t)rec[L_SCR] * c.stride;
#pragma unroll
            for (int kb = 0; kb < kMaxK / 16; ++kb) {
                if (kb * 16 < kout) {
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        // fragment e holds accumulator values 8kb + 2e, 8kb + 2e + 1
                        const float v0 = s[(size_t)(8 * kb + 2 * e) * c.stride];
                        const float v1 = s[(size_t)(8 * kb + 2 * e + 1) * c.stride];
                        a[kb][e] = pack_bf16(split_term(v0, t), split_term(v1, t));
                    }
                }
            }
        }
        run_products<N, kMaxK>(acc, a, kout, rec[L_BROWS], c);
    }
    if (rec_prev == nullptr) {  // dX = bf16(dh_0)
        const int d0 = rec[L_DIN];
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
            if (j * 8 < d0) {
                const int col = 8 * j + 2 * c.tig;
                store_pair(p.dx, c.r0, col, n, d0, bf16_round(acc[4 * j]), bf16_round(acc[4 * j + 1]));
                store_pair(p.dx, c.r1, col, n, d0, bf16_round(acc[4 * j + 2]), bf16_round(acc[4 * j + 3]));
            }
        }
        return;
    }
    // dz_{i-1} = bf16(dh_i)·act'(z_i), act' from the scratch of layer i-1
    float* s = c.scr + (size_t)rec_prev[L_SCR] * c.stride;
    if (kHid == kShipped && p.act == kRelu) {
#pragma unroll
        for (int v0 = 0; v0 < N / 2; v0 += 16) {
            const uint32_t word = __float_as_uint(s[(size_t)(v0 / 16) * c.stride]);
#pragma unroll
            for (int u = 0; u < 16; ++u)
                if (v0 + u < N / 2) acc[v0 + u] = bf16_round(acc[v0 + u]) * (0.5f * (float)((word >> (2 * u)) & 3u));
        }
    } else if (kHid == kShipped && p.act == 0) {
#pragma unroll
        for (int v = 0; v < N / 2; ++v) acc[v] = bf16_round(acc[v]);
    } else {
#pragma unroll
        for (int v = 0; v < N / 2; ++v) {
            acc[v] = bf16_round(acc[v]) * s[(size_t)v * c.stride];
            s[(size_t)v * c.stride] = acc[v];
        }
    }
    __nv_bfloat16* tile = p.dzbuf + (size_t)c.t64 * kTile * p.zw + kTile * rec_prev[L_DZCOL];
    const int kn = rec_prev[L_KOUT];  // the next product's K: pad16(d_i)
    if (kHid == kShipped && rec_prev[L_TERMS] == 1) {  // a bf16 value: the next product's A fragments
#pragma unroll
        for (int kb = 0; kb < N / 16; ++kb) {
            if (kb * 16 < kn) {
#pragma unroll
                for (int e = 0; e < 4; ++e) a[kb][e] = pack_bf16(acc[8 * kb + 2 * e], acc[8 * kb + 2 * e + 1]);
            }
        }
        if (c.live) store_frags<kMaxK>(tile, a, kn, n, c);
    } else if (c.live) {
        store_terms<N>(tile, acc, kn, N, n, c);
    }
}

template <int kC>
struct Regs {
    static constexpr int kProducer = kC == 2 ? 40 : 24;
    static constexpr int kConsumer = kC == 2 ? 232 : 160;
};

// Dispatch on a layer's wgmma N (a switch over the widths this instantiation takes)
#define NGP_WIDE_SWITCH(NV, CALL)                  \
    switch (NV) {                                  \
        case 16: CALL(16); break;                  \
        case 32: CALL(32); break;                  \
        case 64: CALL(64); break;                  \
        case 128: CALL(128); break;                \
        default:                                   \
            if constexpr (kMaxN == 256) CALL(256); \
            break;                                 \
    }

// kHid: the hidden activation the kernel is compiled for (kHidden of its unit)
template <int kMaxN, int kC, bool kBwd, int kHid>
__global__ void __launch_bounds__(128 * (kC + 1), 1) mlp_wide_kernel(const Params p) {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    unsigned char* stages = smem_raw;
    uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw + (size_t)p.n_stages * kStageBytes);
    uint64_t* empty = full + p.n_stages;
    int* s_l = reinterpret_cast<int*>(empty + p.n_stages);
    float* s_scr = reinterpret_cast<float*>(s_l + kLayerInts * p.L);
    const unsigned char* wpk = p.pk + header_bytes(p.L);
    if (threadIdx.x == 0) {
        layer_records(reinterpret_cast<const int*>(p.pk), p.L, p.act, s_l);
        for (int s = 0; s < p.n_stages; ++s) {
            wg::mbar_init(&full[s], 1);
            wg::mbar_init(&empty[s], kC);
        }
        wg::mbar_init_fence();
    }
    __syncthreads();
    const long long n_tiles = (p.n + kTile * kC - 1) / (kTile * kC);
    const int wgi = threadIdx.x / 128;
    if (wgi == 0) {
        wg::regs_dec<Regs<kC>::kProducer>();
        if (threadIdx.x != 0) return;
        uint32_t q = 0;
        auto produce = [&](const unsigned char* src, uint32_t bytes) {
            const int s = (int)(q % (uint32_t)p.n_stages);
            wg::mbar_wait(&empty[s], ((q / (uint32_t)p.n_stages) & 1u) ^ 1u);
            wg::mbar_expect_tx(&full[s], bytes);
            wg::bulk_copy(stages + (size_t)s * kStageBytes, src, bytes, &full[s]);
            ++q;
        };
        for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
            for (int i = 0; i < p.L; ++i) {
                const int* r = s_l + kLayerInts * i;
                for (int k0 = 0; k0 < r[L_KIN]; k0 += r[L_FROWS]) {
                    const int kr = r[L_KIN] - k0 < r[L_FROWS] ? r[L_KIN] - k0 : r[L_FROWS];
                    produce(wpk + r[L_FOFF] + 2 * k0 * r[L_NOUT], 2u * kr * r[L_NOUT]);
                }
            }
            if (!kBwd) continue;
            for (int i = p.L - 1; i >= 0; --i) {
                const int* r = s_l + kLayerInts * i;
                for (int t = 0; t < r[L_TERMS]; ++t) {
                    for (int k0 = 0; k0 < r[L_KOUT]; k0 += r[L_BROWS]) {
                        const int kr = r[L_KOUT] - k0 < r[L_BROWS] ? r[L_KOUT] - k0 : r[L_BROWS];
                        produce(wpk + r[L_BOFF] + 2 * k0 * r[L_NIN], 2u * kr * r[L_NIN]);
                    }
                }
            }
        }
        return;
    }
    wg::regs_inc<Regs<kC>::kConsumer>();
    Ctx c;
    c.stages = stages;
    c.full = full;
    c.empty = empty;
    c.n_stages = p.n_stages;
    c.q = 0;
    c.wtid = threadIdx.x & 127;
    c.warp = c.wtid >> 5;
    c.gq = (c.wtid & 31) >> 2;
    c.tig = c.wtid & 3;
    const int ct = threadIdx.x - 128;  // consumer thread of the block
    c.stride = 128 * kC;
    c.scr = p.scr_in_smem ? s_scr + ct : p.gscr + (size_t)blockIdx.x * c.stride * p.scr_words + ct;
    const long long n_t64 = (p.n + kTile - 1) / kTile;
    uint32_t a[kMaxN / 16][4];
    for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        c.t64 = tile * kC + (wgi - 1);
        c.r0 = c.t64 * kTile + 16 * c.warp + c.gq;
        c.r1 = c.r0 + 8;
        c.live = c.t64 < n_t64;
        load_x<kMaxN>(a, p.x, s_l[L_DIN], s_l[L_KIN], p.n, c);
        if (kBwd && c.live) store_frags<kMaxN>(p.hbuf + (size_t)c.t64 * kTile * p.hw, a, s_l[L_KIN], p.n, c);
        for (int i = 0; i < p.L; ++i) {
            const int* r = s_l + kLayerInts * i;
            const bool last = i == p.L - 1;
            const int* rn = last ? r : r + kLayerInts;
#define NGP_FWD(NV) fwd_layer<NV, kMaxN, kBwd, kHid>(r, rn, last, p, a, c)
            NGP_WIDE_SWITCH(r[L_NOUT], NGP_FWD)
#undef NGP_FWD
        }
        const int oa = p.out_act;
        if (!kBwd && oa != 0 && (kHid == kGeneric || oa >= kLeakyRelu)) {  // fwd_layer wrote z_L
#define NGP_OUT(K) out_rolled<K>(p, s_l[kLayerInts * (p.L - 1) + L_DOUT], c)
            NGP_ROLLED_SWITCH(oa, NGP_OUT)
#undef NGP_OUT
        }
        if constexpr (kBwd) {
            for (int i = p.L - 1; i >= 0; --i) {
                const int* r = s_l + kLayerInts * i;
                const int* rp = i > 0 ? r - kLayerInts : nullptr;
#define NGP_BWD(NV) bwd_layer<NV, kMaxN, kHid>(r, rp, p, a, c)
                NGP_WIDE_SWITCH(r[L_NIN], NGP_BWD)
#undef NGP_BWD
            }
        }
    }
}

// ---- host side ----

struct DeviceInfo {
    int n_sm = 0, smem_optin = 0;
};

const DeviceInfo& device_info() {
    static DeviceInfo info;
    if (info.n_sm == 0) {
        int device = 0;
        cudaGetDevice(&device);
        cudaDeviceGetAttribute(&info.n_sm, cudaDevAttrMultiProcessorCount, device);
        cudaDeviceGetAttribute(&info.smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    }
    return info;
}

// the widths d_0 .. d_L, checked; the largest wgmma N, or 0 if one is out of range
int check_dims(const int* d, int n_layers) {
    int pmax = 0;
    if (n_layers < 1) return 0;
    for (int i = 0; i <= n_layers; ++i) {
        if (d[i] < 1 || d[i] > kMaxWidth) return 0;
        pmax = wgn(d[i]) > pmax ? wgn(d[i]) : pmax;
    }
    return pmax;
}

// consumer warpgroups of the route these widths take
int consumers(int pmax) { return pmax <= 128 ? 3 : 2; }

struct Plan {
    std::vector<int> rec;
    Totals t;
    int recs_bytes;  // of the records in shared memory
};

Plan plan(const int* d, int n_layers, int act) {
    Plan pl;
    pl.rec.resize((size_t)kLayerInts * n_layers);
    pl.t = layer_records(d, n_layers, act, pl.rec.data());
    pl.recs_bytes = (int)sizeof(int) * kLayerInts * n_layers;
    return pl;
}

size_t base_smem(int n_stages, int stage_bytes, int recs_bytes) {
    return (size_t)n_stages * stage_bytes + 2 * sizeof(uint64_t) * n_stages + recs_bytes + 16;
}

// packs every layer (the backward layouts too where bwd): one launch a layer
int pack(const void* w, const Plan& pl, int n_layers, unsigned char* scratch, bool bwd, cudaStream_t st) {
    int* header = reinterpret_cast<int*>(scratch);
    __nv_bfloat16* wpk = reinterpret_cast<__nv_bfloat16*>(scratch + header_bytes(n_layers));
    for (int i = 0; i < n_layers; ++i) {
        const int* r = pl.rec.data() + kLayerInts * i;
        const PackDims pd = {r[L_DIN], r[L_DOUT], r[L_KIN], r[L_NOUT], r[L_FROWS], r[L_KOUT], r[L_NIN], r[L_BROWS]};
        const int values = r[L_KIN] * r[L_NOUT] + (bwd ? r[L_KOUT] * r[L_NIN] : 0);
        const int blocks = (values + 255) / 256 < 64 ? (values + 255) / 256 : 64;
        pack_layer<<<blocks, 256, 0, st>>>(static_cast<const float* const*>(w)[i], pd, wpk + r[L_FOFF] / 2,
                                           bwd ? wpk + r[L_BOFF] / 2 : nullptr, header, i, i == n_layers - 1);
    }
    return (int)cudaGetLastError();
}

// scratch bytes: the header and the packed weights (both layouts)
size_t scratch_bytes(const Plan& pl, int n_layers) {
    return header_bytes(n_layers) + (size_t)pl.t.fwd_bytes + pl.t.bwd_bytes;
}

// the forward's (and F's) shared memory: stages, and the per-thread scratch
// where it fits beside at least kMinStages stages; 0 if nothing fits
struct SmemPlan {
    size_t bytes;
    int n_stages, scr_in_smem;
};

SmemPlan smem_plan(const Plan& pl, int kc, bool bwd) {
    const size_t optin = (size_t)device_info().smem_optin;
    const size_t scr = bwd ? sizeof(float) * 128 * kc * pl.t.scr_words : 0;
    for (int s = kMaxStages; s >= kMinStages; --s) {
        const size_t b = base_smem(s, kStageBytes, pl.recs_bytes);
        if (b + scr <= optin) return {b + scr, s, 1};
    }
    const size_t b = base_smem(kMaxStages, kStageBytes, pl.recs_bytes);
    if (b <= optin) return {b, kMaxStages, 0};
    return {0, 0, 0};
}

template <typename K>
int set_smem(K kernel, size_t bytes, size_t& done) {
    if (bytes > done) {
        const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
        if (err != cudaSuccess) return (int)err;
        done = bytes;
    }
    return 0;
}

template <int kMaxN, int kC, bool kBwd>
int launch_wide(Params p, const Plan& pl, cudaStream_t st) {
    const SmemPlan sp = smem_plan(pl, kC, kBwd);
    if (sp.bytes == 0) return (int)cudaErrorInvalidValue;
    static size_t set = 0;
    const int err = set_smem(mlp_wide_kernel<kMaxN, kC, kBwd, kHidden>, sp.bytes, set);
    if (err != 0) return err;
    p.n_stages = sp.n_stages;
    p.scr_in_smem = sp.scr_in_smem;
    p.hw = pl.t.hw;
    p.zw = pl.t.zw;
    p.scr_words = pl.t.scr_words;
    const long long n_tiles = (p.n + kTile * kC - 1) / (kTile * kC);
    const long long want = device_info().n_sm;
    const unsigned blocks = (unsigned)(n_tiles < want ? n_tiles : want);
    mlp_wide_kernel<kMaxN, kC, kBwd, kHidden><<<blocks, 128 * (kC + 1), sp.bytes, st>>>(p);
    return (int)cudaGetLastError();
}

// F's first launch (csrc/mlp_wide_bwd.cu's arguments) on the instantiation
// <kMaxN, kC, kHidden>: each is compiled in a source of its own
// (mlp_wide_bwd.cu, mlp_wide_bwd256.cu and their generic twins), so that
// they build in parallel
template <int kMaxN, int kC>
int launch_bwd(const void* x, const void* w, const void* g, const int* d, int n_layers, int act, int out_act,
               long long n, void* scratch, void* dx, void* hbuf, void* dzbuf, void* gscr, void* zf,
               cudaStream_t st) {
    unsigned char* pk = static_cast<unsigned char*>(scratch);
    const Plan pl = plan(d, n_layers, act);
    const int err = pack(w, pl, n_layers, pk, true, st);
    if (err != 0) return err;
    Params p = {};
    p.x = static_cast<const float*>(x);
    p.pk = pk;
    p.L = n_layers;
    p.act = act;
    p.out_act = out_act;
    p.n = n;
    p.g = static_cast<const float*>(g);
    p.dx = static_cast<float*>(dx);
    p.hbuf = static_cast<__nv_bfloat16*>(hbuf);
    p.dzbuf = static_cast<__nv_bfloat16*>(dzbuf);
    p.gscr = static_cast<float*>(gscr);
    p.zf = static_cast<float*>(zf);
    return launch_wide<kMaxN, kC, true>(p, pl, st);
}

}  // namespace

