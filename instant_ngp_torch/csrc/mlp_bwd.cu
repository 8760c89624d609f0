// Kernel F: fused bias-free MLP, backward.
//
// Replaces the autodiff backward of instant_ngp_tpu/ops/pallas/
// mlp_kernel.py::fused_mlp (mlp_kernel.py:106-111, the vjp of
// _reference_forward) and of ops/mlp.py::MLP.__call__ (mlp.py:94-101).
// Plain version: instant_ngp_torch/ops/mlp_kernel.py::fused_mlp_bwd_plain.
//
// Contract (JAX's vjp of MLP.__call__): the hidden activations are
// recomputed from x and the weights, both bf16; every product takes the
// f32 cotangent against a bf16 operand in f32, and each result (dh per
// layer, dX, every dW) is rounded to bf16. The ReLU mask comes from the f32
// pre-activation and is 0.5 where it is exactly 0, as JAX differentiates
// jnp.maximum. The cotangent g stays f32: it is never rounded before a
// product. This kernel leaves dW as f32 sums; the wrapper rounds them to
// bf16 afterwards.
//
// Why bf16 tensor cores compute that contract: only the output cotangent g
// is not a bf16 value. Every inner cotangent is dz = bf16(dh)·act' with
// act' in {0, 1/2, 1}, exactly a bf16 value, and h, x and W are bf16, so a
// bf16 mma with f32 accumulation forms the same products as the plain
// version's f32 ones. g enters as three bf16 terms, hi = bf16(g), mid =
// bf16(g - hi) and lo = g - hi - mid, in three mma passes on the last layer
// only: f32 has 24 significant bits and bf16 8, so hi + mid + lo is g
// exactly and the products are the plain version's. Two terms (g to ~2^-17
// relative) are not enough: the error flips intermediate bf16 roundings of
// dh, and ~6 % of the first layer's dW values then differ from JAX's by a
// bf16 step (tests/test_torch_bwd_design.py). TF32 would round g to 2^-11.
//
// What bounds it on an H100: per row, the recompute, dh and dW products of
// widths <= 64 (9,408 multiply-adds a row for the two NeRF MLPs together, 3
// times over) against 64 + 4·out + 4·in bytes of row traffic. On tensor
// cores the products take ~1/20 of the time the bytes take, so the bound is
// the bytes; what the kernel actually spends is latency: shared-memory
// staging between the row-major and the transposed products, and the block
// barriers around them.
//
// Design: persistent blocks of 8 warps walk tiles of up to 128 rows (16 a
// warp; 64, 32 or 16 where a deep MLP's staging would not fit shared
// memory). All products are warp-level mma.sync m16n8k16 (bf16 in, f32
// accumulate), widths padded to 16 with zeros as in kernel B. Each block
// lays the weights out in shared memory in kernel B's layout (each layer
// transposed, (out, in + 8)) from their (in, out) f32 values, rounding them
// to bf16, and rounds the f32 input to bf16 as it reads it, so the wrapper
// launches on the tensors as they are (a small backward is bound by its
// host overhead).
// - Phase 1, per warp and its 16 rows: the forward again (kernel B's
//   fragment chain), keeping each hidden layer's ReLU mask (2 bits a value,
//   in shared memory); then g's three terms (hi as A fragments in
//   registers, mid and lo read back from the shared tile) and the dh chain
//   layer by layer: dh_i = dz_i·W_i^T, rounded to bf16, times the mask
//   gives dz_{i-1}, whose accumulator fragments are the next A fragments.
//   Each h_i and dz_i (and g's mid and lo terms) is also stored transposed,
//   (width, rows), into the block's shared tile. dX is written from the
//   last accumulators.
// - Phase 2, after a barrier: dW_i = h_i^T·dz_i over the tile's rows, with
//   the tile's rows as the mma's k. Every dW is cut into 16x8 mma tiles,
//   dealt round-robin to the warps, and each warp keeps its tiles' f32 sums
//   in registers for the whole persistent loop (7 tiles, 28 registers a
//   thread, for the rgb MLP's 7,168 dW values).
// - At the end, one global f32 atomicAdd per dW element per block.
// A ragged last tile reads zero rows and a zero cotangent past n, which add
// nothing to dW; dX is written for rows below n only.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLayers = 8;
constexpr int kMaxWidth = 64;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxTileRows = 16 * kWarps;
constexpr int kRowPad = 8;  // bf16 values of padding per shared row (bank spread)
constexpr int kRelu = 1;

struct Dims {
    int n_layers;
    int d[kMaxLayers + 1];       // real widths
    int p[kMaxLayers + 1];       // widths padded to multiples of 16
    int wt_off[kMaxLayers];      // bf16 offset of W_i^T, (p_out, p_in + kRowPad)
    int w_off[kMaxLayers];       // offset of dW_i, (d_in, d_out), in dw
    int h_off[kMaxLayers];       // first transposed row of h_i in the h tile
    int z_off[kMaxLayers + 1];   // first transposed row of dz_i; z_off[L]: g's mid, then lo term
    int t_off[kMaxLayers + 1];   // first dW mma tile of layer i; t_off[L]: their count
    int w_total;                 // bf16 values of the shared weights
    int h_rows, z_rows;          // transposed rows of the h and dz tiles
};

// each layer's f32 weights, (d_in, d_out)
struct Weights {
    const float* p[kMaxLayers];
};

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

// two values rounded to bf16, packed low = first (smaller column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

// the three bf16 terms of v (hi, mid, lo), which sum to v exactly
__device__ __forceinline__ void split3(float v, float t[3]) {
    t[0] = bf16_round(v);
    const float r = v - t[0];
    t[1] = bf16_round(r);
    t[2] = r - t[1];
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float act_fwd(int act, float z) { return act == kRelu ? fmaxf(z, 0.0f) : z; }

// d act / d z as a code: 0, 1, 2 for 0, 1/2, 1
__device__ __forceinline__ uint64_t act_code(int act, float z) {
    if (act != kRelu) return 2u;
    return z > 0.0f ? 2u : (z == 0.0f ? 1u : 0u);
}

// the packed pair v (columns col, col + 1 of one row) into the transposed
// tile t (row stride `stride`) at column `row`
__device__ __forceinline__ void store_t(__nv_bfloat16* t, int stride, int col, int row, uint32_t v) {
    unsigned short* s = reinterpret_cast<unsigned short*>(t);
    s[col * stride + row] = (unsigned short)(v & 0xffffu);
    s[(col + 1) * stride + row] = (unsigned short)(v >> 16);
}

// the B fragment (k = o, n = kin) of dh = dz·W^T from W^T stored (out, in):
// the two k values of a register lie in two rows
__device__ __forceinline__ uint32_t ld_pair_rows(const __nv_bfloat16* p, int stride) {
    const unsigned short* s = reinterpret_cast<const unsigned short*>(p);
    return (uint32_t)s[0] | ((uint32_t)s[stride] << 16);
}

// the layer and (m, n) block of dW mma tile t
__device__ __forceinline__ void dw_tile(const Dims& dm, int t, int& i, int& mb, int& nb) {
    i = 0;
    while (t >= dm.t_off[i + 1]) ++i;
    const int local = t - dm.t_off[i];
    const int n_nb = dm.p[i + 1] / 8;
    mb = local / n_nb;
    nb = local - mb * n_nb;
}

template <int kTW>
__global__ void __launch_bounds__(kThreads, kTW <= 8 ? 2 : 1)
mlp_bwd_kernel(const float* __restrict__ x, Weights w,
               const float* __restrict__ g, Dims dm, int act, int tile_rows, long long n,
               float* __restrict__ dx, float* __restrict__ dw) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int ts = tile_rows + kRowPad;  // row stride of the transposed tiles
    __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem_raw);
    __nv_bfloat16* ht = ws + dm.w_total;
    __nv_bfloat16* zt = ht + dm.h_rows * ts;
    uint64_t* masks = reinterpret_cast<uint64_t*>(zt + dm.z_rows * ts);  // [layer][warp][lane]
    // the weights in kernel B's layout, rounded to bf16: each layer
    // transposed, (p_out, p_in + kRowPad), zero-padded; layer i is f32 (d_in,
    // d_out) at w.p[i]
    for (int i = 0; i < dm.n_layers; ++i) {
        const int din = dm.d[i], dout = dm.d[i + 1], stride = dm.p[i] + kRowPad;
        const float* wl = w.p[i];
        for (int e = threadIdx.x; e < dm.p[i + 1] * stride; e += kThreads) {
            const int o = e / stride, k = e - o * stride;
            ws[dm.wt_off[i] + e] = __float2bfloat16_rn(o < dout && k < din ? wl[k * dout + o] : 0.0f);
        }
    }
    __syncthreads();

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int gq = lane >> 2;   // fragment row group
    const int tig = lane & 3;   // thread in group
    const int L = dm.n_layers;
    const int p0 = dm.p[0], d0 = dm.d[0], pL = dm.p[L], dL = dm.d[L];
    auto x_pair = [&](long long r, int c) -> uint32_t {  // x[r, c:c+2] rounded to bf16
        const float v0 = r < n && c < d0 ? x[r * d0 + c] : 0.0f;
        const float v1 = r < n && c + 1 < d0 ? x[r * d0 + c + 1] : 0.0f;
        return pack_bf16(v0, v1);
    };
    const int n_dw_tiles = dm.t_off[L];

    float dwacc[kTW][4];
#pragma unroll
    for (int j = 0; j < kTW; ++j) dwacc[j][0] = dwacc[j][1] = dwacc[j][2] = dwacc[j][3] = 0.0f;

    const long long n_tiles = (n + tile_rows - 1) / tile_rows;
    for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        // ---- phase 1: this warp's 16 rows ----
        if (warp * 16 < tile_rows) {
            const int c0 = warp * 16 + gq, c1 = c0 + 8;  // columns in the transposed tiles
            const long long r0 = tile * tile_rows + c0, r1 = r0 + 8;
            uint32_t a[kMaxWidth / 16][4];
            __nv_bfloat16* h0 = ht + dm.h_off[0] * ts;
#pragma unroll
            for (int kb = 0; kb < kMaxWidth / 16; ++kb) {
                if (kb * 16 < p0) {
                    const int c = kb * 16 + tig * 2;
                    a[kb][0] = x_pair(r0, c);
                    a[kb][1] = x_pair(r1, c);
                    a[kb][2] = x_pair(r0, c + 8);
                    a[kb][3] = x_pair(r1, c + 8);
                    store_t(h0, ts, c, c0, a[kb][0]);
                    store_t(h0, ts, c, c1, a[kb][1]);
                    store_t(h0, ts, c + 8, c0, a[kb][2]);
                    store_t(h0, ts, c + 8, c1, a[kb][3]);
                }
            }
            // the forward through the hidden layers: masks and h_{i+1}
            for (int i = 0; i < L - 1; ++i) {
                const int kin = dm.p[i], kout = dm.p[i + 1];
                const int stride = kin + kRowPad;
                const __nv_bfloat16* wt = ws + dm.wt_off[i];
                float acc[kMaxWidth / 8][4];
#pragma unroll
                for (int nb = 0; nb < kMaxWidth / 8; ++nb) {
                    acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.0f;
                    if (nb * 8 < kout) {
                        const __nv_bfloat16* wrow = wt + (nb * 8 + gq) * stride + tig * 2;
#pragma unroll
                        for (int kb = 0; kb < kMaxWidth / 16; ++kb) {
                            if (kb * 16 < kin)
                                mma_bf16(acc[nb], a[kb], ld32(wrow + kb * 16), ld32(wrow + kb * 16 + 8));
                        }
                    }
                }
                uint64_t m = 0;
#pragma unroll
                for (int nb = 0; nb < kMaxWidth / 8; ++nb) {
                    if (nb * 8 < kout) {
#pragma unroll
                        for (int e = 0; e < 4; ++e) m |= act_code(act, acc[nb][e]) << (2 * (nb * 4 + e));
                    }
                }
                masks[(i * kWarps + warp) * 32 + lane] = m;
                __nv_bfloat16* hn = ht + dm.h_off[i + 1] * ts;
#pragma unroll
                for (int kb = 0; kb < kMaxWidth / 16; ++kb) {
                    if (kb * 16 < kout) {
                        const float* lo = acc[2 * kb];
                        const float* hi = acc[2 * kb + 1];
                        a[kb][0] = pack_bf16(act_fwd(act, lo[0]), act_fwd(act, lo[1]));
                        a[kb][1] = pack_bf16(act_fwd(act, lo[2]), act_fwd(act, lo[3]));
                        a[kb][2] = pack_bf16(act_fwd(act, hi[0]), act_fwd(act, hi[1]));
                        a[kb][3] = pack_bf16(act_fwd(act, hi[2]), act_fwd(act, hi[3]));
                        const int c = kb * 16 + tig * 2;
                        store_t(hn, ts, c, c0, a[kb][0]);
                        store_t(hn, ts, c, c1, a[kb][1]);
                        store_t(hn, ts, c + 8, c0, a[kb][2]);
                        store_t(hn, ts, c + 8, c1, a[kb][3]);
                    }
                }
            }
            // the output cotangent (output activation none) as hi + mid +
            // lo: hi in a, all three in the shared tile (the hi rows are
            // dz_{L-1}'s); rows past n and padded columns are 0
            auto g_tile = [&](int q) {  // term q: hi in dz_{L-1}'s rows, then mid and lo
                return zt + (q == 0 ? dm.z_off[L - 1] : dm.z_off[L] + (q - 1) * pL) * ts;
            };
#pragma unroll
            for (int kb = 0; kb < kMaxWidth / 16; ++kb) {
                if (kb * 16 < pL) {
#pragma unroll
                    for (int half = 0; half < 2; ++half) {
                        const int c = kb * 16 + half * 8 + tig * 2;
#pragma unroll
                        for (int rr = 0; rr < 2; ++rr) {
                            const long long r = rr == 0 ? r0 : r1;
                            float t0[3], t1[3];
                            split3(r < n && c < dL ? g[r * dL + c] : 0.0f, t0);
                            split3(r < n && c + 1 < dL ? g[r * dL + c + 1] : 0.0f, t1);
#pragma unroll
                            for (int q = 0; q < 3; ++q)
                                store_t(g_tile(q), ts, c, rr == 0 ? c0 : c1, pack_bf16(t0[q], t1[q]));
                            a[kb][half * 2 + rr] = pack_bf16(t0[0], t1[0]);
                        }
                    }
                }
            }
            // the dh chain: a holds dz_i's A fragments
            for (int i = L - 1; i >= 0; --i) {
                const int kin = dm.p[i], kout = dm.p[i + 1];
                const int stride = kin + kRowPad;
                const __nv_bfloat16* wt = ws + dm.wt_off[i];
                float acc[kMaxWidth / 8][4];
#pragma unroll
                for (int nb = 0; nb < kMaxWidth / 8; ++nb)
                    acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.0f;
                // the last layer takes g's three terms: hi from a, mid and lo
                // from the shared tile, where this lane stored them
                const int n_terms = i == L - 1 ? 3 : 1;
                for (int q = 0; q < n_terms; ++q) {
#pragma unroll
                    for (int kb = 0; kb < kMaxWidth / 16; ++kb) {
                        if (kb * 16 < kout) {
                            uint32_t f[4];
#pragma unroll
                            for (int e = 0; e < 4; ++e)
                                f[e] = q == 0 ? a[kb][e]
                                              : ld_pair_rows(g_tile(q) + (kb * 16 + (e >> 1) * 8 + tig * 2) * ts +
                                                                 ((e & 1) ? c1 : c0), ts);
#pragma unroll
                            for (int nb = 0; nb < kMaxWidth / 8; ++nb) {
                                if (nb * 8 < kin) {
                                    // B[k = o][n = kin] = W^T[o][kin]
                                    const __nv_bfloat16* wcol = wt + (kb * 16 + tig * 2) * stride + nb * 8 + gq;
                                    mma_bf16(acc[nb], f, ld_pair_rows(wcol, stride),
                                             ld_pair_rows(wcol + 8 * stride, stride));
                                }
                            }
                        }
                    }
                }
                if (i > 0) {
                    // dz_{i-1} = bf16(dh_i)·act'(z_{i-1}): exactly a bf16 value
                    const uint64_t m = masks[((i - 1) * kWarps + warp) * 32 + lane];
                    __nv_bfloat16* zn = zt + dm.z_off[i - 1] * ts;
#pragma unroll
                    for (int kb = 0; kb < kMaxWidth / 16; ++kb) {
                        if (kb * 16 < kin) {
#pragma unroll
                            for (int half = 0; half < 2; ++half) {
                                const int nb = 2 * kb + half;
                                float v[4];
#pragma unroll
                                for (int e = 0; e < 4; ++e)
                                    v[e] = bf16_round(acc[nb][e]) *
                                           (0.5f * (float)((m >> (2 * (nb * 4 + e))) & 3u));
                                const int c = nb * 8 + tig * 2;
                                a[kb][half * 2] = pack_bf16(v[0], v[1]);
                                a[kb][half * 2 + 1] = pack_bf16(v[2], v[3]);
                                store_t(zn, ts, c, c0, a[kb][half * 2]);
                                store_t(zn, ts, c, c1, a[kb][half * 2 + 1]);
                            }
                        }
                    }
                } else {
#pragma unroll
                    for (int nb = 0; nb < kMaxWidth / 8; ++nb) {
                        const int c = nb * 8 + tig * 2;
                        if (nb * 8 < kin) {
                            if (r0 < n && c < d0) dx[r0 * d0 + c] = bf16_round(acc[nb][0]);
                            if (r0 < n && c + 1 < d0) dx[r0 * d0 + c + 1] = bf16_round(acc[nb][1]);
                            if (r1 < n && c < d0) dx[r1 * d0 + c] = bf16_round(acc[nb][2]);
                            if (r1 < n && c + 1 < d0) dx[r1 * d0 + c + 1] = bf16_round(acc[nb][3]);
                        }
                    }
                }
            }
        }
        __syncthreads();
        // ---- phase 2: dW_i += h_i^T · dz_i over the tile's rows ----
#pragma unroll
        for (int j = 0; j < kTW; ++j) {
            const int t = warp + kWarps * j;
            if (t < n_dw_tiles) {
                int i, mb, nb;
                dw_tile(dm, t, i, mb, nb);
                const __nv_bfloat16* pa = ht + (dm.h_off[i] + mb * 16 + gq) * ts + tig * 2;
                const __nv_bfloat16* pb = zt + (dm.z_off[i] + nb * 8 + gq) * ts + tig * 2;
                // g's mid and lo terms, for the last layer
                const __nv_bfloat16* pm = zt + (dm.z_off[L] + nb * 8 + gq) * ts + tig * 2;
                const __nv_bfloat16* pl = pm + pL * ts;
                for (int k = 0; k < tile_rows; k += 16) {
                    const uint32_t fa[4] = {ld32(pa + k), ld32(pa + 8 * ts + k), ld32(pa + k + 8),
                                            ld32(pa + 8 * ts + k + 8)};
                    mma_bf16(dwacc[j], fa, ld32(pb + k), ld32(pb + k + 8));
                    if (i == L - 1) {
                        mma_bf16(dwacc[j], fa, ld32(pm + k), ld32(pm + k + 8));
                        mma_bf16(dwacc[j], fa, ld32(pl + k), ld32(pl + k + 8));
                    }
                }
            }
        }
        __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < kTW; ++j) {
        const int t = warp + kWarps * j;
        if (t < n_dw_tiles) {
            int i, mb, nb;
            dw_tile(dm, t, i, mb, nb);
            const int din = dm.d[i], dout = dm.d[i + 1];
            float* dwl = dw + dm.w_off[i];
            const int m0 = mb * 16 + gq, m1 = m0 + 8, c = nb * 8 + tig * 2;
            if (m0 < din && c < dout) atomicAdd(dwl + m0 * dout + c, dwacc[j][0]);
            if (m0 < din && c + 1 < dout) atomicAdd(dwl + m0 * dout + c + 1, dwacc[j][1]);
            if (m1 < din && c < dout) atomicAdd(dwl + m1 * dout + c, dwacc[j][2]);
            if (m1 < din && c + 1 < dout) atomicAdd(dwl + m1 * dout + c + 1, dwacc[j][3]);
        }
    }
}

// The device's SM count and shared-memory limit, read once: the package
// runs on one card.
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

template <int kTW>
int launch(const float* x, const Weights& w, const float* g, const Dims& dm, int act,
           int tile_rows, size_t smem, long long n, float* dx, float* dw, cudaStream_t st) {
    // the shared-memory opt-in and the occupancy of the last size, kept
    // across launches (host API calls cost more than a small launch)
    static size_t set_smem = 0, occ_smem = 0;
    static int per_sm = 1;
    if (smem > set_smem) {
        const cudaError_t err = cudaFuncSetAttribute(
            mlp_bwd_kernel<kTW>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        set_smem = smem;
    }
    if (smem != occ_smem) {
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mlp_bwd_kernel<kTW>, kThreads, smem);
        occ_smem = smem;
    }
    const int n_sm = device_info().n_sm;
    const long long n_tiles = (n + tile_rows - 1) / tile_rows;
    const long long want = (long long)n_sm * (per_sm > 0 ? per_sm : 1);
    const unsigned blocks = (unsigned)(n_tiles < want ? n_tiles : want);
    mlp_bwd_kernel<kTW><<<blocks, kThreads, smem, st>>>(x, w, g, dm, act, tile_rows, n, dx, dw);
    return (int)cudaGetLastError();
}

}  // namespace

// x: (n, d_0) f32, rounded to bf16 here; w: n_layers pointers, layer i f32
// (d_i, d_{i+1}), rounded to bf16 here; dims: the widths d_0 .. d_L.
extern "C" int ngp_fused_mlp_bwd(const void* x, const void* w, const void* g, const void* dims,
                                 int n_layers, int act, long long n, void* dx, void* dw,
                                 void* stream) {
    if (n_layers < 1 || n_layers > kMaxLayers) return (int)cudaErrorInvalidValue;
    Dims dm;
    dm.n_layers = n_layers;
    const int* d = static_cast<const int*>(dims);
    for (int i = 0; i <= n_layers; ++i) {
        if (d[i] < 1 || d[i] > kMaxWidth) return (int)cudaErrorInvalidValue;
        dm.d[i] = d[i];
        dm.p[i] = (d[i] + 15) / 16 * 16;
    }
    int wt = 0, wo = 0, hr = 0, zr = 0, tt = 0;
    for (int i = 0; i < n_layers; ++i) {
        dm.wt_off[i] = wt;
        dm.w_off[i] = wo;
        dm.h_off[i] = hr;
        dm.z_off[i] = zr;
        dm.t_off[i] = tt;
        wt += dm.p[i + 1] * (dm.p[i] + kRowPad);
        wo += d[i] * d[i + 1];
        hr += dm.p[i];
        zr += dm.p[i + 1];
        tt += (dm.p[i] / 16) * (dm.p[i + 1] / 8);
    }
    dm.z_off[n_layers] = zr;
    zr += 2 * dm.p[n_layers];  // g's mid and lo terms
    dm.t_off[n_layers] = tt;
    dm.w_total = wt;
    dm.h_rows = hr;
    dm.z_rows = zr;
    // the most rows a tile can stage in shared memory
    const size_t smem_max = (size_t)device_info().smem_optin;
    int tile_rows = kMaxTileRows;
    size_t smem = 0;
    for (; tile_rows >= 16; tile_rows /= 2) {
        smem = sizeof(__nv_bfloat16) * ((size_t)wt + (size_t)(hr + zr) * (tile_rows + kRowPad)) +
               sizeof(uint64_t) * (size_t)(n_layers - 1) * kThreads;
        if (smem <= smem_max) break;
    }
    if (tile_rows < 16) return (int)cudaErrorInvalidValue;
    const int per_warp = (tt + kWarps - 1) / kWarps;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* xp = static_cast<const float*>(x);
    Weights wp;
    for (int i = 0; i < n_layers; ++i) wp.p[i] = static_cast<const float* const*>(w)[i];
    const float* gp = static_cast<const float*>(g);
    float* dxp = static_cast<float*>(dx);
    float* dwp = static_cast<float*>(dw);
    if (per_warp <= 8) return launch<8>(xp, wp, gp, dm, act, tile_rows, smem, n, dxp, dwp, st);
    if (per_warp <= 16) return launch<16>(xp, wp, gp, dm, act, tile_rows, smem, n, dxp, dwp, st);
    return launch<32>(xp, wp, gp, dm, act, tile_rows, smem, n, dxp, dwp, st);
}
