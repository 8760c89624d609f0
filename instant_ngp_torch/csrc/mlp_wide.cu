// Kernels B and F past the narrow kernels' limits: the fused bias-free MLP,
// forward (B) and backward (F), at any depth, layer widths up to 256, and
// relu, none, sigmoid or exponential as the hidden and the output activation.
//
// Replaces the same Pallas kernel as csrc/mlp.cu and csrc/mlp_bwd.cu:
// instant_ngp_tpu/ops/pallas/mlp_kernel.py::_fused_mlp_fwd_impl (public
// fused_mlp), which takes any widths, any depth and those four activations
// (mlp_kernel.py:40-50), and its backward, the vjp of _reference_forward
// (mlp_kernel.py:106-111). Plain versions: instant_ngp_torch/ops/
// mlp_kernel.py::fused_mlp_plain and fused_mlp_bwd_plain. The wrapper routes
// an MLP here where kernel B or F (csrc/mlp.cu, csrc/mlp_bwd.cu: widths <= 64,
// <= 8 matrices, relu/none) does not take it.
//
// Contract: as csrc/mlp.cu and csrc/mlp_bwd.cu. Sigmoid and exponential are
// computed on the f32 accumulator and then rounded to bf16, as the plain
// version does; their derivatives are s·(1 − s) and e^z of the f32 values, as
// JAX differentiates jax.nn.sigmoid and jnp.exp.
//
// What bounds it on an H100: at 128 wide the products are no longer nearly
// free. image/oneblob.json (256 -> 128 x 8 -> 3, 147,840 weights) does 2·147,840
// operations a row for 1 KB of f32 input: ~0.08 ms each for the products (989
// TFLOP/s bf16) and the bytes (3.35 TB/s) at 2^18 rows. The weights no longer
// fit shared memory at once (~316 KB in bf16, padded, against 227 KB a block).
//
// Design, forward (B, and F's recompute, one device function): persistent
// blocks of 8 warps walk tiles of 128 rows, one m16 row block a warp.
// - The wrapper's scratch holds every layer's weights once, rounded to bf16 and
//   laid out by a small packing kernel per layer: transposed, (p_out, p_in + 8),
//   zero-padded to multiples of 16 (kernel B's layout); for F also untransposed,
//   (p_in, p_out + 8), the B operand of dh = dz·W^T. Its header holds the widths,
//   which the block reads into shared memory: no fixed arrays of layers.
// - The weights stream through two shared-memory stages of 64 output rows
//   each (cp.async, 16-byte pieces, all L2 hits after the first block): the
//   next chunk, of this layer, the next layer or the next tile, lands while
//   this chunk's products run. One barrier a chunk.
// - A warp's activations never leave the SM: the A fragments of its 16 rows
//   sit in registers (a[width / 16][4]); those of the next layer, built chunk
//   by chunk from the accumulators of 64 output columns (acc[8][4]) after the
//   activation and the bf16 rounding, are parked in shared memory, each lane's
//   own words (the accumulator and A fragment layouts put a column pair in the
//   same lane), and read back once the layer is done. The mma order of each
//   accumulator is kernel B's: k blocks ascending from zero, so B, F's
//   recompute and the narrow kernels agree bit for bit. The input is read from
//   global memory straight into the A fragments (32 bytes of a row a lane
//   group, whole sectors) and the output written from the accumulators.
// - Two instantiations: widths <= 128 (128 registers, two blocks an SM) and
//   <= 256 (about 200, one block; 132 KB of shared memory).
//
// Design, backward (F): the same forward per tile, which also writes h_i
// (every layer's input, f32 copies of bf16 values) and each hidden layer's
// activation derivative act'(z) to global memory; then, per warp and its rows,
// the dh chain, layer by layer from the last: dz_{L-1} = g·act_out'(z_L), dh_i
// = dz_i·W_i^T on tensor cores, dz_{i-1} = bf16(dh_i)·act'(z_i), dX =
// bf16(dh_0). dz is an f32 value wherever it is not bf16 (g, and every dz under
// a sigmoid or exponential hidden layer), so its A fragments enter as the
// three bf16 terms of kernel F's split (hi + mid + lo = dz exactly), read back
// from global memory; a bf16 dz (relu/none hidden) enters as one. Each lane
// reads back only what it wrote itself (the accumulator and A fragment layouts
// put a column pair in the same lane), so no barrier orders them. Every dz_i is
// kept in global memory in f32 for the weight gradient dW_i = h_i^T·dz_i, which
// the wrapper forms with one f32 matrix product a layer (TF32 off): the JAX
// package too leaves that product to XLA, outside its Pallas kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileRows = 16 * kWarps;  // one m16 row block a warp
constexpr int kChunk = 64;              // weight rows a shared-memory stage holds
constexpr int kRowPad = 8;              // bf16 values of padding a weight row (bank spread)
constexpr int kMaxWidth = 256;
constexpr int kLayerInts = 8;  // per layer: d_in, d_out, p_in, p_out, fwd off, bwd off, h col, z col
constexpr int kRelu = 1, kSigmoid = 2, kExp = 3;

__host__ __device__ inline int pad16(int v) { return (v + 15) / 16 * 16; }

// bytes before the packed weights: the widths d_0 .. d_L, 16-byte aligned
__host__ __device__ inline int header_bytes(int n_layers) { return ((n_layers + 1) * 4 + 15) / 16 * 16; }

// layer i's record (kLayerInts ints) from the widths: the packed weights are
// every forward layout (p_out, p_in + 8), then every backward layout (p_in,
// p_out + 8); h_i and dz_i start at columns h col and z col of (n, Σ d) arrays
__host__ __device__ inline void layer_record(const int* d, int n_layers, int i, int* rec) {
    int fo = 0, bo = 0, hc = 0, zc = 0;
    for (int j = 0; j < n_layers; ++j) bo += pad16(d[j + 1]) * (pad16(d[j]) + kRowPad);
    for (int j = 0; j < i; ++j) {
        fo += pad16(d[j + 1]) * (pad16(d[j]) + kRowPad);
        bo += pad16(d[j]) * (pad16(d[j + 1]) + kRowPad);
        hc += d[j];
        zc += d[j + 1];
    }
    rec[0] = d[i];
    rec[1] = d[i + 1];
    rec[2] = pad16(d[i]);
    rec[3] = pad16(d[i + 1]);
    rec[4] = fo;
    rec[5] = bo;
    rec[6] = hc;
    rec[7] = zc;
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
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

__device__ __forceinline__ float activate(float v, int act) {
    if (act == kRelu) return fmaxf(v, 0.0f);
    if (act == kSigmoid) return 1.0f / (1.0f + expf(-v));
    if (act == kExp) return expf(v);
    return v;
}

// d act / d z at the f32 pre-activation z, as JAX differentiates it
__device__ __forceinline__ float act_grad(float z, int act) {
    if (act == kRelu) return z > 0.0f ? 1.0f : (z == 0.0f ? 0.5f : 0.0f);
    if (act == kSigmoid) {
        const float s = activate(z, kSigmoid);
        return s * (1.0f - s);
    }
    if (act == kExp) return expf(z);
    return 1.0f;
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// layer i's f32 (din, dout) weights w into the packed bf16 layouts, zero-padded:
// fwd (pout, pin + 8) transposed; bwd (pin, pout + 8), where not null. Block 0
// also writes the widths this launch knows into the header.
__global__ void pack_layer(const float* __restrict__ w, int din, int dout, __nv_bfloat16* fwd,
                           __nv_bfloat16* bwd, int* header, int i, int last) {
    const int pin = pad16(din), pout = pad16(dout);
    const int fs = pin + kRowPad, bs = pout + kRowPad;
    const int n_f = pout * fs, n_all = n_f + (bwd != nullptr ? pin * bs : 0);
    if (blockIdx.x == 0 && threadIdx.x == 0) {
        header[i] = din;
        if (last) header[i + 1] = dout;
    }
    for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n_all; e += gridDim.x * blockDim.x) {
        if (e < n_f) {
            const int o = e / fs, k = e - o * fs;
            fwd[e] = __float2bfloat16_rn(o < dout && k < din ? w[k * dout + o] : 0.0f);
        } else {
            const int e2 = e - n_f, k = e2 / bs, o = e2 - k * bs;
            bwd[e2] = __float2bfloat16_rn(k < din && o < dout ? w[k * dout + o] : 0.0f);
        }
    }
}

// the chunks a tile consumes, in order, as (bf16 offset into the packed
// weights, 16-byte pieces): the forward's layers 0 .. L-1, each in chunks of
// kChunk output rows; for F then the backward's layers L-1 .. 0, each in
// chunks of kChunk input rows
__host__ __device__ inline int chunk_count(const int* d, int n_layers, bool bwd) {
    int c = 0;
    for (int i = 0; i < n_layers; ++i) {
        c += (pad16(d[i + 1]) + kChunk - 1) / kChunk;
        if (bwd) c += (pad16(d[i]) + kChunk - 1) / kChunk;
    }
    return c;
}

template <int kKB>
__host__ __device__ constexpr int stage_values() {
    return kChunk * (16 * kKB + kRowPad);
}

// the next layer's A fragments, parked: kKB·4 words a lane
template <int kKB>
__host__ __device__ constexpr int act_words() {
    return kThreads * kKB * 4;
}

template <int kKB>
size_t smem_bytes(int n_layers, int n_chunks) {
    return sizeof(__nv_bfloat16) * 2 * (size_t)stage_values<kKB>() + sizeof(uint32_t) * act_words<kKB>() +
           sizeof(int) * ((size_t)kLayerInts * n_layers + 2 * (size_t)n_chunks);
}

// x[r, c:c+2] rounded to bf16, zero past n rows or d0 columns
__device__ __forceinline__ uint32_t x_pair(const float* __restrict__ x, long long r, int c, long long n,
                                           int d0) {
    const float v0 = r < n && c < d0 ? x[r * d0 + c] : 0.0f;
    const float v1 = r < n && c + 1 < d0 ? x[r * d0 + c + 1] : 0.0f;
    return pack_bf16(v0, v1);
}

// the pair (v0, v1) into columns c, c + 1 of row r of the (n, w) f32 array z
__device__ __forceinline__ void store_pair(float* z, long long r, int c, long long n, int w, float v0,
                                           float v1) {
    if (r < n && c < w) z[r * w + c] = v0;
    if (r < n && c + 1 < w) z[r * w + c + 1] = v1;
}

__device__ __forceinline__ float lo_half(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_half(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// term q of dz[r, c:c+2] (f32, (n, w)), packed bf16; zero past n rows or w columns
__device__ __forceinline__ uint32_t dz_pair(const float* dz, long long r, int c, long long n, int w, int q) {
    const float v0 = r < n && c < w ? dz[r * w + c] : 0.0f;
    const float v1 = r < n && c + 1 < w ? dz[r * w + c + 1] : 0.0f;
    return pack_bf16(split_term(v0, q), split_term(v1, q));
}

template <int kKB, bool kBwd>
__global__ void __launch_bounds__(kThreads, kKB <= 8 ? 2 : 1)
mlp_wide_kernel(const float* __restrict__ x, const unsigned char* __restrict__ pk, int L, int act,
                int out_act, long long n, float* __restrict__ out, const float* __restrict__ g,
                float* __restrict__ dx, float* hbuf, float* dzbuf, float* __restrict__ zf) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    constexpr int kStage = stage_values<kKB>();
    __nv_bfloat16* stages = reinterpret_cast<__nv_bfloat16*>(smem_raw);
    uint32_t* s_act = reinterpret_cast<uint32_t*>(stages + 2 * kStage);  // [warp][kb][4][lane]
    int* s_l = reinterpret_cast<int*>(s_act + act_words<kKB>());
    int* s_c = s_l + kLayerInts * L;
    __shared__ int s_nc;
    const int* dims = reinterpret_cast<const int*>(pk);
    const __nv_bfloat16* wpk = reinterpret_cast<const __nv_bfloat16*>(pk + header_bytes(L));
    if (threadIdx.x == 0) {
        int nc = 0;
        for (int i = 0; i < L; ++i) {
            int* rec = s_l + kLayerInts * i;
            layer_record(dims, L, i, rec);
            for (int c = 0; c * kChunk < rec[3]; ++c) {
                const int rows = rec[3] - c * kChunk < kChunk ? rec[3] - c * kChunk : kChunk;
                s_c[2 * nc] = rec[4] + c * kChunk * (rec[2] + kRowPad);
                s_c[2 * nc + 1] = rows * (rec[2] + kRowPad) / 8;
                ++nc;
            }
        }
        if (kBwd) {
            for (int i = L - 1; i >= 0; --i) {
                const int* rec = s_l + kLayerInts * i;
                for (int c = 0; c * kChunk < rec[2]; ++c) {
                    const int rows = rec[2] - c * kChunk < kChunk ? rec[2] - c * kChunk : kChunk;
                    s_c[2 * nc] = rec[5] + c * kChunk * (rec[3] + kRowPad);
                    s_c[2 * nc + 1] = rows * (rec[3] + kRowPad) / 8;
                    ++nc;
                }
            }
        }
        s_nc = nc;
    }
    __syncthreads();
    const int nc = s_nc;
    const long long n_tiles = (n + kTileRows - 1) / kTileRows;
    const long long my_tiles = blockIdx.x < n_tiles ? (n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
    const long long total = my_tiles * nc;  // chunks this block consumes
    long long q = 0;                        // chunks consumed so far
    // chunk qq of the stream into stage qq & 1
    auto issue = [&](long long qq) {
        const int j = (int)(qq % nc);
        const uint4* src = reinterpret_cast<const uint4*>(wpk + s_c[2 * j]);
        uint4* dst = reinterpret_cast<uint4*>(stages + (qq & 1) * kStage);
        for (int e = threadIdx.x; e < s_c[2 * j + 1]; e += kThreads) cp_async16(dst + e, src + e);
        cp_async_commit();
    };
    // the next chunk, landed for every thread; the one after it in flight
    // into the other stage, which every thread is done with
    auto acquire = [&]() -> const __nv_bfloat16* {
        cp_async_wait_all();
        __syncthreads();
        if (q + 1 < total) issue(q + 1);
        const __nv_bfloat16* st = stages + (q & 1) * kStage;
        ++q;
        return st;
    };
    if (total > 0) issue(0);

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int gq = lane >> 2;  // fragment row group
    const int tig = lane & 3;  // thread in group
    const int d0 = s_l[0], p0 = s_l[2];

    for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const long long r0 = tile * kTileRows + warp * 16 + gq, r1 = r0 + 8;
        uint32_t a[kKB][4];
#pragma unroll
        for (int kb = 0; kb < kKB; ++kb) {
            if (kb * 16 < p0) {
                const int c = kb * 16 + tig * 2;
                a[kb][0] = x_pair(x, r0, c, n, d0);
                a[kb][1] = x_pair(x, r1, c, n, d0);
                a[kb][2] = x_pair(x, r0, c + 8, n, d0);
                a[kb][3] = x_pair(x, r1, c + 8, n, d0);
                if (kBwd) {  // h_0 = bf16(x)
                    store_pair(hbuf, r0, c, n, d0, lo_half(a[kb][0]), hi_half(a[kb][0]));
                    store_pair(hbuf, r1, c, n, d0, lo_half(a[kb][1]), hi_half(a[kb][1]));
                    store_pair(hbuf, r0, c + 8, n, d0, lo_half(a[kb][2]), hi_half(a[kb][2]));
                    store_pair(hbuf, r1, c + 8, n, d0, lo_half(a[kb][3]), hi_half(a[kb][3]));
                }
            }
        }
        // ---- the forward ----
        for (int i = 0; i < L; ++i) {
            const int* rec = s_l + kLayerInts * i;
            const int pin = rec[2], dout = rec[1], pout = rec[3];
            const int stride = pin + kRowPad;
            const bool last = i == L - 1;
            float* zrec = zf != nullptr ? zf + n * rec[7] : nullptr;
            float* dzl = kBwd ? dzbuf + n * rec[7] : nullptr;              // (n, dout)
            float* hn = kBwd && !last ? hbuf + n * (rec[6] + rec[0]) : nullptr;  // h_{i+1}, (n, dout)
            // this lane's A fragments of the next layer, parked in shared
            // memory while this layer's chunks still read a
            uint32_t* an = s_act + warp * kKB * 4 * 32 + lane;
            for (int c = 0; c * kChunk < pout; ++c) {
                const __nv_bfloat16* wt = acquire();
                const int nbs = (pout - c * kChunk) / 8 < 8 ? (pout - c * kChunk) / 8 : 8;
                float acc[8][4];
#pragma unroll
                for (int nb = 0; nb < 8; ++nb) acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.0f;
                const __nv_bfloat16* wrow = wt + gq * stride + tig * 2;
#pragma unroll
                for (int kb = 0; kb < kKB; ++kb) {
                    if (kb * 16 < pin) {
#pragma unroll
                        for (int nb = 0; nb < 8; ++nb) {
                            if (nb < nbs) {
                                const __nv_bfloat16* wp = wrow + nb * 8 * stride + kb * 16;
                                mma_bf16(acc[nb], a[kb], ld32(wp), ld32(wp + 8));
                            }
                        }
                    }
                }
#pragma unroll
                for (int nb = 0; nb < 8; ++nb) {
                    if (nb < nbs) {
                        const int col = c * kChunk + nb * 8 + tig * 2;
                        const float* v = acc[nb];
                        if (zrec != nullptr) {
                            store_pair(zrec, r0, col, n, dout, v[0], v[1]);
                            store_pair(zrec, r1, col, n, dout, v[2], v[3]);
                        }
                        if (last) {
                            if (kBwd) {  // dz_{L-1} = g · act_out'(z_L)
                                float gv[4];
#pragma unroll
                                for (int e = 0; e < 4; ++e) {
                                    const long long r = e < 2 ? r0 : r1;
                                    const int cc = col + (e & 1);
                                    gv[e] = r < n && cc < dout ? g[r * dout + cc] * act_grad(v[e], out_act) : 0.0f;
                                }
                                store_pair(dzl, r0, col, n, dout, gv[0], gv[1]);
                                store_pair(dzl, r1, col, n, dout, gv[2], gv[3]);
                            } else {
                                store_pair(out, r0, col, n, dout, activate(v[0], out_act), activate(v[1], out_act));
                                store_pair(out, r1, col, n, dout, activate(v[2], out_act), activate(v[3], out_act));
                            }
                        } else if (kBwd) {  // act'(z_{i+1}), read back by the dh chain
                            store_pair(dzl, r0, col, n, dout, act_grad(v[0], act), act_grad(v[1], act));
                            store_pair(dzl, r1, col, n, dout, act_grad(v[2], act), act_grad(v[3], act));
                        }
                    }
                }
                if (!last) {
                    // accumulator fragments (n blocks 2j, 2j+1) -> A fragment 4c + j
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        if (2 * j < nbs) {
                            const int kb = 4 * c + j;
                            const float* lo = acc[2 * j];
                            const float* hi = acc[2 * j + 1];
                            const uint32_t f[4] = {pack_bf16(activate(lo[0], act), activate(lo[1], act)),
                                                   pack_bf16(activate(lo[2], act), activate(lo[3], act)),
                                                   pack_bf16(activate(hi[0], act), activate(hi[1], act)),
                                                   pack_bf16(activate(hi[2], act), activate(hi[3], act))};
#pragma unroll
                            for (int e = 0; e < 4; ++e) an[(kb * 4 + e) * 32] = f[e];
                            if (kBwd) {
                                const int col = kb * 16 + tig * 2;
                                store_pair(hn, r0, col, n, dout, lo_half(f[0]), hi_half(f[0]));
                                store_pair(hn, r1, col, n, dout, lo_half(f[1]), hi_half(f[1]));
                                store_pair(hn, r0, col + 8, n, dout, lo_half(f[2]), hi_half(f[2]));
                                store_pair(hn, r1, col + 8, n, dout, lo_half(f[3]), hi_half(f[3]));
                            }
                        }
                    }
                }
            }
            if (!last) {
#pragma unroll
                for (int kb = 0; kb < kKB; ++kb) {
                    if (kb * 16 < pout) {
#pragma unroll
                        for (int e = 0; e < 4; ++e) a[kb][e] = an[(kb * 4 + e) * 32];
                    }
                }
            }
        }
        if constexpr (!kBwd) continue;
        // ---- the dh chain ----
        for (int i = L - 1; i >= 0; --i) {
            const int* rec = s_l + kLayerInts * i;
            const int din = rec[0], dout = rec[1], pin = rec[2], pout = rec[3];
            const int stride = pout + kRowPad;
            const float* dz = dzbuf + n * rec[7];                              // dz_i, (n, dout)
            float* dzp = i > 0 ? dzbuf + n * s_l[kLayerInts * (i - 1) + 7] : nullptr;  // (n, din)
            // a bf16 dz enters as one term, an f32 one as three
            const int n_terms = i == L - 1 || (act != kRelu && act != 0) ? 3 : 1;
            for (int c = 0; c * kChunk < pin; ++c) {
                const __nv_bfloat16* wt = acquire();
                const int nbs = (pin - c * kChunk) / 8 < 8 ? (pin - c * kChunk) / 8 : 8;
                float acc[8][4];
#pragma unroll
                for (int nb = 0; nb < 8; ++nb) acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.0f;
                const __nv_bfloat16* wrow = wt + gq * stride + tig * 2;
                for (int t = 0; t < n_terms; ++t) {
#pragma unroll 4
                    for (int kb = 0; kb * 16 < pout; ++kb) {
                        const int cc = kb * 16 + tig * 2;
                        const uint32_t f[4] = {dz_pair(dz, r0, cc, n, dout, t), dz_pair(dz, r1, cc, n, dout, t),
                                               dz_pair(dz, r0, cc + 8, n, dout, t), dz_pair(dz, r1, cc + 8, n, dout, t)};
#pragma unroll
                        for (int nb = 0; nb < 8; ++nb) {
                            if (nb < nbs) {
                                const __nv_bfloat16* wp = wrow + nb * 8 * stride + kb * 16;
                                mma_bf16(acc[nb], f, ld32(wp), ld32(wp + 8));
                            }
                        }
                    }
                }
#pragma unroll
                for (int nb = 0; nb < 8; ++nb) {
                    if (nb < nbs) {
                        const int col = c * kChunk + nb * 8 + tig * 2;
#pragma unroll
                        for (int e = 0; e < 4; ++e) {
                            const long long r = e < 2 ? r0 : r1;
                            const int cc = col + (e & 1);
                            if (r < n && cc < din) {
                                const float dh = bf16_round(acc[nb][e]);
                                if (i > 0) {
                                    // dz_{i-1} = bf16(dh_i)·act'(z_i), over the act' stored there
                                    dzp[r * din + cc] = dh * dzp[r * din + cc];
                                } else {
                                    dx[r * din + cc] = dh;
                                }
                            }
                        }
                    }
                }
            }
        }
    }
    cp_async_wait_all();
}

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

// the widths d_0 .. d_L, checked; the largest padded width, or 0 if one is out of range
int check_dims(const int* d, int n_layers) {
    int pmax = 0;
    if (n_layers < 1) return 0;
    for (int i = 0; i <= n_layers; ++i) {
        if (d[i] < 1 || d[i] > kMaxWidth) return 0;
        pmax = pad16(d[i]) > pmax ? pad16(d[i]) : pmax;
    }
    return pmax;
}

size_t packed_bytes(const int* d, int n_layers) {
    int rec[kLayerInts];
    layer_record(d, n_layers, n_layers - 1, rec);
    // the last backward layout ends the packed weights
    const size_t values = (size_t)rec[5] + (size_t)rec[2] * (rec[3] + kRowPad);
    return header_bytes(n_layers) + sizeof(__nv_bfloat16) * values;
}

int pack(const void* w, const int* d, int n_layers, unsigned char* scratch, bool bwd, cudaStream_t st) {
    int* header = reinterpret_cast<int*>(scratch);
    __nv_bfloat16* wpk = reinterpret_cast<__nv_bfloat16*>(scratch + header_bytes(n_layers));
    for (int i = 0; i < n_layers; ++i) {
        int rec[kLayerInts];
        layer_record(d, n_layers, i, rec);
        const int values = rec[3] * (rec[2] + kRowPad) + (bwd ? rec[2] * (rec[3] + kRowPad) : 0);
        const int blocks = (values + kThreads - 1) / kThreads < 64 ? (values + kThreads - 1) / kThreads : 64;
        pack_layer<<<blocks, kThreads, 0, st>>>(static_cast<const float* const*>(w)[i], d[i], d[i + 1],
                                                wpk + rec[4], bwd ? wpk + rec[5] : nullptr, header, i,
                                                i == n_layers - 1);
    }
    return (int)cudaGetLastError();
}

template <int kKB, bool kBwd>
int launch(const float* x, const unsigned char* pk, const int* d, int n_layers, int act, int out_act,
           long long n, float* out, const float* g, float* dx, float* hbuf, float* dzbuf, float* zf,
           cudaStream_t st) {
    const size_t smem = smem_bytes<kKB>(n_layers, chunk_count(d, n_layers, kBwd));
    const DeviceInfo& dev = device_info();
    if (smem > (size_t)dev.smem_optin) return (int)cudaErrorInvalidValue;
    // the shared-memory opt-in and the occupancy of the last size, kept
    // across launches (host API calls cost more than a small launch)
    static size_t set_smem = 0, occ_smem = 0;
    static int per_sm = 1;
    if (smem > set_smem) {
        const cudaError_t err = cudaFuncSetAttribute(mlp_wide_kernel<kKB, kBwd>,
                                                     cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        set_smem = smem;
    }
    if (smem != occ_smem) {
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mlp_wide_kernel<kKB, kBwd>, kThreads, smem);
        occ_smem = smem;
    }
    const long long n_tiles = (n + kTileRows - 1) / kTileRows;
    const long long want = (long long)dev.n_sm * (per_sm > 0 ? per_sm : 1);
    const unsigned blocks = (unsigned)(n_tiles < want ? n_tiles : want);
    mlp_wide_kernel<kKB, kBwd><<<blocks, kThreads, smem, st>>>(x, pk, n_layers, act, out_act, n, out, g, dx,
                                                               hbuf, dzbuf, zf);
    return (int)cudaGetLastError();
}

}  // namespace

// bytes of the scratch the wide launchers take for these widths (the packed
// weights and their header), or -1 if a width is out of range
extern "C" long long ngp_fused_mlp_wide_scratch(const void* dims, int n_layers) {
    const int* d = static_cast<const int*>(dims);
    if (check_dims(d, n_layers) == 0) return -1;
    return (long long)packed_bytes(d, n_layers);
}

// x: (n, d_0) f32; w: n_layers host pointers, layer i f32 (d_i, d_{i+1}); dims:
// host int[n_layers + 1]; scratch: ngp_fused_mlp_wide_scratch bytes; out: (n,
// d_L) f32
extern "C" int ngp_fused_mlp_wide(const void* x, const void* w, const void* dims, int n_layers, int act,
                                  int out_act, long long n, void* scratch, void* out, void* stream) {
    const int* d = static_cast<const int*>(dims);
    const int pmax = check_dims(d, n_layers);
    if (pmax == 0) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    unsigned char* pk = static_cast<unsigned char*>(scratch);
    const int err = pack(w, d, n_layers, pk, false, st);
    if (err != 0) return err;
    const float* xp = static_cast<const float*>(x);
    float* op = static_cast<float*>(out);
    if (pmax <= 128)
        return launch<8, false>(xp, pk, d, n_layers, act, out_act, n, op, nullptr, nullptr, nullptr, nullptr,
                                nullptr, st);
    return launch<16, false>(xp, pk, d, n_layers, act, out_act, n, op, nullptr, nullptr, nullptr, nullptr,
                             nullptr, st);
}

// x: (n, d_0) f32; w, dims, scratch: as ngp_fused_mlp_wide; g: (n, d_L) f32;
// dx: (n, d_0) f32; hbuf: (n, d_0 + .. + d_{L-1}) f32, h_i layer by layer, each
// (n, d_i); dzbuf: (n, d_1 + .. + d_L) f32, dz_i layer by layer, each (n,
// d_{i+1}); zf: null, or laid out as dzbuf for the recompute's pre-activations
extern "C" int ngp_fused_mlp_bwd_wide(const void* x, const void* w, const void* g, const void* dims,
                                      int n_layers, int act, int out_act, long long n, void* scratch, void* dx,
                                      void* hbuf, void* dzbuf, void* zf, void* stream) {
    const int* d = static_cast<const int*>(dims);
    const int pmax = check_dims(d, n_layers);
    if (pmax == 0) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    unsigned char* pk = static_cast<unsigned char*>(scratch);
    const int err = pack(w, d, n_layers, pk, true, st);
    if (err != 0) return err;
    const float* xp = static_cast<const float*>(x);
    const float* gp = static_cast<const float*>(g);
    float* dxp = static_cast<float*>(dx);
    float* hp = static_cast<float*>(hbuf);
    float* zp = static_cast<float*>(dzbuf);
    float* zfp = static_cast<float*>(zf);
    if (pmax <= 128)
        return launch<8, true>(xp, pk, d, n_layers, act, out_act, n, nullptr, gp, dxp, hp, zp, zfp, st);
    return launch<16, true>(xp, pk, d, n_layers, act, out_act, n, nullptr, gp, dxp, hp, zp, zfp, st);
}
