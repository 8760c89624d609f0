// Kernel B: fused bias-free MLP, forward.
//
// Replaces the Pallas kernel instant_ngp_tpu/ops/pallas/mlp_kernel.py::
// _fused_mlp_fwd_impl (public fused_mlp), which computes what MLP.__call__
// computes: bf16 input and weights, f32 accumulation, each hidden
// activation rounded back to bf16, an f32 output.
// Plain version: instant_ngp_torch/ops/mlp_kernel.py::fused_mlp_plain.
//
// Limits: this is kernel B's narrow route, for every width <= 64, at most 8
// matrices and relu or none as both activations (the NeRF, SDF and image
// base configs). The wrapper (ops/mlp_kernel.py::fused_mlp) sends the rest of
// the Pallas kernel's contract, widths up to 256, any depth, sigmoid and
// exponential, to csrc/mlp_wide.cu, whose weights stream through shared
// memory a chunk at a time instead of sitting there whole; the A fragments of
// both routes are kept in registers and sized by the widest layer, which is
// what caps this one at 64.
//
// What bounds it on an H100: the NeRF MLPs are tiny (32->64->16 and
// 32->64->64->3, 3,072 and 6,336 multiply-adds a row) and their weights
// (25 KB of f32 for the larger) fit shared memory many times over. On
// tensor cores the products are nearly free (~0.01 ms for both fox MLPs at
// 2^19 rows); the bound is the bytes: the 128-byte f32 input row and the
// output row. What the kernel spends beyond that is latency (the fragment
// loads from shared memory and the mma chains of each tile) and a fixed
// start per call (every block lays the weights out); what a small call
// spends beyond that is host work, so the wrapper does one launch on the
// tensors as they are.
//
// Design: persistent blocks of 8 warps, two per SM, each walking row tiles
// of 256 rows (32 a warp) with a stride of the grid.
// - Each block lays all layers' weights out in shared memory once: each
//   layer transposed, (out, in + 8) bf16, rounded from the f32 (in, out)
//   values with __float2bfloat16_rn, zero-padded to multiples of 16 (kernel
//   F's layout and rounding); the 8 extra values a row spread a warp's
//   fragment loads over 32 banks. The f32 weights are read in order, eight
//   16-byte loads in flight a thread. The per-layer constants go to shared
//   memory too: indexed at run time in the parameter structs, they were
//   copied to every thread's local memory.
// - The f32 input tiles come into two shared-memory stages by cp.async
//   (16-byte pieces where the rows allow it), the next tile's loads in
//   flight while this tile's products run; rows past n are zero-filled.
//   (Three stages, one block fewer per SM, were slower at 2^19 rows.)
// - A warp's A fragments are read from the staged f32 tile with 64-bit
//   loads (row stride = width + 8 floats, so a half-warp hits 32 banks) and
//   rounded to bf16 in registers with __floats2bfloat162_rn (round to
//   nearest even, like XLA's convert). ldmatrix reads b16 data only, so it
//   would need a second, converted copy of the tile.
// - Each layer is warp-level mma.sync m16n8k16 (bf16 in, f32 accumulate)
//   over two m16 row blocks, so each B fragment read from shared memory
//   feeds two products; k blocks outer, n blocks inner, so consecutive
//   mma's write different accumulators, and each accumulator takes its k
//   blocks in ascending order from zero, exactly as kernel F's recompute,
//   so F differentiates the network B ran. The accumulator fragment of one
//   layer, after the activation and the bf16 rounding, is the A fragment of
//   the next, so activations never leave registers.
// - The output tile is staged in shared memory and written with coalesced
//   16-byte stores: a tile's rows are contiguous in the (n, out) output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWidth = 64;
constexpr int kMaxLayers = 8;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowBlocks = 2;  // m16 row blocks a warp: each B fragment feeds kRowBlocks mma's
constexpr int kTileRows = 16 * kRowBlocks * kWarps;
constexpr int kBlocksPerSm = 2;  // the occupancy __launch_bounds__ leaves registers for
constexpr int kRowPad = 8;  // bf16 values of padding per transposed weight row
constexpr int kRelu = 1;

struct Dims {
    int n_layers;
    int d[kMaxLayers + 1];   // real widths
    int p[kMaxLayers + 1];   // widths padded to multiples of 16
    int wt_off[kMaxLayers];  // bf16 offset of W_i^T, (p_out, p_in + kRowPad)
    int d_out;               // d[n_layers]
    int w_total;             // bf16 values of the shared weights
    int xs;                  // f32 row stride of a stage: max(p[0], d_out rounded to 8) + 8
};

// each layer's f32 weights, (d_in, d_out)
struct Weights {
    const float* p[kMaxLayers];
};

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float activate(float v, int act) { return act == kRelu ? fmaxf(v, 0.0f) : v; }

// two values rounded to bf16, packed low = first (smaller column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(float2 v) { return pack_bf16(v.x, v.y); }

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// n bytes (4 or 16) from src to shared dst, or zeros where !ok
template <int kBytes>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool ok) {
    const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
    if constexpr (kBytes == 16) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                     "r"(ok ? 16 : 0));
    } else {
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
                     "r"(ok ? 4 : 0));
    }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// rows [tile·kTileRows, +kTileRows) of x, (n, d0) f32, into a stage
// (kTileRows, xs); 16-byte pieces when vec (d0 % 4 == 0, x 16-byte aligned)
__device__ __forceinline__ void load_tile(float* stage, const float* __restrict__ x, long long tile,
                                          long long n, int d0, int xs, bool vec) {
    const long long r0 = tile * kTileRows;
    if (vec) {
        const int per_row = d0 >> 2;
        for (int i = threadIdx.x; i < kTileRows * per_row; i += kThreads) {
            const int r = i / per_row, c = (i - r * per_row) * 4;
            const bool ok = r0 + r < n;
            cp_async<16>(stage + r * xs + c, ok ? x + (r0 + r) * d0 + c : x, ok);
        }
    } else {
        for (int i = threadIdx.x; i < kTileRows * d0; i += kThreads) {
            const int r = i / d0, c = i - r * d0;
            const bool ok = r0 + r < n;
            cp_async<4>(stage + r * xs + c, ok ? x + (r0 + r) * d0 + c : x, ok);
        }
    }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
fused_mlp_kernel(const float* __restrict__ x, Weights w, Dims dm, int act, int out_act, int vec,
                 long long n, float* __restrict__ out) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem_raw);
    float* xs = reinterpret_cast<float*>(ws + dm.w_total);  // 2 stages of (kTileRows, dm.xs)
    const int stage_size = kTileRows * dm.xs;
    const int L = dm.n_layers, d0 = dm.d[0], p0 = dm.p[0], dL = dm.d_out;
    const long long n_tiles = (n + kTileRows - 1) / kTileRows;

    // the block's first tile in flight while the weights are laid out
    if (blockIdx.x < n_tiles) load_tile(xs, x, blockIdx.x, n, d0, dm.xs, vec);
    cp_async_commit();
    // the per-layer constants in shared memory: a runtime index into the
    // parameter structs would make the compiler copy them to local memory,
    // which every thread then reads in the layer loop
    __shared__ int s_d[kMaxLayers + 1], s_p[kMaxLayers + 1], s_off[kMaxLayers];
    __shared__ const float* s_w[kMaxLayers];
    if (threadIdx.x == 0) {
#pragma unroll
        for (int i = 0; i <= kMaxLayers; ++i) {
            s_d[i] = dm.d[i];
            s_p[i] = dm.p[i];
        }
#pragma unroll
        for (int i = 0; i < kMaxLayers; ++i) {
            s_off[i] = dm.wt_off[i];
            s_w[i] = w.p[i];
        }
    }
    // the weights: a zeroed area (its padding stays zero), then each layer
    // read in order, kBatch loads in flight a thread, and stored transposed
    for (int i = threadIdx.x; i < dm.w_total / 8; i += kThreads)
        reinterpret_cast<uint4*>(ws)[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
    for (int i = 0; i < L; ++i) {
        const int dout = s_d[i + 1], stride = s_p[i] + kRowPad, count = s_d[i] * dout;
        const float* __restrict__ wl = s_w[i];
        __nv_bfloat16* wt = ws + s_off[i];
        constexpr int kBatch = 8;
        if ((count & 3) == 0 && (reinterpret_cast<uintptr_t>(wl) & 15) == 0) {  // 16-byte loads
            const int n4 = count >> 2;
            for (int q0 = threadIdx.x; q0 < n4; q0 += kBatch * kThreads) {
                float4 v[kBatch];
#pragma unroll
                for (int u = 0; u < kBatch; ++u) {
                    const int q = q0 + u * kThreads;
                    v[u] = q < n4 ? __ldg(reinterpret_cast<const float4*>(wl) + q)
                                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
                }
#pragma unroll
                for (int u = 0; u < kBatch; ++u) {
                    const int q = q0 + u * kThreads;
                    const float vq[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        const int e = 4 * q + j, k = e / dout;
                        if (q < n4) wt[(e - k * dout) * stride + k] = __float2bfloat16_rn(vq[j]);
                    }
                }
            }
            continue;
        }
        for (int e0 = threadIdx.x; e0 < count; e0 += kBatch * kThreads) {
            float v[kBatch];
#pragma unroll
            for (int u = 0; u < kBatch; ++u) {
                const int e = e0 + u * kThreads;
                v[u] = e < count ? __ldg(wl + e) : 0.0f;
            }
#pragma unroll
            for (int u = 0; u < kBatch; ++u) {
                const int e = e0 + u * kThreads, k = e / dout;
                if (e < count) wt[(e - k * dout) * stride + k] = __float2bfloat16_rn(v[u]);
            }
        }
    }
    // columns d0 .. p0 of both stages are zero: cp.async writes columns < d0
    // only (an output wider than d0 is cleared from them after its copy-out)
    if (p0 > d0) {
        const int pad = p0 - d0;
        for (int i = threadIdx.x; i < 2 * kTileRows * pad; i += kThreads) {
            const int r = i / pad;
            xs[r * dm.xs + d0 + (i - r * pad)] = 0.0f;
        }
    }

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2;   // fragment row group
    const int tig = lane & 3;  // thread in group
    const int wr = warp * 16 * kRowBlocks + g;  // this lane's first row in the tile
    int stage = 0;
    for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        // this tile's loads have landed, and every thread is past the
        // previous tile's output: the next tile goes into the other stage
        cp_async_wait<0>();
        __syncthreads();
        const long long next = tile + gridDim.x;
        if (next < n_tiles)
            load_tile(xs + (stage ^ 1) * stage_size, x, next, n, d0, dm.xs, vec);
        cp_async_commit();

        // A fragments of this warp's rows (row block r: rows wr + 16r and +8),
        // rounded to bf16; the warp then writes its output into the same rows
        float* xt = xs + stage * stage_size;
        uint32_t a[kRowBlocks][kMaxWidth / 16][4];
#pragma unroll
        for (int r = 0; r < kRowBlocks; ++r) {
            const float* x0 = xt + (wr + 16 * r) * dm.xs;
            const float* x1 = x0 + 8 * dm.xs;
#pragma unroll
            for (int kb = 0; kb < kMaxWidth / 16; ++kb) {
                if (kb * 16 < p0) {
                    const int c = kb * 16 + tig * 2;
                    a[r][kb][0] = pack_bf16(*reinterpret_cast<const float2*>(x0 + c));
                    a[r][kb][1] = pack_bf16(*reinterpret_cast<const float2*>(x1 + c));
                    a[r][kb][2] = pack_bf16(*reinterpret_cast<const float2*>(x0 + c + 8));
                    a[r][kb][3] = pack_bf16(*reinterpret_cast<const float2*>(x1 + c + 8));
                }
            }
        }
        for (int layer = 0; layer < L; ++layer) {
            const int kin = s_p[layer], kout = s_p[layer + 1];
            const int stride = kin + kRowPad;
            const __nv_bfloat16* wt = ws + s_off[layer];
            // k blocks outer, n blocks inner: consecutive mma's write different
            // accumulators (no stall between them), and each accumulator still
            // takes its k blocks in ascending order, as kernel F's recompute
            float acc[kRowBlocks][kMaxWidth / 8][4];
#pragma unroll
            for (int r = 0; r < kRowBlocks; ++r) {
#pragma unroll
                for (int nb = 0; nb < kMaxWidth / 8; ++nb)
                    acc[r][nb][0] = acc[r][nb][1] = acc[r][nb][2] = acc[r][nb][3] = 0.0f;
            }
            const __nv_bfloat16* wrow = wt + g * stride + tig * 2;
#pragma unroll
            for (int kb = 0; kb < kMaxWidth / 16; ++kb) {
                if (kb * 16 < kin) {
#pragma unroll
                    for (int nb = 0; nb < kMaxWidth / 8; ++nb) {
                        if (nb * 8 < kout) {
                            const __nv_bfloat16* wp = wrow + nb * 8 * stride + kb * 16;
                            const uint32_t b0 = ld32(wp), b1 = ld32(wp + 8);
#pragma unroll
                            for (int r = 0; r < kRowBlocks; ++r) mma_bf16(acc[r][nb], a[r][kb], b0, b1);
                        }
                    }
                }
            }
#pragma unroll
            for (int r = 0; r < kRowBlocks; ++r) {
                if (layer < L - 1) {
                    // accumulator fragments (n-blocks 2kb, 2kb+1) -> A fragment kb
#pragma unroll
                    for (int kb = 0; kb < kMaxWidth / 16; ++kb) {
                        if (kb * 16 < kout) {
                            const float* lo = acc[r][2 * kb];
                            const float* hi = acc[r][2 * kb + 1];
                            a[r][kb][0] = pack_bf16(activate(lo[0], act), activate(lo[1], act));
                            a[r][kb][1] = pack_bf16(activate(lo[2], act), activate(lo[3], act));
                            a[r][kb][2] = pack_bf16(activate(hi[0], act), activate(hi[1], act));
                            a[r][kb][3] = pack_bf16(activate(hi[2], act), activate(hi[3], act));
                        }
                    }
                } else {
                    float* o0 = xt + (wr + 16 * r) * dm.xs;
                    float* o1 = o0 + 8 * dm.xs;
#pragma unroll
                    for (int nb = 0; nb < kMaxWidth / 8; ++nb) {
                        const int c = nb * 8 + tig * 2;
                        if (nb * 8 < kout) {
                            if (c < dL) {
                                o0[c] = activate(acc[r][nb][0], out_act);
                                o1[c] = activate(acc[r][nb][2], out_act);
                            }
                            if (c + 1 < dL) {
                                o0[c + 1] = activate(acc[r][nb][1], out_act);
                                o1[c + 1] = activate(acc[r][nb][3], out_act);
                            }
                        }
                    }
                }
            }
        }
        __syncthreads();

        // the tile's output rows are contiguous: write them in order
        const long long r0 = tile * kTileRows;
        const int total = (int)((n - r0 < kTileRows ? n - r0 : kTileRows) * dL);
        float* o = out + r0 * dL;
        for (int e = threadIdx.x * 4; e < total; e += kThreads * 4) {
            float v[4];
            if ((dL & 3) == 0) {  // the four values lie in one row
                const int r = e / dL;
                const float4 q = *reinterpret_cast<const float4*>(xt + r * dm.xs + (e - r * dL));
                v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
            } else {
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    const int r = (e + k) / dL;
                    v[k] = e + k < total ? xt[r * dm.xs + (e + k - r * dL)] : 0.0f;
                }
            }
            if (e + 3 < total) {
                *reinterpret_cast<float4*>(o + e) = make_float4(v[0], v[1], v[2], v[3]);
            } else {
#pragma unroll
                for (int k = 0; k < 3; ++k) {
                    if (e + k < total) o[e + k] = v[k];
                }
            }
        }
        if (dL > d0 && p0 > d0) {  // the output covered input padding: zero it again
            const int pad = (dL < p0 ? dL : p0) - d0;
            for (int i = threadIdx.x; i < kTileRows * pad; i += kThreads) {
                const int r = i / pad;
                xt[r * dm.xs + d0 + (i - r * pad)] = 0.0f;
            }
        }
        stage ^= 1;
    }
    cp_async_wait<0>();
}

// The device's SM count and shared-memory limit, read once: the package
// runs on one card.
struct DeviceInfo {
    int n_sm = 0, smem_optin = 0, smem_sm = 0;
};

const DeviceInfo& device_info() {
    static DeviceInfo info;
    if (info.n_sm == 0) {
        int device = 0;
        cudaGetDevice(&device);
        cudaDeviceGetAttribute(&info.n_sm, cudaDevAttrMultiProcessorCount, device);
        cudaDeviceGetAttribute(&info.smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
        cudaDeviceGetAttribute(&info.smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
    }
    return info;
}

}  // namespace

// x: (n, d_0) f32, rounded to bf16 here; w: n_layers pointers, layer i f32
// (d_i, d_{i+1}), rounded to bf16 here; dims: the widths d_0 .. d_L;
// out: (n, d_L) f32.
extern "C" int ngp_fused_mlp(const void* x, const void* w, const void* dims, int n_layers, int act,
                             int out_act, long long n, void* out, void* stream) {
    if (n_layers < 1 || n_layers > kMaxLayers) return (int)cudaErrorInvalidValue;
    Dims dm;
    dm.n_layers = n_layers;
    const int* d = static_cast<const int*>(dims);
    int wt = 0;
    for (int i = 0; i <= n_layers; ++i) {
        if (d[i] < 1 || d[i] > kMaxWidth) return (int)cudaErrorInvalidValue;
        dm.d[i] = d[i];
        dm.p[i] = (d[i] + 15) / 16 * 16;
    }
    for (int i = 0; i < n_layers; ++i) {
        dm.wt_off[i] = wt;
        wt += dm.p[i + 1] * (dm.p[i] + kRowPad);
    }
    dm.w_total = wt;
    dm.d_out = d[n_layers];
    const int d_out8 = (d[n_layers] + 7) / 8 * 8;
    dm.xs = (dm.p[0] > d_out8 ? dm.p[0] : d_out8) + 8;
    Weights wp;
    for (int i = 0; i < n_layers; ++i) wp.p[i] = static_cast<const float* const*>(w)[i];
    const size_t smem = sizeof(__nv_bfloat16) * (size_t)wt + sizeof(float) * 2 * kTileRows * dm.xs;
    const DeviceInfo& dev = device_info();
    if (smem > (size_t)dev.smem_optin) return (int)cudaErrorInvalidValue;
    // the shared-memory opt-in of the largest size so far, kept across
    // launches (host API calls cost more than a small launch)
    static size_t set_smem = 48 * 1024;
    if (smem > set_smem) {
        const cudaError_t err = cudaFuncSetAttribute(
            fused_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        set_smem = smem;
    }
    // blocks an SM holds: kBlocksPerSm, where each block's smem plus the
    // 1 KB the runtime reserves fits
    const long long fit = (long long)(dev.smem_sm / (smem + 1024));
    const long long per_sm = fit < 1 ? 1 : fit < kBlocksPerSm ? fit : kBlocksPerSm;
    const long long n_tiles = (n + kTileRows - 1) / kTileRows;
    const long long want = (long long)dev.n_sm * per_sm;
    const unsigned blocks = (unsigned)(n_tiles < want ? n_tiles : want);
    const float* xp = static_cast<const float*>(x);
    const int vec = d[0] % 4 == 0 && reinterpret_cast<uintptr_t>(xp) % 16 == 0;
    fused_mlp_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        xp, wp, dm, act, out_act, vec, n, static_cast<float*>(out));
    return (int)cudaGetLastError();
}
