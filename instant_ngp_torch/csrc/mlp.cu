// Kernel B: fused bias-free MLP, forward.
//
// Replaces the Pallas kernel instant_ngp_tpu/ops/pallas/mlp_kernel.py::
// _fused_mlp_fwd_impl (public fused_mlp), which computes what MLP.__call__
// computes: bf16 input and weights, f32 accumulation, each hidden
// activation rounded back to bf16, an f32 output.
// Plain version: instant_ngp_torch/ops/mlp_kernel.py::fused_mlp_plain.
//
// What bounds it on an H100: the NeRF MLPs are tiny (32->64->16 and
// 32->64->64->3, 3,072 and 6,336 multiply-adds a row) and their weights
// (12.7 KB for the larger) fit shared memory many times over. On tensor
// cores the products are nearly free; what is left is reading the 64-byte
// input row, writing the output row, and feeding the tensor cores from
// shared memory.
//
// Simple design: the block copies all layers' weights into shared memory
// as bf16 once, each layer stored transposed (out, in) with rows padded by
// 8 values so that the fragment loads of a warp hit 32 distinct banks.
// Each warp then walks 16-row tiles with a grid-stride loop. A tile runs
// through all layers with warp-level mma.sync m16n8k16 (bf16 in, f32
// accumulate): the f32 accumulator fragment of one layer, after the
// activation and __float2bfloat16_rn (round to nearest even, like XLA's
// convert), is exactly the A fragment of the next layer, so activations
// never leave registers. Widths are padded to multiples of 16 with zeros
// (at most 64). Any row count works: the ragged last tile is masked; the
// TPU kernel's N % 512 restriction does not carry over. wgmma and TMA are
// for a later kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWidth = 64;
constexpr int kMaxLayers = 8;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowPad = 8;  // bf16 values of padding per transposed weight row
constexpr int kRelu = 1;

struct MlpDims {
    int d[kMaxLayers + 1];  // padded widths, multiples of 16
};

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float activate(float v, int act) { return act == kRelu ? fmaxf(v, 0.0f) : v; }

// two activations rounded to bf16, packed low = first (smaller column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads)
fused_mlp_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                 MlpDims dims, int n_layers, int w_total, int out_real, int act, int out_act,
                 long long n, float* __restrict__ out) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem_raw);
    for (int i = threadIdx.x; i < w_total / 8; i += blockDim.x) {
        reinterpret_cast<uint4*>(ws)[i] = reinterpret_cast<const uint4*>(w)[i];
    }
    __syncthreads();

    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;   // fragment row group
    const int tig = lane & 3;  // thread in group
    const long long n_tiles = (n + 15) / 16;
    const int k0 = dims.d[0];

    for (long long tile = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5); tile < n_tiles;
         tile += (long long)gridDim.x * kWarps) {
        const long long r0 = tile * 16 + g, r1 = r0 + 8;
        // A fragments of the input tile, straight from device memory
        uint32_t a[kMaxWidth / 16][4];
#pragma unroll
        for (int kb = 0; kb < kMaxWidth / 16; ++kb) {
            if (kb * 16 < k0) {
                const int c = kb * 16 + tig * 2;
                a[kb][0] = r0 < n ? ld32(x + r0 * k0 + c) : 0u;
                a[kb][1] = r1 < n ? ld32(x + r1 * k0 + c) : 0u;
                a[kb][2] = r0 < n ? ld32(x + r0 * k0 + c + 8) : 0u;
                a[kb][3] = r1 < n ? ld32(x + r1 * k0 + c + 8) : 0u;
            }
        }
        int off = 0;
        for (int layer = 0; layer < n_layers; ++layer) {
            const int kin = dims.d[layer], kout = dims.d[layer + 1];
            const int stride = kin + kRowPad;
            float acc[kMaxWidth / 8][4];
#pragma unroll
            for (int nb = 0; nb < kMaxWidth / 8; ++nb) {
                acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.0f;
                if (nb * 8 < kout) {
                    const __nv_bfloat16* wrow = ws + off + (nb * 8 + g) * stride + tig * 2;
#pragma unroll
                    for (int kb = 0; kb < kMaxWidth / 16; ++kb) {
                        if (kb * 16 < kin) {
                            mma_bf16(acc[nb], a[kb], ld32(wrow + kb * 16), ld32(wrow + kb * 16 + 8));
                        }
                    }
                }
            }
            off += kout * stride;
            if (layer < n_layers - 1) {
                // accumulator fragments (n-blocks 2kb, 2kb+1) -> A fragment kb
#pragma unroll
                for (int kb = 0; kb < kMaxWidth / 16; ++kb) {
                    if (kb * 16 < kout) {
                        const float* lo = acc[2 * kb];
                        const float* hi = acc[2 * kb + 1];
                        a[kb][0] = pack_bf16(activate(lo[0], act), activate(lo[1], act));
                        a[kb][1] = pack_bf16(activate(lo[2], act), activate(lo[3], act));
                        a[kb][2] = pack_bf16(activate(hi[0], act), activate(hi[1], act));
                        a[kb][3] = pack_bf16(activate(hi[2], act), activate(hi[3], act));
                    }
                }
            } else {
#pragma unroll
                for (int nb = 0; nb < kMaxWidth / 8; ++nb) {
                    const int c = nb * 8 + tig * 2;
                    if (nb * 8 < kout) {
                        if (r0 < n && c < out_real) out[r0 * out_real + c] = activate(acc[nb][0], out_act);
                        if (r0 < n && c + 1 < out_real) out[r0 * out_real + c + 1] = activate(acc[nb][1], out_act);
                        if (r1 < n && c < out_real) out[r1 * out_real + c] = activate(acc[nb][2], out_act);
                        if (r1 < n && c + 1 < out_real) out[r1 * out_real + c + 1] = activate(acc[nb][3], out_act);
                    }
                }
            }
        }
    }
}

}  // namespace

extern "C" int ngp_fused_mlp(const void* x, const void* w, const void* dims, int n_layers,
                             int out_real, int act, int out_act, long long n, void* out,
                             void* stream) {
    if (n_layers < 1 || n_layers > kMaxLayers) return (int)cudaErrorInvalidValue;
    MlpDims md;
    int w_total = 0;
    for (int l = 0; l <= n_layers; ++l) {
        md.d[l] = static_cast<const int*>(dims)[l];
        if (md.d[l] % 16 != 0 || md.d[l] < 16 || md.d[l] > kMaxWidth) return (int)cudaErrorInvalidValue;
        if (l > 0) w_total += md.d[l] * (md.d[l - 1] + kRowPad);
    }
    const size_t smem = (size_t)w_total * sizeof(__nv_bfloat16);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            fused_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const long long tiles = (n + 15) / 16;
    long long blocks = (tiles + kWarps - 1) / kWarps;
    if (blocks > 132 * 8) blocks = 132 * 8;  // grid-stride: weights load once per block
    fused_mlp_kernel<<<(unsigned)blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w), md, n_layers,
        w_total, out_real, act, out_act, n, static_cast<float*>(out));
    return (int)cudaGetLastError();
}
