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
// What bounds it on an H100: per row, the recompute, dh and dW products of
// widths <= 64 (about 37 k multiply-adds for the two NeRF MLPs together),
// on CUDA cores in f32, against 64 + 4·in bytes of row traffic: compute
// bound, far below the tensor cores' rate.
//
// Simple design: persistent blocks of 256 threads, each walking tiles of 32
// rows. The weights (f32 copies of the bf16 values, rows padded by one
// float so that the dh loop's column walk spreads over the banks) and the
// block's dW partial sums live in shared memory, as do the tile's input,
// pre-activations and the cotangent of the layer in flight. Every phase
// maps (row, column) or (in, out) pairs onto the threads; each thread owns
// fixed dW elements, so the partial sums need no shared atomics. At the end
// each block adds its partials to the f32 dW with global atomics. Products
// are explicit fmaf in a fixed order.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxLayers = 8;
constexpr int kMaxWidth = 64;
constexpr int kTile = 32;
constexpr int kThreads = 256;

struct Dims {
    int n_layers;
    int d[kMaxLayers + 1];
    int w_off[kMaxLayers];   // layer offset in the global bf16 weights / f32 dW
    int ws_off[kMaxLayers];  // layer offset in the padded shared weights
    int z_off[kMaxLayers];   // hidden layer offset in the shared pre-activations
    int w_total, ws_total, z_total;
};

__device__ __forceinline__ float bf16_round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float act_fwd(int act, float z) {
    return act == 1 ? fmaxf(z, 0.0f) : z;
}

__device__ __forceinline__ float act_grad(int act, float z) {
    if (act != 1) return 1.0f;
    return z > 0.0f ? 1.0f : (z == 0.0f ? 0.5f : 0.0f);
}

__global__ void __launch_bounds__(kThreads)
mlp_bwd_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
               const float* __restrict__ g, Dims dm, int act, long long n,
               float* __restrict__ dx, float* __restrict__ dw) {
    extern __shared__ float smem[];
    float* ws = smem;                        // padded weights, [k][out + 1]
    float* dws = ws + dm.ws_total;           // dW partials, [k][out]
    float* xs = dws + dm.w_total;            // input tile [kTile][d0]
    float* zs = xs + kTile * dm.d[0];        // hidden pre-activations [kTile][d_{i+1}]
    float* cur = zs + dm.z_total;            // cotangent in flight [kTile][<= 64]
    float* nxt = cur + kTile * kMaxWidth;
    const int tid = threadIdx.x;
    const int L = dm.n_layers;

    for (int i = 0; i < L; ++i) {
        const int in = dm.d[i], out = dm.d[i + 1];
        for (int e = tid; e < in * out; e += kThreads) {
            const int k = e / out, o = e - k * out;
            ws[dm.ws_off[i] + k * (out + 1) + o] = __bfloat162float(w[dm.w_off[i] + e]);
        }
    }
    for (int e = tid; e < dm.w_total; e += kThreads) dws[e] = 0.0f;
    __syncthreads();

    const long long n_tiles = (n + kTile - 1) / kTile;
    const int d0 = dm.d[0], dL = dm.d[L];
    for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const long long r0 = tile * kTile;
        const int nr = (int)min((long long)kTile, n - r0);
        for (int e = tid; e < kTile * d0; e += kThreads) {
            const int r = e / d0;
            xs[e] = r < nr ? __bfloat162float(x[r0 * d0 + e]) : 0.0f;
        }
        __syncthreads();
        // recompute the hidden pre-activations
        for (int i = 0; i < L - 1; ++i) {
            const int in = dm.d[i], out = dm.d[i + 1];
            const float* wl = ws + dm.ws_off[i];
            float* zl = zs + dm.z_off[i];
            const float* zp = i > 0 ? zs + dm.z_off[i - 1] : nullptr;
            for (int e = tid; e < kTile * out; e += kThreads) {
                const int r = e / out, o = e - r * out;
                float acc = 0.0f;
                for (int k = 0; k < in; ++k) {
                    const float h = i == 0 ? xs[r * in + k] : bf16_round(act_fwd(act, zp[r * in + k]));
                    acc = fmaf(h, wl[k * (out + 1) + o], acc);
                }
                zl[e] = acc;
            }
            __syncthreads();
        }
        // the output cotangent (output activation none); rows past n are 0
        for (int e = tid; e < kTile * dL; e += kThreads) {
            const int r = e / dL;
            cur[e] = r < nr ? g[r0 * dL + e] : 0.0f;
        }
        __syncthreads();
        for (int i = L - 1; i >= 0; --i) {
            const int in = dm.d[i], out = dm.d[i + 1];
            const float* wl = ws + dm.ws_off[i];
            const float* zp = i > 0 ? zs + dm.z_off[i - 1] : nullptr;
            // dW_i += h_i^T · dz_i
            for (int e = tid; e < in * out; e += kThreads) {
                const int k = e / out, o = e - k * out;
                float acc = 0.0f;
                for (int r = 0; r < kTile; ++r) {
                    const float h = i == 0 ? xs[r * in + k] : bf16_round(act_fwd(act, zp[r * in + k]));
                    acc = fmaf(h, cur[r * out + o], acc);
                }
                dws[dm.w_off[i] + e] += acc;
            }
            // dh_i = bf16(dz_i · W_i^T); dz_{i-1} = dh_i · act'(z_{i-1}); dX = dh_0
            for (int e = tid; e < kTile * in; e += kThreads) {
                const int r = e / in, k = e - r * in;
                float acc = 0.0f;
                for (int o = 0; o < out; ++o) acc = fmaf(cur[r * out + o], wl[k * (out + 1) + o], acc);
                const float dh = bf16_round(acc);
                if (i > 0) {
                    nxt[e] = dh * act_grad(act, zp[e]);
                } else if (r < nr) {
                    dx[r0 * in + e] = dh;
                }
            }
            __syncthreads();
            float* tmp = cur;
            cur = nxt;
            nxt = tmp;
        }
    }
    for (int e = tid; e < dm.w_total; e += kThreads) atomicAdd(dw + e, dws[e]);
}

}  // namespace

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
    }
    dm.w_total = dm.ws_total = dm.z_total = 0;
    for (int i = 0; i < n_layers; ++i) {
        dm.w_off[i] = dm.w_total;
        dm.ws_off[i] = dm.ws_total;
        dm.z_off[i] = dm.z_total;
        dm.w_total += d[i] * d[i + 1];
        dm.ws_total += d[i] * (d[i + 1] + 1);
        if (i < n_layers - 1) dm.z_total += kTile * d[i + 1];
    }
    const size_t smem = sizeof(float) * ((size_t)dm.ws_total + dm.w_total + kTile * d[0] +
                                         dm.z_total + 2 * kTile * kMaxWidth);
    cudaError_t err = cudaFuncSetAttribute(mlp_bwd_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    int device = 0, n_sm = 132, per_sm = 1;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mlp_bwd_kernel, kThreads, smem);
    const long long n_tiles = (n + kTile - 1) / kTile;
    const long long want = (long long)n_sm * (per_sm > 0 ? per_sm : 1);
    const unsigned blocks = (unsigned)(n_tiles < want ? n_tiles : want);
    mlp_bwd_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        static_cast<const float*>(g), dm, act, n, static_cast<float*>(dx),
        static_cast<float*>(dw));
    return (int)cudaGetLastError();
}
