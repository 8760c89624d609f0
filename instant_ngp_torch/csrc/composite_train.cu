// Kernel G: training composite + loss + backward, fused.
//
// Replaces instant_ngp_tpu/nerf/task.py::_composite (task.py:683, the
// cumsum compositing at :748-757), the per-ray loss (task.py:937-940), the
// density regularizers (task.py:1004-1020) and JAX's autodiff of all three:
// the reference's compute_loss_kernel_train_nerf (testbed_nerf.cu:852-1180)
// fuses them the same way. Plain version: instant_ngp_torch/nerf/train.py::
// composite_train_plain.
//
// Per ray, over its K samples: rgb and density activations, tau = sigma·dt,
// T_k = exp(−cumsum(tau)_k + tau_k) (the JAX order), w_k = (1 − e^−tau_k)·
// T_k, rgb = Σ w_k c_k plus T_final·bg where T_final >= EPS_T, the loss
// (Huber/5 or L2) averaged over the channels, times pixel_ok. Then the
// gradient of mean(per-ray loss) + Σ stopgrad(coeff)·clip(σ_logit, ±30):
// G = d objective / d rgb, and d tau_k = G·(T_k e^−tau_k c_k − suffix_k)
// with suffix_k = rgb − Σ_{j<=k} w_j c_j, which gives d/d σ_logit through
// the clamped exp (0.5 on the clamp bounds, as JAX differentiates
// jnp.clip) and d/d rgb logits as G·w_k·logistic'. The regularizer adds its
// coefficient where the grid is foggy (mean density, read on the device)
// and σ_logit < 0 (−1e-4), and where the sample is nearer than
// near_distance with σ_logit > −10 (+1e-4), times valid and reg_scale.
//
// What bounds it on an H100: bytes. A sample reads its out row (16 B), ts,
// dts (4 B each) and valid (1 B) and writes its dout row (16 B): 41 B, so
// 5.4 MB at R 4096, K 32, 0.0016 ms at 3.35 TB/s; a few exp a sample. The
// work per ray is a chain (a prefix sum), so what the card reaches is set by
// latency: how many rays are in flight and how long one ray's chain is.
//
// Design: one warp per ray, one lane per sample, the samples in chunks of
// 32 (any K; lanes past K take tau = 0 and w·c = 0 and stay in the
// collectives). A lane loads its out row as one float4 and its ts, dts and
// valid entries, so a warp's out load is 512 contiguous bytes. The forward
// is an inclusive warp scan of tau (5 __shfl_up_sync steps) plus the running
// Σ tau carried from the chunk before, which gives T_k; and inclusive scans
// of w·c per channel plus their carries, which give Σ_{j<=k} w_j c_j for the
// backward and, from the last lane, rgb. Loss and G are computed by every
// lane of the warp alike. The backward needs only each sample's forward
// state and rgb, so nothing is recomputed: the state of the first
// kRegChunks chunks stays in registers (K <= 64), that of later chunks goes
// to a scratch buffer the wrapper allocates at the size
// ngp_composite_train_scratch_floats gives (lane-contiguous, one coalesced
// 128-byte store and load per field). No shared memory, no
// atomics: a ray's result depends on its inputs alone, so the kernel is
// deterministic. The scan adds in another order than a sequential cumsum;
// the error against the plain version stays of the size TOL_COMPOSITE_TRAIN
// allows (chip_smoke.py). expf, and -fmad=false: a*b+c rounds twice, as
// PyTorch's elementwise ops do.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNone = 0, kRelu = 1, kLogistic = 2, kExponential = 3;
constexpr int kL2 = 0, kHuber = 1;
constexpr float kMinOpticalThickness = 0.01f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;      // rays per block
constexpr int kRegChunks = 2;  // chunks of 32 samples whose state stays in registers
constexpr int kStateFields = 15;

__device__ __forceinline__ float clip_grad(float v, float lo, float hi) {
    if (v == lo || v == hi) return 0.5f;
    return (v > lo && v < hi) ? 1.0f : 0.0f;
}

__device__ __forceinline__ float activate(int act, float v, float clamp_at) {
    switch (act) {
        case kRelu: return fmaxf(v, 0.0f);
        case kLogistic: return 1.0f / (1.0f + expf(-v));
        case kExponential: return expf(fminf(fmaxf(v, -clamp_at), clamp_at));
        default: return v;
    }
}

__device__ __forceinline__ float activate_grad(int act, float v, float clamp_at) {
    switch (act) {
        case kRelu: return v > 0.0f ? 1.0f : (v == 0.0f ? 0.5f : 0.0f);
        case kLogistic: {
            const float e = expf(-v);
            const float u = 1.0f + e;
            return e / (u * u);
        }
        case kExponential:
            return expf(fminf(fmaxf(v, -clamp_at), clamp_at)) * clip_grad(v, -clamp_at, clamp_at);
        default: return 1.0f;
    }
}

// inclusive prefix sum over the warp's lanes: lane l gets x_0 + ... + x_l
__device__ __forceinline__ float warp_scan(float x, int lane) {
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const float y = __shfl_up_sync(kFull, x, d);
        if (lane >= d) x = x + y;
    }
    return x;
}

// what the backward needs of one sample, from its forward
struct Sample {
    float col[3], prefix[3], col_grad[3];  // c_k, Σ_{j<=k} w_j c_j, d c_k / d logit
    float w, T_next, dt, density_grad, reg;
    float valid;  // 1 or 0
};

struct Params {
    const float4* out;
    const float* ts;
    const float* dts;
    const unsigned char* valid;
    int K;
    float near_distance, reg_scale;
    int rgb_act, density_act;
};

// the forward of chunk c of the ray at base (= r·K): the sample's state;
// carry_tau and carry_wc hold the sums over the chunks before and are
// advanced past this one
__device__ __forceinline__ Sample forward_chunk(const Params& p, bool foggy, long long base,
                                                int c, int lane, float& carry_tau,
                                                float* carry_wc) {
    const int k = c * 32 + lane;
    const bool in = k < p.K;
    float4 o = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float dt = 0.0f, t = 0.0f;
    bool v = false;
    if (in) {
        o = __ldg(p.out + base + k);
        dt = __ldg(p.dts + base + k);
        t = __ldg(p.ts + base + k);
        v = __ldg(p.valid + base + k) != 0;
    }
    Sample s;
    const float sigma = v ? activate(p.density_act, o.w, 15.0f) : 0.0f;
    const float tau = sigma * dt;
    const float cum = carry_tau + warp_scan(tau, lane);
    const float T = expf(-cum + tau);
    const float e = expf(-tau);
    const float w = (1.0f - e) * T;
    s.w = w;  // 0 past K and where invalid: tau = 0
    s.T_next = T * e;
    const float logits[3] = {o.x, o.y, o.z};
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
        s.col[ch] = activate(p.rgb_act, logits[ch], 10.0f);
        s.col_grad[ch] = activate_grad(p.rgb_act, logits[ch], 10.0f);
        s.prefix[ch] = carry_wc[ch] + warp_scan(s.w * s.col[ch], lane);
        carry_wc[ch] = __shfl_sync(kFull, s.prefix[ch], 31);
    }
    carry_tau = __shfl_sync(kFull, cum, 31);
    s.dt = dt;
    s.density_grad = activate_grad(p.density_act, o.w, 15.0f);
    float coeff = ((foggy && o.w < 0.0f) ? -1e-4f : 0.0f) +
                  ((o.w > -10.0f && t < p.near_distance) ? 1e-4f : 0.0f);
    coeff = coeff * (v ? 1.0f : 0.0f) * p.reg_scale;
    s.reg = coeff * clip_grad(o.w, -30.0f, 30.0f);
    s.valid = v ? 1.0f : 0.0f;
    return s;
}

__device__ __forceinline__ void backward_sample(const Sample& s, const float* rgb, const float* G,
                                                float4* dout, long long base, int k, int K) {
    if (k >= K) return;
    float dtau = 0.0f;
    float go[3];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
        const float suffix = rgb[ch] - s.prefix[ch];
        dtau = dtau + G[ch] * (s.T_next * s.col[ch] - suffix);
        go[ch] = G[ch] * s.w * s.col_grad[ch];
    }
    const float ds = s.valid != 0.0f ? dtau * s.dt * s.density_grad : 0.0f;
    dout[base + k] = make_float4(go[0], go[1], go[2], ds + s.reg);
}

__device__ __forceinline__ void store_state(float* scratch, const Sample& s, int lane) {
    const float* f = reinterpret_cast<const float*>(&s);
#pragma unroll
    for (int i = 0; i < kStateFields; ++i) scratch[i * 32 + lane] = f[i];
}

__device__ __forceinline__ Sample load_state(const float* scratch, int lane) {
    Sample s;
    float* f = reinterpret_cast<float*>(&s);
#pragma unroll
    for (int i = 0; i < kStateFields; ++i) f[i] = scratch[i * 32 + lane];
    return s;
}

static_assert(sizeof(Sample) == kStateFields * sizeof(float), "Sample is kStateFields floats");

// kChunks: the chunks whose state stays in registers (1 where K <= 32)
template <int kChunks>
__global__ void __launch_bounds__(kWarps * 32)
composite_train_kernel(Params p, const float* __restrict__ target, const float* __restrict__ bg,
                       const bool* __restrict__ pixel_ok, const float* __restrict__ mean_density,
                       int R, float inv_n_rays, float eps_t, int loss,
                       float* __restrict__ per_ray, float4* __restrict__ dout,
                       float* __restrict__ scratch) {
    const int lane = threadIdx.x & 31;
    const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
    if (r >= R) return;  // the whole warp: one ray a warp
    const long long base = (long long)r * p.K;
    const int n_chunks = (p.K + 31) / 32;
    // the scratch of this ray: its chunks from kChunks on, kStateFields x 32 each
    float* ray_scratch = scratch + (long long)r * max(n_chunks - kChunks, 0) * kStateFields * 32;
    const bool foggy = mean_density[0] < kMinOpticalThickness;

    // forward
    float carry_tau = 0.0f;
    float carry_wc[3] = {0.0f, 0.0f, 0.0f};
    Sample held[kChunks];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
        if (c < n_chunks) held[c] = forward_chunk(p, foggy, base, c, lane, carry_tau, carry_wc);
    }
    for (int c = kChunks; c < n_chunks; ++c) {
        store_state(ray_scratch + (long long)(c - kChunks) * kStateFields * 32,
                    forward_chunk(p, foggy, base, c, lane, carry_tau, carry_wc), lane);
    }
    const float T_final = expf(-carry_tau);
    const float bg_w = T_final >= eps_t ? T_final : 0.0f;
    const float ok = pixel_ok[r] ? 1.0f : 0.0f;
    float rgb[3], d[3], lsum = 0.0f;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
        rgb[ch] = carry_wc[ch] + bg_w * bg[r * 3 + ch];
        d[ch] = rgb[ch] - target[r * 3 + ch];
        const float ad = fabsf(d[ch]);
        float l;
        if (loss == kHuber) {
            l = (ad > 0.1f ? ad - 0.05f : (5.0f * d[ch]) * d[ch]) / 5.0f;
        } else {
            l = d[ch] * d[ch];
        }
        lsum = lsum + l;
    }
    if (lane == 0) per_ray[r] = lsum / 3.0f * ok;

    // G = d objective / d rgb
    const float ct = inv_n_rays * ok / 3.0f;
    float G[3];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
        if (loss == kHuber) {
            const float cth = ct / 5.0f;
            G[ch] = fabsf(d[ch]) > 0.1f ? (d[ch] > 0.0f ? cth : (d[ch] < 0.0f ? -cth : 0.0f))
                                        : cth * (5.0f * d[ch]) + cth * d[ch] * 5.0f;
        } else {
            G[ch] = ct * d[ch] + ct * d[ch];
        }
    }

    // backward, from the forward's state
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
        if (c < n_chunks) backward_sample(held[c], rgb, G, dout, base, c * 32 + lane, p.K);
    }
    for (int c = kChunks; c < n_chunks; ++c) {
        backward_sample(load_state(ray_scratch + (long long)(c - kChunks) * kStateFields * 32, lane),
                        rgb, G, dout, base, c * 32 + lane, p.K);
    }
}

template <int kChunks>
void launch(const Params& p, const void* target, const void* bg, const void* pixel_ok,
            const void* mean_density, int R, float inv_n_rays, float eps_t, int loss,
            void* per_ray, void* dout, void* scratch, cudaStream_t st) {
    const unsigned blocks = (unsigned)((R + kWarps - 1) / kWarps);
    composite_train_kernel<kChunks><<<blocks, kWarps * 32, 0, st>>>(
        p, static_cast<const float*>(target), static_cast<const float*>(bg),
        static_cast<const bool*>(pixel_ok), static_cast<const float*>(mean_density), R,
        inv_n_rays, eps_t, loss, static_cast<float*>(per_ray), static_cast<float4*>(dout),
        static_cast<float*>(scratch));
}

}  // namespace

// the f32 scratch ngp_composite_train needs for R rays of K samples: the
// forward state of every chunk past the first kRegChunks, kStateFields x 32
// floats a chunk; 0 where K <= 32 * kRegChunks
extern "C" long long ngp_composite_train_scratch_floats(int R, int K) {
    const long long spill = (K + 31) / 32 - kRegChunks;
    return spill > 0 ? (long long)R * spill * kStateFields * 32 : 0;
}

// scratch: ngp_composite_train_scratch_floats(R, K) floats, or null where that is 0
extern "C" int ngp_composite_train(const void* out, const void* ts, const void* dts,
                                   const void* valid, const void* target, const void* bg,
                                   const void* pixel_ok, const void* mean_density, int R, int K,
                                   float near_distance, float reg_scale, float inv_n_rays,
                                   float eps_t, int loss, int rgb_act, int density_act,
                                   void* per_ray, void* dout, void* scratch, void* stream) {
    if (K < 0 || (K > 32 * kRegChunks && scratch == nullptr)) return (int)cudaErrorInvalidValue;
    Params p;
    p.out = static_cast<const float4*>(out);
    p.ts = static_cast<const float*>(ts);
    p.dts = static_cast<const float*>(dts);
    p.valid = static_cast<const unsigned char*>(valid);
    p.K = K;
    p.near_distance = near_distance;
    p.reg_scale = reg_scale;
    p.rgb_act = rgb_act;
    p.density_act = density_act;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (K <= 32) {
        launch<1>(p, target, bg, pixel_ok, mean_density, R, inv_n_rays, eps_t, loss, per_ray,
                  dout, scratch, st);
    } else {
        launch<kRegChunks>(p, target, bg, pixel_ok, mean_density, R, inv_n_rays, eps_t, loss,
                           per_ray, dout, scratch, st);
    }
    return (int)cudaGetLastError();
}
