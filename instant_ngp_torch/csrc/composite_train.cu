// Kernel G: training composite + loss + backward, fused.
//
// Replaces instant_ngp_tpu/nerf/task.py::_composite (task.py:743-761), the
// per-ray loss (task.py:937-940), the density regularizers (task.py:
// 1004-1020) and JAX's autodiff of all three: the reference's
// compute_loss_kernel_train_nerf (testbed_nerf.cu:852-1180) fuses them the
// same way. Plain version: instant_ngp_torch/nerf/train.py::
// composite_train_plain.
//
// Per ray, over its K samples: rgb and density activations, tau = sigma·dt,
// T_k = exp(−cumsum(tau)_k + tau_k) (the JAX order), w_k = (1 − e^−tau_k)·
// T_k, rgb = Σ w_k c_k plus T_final·bg where T_final >= EPS_T, the loss
// (Huber/5 or L2) averaged over the channels, times pixel_ok. Then the
// gradient of mean(per-ray loss) + Σ stopgrad(coeff)·clip(σ_logit, ±30):
// G = d objective / d rgb, and in a second pass over the samples
// d tau_k = G·(T_k e^−tau_k c_k − suffix_k) with suffix_k = rgb − Σ_{j<=k}
// w_j c_j, which gives d/d σ_logit through the clamped exp (0.5 on the
// clamp bounds, as JAX differentiates jnp.clip) and d/d rgb logits as
// G·w_k·logistic'. The regularizer adds its coefficient where the grid is
// foggy (mean density, read on the device) and σ_logit < 0 (−1e-4), and
// where the sample is nearer than near_distance with σ_logit > −10 (+1e-4),
// times valid and reg_scale.
//
// What bounds it on an H100: it reads 24 bytes and writes 16 per sample,
// about 5 MB at R 4096, K 32, with a few exp per sample: memory and launch
// bound; the card takes tens of microseconds.
//
// Simple design: one thread per ray, two passes over its samples (the
// second recomputes the forward instead of storing it).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNone = 0, kRelu = 1, kLogistic = 2, kExponential = 3;
constexpr int kL2 = 0, kHuber = 1;
constexpr float kMinOpticalThickness = 0.01f;

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

__global__ void composite_train_kernel(const float* __restrict__ out, const float* __restrict__ ts,
                                       const float* __restrict__ dts, const bool* __restrict__ valid,
                                       const float* __restrict__ target, const float* __restrict__ bg,
                                       const bool* __restrict__ pixel_ok,
                                       const float* __restrict__ mean_density, int R, int K,
                                       float near_distance, float reg_scale, float inv_n_rays,
                                       float eps_t, int loss, int rgb_act, int density_act,
                                       float* __restrict__ per_ray, float* __restrict__ dout) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= R) return;
    const long long base = (long long)r * K;

    // forward
    float rgb[3] = {0.0f, 0.0f, 0.0f};
    float cum = 0.0f;
    for (int k = 0; k < K; ++k) {
        const float* o = out + (base + k) * 4;
        const bool v = valid[base + k];
        const float sigma = v ? activate(density_act, o[3], 15.0f) : 0.0f;
        const float tau = sigma * dts[base + k];
        cum = cum + tau;
        const float T = expf(-cum + tau);
        const float w = (1.0f - expf(-tau)) * T;
        for (int c = 0; c < 3; ++c) rgb[c] = rgb[c] + w * activate(rgb_act, o[c], 10.0f);
    }
    const float T_final = expf(-cum);
    const float bg_w = T_final >= eps_t ? T_final : 0.0f;
    const float ok = pixel_ok[r] ? 1.0f : 0.0f;
    float d[3], lsum = 0.0f;
    for (int c = 0; c < 3; ++c) {
        rgb[c] = rgb[c] + bg_w * bg[r * 3 + c];
        d[c] = rgb[c] - target[r * 3 + c];
        const float ad = fabsf(d[c]);
        float l;
        if (loss == kHuber) {
            l = (ad > 0.1f ? ad - 0.05f : (5.0f * d[c]) * d[c]) / 5.0f;
        } else {
            l = d[c] * d[c];
        }
        lsum = lsum + l;
    }
    per_ray[r] = lsum / 3.0f * ok;

    // G = d objective / d rgb
    float ct = inv_n_rays * ok / 3.0f;
    float G[3];
    for (int c = 0; c < 3; ++c) {
        if (loss == kHuber) {
            const float cth = ct / 5.0f;
            G[c] = fabsf(d[c]) > 0.1f ? (d[c] > 0.0f ? cth : (d[c] < 0.0f ? -cth : 0.0f))
                                      : cth * (5.0f * d[c]) + cth * d[c] * 5.0f;
        } else {
            G[c] = ct * d[c] + ct * d[c];
        }
    }
    const bool foggy = mean_density[0] < kMinOpticalThickness;

    // backward, recomputing the forward
    float prefix[3] = {0.0f, 0.0f, 0.0f};
    cum = 0.0f;
    for (int k = 0; k < K; ++k) {
        const float* o = out + (base + k) * 4;
        float* go = dout + (base + k) * 4;
        const bool v = valid[base + k];
        const float s = o[3];
        const float dt = dts[base + k];
        const float sigma = v ? activate(density_act, s, 15.0f) : 0.0f;
        const float tau = sigma * dt;
        cum = cum + tau;
        const float T = expf(-cum + tau);
        const float e = expf(-tau);
        const float w = (1.0f - e) * T;
        const float T_next = T * e;
        float dtau = 0.0f;
        for (int c = 0; c < 3; ++c) {
            const float col = activate(rgb_act, o[c], 10.0f);
            prefix[c] = prefix[c] + w * col;
            const float suffix = rgb[c] - prefix[c];
            dtau = dtau + G[c] * (T_next * col - suffix);
            go[c] = G[c] * w * activate_grad(rgb_act, o[c], 10.0f);
        }
        float ds = v ? dtau * dt * activate_grad(density_act, s, 15.0f) : 0.0f;
        float coeff = ((foggy && s < 0.0f) ? -1e-4f : 0.0f) +
                      ((s > -10.0f && ts[base + k] < near_distance) ? 1e-4f : 0.0f);
        coeff = coeff * (v ? 1.0f : 0.0f) * reg_scale;
        go[3] = ds + coeff * clip_grad(s, -30.0f, 30.0f);
    }
}

}  // namespace

extern "C" int ngp_composite_train(const void* out, const void* ts, const void* dts,
                                   const void* valid, const void* target, const void* bg,
                                   const void* pixel_ok, const void* mean_density, int R, int K,
                                   float near_distance, float reg_scale, float inv_n_rays,
                                   float eps_t, int loss, int rgb_act, int density_act,
                                   void* per_ray, void* dout, void* stream) {
    const int threads = 128;
    const unsigned blocks = (unsigned)((R + threads - 1) / threads);
    composite_train_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(out), static_cast<const float*>(ts),
        static_cast<const float*>(dts), static_cast<const bool*>(valid),
        static_cast<const float*>(target), static_cast<const float*>(bg),
        static_cast<const bool*>(pixel_ok), static_cast<const float*>(mean_density), R, K,
        near_distance, reg_scale, inv_n_rays, eps_t, loss, rgb_act, density_act,
        static_cast<float*>(per_ray), static_cast<float*>(dout));
    return (int)cudaGetLastError();
}
