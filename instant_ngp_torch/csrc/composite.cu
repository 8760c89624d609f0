// Kernel D: composite one render window.
//
// Replaces instant_ngp_tpu/nerf/task.py::NerfTask._composite_window (the
// cumsum-based alpha compositing of a (R, K) sample window onto the rays'
// running transmittance, color and depth, plus the alive rule).
// Plain version: instant_ngp_torch/nerf/task.py::composite_window_plain.
//
// What bounds it on an H100: a ray reads K = 8 samples of 4 + 3 floats and
// its running state, about 140 bytes, and does a few exps per sample:
// memory-bound, and small next to the march and the network.
//
// Simple design: one thread per ray walks its K samples in order, keeping
// the running sum of tau in a register. Per sample: sigma =
// exp(clip(logit, -15, 15)), 0 where the sample is invalid; rgb through
// the logistic (exp for HDR); tau = sigma * dt; the weight is
// (1 - e^{-tau}) * T * e^{-(cumsum - tau)}, i.e. the exclusive running
// sum, computed as the JAX package computes it. It then writes T, rgb,
// depth, the alive flag (T >= eps, t_exit < tmax, and progress t_exit > t)
// and the cost (valid sample count). expf is the accurate library
// function.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kNone = 0, kRelu = 1, kLogistic = 2, kExponential = 3;

__device__ __forceinline__ float to_rgb(float v, int act) {
    switch (act) {
        case kRelu: return fmaxf(v, 0.0f);
        case kLogistic: return 1.0f / (1.0f + expf(-v));
        case kExponential: return expf(fminf(fmaxf(v, -10.0f), 10.0f));
        default: return v;
    }
}

__device__ __forceinline__ float to_density(float v, int act) {
    switch (act) {
        case kRelu: return fmaxf(v, 0.0f);
        case kLogistic: return 1.0f / (1.0f + expf(-v));
        case kExponential: return expf(fminf(fmaxf(v, -15.0f), 15.0f));
        default: return v;
    }
}

__global__ void composite_window_kernel(
    const float* __restrict__ out, const float* __restrict__ ts, const float* __restrict__ dts,
    const uint8_t* __restrict__ valid, const float* __restrict__ t, const float* __restrict__ t_exit,
    const float* __restrict__ T, const float* __restrict__ rgb, const float* __restrict__ depth,
    const uint8_t* __restrict__ alive, const float* __restrict__ tmax, const float* __restrict__ cost,
    int R, int K, float eps_t, int rgb_act, int density_act, float* __restrict__ T_new,
    float* __restrict__ rgb_new, float* __restrict__ depth_new, uint8_t* __restrict__ alive_new,
    float* __restrict__ cost_new) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= R) return;
    const float Tr = T[r];
    float cs = 0.0f, acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_d = 0.0f;
    int n_valid = 0;
    for (int k = 0; k < K; ++k) {
        const size_t i = (size_t)r * K + k;
        const float4 o = reinterpret_cast<const float4*>(out)[i];
        const bool v = valid[i] != 0;
        const float sigma = v ? to_density(o.w, density_act) : 0.0f;
        const float tau = sigma * dts[i];
        cs = cs + tau;
        const float weight = (1.0f - expf(-tau)) * (Tr * expf(-cs + tau));
        acc_r = acc_r + weight * to_rgb(o.x, rgb_act);
        acc_g = acc_g + weight * to_rgb(o.y, rgb_act);
        acc_b = acc_b + weight * to_rgb(o.z, rgb_act);
        acc_d = acc_d + weight * ts[i];
        n_valid += v;
    }
    const float Tn = Tr * expf(-cs);
    T_new[r] = Tn;
    rgb_new[r * 3 + 0] = rgb[r * 3 + 0] + acc_r;
    rgb_new[r * 3 + 1] = rgb[r * 3 + 1] + acc_g;
    rgb_new[r * 3 + 2] = rgb[r * 3 + 2] + acc_b;
    depth_new[r] = depth[r] + acc_d;
    alive_new[r] = (alive[r] != 0) && Tn >= eps_t && t_exit[r] < tmax[r] && t_exit[r] > t[r];
    cost_new[r] = cost[r] + (float)n_valid;
}

}  // namespace

extern "C" int ngp_composite_window(const void* out, const void* ts, const void* dts,
                                    const void* valid, const void* t, const void* t_exit,
                                    const void* T, const void* rgb, const void* depth,
                                    const void* alive, const void* tmax, const void* cost, int R,
                                    int K, float eps_t, int rgb_act, int density_act, void* T_new,
                                    void* rgb_new, void* depth_new, void* alive_new,
                                    void* cost_new, void* stream) {
    const int threads = 128;
    const int blocks = (R + threads - 1) / threads;
    composite_window_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(out), static_cast<const float*>(ts),
        static_cast<const float*>(dts), static_cast<const uint8_t*>(valid),
        static_cast<const float*>(t), static_cast<const float*>(t_exit),
        static_cast<const float*>(T), static_cast<const float*>(rgb),
        static_cast<const float*>(depth), static_cast<const uint8_t*>(alive),
        static_cast<const float*>(tmax), static_cast<const float*>(cost), R, K, eps_t, rgb_act,
        density_act, static_cast<float*>(T_new), static_cast<float*>(rgb_new),
        static_cast<float*>(depth_new), static_cast<uint8_t*>(alive_new),
        static_cast<float*>(cost_new));
    return (int)cudaGetLastError();
}
