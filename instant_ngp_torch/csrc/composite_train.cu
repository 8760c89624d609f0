// Kernel G: training composite + loss + backward, fused.
//
// Replaces instant_ngp_tpu/nerf/task.py::_composite (task.py:683, the
// cumsum compositing at :748-757), the per-ray loss (task.py:937-940), the
// objectives of the three train modes (task.py:930-990), the density
// regularizers (task.py:1004-1020) and JAX's autodiff of them: the
// reference's compute_loss_kernel_train_nerf (testbed_nerf.cu:852-1180)
// fuses them the same way. Plain version: instant_ngp_torch/nerf/train.py::
// composite_train_plain.
//
// Per ray, over its K samples: rgb and density activations, tau = sigma·dt,
// T_k = exp(−cumsum(tau)_k + tau_k) (the JAX order), w_k = (1 − e^−tau_k)·
// T_k, rgb = Σ w_k c_k plus T_final·bg where T_final >= EPS_T, the loss
// (L2, Huber/5, L1, MAPE, SMAPE, LogL1 or RelativeL2; a template parameter)
// averaged over the channels, times pixel_ok: the per-ray loss of every
// mode. Then the gradient of the mode's objective (a template parameter)
// plus Σ stopgrad(coeff)·clip(σ_logit, ±30):
//   nerf: G = d objective / d rgb, d tau_k = G·(T_k e^−tau_k c_k − suffix_k)
//     with suffix_k = rgb − Σ_{j<=k} w_j c_j, d/d rgb logits G·w_k·act';
//   rfl: the loss composited over the samples, Σ w_k ℓ(t, c_k) + T_final·
//     ℓ(t, bg): the same identity with L_k = Σ_ch ℓ(t, c_k) (a fourth scan);
//   rflrelax: each sample's ℓ'(t, lerp_k) at lerp_k = (1 − α_k)·suffix_k /
//     max(T_k − w_k, 1e-6) + α_k c_k, with stop-gradient coefficients.
// d σ_logit goes through the clamped exp (0.5 on the clamp bounds, as JAX
// differentiates jnp.clip). The regularizer adds its coefficient where the
// grid is foggy (mean density, read on the device) and σ_logit < 0 (−1e-4),
// and where the sample is nearer than near_distance with σ_logit > −10
// (+1e-4), times valid and reg_scale. Where the caller passes dtarget, d
// objective / d target (R, 3) is written too (the exposure's and the
// environment map's gradient): a warp sum over the samples in the RFL modes;
// where it passes dbg, d objective / d bg (R, 3) (the environment map's):
// G·T_final in nerf mode, ct·T_final·ℓ'(t, bg) in rfl, 0 in rflrelax (its
// coefficients are stop-gradients). |x|'s slope is +1 at 0, as JAX takes it.
//
// Depth (task.py:753, :1021-1037): depth = Σ w_k t_k, a fifth scan, runs
// where the caller asks for the depth (depth_out, the sharpness deposit) or
// passes target depths. With targets, the objective gains λ·mean(ℓ_d(t_d,
// depth)·[t_d > 0]) in every mode (ℓ_d any of the seven losses, a runtime
// code: one scalar a ray), so d tau_k gains D·(T_k e^−tau_k t_k −
// (depth − Σ_{j<=k} w_j t_j)), D = λ/R·[t_d > 0]·ℓ_d'(t_d, depth): the suffix
// identity with t_k in place of c_k, no background term. The per-ray loss
// stays photometric (the error map's deposit).
//
// What bounds it on an H100: bytes. A sample reads its out row (16 B), ts,
// dts (4 B each) and valid (1 B) and writes its dout row (16 B): 41 B, so
// 5.4 MB at R 4096, K 32, 0.0016 ms at 3.35 TB/s; a few exp a sample (the
// depth term adds a ray's target depth read and its depth and d/d bg written,
// 20 B a ray). The
// work per ray is a chain (a prefix sum), so what the card reaches is set by
// latency: how many rays are in flight and how long one ray's chain is.
//
// Design: one warp per ray, one lane per sample, the samples in chunks of
// 32 (any K; lanes past K take tau = 0 and w·c = 0 and stay in the
// collectives). A lane loads its out row as one float4 and its ts, dts and
// valid entries, so a warp's out load is 512 contiguous bytes. The forward
// is an inclusive warp scan of tau (5 __shfl_up_sync steps) plus the running
// Σ tau carried from the chunk before, which gives T_k; and inclusive scans
// of w·c per channel (and of w·L in RFL) plus their carries, which give Σ_{j<=k}
// w_j c_j for the backward and, from the last lane, rgb. Loss and G are
// computed by every lane of the warp alike. The backward needs only each
// sample's forward state and rgb, so nothing is recomputed: the state of the
// first kRegChunks chunks stays in registers (K <= 64), that of later chunks
// goes to a scratch buffer the wrapper allocates at the size
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
constexpr int kL2 = 0, kHuber = 1, kL1 = 2, kMape = 3, kSmape = 4, kLogL1 = 5, kRelL2 = 6;
constexpr int kNerf = 0, kRfl = 1, kRelax = 2;
constexpr float kMinOpticalThickness = 0.01f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;      // rays per block
constexpr int kRegChunks = 2;  // chunks of 32 samples whose state stays in registers
constexpr int kStateFields = 19;

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
            // e / (1 + e)^2, JAX's autodiff of 1 / (1 + e^-v), but 0 where e^-v
            // overflows (v < -88.7), where that quotient is inf / inf = NaN
            const float e = expf(-v);
            const float u = 1.0f + e;
            return isinf(e) ? 0.0f : e / (u * u);
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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) x = x + __shfl_xor_sync(kFull, x, d);
    return x;
}

__device__ __forceinline__ float abs_slope(float x) { return x >= 0.0f ? 1.0f : -1.0f; }

// the loss of prediction p against target t, and its derivatives in p and
// in t, with the JAX package's stop-gradients (ops/losses.py::loss_and_grads)
template <int kLoss>
__device__ __forceinline__ float loss_value(float t, float p) {
    const float d = p - t;
    const float ad = fabsf(d);
    if (kLoss == kL2) return d * d;
    if (kLoss == kHuber) return (ad > 0.1f ? ad - 0.05f : (5.0f * d) * d) / 5.0f;
    if (kLoss == kL1) return ad;
    if (kLoss == kMape) return ad / (fabsf(p) + 1e-2f);
    if (kLoss == kSmape) return ad / (0.5f * (fabsf(p) + fabsf(t)) + 1e-2f);
    if (kLoss == kLogL1) return logf(ad + 1.0f);
    return d * d / (p * p + 1e-2f);
}

template <int kLoss>
__device__ __forceinline__ float loss_dp(float t, float p) {
    const float d = p - t;
    const float s = abs_slope(d);
    if (kLoss == kL2) return 2.0f * d;
    if (kLoss == kHuber) return (fabsf(d) > 0.1f ? s : 10.0f * d) / 5.0f;
    if (kLoss == kL1) return s;
    if (kLoss == kMape) return s / (fabsf(p) + 1e-2f);
    if (kLoss == kSmape) return s / (0.5f * (fabsf(p) + fabsf(t)) + 1e-2f);
    if (kLoss == kLogL1) return s / (fabsf(d) + 1.0f);
    const float den = p * p + 1e-2f;
    return 2.0f * d / den - d * d * (2.0f * p) / (den * den);
}

// loss_dp of the loss with runtime code ``loss`` (the depth term's)
__device__ __noinline__ float loss_dp_code(int loss, float t, float p) {
    switch (loss) {
        case kL2: return loss_dp<kL2>(t, p);
        case kHuber: return loss_dp<kHuber>(t, p);
        case kL1: return loss_dp<kL1>(t, p);
        case kMape: return loss_dp<kMape>(t, p);
        case kSmape: return loss_dp<kSmape>(t, p);
        case kLogL1: return loss_dp<kLogL1>(t, p);
        default: return loss_dp<kRelL2>(t, p);
    }
}

template <int kLoss>
__device__ __forceinline__ float loss_dt(float t, float p) {
    const float d = p - t;
    if (kLoss == kSmape) {
        const float den = 0.5f * (fabsf(p) + fabsf(t)) + 1e-2f;
        return -abs_slope(d) / den - fabsf(d) / (den * den) * (0.5f * abs_slope(t));
    }
    if (kLoss == kRelL2) return -2.0f * d / (p * p + 1e-2f);
    return -loss_dp<kLoss>(t, p);
}

// what the backward needs of one sample, from its forward
struct Sample {
    float col[3], prefix[3], col_grad[3];  // c_k, Σ_{j<=k} w_j c_j, d c_k / d logit
    float w, T, e, dt, density_grad, reg;
    float valid;     // 1 or 0
    float prefix_l;  // RFL: Σ_{j<=k} w_j L_j, L the sample's channel-summed loss
    float t, prefix_t;  // t_k and Σ_{j<=k} w_j t_j where the depth is needed
};

struct Params {
    const float4* out;
    const float* ts;
    const float* dts;
    const unsigned char* valid;
    int K;
    float near_distance, reg_scale;
    int rgb_act, density_act;
    bool need_depth;  // the depth scan runs (depth_out or target depths given)
};

// the forward of chunk c of the ray at base (= r·K): the sample's state;
// carry_tau, carry_wc, carry_l and carry_t hold the sums over the chunks
// before and are advanced past this one
template <int kLoss, int kMode>
__device__ __forceinline__ Sample forward_chunk(const Params& p, bool foggy, long long base,
                                                int c, int lane, const float* tgt,
                                                float& carry_tau, float* carry_wc,
                                                float& carry_l, float& carry_t) {
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
    s.T = T;
    s.e = e;
    const float logits[3] = {o.x, o.y, o.z};
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
        s.col[ch] = activate(p.rgb_act, logits[ch], 10.0f);
        s.col_grad[ch] = activate_grad(p.rgb_act, logits[ch], 10.0f);
        s.prefix[ch] = carry_wc[ch] + warp_scan(s.w * s.col[ch], lane);
        carry_wc[ch] = __shfl_sync(kFull, s.prefix[ch], 31);
    }
    carry_tau = __shfl_sync(kFull, cum, 31);
    s.prefix_l = 0.0f;
    if (kMode == kRfl) {
        float L = 0.0f;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) L = L + loss_value<kLoss>(tgt[ch], s.col[ch]);
        s.prefix_l = carry_l + warp_scan(w * L, lane);
        carry_l = __shfl_sync(kFull, s.prefix_l, 31);
    }
    s.t = t;
    s.prefix_t = 0.0f;
    if (p.need_depth) {  // uniform across the warp
        s.prefix_t = carry_t + warp_scan(w * t, lane);
        carry_t = __shfl_sync(kFull, s.prefix_t, 31);
    }
    s.dt = dt;
    s.density_grad = activate_grad(p.density_act, o.w, 15.0f);
    float coeff = ((foggy && o.w < 0.0f) ? -1e-4f : 0.0f) +
                  ((o.w > -10.0f && t < p.near_distance) ? 1e-4f : 0.0f);
    coeff = coeff * (v ? 1.0f : 0.0f) * p.reg_scale;
    s.reg = coeff * clip_grad(o.w, -30.0f, 30.0f);
    s.valid = v ? 1.0f : 0.0f;
    return s;
}

// the backward of one sample: its dout row, and its share of d objective
// / d target added to acc_t (RFL modes)
template <int kLoss, int kMode>
__device__ __forceinline__ void backward_sample(const Sample& s, const float* rgb, const float* G,
                                                const float* tgt, float ct, float comp_l,
                                                float depth, float Gd, float4* dout,
                                                long long base, int k, int K, float* acc_t) {
    if (k >= K) return;
    float go[3];
    float ds;
    if (kMode == kNerf) {
        const float T_next = s.T * s.e;
        float dtau = 0.0f;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
            const float suffix = rgb[ch] - s.prefix[ch];
            dtau = dtau + G[ch] * (T_next * s.col[ch] - suffix);
            go[ch] = G[ch] * s.w * s.col_grad[ch];
        }
        ds = s.valid != 0.0f ? dtau * s.dt * s.density_grad : 0.0f;
    } else if (kMode == kRfl) {
        float L = 0.0f;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
            L = L + loss_value<kLoss>(tgt[ch], s.col[ch]);
            go[ch] = ct * s.w * loss_dp<kLoss>(tgt[ch], s.col[ch]) * s.col_grad[ch];
            acc_t[ch] = acc_t[ch] + s.w * loss_dt<kLoss>(tgt[ch], s.col[ch]);
        }
        const float dtau = ct * ((s.T * s.e) * L - (comp_l - s.prefix_l));
        ds = s.valid != 0.0f ? dtau * s.dt * s.density_grad : 0.0f;
    } else {
        const float alpha = 1.0f - s.e;
        const float T_after = s.T - s.w;
        const float coef = s.T * s.valid * ct;
        float dsig = 0.0f;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
            const float suffix = rgb[ch] - s.prefix[ch];
            const float rgb_bg = suffix / fmaxf(T_after, 1e-6f);
            const float lerp = (1.0f - alpha) * rgb_bg + alpha * s.col[ch];
            const float g = loss_dp<kLoss>(tgt[ch], lerp);
            go[ch] = coef * alpha * g * s.col_grad[ch];
            dsig = dsig + g * (T_after * s.col[ch] - suffix);
            acc_t[ch] = acc_t[ch] + coef * loss_dt<kLoss>(tgt[ch], lerp);
        }
        ds = dsig * s.dt * s.valid * ct * s.density_grad;
    }
    if (Gd != 0.0f && s.valid != 0.0f) {
        const float dtau_d = Gd * ((s.T * s.e) * s.t - (depth - s.prefix_t));
        ds = ds + dtau_d * s.dt * s.density_grad;
    }
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
template <int kLoss, int kMode, int kChunks>
__global__ void __launch_bounds__(kWarps * 32)
composite_train_kernel(Params p, const float* __restrict__ target, const float* __restrict__ bg,
                       const bool* __restrict__ pixel_ok, const float* __restrict__ mean_density,
                       int R, float inv_n_rays, float eps_t, float* __restrict__ per_ray,
                       float4* __restrict__ dout, float* __restrict__ dtarget,
                       const float* __restrict__ target_depth, float depth_lambda,
                       int depth_loss, float* __restrict__ depth_out, float* __restrict__ dbg,
                       float* __restrict__ scratch) {
    const int lane = threadIdx.x & 31;
    const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
    if (r >= R) return;  // the whole warp: one ray a warp
    const long long base = (long long)r * p.K;
    const int n_chunks = (p.K + 31) / 32;
    // the scratch of this ray: its chunks from kChunks on, kStateFields x 32 each
    float* ray_scratch = scratch + (long long)r * max(n_chunks - kChunks, 0) * kStateFields * 32;
    const bool foggy = mean_density[0] < kMinOpticalThickness;
    const float tgt[3] = {target[r * 3], target[r * 3 + 1], target[r * 3 + 2]};

    // forward
    float carry_tau = 0.0f, carry_l = 0.0f, carry_t = 0.0f;
    float carry_wc[3] = {0.0f, 0.0f, 0.0f};
    Sample held[kChunks];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
        if (c < n_chunks) {
            held[c] = forward_chunk<kLoss, kMode>(p, foggy, base, c, lane, tgt, carry_tau,
                                                  carry_wc, carry_l, carry_t);
        }
    }
    for (int c = kChunks; c < n_chunks; ++c) {
        store_state(ray_scratch + (long long)(c - kChunks) * kStateFields * 32,
                    forward_chunk<kLoss, kMode>(p, foggy, base, c, lane, tgt, carry_tau,
                                                carry_wc, carry_l, carry_t), lane);
    }
    const float T_final = expf(-carry_tau);
    const float bg_w = T_final >= eps_t ? T_final : 0.0f;
    const float ok = pixel_ok[r] ? 1.0f : 0.0f;
    float rgb[3], d[3], bgc[3], lsum = 0.0f, lbg = 0.0f;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
        bgc[ch] = bg[r * 3 + ch];
        rgb[ch] = carry_wc[ch] + bg_w * bgc[ch];
        d[ch] = rgb[ch] - tgt[ch];
        lsum = lsum + loss_value<kLoss>(tgt[ch], rgb[ch]);
        if (kMode == kRfl) lbg = lbg + loss_value<kLoss>(tgt[ch], bgc[ch]);
    }
    if (lane == 0) per_ray[r] = lsum / 3.0f * ok;
    const float comp_l = carry_l + bg_w * lbg;
    const float depth = carry_t;
    if (depth_out != nullptr && lane == 0) depth_out[r] = depth;
    // D = d objective / d depth
    float Gd = 0.0f;
    if (target_depth != nullptr) {
        const float td = target_depth[r];
        Gd = td > 0.0f ? depth_lambda * inv_n_rays * loss_dp_code(depth_loss, td, depth) : 0.0f;
    }

    // G = d objective / d rgb (nerf mode), in the order JAX's autodiff forms it
    const float ct = inv_n_rays * ok / 3.0f;
    float G[3];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
        if (kLoss == kHuber) {
            const float cth = ct / 5.0f;
            G[ch] = fabsf(d[ch]) > 0.1f ? (d[ch] > 0.0f ? cth : (d[ch] < 0.0f ? -cth : 0.0f))
                                        : cth * (5.0f * d[ch]) + cth * d[ch] * 5.0f;
        } else if (kLoss == kL2) {
            G[ch] = ct * d[ch] + ct * d[ch];
        } else {
            G[ch] = ct * loss_dp<kLoss>(tgt[ch], rgb[ch]);
        }
    }

    // backward, from the forward's state
    float acc_t[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
        if (c < n_chunks) {
            backward_sample<kLoss, kMode>(held[c], rgb, G, tgt, ct, comp_l, depth, Gd, dout,
                                          base, c * 32 + lane, p.K, acc_t);
        }
    }
    for (int c = kChunks; c < n_chunks; ++c) {
        backward_sample<kLoss, kMode>(
            load_state(ray_scratch + (long long)(c - kChunks) * kStateFields * 32, lane), rgb, G,
            tgt, ct, comp_l, depth, Gd, dout, base, c * 32 + lane, p.K, acc_t);
    }
    if (dbg != nullptr && lane == 0) {
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
            dbg[r * 3 + ch] = kMode == kNerf ? G[ch] * bg_w
                            : kMode == kRfl ? ct * bg_w * loss_dp<kLoss>(tgt[ch], bgc[ch])
                                            : 0.0f;
        }
    }
    if (dtarget != nullptr) {
        float dt_out[3];
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
            if (kMode == kNerf) {
                dt_out[ch] = ct * loss_dt<kLoss>(tgt[ch], rgb[ch]);
            } else if (kMode == kRfl) {
                dt_out[ch] = ct * (warp_sum(acc_t[ch]) + bg_w * loss_dt<kLoss>(tgt[ch], bgc[ch]));
            } else {
                dt_out[ch] = warp_sum(acc_t[ch]);
            }
        }
        if (lane == 0) {
#pragma unroll
            for (int ch = 0; ch < 3; ++ch) dtarget[r * 3 + ch] = dt_out[ch];
        }
    }
}

struct Launch {
    Params p;
    const float *target, *bg, *mean_density;
    const bool* pixel_ok;
    int R;
    float inv_n_rays, eps_t;
    float *per_ray, *dtarget, *scratch;
    float4* dout;
    const float* target_depth;
    float depth_lambda;
    int depth_loss;
    float *depth_out, *dbg;
    cudaStream_t st;
};

template <int kLoss, int kMode, int kChunks>
void launch(const Launch& a) {
    const unsigned blocks = (unsigned)((a.R + kWarps - 1) / kWarps);
    composite_train_kernel<kLoss, kMode, kChunks><<<blocks, kWarps * 32, 0, a.st>>>(
        a.p, a.target, a.bg, a.pixel_ok, a.mean_density, a.R, a.inv_n_rays, a.eps_t, a.per_ray,
        a.dout, a.dtarget, a.target_depth, a.depth_lambda, a.depth_loss, a.depth_out, a.dbg,
        a.scratch);
}

template <int kLoss, int kMode>
void launch_k(const Launch& a) {
    if (a.p.K <= 32) {
        launch<kLoss, kMode, 1>(a);
    } else {
        launch<kLoss, kMode, kRegChunks>(a);
    }
}

template <int kLoss>
bool launch_mode(const Launch& a, int mode) {
    switch (mode) {
        case kNerf: launch_k<kLoss, kNerf>(a); return true;
        case kRfl: launch_k<kLoss, kRfl>(a); return true;
        case kRelax: launch_k<kLoss, kRelax>(a); return true;
        default: return false;
    }
}

bool launch_loss(const Launch& a, int loss, int mode) {
    switch (loss) {
        case kL2: return launch_mode<kL2>(a, mode);
        case kHuber: return launch_mode<kHuber>(a, mode);
        case kL1: return launch_mode<kL1>(a, mode);
        case kMape: return launch_mode<kMape>(a, mode);
        case kSmape: return launch_mode<kSmape>(a, mode);
        case kLogL1: return launch_mode<kLogL1>(a, mode);
        case kRelL2: return launch_mode<kRelL2>(a, mode);
        default: return false;
    }
}

}  // namespace

// the f32 scratch ngp_composite_train needs for R rays of K samples: the
// forward state of every chunk past the first kRegChunks, kStateFields x 32
// floats a chunk; 0 where K <= 32 * kRegChunks
extern "C" long long ngp_composite_train_scratch_floats(int R, int K) {
    const long long spill = (K + 31) / 32 - kRegChunks;
    return spill > 0 ? (long long)R * spill * kStateFields * 32 : 0;
}

// scratch: ngp_composite_train_scratch_floats(R, K) floats, or null where
// that is 0; dtarget: (R, 3) f32, or null where the caller needs no d/d target;
// target_depth: (R,) f32 target depths (0: none), or null without the depth
// term; depth_out: (R,) f32, or null; dbg: (R, 3) f32 d/d bg, or null
extern "C" int ngp_composite_train(const void* out, const void* ts, const void* dts,
                                   const void* valid, const void* target, const void* bg,
                                   const void* pixel_ok, const void* mean_density, int R, int K,
                                   float near_distance, float reg_scale, float inv_n_rays,
                                   float eps_t, int loss, int mode, int rgb_act, int density_act,
                                   void* per_ray, void* dout, void* dtarget,
                                   const void* target_depth, float depth_lambda, int depth_loss,
                                   void* depth_out, void* dbg, void* scratch, void* stream) {
    if (K < 0 || (K > 32 * kRegChunks && scratch == nullptr)) return (int)cudaErrorInvalidValue;
    if (target_depth != nullptr && (depth_loss < kL2 || depth_loss > kRelL2)) {
        return (int)cudaErrorInvalidValue;
    }
    Launch a;
    a.p.out = static_cast<const float4*>(out);
    a.p.ts = static_cast<const float*>(ts);
    a.p.dts = static_cast<const float*>(dts);
    a.p.valid = static_cast<const unsigned char*>(valid);
    a.p.K = K;
    a.p.near_distance = near_distance;
    a.p.reg_scale = reg_scale;
    a.p.rgb_act = rgb_act;
    a.p.density_act = density_act;
    a.p.need_depth = target_depth != nullptr || depth_out != nullptr;
    a.target = static_cast<const float*>(target);
    a.bg = static_cast<const float*>(bg);
    a.pixel_ok = static_cast<const bool*>(pixel_ok);
    a.mean_density = static_cast<const float*>(mean_density);
    a.R = R;
    a.inv_n_rays = inv_n_rays;
    a.eps_t = eps_t;
    a.per_ray = static_cast<float*>(per_ray);
    a.dout = static_cast<float4*>(dout);
    a.dtarget = static_cast<float*>(dtarget);
    a.scratch = static_cast<float*>(scratch);
    a.target_depth = static_cast<const float*>(target_depth);
    a.depth_lambda = depth_lambda;
    a.depth_loss = depth_loss;
    a.depth_out = static_cast<float*>(depth_out);
    a.dbg = static_cast<float*>(dbg);
    a.st = static_cast<cudaStream_t>(stream);
    if (!launch_loss(a, loss, mode)) return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}
