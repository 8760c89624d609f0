// Kernel C: occupancy-grid ray march.
//
// Replaces instant_ngp_tpu/nerf/sampler.py::march_rays, with
// nerf/occupancy.py::skip_at and the stepping math of ops/raymarch.py
// (ray_intersect_aabb, advance_n_steps, to/from_stepping_space, calc_dt,
// distance_to_next_voxel, advance_to_next_voxel, mip_from_pos,
// mip_from_dt). Plain version: instant_ngp_torch/nerf/sampler.py::
// march_rays_plain.
//
// What bounds it on an H100: latency. Every iteration of a ray is a chain
// of dependent steps (logf, expf, the mip, the address of one skip-chain
// value, its load, then either an emitted sample or a skip with another
// logf and expf), and a ray runs up to n_march_iters of them (at fox's
// training march every ray fills its 32 slots within 40). A training batch
// is only 4,096 rays (128 warps), far too few to hide that chain.
//
// Design: one thread per ray runs the per-ray loop of the JAX while_loop
// and writes ts, dts, valid, t_exit and n_valid into the (R, K) layout. The
// JAX loop is lockstep only for XLA's sake: a ray whose `ok` is false keeps
// t and its sample count unchanged from then on, so stopping each thread at
// its first non-ok iteration gives the same result. What shortens the work
// per ray, each without changing a bit of the result:
// - the ray's start (the aabb entry advanced by its jitter in stepping
//   space) is computed here, from the jitter, instead of by ~25 PyTorch
//   operations before the launch;
// - to_stepping_space(t) is computed once per iteration and serves both
//   calc_dt and the skip;
// - 2^-mip, 128·2^-mip and its inverse are built from exponent bits, and
//   frexpf's exponent is read from the bits (all exact: the inputs are
//   positive normal floats and the results powers of two), so a division
//   by the power-of-two resolution is a multiply by its exact inverse;
// - an emitted sample stores the dt its step computed: the plain version's
//   calc_dt(ts) of the same t gives the same bits, so there is no second
//   pass over the samples;
// - 32-thread blocks (kThreads) spread a 4,096-ray training batch over
//   128 SMs instead of 32.
// A uint8 copy of the skip chain was measured and not kept (PERF.md):
// fox's three cascades are 24 MB of f32 and stay in L2, and the byte load
// was no faster.
// Both cone branches (cone_angle <= 1e-5), the idir clamp at 1e-12, the
// half-step minimum of advance_to_next_voxel and skip_at's "out of grid ->
// 1" are kept. logf/expf/floorf are the accurate library functions: the
// library is built without fast math, because approximate intrinsics would
// move cell and step decisions. o + t*d and the linear branches of the
// stepping warp are fmaf, and divisions by constants are reciprocal
// multiplies, as the reference's compiled code computes them; -fmad=false
// keeps every other expression unfused.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kGrid = 128;  // 2^7 cells a side
constexpr int kGridLog2 = 7;
constexpr int kCascades = 8;
constexpr float kMaxDepth = 16384.0f;
// the block size: 32 threads put a 4,096-ray training batch on 128 SMs, where
// 128 left 100 SMs idle (PERF.md, kernel C's levers)
constexpr int kThreads = 32;

// f32 constants of the stepping-space warp, computed once on the host
// (ops/raymarch.py::stepping) so that kernel and plain version share them
struct Stepping {
    bool uniform;
    float log1p_c, inv_log1p_c, a, b, at, bt, min_step, inv_min_step, max_step, inv_max_step;
};

// As the reference is compiled: division by a constant is a multiply by
// its reciprocal, and (x - c) * k + c' is one fused multiply-add.
__device__ __forceinline__ float to_stepping_space(float t, const Stepping& s) {
    if (s.uniform) return t * s.inv_min_step;
    if (t <= s.at) return fmaf(t - s.at, s.inv_min_step, s.a);
    if (t <= s.bt) return logf(fmaxf(t, 1e-30f)) * s.inv_log1p_c;
    return fmaf(t - s.bt, s.inv_max_step, s.b);
}

__device__ __forceinline__ float from_stepping_space(float n, const Stepping& s) {
    if (s.uniform) return n * s.min_step;
    if (n <= s.a) return fmaf(n - s.a, s.min_step, s.at);
    if (n <= s.b) return expf(n * s.log1p_c);
    return fmaf(n - s.b, s.max_step, s.bt);
}

// 2^e for an integer e in [-126, 127], exactly exp2f's value
__device__ __forceinline__ float pow2i(int e) { return __int_as_float((e + 127) << 23); }

// the exponent frexpf gives a positive normal x (x = m * 2^e, m in [0.5, 1))
__device__ __forceinline__ int frexp_exp(float x) { return (__float_as_int(x) >> 23) - 126; }

__device__ __forceinline__ float sign(float v) { return v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : 0.0f); }

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

// the skip from t, whose stepping-space position is st, to the next voxel
// of cascade mip (res = 128 * 2^-mip cells across [0, 1]; t / res is the
// multiply by the exact inverse)
__device__ float advance_to_next_voxel(float t, float st, const Stepping& s, const float pos[3],
                                       const float dir[3], const float idir[3], int mip) {
    const float res = pow2i(kGridLog2 - mip);
    float dist = INFINITY;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const float p = res * (pos[k] - 0.5f);
        float t_ax = (floorf((p + 0.5f) + 0.5f * sign(dir[k])) - p) * idir[k];
        if (fabsf(dir[k]) < 1e-10f) t_ax = INFINITY;
        dist = fminf(dist, t_ax);
    }
    const float t_target = t + fmaxf(dist * pow2i(mip - kGridLog2), 0.0f);
    const float ds = s.uniform ? fmaf(t_target, s.inv_min_step, -st)
                               : to_stepping_space(t_target, s) - st;
    return from_stepping_space(st + ceilf(fmaxf(ds, 0.5f)), s);
}

__device__ __forceinline__ int mip_from_dt(float dt, const float pos[3], int max_cascade) {
    const float maxval = fmaxf(fmaxf(fabsf(pos[0] - 0.5f), fabsf(pos[1] - 0.5f)), fabsf(pos[2] - 0.5f));
    const int mip = clampi(frexp_exp(fmaxf(maxval, 1e-30f)) + 1, 0, max_cascade);
    const float dt_scaled = dt * (float)(2 * kGrid);
    return dt_scaled < 1.0f ? mip
                            : clampi(max(mip, frexp_exp(fmaxf(dt_scaled, 1e-30f))), 0, max_cascade);
}

__device__ __forceinline__ float skip_at(const float* __restrict__ skipmip, const float pos[3],
                                         int mip) {
    const float mip_scale = pow2i(-mip);
    int i[3];
    bool inb = true;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const float p = (pos[k] - 0.5f) * mip_scale + 0.5f;
        const float fi = floorf(p * (float)kGrid);
        inb = inb && fi >= 0.0f && fi < (float)kGrid;
        i[k] = fi < 0.0f ? 0 : (fi > (float)(kGrid - 1) ? kGrid - 1 : (int)fi);
    }
    const float v = __ldg(skipmip + (((mip * kGrid + i[0]) * kGrid + i[1]) * kGrid + i[2]));
    return inb ? v : 1.0f;
}

__global__ void march_rays_kernel(const float* __restrict__ o, const float* __restrict__ d,
                                  const float* __restrict__ t0, const float* __restrict__ skipmip,
                                  const float* __restrict__ aabb_min,
                                  const float* __restrict__ aabb_max, Stepping s, int R, int K,
                                  int n_iters, int min_mip, int max_mip, float dt_scale,
                                  bool from_jitter, float* __restrict__ ts, float* __restrict__ dts,
                                  bool* __restrict__ valid, float* __restrict__ t_exit,
                                  int* __restrict__ n_valid) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= R) return;
    float org[3], dir[3], idir[3], lo[3], hi[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        lo[k] = __ldg(aabb_min + k);
        hi[k] = __ldg(aabb_max + k);
        org[k] = o[r * 3 + k];
        dir[k] = d[r * 3 + k];
        const float dk = fabsf(dir[k]) < 1e-12f ? (dir[k] >= 0.0f ? 1e-12f : -1e-12f) : dir[k];
        idir[k] = 1.0f / dk;
    }
    float t = t0[r];
    if (from_jitter) {  // ray_intersect_aabb's tmin, advanced by the jitter (advance_n_steps)
        float tmin = -INFINITY;
#pragma unroll
        for (int k = 0; k < 3; ++k)
            tmin = fmaxf(tmin, fminf((lo[k] - org[k]) * idir[k], (hi[k] - org[k]) * idir[k]));
        tmin = fmaxf(tmin, 0.0f);
        t = s.uniform ? fmaf(tmin, s.inv_min_step, t) * s.min_step
                      : from_stepping_space(to_stepping_space(tmin, s) + t, s);
    }
    float* __restrict__ ts_r = ts + (size_t)r * K;
    float* __restrict__ dts_r = dts + (size_t)r * K;
    bool* __restrict__ valid_r = valid + (size_t)r * K;
    int n = 0;
    for (int it = 0; it < n_iters; ++it) {
        float pos[3];
        bool inside = true;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            pos[k] = fmaf(t, dir[k], org[k]);
            inside = inside && pos[k] >= lo[k] && pos[k] <= hi[k];
        }
        if (!(inside && t < kMaxDepth && n < K)) break;
        const float st = to_stepping_space(t, s);
        // calc_dt(t) * dt_scale
        const float dt = (s.uniform ? fmaf(fmaf(t, s.inv_min_step, 1.0f), s.min_step, -t)
                                    : from_stepping_space(st + 1.0f, s) - t) * dt_scale;
        const int mip = clampi(mip_from_dt(dt, pos, max_mip), min_mip, max_mip);
        const float c = skip_at(skipmip, pos, mip);
        if (c == 0.0f) {
            ts_r[n] = t;
            dts_r[n] = dt;
            valid_r[n] = true;
            ++n;
            t = t + dt;
        } else {
            const int skip_mip = min(mip + (int)fmaxf(c - 1.0f, 0.0f), kCascades - 1);
            t = advance_to_next_voxel(t, st, s, pos, dir, idir, skip_mip);
        }
    }
    for (int k = n; k < K; ++k) {
        ts_r[k] = 0.0f;
        dts_r[k] = 0.0f;
        valid_r[k] = false;
    }
    t_exit[r] = t;
    n_valid[r] = n;
}

}  // namespace

// from_jitter: t0 holds each ray's start jitter (else its start distance)
extern "C" int ngp_march_rays(const void* o, const void* d, const void* t0, const void* skipmip,
                              const void* aabb_min, const void* aabb_max, const void* stepping,
                              int R, int K, int n_iters, int min_mip, int max_mip, float dt_scale,
                              int from_jitter, void* ts, void* dts, void* valid,
                              void* t_exit, void* n_valid, void* stream) {
    const float* sp = static_cast<const float*>(stepping);
    const Stepping s = {sp[0] != 0.0f, sp[1], sp[2], sp[3], sp[4], sp[5], sp[6], sp[7], sp[8],
                        sp[9], sp[10]};
    const int blocks = (R + kThreads - 1) / kThreads;
    march_rays_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(o), static_cast<const float*>(d), static_cast<const float*>(t0),
        static_cast<const float*>(skipmip), static_cast<const float*>(aabb_min),
        static_cast<const float*>(aabb_max), s, R, K, n_iters, min_mip, max_mip, dt_scale,
        from_jitter != 0, static_cast<float*>(ts), static_cast<float*>(dts),
        static_cast<bool*>(valid), static_cast<float*>(t_exit), static_cast<int*>(n_valid));
    return (int)cudaGetLastError();
}
