// Kernel C: occupancy-grid ray march.
//
// Replaces instant_ngp_tpu/nerf/sampler.py::march_rays, with
// nerf/occupancy.py::skip_at and the stepping math of ops/raymarch.py
// (to/from_stepping_space, calc_dt, distance_to_next_voxel,
// advance_to_next_voxel, mip_from_pos, mip_from_dt).
// Plain version: instant_ngp_torch/nerf/sampler.py::march_rays_plain.
//
// What bounds it on an H100: every iteration of a ray reads one 4-byte
// value of the skip chain (8 x 128^3 f32 = 64 MB), at an address that
// depends on the previous iteration's result. The arithmetic between two
// reads is a few dozen flops, so a ray's loop is a chain of dependent
// loads: the kernel is latency-bound.
//
// Simple design: one thread per ray runs the per-ray loop of the JAX
// while_loop for up to n_march_iters iterations and writes ts, dts,
// t_exit and n_valid into the (R, K) layout. The JAX loop is lockstep
// only for XLA's sake: a ray whose `ok` is false keeps t and its sample
// count unchanged from then on, so stopping each thread at its first
// non-ok iteration gives the same result. Many rays in flight hide the
// latency of each ray's chain. Both cone branches (cone_angle <= 1e-5),
// the idir clamp at 1e-12, the half-step minimum of
// advance_to_next_voxel and skip_at's "out of grid -> 1" are kept.
// logf/expf/frexpf/floorf are the accurate library functions: the library
// is built without fast math, because approximate intrinsics would move
// cell and step decisions. o + t*d and the linear branches of the stepping
// warp are fmaf, and divisions by constants are reciprocal multiplies, as
// the reference's compiled code computes them; -fmad=false keeps every
// other expression unfused.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kGrid = 128;
constexpr int kCascades = 8;
constexpr float kMaxDepth = 16384.0f;

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

__device__ __forceinline__ float calc_dt(float t, const Stepping& s) {
    if (s.uniform) return fmaf(fmaf(t, s.inv_min_step, 1.0f), s.min_step, -t);
    return from_stepping_space(to_stepping_space(t, s) + 1.0f, s) - t;
}

__device__ __forceinline__ float sign(float v) { return v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : 0.0f); }

__device__ float distance_to_next_voxel(const float pos[3], const float dir[3],
                                        const float idir[3], float res) {
    float t = INFINITY;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const float p = res * (pos[k] - 0.5f);
        float t_ax = (floorf((p + 0.5f) + 0.5f * sign(dir[k])) - p) * idir[k];
        if (fabsf(dir[k]) < 1e-10f) t_ax = INFINITY;
        t = fminf(t, t_ax);
    }
    return fmaxf(t / res, 0.0f);
}

__device__ float advance_to_next_voxel(float t, const Stepping& s, const float pos[3],
                                       const float dir[3], const float idir[3], int mip) {
    const float res = (float)kGrid * exp2f(-(float)mip);
    const float t_target = t + distance_to_next_voxel(pos, dir, idir, res);
    const float st = to_stepping_space(t, s);
    const float ds = s.uniform ? fmaf(t_target, s.inv_min_step, -st)
                               : to_stepping_space(t_target, s) - st;
    return from_stepping_space(st + ceilf(fmaxf(ds, 0.5f)), s);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

__device__ int mip_from_dt(float dt, const float pos[3], int max_cascade) {
    const float maxval = fmaxf(fmaxf(fabsf(pos[0] - 0.5f), fabsf(pos[1] - 0.5f)), fabsf(pos[2] - 0.5f));
    int e;
    frexpf(fmaxf(maxval, 1e-30f), &e);
    const int mip = clampi(e + 1, 0, max_cascade);
    const float dt_scaled = dt * (float)(2 * kGrid);
    frexpf(fmaxf(dt_scaled, 1e-30f), &e);
    return dt_scaled < 1.0f ? mip : clampi(max(mip, e), 0, max_cascade);
}

__device__ __forceinline__ float skip_at(const float* __restrict__ skipmip, const float pos[3], int mip) {
    const float mip_scale = exp2f(-(float)mip);
    int i[3];
    bool inb = true;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const float p = (pos[k] - 0.5f) * mip_scale + 0.5f;
        const float fi = floorf(p * (float)kGrid);
        inb = inb && fi >= 0.0f && fi < (float)kGrid;
        i[k] = fi < 0.0f ? 0 : (fi > (float)(kGrid - 1) ? kGrid - 1 : (int)fi);
    }
    const float v = __ldg(skipmip + (((size_t)mip * kGrid + i[0]) * kGrid + i[1]) * kGrid + i[2]);
    return inb ? v : 1.0f;
}

struct Aabb {
    float lo[3], hi[3];
};

__global__ void march_rays_kernel(const float* __restrict__ o, const float* __restrict__ d,
                                  const float* __restrict__ t0, const float* __restrict__ skipmip,
                                  Aabb box, Stepping s, int R, int K, int n_iters,
                                  int min_mip, int max_mip, float dt_scale,
                                  float* __restrict__ ts, float* __restrict__ dts,
                                  float* __restrict__ t_exit, int* __restrict__ n_valid) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= R) return;
    float org[3], dir[3], idir[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        org[k] = o[r * 3 + k];
        dir[k] = d[r * 3 + k];
        const float dk = fabsf(dir[k]) < 1e-12f ? (dir[k] >= 0.0f ? 1e-12f : -1e-12f) : dir[k];
        idir[k] = 1.0f / dk;
    }
    float* __restrict__ ts_r = ts + (size_t)r * K;
    float* __restrict__ dts_r = dts + (size_t)r * K;
    float t = t0[r];
    int n = 0;
    for (int it = 0; it < n_iters; ++it) {
        float pos[3];
        bool inside = true;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            pos[k] = fmaf(t, dir[k], org[k]);
            inside = inside && pos[k] >= box.lo[k] && pos[k] <= box.hi[k];
        }
        if (!(inside && t < kMaxDepth && n < K)) break;
        const float dt = calc_dt(t, s) * dt_scale;
        const int mip = clampi(mip_from_dt(dt, pos, max_mip), min_mip, max_mip);
        const float chain = skip_at(skipmip, pos, mip);
        if (chain == 0.0f) {
            ts_r[n] = t;
            ++n;
            t = t + dt;
        } else {
            const int skip_mip = min(mip + (int)fmaxf(chain - 1.0f, 0.0f), kCascades - 1);
            t = advance_to_next_voxel(t, s, pos, dir, idir, skip_mip);
        }
    }
    for (int k = 0; k < K; ++k) {
        if (k < n) {
            dts_r[k] = calc_dt(ts_r[k], s) * dt_scale;
        } else {
            ts_r[k] = 0.0f;
            dts_r[k] = 0.0f;
        }
    }
    t_exit[r] = t;
    n_valid[r] = n;
}

}  // namespace

extern "C" int ngp_march_rays(const void* o, const void* d, const void* t0, const void* skipmip,
                              const void* aabb, const void* stepping, int R, int K, int n_iters,
                              int min_mip, int max_mip, float dt_scale, void* ts, void* dts,
                              void* t_exit, void* n_valid, void* stream) {
    Aabb box;
    for (int k = 0; k < 3; ++k) {
        box.lo[k] = static_cast<const float*>(aabb)[k];
        box.hi[k] = static_cast<const float*>(aabb)[3 + k];
    }
    const float* sp = static_cast<const float*>(stepping);
    const Stepping s = {sp[0] != 0.0f, sp[1], sp[2], sp[3], sp[4], sp[5], sp[6], sp[7], sp[8],
                        sp[9], sp[10]};
    const int threads = 128;
    const int blocks = (R + threads - 1) / threads;
    march_rays_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(o), static_cast<const float*>(d), static_cast<const float*>(t0),
        static_cast<const float*>(skipmip), box, s, R, K, n_iters, min_mip, max_mip,
        dt_scale, static_cast<float*>(ts), static_cast<float*>(dts), static_cast<float*>(t_exit),
        static_cast<int*>(n_valid));
    return (int)cudaGetLastError();
}
