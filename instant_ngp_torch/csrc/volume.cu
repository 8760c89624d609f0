// Kernels L and M: the volume primitive's path tracers through the
// ground-truth density grid.
//
// L (volume_generate_batch) replaces instant_ngp_tpu/volume/task.py::
// VolumeTask._generate_batch, the delta-tracked training batch; M
// (volume_trace_gt) replaces VolumeTask._render_rays_gt, the ground-truth
// render's Woodcock trace. Neither is a Pallas kernel: each is an XLA
// composition (a lax.scan of 192 lockstep iterations, a fori_loop of 256),
// which as plain PyTorch is a host loop of ~40 small ops an iteration, ~7,700
// launches a training step. Plain versions: instant_ngp_torch/volume/
// tracking.py::generate_batch_plain and trace_gt_plain.
//
// What bounds them on an H100: latency. A path is a chain of dependent
// iterations (logf, a move, the bitgrid's byte, on an event the grid's value,
// a compare with a draw), and a training batch is only 2^15 paths, 1,024
// warps over 132 SMs, too few to hide the chain. The draws are the only large
// traffic (14 floats a path an iteration for L, 5 for M); the grid (128^3 f32,
// 8 MiB) and the bitgrid (2 MiB) stay in L2.
//
// Design: one thread a path (a ray for M) runs all its iterations with its
// state in registers, and writes its outputs once. The JAX loops are lockstep
// only for XLA's sake: a path that is done (L) or no longer alive (M) changes
// nothing any more, so its thread stops there, and a draw is read only where
// the plain version uses it (the jitter and zeta2 at an event, the scatter
// normal at a scatter, the respawn's six at a respawn). Draws are stored
// iteration-major and path-minor, so a warp's reads of one draw coalesce. The
// vertex slots are register arrays indexed only by unrolled constants.
//
// The arithmetic is the plain version's, operation for operation: no fast
// math, -fmad=false (each a*b + c rounds twice), accurate logf, sqrtf and
// division, the divisions by constants as multiplies by their f32
// reciprocals (1 / extent, 1 / majorant), the norms summed (x*x + y*y) + z*z,
// sun^64 as six squarings, and the index truncation and floor of the JAX
// reads. Kept on purpose from the JAX function: a throughput that is never
// updated (an attempt ends with 1 or 0), the respawn draws consumed at every
// iteration, the pending range and done changed only when an attempt ends,
// the density read's floor and the bitgrid read's truncation toward zero.
// Later work (ROADMAP): draws made in the kernel from a counter-based
// generator, more paths in flight, the bitgrid in shared memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kVertices = 4;        // MAX_TRAIN_VERTICES
constexpr int kBatchDraws = 14;     // BatchDraws rows an iteration
constexpr int kGtDraws = 5;         // the ground-truth trace's
constexpr int kBitRes = 128;        // the bitgrid: 128^3 bytes
constexpr int kBatchThreads = 64;   // 2^15 paths: 512 blocks, ~4 an SM
constexpr int kGtThreads = 128;

// rows of a batch iteration's draws (tracking.py)
constexpr int kZeta1 = 0, kJitter = 1, kZeta2 = 4, kScatter = 5, kRespawnNormal = 8,
              kRespawnUniform = 11;

struct Params {
    float amin[3], amax[3], inv_extent[3];
    float scale, inv_majorant, albedo, scattering;
    float up[3], sun[3], sky[3], suncol[3];
    int res[3];
};

__device__ __forceinline__ float norm3(float x, float y, float z) {
    return sqrtf(x * x + y * y + z * z);
}

// ops/raymarch.py::ray_intersect_aabb: tmin clamped at 0, and tmax
__device__ __forceinline__ void intersect_aabb(const float o[3], const float d[3], const Params& p,
                                               float& tmin, float& tmax) {
    float lo = -INFINITY, hi = INFINITY;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const float dk = fabsf(d[k]) < 1e-12f ? (d[k] >= 0.0f ? 1e-12f : -1e-12f) : d[k];
        const float idir = 1.0f / dk;
        const float t0 = (p.amin[k] - o[k]) * idir;
        const float t1 = (p.amax[k] - o[k]) * idir;
        lo = fmaxf(lo, fminf(t0, t1));
        hi = fminf(hi, fmaxf(t0, t1));
    }
    tmin = fmaxf(lo, 0.0f);
    tmax = hi;
}

__device__ __forceinline__ bool inside(const float pos[3], const Params& p) {
    return pos[0] >= p.amin[0] && pos[0] <= p.amax[0] && pos[1] >= p.amin[1] &&
           pos[1] <= p.amax[1] && pos[2] >= p.amin[2] && pos[2] <= p.amax[2];
}

// VolumeTask._bitgrid_at: truncation toward zero, then the clip
__device__ __forceinline__ bool occupied(const uint8_t* __restrict__ bits, const float pos[3]) {
    int c[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) c[k] = min(max((int)(pos[k] * 128.0f + 0.5f), 0), kBitRes - 1);
    return bits[(c[0] * kBitRes + c[1]) * kBitRes + c[2]] != 0;
}

// VolumeTask._take of floor(fidx): 0 outside the grid
__device__ __forceinline__ float grid_value(const float* __restrict__ grid, const Params& p,
                                            const float fidx[3]) {
    int i[3];
    bool inb = true;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        i[k] = (int)floorf(fidx[k]);
        inb = inb && i[k] >= 0 && i[k] < p.res[k];
        i[k] = min(max(i[k], 0), p.res[k] - 1);
    }
    return inb ? grid[(i[0] * p.res[1] + i[1]) * p.res[2] + i[2]] : 0.0f;
}

// VolumeTask._grid_density_at: the nearest voxel
__device__ __forceinline__ float density_nearest(const float* __restrict__ grid, const Params& p,
                                                 const float pos[3]) {
    float f[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) f[k] = (pos[k] - p.amin[k]) * p.inv_extent[k] * (float)p.res[k];
    return grid_value(grid, p, f);
}

// VolumeTask._grid_density_at_jittered: floor(index - 0.5 + jitter)
__device__ __forceinline__ float density_jittered(const float* __restrict__ grid, const Params& p,
                                                  const float pos[3], const float jitter[3]) {
    float f[3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
        f[k] = (pos[k] - p.amin[k]) * p.inv_extent[k] * (float)p.res[k] - 0.5f + jitter[k];
    return grid_value(grid, p, f);
}

// tracking.py::proc_envmap
__device__ __forceinline__ void envmap(const float d[3], const Params& p, float out[3]) {
    const float skyam = (d[0] * p.up[0] + d[1] * p.up[1] + d[2] * p.up[2]) * 0.5f + 0.5f;
    float sunam = fmaxf(d[0] * p.sun[0] + d[1] * p.sun[1] + d[2] * p.sun[2], 0.0f);
#pragma unroll
    for (int k = 0; k < 6; ++k) sunam = sunam * sunam;
    const float s20 = 20.0f * sunam;
#pragma unroll
    for (int c = 0; c < 3; ++c) out[c] = p.sky[c] * skyam + p.suncol[c] * s20;
}

// tracking.py::_spawn: from the sphere of radius 2 toward a uniform point of
// the box, moved onto the box
__device__ __forceinline__ void spawn(const float n[3], const float u[3], const Params& p,
                                      float pos[3], float dir[3]) {
    const float nn = norm3(n[0], n[1], n[2]);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        pos[k] = n[k] / nn * 2.0f + 0.5f;
        dir[k] = u[k] * (p.amax[k] - p.amin[k]) + p.amin[k] - pos[k];
    }
    const float dn = norm3(dir[0], dir[1], dir[2]);
#pragma unroll
    for (int k = 0; k < 3; ++k) dir[k] = dir[k] / dn;
    float tmin, tmax;
    intersect_aabb(pos, dir, p, tmin, tmax);
    const float t = fmaxf(tmin, 0.0f) + 1e-6f;
#pragma unroll
    for (int k = 0; k < 3; ++k) pos[k] = pos[k] + t * dir[k];
}

__global__ void __launch_bounds__(kBatchThreads)
volume_generate_batch_kernel(const float* __restrict__ first, const float* __restrict__ draws,
                             const float* __restrict__ grid, const uint8_t* __restrict__ bits,
                             const Params p, int n, int n_iters, float* __restrict__ pts,
                             float* __restrict__ tgt, bool* __restrict__ valid) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    float pos[3], dir[3];
    {
        const float nrm[3] = {first[i], first[n + i], first[2 * n + i]};
        const float uni[3] = {first[3 * n + i], first[4 * n + i], first[5 * n + i]};
        spawn(nrm, uni, p, pos, dir);
    }
    float rec_pos[kVertices][3], rec_den[kVertices], rec_rgb[kVertices][3];
#pragma unroll
    for (int v = 0; v < kVertices; ++v) {
        rec_den[v] = 0.0f;
#pragma unroll
        for (int c = 0; c < 3; ++c) rec_pos[v][c] = rec_rgb[v][c] = 0.0f;
    }
    int n_rec = 0, pend_from = 0;
    bool done = false;
    for (int it = 0; it < n_iters && !done; ++it) {
        // row r of this iteration's draws for this path: d[r * n]
        const float* d = draws + (size_t)it * kBatchDraws * n + i;
        const float dt = -logf(1.0f - d[kZeta1 * n]) * p.scale;
#pragma unroll
        for (int k = 0; k < 3; ++k) pos[k] = pos[k] + dir[k] * dt;
        const bool in = inside(pos, p);
        bool absorb = false;
        if (in && occupied(bits, pos)) {  // an event
            const float jitter[3] = {d[kJitter * n], d[(kJitter + 1) * n], d[(kJitter + 2) * n]};
            const float density = density_jittered(grid, p, pos, jitter);
#pragma unroll
            for (int v = 0; v < kVertices; ++v) {
                if (v == n_rec) {
                    rec_den[v] = density;
#pragma unroll
                    for (int c = 0; c < 3; ++c) rec_pos[v][c] = pos[c];
                }
            }
            n_rec = min(n_rec + 1, kVertices);
            const float extinction = density * p.inv_majorant;
            const float scatter_prob = extinction * p.albedo;
            const float zeta2 = d[kZeta2 * n];
            const bool real = zeta2 < extinction;
            const bool scatter = real && zeta2 < scatter_prob;
            absorb = real && !scatter;
            if (scatter) {
                const float nd[3] = {d[kScatter * n], d[(kScatter + 1) * n],
                                     d[(kScatter + 2) * n]};
                const float nn = norm3(nd[0], nd[1], nd[2]);
                float nw[3];
#pragma unroll
                for (int k = 0; k < 3; ++k) nw[k] = dir[k] * p.scattering + nd[k] / nn;
                const float wn = norm3(nw[0], nw[1], nw[2]);
#pragma unroll
                for (int k = 0; k < 3; ++k) dir[k] = nw[k] / wn;
            }
        }
        if (!in || absorb) {  // the attempt ends: escaped (throughput 1) or absorbed (0)
            float rad[3];
            envmap(dir, p, rad);
            const float thr = absorb ? 0.0f : 1.0f;
#pragma unroll
            for (int v = 0; v < kVertices; ++v) {
                if (v >= pend_from && v < n_rec) {
#pragma unroll
                    for (int c = 0; c < 3; ++c) rec_rgb[v][c] = rad[c] * thr;
                }
            }
            pend_from = n_rec;
            if (n_rec >= kVertices) {
                done = true;
            } else {
                const float nrm[3] = {d[kRespawnNormal * n], d[(kRespawnNormal + 1) * n],
                                      d[(kRespawnNormal + 2) * n]};
                const float uni[3] = {d[kRespawnUniform * n], d[(kRespawnUniform + 1) * n],
                                      d[(kRespawnUniform + 2) * n]};
                spawn(nrm, uni, p, pos, dir);
            }
        }
    }
    // an attempt still in flight at the cap ends with throughput 1
    float rad[3];
    envmap(dir, p, rad);
#pragma unroll
    for (int v = 0; v < kVertices; ++v) {
        if (v >= pend_from && v < n_rec) {
#pragma unroll
            for (int c = 0; c < 3; ++c) rec_rgb[v][c] = rad[c] * 1.0f;
        }
    }
#pragma unroll
    for (int v = 0; v < kVertices; ++v) {
        const size_t row = (size_t)i * kVertices + v;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            pts[row * 3 + c] = rec_pos[v][c];
            tgt[row * 4 + c] = rec_rgb[v][c];
        }
        tgt[row * 4 + 3] = rec_den[v];
        valid[row] = v < n_rec;
    }
}

__global__ void __launch_bounds__(kGtThreads)
volume_trace_gt_kernel(const float* __restrict__ o, const float* __restrict__ d,
                       const float* __restrict__ draws, const float* __restrict__ grid,
                       const uint8_t* __restrict__ bits, const Params p, int R, int n_iters,
                       float* __restrict__ rgb, float* __restrict__ alpha) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= R) return;
    const float org[3] = {o[3 * i], o[3 * i + 1], o[3 * i + 2]};
    float dir[3] = {d[3 * i], d[3 * i + 1], d[3 * i + 2]};
    float tmin, tmax;
    intersect_aabb(org, dir, p, tmin, tmax);
    bool alive = tmax > tmin;
    float pos[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) pos[k] = org[k] + tmin * dir[k];
    bool absorbed = false, scattered = false;
    for (int it = 0; it < n_iters && alive; ++it) {
        // row r of this iteration's draws for this ray: dr[r * R]
        const float* dr = draws + (size_t)it * kGtDraws * R + i;
        const float dt = -logf(dr[0]) * p.scale;
#pragma unroll
        for (int k = 0; k < 3; ++k) pos[k] = pos[k] + dt * dir[k];
        const bool in = inside(pos, p);
        if (in && occupied(bits, pos)) {  // an event
            const float extinction = density_nearest(grid, p, pos) * p.inv_majorant;
            const float z2 = dr[R];
            const bool scatter = z2 < extinction * p.albedo;
            if (scatter) {
                float nd[3];
#pragma unroll
                for (int k = 0; k < 3; ++k) nd[k] = dir[k] * p.scattering + dr[(2 + k) * R];
                const float nn = fmaxf(norm3(nd[0], nd[1], nd[2]), 1e-9f);
#pragma unroll
                for (int k = 0; k < 3; ++k) dir[k] = nd[k] / nn;
                scattered = true;
            } else if (z2 < extinction) {
                absorbed = true;
            }
        }
        alive = in && !absorbed;
    }
    float env[3];
    envmap(dir, p, env);
#pragma unroll
    for (int c = 0; c < 3; ++c) rgb[3 * i + c] = absorbed ? 0.0f : env[c];
    alpha[i] = (absorbed || scattered) ? 1.0f : 0.0f;
}

Params make_params(const void* values, const void* res) {
    const float* f = static_cast<const float*>(values);
    const int* r = static_cast<const int*>(res);
    Params p;
    for (int k = 0; k < 3; ++k) {
        p.amin[k] = f[k];
        p.amax[k] = f[3 + k];
        p.inv_extent[k] = f[6 + k];
        p.up[k] = f[13 + k];
        p.sun[k] = f[16 + k];
        p.sky[k] = f[19 + k];
        p.suncol[k] = f[22 + k];
        p.res[k] = r[k];
    }
    p.scale = f[9];
    p.inv_majorant = f[10];
    p.albedo = f[11];
    p.scattering = f[12];
    return p;
}

}  // namespace

extern "C" int ngp_volume_generate_batch(const void* first, const void* draws, const void* grid,
                                         const void* bits, const void* params, const void* res,
                                         int n, int n_iters, void* pts, void* tgt, void* valid,
                                         void* stream) {
    const Params p = make_params(params, res);
    const int blocks = (n + kBatchThreads - 1) / kBatchThreads;
    volume_generate_batch_kernel<<<blocks, kBatchThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(first), static_cast<const float*>(draws),
        static_cast<const float*>(grid), static_cast<const uint8_t*>(bits), p, n, n_iters,
        static_cast<float*>(pts), static_cast<float*>(tgt), static_cast<bool*>(valid));
    return (int)cudaGetLastError();
}

extern "C" int ngp_volume_trace_gt(const void* o, const void* d, const void* draws,
                                   const void* grid, const void* bits, const void* params,
                                   const void* res, int R, int n_iters, void* rgb, void* alpha,
                                   void* stream) {
    const Params p = make_params(params, res);
    const int blocks = (R + kGtThreads - 1) / kGtThreads;
    volume_trace_gt_kernel<<<blocks, kGtThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(o), static_cast<const float*>(d),
        static_cast<const float*>(draws), static_cast<const float*>(grid),
        static_cast<const uint8_t*>(bits), p, R, n_iters, static_cast<float*>(rgb),
        static_cast<float*>(alpha));
    return (int)cudaGetLastError();
}
