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
// warps over 132 SMs, ~8 an SM, too few to hide the chain. The draws are the
// only large traffic (14 floats a path an iteration for L, 5 for M); the grid
// (128^3 f32, 8 MiB) and the bitgrid (2 MiB) stay in L2.
//
// Design: one thread a path (a ray for M), its state in registers, its
// outputs written once. The memory latencies are taken off the chain from one
// iteration to the next:
//
// - Draws staged ahead of use. Each thread keeps a ring of kDepth stages of
//   kStage iterations in its own column of shared memory, holding the rows
//   every live iteration reads (L: zeta1, the jitter and zeta2, rows 0-4 of
//   14; M: u and z2, rows 0-1 of 5), and fills a stage kDepth - 1 stages
//   ahead of its use by 4-byte cp.async copies of its own column: a warp's
//   copies of one row are one coalesced 128-byte read, and no thread waits
//   for another. The rare rows (the scatter normal, the respawn's six) are
//   read at their use, as the plain version reads them.
// - A look-ahead window. The direction changes only at a scatter or a
//   respawn, and a free flight's length depends on its draw alone, so a
//   thread computes the positions of its next kWindow iterations at once
//   (the same per-axis multiply and add in the same order, so the same bits),
//   issues their bitgrid reads together and their grid reads (L: of the
//   occupied ones, after the bytes; M: of those in the box, with the bytes),
//   all predicated loads, so that no branch orders them, and then walks them
//   in order. At the first scatter, escape, absorption or respawn it
//   drops the rest of the window and starts the next one after it; null
//   events and recorded vertices move neither the position nor the
//   direction, so the window survives them. The cut's rare work (a new
//   direction, the envmap, a respawn) runs once after the walk, outside its
//   unrolled loop.
// Measured and not kept (instant_ngp_torch/bench/volume_variants.py): the
// block's draws staged by one thread's 1-D bulk copies on an mbarrier a stage
// (the block then walks its stages in step, and waits on its slowest warp), a
// bit-packed bitgrid (no faster), longer windows (more work lost at each cut:
// a warp pays for any lane's cut).
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
constexpr int kWindow = 4;          // iterations a look-ahead window
constexpr int kStage = 16;          // iterations a ring stage
constexpr int kBatchStaged = 5;     // L's staged rows: zeta1, the jitter, zeta2
constexpr int kGtStaged = 2;        // M's: u, z2
constexpr int kBatchDepth = 2;      // L's ring: 2 x 5 x 16 x 64 x 4 B = 40 KB a block
constexpr int kGtDepth = 3;         // M's: 3 x 2 x 16 x 128 x 4 B = 48 KB

// rows of a batch iteration's draws (tracking.py)
constexpr int kZeta1 = 0, kJitter = 1, kZeta2 = 4, kScatter = 5, kRespawnNormal = 8,
              kRespawnUniform = 11;
// rows of a ground-truth iteration's
constexpr int kGtU = 0, kGtZeta2 = 1, kGtNormal = 2;

struct Params {
    float amin[3], amax[3], inv_extent[3];
    float scale, inv_majorant, albedo, scattering;
    float up[3], sun[3], sky[3], suncol[3];
    int res[3];
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     (uint32_t)__cvta_generic_to_shared(dst)),
                 "l"(src)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// One thread's ring of staged draws: stage s (iterations [s * kStage, s *
// kStage + kStage)) lives in slot s % kDepth; row r of its iteration j is
// at col[((slot * kRows + r) * kStage + j) * kThreads], col being the
// thread's column of the block's shared memory. Only the thread reads and
// writes its column, so a stage is ready once its own copies are.
template <int kRows, int kThreads, int kDepth>
struct DrawRing {
    static constexpr size_t kBytes = sizeof(float) * kDepth * kRows * kStage * kThreads;

    float* col;
    const float* draws;  // (n_iters, per_iter, n), this thread's path at offset i
    int per_iter, n, n_iters, n_stages, i;

    __device__ DrawRing(float* smem, const float* draws_, int per_iter_, int n_, int n_iters_, int i_)
        : col(smem + threadIdx.x), draws(draws_), per_iter(per_iter_), n(n_), n_iters(n_iters_),
          n_stages((n_iters_ + kStage - 1) / kStage), i(i_) {}

    __device__ const float* src(int it, int r) const {
        return draws + ((size_t)it * per_iter + r) * n + i;
    }
    // row r < kRows of iteration s * kStage + j
    __device__ float at(int s, int r, int j) const {
        return col[(((s % kDepth) * kRows + r) * kStage + j) * kThreads];
    }
    // row r of that iteration: staged, or (a constant r past the staged rows)
    // read at its use
    __device__ float get(int s, int r, int j) const {
        return r < kRows ? at(s, r, j) : *src(s * kStage + j, r);
    }

    // stage s's copies, one commit group a stage (empty past the last)
    __device__ void fill(int s) {
        if (s < n_stages) {
            const int m = min(kStage, n_iters - s * kStage);
            float* dst = col + (s % kDepth) * kRows * kStage * kThreads;
            for (int r = 0; r < kRows; ++r)
                for (int j = 0; j < m; ++j)
                    cp_async4(dst + (r * kStage + j) * kThreads, src(s * kStage + j, r));
        }
        cp_async_commit();
    }
    __device__ void start() {
        for (int s = 0; s < kDepth; ++s) fill(s);
    }
    // the oldest stage in flight has landed
    __device__ void wait() const { cp_async_wait<kDepth - 1>(); }
    // before the thread leaves: every copy into its column has landed
    __device__ void drain() const { cp_async_wait<0>(); }
};

using BatchRing = DrawRing<kBatchStaged, kBatchThreads, kBatchDepth>;
using GtRing = DrawRing<kGtStaged, kGtThreads, kGtDepth>;
// within the dynamic shared memory a launch gets without an opt-in, and so
// 4 blocks an SM
static_assert(BatchRing::kBytes <= 48 * 1024 && GtRing::kBytes <= 48 * 1024, "a ring past 48 KB");

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

// a read-only load where ok, else the default: one predicated instruction, no
// branch, so loads of a window issue back to back and stay in flight together
__device__ __forceinline__ float ldg_if(bool ok, const float* ptr, float otherwise) {
    float v = otherwise;
    asm("{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n@p ld.global.nc.f32 %0, [%1];\n}\n"
        : "+f"(v)
        : "l"(ptr), "r"((int)ok));
    return v;
}
__device__ __forceinline__ uint32_t ldg_if(bool ok, const uint8_t* ptr) {
    uint32_t v = 0;
    asm("{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n@p ld.global.nc.u8 %0, [%1];\n}\n"
        : "+r"(v)
        : "l"(ptr), "r"((int)ok));
    return v;
}

// VolumeTask._bitgrid_cell: truncation toward zero, then the clip
__device__ __forceinline__ int bitgrid_cell(const float pos[3]) {
    int c[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) c[k] = min(max((int)(pos[k] * 128.0f + 0.5f), 0), kBitRes - 1);
    return (c[0] * kBitRes + c[1]) * kBitRes + c[2];
}

// VolumeTask._voxel of floor(fidx): the flat index clamped into the grid,
// and whether the voxel lies inside it (VolumeTask._take reads 0 outside)
__device__ __forceinline__ int voxel(const Params& p, const float fidx[3], bool& inb) {
    int i[3];
    inb = true;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        i[k] = (int)floorf(fidx[k]);
        inb = inb && i[k] >= 0 && i[k] < p.res[k];
        i[k] = min(max(i[k], 0), p.res[k] - 1);
    }
    return (i[0] * p.res[1] + i[1]) * p.res[2] + i[2];
}

// VolumeTask._nearest_index: the voxel under a position
__device__ __forceinline__ int voxel_nearest(const Params& p, const float pos[3], bool& inb) {
    float f[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) f[k] = (pos[k] - p.amin[k]) * p.inv_extent[k] * (float)p.res[k];
    return voxel(p, f, inb);
}

// VolumeTask._jittered_index: floor(index - 0.5 + jitter)
__device__ __forceinline__ int voxel_jittered(const Params& p, const float pos[3],
                                              const float jitter[3], bool& inb) {
    float f[3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
        f[k] = (pos[k] - p.amin[k]) * p.inv_extent[k] * (float)p.res[k] - 0.5f + jitter[k];
    return voxel(p, f, inb);
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

// A window: the positions of its kWindow slots from pos along dir (the
// first `avail` of them; the others keep the last), each slot's move pos +
// dir * dt in the plain version's order, whether each lies inside the box,
// and the bitgrid's byte under each slot inside it. The bytes are read by
// predicated loads, all in flight together.
template <bool kDtFirst>
__device__ __forceinline__ void window(const float pos[3], const float dir[3],
                                       const float dt[kWindow], int avail, const Params& p,
                                       const uint8_t* __restrict__ bits, float w[kWindow][3],
                                       bool in[kWindow], uint32_t byte[kWindow]) {
    float c[3] = {pos[0], pos[1], pos[2]};
#pragma unroll
    for (int j = 0; j < kWindow; ++j) {
        const bool on = j < avail;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            const float moved = c[k] + (kDtFirst ? dt[j] * dir[k] : dir[k] * dt[j]);
            c[k] = on ? moved : c[k];
            w[j][k] = c[k];
        }
        in[j] = on && inside(c, p);
        byte[j] = ldg_if(in[j], bits + bitgrid_cell(c));
    }
}

// The state of one path of a training batch
struct BatchPath {
    float pos[3], dir[3];
    float rec_pos[kVertices][3], rec_den[kVertices], rec_rgb[kVertices][3];
    int n_rec, pend_from;
    bool done;
};

// A path's iterations of stage s, a window at a time (one thread).
__device__ __forceinline__ void batch_stage(BatchPath& q, const BatchRing& ring, int s,
                                            const float* __restrict__ grid,
                                            const uint8_t* __restrict__ bits, const Params& p) {
    const int m = min(kStage, ring.n_iters - s * kStage);
    for (int start = 0; start < m && !q.done;) {
        // the window: slots start + j of the stage (clamped into it for the
        // reads of the slots past its end, which are not walked)
        int slot[kWindow];
        float dt[kWindow];
#pragma unroll
        for (int j = 0; j < kWindow; ++j) {
            slot[j] = min(start + j, kStage - 1);
            dt[j] = -logf(1.0f - ring.at(s, kZeta1, slot[j])) * p.scale;
        }
        float w[kWindow][3];
        bool in[kWindow];
        uint32_t byte[kWindow];
        window<false>(q.pos, q.dir, dt, m - start, p, bits, w, in, byte);
        // the grid's values at the occupied slots, a second round trip (read
        // with the bytes at every slot in the box, the jittered voxels cost
        // more requests than the trip saves)
        bool occ[kWindow];
        float den[kWindow], zeta2[kWindow];
#pragma unroll
        for (int j = 0; j < kWindow; ++j) {
            const float jitter[3] = {ring.at(s, kJitter, slot[j]), ring.at(s, kJitter + 1, slot[j]),
                                     ring.at(s, kJitter + 2, slot[j])};
            bool inb;
            const int v = voxel_jittered(p, w[j], jitter, inb);
            occ[j] = byte[j] != 0;
            den[j] = ldg_if(occ[j] && inb, grid + v, 0.0f);
            zeta2[j] = ring.at(s, kZeta2, slot[j]);
        }
        // the walk, up to the first slot that turns the path or ends its
        // attempt; that slot's rare work (a new direction, the envmap, a
        // respawn) follows the loop, so the unrolled body stays small
        int next = min(kWindow, m - start);
        bool cut = false, scatter = false, absorb = false;
#pragma unroll
        for (int j = 0; j < kWindow; ++j) {
            if (j >= next) continue;
#pragma unroll
            for (int k = 0; k < 3; ++k) q.pos[k] = w[j][k];
            if (!in[j]) {  // escaped
                cut = true;
                next = j + 1;
            } else if (occ[j]) {  // an event
                const float density = den[j];
#pragma unroll
                for (int v = 0; v < kVertices; ++v) {
                    if (v == q.n_rec) {
                        q.rec_den[v] = density;
#pragma unroll
                        for (int c = 0; c < 3; ++c) q.rec_pos[v][c] = q.pos[c];
                    }
                }
                q.n_rec = min(q.n_rec + 1, kVertices);
                const float extinction = density * p.inv_majorant;
                const float scatter_prob = extinction * p.albedo;
                if (zeta2[j] < extinction) {  // a real collision: scattered or absorbed
                    scatter = zeta2[j] < scatter_prob;
                    absorb = !scatter;
                    cut = true;
                    next = j + 1;
                }
            }
        }
        const int j = start + next - 1;  // the last slot walked
        start += next;
        if (!cut) continue;
        if (scatter) {
            const float nd[3] = {ring.get(s, kScatter, j), ring.get(s, kScatter + 1, j),
                                 ring.get(s, kScatter + 2, j)};
            const float nn = norm3(nd[0], nd[1], nd[2]);
            float nw[3];
#pragma unroll
            for (int k = 0; k < 3; ++k) nw[k] = q.dir[k] * p.scattering + nd[k] / nn;
            const float wn = norm3(nw[0], nw[1], nw[2]);
#pragma unroll
            for (int k = 0; k < 3; ++k) q.dir[k] = nw[k] / wn;
            continue;
        }
        // the attempt ends: escaped (throughput 1) or absorbed (0)
        float rad[3];
        envmap(q.dir, p, rad);
        const float thr = absorb ? 0.0f : 1.0f;
#pragma unroll
        for (int v = 0; v < kVertices; ++v) {
            if (v >= q.pend_from && v < q.n_rec) {
#pragma unroll
                for (int c = 0; c < 3; ++c) q.rec_rgb[v][c] = rad[c] * thr;
            }
        }
        q.pend_from = q.n_rec;
        if (q.n_rec >= kVertices) {
            q.done = true;
        } else {
            const float nrm[3] = {ring.get(s, kRespawnNormal, j), ring.get(s, kRespawnNormal + 1, j),
                                  ring.get(s, kRespawnNormal + 2, j)};
            const float uni[3] = {ring.get(s, kRespawnUniform, j),
                                  ring.get(s, kRespawnUniform + 1, j),
                                  ring.get(s, kRespawnUniform + 2, j)};
            spawn(nrm, uni, p, q.pos, q.dir);
        }
    }
}

__global__ void __launch_bounds__(kBatchThreads)
volume_generate_batch_kernel(const float* __restrict__ first, const float* __restrict__ draws,
                             const float* __restrict__ grid, const uint8_t* __restrict__ bits,
                             const Params p, int n, int n_iters, float* __restrict__ pts,
                             float* __restrict__ tgt, bool* __restrict__ valid) {
    extern __shared__ float smem[];
    const int i = blockIdx.x * kBatchThreads + threadIdx.x;
    if (i >= n) return;
    BatchRing ring(smem, draws, kBatchDraws, n, n_iters, i);
    ring.start();
    BatchPath q;
    {
        const float nrm[3] = {first[i], first[n + i], first[2 * n + i]};
        const float uni[3] = {first[3 * n + i], first[4 * n + i], first[5 * n + i]};
        spawn(nrm, uni, p, q.pos, q.dir);
    }
#pragma unroll
    for (int v = 0; v < kVertices; ++v) {
        q.rec_den[v] = 0.0f;
#pragma unroll
        for (int c = 0; c < 3; ++c) q.rec_pos[v][c] = q.rec_rgb[v][c] = 0.0f;
    }
    q.n_rec = q.pend_from = 0;
    q.done = false;
    for (int s = 0; s < ring.n_stages && !q.done; ++s) {
        ring.wait();
        batch_stage(q, ring, s, grid, bits, p);
        if (!q.done) ring.fill(s + kBatchDepth);
    }
    ring.drain();
    // an attempt still in flight at the cap ends with throughput 1
    float rad[3];
    envmap(q.dir, p, rad);
#pragma unroll
    for (int v = 0; v < kVertices; ++v) {
        if (v >= q.pend_from && v < q.n_rec) {
#pragma unroll
            for (int c = 0; c < 3; ++c) q.rec_rgb[v][c] = rad[c] * 1.0f;
        }
    }
#pragma unroll
    for (int v = 0; v < kVertices; ++v) {
        const size_t row = (size_t)i * kVertices + v;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            pts[row * 3 + c] = q.rec_pos[v][c];
            tgt[row * 4 + c] = q.rec_rgb[v][c];
        }
        tgt[row * 4 + 3] = q.rec_den[v];
        valid[row] = v < q.n_rec;
    }
}

// The state of one ray of the ground-truth trace
struct GtRay {
    float pos[3], dir[3];
    bool alive, absorbed, scattered;
};

// A ray's iterations of stage s, a window at a time (one thread).
__device__ __forceinline__ void gt_stage(GtRay& q, const GtRing& ring, int s,
                                         const float* __restrict__ grid,
                                         const uint8_t* __restrict__ bits, const Params& p) {
    const int m = min(kStage, ring.n_iters - s * kStage);
    for (int start = 0; start < m && q.alive;) {
        int slot[kWindow];
        float dt[kWindow];
#pragma unroll
        for (int j = 0; j < kWindow; ++j) {
            slot[j] = min(start + j, kStage - 1);
            dt[j] = -logf(ring.at(s, kGtU, slot[j])) * p.scale;
        }
        float w[kWindow][3];
        bool in[kWindow];
        uint32_t byte[kWindow];
        window<true>(q.pos, q.dir, dt, m - start, p, bits, w, in, byte);
        // the grid's values at the slots inside the box, read with the
        // bytes: one round trip (the nearest voxel lies under the cell)
        bool occ[kWindow];
        float extinction[kWindow], z2[kWindow];
#pragma unroll
        for (int j = 0; j < kWindow; ++j) {
            bool inb;
            const int v = voxel_nearest(p, w[j], inb);
            occ[j] = byte[j] != 0;
            extinction[j] = ldg_if(in[j] && inb, grid + v, 0.0f) * p.inv_majorant;
            z2[j] = ring.at(s, kGtZeta2, slot[j]);
        }
        // the walk, up to the first slot that turns the ray or ends it; a
        // turn's new direction follows the loop
        int next = min(kWindow, m - start);
        bool scatter = false;
#pragma unroll
        for (int j = 0; j < kWindow; ++j) {
            if (j >= next) continue;
#pragma unroll
            for (int k = 0; k < 3; ++k) q.pos[k] = w[j][k];
            if (!in[j]) {  // escaped
                q.alive = false;
                next = j + 1;
            } else if (occ[j]) {  // an event
                if (z2[j] < extinction[j] * p.albedo) {
                    scatter = true;
                    next = j + 1;
                } else if (z2[j] < extinction[j]) {
                    q.absorbed = true;
                    q.alive = false;
                    next = j + 1;
                }
            }
        }
        const int j = start + next - 1;  // the last slot walked
        start += next;
        if (!scatter) continue;
        float nd[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) nd[k] = q.dir[k] * p.scattering + ring.get(s, kGtNormal + k, j);
        const float nn = fmaxf(norm3(nd[0], nd[1], nd[2]), 1e-9f);
#pragma unroll
        for (int k = 0; k < 3; ++k) q.dir[k] = nd[k] / nn;
        q.scattered = true;
    }
}

__global__ void __launch_bounds__(kGtThreads)
volume_trace_gt_kernel(const float* __restrict__ o, const float* __restrict__ d,
                       const float* __restrict__ draws, const float* __restrict__ grid,
                       const uint8_t* __restrict__ bits, const Params p, int R, int n_iters,
                       float* __restrict__ rgb, float* __restrict__ alpha) {
    extern __shared__ float smem[];
    const int i = blockIdx.x * kGtThreads + threadIdx.x;
    if (i >= R) return;
    GtRing ring(smem, draws, kGtDraws, R, n_iters, i);
    GtRay q;
    const float org[3] = {o[3 * i], o[3 * i + 1], o[3 * i + 2]};
#pragma unroll
    for (int k = 0; k < 3; ++k) q.dir[k] = d[3 * i + k];
    float tmin, tmax;
    intersect_aabb(org, q.dir, p, tmin, tmax);
    q.alive = tmax > tmin;
    q.absorbed = q.scattered = false;
#pragma unroll
    for (int k = 0; k < 3; ++k) q.pos[k] = org[k] + tmin * q.dir[k];
    if (q.alive) ring.start();
    for (int s = 0; s < ring.n_stages && q.alive; ++s) {
        ring.wait();
        gt_stage(q, ring, s, grid, bits, p);
        if (q.alive) ring.fill(s + kGtDepth);
    }
    ring.drain();
    float env[3];
    envmap(q.dir, p, env);
#pragma unroll
    for (int c = 0; c < 3; ++c) rgb[3 * i + c] = q.absorbed ? 0.0f : env[c];
    alpha[i] = (q.absorbed || q.scattered) ? 1.0f : 0.0f;
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
    volume_generate_batch_kernel<<<blocks, kBatchThreads, BatchRing::kBytes,
                                   static_cast<cudaStream_t>(stream)>>>(
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
    volume_trace_gt_kernel<<<blocks, kGtThreads, GtRing::kBytes,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(o), static_cast<const float*>(d),
        static_cast<const float*>(draws), static_cast<const float*>(grid),
        static_cast<const uint8_t*>(bits), p, R, n_iters, static_cast<float*>(rgb),
        static_cast<float*>(alpha));
    return (int)cudaGetLastError();
}
