// Kernels I and J: the two gathers of the TPU gather microbenchmarks, and
// the image step's bilinear texture read.
//
// Kernel I, row gather: out[i, :] = table[idx[i], :].
// Replaces scripts/bench_gather_tpu.py::make_pallas_take (a Pallas kernel
// that holds the (T, F) table in VMEM and takes N = 2^20 rows of it). On
// the port's paths it reads the image primitive's ground-truth tiles and
// runs the gather microbenchmarks. Plain version: instant_ngp_torch/ops/
// gather.py::take_rows_plain.
//
// What bounds it on an H100: bytes. Each row is read once from a random
// place and written once in order; at F = 4 f32 a row is one 16-byte
// sector, so a random read costs a whole 32-byte sector of device memory
// (or of L2, where the table fits its 50 MB: 2^19 x 16 B = 8 MB does, the
// 1 GiB texture does not). What the card reaches on random rows of a table
// that does not fit L2 is set by the rate at which device memory serves
// random accesses, not the bound that counts 16 bytes a row (PERF.md §6
// gives the times of instant_ngp_torch/bench/composite_gather.py beside it,
// and beside torch.index_select's).
//
// Design: the kernel copies bytes and does not care about the element type.
// A thread takes kItems V-byte pieces (V = 16, 8 or 4, the widest that
// divides the row; the wrapper checks alignment) a block width apart: it
// loads their kItems indices first, then issues their kItems row loads, all
// independent, so that several random reads are in flight per thread, not
// one dependent index->row pair. Consecutive threads take consecutive
// pieces, so index loads and stores are coalesced. Offsets are 64-bit (the
// 16384^2 RGBA f32 texture is 4 GiB). An index outside [0, T) writes a
// zero row instead of reading out of bounds. Two pieces a thread, plain
// stores: on an H100, 4 and 8 pieces a thread were no faster at the image
// step's texels, and streaming stores (__stcs) changed nothing (PERF.md §6).
//
// Kernel I, bilinear entry: out[i, :] = the bilinear read of the (H·W, 4)
// f32 texture at uv[i] (the reference's pixel addressing, testbed_image.cu:
// 196-211). Replaces the image step's read in instant_ngp_tpu/image_fit/
// task.py::bilinear_read (texture[yi, xi] at 4 corners, then weights), which
// as PyTorch ops and a row gather takes 50 device kernels: the corners'
// indices, one row gather of 4N rows and the interpolation. Plain version: instant_ngp_torch/
// ops/gather.py::bilinear_read_plain, equal to it bit for bit.
//
// What bounds it: bytes; per read 8 B of uv, 4 rows of 16 B and 16 B out:
// 23.1 MB at the image step's 2^18 reads, 0.0069 ms at 3.35 TB/s. The rows
// lie at random places of a 1 GiB texture, in two pairs (00 and 10 side by
// side, 01 and 11 a texture row further): a pair is one 32-byte sector when
// x0 is even and two when it is odd, so the sectors the card must fetch are
// ~1.5x the rows' bytes, and device memory's rate of random accesses bounds
// it as it bounds the row gather: 0.024 ms on an H100 at the image step
// (PERF.md §6), 2^19 random pairs of rows.
//
// Design: one thread per read. It loads uv as a float2 and computes pos
// exactly as the plain version does: fmaf(uv, res, -0.5f) (the jitted JAX
// read's FMA, which common.fma_exact emulates),
// clamped to [0, res − 1.0001 rounded to f32] (the wrapper passes the upper
// bounds), floor, frac, x0 and y0 clamped to [0, W−2] and [0, H−2]. It
// issues the 4 corner loads as independent 16-byte loads, weighs them as
// the jitted JAX read does, fma(w11, v11, fma(w01, v01, fma(w00, v00,
// w10·v10))) with w00 = (1−fx)(1−fy), w10 = fx(1−fy), w01 = (1−fx)fy,
// w11 = fx·fy (XLA contracts the weighted sum into three FMAs; -fmad=false
// keeps every other product rounded), and writes one 16-byte row.
//
// Kernel J, column gather summed over reps: out[i, j] =
// sum_{k < reps} x[(idx[i, j] + k) mod T, j] on (T, L), where idx + k is
// int32 arithmetic (it wraps past 2^31 − 1, as the Pallas kernel's int32
// sum does) and mod is a floor modulo.
// Replaces the Pallas kernel in scripts/bench_dyngather.py::run_one
// (jnp.take_along_axis inside a fori_loop, everything in VMEM).
// Plain version: instant_ngp_torch/ops/gather.py::gather_cols_sum_plain;
// the route and tiling: ops/gather.py::cols_plan, sized by what
// ngp_gather_cols_limits reads (this file's block, the device's SMs and
// shared memory).
//
// What bounds it on an H100: an output reads reps rows of its own column.
// In the row-major (T, L) table they lie L elements apart, so each read
// costs its own 32-byte sector for 4 (f32) or 2 (bf16) bytes: 8 sectors,
// 256 B of L2 traffic an output at reps 8, which is what the L2's sector
// rate made the one-thread-an-output design pay (PERF.md §6). In a
// column-major copy the window is reps contiguous elements: 32 B in f32,
// one or two sectors (1.875 at random starts), 16 B in bf16 (one or two,
// 1.5). The bound counts x, idx and out once each, over device memory's
// rate. What bounds this design, per output at reps 8: on the shared route
// 4 B of idx and 4 B of out, plus the tile staged once per split (T 4,096
// f32: 8 splits, so 8 × 4 B = one 32-byte sector an output, from L2), and
// the window as 8 reads of shared memory at random banks; on the transpose
// route 4 B of x read and 4 B written by the transpose, 4 B of idx, 4 B of
// out, and the window from the L2-resident scratch: 1.875 sectors, 60 B
// (bf16 1.5, 48 B), so the L2's sector rate bounds it (PERF.md §6).
//
// Design. Both routes read each column from a padded copy whose entry p
// holds x[p mod T, j] for p < T + reps − 1, so the window of a start r0 in
// [0, T) is entries r0 .. r0 + reps − 1: the mod-T wrap costs nothing. One
// 32-bit remainder an output, r0 = idx mod T (floor); the int32 sum
// idx + k wraps at k = 2^31 − idx (idx > 0), where the row becomes
// rw = (−2^31) mod T (the wrapper's), one compare a k. The sum runs in the
// element type in k order from zero, as the plain version's: bit for bit
// in f32 and bf16.
//  - shared route, where a tile of all padded rows at one sector a row fits
//    a block's shared memory (T up to ~7,000): block (t, s) stages columns
//    [t·c, t·c + c) in shared memory, column-major, c = 8 f32 or 16 bf16,
//    so a row is one coalesced 32-byte sector (16-byte vector loads where
//    aligned); then it sums the outputs of its rows from there, consecutive
//    threads on consecutive columns (idx and out coalesced). A thread's first
//    kColsOuts indices are loaded before the tile, to arrive while it
//    stages. Rows split over as many blocks as one wave holds, but no more
//    than leave each thread an output (T 4,096 f32: 8 splits of 16 tiles,
//    128 KB a block; T 512: 4 splits), and every split stages its tile
//    again: 16 MB of L2 reads at T 4,096 against 134 MB of sectors.
//  - transpose route (larger T): 32x32 tiles through shared memory write
//    the padded copies to an (L, stride) scratch tensor (16 MB at T 32,768
//    f32: it stays in L2); then a thread sums kColsOuts outputs a block
//    width apart, all their windows' loads in flight, idx read and out
//    written evict-first so that the scratch keeps its place in L2. At
//    reps 8 (the microbenchmark's) a window is two or three 16-byte loads
//    (one or two in bf16) shifted into place in registers, not 8 loads. A
//    thread's column is one remainder by L, then a compare-and-wrap a step.
//    Both launches come from one wrapper call. At the microbenchmark's
//    T 8–4,096 the transpose route is the slower one on an H100 (two
//    launches where one does, and the window sectors; PERF.md §6), so the
//    shared route stays.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTakeThreads = 256;
constexpr int kItems = 2;  // pieces a thread takes, a block width apart

template <typename V>
__global__ void __launch_bounds__(kTakeThreads)
take_rows_kernel(const V* __restrict__ table, const int* __restrict__ idx, long long n_items,
                 long long n_rows, int pieces, V* __restrict__ out) {
    const long long first = (long long)blockIdx.x * (kTakeThreads * kItems) + threadIdx.x;
    long long src[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
        const long long i = first + j * kTakeThreads;
        src[j] = -1;
        if (i < n_items) {
            const long long row = pieces == 1 ? i : i / pieces;
            const long long s = __ldg(idx + row);
            if (s >= 0 && s < n_rows) src[j] = s * pieces + (i - row * pieces);
        }
    }
    V v[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) v[j] = src[j] >= 0 ? __ldg(table + src[j]) : V{};
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
        const long long i = first + j * kTakeThreads;
        if (i < n_items) out[i] = v[j];
    }
}

constexpr int kBilinearThreads = 256;

__global__ void __launch_bounds__(kBilinearThreads)
bilinear_read_kernel(const float4* __restrict__ texture, const float2* __restrict__ uv,
                     long long n, int w, int h, float hi_x, float hi_y,
                     float4* __restrict__ out) {
    const long long i = (long long)blockIdx.x * kBilinearThreads + threadIdx.x;
    if (i >= n) return;
    const float2 p = __ldg(uv + i);
    const float px = fminf(fmaxf(fmaf(p.x, (float)w, -0.5f), 0.0f), hi_x);
    const float py = fminf(fmaxf(fmaf(p.y, (float)h, -0.5f), 0.0f), hi_y);
    const float ix = floorf(px), iy = floorf(py);
    const float fx = px - ix, fy = py - iy;
    const int x0 = min(max((int)ix, 0), w - 2);
    const int y0 = min(max((int)iy, 0), h - 2);
    const long long t00 = (long long)y0 * w + x0;
    const float4 v00 = __ldg(texture + t00);
    const float4 v10 = __ldg(texture + t00 + 1);
    const float4 v01 = __ldg(texture + t00 + w);
    const float4 v11 = __ldg(texture + t00 + w + 1);
    const float gx = 1.0f - fx, gy = 1.0f - fy;
    const float w00 = gx * gy, w10 = fx * gy, w01 = gx * fy, w11 = fx * fy;
    float4 r;
    r.x = fmaf(w11, v11.x, fmaf(w01, v01.x, fmaf(w00, v00.x, w10 * v10.x)));
    r.y = fmaf(w11, v11.y, fmaf(w01, v01.y, fmaf(w00, v00.y, w10 * v10.y)));
    r.z = fmaf(w11, v11.z, fmaf(w01, v01.z, fmaf(w00, v00.z, w10 * v10.z)));
    r.w = fmaf(w11, v11.w, fmaf(w01, v01.w, fmaf(w00, v00.w, w10 * v10.w)));
    out[i] = r;
}

template <typename T>
__device__ __forceinline__ T add(T a, T b);

template <>
__device__ __forceinline__ float add<float>(float a, float b) { return a + b; }

template <>
__device__ __forceinline__ __nv_bfloat16 add<__nv_bfloat16>(__nv_bfloat16 a, __nv_bfloat16 b) {
    return __float2bfloat16_rn(__bfloat162float(a) + __bfloat162float(b));
}

// T's value from its bits; the evict-first store of a T
template <typename T>
__device__ __forceinline__ T from_bits(unsigned b);

template <>
__device__ __forceinline__ float from_bits<float>(unsigned b) { return __uint_as_float(b); }

template <>
__device__ __forceinline__ __nv_bfloat16 from_bits<__nv_bfloat16>(unsigned b) {
    return __ushort_as_bfloat16((unsigned short)b);
}

__device__ __forceinline__ void store_stream(float* p, float v) { __stcs(p, v); }

__device__ __forceinline__ void store_stream(__nv_bfloat16* p, __nv_bfloat16 v) {
    __stcs(reinterpret_cast<unsigned short*>(p), __bfloat16_as_ushort(v));
}

// element q of a 16-byte vector of T
template <typename T>
__device__ __forceinline__ T lane_of(const uint4& w, int q) {
    constexpr int per_word = 4 / sizeof(T);
    const int i = q / per_word;
    const unsigned word = i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w;
    return from_bits<T>(word >> (8 * sizeof(T) * (q % per_word)));
}

constexpr int kColsThreads = 1024;   // shared route, a block
constexpr int kColsOuts = 4;         // outputs a thread holds at once
constexpr int kScratchThreads = 256; // transpose route's sum, a block
constexpr int kTile = 32;            // transpose tile, kTile x kTile
constexpr int kTileRows = 8;         // transpose block: kTile x kTileRows threads
constexpr int kVecReps = 8;          // reps the transpose route loads as 16-byte chunks

// r0 = v mod T (a floor modulo), the one remainder an output
__device__ __forceinline__ int first_row(int v, int n_rows) {
    const int p = v % n_rows;
    return p < 0 ? p + n_rows : p;
}

// the k at which the int32 sum v + k wraps past 2^31 − 1 (never: 2^32 − 1)
__device__ __forceinline__ unsigned wrap_k(int v) {
    return v > 0 ? 0x80000000u - (unsigned)v : 0xffffffffu;
}

// One output: the sum of a window of a padded column copy (col[p] =
// x[p mod T, j] for p < T + reps − 1) from row v mod T, the int32 wrap of
// v + k sending it to row rw at k = wrap_k(v).
template <typename T>
__device__ __forceinline__ T window_sum(const T* col, int v, int n_rows, int reps, int rw) {
    int p = first_row(v, n_rows);
    const unsigned kw = wrap_k(v);
    T acc = T(0.0f);
#pragma unroll 8
    for (int k = 0; k < reps; ++k, ++p) {
        if ((unsigned)k == kw) p = rw;
        acc = add<T>(acc, col[p]);
    }
    return acc;
}

// The same for kVecReps entries from entry p, no int32 wrap, of a column
// copy aligned to 16 bytes: its 16-byte chunks (2 or 3 in f32, 1 or 2 in
// bf16) are loaded together, shifted so that element k is lane k (a funnel
// shift of half a word in bf16, then selects by 1 and 2 words), and summed
// in k order.
template <typename T>
__device__ __forceinline__ T window_sum_vec(const T* col, int p) {
    constexpr int V = 16 / sizeof(T), per_word = 4 / sizeof(T);
    constexpr int NC = (kVecReps + V - 2) / V + 1, NW = 4 * NC;
    const int e0 = p % V;
    const int nc = (e0 + kVecReps - 1) / V + 1;
    const uint4* chunk = reinterpret_cast<const uint4*>(col + (p - e0));
    unsigned w[NW];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
        const uint4 u = c < nc ? __ldg(chunk + c) : make_uint4(0u, 0u, 0u, 0u);
        w[4 * c] = u.x;
        w[4 * c + 1] = u.y;
        w[4 * c + 2] = u.z;
        w[4 * c + 3] = u.w;
    }
    int sw = e0;  // words to shift by
    if constexpr (per_word == 2) {
        const unsigned sh = 16u * (e0 & 1);
#pragma unroll
        for (int m = 0; m + 1 < NW; ++m) w[m] = __funnelshift_r(w[m], w[m + 1], sh);
        sw = e0 >> 1;
    }
#pragma unroll
    for (int m = 0; m + 1 < NW; ++m) w[m] = (sw & 1) ? w[m + 1] : w[m];
#pragma unroll
    for (int m = 0; m + 2 < NW; ++m) w[m] = (sw & 2) ? w[m + 2] : w[m];
    T acc = T(0.0f);
#pragma unroll
    for (int k = 0; k < kVecReps; ++k) {
        acc = add<T>(acc, from_bits<T>(w[k / per_word] >> (8 * sizeof(T) * (k % per_word))));
    }
    return acc;
}

// shared route: block (tile, split) of (n_cols / cols, splits); V elements a
// staging load (16 bytes' worth, or 1)
template <typename T, int V>
__global__ void __launch_bounds__(kColsThreads)
gather_cols_sum_shared_kernel(const T* __restrict__ x, const int* __restrict__ idx, int n_rows,
                              int n_cols, int reps, int rw, int stride, int c_log2, int rows,
                              T* __restrict__ out) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* tile = reinterpret_cast<T*>(smem_raw);
    const int c_mask = (1 << c_log2) - 1;
    const int j0 = blockIdx.x << c_log2;
    const int r0 = blockIdx.y * rows;
    const int n_out = (min(n_rows, r0 + rows) - r0) << c_log2;
    int v[kColsOuts];
    auto load_idx = [&](int base) {
#pragma unroll
        for (int u = 0; u < kColsOuts; ++u) {
            const int o = base + u * kColsThreads + threadIdx.x;
            const int j = j0 + (o & c_mask);
            v[u] = o < n_out && j < n_cols ? __ldcs(idx + (r0 + (o >> c_log2)) * n_cols + j) : 0;
        }
    };
    load_idx(0);
    // tile[jl * stride + p] = x[p mod T, j0 + jl], p < T + reps − 1
    const int padded = n_rows + max(reps, 1) - 1;
    const int row_log2 = c_log2 - (V == 1 ? 0 : V == 4 ? 2 : 3);  // loads a tile row: 2^row_log2
    const int row_mask = (1 << row_log2) - 1;
#pragma unroll 4
    for (int e = threadIdx.x; e < padded << row_log2; e += kColsThreads) {
        const int p = e >> row_log2, jl = (e & row_mask) * V;
        const int src = p < n_rows ? p : p % n_rows;
        if (j0 + jl >= n_cols) continue;
        if constexpr (V == 1) {
            tile[jl * stride + p] = x[src * n_cols + j0 + jl];
        } else {
            const uint4 w = *reinterpret_cast<const uint4*>(x + src * n_cols + j0 + jl);
#pragma unroll
            for (int q = 0; q < V; ++q) tile[(jl + q) * stride + p] = lane_of<T>(w, q);
        }
    }
    __syncthreads();
    for (int base = 0; base < n_out; base += kColsOuts * kColsThreads) {
        if (base > 0) load_idx(base);
#pragma unroll
        for (int u = 0; u < kColsOuts; ++u) {
            const int o = base + u * kColsThreads + threadIdx.x;
            const int jl = o & c_mask;
            if (o < n_out && j0 + jl < n_cols) {
                out[(r0 + (o >> c_log2)) * n_cols + j0 + jl] =
                    window_sum<T>(tile + jl * stride, v[u], n_rows, reps, rw);
            }
        }
    }
}

// transpose route, first launch: xt[j * stride + p] = x[p mod T, j] for
// p < T + reps − 1, block (p tile, j tile); S: the elements' bits
template <typename S>
__global__ void __launch_bounds__(kTile * kTileRows)
gather_cols_transpose_kernel(const S* __restrict__ x, int n_rows, int n_cols, int padded,
                             int stride, S* __restrict__ xt) {
    __shared__ S tile[kTile][kTile + 1];
    const int p0 = blockIdx.x * kTile, j0 = blockIdx.y * kTile;
#pragma unroll
    for (int r = threadIdx.y; r < kTile; r += kTileRows) {
        const int p = p0 + r, j = j0 + threadIdx.x;
        if (p < padded && j < n_cols) {
            const int src = p < n_rows ? p : p % n_rows;
            tile[r][threadIdx.x] = __ldg(x + src * n_cols + j);
        }
    }
    __syncthreads();
#pragma unroll
    for (int r = threadIdx.y; r < kTile; r += kTileRows) {
        const int j = j0 + r, p = p0 + threadIdx.x;
        if (p < padded && j < n_cols) xt[j * stride + p] = tile[threadIdx.x][r];
    }
}

// transpose route, second launch: kColsOuts outputs a thread, a block width
// apart, their windows read from the scratch copies (as 16-byte chunks
// where kVec: reps is kVecReps)
template <typename T, bool kVec>
__global__ void __launch_bounds__(kScratchThreads)
gather_cols_sum_scratch_kernel(const T* __restrict__ xt, const int* __restrict__ idx, int n_rows,
                               int n_cols, int reps, int rw, int stride, T* __restrict__ out) {
    const int n_out = n_rows * n_cols;
    const int first = blockIdx.x * (kScratchThreads * kColsOuts) + threadIdx.x;
    int v[kColsOuts];
#pragma unroll
    for (int u = 0; u < kColsOuts; ++u) {
        const int o = first + u * kScratchThreads;
        v[u] = o < n_out ? __ldcs(idx + o) : 0;
    }
    const int step = kScratchThreads % n_cols;
    int j = first % n_cols;
#pragma unroll
    for (int u = 0; u < kColsOuts; ++u) {
        const int o = first + u * kScratchThreads;
        if (o < n_out) {
            const T* col = xt + j * stride;
            store_stream(out + o, kVec && wrap_k(v[u]) >= kVecReps
                                      ? window_sum_vec<T>(col, first_row(v[u], n_rows))
                                      : window_sum<T>(col, v[u], n_rows, reps, rw));
        }
        j += step;
        if (j >= n_cols) j -= n_cols;
    }
}

template <typename V>
void launch_take_rows(const void* table, const int* idx, long long n, long long n_rows,
                      int row_bytes, void* out, cudaStream_t st) {
    const int pieces = row_bytes / (int)sizeof(V);
    const long long items = n * pieces;
    const unsigned blocks =
        (unsigned)((items + kTakeThreads * kItems - 1) / (kTakeThreads * kItems));
    take_rows_kernel<V><<<blocks, kTakeThreads, 0, st>>>(
        static_cast<const V*>(table), idx, items, n_rows, pieces, static_cast<V*>(out));
}

}  // namespace

extern "C" int ngp_take_rows(const void* table, const void* idx, long long n, long long n_rows,
                             int row_bytes, void* out, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int* ip = static_cast<const int*>(idx);
    if (row_bytes % 16 == 0) {
        launch_take_rows<uint4>(table, ip, n, n_rows, row_bytes, out, st);
    } else if (row_bytes % 8 == 0) {
        launch_take_rows<uint2>(table, ip, n, n_rows, row_bytes, out, st);
    } else if (row_bytes % 4 == 0) {
        launch_take_rows<unsigned>(table, ip, n, n_rows, row_bytes, out, st);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

// texture (w·h, 4) f32, uv (n, 2) f32; hi_x, hi_y: the upper clamps of pos
extern "C" int ngp_bilinear_read(const void* texture, const void* uv, long long n, int w, int h,
                                 float hi_x, float hi_y, void* out, void* stream) {
    if (w < 2 || h < 2) return (int)cudaErrorInvalidValue;
    const unsigned blocks = (unsigned)((n + kBilinearThreads - 1) / kBilinearThreads);
    bilinear_read_kernel<<<blocks, kBilinearThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(texture), static_cast<const float2*>(uv), n, w, h, hi_x, hi_y,
        static_cast<float4*>(out));
    return (int)cudaGetLastError();
}

namespace {

template <typename T, int V>
cudaError_t launch_cols_shared(const void* x, const int* idx, int n_rows, int n_cols, int reps,
                               int rw, int stride, int cols, int rows, int splits, void* out,
                               cudaStream_t st) {
    // above 48 KB of dynamic shared memory only after opting in: to the most
    // a launch has asked for
    static int opted_in = 0;
    auto kernel = gather_cols_sum_shared_kernel<T, V>;
    const int smem = cols * stride * (int)sizeof(T);
    if (smem > opted_in) {
        const cudaError_t err =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return err;
        opted_in = smem;
    }
    int c_log2 = 0;
    while ((1 << c_log2) < cols) ++c_log2;
    const dim3 grid((unsigned)((n_cols + cols - 1) / cols), (unsigned)splits);
    kernel<<<grid, kColsThreads, smem, st>>>(static_cast<const T*>(x), idx, n_rows, n_cols, reps,
                                             rw, stride, c_log2, rows, static_cast<T*>(out));
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch_cols_sum(const void* src, const int* idx, int n_rows, int n_cols, int reps,
                            int rw, int stride, int cols, int rows, int splits, int vec, void* out,
                            cudaStream_t st) {
    if (cols == 0) {
        const long long n_out = (long long)n_rows * n_cols;
        const unsigned blocks = (unsigned)((n_out + kScratchThreads * kColsOuts - 1) /
                                           (kScratchThreads * kColsOuts));
        auto kernel = reps == kVecReps ? gather_cols_sum_scratch_kernel<T, true>
                                       : gather_cols_sum_scratch_kernel<T, false>;
        kernel<<<blocks, kScratchThreads, 0, st>>>(static_cast<const T*>(src), idx, n_rows,
                                                   n_cols, reps, rw, stride, static_cast<T*>(out));
        return cudaGetLastError();
    }
    if (vec == 16 / (int)sizeof(T)) {
        return launch_cols_shared<T, (int)(16 / sizeof(T))>(src, idx, n_rows, n_cols, reps, rw,
                                                            stride, cols, rows, splits, out, st);
    }
    return launch_cols_shared<T, 1>(src, idx, n_rows, n_cols, reps, rw, stride, cols, rows,
                                    splits, out, st);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; xt: (n_cols, stride) scratch
extern "C" int ngp_gather_cols_transpose(const void* x, int n_rows, int n_cols, int reps,
                                         int stride, int dtype, void* xt, void* stream) {
    const int padded = n_rows + (reps > 1 ? reps : 1) - 1;
    const dim3 grid((unsigned)((padded + kTile - 1) / kTile),
                    (unsigned)((n_cols + kTile - 1) / kTile));
    const dim3 block(kTile, kTileRows);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0:
            gather_cols_transpose_kernel<unsigned><<<grid, block, 0, st>>>(
                static_cast<const unsigned*>(x), n_rows, n_cols, padded, stride,
                static_cast<unsigned*>(xt));
            break;
        case 1:
            gather_cols_transpose_kernel<unsigned short><<<grid, block, 0, st>>>(
                static_cast<const unsigned short*>(x), n_rows, n_cols, padded, stride,
                static_cast<unsigned short*>(xt));
            break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

// What ops/gather.py::cols_plan sizes kernel J's shared route by: out =
// {kColsThreads, the device's SMs, the shared memory a block may opt in to,
// an SM's, the runtime's reserve a block, threads an SM}
extern "C" int ngp_gather_cols_limits(int device, int* out) {
    out[0] = kColsThreads;
    const cudaDeviceAttr attrs[5] = {
        cudaDevAttrMultiProcessorCount, cudaDevAttrMaxSharedMemoryPerBlockOptin,
        cudaDevAttrMaxSharedMemoryPerMultiprocessor, cudaDevAttrReservedSharedMemoryPerBlock,
        cudaDevAttrMaxThreadsPerMultiProcessor};
    for (int a = 0; a < 5; ++a) {
        const cudaError_t err = cudaDeviceGetAttribute(out + 1 + a, attrs[a], device);
        if (err != cudaSuccess) return (int)err;
    }
    return (int)cudaSuccess;
}

// src: x (shared route) or the transpose's xt (cols == 0); rw: the row past
// the int32 wrap, (−2^31) mod T; vec: elements a staging load takes
extern "C" int ngp_gather_cols_sum(const void* src, const void* idx, int n_rows, int n_cols,
                                   int reps, int rw, int dtype, int stride, int cols, int rows,
                                   int splits, int vec, void* out, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int* ip = static_cast<const int*>(idx);
    switch (dtype) {
        case 0:
            return (int)launch_cols_sum<float>(src, ip, n_rows, n_cols, reps, rw, stride, cols,
                                               rows, splits, vec, out, st);
        case 1:
            return (int)launch_cols_sum<__nv_bfloat16>(src, ip, n_rows, n_cols, reps, rw, stride,
                                                       cols, rows, splits, vec, out, st);
        default: return (int)cudaErrorInvalidValue;
    }
}
