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
// sum_{k < reps} x[(idx[i, j] + k) mod T, j] on (T, L).
// Replaces the Pallas kernel in scripts/bench_dyngather.py::run_one
// (jnp.take_along_axis inside a fori_loop, everything in VMEM).
// Plain version: instant_ngp_torch/ops/gather.py::gather_cols_sum_plain.
//
// What bounds it on an H100: each output element reads reps elements of
// its own column at random rows, 4 (f32) or 2 (bf16) bytes out of a
// 32-byte sector each. The (T, 128) table is at most 16 MB and sits in
// L2, so the L2's sector rate bounds it, not device memory.
//
// Simple design: one thread per output element, consecutive threads on
// consecutive columns. The sum runs in the element type, in k order from
// zero, as the Pallas kernel carries it: a bf16 sum is rounded to bf16
// after every add.

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

template <typename T>
__global__ void gather_cols_sum_kernel(const T* __restrict__ x, const int* __restrict__ idx,
                                       long long n_rows, int n_cols, int reps,
                                       T* __restrict__ out) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n_rows * n_cols) return;
    const long long j = i % n_cols;
    const long long base = idx[i];
    T acc = T(0.0f);
    for (int k = 0; k < reps; ++k) {
        long long r = (base + k) % n_rows;  // floor modulo, as jnp's % on ints
        if (r < 0) r += n_rows;
        acc = add<T>(acc, x[r * n_cols + j]);
    }
    out[i] = acc;
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

// dtype: 0 float32, 1 bfloat16
extern "C" int ngp_gather_cols_sum(const void* x, const void* idx, long long n_rows, int n_cols,
                                   int reps, int dtype, void* out, void* stream) {
    const int threads = 256;
    const unsigned blocks = (unsigned)((n_rows * n_cols + threads - 1) / threads);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int* ip = static_cast<const int*>(idx);
    switch (dtype) {
        case 0:
            gather_cols_sum_kernel<float><<<blocks, threads, 0, st>>>(
                static_cast<const float*>(x), ip, n_rows, n_cols, reps, static_cast<float*>(out));
            break;
        case 1:
            gather_cols_sum_kernel<__nv_bfloat16><<<blocks, threads, 0, st>>>(
                static_cast<const __nv_bfloat16*>(x), ip, n_rows, n_cols, reps,
                static_cast<__nv_bfloat16*>(out));
            break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
