// Kernels I and J: the two gathers of the TPU gather microbenchmarks.
//
// Kernel I, row gather: out[i, :] = table[idx[i], :].
// Replaces scripts/bench_gather_tpu.py::make_pallas_take (a Pallas kernel
// that holds the (T, F) table in VMEM and takes N = 2^20 rows of it). On
// the port's main path it fetches the image primitive's training targets:
// the 4 texels of each bilinear read, 4 x 2^18 rows of the (H*W, 4) f32
// texture per step. Plain version: instant_ngp_torch/ops/gather.py::
// take_rows_plain.
//
// What bounds it on an H100: bytes. Each row is read once from a random
// place and written once in order; at F = 4 f32 a row is one 16-byte
// sector, so a random read costs a whole 32-byte sector of device memory
// (or of L2, where the table fits its 50 MB: 2^19 x 16 B = 8 MB does, the
// 1 GiB texture does not).
//
// Simple design: the kernel copies bytes and does not care about the
// element type. One thread per V-byte piece of a row (V = 16, 8 or 4, the
// widest that divides the row; the wrapper checks alignment), consecutive
// threads on consecutive pieces of a row and then on consecutive rows, so
// the writes are coalesced and each row's read is one vector load per
// thread. An index outside [0, T) writes a zero row instead of reading out
// of bounds.
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

template <typename V>
__global__ void take_rows_kernel(const V* __restrict__ table, const int* __restrict__ idx,
                                 long long n, long long n_rows, int pieces, V* __restrict__ out) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n * pieces) return;
    const long long row = i / pieces;
    const int piece = (int)(i - row * pieces);
    const long long src = idx[row];
    V v;
    if (src >= 0 && src < n_rows) {
        v = __ldg(table + src * pieces + piece);
    } else {
        v = V{};
    }
    out[i] = v;
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

}  // namespace

extern "C" int ngp_take_rows(const void* table, const void* idx, long long n, long long n_rows,
                             int row_bytes, void* out, void* stream) {
    const int threads = 256;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int* ip = static_cast<const int*>(idx);
    if (row_bytes % 16 == 0) {
        const int pieces = row_bytes / 16;
        const unsigned blocks = (unsigned)((n * pieces + threads - 1) / threads);
        take_rows_kernel<uint4><<<blocks, threads, 0, st>>>(
            static_cast<const uint4*>(table), ip, n, n_rows, pieces, static_cast<uint4*>(out));
    } else if (row_bytes % 8 == 0) {
        const int pieces = row_bytes / 8;
        const unsigned blocks = (unsigned)((n * pieces + threads - 1) / threads);
        take_rows_kernel<uint2><<<blocks, threads, 0, st>>>(
            static_cast<const uint2*>(table), ip, n, n_rows, pieces, static_cast<uint2*>(out));
    } else if (row_bytes % 4 == 0) {
        const int pieces = row_bytes / 4;
        const unsigned blocks = (unsigned)((n * pieces + threads - 1) / threads);
        take_rows_kernel<unsigned><<<blocks, threads, 0, st>>>(
            static_cast<const unsigned*>(table), ip, n, n_rows, pieces, static_cast<unsigned*>(out));
    } else {
        return (int)cudaErrorInvalidValue;
    }
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
