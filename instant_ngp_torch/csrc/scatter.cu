// Kernel H: row scatter-add, out = zeros(size, F).at[idx].add(vals).
//
// Replaces the Pallas scatter probes scripts/bench_pallas_scatter.py::
// scatter_kernel (2^20 rows into a (2^19, 2) table) and scripts/
// bench_pallas_scatter1d.py::scatter_kernel (the same into a flat (S·F,)
// accumulator: F = 1 here), and instant_ngp_tpu/ops/scatter.py::
// scatter_add_xla. On the training path it makes the error-map deposit.
// Plain version: instant_ngp_torch/ops/scatter.py::scatter_add_rows_plain.
//
// What bounds it on an H100: one f32 atomic per element at a random row,
// resolved in L2 (a (2^19, 2) table is 4 MB and stays there): atomic
// throughput, with contention only where indices repeat.
//
// Simple design: one thread per (row, feature) element; rows whose index
// lies outside [0, size) are dropped, as JAX drops out-of-bounds updates.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void scatter_add_kernel(const long long* __restrict__ idx, const float* __restrict__ vals,
                                   long long m, int F, long long size, float* __restrict__ out) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= m * F) return;
    const long long row = i / F;
    const long long dst = idx[row];
    if (dst < 0 || dst >= size) return;
    atomicAdd(out + dst * F + (i - row * F), vals[i]);
}

}  // namespace

extern "C" int ngp_scatter_add_rows(const void* idx, const void* vals, long long m, int F,
                                    long long size, void* out, void* stream) {
    const int threads = 256;
    const unsigned blocks = (unsigned)((m * F + threads - 1) / threads);
    scatter_add_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(idx), static_cast<const float*>(vals), m, F, size,
        static_cast<float*>(out));
    return (int)cudaGetLastError();
}
