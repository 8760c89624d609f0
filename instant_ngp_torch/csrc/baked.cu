// Kernel N: the baked sample.
//
// Replaces instant_ngp_tpu/nerf/baked.py::query (the per-sample lookup of
// the baked sparse-cell cache). Plain version:
// instant_ngp_torch/nerf/baked.py::query_plain, which this kernel follows
// operation for operation, so the two agree to the bit.
//
// Per sample: ngp_baked::sample (csrc/baked.cuh): the cascade (mip) from
// the position, that mip's bake resolution n and flat index offset, the
// cell and its fraction, one int32 index load, one 64-byte bf16 row (8
// corners x [r, g, b, sigma]), the trilinear sum over the corners in the
// bake's order c = 4*dx + 2*dy + dz, and zero outside occupancy or outside
// the mip's box.
//
// What bounds it on an H100: bytes. A sample reads its position (12 B),
// one index entry (4 B) and one table row (64 B) and writes 16 B: ~96 B,
// against ~30 flops. The index and table are random-access reads (the
// index is 256^3 + 2*128^3 int32 on fox, 84 MB; the table up to 2^21
// rows, 134 MB), so the row read is what costs.
//
// Simple design: one thread a sample; the row as four 16-byte loads.
//
// The baked render no longer launches N: its rounds go through the baked
// round (csrc/baked_round.cu), which calls the same per-sample body. N
// stays the port of query, for positions a caller gives.

#include <cuda_runtime.h>
#include <stdint.h>

#include "baked.cuh"

namespace {

__global__ void baked_query_kernel(const float* __restrict__ pos, const int32_t* __restrict__ index,
                                   const uint4* __restrict__ table,
                                   const int32_t* __restrict__ offsets,
                                   const int32_t* __restrict__ res, int max_mip, long long M,
                                   float4* __restrict__ out) {
    const long long m = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (m >= M) return;
    out[m] = ngp_baked::sample(pos[3 * m + 0], pos[3 * m + 1], pos[3 * m + 2], index, table,
                               offsets, res, max_mip);
}

}  // namespace

extern "C" int ngp_baked_query(const void* pos, const void* index, const void* table,
                               const void* offsets, const void* res, int max_mip, long long M,
                               void* out, void* stream) {
    const int threads = 256;
    const long long blocks = (M + threads - 1) / threads;
    baked_query_kernel<<<(unsigned)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(pos), static_cast<const int32_t*>(index),
        static_cast<const uint4*>(table), static_cast<const int32_t*>(offsets),
        static_cast<const int32_t*>(res), max_mip, M, static_cast<float4*>(out));
    return (int)cudaGetLastError();
}
