// Kernel N: the baked sample.
//
// Replaces instant_ngp_tpu/nerf/baked.py::query (the per-sample lookup of
// the baked sparse-cell cache). Plain version:
// instant_ngp_torch/nerf/baked.py::query_plain, which this kernel follows
// operation for operation, so the two agree to the bit.
//
// Per sample: the cascade (mip) from the position, that mip's bake
// resolution n and flat index offset, the cell and its fraction, one int32
// index load, one 64-byte bf16 row (8 corners x [r, g, b, sigma]), the
// trilinear sum over the corners in the bake's order c = 4*dx + 2*dy + dz,
// and zero outside occupancy or outside the mip's box.
//
// What bounds it on an H100: bytes. A sample reads its position (12 B),
// one index entry (4 B) and one table row (64 B) and writes 16 B: ~96 B,
// against ~30 flops. The index and table are random-access reads (the
// index is 256^3 + 2*128^3 int32 on fox, 84 MB; the table up to 2^21
// rows, 134 MB), so the row read is what costs.
//
// Simple design: one thread a sample; the row as four 16-byte loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__global__ void baked_query_kernel(const float* __restrict__ pos, const int32_t* __restrict__ index,
                                   const uint4* __restrict__ table,
                                   const int32_t* __restrict__ offsets,
                                   const int32_t* __restrict__ res, int max_mip, long long M,
                                   float4* __restrict__ out) {
    const long long m = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (m >= M) return;
    float p[3] = {pos[3 * m + 0], pos[3 * m + 1], pos[3 * m + 2]};
    // mip_from_pos: the smallest cascade containing the position
    const float maxval = fmaxf(fmaxf(fabsf(p[0] - 0.5f), fabsf(p[1] - 0.5f)), fabsf(p[2] - 0.5f));
    int e;
    frexpf(fmaxf(maxval, 1e-30f), &e);
    const int mip = min(max(e + 1, 0), max_mip);
    const int n = res[mip];
    const float nf = (float)n;
    const float scale = ldexpf(1.0f, -mip);
    bool inb = true;
    int i[3];
    float f[3];
    for (int a = 0; a < 3; ++a) {
        const float q = (p[a] - 0.5f) * scale + 0.5f;
        inb = inb && q >= 0.0f && q < 1.0f;
        const float u = q * nf;
        i[a] = min(max((int)floorf(u), 0), n - 1);
        f[a] = fminf(fmaxf(u - (float)i[a], 0.0f), 1.0f);
    }
    const int flat = offsets[mip] + (i[0] * n + i[1]) * n + i[2];
    const int idx = index[flat];
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (idx >= 0 && inb) {
        const uint4* row = table + (size_t)idx * 4;  // 32 bf16 = 4 x 16 B
        const float w[3][2] = {{1.0f - f[0], f[0]}, {1.0f - f[1], f[1]}, {1.0f - f[2], f[2]}};
        for (int h = 0; h < 4; ++h) {  // 16 B: two corners of [r, g, b, sigma]
            const uint4 v = row[h];
            const uint32_t words[4] = {v.x, v.y, v.z, v.w};
            for (int k = 0; k < 2; ++k) {
                const int c = 2 * h + k;
                const float wc = (w[0][(c >> 2) & 1] * w[1][(c >> 1) & 1]) * w[2][c & 1];
                acc.x = acc.x + wc * bf16_lo(words[2 * k]);
                acc.y = acc.y + wc * bf16_hi(words[2 * k]);
                acc.z = acc.z + wc * bf16_lo(words[2 * k + 1]);
                acc.w = acc.w + wc * bf16_hi(words[2 * k + 1]);
            }
        }
    }
    out[m] = acc;
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
