// The baked sample: kernel N's per-sample body, shared by kernel N
// (csrc/baked.cu) and the baked round (csrc/baked_round.cu).
//
// The lookup of instant_ngp_tpu/nerf/baked.py::query at one world position,
// in the order of its plain version instant_ngp_torch/nerf/baked.py::
// query_plain, so that both callers agree with it to the bit: the cascade
// (mip) from the position, that mip's bake resolution n and flat index
// offset, the cell and its fraction, one int32 index load, one 64-byte bf16
// row (8 corners x [r, g, b, sigma]) as four 16-byte loads, the trilinear
// sum over the corners in the bake's order c = 4*dx + 2*dy + dz, and zero
// outside occupancy or outside the mip's box.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ngp_baked {

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// activated [r, g, b, sigma] of the bake at world position (p0, p1, p2)
__device__ __forceinline__ float4 sample(float p0, float p1, float p2,
                                         const int32_t* __restrict__ index,
                                         const uint4* __restrict__ table,
                                         const int32_t* __restrict__ offsets,
                                         const int32_t* __restrict__ res, int max_mip) {
    const float p[3] = {p0, p1, p2};
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
        const uint4 v[4] = {row[0], row[1], row[2], row[3]};  // all four loads in flight
        const float w[3][2] = {{1.0f - f[0], f[0]}, {1.0f - f[1], f[1]}, {1.0f - f[2], f[2]}};
        for (int h = 0; h < 4; ++h) {  // 16 B: two corners of [r, g, b, sigma]
            const uint32_t words[4] = {v[h].x, v[h].y, v[h].z, v[h].w};
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
    return acc;
}

}  // namespace ngp_baked
