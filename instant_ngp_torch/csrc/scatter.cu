// Kernel H: row scatter-add, out.at[idx].add(vals) in place.
//
// Replaces the Pallas scatter probes scripts/bench_pallas_scatter.py::
// scatter_kernel (2^20 rows into a (2^19, 2) table) and scripts/
// bench_pallas_scatter1d.py::scatter_kernel (the same into a flat (S·F,)
// accumulator: F = 1 here), and instant_ngp_tpu/ops/scatter.py::
// scatter_add_xla. On the training path it adds the error-map deposit
// straight into the map, as the JAX step's error_map.at[corners].add does.
// Plain version: instant_ngp_torch/ops/scatter.py::scatter_add_rows_plain_.
//
// What bounds it on an H100: one atomic per row at a random address,
// resolved in L2 (a (2^19, 2) table is 4 MB and stays there): atomic
// throughput, with contention only where indices repeat. At the path's
// 16,384 rows the kernel takes ~1.3 us on the card, and the host's enqueue
// of the call takes longer (PERF.md).
//
// Design: one thread per row, F a template parameter. A row of F = 2 or 4
// is one float2/float4 atomicAdd (sm_90), each component an f32 add as
// with scalar atomics; F = 1 one scalar atomic; any other F (Fn = 0) a
// loop of scalar atomics. Indices are read as int32 or int64 as they come.
// Offsets are 32-bit when every offset fits (m·F and size·F below 2^31).
// Rows whose index lies outside [0, size) are dropped, as JAX drops
// out-of-bounds updates.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int Fn, typename Index, typename Off>
__global__ void scatter_add_kernel(const Index* __restrict__ idx, const float* __restrict__ vals,
                                   Off m, int F, Off size, float* __restrict__ out) {
    const Off r = (Off)blockIdx.x * (Off)blockDim.x + (Off)threadIdx.x;
    if (r >= m) return;
    const Index dst = __ldg(idx + r);
    if (dst < 0 || (long long)dst >= (long long)size) return;
    const Off row = (Off)dst;
    if constexpr (Fn == 1) {
        atomicAdd(out + row, __ldg(vals + r));
    } else if constexpr (Fn == 2) {
        atomicAdd(reinterpret_cast<float2*>(out) + row,
                  __ldg(reinterpret_cast<const float2*>(vals) + r));
    } else if constexpr (Fn == 4) {
        atomicAdd(reinterpret_cast<float4*>(out) + row,
                  __ldg(reinterpret_cast<const float4*>(vals) + r));
    } else {
        for (int f = 0; f < F; ++f) atomicAdd(out + row * F + f, __ldg(vals + r * F + f));
    }
}

template <int Fn, typename Index, typename Off>
void launch(const void* idx, const void* vals, long long m, int F, long long size, void* out,
            cudaStream_t stream) {
    const int threads = 256;
    const unsigned blocks = (unsigned)((m + threads - 1) / threads);
    scatter_add_kernel<Fn, Index, Off><<<blocks, threads, 0, stream>>>(
        static_cast<const Index*>(idx), static_cast<const float*>(vals), (Off)m, F, (Off)size,
        static_cast<float*>(out));
}

template <typename Index, typename Off>
void launch_f(const void* idx, const void* vals, long long m, int F, int vec, long long size,
              void* out, cudaStream_t stream) {
    if (F == 1) {
        launch<1, Index, Off>(idx, vals, m, F, size, out, stream);
    } else if (F == 2 && vec) {
        launch<2, Index, Off>(idx, vals, m, F, size, out, stream);
    } else if (F == 4 && vec) {
        launch<4, Index, Off>(idx, vals, m, F, size, out, stream);
    } else {
        launch<0, Index, Off>(idx, vals, m, F, size, out, stream);
    }
}

}  // namespace

// idx_bytes: 4 (int32) or 8 (int64); vec: out and vals are aligned to F
// floats, so a row of F = 2 or 4 may be one vector atomic
extern "C" int ngp_scatter_add_rows(const void* idx, int idx_bytes, const void* vals, long long m,
                                    int F, int vec, long long size, void* out, void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool narrow = m * F < (1LL << 31) && size * F < (1LL << 31);
    if (idx_bytes == 4) {
        if (narrow) launch_f<int32_t, int32_t>(idx, vals, m, F, vec, size, out, s);
        else launch_f<int32_t, long long>(idx, vals, m, F, vec, size, out, s);
    } else {
        if (narrow) launch_f<long long, int32_t>(idx, vals, m, F, vec, size, out, s);
        else launch_f<long long, long long>(idx, vals, m, F, vec, size, out, s);
    }
    return (int)cudaGetLastError();
}
