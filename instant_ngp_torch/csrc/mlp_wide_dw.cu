// Kernel F's wide route, second launch: dW_i = h_i^T·dz_i from the bf16 h_i and
// dz_i (and dz_i's three terms where it is an f32 value) that the first
// launch wrote, on wgmma, split over ranges of rows whose f32 partials a
// second kernel sums in order (csrc/mlp_wide.cu describes the design). It
// replaces what the JAX package leaves to XLA in the vjp of _reference_forward
// (instant_ngp_tpu/ops/pallas/mlp_kernel.py:106-111); plain version:
// instant_ngp_torch/ops/mlp_kernel.py::mlp_dw_plain.

#include "mlp_wide.cuh"

namespace {

// ---- dW ----

constexpr int kDwC = 2;  // consumer warpgroups of the dW kernel: 128 input features a unit

struct DwParams {
    const __nv_bfloat16* hbuf;
    const __nv_bfloat16* dzbuf;
    const unsigned char* pk;  // the widths (header)
    int L, act;
    long long n;
    int spt;     // 64-row tiles a split
    int splits;
    int hw, zw;
    int n_stages, stage_bytes;
    float* partials;  // per layer (splits, d_in, d_out) f32
};

// the dW product of one unit: acc (64 features x N) over the unit's tiles
template <int N>
__device__ __forceinline__ void dw_unit(const int* r, const DwParams& p, long long t0, long long t1, int cw,
                                        unsigned char* stages, uint64_t* full, uint64_t* empty, uint32_t& q,
                                        int wtid, float* part, int m0, int gq, int tig, int warp) {
    float acc[N / 2];
#pragma unroll
    for (int v = 0; v < N / 2; ++v) acc[v] = 0.0f;
#pragma unroll
    for (int v = 0; v < N / 2; ++v) wg::fence_reg(acc[v]);
    wg::fence();
    const int terms = r[L_TERMS];
    int pend = -1, cur = 0;
    for (long long t = t0; t < t1; ++t) {
        if (t > t0) {
            wg::commit();
            if (pend >= 0) {
                wg::wait<1>();
                if (wtid == 0) wg::mbar_arrive(&empty[pend]);
            }
            pend = cur;
        }
        cur = (int)(q % (uint32_t)p.n_stages);
        wg::mbar_wait(&full[cur], (q / (uint32_t)p.n_stages) & 1u);
        ++q;
        const unsigned char* st = stages + (size_t)cur * p.stage_bytes;
        const unsigned char* sa = st + cw * (kTile * kTile * 2);
        const unsigned char* sb = st + kDwC * (kTile * kTile * 2);
#pragma unroll
        for (int ks = 0; ks < kTile / 16; ++ks) {
            for (int qq = 0; qq < terms; ++qq)
                wg::Wgmma<N>::template ss<1, 1>(acc, wg::desc(sa + ks * 256, 128, 1024),
                                                wg::desc(sb + qq * kTile * N * 2 + ks * 256, 128, 1024), 1);
        }
    }
    wg::commit();
    wg::wait<0>();
    if (wtid == 0) {
        if (pend >= 0) wg::mbar_arrive(&empty[pend]);
        wg::mbar_arrive(&empty[cur]);
    }
#pragma unroll
    for (int v = 0; v < N / 2; ++v) wg::fence_reg(acc[v]);
    const int din = r[L_DIN], dout = r[L_DOUT];
    const int m_a = m0 + 16 * warp + gq, m_b = m_a + 8;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
        const int col = 8 * j + 2 * tig;
        store_pair(part, m_a, col, din, dout, acc[4 * j], acc[4 * j + 1]);
        store_pair(part, m_b, col, din, dout, acc[4 * j + 2], acc[4 * j + 3]);
    }
}

// units of (layer, group of kDwC·64 input features, split of rows)
__device__ __forceinline__ void unit_of(const int* s_u, int L, int splits, int u, int& i, int& grp,
                                        int& s) {
    i = 0;
    while (i + 1 < L && u >= s_u[i + 1]) ++i;
    const int k = u - s_u[i];
    grp = k / splits;
    s = k - grp * splits;
}

template <int kMaxN>
__global__ void __launch_bounds__(128 * (kDwC + 1), 1) mlp_dw_kernel(const DwParams p) {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    unsigned char* stages = smem_raw;
    uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw + (size_t)p.n_stages * p.stage_bytes);
    uint64_t* empty = full + p.n_stages;
    int* s_l = reinterpret_cast<int*>(empty + p.n_stages);
    int* s_u = s_l + kLayerInts * p.L;  // the first unit of each layer, then the total
    __shared__ int s_p[1];
    if (threadIdx.x == 0) {
        layer_records(reinterpret_cast<const int*>(p.pk), p.L, p.act, s_l);
        int u = 0;
        for (int i = 0; i < p.L; ++i) {
            s_u[i] = u;
            u += (pad64(s_l[kLayerInts * i + L_DIN]) + kDwC * kTile - 1) / (kDwC * kTile) * p.splits;
        }
        s_u[p.L] = u;
        s_p[0] = u;
        for (int s = 0; s < p.n_stages; ++s) {
            wg::mbar_init(&full[s], 1);
            wg::mbar_init(&empty[s], kDwC);
        }
        wg::mbar_init_fence();
    }
    __syncthreads();
    const int n_units = s_p[0];
    const long long n_t64 = (p.n + kTile - 1) / kTile;
    const int wgi = threadIdx.x / 128;
    if (wgi == 0) {
        wg::regs_dec<Regs<kDwC>::kProducer>();
        if (threadIdx.x != 0) return;
        uint32_t q = 0;
        for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
            int i, grp, s;
            unit_of(s_u, p.L, p.splits, u, i, grp, s);
            const int* r = s_l + kLayerInts * i;
            const int f0 = grp * kDwC * kTile;
            const int fa = pad64(r[L_DIN]) - f0 < kDwC * kTile ? pad64(r[L_DIN]) - f0 : kDwC * kTile;
            const uint32_t a_bytes = 2u * kTile * fa;
            const uint32_t b_bytes = 2u * kTile * r[L_NOUT] * r[L_TERMS];
            const long long t1 = (s + 1LL) * p.spt < n_t64 ? (s + 1LL) * p.spt : n_t64;
            for (long long t = (long long)s * p.spt; t < t1; ++t) {
                const int st = (int)(q % (uint32_t)p.n_stages);
                wg::mbar_wait(&empty[st], ((q / (uint32_t)p.n_stages) & 1u) ^ 1u);
                wg::mbar_expect_tx(&full[st], a_bytes + b_bytes);
                unsigned char* dst = stages + (size_t)st * p.stage_bytes;
                wg::bulk_copy(dst, p.hbuf + (size_t)t * kTile * p.hw + (size_t)kTile * (r[L_HCOL] + f0), a_bytes,
                              &full[st]);
                wg::bulk_copy(dst + kDwC * kTile * kTile * 2,
                              p.dzbuf + (size_t)t * kTile * p.zw + (size_t)kTile * r[L_DZCOL], b_bytes, &full[st]);
                ++q;
            }
        }
        return;
    }
    wg::regs_inc<Regs<kDwC>::kConsumer>();
    const int wtid = threadIdx.x & 127, warp = wtid >> 5, gq = (wtid & 31) >> 2, tig = wtid & 3;
    const int cw = wgi - 1;
    uint32_t q = 0;
    for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
        int i, grp, s;
        unit_of(s_u, p.L, p.splits, u, i, grp, s);
        const int* r = s_l + kLayerInts * i;
        // layer i's partials: (splits, d_in, d_out) after those of the layers before it
        size_t off = 0;
        for (int j = 0; j < i; ++j) off += (size_t)p.splits * s_l[kLayerInts * j + L_DIN] * s_l[kLayerInts * j + L_DOUT];
        float* part = p.partials + off + (size_t)s * r[L_DIN] * r[L_DOUT];
        const long long t0 = (long long)s * p.spt;
        const long long t1 = t0 + p.spt < n_t64 ? t0 + p.spt : n_t64;
        const int m0 = (grp * kDwC + cw) * kTile;
#define NGP_DW(NV) dw_unit<NV>(r, p, t0, t1, cw, stages, full, empty, q, wtid, part, m0, gq, tig, warp)
        NGP_WIDE_SWITCH(r[L_NOUT], NGP_DW)
#undef NGP_DW
    }
}

// dW_i = bf16(Σ_s partial_s), s in order (the f32 sum itself where !round_bf16):
// every layer, one element a thread
__global__ void dw_reduce(const float* __restrict__ partials, const unsigned char* pk, int L, int splits,
                          float* __restrict__ dw, long long total, int round_bf16) {
    const int* d = reinterpret_cast<const int*>(pk);
    for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total;
         e += (long long)gridDim.x * blockDim.x) {
        long long base = 0, pbase = 0;
        int i = 0;
        while ((long long)d[i] * d[i + 1] <= e - base) {
            base += (long long)d[i] * d[i + 1];
            pbase += (long long)splits * d[i] * d[i + 1];
            ++i;
        }
        const long long k = e - base, size = (long long)d[i] * d[i + 1];
        float sum = 0.0f;
        for (int s = 0; s < splits; ++s) sum += partials[pbase + s * size + k];
        dw[e] = round_bf16 ? bf16_round(sum) : sum;
    }
}

int dw_stage_bytes(const int* d, int n_layers, int act) {
    int b = 0;
    for (int i = 0; i < n_layers; ++i) {
        const int terms = i == n_layers - 1 || act >= kSigmoid ? 3 : 1;
        const int v = kDwC * kTile * kTile * 2 + 2 * kTile * wgn(d[i + 1]) * terms;
        b = v > b ? v : b;
    }
    return b;
}

}  // namespace

// hbuf, dzbuf: what ngp_fused_mlp_bwd_wide wrote for these widths, n and act;
// scratch: its scratch (the widths in its header); split_rows: rows a split;
// partials: ngp_fused_mlp_wide_sizes' f32 values; dw: every layer's (d_i,
// d_{i+1}) f32 in turn, bf16 values where round_bf16, else the f32 sums (a
// data-parallel step sums them over its ranks before it rounds)
extern "C" int ngp_fused_mlp_dw_wide(const void* hbuf, const void* dzbuf, const void* dims, int n_layers, int act,
                                     long long n, int split_rows, void* scratch, void* partials, void* dw,
                                     int round_bf16, void* stream) {
    const int* d = static_cast<const int*>(dims);
    const int pmax = check_dims(d, n_layers);
    if (pmax == 0 || split_rows < kTile || split_rows % kTile != 0) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const Plan pl = plan(d, n_layers, act);
    DwParams p = {};
    p.hbuf = static_cast<const __nv_bfloat16*>(hbuf);
    p.dzbuf = static_cast<const __nv_bfloat16*>(dzbuf);
    p.pk = static_cast<const unsigned char*>(scratch);
    p.L = n_layers;
    p.act = act;
    p.n = n;
    p.spt = split_rows / kTile;
    const long long n_t64 = (n + kTile - 1) / kTile;
    p.splits = (int)((n_t64 + p.spt - 1) / p.spt);
    p.hw = pl.t.hw;
    p.zw = pl.t.zw;
    p.stage_bytes = dw_stage_bytes(d, n_layers, act);
    p.partials = static_cast<float*>(partials);
    const size_t optin = (size_t)device_info().smem_optin;
    const size_t units_bytes = sizeof(int) * (n_layers + 1);
    int s = kMaxStages + 2;
    while (s > 2 && base_smem(s, p.stage_bytes, pl.recs_bytes) + units_bytes > optin) --s;
    const size_t smem = base_smem(s, p.stage_bytes, pl.recs_bytes) + units_bytes;
    if (smem > optin) return (int)cudaErrorInvalidValue;
    p.n_stages = s;
    long long n_units = 0;
    for (int i = 0; i < n_layers; ++i) n_units += (pad64(d[i]) + kDwC * kTile - 1) / (kDwC * kTile) * p.splits;
    const long long want = device_info().n_sm;
    const unsigned blocks = (unsigned)(n_units < want ? n_units : want);
    static size_t set128 = 0, set256 = 0;
    int err;
    if (pmax <= 128) {
        err = set_smem(mlp_dw_kernel<128>, smem, set128);
        if (err != 0) return err;
        mlp_dw_kernel<128><<<blocks, 128 * (kDwC + 1), smem, st>>>(p);
    } else {
        err = set_smem(mlp_dw_kernel<256>, smem, set256);
        if (err != 0) return err;
        mlp_dw_kernel<256><<<blocks, 128 * (kDwC + 1), smem, st>>>(p);
    }
    err = (int)cudaGetLastError();
    if (err != 0) return err;
    long long total = 0;
    for (int i = 0; i < n_layers; ++i) total += (long long)d[i] * d[i + 1];
    const long long rb = (total + 255) / 256;
    dw_reduce<<<(unsigned)(rb < 4 * want ? rb : 4 * want), 256, 0, st>>>(
        static_cast<const float*>(partials), p.pk, n_layers, p.splits, static_cast<float*>(dw), total,
        round_bf16);
    return (int)cudaGetLastError();
}

// whether a wgmma chain rounds like kernel B's mma.sync chain: x (64, 256) f32,
// w (256, 128) f32, scratch (ngp_fused_mlp_wide_sizes' bytes for those widths),
