// Kernels B and F past the narrow kernels' limits: the fused bias-free MLP,
// forward (B) and backward (F), at any depth, layer widths up to 256, and
// relu, none, sigmoid, exponential, leakyrelu, sine, squareplus, softplus or
// tanh as the hidden and the output activation; and F's weight gradient, dW_i = h_i^T·dz_i, the second launch of a wide F.
//
// Replaces the same Pallas kernel as csrc/mlp.cu and csrc/mlp_bwd.cu:
// instant_ngp_tpu/ops/pallas/mlp_kernel.py::_fused_mlp_fwd_impl (public
// fused_mlp), which takes any widths, any depth and those four activations
// (mlp_kernel.py:40-50), and its backward, the vjp of _reference_forward
// (mlp_kernel.py:106-111). Plain versions: instant_ngp_torch/ops/
// mlp_kernel.py::fused_mlp_plain, fused_mlp_bwd_plain and mlp_dw_plain. The
// wrapper routes an MLP here where kernel B or F (csrc/mlp.cu, csrc/
// mlp_bwd.cu: widths <= 64, <= 8 matrices, relu/none) does not take it.
//
// Contract: as csrc/mlp.cu and csrc/mlp_bwd.cu. Sigmoid and exponential are
// computed on the f32 accumulator and then rounded to bf16, as the plain
// version does; their derivatives are s·(1 − s) and e^z of the f32 values, as
// JAX differentiates jax.nn.sigmoid and jnp.exp. Leakyrelu, sine,
// squareplus, softplus and tanh (the JAX MLP's XLA path, instant_ngp_tpu/ops/
// mlp.py:27-40, which its Pallas kernel does not take) are the same kind: f32
// values and f32 derivatives (mlp_wide.cuh's activate and act_grad). Every
// activation is compiled into the kernel that runs it, one instantiation a
// kind picked per layer: this source's kernels take relu, sigmoid,
// exponential or none as the hidden activation, its generic twin's
// (csrc/mlp_wide_generic.cu) the five; each takes any output activation,
// one its hidden layers do not take through a rolled loop over the output
// (mlp_wide.cuh).
//
// What bounds it on an H100: at 128 wide the products are no longer nearly
// free. image/oneblob.json (256 -> 128 x 8 -> 3, 147,840 weights) does 2·147,840
// operations a row for 1 KB of f32 input: ~0.08 ms each for the products (989
// TFLOP/s bf16) and the bytes (3.35 TB/s) at 2^18 rows. The weights do not fit
// shared memory at once (~300 KB in bf16 against 227 KB a block), so they
// stream through it, from L2, once for every tile of rows. F's backward is two
// more products of the same size, and dW needs every layer's input h_i and
// output cotangent dz_i of every row: 2^18 x 2,307 bf16 values at oneblob, 1.2
// GB written by F and read by the dW kernel, ~0.36 ms each way at 3.35 TB/s.
// That traffic, not the operations, is the wide F's floor.
//
// Design, forward (B, and F's recompute: one device function, fwd_layer):
// persistent blocks, one an SM, of one producer warpgroup and kC consumer
// warpgroups (kC = 3 where every width is <= 128, 2 where one is <= 256),
// each consumer owning 64 rows of the block's tile of 64·kC rows.
// - Products are wgmma m64nNk16 (N = the layer's width padded to 16, 32, 64,
//   128 or 256; f32 accumulators; k16 steps in ascending order from zero into
//   zeroed accumulators). A chain of them rounds exactly like kernel B's
//   mma.sync m16n8k16 chain (the probe below, run by chip_smoke.py, holds the
//   two bit for bit), so the wide and the narrow route, and B and F's
//   recompute, agree to the bit.
// - The A operand comes from registers: the x tile is read (f32, rounded in
//   the kernel) straight into the A fragments, and after each layer the next
//   layer's fragments are built from the accumulators after the activation
//   and the bf16 rounding (the accumulator and A layouts put a column pair in
//   the same lane). Activations never touch shared memory.
// - The B operand comes from shared memory in wgmma's K-major core-matrix
//   layout with no swizzle (wgmma.cuh): pack_layer lays every layer out once a
//   call, rounded to bf16 and zero-padded, in chunks of K rows that fill one
//   32 KB stage (64 rows at N = 256, 128 at 128, a whole small layer). A
//   core matrix is one contiguous 128-byte line, so the tensor core reads it
//   without bank conflicts, and a chunk is one contiguous run of bytes.
// - Chunks stream into a ring of kStages (4 to 6) stages by 1-D bulk
//   asynchronous copies (cp.async.bulk, no tensor map) that complete on the
//   stage's "full" mbarrier. One thread of the producer warpgroup walks the
//   same (tile, layer, chunk) sequence as the consumers and runs ahead across
//   layers and tiles, as far as the ring allows. A consumer waits on the
//   stage's full barrier, issues its wgmmas, and one thread of it arrives on
//   the stage's "empty" barrier once the wgmmas that read it have completed
//   (wgmma.wait_group 1 keeps the next chunk's products in flight meanwhile).
//   No __syncthreads after set-up.
// - setmaxnreg gives the producer 40 (kC = 2) or 24 registers and the
//   consumers 232 or 160: a 256-wide layer needs 128 accumulator registers
//   and 64 of A fragments a thread.
//
// Design, backward (F): the same forward per tile, which also writes h_i (each
// layer's input, bf16) for the dW kernel and keeps each hidden layer's
// act'(z) in a per-thread scratch (2-bit codes under relu, nothing under
// none, f32 under the others). Then the dh chain, layer by layer
// from the last, on wgmma as well, with the untransposed packed weights as the
// B operand: dz_{L-1} = g·act_out'(z_L); dh_i = dz_i·W_i^T; dz_{i-1} =
// bf16(dh_i)·act'(z_i); dX = bf16(dh_0). Under a relu/none hidden layer each
// inner dz_i is a bf16 value (act' is 0, ½ or 1), so it goes from the
// accumulators straight into the next product's A fragments and, once, to
// the dz buffer in bf16. Where dz is an f32 value (dz_{L-1}, and every dz
// under any other hidden activation) it is kept in the per-thread
// scratch and enters the products as the three bf16 terms of kernel F's
// exact split (hi + mid + lo = dz), one pass of the layer's chunks each, and
// is written to the dz buffer as those three terms. The per-thread scratch
// stays in shared memory where it fits beside four stages (at 128 wide and
// relu, 4 words a thread per hidden layer: oneblob's 8 layers and its f32
// dz_{L-1} take 40 words, 60 KB for 384 threads; at 256 wide 8 words a
// layer), else in global memory, where it stays in L2; each thread reads
// back only what it wrote. Everything else of a tile stays in registers.
//
// h_i and dz_i go to global memory in the dW kernel's operand layout: per 64-
// row tile, MN-major core matrices (8 rows x 8 features, 128 contiguous bytes,
// feature groups 1 KB apart), so a warp's store of one fragment register is
// one whole 128-byte line, rows past n written as zeros.
//
// Design, dW (a second launch, mlp_dw_kernel): dW_i = Σ_rows h_i^T·dz_i on
// wgmma m64nNk16 with both operands read from shared memory, transposed
// (MN-major), k = rows in ascending 16-row steps, the three dz terms in turn
// where they exist, f32 accumulators. Persistent blocks walk units of (layer,
// 64·kC input features, a range of split_rows rows); the producer streams each
// 64-row tile's h slab and dz block through the ring as above. Each unit
// writes its f32 partial; a second small kernel sums every element's
// partials in the order of the ranges and rounds once to bf16. No atomics: a
// call gives the same bits from run to run.

#include "mlp_wide.cuh"

namespace {

// kernel B's wide route on (x, w, dims, n_layers, act, out_act, n, scratch,
// out): pack the weights, then the persistent kernel
int wide_forward(const void* x, const void* w, const void* dims, int n_layers, int act, int out_act,
                 long long n, void* scratch, void* out, void* stream) {
    const int* d = static_cast<const int*>(dims);
    const int pmax = check_dims(d, n_layers);
    if (pmax == 0) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    unsigned char* pk = static_cast<unsigned char*>(scratch);
    const Plan pl = plan(d, n_layers, act);
    const int err = pack(w, pl, n_layers, pk, false, st);
    if (err != 0) return err;
    Params p = {};
    p.x = static_cast<const float*>(x);
    p.pk = pk;
    p.L = n_layers;
    p.act = act;
    p.out_act = out_act;
    p.n = n;
    p.out = static_cast<float*>(out);
    if (pmax <= 128) return launch_wide<128, 3, false>(p, pl, st);
    return launch_wide<256, 2, false>(p, pl, st);
}

}  // namespace

#if NGP_GENERIC_ACT
// kernel B's wide route under a generic activation (csrc/mlp_wide_generic.cu)
extern "C" int ngp_fused_mlp_wide_generic(const void* x, const void* w, const void* dims, int n_layers,
                                          int act, int out_act, long long n, void* scratch, void* out,
                                          void* stream) {
    return wide_forward(x, w, dims, n_layers, act, out_act, n, scratch, out, stream);
}
#else
extern "C" int ngp_fused_mlp_wide_generic(const void* x, const void* w, const void* dims, int n_layers,
                                          int act, int out_act, long long n, void* scratch, void* out,
                                          void* stream);

namespace {

// ---- the rounding probe ----

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

constexpr int kProbeK = 256, kProbeN = 128;

// one warpgroup: z = bf16(x)·bf16(W), x (64, 256) f32, W (256, 128) packed as
// the forward's B operand (two chunks of 128 rows); zw by one wgmma
// m64n128k16 chain, zm by each warp's mma.sync m16n8k16 chains (kernel B's
// order: k blocks ascending from zero), both into zeroed accumulators
__global__ void __launch_bounds__(128, 1) wgmma_probe(const float* __restrict__ x, const float* __restrict__ w,
                                                       const unsigned char* wpk, int rows, float* zw, float* zm) {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    __shared__ __align__(8) uint64_t bar;
    const int t = threadIdx.x;
    if (t == 0) {
        wg::mbar_init(&bar, 1);
        wg::mbar_init_fence();
    }
    __syncthreads();
    const uint32_t bytes = 2u * kProbeK * kProbeN;
    if (t == 0) {
        wg::mbar_expect_tx(&bar, bytes);
        wg::bulk_copy(smem_raw, wpk, bytes, &bar);
    }
    Ctx c;
    c.wtid = t;
    c.warp = t >> 5;
    c.gq = (t & 31) >> 2;
    c.tig = t & 3;
    c.r0 = 16 * c.warp + c.gq;
    c.r1 = c.r0 + 8;
    uint32_t a[kProbeK / 16][4];
    load_x<kProbeK>(a, x, kProbeK, kProbeK, 64, c);
    wg::mbar_wait(&bar, 0);
    float acc[kProbeN / 2];
#pragma unroll
    for (int v = 0; v < kProbeN / 2; ++v) acc[v] = 0.0f;
#pragma unroll
    for (int v = 0; v < kProbeN / 2; ++v) wg::fence_reg(acc[v]);
    wg::fence();
#pragma unroll
    for (int kb = 0; kb < kProbeK / 16; ++kb) {
        const int ch = kb * 16 / rows, loc = kb - ch * rows / 16;
        wg::Wgmma<kProbeN>::rs(acc, a[kb],
                               wg::desc(smem_raw + (size_t)ch * rows * kProbeN * 2 + loc * 256, 128, rows * 16), 1);
    }
    wg::commit();
    wg::wait<0>();
#pragma unroll
    for (int v = 0; v < kProbeN / 2; ++v) wg::fence_reg(acc[v]);
#pragma unroll
    for (int kb = 0; kb < kProbeK / 16; ++kb)
#pragma unroll
        for (int e = 0; e < 4; ++e) wg::fence_reg(a[kb][e]);
#pragma unroll
    for (int j = 0; j < kProbeN / 8; ++j) {
        const int col = 8 * j + 2 * c.tig;
        store_pair(zw, c.r0, col, 64, kProbeN, acc[4 * j], acc[4 * j + 1]);
        store_pair(zw, c.r1, col, 64, kProbeN, acc[4 * j + 2], acc[4 * j + 3]);
    }
    for (int j = 0; j < kProbeN / 8; ++j) {
        float m[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        const int nn = 8 * j + c.gq;
#pragma unroll
        for (int kb = 0; kb < kProbeK / 16; ++kb) {
            const int k = 16 * kb + 2 * c.tig;
            mma_bf16(m, a[kb], pack_bf16(w[k * kProbeN + nn], w[(k + 1) * kProbeN + nn]),
                     pack_bf16(w[(k + 8) * kProbeN + nn], w[(k + 9) * kProbeN + nn]));
        }
        const int col = 8 * j + 2 * c.tig;
        store_pair(zm, c.r0, col, 64, kProbeN, m[0], m[1]);
        store_pair(zm, c.r1, col, 64, kProbeN, m[2], m[3]);
    }
}

}  // namespace


// sizes of what a wide call takes (int64 out[6]): scratch bytes (header,
// packed weights, records), F's h buffer and dz buffer (bf16 values), F's
// global per-thread scratch (f32 values, 0 where it fits shared memory), the dW
// partials (f32 values) and their splits; for n rows, the hidden activation
// act and dW splits of split_rows rows. Returns a cudaError.
extern "C" int ngp_fused_mlp_wide_sizes(const void* dims, int n_layers, int act, long long n, int split_rows,
                                        void* out) {
    const int* d = static_cast<const int*>(dims);
    long long* o = static_cast<long long*>(out);
    const int pmax = check_dims(d, n_layers);
    if (pmax == 0 || split_rows < kTile || split_rows % kTile != 0) return (int)cudaErrorInvalidValue;
    const Plan pl = plan(d, n_layers, act);
    const int kc = consumers(pmax);
    const long long n_t64 = (n + kTile - 1) / kTile;
    const SmemPlan sp = smem_plan(pl, kc, true);
    long long parts = 0;
    for (int i = 0; i < n_layers; ++i) parts += (long long)d[i] * d[i + 1];
    const long long splits = (n_t64 + split_rows / kTile - 1) / (split_rows / kTile);
    o[0] = (long long)scratch_bytes(pl, n_layers);
    o[1] = n_t64 * kTile * pl.t.hw;
    o[2] = n_t64 * kTile * pl.t.zw;
    o[3] = sp.scr_in_smem ? 0 : (long long)device_info().n_sm * 128 * kc * pl.t.scr_words;
    o[4] = splits * parts;
    o[5] = splits;
    return (int)cudaGetLastError();
}

// x: (n, d_0) f32; w: n_layers host pointers, layer i f32 (d_i, d_{i+1}); dims:
// host int[n_layers + 1]; scratch: ngp_fused_mlp_wide_sizes' bytes; out: (n,
// d_L) f32. A generic hidden activation goes to csrc/mlp_wide_generic.cu's
// kernels; both sets take every output activation.
extern "C" int ngp_fused_mlp_wide(const void* x, const void* w, const void* dims, int n_layers, int act,
                                  int out_act, long long n, void* scratch, void* out, void* stream) {
    if (uses_generic(act))
        return ngp_fused_mlp_wide_generic(x, w, dims, n_layers, act, out_act, n, scratch, out, stream);
    return wide_forward(x, w, dims, n_layers, act, out_act, n, scratch, out, stream);
}

// whether a wgmma chain rounds like kernel B's mma.sync chain: x (64, 256) f32,
// w (256, 128) f32, scratch (ngp_fused_mlp_wide_sizes' bytes for those widths),
// zw, zm (64, 128) f32: the same product by each (wgmma_probe)
extern "C" int ngp_mlp_wgmma_probe(const void* x, const void* w, void* scratch, void* zw, void* zm, void* stream) {
    const int d[2] = {kProbeK, kProbeN};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    unsigned char* pk = static_cast<unsigned char*>(scratch);
    const Plan pl = plan(d, 1, kRelu);
    const void* wp[1] = {w};
    int err = pack(wp, pl, 1, pk, false, st);
    if (err != 0) return err;
    const int bytes = 2 * kProbeK * kProbeN;
    static size_t set = 0;
    err = set_smem(wgmma_probe, bytes, set);
    if (err != 0) return err;
    wgmma_probe<<<1, 128, bytes, st>>>(static_cast<const float*>(x), static_cast<const float*>(w),
                                       pk + header_bytes(1), chunk_rows(kProbeK, kProbeN), static_cast<float*>(zw),
                                       static_cast<float*>(zm));
    return (int)cudaGetLastError();
}
#endif  // NGP_GENERIC_ACT
