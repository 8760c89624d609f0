// Kernel F's wide route, first launch: the forward recompute and the dh
// chain on wgmma, writing dX, h_i and dz_i (csrc/mlp_wide.cu describes the
// design; the second launch, dW, is csrc/mlp_wide_dw.cu). Replaces the
// backward of instant_ngp_tpu/ops/pallas/mlp_kernel.py::fused_mlp, the vjp of
// _reference_forward (mlp_kernel.py:106-111); plain version: instant_ngp_torch/
// ops/mlp_kernel.py::fused_mlp_bwd_plain.

#include "mlp_wide.cuh"

#define NGP_BWD_ARGS                                                                                       \
    const void *x, const void *w, const void *g, const void *dims, int n_layers, int act, int out_act,   \
        long long n, void *scratch, void *dx, void *hbuf, void *dzbuf, void *gscr, void *zf, void *stream
#define NGP_BWD_PASS x, w, g, dims, n_layers, act, out_act, n, scratch, dx, hbuf, dzbuf, gscr, zf, stream

// the 256-wide instantiations, in csrc/mlp_wide_bwd256.cu and its generic twin
extern "C" int ngp_fused_mlp_bwd_wide256(NGP_BWD_ARGS);
extern "C" int ngp_fused_mlp_bwd_wide256_generic(NGP_BWD_ARGS);

namespace {

// the 128-wide instantiation here, a wider MLP to wide256
int bwd_entry(NGP_BWD_ARGS, int (*wide256)(NGP_BWD_ARGS)) {
    const int* d = static_cast<const int*>(dims);
    const int pmax = check_dims(d, n_layers);
    if (pmax == 0) return (int)cudaErrorInvalidValue;
    if (pmax > 128) return wide256(NGP_BWD_PASS);
    return launch_bwd<128, 3>(x, w, g, d, n_layers, act, out_act, n, scratch, dx, hbuf, dzbuf, gscr, zf,
                              static_cast<cudaStream_t>(stream));
}

}  // namespace

#if NGP_GENERIC_ACT
// kernel F's wide route under a generic activation (csrc/mlp_wide_bwd_generic.cu)
extern "C" int ngp_fused_mlp_bwd_wide_generic(NGP_BWD_ARGS) {
    return bwd_entry(NGP_BWD_PASS, ngp_fused_mlp_bwd_wide256_generic);
}
#else
extern "C" int ngp_fused_mlp_bwd_wide_generic(NGP_BWD_ARGS);

// x: (n, d_0) f32; w, dims, scratch: as ngp_fused_mlp_wide; g: (n, d_L) f32;
// dx: (n, d_0) f32; hbuf, dzbuf, gscr: ngp_fused_mlp_wide_sizes' values (bf16,
// bf16, f32; gscr null where it takes none); zf: null, or (n, d_1 + .. + d_L)
// f32, layer by layer, for the recompute's pre-activations. A generic hidden
// activation goes to csrc/mlp_wide_bwd_generic.cu's kernels; both sets take
// every output activation.
extern "C" int ngp_fused_mlp_bwd_wide(const void* x, const void* w, const void* g, const void* dims, int n_layers,
                                      int act, int out_act, long long n, void* scratch, void* dx, void* hbuf,
                                      void* dzbuf, void* gscr, void* zf, void* stream) {
    if (uses_generic(act)) return ngp_fused_mlp_bwd_wide_generic(NGP_BWD_PASS);
    return bwd_entry(NGP_BWD_PASS, ngp_fused_mlp_bwd_wide256);
}
#endif
