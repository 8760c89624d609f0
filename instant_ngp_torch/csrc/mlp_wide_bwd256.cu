// Kernel F's wide route, first launch, for MLPs with a layer wider than 128
// (two consumer warpgroups of 232 registers): csrc/mlp_wide_bwd.cu's
// ngp_fused_mlp_bwd_wide hands them here, so that the two instantiations of
// the kernel compile in parallel (csrc/mlp_wide.cu describes the design).

#include "mlp_wide.cuh"

namespace {

int bwd256(const void* x, const void* w, const void* g, const void* dims, int n_layers, int act, int out_act,
           long long n, void* scratch, void* dx, void* hbuf, void* dzbuf, void* gscr, void* zf, void* stream) {
    const int* d = static_cast<const int*>(dims);
    if (check_dims(d, n_layers) == 0) return (int)cudaErrorInvalidValue;
    return launch_bwd<256, 2>(x, w, g, d, n_layers, act, out_act, n, scratch, dx, hbuf, dzbuf, gscr, zf,
                              static_cast<cudaStream_t>(stream));
}

}  // namespace

#if NGP_GENERIC_ACT
extern "C" int ngp_fused_mlp_bwd_wide256_generic(const void* x, const void* w, const void* g, const void* dims,
                                                 int n_layers, int act, int out_act, long long n, void* scratch,
                                                 void* dx, void* hbuf, void* dzbuf, void* gscr, void* zf,
                                                 void* stream) {
    return bwd256(x, w, g, dims, n_layers, act, out_act, n, scratch, dx, hbuf, dzbuf, gscr, zf, stream);
}
#else
extern "C" int ngp_fused_mlp_bwd_wide256(const void* x, const void* w, const void* g, const void* dims,
                                         int n_layers, int act, int out_act, long long n, void* scratch, void* dx,
                                         void* hbuf, void* dzbuf, void* gscr, void* zf, void* stream) {
    return bwd256(x, w, g, dims, n_layers, act, out_act, n, scratch, dx, hbuf, dzbuf, gscr, zf, stream);
}
#endif
