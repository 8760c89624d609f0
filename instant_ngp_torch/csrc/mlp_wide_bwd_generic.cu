// Kernel F's wide route (first launch, up to 128 wide) under a generic activation: leakyrelu,
// sine, squareplus, softplus or tanh as the hidden or the output activation
// (instant_ngp_tpu/ops/mlp.py:27-40, the JAX MLP's XLA path; plain versions:
// instant_ngp_torch/ops/mlp_kernel.py's _act and _act_grad). The source of
// csrc/mlp_wide_bwd.cu compiled with NGP_GENERIC_ACT: every layer's activation through
// mlp_wide.cuh's kGeneric instantiation, a non-inlined call a value on the
// code given at run time. A kernel of their own, so that the relu, sigmoid
// and exponential kernels hold no call (csrc/mlp_wide.cuh), and a source of
// its own, so that it compiles in parallel with the others.

#define NGP_GENERIC_ACT 1
#include "mlp_wide_bwd.cu"
