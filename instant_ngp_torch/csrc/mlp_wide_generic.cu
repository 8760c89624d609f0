// Kernel B's wide route under a generic hidden activation:
// leakyrelu, sine, squareplus, softplus or tanh (instant_ngp_tpu/ops/
// mlp.py:27-40, the JAX MLP's XLA path; plain versions: instant_ngp_torch/
// ops/mlp_kernel.py's _act and _act_grad), with any output activation. The
// source of csrc/mlp_wide.cu compiled with NGP_GENERIC_ACT: each hidden layer takes
// the instantiation of its activation, inline at every value, picked once
// per layer (csrc/mlp_wide.cuh's NGP_GENERIC_SWITCH). Kernels of their own,
// so that the relu, sigmoid and exponential kernels hold none of the five's
// code, and a source of its own, so that it compiles in parallel.

#define NGP_GENERIC_ACT 1
#include "mlp_wide.cu"
