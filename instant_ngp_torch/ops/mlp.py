"""Bias-free MLP (port of ``instant_ngp_tpu/ops/mlp.py``).

tcnn MLPs have no biases. Compute follows the JAX package: bf16 inputs
and weights, f32 accumulation, hidden activations rounded to bf16, an f32
output. Weights are stored (fan_in, fan_out), forward is x @ W_0 @ … @
W_last. The forward runs through ``fused_mlp`` (kernel B on CUDA tensors)
and the backward through ``fused_mlp_bwd`` (kernel F on CUDA tensors),
joined by a ``torch.autograd.Function``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .mlp_kernel import fused_mlp, fused_mlp_bwd, fused_mlp_bwd_plain, fused_mlp_plain


class _FusedMLPFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mlp: "MLP", f32_dw: bool, x: torch.Tensor, *ws: torch.Tensor) -> torch.Tensor:
        ctx.mlp, ctx.f32_dw = mlp, f32_dw
        ctx.save_for_backward(x, *ws)
        forward = fused_mlp if mlp.use_kernel else fused_mlp_plain
        return forward(list(ws), x, mlp.activation, mlp.output_activation)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, *ws = ctx.saved_tensors
        mlp = ctx.mlp
        backward = fused_mlp_bwd if mlp.use_kernel else fused_mlp_bwd_plain
        dx, dws = backward(ws, x, g, mlp.activation, mlp.output_activation, f32_dw=ctx.f32_dw)
        return (None, None, dx.to(x.dtype), *dws)


class MLP(nn.Module):
    def __init__(self, n_input_dims: int, n_output_dims: int, n_neurons: int = 64,
                 n_hidden_layers: int = 2, activation: str = "ReLU",
                 output_activation: str = "None", device=None):
        super().__init__()
        self.n_input_dims = n_input_dims
        self.n_output_dims = n_output_dims
        self.n_neurons = n_neurons
        self.n_hidden_layers = n_hidden_layers
        self.activation = activation
        self.output_activation = output_activation
        self.use_kernel = True
        self.weights = nn.ParameterList([
            nn.Parameter(torch.zeros(shape, dtype=torch.float32, device=device))
            for shape in self.layer_sizes
        ])

    @property
    def layer_sizes(self) -> tuple[tuple[int, int], ...]:
        if self.n_hidden_layers == 0:
            return ((self.n_input_dims, self.n_output_dims),)
        sizes = [(self.n_input_dims, self.n_neurons)]
        for _ in range(self.n_hidden_layers - 1):
            sizes.append((self.n_neurons, self.n_neurons))
        sizes.append((self.n_neurons, self.n_output_dims))
        return tuple(sizes)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        """He-uniform weights in place, U(±sqrt(6 / fan_in)), as the JAX
        package's ``MLP.init`` (different random bits)."""
        for w, (fan_in, _) in zip(self.weights, self.layer_sizes):
            limit = math.sqrt(6.0 / fan_in)
            u = torch.rand(w.shape, generator=generator, dtype=torch.float32,
                           device=generator.device)
            w.copy_(u * (2.0 * limit) - limit)

    def forward(self, x: torch.Tensor, f32_dw: bool = False) -> torch.Tensor:
        """``f32_dw``: the backward gives the weights the f32 sums of dW,
        not yet rounded to bf16 (a data-parallel step rounds them after its
        sum over the ranks)."""
        return _FusedMLPFunction.apply(self, f32_dw, x, *self.weights)


def mlp_from_config(cfg: dict, n_input_dims: int, n_output_dims: int, device=None) -> MLP:
    return MLP(
        n_input_dims=n_input_dims,
        n_output_dims=n_output_dims,
        n_neurons=int(cfg.get("n_neurons", 64)),
        n_hidden_layers=int(cfg.get("n_hidden_layers", 2)),
        activation=cfg.get("activation", "ReLU"),
        output_activation=cfg.get("output_activation", "None"),
        device=device,
    )
