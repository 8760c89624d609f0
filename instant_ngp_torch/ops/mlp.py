"""Bias-free MLP (port of ``instant_ngp_tpu/ops/mlp.py``).

tcnn MLPs have no biases. Compute follows the JAX package: bf16 inputs
and weights, f32 accumulation, hidden activations rounded to bf16, an f32
output. Weights are stored (fan_in, fan_out), forward is x @ W_0 @ … @
W_last, and it runs through ``fused_mlp`` (kernel B on CUDA tensors).
"""

from __future__ import annotations

import torch
from torch import nn

from .mlp_kernel import fused_mlp, fused_mlp_plain


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
            nn.Parameter(torch.zeros(shape, dtype=torch.float32, device=device), requires_grad=False)
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mlp = fused_mlp if self.use_kernel else fused_mlp_plain
        return mlp(list(self.weights), x, self.activation, self.output_activation)


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
