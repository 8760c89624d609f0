"""NetworkWithInputEncoding: encoding → MLP, the model of the image primitive
(port of ``instant_ngp_tpu/models/network.py``; the reference builds it with
tcnn's create_network factories, testbed.cu:4160-4412).

Parameters move between the packages as numpy trees in the JAX layout
``{"net": [W (in, out), …], "enc": (table_l (size_l, F), …)}``
(``params_from_jax`` / ``params_to_numpy``; ``train_state_from_jax`` adds
Adam's moments and step). In the port they are one list, ``param_list()``,
in the order [net…, enc], and a grid's per-level tables are one flat
table.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops.encodings import encoding_from_config
from ..ops.hashgrid import GridEncoding
from ..ops.mlp import MLP, mlp_from_config
from ..ops.optimizers import state_from_tree, state_to_tree


class NetworkWithInputEncoding(nn.Module):
    def __init__(self, encoding: nn.Module, network: MLP):
        super().__init__()
        self.encoding = encoding
        self.network = network

    @property
    def n_input_dims(self) -> int:
        return self.encoding.n_dims_to_encode

    @property
    def n_output_dims(self) -> int:
        return self.network.n_output_dims

    def forward(self, x: torch.Tensor, max_level=None) -> torch.Tensor:
        """x (N, n_input_dims) → (N, n_output_dims) f32 (bf16 compute in
        the MLP, as the JAX package's default compute dtype)."""
        if isinstance(self.encoding, GridEncoding):
            feats = self.encoding(x, max_level=max_level)
        else:
            feats = self.encoding(x)
        return self.network(feats)

    def init(self, generator: torch.Generator) -> None:
        """Fresh weights in place: He-uniform MLP, grid tables in ±1e-4."""
        self.network.init(generator)
        if isinstance(self.encoding, GridEncoding):
            self.encoding.init(generator)

    def param_list(self) -> list[nn.Parameter]:
        """The trainable parameters in the order [net…, enc]."""
        params = list(self.network.weights)
        if isinstance(self.encoding, GridEncoding):
            params.append(self.encoding.table)
        return params

    def matrix_mask(self) -> list[bool]:
        """True for the MLP matrices (l2_reg applies), False for the table."""
        return [True] * len(self.network.weights) + [False] * (len(self.param_list())
                                                              - len(self.network.weights))

    def set_use_kernels(self, flag: bool) -> None:
        """Route the grid encoding and the MLP through their CUDA kernels
        (True, the default) or their plain versions."""
        self.network.use_kernel = flag
        if isinstance(self.encoding, GridEncoding):
            self.encoding.use_kernel = flag

    @staticmethod
    def from_config(config: dict, n_input_dims: int, n_output_dims: int,
                    device=None) -> "NetworkWithInputEncoding":
        enc = encoding_from_config(config.get("encoding", {"otype": "Identity"}), n_input_dims,
                                   device=device)
        net = mlp_from_config(config.get("network", {}), enc.n_output_dims, n_output_dims,
                              device=device)
        return NetworkWithInputEncoding(enc, net)


def params_to_numpy(model: NetworkWithInputEncoding) -> dict:
    """The model's parameters as the JAX package's numpy tree."""
    return tree_from_flat(model, model.param_list())


def tree_from_flat(model: NetworkWithInputEncoding, flat) -> dict:
    """A list in ``param_list`` order (the parameters, or an optimizer
    moment) as the JAX package's parameter tree of numpy arrays. Its
    ``jax.tree.leaves`` order (``snapshot.tree_leaves``): enc's per-level
    tables, then net's matrices (keys sorted)."""
    arrs = [t.detach().cpu().numpy() for t in flat]
    n = len(model.network.weights)
    tree = {"net": arrs[:n]}
    if isinstance(model.encoding, GridEncoding):
        tree["enc"] = tuple(model.encoding.unpack_params(arrs[n]))
    return tree


def flat_from_tree(model: NetworkWithInputEncoding, tree: dict) -> list[np.ndarray]:
    """A JAX parameter-shaped tree (params, or an optimizer moment) as
    numpy arrays in ``param_list`` order."""
    flat = [np.array(w, np.float32) for w in tree["net"]]
    if "enc" in tree:
        flat.append(np.concatenate([np.asarray(t, np.float32) for t in tree["enc"]], axis=0))
    shapes = [tuple(p.shape) for p in model.param_list()]
    if [a.shape for a in flat] != shapes:
        raise ValueError(f"tree shapes {[a.shape for a in flat]} do not match the model {shapes}")
    return flat


@torch.no_grad()
def params_from_jax(model: NetworkWithInputEncoding, tree: dict) -> NetworkWithInputEncoding:
    """Load the JAX package's parameter tree (numpy arrays) into ``model``
    in place and return it. Shapes must match the model exactly."""
    for dst, src in zip(model.param_list(), flat_from_tree(model, tree)):
        dst.copy_(torch.from_numpy(src))
    return model


@torch.no_grad()
def train_state_from_jax(model: NetworkWithInputEncoding, opt, params, opt_state) -> dict:
    """The JAX package's parameters and Adam state (numpy trees) as the
    port's: parameters copied into ``model`` in place; returns the
    optimizer state dict (``step``, ``m``, ``v``, and ``ema`` where the
    JAX state has one) for ``opt``."""
    params_from_jax(model, params)
    state = state_from_tree(opt_state, lambda tree: flat_from_tree(model, tree),
                            model.param_list()[0].device)
    if opt.spec.ema_decay is not None and "ema" not in state:
        raise ValueError("the optimizer keeps a parameter EMA but the JAX state has none")
    return state


def train_state_to_numpy(model: NetworkWithInputEncoding, opt_state: dict) -> dict:
    """The port's optimizer state as a numpy tree in the JAX layout."""
    return state_to_tree(opt_state, lambda flat: tree_from_flat(model, flat))
