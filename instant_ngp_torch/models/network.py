"""NetworkWithInputEncoding: encoding → MLP, the model of the image primitive
(port of ``instant_ngp_tpu/models/network.py``; the reference builds it with
tcnn's create_network factories, testbed.cu:4160-4412).

Parameters move between the packages as numpy trees in the JAX layout
``{"net": [W (in, out), …], "enc": (table_l (size_l, F), …)}``
(``params_from_jax`` / ``params_to_numpy``; ``train_state_from_jax`` adds
Adam's moments and step); ``enc`` is Takikawa's (n_entries, F) table for
that encoding, a Composite's list of nested trees, and absent for an
encoding without parameters. In the port they are one list,
``param_list()``, in the order [net…, enc tables], and a grid's per-level
tables are one flat table.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops.encodings import (encoding_flat, encoding_from_config, encoding_tables, encoding_tree,
                             init_encoding, set_encoding_kernels)
from ..ops.mlp import MLP, mlp_from_config
from ..ops.losses import loss_fn, loss_type_from_string
from ..ops.optimizers import Optimizer, OptimizerSpec, state_from_tree, state_to_tree


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
        return self.network(self.encoding(x, max_level=max_level))

    def init(self, generator: torch.Generator) -> None:
        """Fresh weights in place: He-uniform MLP, encoding tables in ±1e-4."""
        self.network.init(generator)
        init_encoding(self.encoding, generator)

    def param_list(self) -> list[nn.Parameter]:
        """The trainable parameters in the order [net…, enc tables]."""
        return [*self.network.weights, *encoding_tables(self.encoding)]

    def matrix_mask(self) -> list[bool]:
        """True for the MLP matrices (l2_reg applies), False for the table."""
        return [True] * len(self.network.weights) + [False] * (len(self.param_list())
                                                              - len(self.network.weights))

    def set_use_kernels(self, flag: bool) -> None:
        """Route the grid encoding and the MLP through their CUDA kernels
        (True, the default) or their plain versions."""
        self.network.use_kernel = flag
        set_encoding_kernels(self.encoding, flag)

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
    enc = encoding_tree(model.encoding, arrs[n:])
    if enc is not None:
        tree["enc"] = enc
    return tree


def flat_from_tree(model: NetworkWithInputEncoding, tree: dict) -> list[np.ndarray]:
    """A JAX parameter-shaped tree (params, or an optimizer moment) as
    numpy arrays in ``param_list`` order."""
    flat = [np.array(w, np.float32) for w in tree["net"]]
    flat += encoding_flat(model.encoding, tree.get("enc"))
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


class NetworkTask:
    """What the image and SDF tasks share: a ``NetworkWithInputEncoding``
    trained by the config's optimizer chain, its state in the JAX layout,
    the step with the pyngp freeze toggles, and the parameters inference
    reads. A subclass builds it with ``_init_network`` and defines
    ``step_gradients(*batch) → (grads in param_list order, mean loss)``."""

    def _init_network(self, config: dict, n_input_dims: int, n_output_dims: int, seed: int,
                      default_loss: str, encoding=None) -> None:
        """The model (fresh weights from ``seed``), the loss, the optimizer and
        its state, the step count and the freeze toggles, from ``config``
        (its grid already autoconfigured). ``encoding``, where given, is the
        model's encoding (one the config alone cannot build: Takikawa's
        octree needs the mesh)."""
        if encoding is None:
            self.model = NetworkWithInputEncoding.from_config(config, n_input_dims, n_output_dims,
                                                              device=self.device)
        else:
            self.model = NetworkWithInputEncoding(
                encoding, mlp_from_config(config.get("network", {}), encoding.n_output_dims,
                                          n_output_dims, device=self.device))
        self.loss = loss_fn(loss_type_from_string(config.get("loss", {}).get("otype",
                                                                             default_loss)))
        self.model.init(torch.Generator(device=self.device).manual_seed(seed))
        names = {id(p): name for name, p in self.model.named_parameters()}
        self._param_names = [names[id(p)] for p in self.model.param_list()]
        self.opt = Optimizer(OptimizerSpec.from_config(config.get("optimizer", {})),
                             self.model.matrix_mask())
        self.opt_state = self.opt.init(self.model.param_list())
        self.training_step = 0
        # pyngp shall_train_encoding / shall_train_network freeze toggles
        self.shall_train_encoding = True
        self.shall_train_network = True

    def opt_state_tree(self) -> dict:
        """The optimizer state as the JAX package's tree of numpy arrays."""
        return state_to_tree(self.opt_state, lambda flat: tree_from_flat(self.model, flat))

    @torch.no_grad()
    def load_state(self, params: dict, opt_state: dict | None = None,
                   training_step: int = 0) -> None:
        """Load a snapshot's parameters, optimizer state (else a fresh one
        from the loaded parameters) and step, as the JAX package's
        ``Testbed.load_snapshot`` does for an image or an SDF
        (testbed.py:2224-2233). Trees are numpy trees in the JAX layout."""
        params_from_jax(self.model, params)
        if opt_state is None:
            self.opt_state = self.opt.init(self.model.param_list())
        else:
            self.opt_state = state_from_tree(
                opt_state, lambda tree: flat_from_tree(self.model, tree), self.device)
        self.training_step = int(training_step)

    @torch.no_grad()
    def train_step(self, *batch: torch.Tensor) -> torch.Tensor:
        """One step on a batch in place; returns the loss on the device. A
        frozen part takes no update, but Adam's moments advance, as in the
        JAX step."""
        grads, loss = self.step_gradients(*batch)
        params = self.model.param_list()
        n_net = len(self.model.network.weights)
        frozen = []
        if not self.shall_train_network:
            frozen += params[:n_net]
        if not self.shall_train_encoding:
            frozen += params[n_net:]
        kept = [p.clone() for p in frozen]
        self.opt.update(grads, self.opt_state, params)
        for p, k in zip(frozen, kept):
            p.copy_(k)
        return loss

    def inference_params(self) -> dict:
        """The parameters inference reads, by name, detached: the optimizer's
        parameter EMA where the config keeps one, else the model's own."""
        params = self.opt.inference_params(self.opt_state, self.model.param_list())
        return {name: p.detach() for name, p in zip(self._param_names, params)}
