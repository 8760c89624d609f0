"""NerfNetwork, the two-MLP NeRF model (port of
``instant_ngp_tpu/models/nerf_network.py``; reference nerf_network.h).

  pos ──HashGrid──▶ density MLP ──▶ 16-wide density output
                                      │ (channel 0 is the density logit)
  [density_out ⊕ SH(dir)] ──▶ RGB MLP ──▶ rgb (3)
  network output = (rgb0, rgb1, rgb2, density_logit)

Parameters move between the packages as numpy trees in the JAX layout:
``{"density_net": [W (in, out), …], "rgb_net": [...], "pos_enc": (table_l
(size_l, F), …)}`` (``params_from_jax`` / ``params_to_numpy``; a Composite
position encoding's ``pos_enc`` is a list of its nested trees, and an
encoding without parameters has none); the whole
training state, with the optimizer moments, the parameter EMA, the
occupancy grid and the error map, by ``train_state_from_jax`` /
``train_state_to_numpy``. In the port the parameters are one list,
``param_list()``, in the packing order [density_net, rgb_net, pos_enc
tables] (the direction encoding has none), and a grid's per-level tables are
one flat table.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops.encodings import (Composite, encoding_flat, encoding_from_config, encoding_tables,
                             encoding_tree, init_encoding, set_encoding_kernels)
from ..ops.mlp import MLP, mlp_from_config
from ..ops.optimizers import state_from_tree, state_to_tree


class NerfNetwork(nn.Module):
    def __init__(self, pos_encoding: nn.Module, dir_encoding: nn.Module,
                 density_network: MLP, rgb_network: MLP):
        super().__init__()
        self.pos_encoding = pos_encoding
        self.dir_encoding = dir_encoding
        self.density_network = density_network
        self.rgb_network = rgb_network

    def density(self, pos: torch.Tensor, max_level=None) -> torch.Tensor:
        """pos (N, 3) in [0, 1] → (N, 16) f32 density-MLP output; channel 0
        is the density logit."""
        return self.density_network(self.pos_encoding(pos, max_level=max_level))

    def forward(self, pos: torch.Tensor, dir_warped: torch.Tensor, max_level=None) -> torch.Tensor:
        """pos (N, 3) in [0, 1]; dir_warped (N, 3) in [0, 1] (warp_direction
        applied by the caller). Returns (N, 4) f32: rgb logits + density
        logit."""
        d_out = self.density(pos, max_level=max_level)
        rgb_in = torch.cat([d_out, self.dir_encoding(dir_warped)], dim=-1)
        rgb = self.rgb_network(rgb_in)
        return torch.cat([rgb[:, :3], d_out[:, :1]], dim=-1)

    def init(self, generator: torch.Generator) -> None:
        """Fresh weights in place: He-uniform MLPs, tables in ±1e-4."""
        self.density_network.init(generator)
        self.rgb_network.init(generator)
        init_encoding(self.pos_encoding, generator)

    def param_list(self) -> list[nn.Parameter]:
        """The trainable parameters in packing order [density_net, rgb_net,
        pos_enc tables]."""
        return [*self.density_network.weights, *self.rgb_network.weights,
                *encoding_tables(self.pos_encoding)]

    def matrix_mask(self) -> list[bool]:
        """True for the MLP matrices (l2_reg applies), False for tables."""
        n_matrices = len(self.density_network.weights) + len(self.rgb_network.weights)
        return [True] * n_matrices + [False] * len(encoding_tables(self.pos_encoding))

    def set_use_kernels(self, flag: bool) -> None:
        """Route the encoding and both MLPs through their CUDA kernels
        (True, the default) or their plain versions (the reference a
        kernel render is checked against on the card)."""
        set_encoding_kernels(self.pos_encoding, flag)
        self.density_network.use_kernel = flag
        self.rgb_network.use_kernel = flag

    @staticmethod
    def from_config(config: dict, n_extra_dims: int = 0, device=None) -> "NerfNetwork":
        """Build from the NeRF JSON schema (encoding/dir_encoding/network/
        rgb_network blocks)."""
        if n_extra_dims:
            raise NotImplementedError("per-image latent dims are not ported yet")
        pos_enc = encoding_from_config(config.get("encoding", {"otype": "HashGrid"}), 3,
                                       device=device)
        dir_enc = encoding_from_config(
            config.get("dir_encoding", {"otype": "SphericalHarmonics", "degree": 4}), 3,
            device=device)
        # density MLP: 16-wide output, first channel = density logit
        density_net = mlp_from_config(config.get("network", {}), pos_enc.n_output_dims, 16,
                                      device=device)
        rgb_net = mlp_from_config(config.get("rgb_network", {}), 16 + dir_enc.n_output_dims, 3,
                                  device=device)
        return NerfNetwork(pos_enc, dir_enc, density_net, rgb_net)


def params_to_numpy(model: NerfNetwork) -> dict:
    """The model's parameters as the JAX package's numpy tree."""
    return tree_from_flat(model, model.param_list())


def tree_from_flat(model: NerfNetwork, flat) -> dict:
    """A list in ``param_list`` order (the parameters, or an optimizer
    moment) as the JAX package's parameter tree of numpy arrays. A
    Composite direction encoding contributes its (parameter-free) leaves
    as None, as ``Composite.init`` does there.

    The tree's ``jax.tree.leaves`` order (``snapshot.tree_leaves``), which
    snapshots store optimizer states in: density_net's matrices,
    pos_enc's per-level tables, rgb_net's matrices (keys sorted; dir_enc's
    None leaves dropped). ``param_list`` order is [density_net, rgb_net,
    pos_enc tables], with a grid's levels in one flat table."""
    n_d = len(model.density_network.weights)
    n_r = len(model.rgb_network.weights)
    arrs = [t.detach().cpu().numpy() for t in flat]
    tree = {"density_net": arrs[:n_d], "rgb_net": arrs[n_d:n_d + n_r]}
    pos = encoding_tree(model.pos_encoding, arrs[n_d + n_r:])
    if pos is not None:
        tree["pos_enc"] = pos
    if isinstance(model.dir_encoding, Composite):
        tree["dir_enc"] = [None] * len(model.dir_encoding.nested)
    return tree


@torch.no_grad()
def params_from_jax(model: NerfNetwork, tree: dict) -> NerfNetwork:
    """Load the JAX package's parameter tree (numpy arrays) into ``model``
    in place and return it. Shapes must match the model exactly."""
    for key, mlp in (("density_net", model.density_network), ("rgb_net", model.rgb_network)):
        ws = tree[key]
        if len(ws) != len(mlp.weights):
            raise ValueError(f"{key}: {len(ws)} matrices for {len(mlp.weights)} layers")
        for dst, src in zip(mlp.weights, ws):
            src = np.array(src, np.float32)  # a writable copy: JAX arrays are read-only
            if src.shape != tuple(dst.shape):
                raise ValueError(f"{key}: matrix {src.shape} for layer {tuple(dst.shape)}")
            dst.copy_(torch.from_numpy(src))
    tables = encoding_tables(model.pos_encoding)
    flat = encoding_flat(model.pos_encoding, tree.get("pos_enc"))
    if [a.shape for a in flat] != [tuple(t.shape) for t in tables]:
        raise ValueError(f"pos_enc: tables {[a.shape for a in flat]} for "
                         f"{[tuple(t.shape) for t in tables]}")
    for dst, src in zip(tables, flat):
        dst.copy_(torch.from_numpy(src))
    dir_leaves = tree.get("dir_enc")
    if dir_leaves is not None and any(leaf is not None for leaf in dir_leaves):
        raise NotImplementedError("parametric direction encodings are not ported yet")
    return model


def flat_from_tree(model: NerfNetwork, tree: dict) -> list[np.ndarray]:
    """A JAX parameter-shaped tree (params, or an optimizer moment) as
    numpy arrays in ``param_list`` order."""
    flat = [np.asarray(w, np.float32) for w in tree["density_net"]]
    flat += [np.asarray(w, np.float32) for w in tree["rgb_net"]]
    flat += encoding_flat(model.pos_encoding, tree.get("pos_enc"))
    shapes = [tuple(p.shape) for p in model.param_list()]
    if [a.shape for a in flat] != shapes:
        raise ValueError(f"tree shapes {[a.shape for a in flat]} do not match the model {shapes}")
    return flat


@torch.no_grad()
def train_state_from_jax(model: NerfNetwork, state, jax_state) -> None:
    """Copy a JAX ``NerfTrainState`` (or a tree of the same fields with
    numpy leaves) into the port's model and training ``state``: params in
    place; Adam m/v/step and the parameter EMA as a new optimizer state;
    the occupancy grid's density, mean and update count, and the error map.
    The bitfield and skip chain are derived again from the density."""
    get = (lambda o, k: o[k]) if isinstance(jax_state, dict) else getattr
    params_from_jax(model, get(jax_state, "params"))
    state.opt_state = state_from_tree(get(jax_state, "opt_state"),
                                      lambda tree: flat_from_tree(model, tree),
                                      model.density_network.weights[0].device)
    grid = get(jax_state, "grid")
    state.grid.set_density(torch.from_numpy(np.array(get(grid, "density"), np.float32)),
                           float(np.asarray(get(grid, "mean_density"))),
                           int(np.asarray(get(grid, "ema_step"))))
    state.error_map.copy_(torch.from_numpy(np.asarray(get(jax_state, "error_map"), np.float32)))


def train_state_to_numpy(model: NerfNetwork, state) -> dict:
    """The port's training state as numpy trees in the JAX layout (the
    inverse of ``train_state_from_jax``, for the tests)."""
    return {
        "params": params_to_numpy(model),
        "opt_state": state_to_tree(state.opt_state, lambda flat: tree_from_flat(model, flat)),
        "grid": {"density": state.grid.density.cpu().numpy(),
                 "mean_density": np.float32(state.grid.mean_density.cpu()),
                 "ema_step": np.int32(state.grid.ema_step)},
        "error_map": state.error_map.cpu().numpy(),
    }
