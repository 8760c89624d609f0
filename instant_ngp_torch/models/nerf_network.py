"""NerfNetwork, the two-MLP NeRF model (port of
``instant_ngp_tpu/models/nerf_network.py``; reference nerf_network.h).

  pos ──HashGrid──▶ density MLP ──▶ 16-wide density output
                                      │ (channel 0 is the density logit)
  [density_out ⊕ SH(dir) ⊕ extra] ──▶ RGB MLP ──▶ rgb (3)
  network output = (rgb0, rgb1, rgb2, density_logit)

Parameters move between the packages as numpy trees in the JAX layout:
``{"density_net": [W (in, out), …], "rgb_net": [...], "pos_enc": (table_l
(size_l, F), …), "dir_enc": ...}`` (``params_from_jax`` /
``params_to_numpy``; a Composite encoding's tree is a list of its nested
trees, and an encoding without parameters has none); the whole training
state, with the optimizer moments, the parameter EMA, the occupancy grid and
the error map, by ``train_state_from_jax`` / ``train_state_to_numpy``. In
the port the parameters are one list, ``param_list()``, in tcnn's packing
order [density_net, rgb_net, pos_enc tables, dir_enc tables] (a parametric
direction encoding, such as a grid, has tables; SH has none), and a grid's
per-level tables are one flat table. ``n_extra_dims`` per-image latent dims
(the camera state's ``extra``, ``nerf/task.py``) join the rgb MLP's input
after the direction encoding: its input is 16 + 16 + E wide with SH.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops.encodings import (encoding_flat, encoding_from_config, encoding_tables,
                             encoding_tree, init_encoding, set_encoding_kernels)
from ..ops.hashgrid import GridEncoding
from ..ops.mlp import MLP, mlp_from_config
from ..ops.optimizers import state_from_tree, state_to_tree


class NerfNetwork(nn.Module):
    def __init__(self, pos_encoding: nn.Module, dir_encoding: nn.Module,
                 density_network: MLP, rgb_network: MLP, n_extra_dims: int = 0):
        super().__init__()
        self.pos_encoding = pos_encoding
        self.dir_encoding = dir_encoding
        self.density_network = density_network
        self.rgb_network = rgb_network
        self.n_extra_dims = n_extra_dims

    def density(self, pos: torch.Tensor, max_level=None, fast: bool = False,
                f32_dw: bool = False) -> torch.Tensor:
        """pos (N, 3) in [0, 1] → (N, 16) f32 density-MLP output; channel 0
        is the density logit. ``fast`` (a render's ``render_quality="fast"``,
        nerf_network.py:80-111): a grid encoding reads one stochastic corner
        a hashed level; other encodings encode as always. ``f32_dw``: see
        ``MLP.forward``."""
        if fast and isinstance(self.pos_encoding, GridEncoding):
            feats = self.pos_encoding.encode_stochastic(pos, max_level=max_level)
        else:
            feats = self.pos_encoding(pos, max_level=max_level)
        return self.density_network(feats, f32_dw)

    def forward(self, pos: torch.Tensor, dir_warped: torch.Tensor, extra=None, max_level=None,
                fast: bool = False, f32_dw: bool = False) -> torch.Tensor:
        """pos (N, 3) in [0, 1]; dir_warped (N, 3) in [0, 1] (warp_direction
        applied by the caller); extra (N, E) latent dims, zeros where the
        model has them and none are given. Returns (N, 4) f32: rgb logits +
        density logit."""
        d_out = self.density(pos, max_level=max_level, fast=fast, f32_dw=f32_dw)
        inputs = [d_out, self.dir_encoding(dir_warped)]
        if self.n_extra_dims > 0:
            if extra is None:
                extra = torch.zeros((pos.shape[0], self.n_extra_dims), dtype=torch.float32,
                                    device=pos.device)
            inputs.append(extra.to(torch.float32))
        rgb_in = torch.cat(inputs, dim=-1)
        rgb = self.rgb_network(rgb_in, f32_dw)
        return torch.cat([rgb[:, :3], d_out[:, :1]], dim=-1)

    def init(self, generator: torch.Generator) -> None:
        """Fresh weights in place: He-uniform MLPs, tables in ±1e-4."""
        self.density_network.init(generator)
        self.rgb_network.init(generator)
        init_encoding(self.pos_encoding, generator)
        init_encoding(self.dir_encoding, generator)

    def param_list(self) -> list[nn.Parameter]:
        """The trainable parameters in packing order [density_net, rgb_net,
        pos_enc tables, dir_enc tables]."""
        return [*self.density_network.weights, *self.rgb_network.weights,
                *encoding_tables(self.pos_encoding), *encoding_tables(self.dir_encoding)]

    def matrix_mask(self) -> list[bool]:
        """True for the MLP matrices (l2_reg applies, Shampoo preconditions
        them), False for tables."""
        n_matrices = len(self.density_network.weights) + len(self.rgb_network.weights)
        n_tables = len(encoding_tables(self.pos_encoding)) + len(encoding_tables(self.dir_encoding))
        return [True] * n_matrices + [False] * n_tables

    def set_use_kernels(self, flag: bool) -> None:
        """Route the encoding and both MLPs through their CUDA kernels
        (True, the default) or their plain versions (the reference a
        kernel render is checked against on the card)."""
        set_encoding_kernels(self.pos_encoding, flag)
        set_encoding_kernels(self.dir_encoding, flag)
        self.density_network.use_kernel = flag
        self.rgb_network.use_kernel = flag

    @staticmethod
    def from_config(config: dict, n_extra_dims: int = 0, device=None) -> "NerfNetwork":
        """Build from the NeRF JSON schema (encoding/dir_encoding/network/
        rgb_network blocks); the rgb MLP takes n_extra_dims more inputs."""
        pos_enc = encoding_from_config(config.get("encoding", {"otype": "HashGrid"}), 3,
                                       device=device)
        dir_enc = encoding_from_config(
            config.get("dir_encoding", {"otype": "SphericalHarmonics", "degree": 4}), 3,
            device=device)
        # density MLP: 16-wide output, first channel = density logit
        density_net = mlp_from_config(config.get("network", {}), pos_enc.n_output_dims, 16,
                                      device=device)
        rgb_net = mlp_from_config(config.get("rgb_network", {}),
                                  16 + dir_enc.n_output_dims + n_extra_dims, 3, device=device)
        return NerfNetwork(pos_enc, dir_enc, density_net, rgb_net, n_extra_dims)


def params_to_numpy(model: NerfNetwork) -> dict:
    """The model's parameters as the JAX package's numpy tree."""
    return tree_from_flat(model, model.param_list())


def tree_from_flat(model: NerfNetwork, flat) -> dict:
    """A list in ``param_list`` order (the parameters, or an optimizer
    moment) as the JAX package's parameter tree of numpy arrays. A
    Composite direction encoding without parameters contributes its leaves
    as None, as ``Composite.init`` does there.

    The tree's ``jax.tree.leaves`` order (``snapshot.tree_leaves``), which
    snapshots store optimizer states in: density_net's matrices, dir_enc's
    tables, pos_enc's per-level tables, rgb_net's matrices (keys sorted;
    None leaves dropped). ``param_list`` order is [density_net, rgb_net,
    pos_enc tables, dir_enc tables], with a grid's levels in one flat
    table."""
    n_d = len(model.density_network.weights)
    n_r = len(model.rgb_network.weights)
    arrs = [t.detach().cpu().numpy() for t in flat]
    tree = {"density_net": arrs[:n_d], "rgb_net": arrs[n_d:n_d + n_r]}
    rest = arrs[n_d + n_r:]
    pos = encoding_tree(model.pos_encoding, rest)
    if pos is not None:
        tree["pos_enc"] = pos
    dir_tree = encoding_tree(model.dir_encoding, rest)
    if dir_tree is not None:
        tree["dir_enc"] = dir_tree
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
    dir_tables = encoding_tables(model.dir_encoding)
    dir_flat = encoding_flat(model.dir_encoding, tree.get("dir_enc")) if dir_tables else []
    if [a.shape for a in dir_flat] != [tuple(t.shape) for t in dir_tables]:
        raise ValueError(f"dir_enc: tables {[a.shape for a in dir_flat]} for "
                         f"{[tuple(t.shape) for t in dir_tables]}")
    for dst, src in zip(dir_tables, dir_flat):
        dst.copy_(torch.from_numpy(src))
    return model


def flat_from_tree(model: NerfNetwork, tree: dict) -> list[np.ndarray]:
    """A JAX parameter-shaped tree (params, or an optimizer moment) as
    numpy arrays in ``param_list`` order."""
    flat = [np.asarray(w, np.float32) for w in tree["density_net"]]
    flat += [np.asarray(w, np.float32) for w in tree["rgb_net"]]
    flat += encoding_flat(model.pos_encoding, tree.get("pos_enc"))
    if encoding_tables(model.dir_encoding):
        flat += encoding_flat(model.dir_encoding, tree.get("dir_enc"))
    shapes = [tuple(p.shape) for p in model.param_list()]
    if [a.shape for a in flat] != shapes:
        raise ValueError(f"tree shapes {[a.shape for a in flat]} do not match the model {shapes}")
    return flat


@torch.no_grad()
def train_state_from_jax(model: NerfNetwork, state, jax_state) -> None:
    """Copy a JAX ``NerfTrainState`` (or a tree of the same fields with
    numpy leaves) into the port's model and training ``state``: params in
    place; Adam m/v/step and the parameter EMA as a new optimizer state;
    the occupancy grid's density, mean and update count, the error map, and
    the camera offsets with their optimizer's state. The bitfield and skip
    chain are derived again from the density."""
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
    def field(k):
        return jax_state.get(k) if isinstance(jax_state, dict) else getattr(jax_state, k, None)

    cam, cam_opt = field("cam"), field("cam_opt")
    device = state.error_map.device
    if cam is not None:
        state.cam = {k: torch.tensor(np.asarray(v, np.float32), device=device)
                     for k, v in cam.items()}
    if cam_opt is not None:
        keys = sorted(state.cam)
        state.cam_opt = state_from_tree(
            cam_opt, lambda tree: [np.asarray(tree[k], np.float32) for k in keys], device)


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
        "cam": {k: v.detach().cpu().numpy() for k, v in state.cam.items()},
        **({"cam_opt": state_to_tree(state.cam_opt, lambda flat: {
            k: t.detach().cpu().numpy() for k, t in zip(sorted(state.cam), flat)})}
           if state.cam_opt is not None else {}),
    }
