"""NerfNetwork, the two-MLP NeRF model (port of
``instant_ngp_tpu/models/nerf_network.py``; reference nerf_network.h).

  pos ──HashGrid──▶ density MLP ──▶ 16-wide density output
                                      │ (channel 0 is the density logit)
  [density_out ⊕ SH(dir)] ──▶ RGB MLP ──▶ rgb (3)
  network output = (rgb0, rgb1, rgb2, density_logit)

Parameters move between the packages as numpy trees in the JAX layout:
``{"density_net": [W (in, out), …], "rgb_net": [...], "pos_enc": (table_l
(size_l, F), …)}`` (``params_from_jax`` / ``params_to_numpy``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops.encodings import Composite, encoding_from_config
from ..ops.hashgrid import GridEncoding
from ..ops.mlp import MLP, mlp_from_config


class NerfNetwork(nn.Module):
    def __init__(self, pos_encoding: GridEncoding, dir_encoding: nn.Module,
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

    def set_use_kernels(self, flag: bool) -> None:
        """Route the encoding and both MLPs through their CUDA kernels
        (True, the default) or their plain versions (the reference a
        kernel render is checked against on the card)."""
        for m in (self.pos_encoding, self.density_network, self.rgb_network):
            m.use_kernel = flag

    @staticmethod
    def from_config(config: dict, n_extra_dims: int = 0, device=None) -> "NerfNetwork":
        """Build from the NeRF JSON schema (encoding/dir_encoding/network/
        rgb_network blocks)."""
        if n_extra_dims:
            raise NotImplementedError("per-image latent dims are not ported yet")
        pos_enc = encoding_from_config(config.get("encoding", {"otype": "HashGrid"}), 3,
                                       device=device)
        if not isinstance(pos_enc, GridEncoding):
            raise NotImplementedError("only a grid position encoding is ported")
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
    """The model's parameters as the JAX package's numpy tree. A Composite
    direction encoding contributes its (parameter-free) leaves as None,
    as ``Composite.init`` does there."""
    tree = {
        "density_net": [w.detach().cpu().numpy() for w in model.density_network.weights],
        "rgb_net": [w.detach().cpu().numpy() for w in model.rgb_network.weights],
        "pos_enc": tuple(t.detach().cpu().numpy() for t in model.pos_encoding.unpack_params()),
    }
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
            src = np.asarray(src, np.float32)
            if src.shape != tuple(dst.shape):
                raise ValueError(f"{key}: matrix {src.shape} for layer {tuple(dst.shape)}")
            dst.copy_(torch.from_numpy(src))
    tables = tree["pos_enc"]
    levels = model.pos_encoding.levels
    if len(tables) != len(levels):
        raise ValueError(f"pos_enc: {len(tables)} tables for {len(levels)} levels")
    for dst, src in zip(model.pos_encoding.unpack_params(), tables):
        src = np.asarray(src, np.float32)
        if src.shape != tuple(dst.shape):
            raise ValueError(f"pos_enc: table {src.shape} for level {tuple(dst.shape)}")
        dst.copy_(torch.from_numpy(src))
    dir_leaves = tree.get("dir_enc")
    if dir_leaves is not None and any(leaf is not None for leaf in dir_leaves):
        raise NotImplementedError("parametric direction encodings are not ported yet")
    return model
