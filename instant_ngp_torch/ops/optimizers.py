"""Optimizer of the tcnn JSON schema (port of the Adam part of
``instant_ngp_tpu/ops/optimizers.py``): the nested ``Ema →
ExponentialDecay → Adam`` chain of configs/nerf/base.json:5-22, Adam with
``l2_reg`` on matrix parameters and a tiny ``epsilon`` (1e-15), the
exponential learning-rate decay, and an EMA of the parameters that
rendering reads.

Plain PyTorch over the parameter list, updated in place, in the JAX
package's order of operations. The state is a dict ``{"step": int, "m":
[...], "v": [...], "ema": [...]}``; the step is a host integer, so the
learning rate and the bias corrections are host f32 scalars and an update
needs no device read. ``state_to_tree`` / ``state_from_tree`` carry a state
to and from the JAX package's tree of numpy arrays (snapshots, tests).
Shampoo is not ported yet. ``camera_optimizer`` is the NeRF camera
offsets' Adam (``instant_ngp_tpu/nerf/task.py:287-293``), over the offsets'
tensors in sorted-key order, the JAX tree's leaf order.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass
class OptimizerSpec:
    otype: str = "Adam"
    learning_rate: float = 1e-2
    beta1: float = 0.9
    beta2: float = 0.99
    epsilon: float = 1e-15
    l2_reg: float = 0.0
    ema_decay: Optional[float] = None  # parameter EMA (None: off)
    decay_start: Optional[int] = None  # ExponentialDecay (None: constant rate)
    decay_interval: int = 10000
    decay_end: Optional[int] = None
    decay_base: float = 0.33

    @staticmethod
    def from_config(cfg: dict) -> "OptimizerSpec":
        """Walk the nested otype chain collecting the wrappers' settings."""
        spec = OptimizerSpec()
        node = cfg
        while node:
            otype = str(node.get("otype", "Adam")).lower()
            if otype == "ema":
                spec.ema_decay = float(node.get("decay", 0.99))
            elif otype == "exponentialdecay":
                spec.decay_start = int(node.get("decay_start", 0))
                spec.decay_interval = int(node.get("decay_interval", 10000))
                spec.decay_base = float(node.get("decay_base", 0.33))
                if "decay_end" in node:
                    spec.decay_end = int(node["decay_end"])
            else:
                spec.otype = node.get("otype", "Adam")
                if otype == "shampoo":
                    raise NotImplementedError("the Shampoo optimizer is not ported yet")
                if otype != "adam":
                    warnings.warn(f"optimizer otype '{spec.otype}' is not implemented; "
                                  "falling back to Adam with the shared hyperparameters")
                    spec.otype = "Adam"
                spec.learning_rate = float(node.get("learning_rate", 1e-2))
                spec.beta1 = float(node.get("beta1", 0.9))
                spec.beta2 = float(node.get("beta2", 0.99))
                spec.epsilon = float(node.get("epsilon", 1e-8))
                spec.l2_reg = float(node.get("l2_reg", 0.0))
                break
            node = node.get("nested", {})
        return spec


class Optimizer:
    """Adam with optional ExponentialDecay and parameter EMA."""

    def __init__(self, spec: OptimizerSpec, matrix_mask: Sequence[bool]):
        """matrix_mask: per parameter, True where l2_reg applies (the MLP
        matrices, tcnn's optimize_matrix_params)."""
        self.spec = spec
        self.matrix_mask = list(matrix_mask)

    @torch.no_grad()
    def init(self, params: Sequence[torch.Tensor]) -> dict:
        state = {"step": 0,
                 "m": [torch.zeros_like(p) for p in params],
                 "v": [torch.zeros_like(p) for p in params]}
        if self.spec.ema_decay is not None:
            state["ema"] = [p.detach().clone() for p in params]
        return state

    def learning_rate_at(self, step: int) -> float:
        """tcnn exponential_decay: base · decay_base^n with n = 0 before
        decay_start, then 1 + ⌊(step − start) / interval⌋ (capped at
        decay_end), in f32."""
        s = self.spec
        f32 = np.float32
        if s.decay_start is None:
            return float(f32(s.learning_rate))
        eff = max(float(step) - s.decay_start, 0.0)
        if s.decay_end is not None:
            eff = min(eff, float(s.decay_end - s.decay_start))
        started = 1.0 if step >= s.decay_start else 0.0
        n_decays = f32(np.floor(f32(eff) / f32(s.decay_interval)) + started)
        return float(f32(s.learning_rate) * np.power(f32(s.decay_base), n_decays))

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], state: dict,
               params: Sequence[torch.Tensor]) -> None:
        """One Adam step of every parameter in place, then the EMA."""
        s = self.spec
        f32 = np.float32
        step = state["step"] + 1
        lr = self.learning_rate_at(state["step"])
        b1, b2 = float(f32(s.beta1)), float(f32(s.beta2))
        bias1 = float(f32(1.0) - np.power(f32(s.beta1), f32(step)))
        bias2 = float(f32(1.0) - np.power(f32(s.beta2), f32(step)))
        for g, m, v, p, is_matrix in zip(grads, state["m"], state["v"], params,
                                         self.matrix_mask):
            g = g.to(torch.float32)
            if s.l2_reg and is_matrix:
                g = g + s.l2_reg * p
            m.mul_(b1).add_((1.0 - s.beta1) * g)
            v.mul_(b2).add_((1.0 - s.beta2) * g * g)
            p.sub_(lr * (m / bias1) / (torch.sqrt(v / bias2) + s.epsilon))
        state["step"] = step
        if s.ema_decay is not None:
            d = s.ema_decay
            for e, p in zip(state["ema"], params):
                e.mul_(d).add_((1.0 - d) * p)

    def inference_params(self, state: dict, params: Sequence[torch.Tensor]):
        """The parameters rendering reads: the EMA if enabled."""
        if self.spec.ema_decay is not None and "ema" in state:
            return state["ema"]
        return list(params)


# the camera leaves extrinsic_l2_reg applies to: the reference regularizes per
# group (testbed.h:785-789); exposure and focal take their own decoupled decay
CAMERA_L2_KEYS = ("rot", "pos")


def camera_optimizer_spec() -> OptimizerSpec:
    """The camera offsets' Adam: rate 1e-4, β 0.9 / 0.99, ε 1e-8, the rate
    ×0.33 every 2,048 steps from step 0, l2_reg (``extrinsic_l2_reg``) 0."""
    return OptimizerSpec(learning_rate=1e-4, beta1=0.9, beta2=0.99, epsilon=1e-8, l2_reg=0.0,
                         decay_start=0, decay_interval=2048, decay_base=0.33)


def camera_optimizer(spec: OptimizerSpec, keys: Sequence[str]) -> Optimizer:
    """Adam over the camera tensors named ``keys``, in that order, with
    l2_reg on rot and pos only."""
    return Optimizer(spec, [k in CAMERA_L2_KEYS for k in keys])


STATE_KEYS = ("m", "v", "ema")


def state_to_tree(state: dict, to_tree: Callable) -> dict:
    """The state as the JAX package's optimizer-state tree of numpy arrays:
    ``step`` an int32 scalar, and m, v and (where kept) ema each through
    ``to_tree``, the model's converter from a ``param_list``-ordered list to
    its JAX parameter tree. Its ``jax.tree.leaves`` order is ema, m, step, v
    (keys sorted), each moment in its parameter tree's order."""
    tree = {"step": np.int32(state["step"])}
    for key in STATE_KEYS:
        if key in state:
            tree[key] = to_tree(state[key])
    return tree


def state_from_tree(tree: dict, to_flat: Callable, device) -> dict:
    """The inverse of ``state_to_tree``: ``to_flat`` turns a JAX parameter
    tree into numpy arrays in ``param_list`` order."""
    state = {"step": int(np.asarray(tree["step"]))}
    for key in STATE_KEYS:
        if key in tree:
            state[key] = [torch.tensor(a, device=device) for a in to_flat(tree[key])]
    return state
