"""Optimizer of the tcnn JSON schema (port of
``instant_ngp_tpu/ops/optimizers.py``): the nested ``Ema →
ExponentialDecay → Adam | Shampoo`` chain of configs/nerf/base.json:5-22,
Adam with ``l2_reg`` on matrix parameters and a tiny ``epsilon`` (1e-15),
the exponential learning-rate decay, and an EMA of the parameters that
rendering reads. Shampoo (tcnn optimizers/shampoo.h, Gupta et al. 2018)
preconditions each MLP matrix G with L^{-1/4} G R^{-1/4} of its Kronecker
statistics (``torch.linalg.eigh``, as the JAX package's XLA composition),
the step grafted to Adam's norm; the hash tables take Adam.

Plain PyTorch over the parameter list, updated in place, in the JAX
package's order of operations. The state is a dict ``{"step": int, "m":
[...], "v": [...], "ema": [...]}``, with Shampoo's ``"L"``, ``"R"`` (an (n,
n) statistic a matrix, a (1, 1) zero placeholder a table, as the JAX state
keeps them) and ``"pm"`` (the preconditioned step's momentum); the step is
a host integer, so the learning rate and the bias corrections are host f32
scalars and an update needs no device read. ``state_to_tree`` /
``state_from_tree`` carry a state to and from the JAX package's tree of
numpy arrays (snapshots, tests). ``camera_optimizer`` is the NeRF camera
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
    # Shampoo's knobs (tcnn optimizers/shampoo.h's names); an Adam config
    # may carry them, and stays Adam
    beta3: float = 0.9  # momentum of the preconditioned step
    beta_shampoo: float = 1.0  # the Shampoo step's share against Adam's
    identity: float = 1e-4  # added to the statistics' diagonal
    cg_on_momentum: bool = False  # precondition Adam's momentum, not the gradient
    frobenius_normalization: bool = True  # the step's norm grafted to Adam's

    @property
    def is_shampoo(self) -> bool:
        return str(self.otype).lower() == "shampoo"

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
                if otype not in ("adam", "shampoo"):
                    warnings.warn(f"optimizer otype '{spec.otype}' is not implemented; "
                                  "falling back to Adam with the shared hyperparameters")
                    spec.otype = "Adam"
                spec.learning_rate = float(node.get("learning_rate", 1e-2))
                spec.beta1 = float(node.get("beta1", 0.9))
                spec.beta2 = float(node.get("beta2", 0.99))
                spec.epsilon = float(node.get("epsilon", 1e-8))
                spec.l2_reg = float(node.get("l2_reg", 0.0))
                spec.beta3 = float(node.get("beta3", 0.9))
                spec.beta_shampoo = float(node.get("beta_shampoo", 1.0))
                spec.identity = float(node.get("identity", 1e-4))
                spec.cg_on_momentum = bool(node.get("cg_on_momentum", False))
                spec.frobenius_normalization = bool(node.get("frobenius_normalization", True))
                break
            node = node.get("nested", {})
        return spec


class Optimizer:
    """Adam or Shampoo with optional ExponentialDecay and parameter EMA."""

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
        if self.spec.is_shampoo:
            for key, side in (("L", 0), ("R", 1)):
                state[key] = [torch.zeros((p.shape[side],) * 2 if self._shampooed(p, im)
                                          else (1, 1), dtype=torch.float32, device=p.device)
                              for p, im in zip(params, self.matrix_mask)]
            state["pm"] = [torch.zeros_like(p) for p in params]
        return state

    def _shampooed(self, p: torch.Tensor, is_matrix: bool) -> bool:
        return self.spec.is_shampoo and is_matrix and p.ndim == 2

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
        """One Adam (or Shampoo) step of every parameter in place, then the
        EMA."""
        s = self.spec
        f32 = np.float32
        step = state["step"] + 1
        lr = self.learning_rate_at(state["step"])
        b1, b2 = float(f32(s.beta1)), float(f32(s.beta2))
        bias1 = float(f32(1.0) - np.power(f32(s.beta1), f32(step)))
        bias2 = float(f32(1.0) - np.power(f32(s.beta2), f32(step)))
        for i, (g, m, v, p, is_matrix) in enumerate(zip(grads, state["m"], state["v"], params,
                                                        self.matrix_mask)):
            g = g.to(torch.float32)
            if s.l2_reg and is_matrix:
                g = g + s.l2_reg * p
            m.mul_(b1).add_((1.0 - s.beta1) * g)
            v.mul_(b2).add_((1.0 - s.beta2) * g * g)
            adam_step = (m / bias1) / (torch.sqrt(v / bias2) + s.epsilon)
            if self._shampooed(p, is_matrix):
                adam_step = self._shampoo_step(g, m, adam_step, state, i, step, bias1)
            p.sub_(lr * adam_step)
        state["step"] = step
        if s.ema_decay is not None:
            d = s.ema_decay
            for e, p in zip(state["ema"], params):
                e.mul_(d).add_((1.0 - d) * p)

    def _shampoo_step(self, g, m, adam_step, state: dict, i: int, step: int,
                      bias1: float) -> torch.Tensor:
        """The step direction of matrix i (instant_ngp_tpu/ops/optimizers.py:
        173-206): the Kronecker statistics L += g gᵀ, R += gᵀ g (β2 EMAs),
        the gradient (or Adam's momentum) preconditioned by L^{-1/4} ·
        R^{-1/4}, its β3 momentum bias-corrected, grafted to Adam's step's
        Frobenius norm and mixed with it by ``beta_shampoo``."""
        s = self.spec
        L, R, pm = state["L"][i], state["R"][i], state["pm"][i]
        L.mul_(float(np.float32(s.beta2))).add_((1.0 - s.beta2) * (g @ g.T))
        R.mul_(float(np.float32(s.beta2))).add_((1.0 - s.beta2) * (g.T @ g))
        src = m / bias1 if s.cg_on_momentum else g
        pre = self._inv_quarter_root(L) @ src @ self._inv_quarter_root(R)
        pm.mul_(s.beta3).add_((1.0 - s.beta3) * pre)
        shampoo = pm / float(np.float32(1.0) - np.power(np.float32(s.beta3), np.float32(step)))
        if s.frobenius_normalization:
            shampoo = shampoo * (torch.linalg.vector_norm(adam_step)
                                 / torch.clamp(torch.linalg.vector_norm(shampoo), min=1e-12))
        return s.beta_shampoo * shampoo + (1.0 - s.beta_shampoo) * adam_step

    def _inv_quarter_root(self, A: torch.Tensor) -> torch.Tensor:
        """(A + identity·I)^{-1/4} through its eigendecomposition, the
        eigenvalues floored at ``identity``."""
        eye = torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
        w, V = torch.linalg.eigh(A + self.spec.identity * eye)
        w = torch.clamp(w, min=self.spec.identity)
        return (V * torch.pow(w, -0.25)[None, :]) @ V.T

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


STATE_KEYS = ("m", "v", "ema", "pm")
STAT_KEYS = ("L", "R")  # Shampoo's statistics: (n, n) a matrix, (1, 1) a table
# the keys of the JAX parameter trees that hold the MLP matrices, which come
# first in a model's param_list
MATRIX_KEYS = ("density_net", "rgb_net", "net")


def _placeholders(tree):
    """``tree`` with every array leaf a (1, 1) f32 zero."""
    if isinstance(tree, dict):
        return {k: _placeholders(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_placeholders(v) for v in tree)
    return None if tree is None else np.zeros((1, 1), np.float32)


def state_to_tree(state: dict, to_tree: Callable) -> dict:
    """The state as the JAX package's optimizer-state tree of numpy arrays:
    ``step`` an int32 scalar, and m, v and (where kept) ema and Shampoo's pm
    each through ``to_tree``, the model's converter from a
    ``param_list``-ordered list to its JAX parameter tree; Shampoo's L and
    R in that tree's form, the matrices' statistics under the MLP keys and a
    (1, 1) zero for every other leaf. Its ``jax.tree.leaves`` order is its
    keys sorted, each in its parameter tree's order."""
    tree = {"step": np.int32(state["step"])}
    for key in STATE_KEYS:
        if key in state:
            tree[key] = to_tree(state[key])
    for key in STAT_KEYS:
        if key in state:
            shape_tree = to_tree(state["m"])
            stats = iter(t.detach().cpu().numpy() for t in state[key])
            tree[key] = {k: ([next(stats) for _ in v] if k in MATRIX_KEYS else _placeholders(v))
                         for k, v in shape_tree.items()}
    return tree


def state_from_tree(tree: dict, to_flat: Callable, device) -> dict:
    """The inverse of ``state_to_tree``: ``to_flat`` turns a JAX parameter
    tree into numpy arrays in ``param_list`` order."""
    state = {"step": int(np.asarray(tree["step"]))}
    for key in STATE_KEYS:
        if key in tree:
            state[key] = [torch.tensor(a, device=device) for a in to_flat(tree[key])]
    for key in STAT_KEYS:
        if key in tree:
            mats = [np.asarray(a, np.float32) for k in MATRIX_KEYS for a in tree[key].get(k, ())]
            n_tables = len(state["m"]) - len(mats)
            state[key] = [torch.tensor(a, device=device)
                          for a in mats + [np.zeros((1, 1), np.float32)] * n_tables]
    return state
