"""Elementwise losses of the NeRF step (port of the L2 and Huber parts of
``instant_ngp_tpu/ops/losses.py``; reference nerf_device.cuh:75-143).

Huber follows the reference's /5 convention (nerf_device.cuh:607-612):
Huber is divided by 5 so its quadratic region matches L2 and a converged
loss in dB reads approximately as PSNR. Reductions happen at call sites.
"""

from __future__ import annotations

import torch

from ..common import LossType

HUBER_ALPHA = 0.1


def l2(target: torch.Tensor, prediction: torch.Tensor) -> torch.Tensor:
    d = prediction - target
    return d * d


def huber(target: torch.Tensor, prediction: torch.Tensor,
          alpha: float = HUBER_ALPHA) -> torch.Tensor:
    d = prediction - target
    ad = torch.abs(d)
    return torch.where(ad > alpha, ad - 0.5 * alpha, 0.5 / alpha * d * d)


def loss_fn(loss_type: LossType):
    """The elementwise loss of a type, Huber with the /5 scaling. The other
    five loss types of the JAX package are not ported yet."""
    if loss_type == LossType.HUBER:
        return lambda t, p: huber(t, p, HUBER_ALPHA) / 5.0
    if loss_type == LossType.L2:
        return l2
    raise NotImplementedError(f"loss {loss_type.value} is not ported yet")


def loss_type_from_string(name: str) -> LossType:
    name = (name or "L2").lower()
    aliases = {
        "l2": LossType.L2,
        "relativel2": LossType.RELATIVE_L2,
        "l1": LossType.L1,
        "mape": LossType.MAPE,
        "smape": LossType.SMAPE,
        "huber": LossType.HUBER,
        "smoothl1": LossType.HUBER,
        "logl1": LossType.LOGL1,
    }
    return aliases.get(name, LossType.L2)
