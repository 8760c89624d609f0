"""Elementwise losses (port of ``instant_ngp_tpu/ops/losses.py``; reference
nerf_device.cuh:75-143 and the tcnn losses the configs name): L2, L1,
Huber, MAPE, SMAPE, LogL1 and RelativeL2, with the JAX package's
stop-gradients (MAPE and SMAPE stop the prediction in their denominators;
SMAPE's denominator also holds the target, which is not stopped).

Huber follows the reference's /5 convention (nerf_device.cuh:607-612):
Huber is divided by 5 so its quadratic region matches L2 and a converged
loss in dB reads approximately as PSNR. Reductions happen at call sites.

``loss_and_grads`` gives a loss's value and its derivatives with respect to
the prediction and the target, elementwise, as JAX's autodiff forms them
(the slope of |x| is +1 at 0): the NeRF step's composite (kernel G and its
plain version in ``nerf/train.py``) takes them analytically.
"""

from __future__ import annotations

import torch

from ..common import LossType

HUBER_ALPHA = 0.1


def l2(target: torch.Tensor, prediction: torch.Tensor) -> torch.Tensor:
    d = prediction - target
    return d * d


def relative_l2(target: torch.Tensor, prediction: torch.Tensor) -> torch.Tensor:
    d = prediction - target
    return d * d / (prediction * prediction + 1e-2)


def l1(target: torch.Tensor, prediction: torch.Tensor) -> torch.Tensor:
    return torch.abs(prediction - target)


def huber(target: torch.Tensor, prediction: torch.Tensor,
          alpha: float = HUBER_ALPHA) -> torch.Tensor:
    d = prediction - target
    ad = torch.abs(d)
    return torch.where(ad > alpha, ad - 0.5 * alpha, 0.5 / alpha * d * d)


def mape(target: torch.Tensor, prediction: torch.Tensor) -> torch.Tensor:
    """|p − t| / (|p| + 1e-2), the denominator detached as in the JAX
    package's ``stop_gradient`` (and the reference's analytic gradient)."""
    d = prediction - target
    denom = torch.abs(prediction.detach()) + 1e-2
    return torch.abs(d) / denom


def smape(target: torch.Tensor, prediction: torch.Tensor) -> torch.Tensor:
    """|p − t| / (½(|p| + |t|) + 1e-2), the prediction detached in the
    denominator."""
    d = prediction - target
    denom = 0.5 * (torch.abs(prediction.detach()) + torch.abs(target)) + 1e-2
    return torch.abs(d) / denom


def log_l1(target: torch.Tensor, prediction: torch.Tensor) -> torch.Tensor:
    return torch.log(torch.abs(prediction - target) + 1.0)


def loss_fn(loss_type: LossType):
    """The elementwise loss of a type, Huber with the /5 scaling."""
    return {LossType.L2: l2, LossType.RELATIVE_L2: relative_l2, LossType.L1: l1,
            LossType.MAPE: mape, LossType.SMAPE: smape, LossType.LOGL1: log_l1,
            LossType.HUBER: lambda t, p: huber(t, p, HUBER_ALPHA) / 5.0}[loss_type]


def _abs_slope(x: torch.Tensor) -> torch.Tensor:
    """d|x|/dx as JAX differentiates ``jnp.abs``: +1 at 0."""
    return torch.where(x >= 0.0, 1.0, -1.0)


def loss_and_grads(loss_type: LossType, target: torch.Tensor, prediction: torch.Tensor):
    """(loss, d loss / d prediction, d loss / d target), elementwise, with
    the stop-gradients of ``loss_fn``'s losses."""
    t, p = target, prediction
    d = p - t
    ad = torch.abs(d)
    s = _abs_slope(d)
    if loss_type == LossType.L2:
        return d * d, 2.0 * d, -2.0 * d
    if loss_type == LossType.L1:
        return ad, s, -s
    if loss_type == LossType.HUBER:
        far = ad > HUBER_ALPHA
        gp = torch.where(far, s, (1.0 / HUBER_ALPHA) * d) / 5.0
        return huber(t, p) / 5.0, gp, -gp
    if loss_type == LossType.MAPE:
        den = torch.abs(p) + 1e-2
        return ad / den, s / den, -s / den
    if loss_type == LossType.SMAPE:
        den = 0.5 * (torch.abs(p) + torch.abs(t)) + 1e-2
        return ad / den, s / den, -s / den - ad / (den * den) * (0.5 * _abs_slope(t))
    if loss_type == LossType.LOGL1:
        gp = s / (ad + 1.0)
        return torch.log(ad + 1.0), gp, -gp
    if loss_type == LossType.RELATIVE_L2:
        den = p * p + 1e-2
        return d * d / den, 2.0 * d / den - d * d * (2.0 * p) / (den * den), -2.0 * d / den
    raise ValueError(f"unknown loss {loss_type}")


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
