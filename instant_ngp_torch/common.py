"""Constants, activations and small math helpers of the NeRF path.

Port of ``instant_ngp_tpu/common.py`` (the parts the snapshot renderer
reads). The marching constants follow the reference's nerf_device.cuh.
"""

from __future__ import annotations

import enum
import math

import torch

# --- NeRF marching constants ---
NERF_GRIDSIZE = 128
NERF_GRID_N_CELLS = NERF_GRIDSIZE**3
NERF_RENDERING_NEAR_DISTANCE = 0.05
NERF_STEPS = 1024  # finest number of steps per unit length
NERF_CASCADES = 8
SQRT3 = math.sqrt(3.0)
STEPSIZE = SQRT3 / NERF_STEPS
MIN_CONE_STEPSIZE = STEPSIZE
# Maximum step size is the width of the coarsest gridsize cell.
MAX_CONE_STEPSIZE = STEPSIZE * (1 << (NERF_CASCADES - 1)) * NERF_STEPS / NERF_GRIDSIZE
NERF_MIN_OPTICAL_THICKNESS = 0.01
MAX_DEPTH = 16384.0

# Scene scale applied when importing standard nerf-convention datasets.
NERF_SCALE = 0.33


class NerfActivation(enum.Enum):
    NONE = "none"
    RELU = "relu"
    LOGISTIC = "logistic"
    EXPONENTIAL = "exponential"


class LensMode(enum.Enum):
    PERSPECTIVE = "perspective"
    OPENCV = "opencv"
    OPENCV_FISHEYE = "opencv_fisheye"
    FTHETA = "ftheta"
    LATLONG = "latlong"
    EQUIRECTANGULAR = "equirectangular"
    ORTHOGRAPHIC = "orthographic"


def srgb_to_linear(c: torch.Tensor) -> torch.Tensor:
    return torch.where(c < 0.04045, c / 12.92,
                       torch.pow((torch.clamp(c, min=0.04045) + 0.055) / 1.055, 2.4))


def linear_to_srgb(c: torch.Tensor) -> torch.Tensor:
    return torch.where(c < 0.0031308, 12.92 * c,
                       1.055 * torch.pow(torch.clamp(c, min=0.0031308), 1.0 / 2.4) - 0.055)


def logistic(x: torch.Tensor) -> torch.Tensor:
    return 1.0 / (1.0 + torch.exp(-x))


def network_to_rgb(val: torch.Tensor, activation: NerfActivation) -> torch.Tensor:
    """reference nerf_device.cuh:204-213."""
    if activation == NerfActivation.NONE:
        return val
    if activation == NerfActivation.RELU:
        return torch.clamp(val, min=0.0)
    if activation == NerfActivation.LOGISTIC:
        return logistic(val)
    if activation == NerfActivation.EXPONENTIAL:
        return torch.exp(torch.clamp(val, -10.0, 10.0))
    raise ValueError(activation)


def network_to_density(val: torch.Tensor, activation: NerfActivation) -> torch.Tensor:
    """reference nerf_device.cuh:235-243, with the density clamped at ±15
    before exp as in the JAX package."""
    if activation == NerfActivation.NONE:
        return val
    if activation == NerfActivation.RELU:
        return torch.clamp(val, min=0.0)
    if activation == NerfActivation.LOGISTIC:
        return logistic(val)
    if activation == NerfActivation.EXPONENTIAL:
        return torch.exp(torch.clamp(val, -15.0, 15.0))
    raise ValueError(activation)


def warp_direction(d: torch.Tensor) -> torch.Tensor:
    return (d + 1.0) * 0.5


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """a·b + c in f32 with ONE rounding, like a fused multiply-add.

    The JAX reference's compiled CPU code contracts ``a*b + c`` into an
    FMA (and the upstream CUDA code does too), and rays start exactly on
    box faces, where the rounding decides whether a position is inside.
    Emulated in f64: the product of two f32 values is exact there."""
    f64 = torch.float64
    b = b.to(f64) if torch.is_tensor(b) else b
    c = c.to(f64) if torch.is_tensor(c) else c
    return (a.to(f64) * b + c).to(torch.float32)
