"""Constants, enums, activations and small math helpers.

Port of ``instant_ngp_tpu/common.py`` (the parts the NeRF renderer and
training step and the image primitive read). The marching constants
follow the reference's nerf_device.cuh.
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
EPS_T = 1e-4  # transmittance early-stop (reference EPSILON, testbed_nerf.cu:919)

# Scene scale applied when importing standard nerf-convention datasets.
NERF_SCALE = 0.33


class TestbedMode(enum.Enum):
    NONE = "none"
    NERF = "nerf"
    SDF = "sdf"
    IMAGE = "image"
    VOLUME = "volume"
    # pybind11 member casing of the reference (python_api.cu) — aliases
    Nerf = "nerf"
    Sdf = "sdf"
    Image = "image"
    Volume = "volume"


class RandomMode(enum.Enum):
    """Training-position sampling of the image primitive."""

    RANDOM = "random"
    HALTON = "halton"
    SOBOL = "sobol"
    STRATIFIED = "stratified"
    # pybind11 member casing of the reference (python_api.cu) — aliases
    Random = "random"
    Halton = "halton"
    Sobol = "sobol"
    Stratified = "stratified"


class NerfActivation(enum.Enum):
    NONE = "none"
    RELU = "relu"
    LOGISTIC = "logistic"
    EXPONENTIAL = "exponential"


# activation codes the composite kernels (D, G) take
ACTIVATION_CODES = {NerfActivation.NONE: 0, NerfActivation.RELU: 1,
                    NerfActivation.LOGISTIC: 2, NerfActivation.EXPONENTIAL: 3}


class LossType(enum.Enum):
    L2 = "l2"
    L1 = "l1"
    MAPE = "mape"
    SMAPE = "smape"
    HUBER = "huber"
    LOGL1 = "logl1"
    RELATIVE_L2 = "relativel2"


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


def clip_grad(val: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """d clip(val, lo, hi) / d val as JAX differentiates ``jnp.clip``
    (max then min): 1 inside, 0.5 on either bound, 0 outside."""
    inside = torch.where((val > lo) & (val < hi), 1.0, 0.0)
    return torch.where((val == lo) | (val == hi), 0.5, inside)


def network_to_rgb_grad(val: torch.Tensor, activation: NerfActivation) -> torch.Tensor:
    """d network_to_rgb / d val, with the clamp's gradient as ``clip_grad``
    and the logistic's as JAX's autodiff of 1 / (1 + e^-x) computes it."""
    if activation == NerfActivation.NONE:
        return torch.ones_like(val)
    if activation == NerfActivation.RELU:
        return torch.where(val > 0.0, 1.0, torch.where(val == 0.0, 0.5, 0.0))
    if activation == NerfActivation.LOGISTIC:
        e = torch.exp(-val)
        u = 1.0 + e
        return e / (u * u)
    if activation == NerfActivation.EXPONENTIAL:
        return torch.exp(torch.clamp(val, -10.0, 10.0)) * clip_grad(val, -10.0, 10.0)
    raise ValueError(activation)


def network_to_density_grad(val: torch.Tensor, activation: NerfActivation) -> torch.Tensor:
    """d network_to_density / d val (zero outside the ±15 clamp, 0.5 on it)."""
    if activation == NerfActivation.EXPONENTIAL:
        return torch.exp(torch.clamp(val, -15.0, 15.0)) * clip_grad(val, -15.0, 15.0)
    return network_to_rgb_grad(val, activation)


def warp_direction(d: torch.Tensor) -> torch.Tensor:
    return (d + 1.0) * 0.5


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """a·b + c in f32, like a fused multiply-add.

    The JAX reference's compiled CPU code contracts ``a*b + c`` into an
    FMA (and the upstream CUDA code does too), and rays start exactly on
    box faces, where the rounding decides whether a position is inside.
    Emulated in f64: the product of two f32 values is exact there, but the
    f64 sum rounds before the cast to f32, so where the exact sum lies
    within half an f64 ulp of a tie between two f32 values the result can
    differ from a true FMA's in its last bit. ``fma_exact`` rounds once."""
    f64 = torch.float64
    b = b.to(f64) if torch.is_tensor(b) else b
    c = c.to(f64) if torch.is_tensor(c) else c
    return (a.to(f64) * b + c).to(torch.float32)


def fma_exact(a: torch.Tensor, b, c) -> torch.Tensor:
    """a·b + c in f32 with one rounding, equal to a hardware FMA bit for
    bit, for f32 a, b (or b a float an f32 holds) and f32 c.

    The f64 product is exact. The f64 sum s is made round-to-odd: TwoSum
    gives its error, and an inexact s with an even last bit steps one f64
    ulp toward the exact sum. Round-to-odd in 53 bits followed by
    round-to-nearest in 24 rounds as round-to-nearest once (53 >= 2·24 + 2).
    About a dozen more elementwise ops than ``fma``: used where a kernel is
    held to its plain version bit for bit over millions of FMAs."""
    f64 = torch.float64
    p = a.to(f64) * (b.to(f64) if torch.is_tensor(b) else b)
    c = c.to(f64) if torch.is_tensor(c) else c
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    step = (err != 0) & torch.isfinite(err) & ((s.view(torch.int64) & 1) == 0)
    s = torch.where(step, torch.nextafter(s, torch.copysign(torch.full_like(s, math.inf), err)), s)
    return s.to(torch.float32)
