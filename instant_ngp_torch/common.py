"""Constants, enums, activations and small math helpers.

Port of ``instant_ngp_tpu/common.py``: the marching constants (the
reference's nerf_device.cuh), the enums the Testbed and pyngp surface name
(same members and values as the JAX package's), ``Lens``, ``BoundingBox``
and the colour and activation helpers, in torch.
"""

from __future__ import annotations

import enum
import math

import numpy as np
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
    # pybind11 member casing of the reference (python_api.cu) — aliases
    ReLU = "relu"
    Logistic = "logistic"
    Exponential = "exponential"


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
    # pybind11 member casing of the reference (python_api.cu) — aliases
    Perspective = "perspective"
    OpenCV = "opencv"
    OpenCVFisheye = "opencv_fisheye"
    FTheta = "ftheta"
    LatLong = "latlong"
    Equirectangular = "equirectangular"
    Orthographic = "orthographic"


class ColorSpace(enum.Enum):
    LINEAR = "linear"
    SRGB = "srgb"
    # pybind11 member casing of the reference (python_api.cu) — alias
    Linear = "linear"


class RenderMode(enum.Enum):
    AO = "ao"
    SHADE = "shade"
    NORMALS = "normals"
    POSITIONS = "positions"
    DEPTH = "depth"
    DISTORTION = "distortion"
    COST = "cost"
    SLICE = "slice"
    ENCODING_VIS = "encoding_vis"
    # pybind11 member casing of the reference (python_api.cu) — aliases
    Shade = "shade"
    Normals = "normals"
    Positions = "positions"
    Depth = "depth"
    Distortion = "distortion"
    Cost = "cost"
    Slice = "slice"
    EncodingVis = "encoding_vis"


class GroundTruthRenderMode(enum.Enum):
    SHADE = "shade"
    DEPTH = "depth"
    # pybind11 member casing of the reference (python_api.cu) — aliases
    Shade = "shade"
    Depth = "depth"


class MeshSdfMode(enum.Enum):
    WATERTIGHT = "watertight"
    RAYSTAB = "raystab"
    PATH_ESCAPE = "path_escape"
    # pybind11 member casing of the reference (python_api.cu) — aliases
    Watertight = "watertight"
    Raystab = "raystab"
    PathEscape = "path_escape"
    # exact sign from angle-weighted pseudonormals (the default; the
    # reference's PathEscape needs OptiX)
    PSEUDONORMAL = "pseudonormal"


class TonemapCurve(enum.Enum):
    IDENTITY = "identity"
    ACES = "aces"
    HABLE = "hable"
    REINHARD = "reinhard"
    # pybind11 member casing of the reference (python_api.cu) — aliases
    Identity = "identity"
    Hable = "hable"
    Reinhard = "reinhard"


class SDFGroundTruthMode(enum.Enum):
    """Reference ESDFGroundTruthMode (python_api.cu:364-366)."""

    RAYTRACED_MESH = "raytracedmesh"
    SPHERETRACED_MESH = "spheretracedmesh"


class EditingKernel(enum.Enum):
    """Reference EEditingKernel (the camera-path keyframe brush,
    camera_path.cu:80-115)."""

    NONE = "none"
    GAUSSIAN = "gaussian"
    QUARTIC = "quartic"
    HAT = "hat"
    BOX = "box"


class TrainMode(enum.Enum):
    NERF = "nerf"
    RFL = "rfl"
    RFL_RELAX = "rflrelax"
    # pybind11 member casing of the reference (python_api.cu) — aliases
    Nerf = "nerf"
    Rfl = "rfl"
    RflRelax = "rflrelax"


class Lens:
    """pyngp ngp.Lens (python_api.cu:428-433): a lens mode and its parameter
    vector. The mode takes a LensMode or its string value."""

    def __init__(self, mode="perspective", params=None):
        self.mode = LensMode(getattr(mode, "value", mode))
        self.params = np.zeros(7, np.float32)
        if params is not None:
            p = np.asarray(params, np.float32).reshape(-1)
            self.params[: len(p)] = p

    def __repr__(self):
        return f"Lens(mode={self.mode.value}, params={self.params.tolist()})"


class BoundingBox:
    """An axis-aligned box with pyngp's ngp.BoundingBox surface (semantics
    of the reference's bounding_box.cuh:40-140), on the host."""

    def __init__(self, min=None, max=None):  # noqa: A002
        if min is None:  # empty, ready for enlarge()
            self.min = np.full(3, np.inf, np.float32)
            self.max = np.full(3, -np.inf, np.float32)
        else:
            self.min = np.asarray(min, np.float32).reshape(3).copy()
            self.max = np.asarray(max, np.float32).reshape(3).copy()

    def __repr__(self):
        return f"BoundingBox(min={self.min.tolist()}, max={self.max.tolist()})"

    def is_empty(self) -> bool:
        return bool((self.max < self.min).any())

    @property
    def center(self):
        return 0.5 * (self.min + self.max)

    def diag(self):
        return self.max - self.min

    def enlarge(self, other) -> None:
        """Grow to cover a point (3,) or another BoundingBox."""
        if isinstance(other, BoundingBox):
            self.min = np.minimum(self.min, other.min)
            self.max = np.maximum(self.max, other.max)
        else:
            p = np.asarray(other, np.float32).reshape(3)
            self.min = np.minimum(self.min, p)
            self.max = np.maximum(self.max, p)

    def inflate(self, amount: float) -> None:
        self.min = self.min - amount
        self.max = self.max + amount

    def contains(self, p) -> bool:
        p = np.asarray(p, np.float32).reshape(3)
        return bool(((p >= self.min) & (p <= self.max)).all())

    def intersection(self, other: "BoundingBox") -> "BoundingBox":
        return BoundingBox(np.maximum(self.min, other.min), np.minimum(self.max, other.max))

    def intersects(self, other: "BoundingBox") -> bool:
        return not self.intersection(other).is_empty()

    def relative_pos(self, p):
        p = np.asarray(p, np.float32).reshape(3)
        return (p - self.min) / np.maximum(self.diag(), 1e-12)

    def ray_intersect(self, pos, dir):  # noqa: A002
        """Slab-method ray/box interval (bounding_box.cuh:105-125): (tmin,
        tmax); no hit ⇔ tmin > tmax. Zero direction components follow IEEE
        inf semantics as the CUDA original."""
        pos = np.asarray(pos, np.float32).reshape(3)
        dir = np.asarray(dir, np.float32).reshape(3)  # noqa: A001
        zero = dir == 0.0
        with np.errstate(divide="ignore", invalid="ignore"):
            t1 = (self.min - pos) / dir
            t2 = (self.max - pos) / dir
        lo = np.minimum(t1, t2)
        hi = np.maximum(t1, t2)
        # axis-parallel rays: inside the slab → unbounded, else no hit
        inside = (pos >= self.min) & (pos <= self.max)
        lo = np.where(zero, np.where(inside, -np.inf, np.inf), lo)
        hi = np.where(zero, np.where(inside, np.inf, -np.inf), hi)
        return float(lo.max()), float(hi.min())

    def signed_distance(self, p) -> float:
        """Negative inside, positive outside (bounding_box.cuh:127-131)."""
        p = np.asarray(p, np.float32).reshape(3)
        q = np.abs(p - self.center) - 0.5 * self.diag()
        return float(np.linalg.norm(np.maximum(q, 0.0)) + min(float(q.max()), 0.0))

    def distance(self, p) -> float:
        return float(self.distance_sq(p) ** 0.5)

    def distance_sq(self, p) -> float:
        p = np.asarray(p, np.float32).reshape(3)
        d = np.maximum(np.maximum(self.min - p, p - self.max), 0.0)
        return float((d * d).sum())

    def get_vertices(self):
        """The 8 corners (bounding_box.cuh get_vertices order)."""
        lo, hi = self.min, self.max
        return np.asarray([
            [lo[0], lo[1], lo[2]], [hi[0], lo[1], lo[2]],
            [lo[0], hi[1], lo[2]], [hi[0], hi[1], lo[2]],
            [lo[0], lo[1], hi[2]], [hi[0], lo[1], hi[2]],
            [lo[0], hi[1], hi[2]], [hi[0], hi[1], hi[2]],
        ], np.float32)


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
    and the logistic's as JAX's autodiff of 1 / (1 + e^-x) computes it,
    e^-x / (1 + e^-x)², except where e^-x overflows (x < -88.7): there that
    quotient is inf / inf = NaN in JAX, and 0, its limit, here. One such
    sample's NaN reached every parameter through the MLPs' backward and
    stopped fox's training (instant_ngp_torch/bench/nerf_repeat.py)."""
    if activation == NerfActivation.NONE:
        return torch.ones_like(val)
    if activation == NerfActivation.RELU:
        return torch.where(val > 0.0, 1.0, torch.where(val == 0.0, 0.5, 0.0))
    if activation == NerfActivation.LOGISTIC:
        e = torch.exp(-val)
        u = 1.0 + e
        return torch.where(torch.isinf(e), 0.0, e / (u * u))
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
