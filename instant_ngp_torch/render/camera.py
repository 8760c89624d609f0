"""Camera models: uv → camera-space rays through the whole lens stack (port
of ``instant_ngp_tpu/render/camera.py``; reference common_device.cuh:268-527):
perspective, OpenCV radial/tangential, OpenCV fisheye, F-theta, lat-long,
equirectangular and orthographic; the SO(3) exponential and logarithm and
the camera slerp; and the pinhole rays of the SDF and volume renders."""

from __future__ import annotations

import math

import numpy as np
import torch

from ..common import LensMode


def iterative_opencv_undistortion(u, v, k1, k2, p1, p2, n_iters: int = 8):
    """Invert the OpenCV distortion model by fixed-point iteration
    (reference iterative_opencv_lens_undistortion)."""
    x, y = u, v
    for _ in range(n_iters):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + k2 * r2)
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = (u - dx) / radial
        y = (v - dy) / radial
    return x, y


def fisheye_undistortion(u, v, k1, k2, k3, k4, n_iters: int = 8):
    """Invert the OpenCV fisheye model: θ from θ_d by fixed-point
    iteration, then scale (u, v) by tan θ / θ_d."""
    theta_d = torch.sqrt(u * u + v * v)
    theta = theta_d
    for _ in range(n_iters):
        t2 = theta * theta
        theta = theta_d / (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
    scale = torch.where(theta_d > 1e-8, torch.tan(theta) / torch.clamp(theta_d, min=1e-8), 1.0)
    return u * scale, v * scale


def latlong_to_dir(u, v):
    phi = (v - 0.5) * math.pi
    theta = (u - 0.5) * 2.0 * math.pi
    cp = torch.cos(phi)
    return torch.stack([torch.sin(theta) * cp, torch.sin(phi), torch.cos(theta) * cp], -1)


def equirectangular_to_dir(u, v):
    return latlong_to_dir(u, 1.0 - v)


def f_theta_dir(uv_centered: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """F-theta lens → camera-space direction (reference f_theta_undistortion,
    common_device.cuh:368-380). params (r0..r4, width, height): the uv
    offset is rescaled to the intrinsics' own resolution, α = poly4(|pixel|)
    and the direction is (sin α·x̂, sin α·ŷ, cos α). Degenerate pixels (cos α
    ≤ the smallest normal f32, or the centre) get the zero vector, which the
    march treats as an invalid ray."""
    xpix = uv_centered[:, 0] * params[5]
    ypix = uv_centered[:, 1] * params[6]
    norm = torch.sqrt(xpix * xpix + ypix * ypix)
    alpha = params[0] + norm * (params[1] + norm * (params[2] + norm * (params[3]
                                                                         + norm * params[4])))
    sin_a, cos_a = torch.sin(alpha), torch.cos(alpha)
    bad = (cos_a <= torch.finfo(torch.float32).tiny) | (norm == 0.0)
    inv_norm = torch.where(norm == 0.0, 0.0, 1.0 / torch.clamp(norm, min=1e-30))
    d = torch.stack([sin_a * inv_norm * xpix, sin_a * inv_norm * ypix, cos_a], -1)
    return torch.where(bad[:, None], 0.0, d)


def uv_to_ray_cam(uv: torch.Tensor, resolution, focal_length, principal_point,
                  lens_mode: LensMode = LensMode.PERSPECTIVE,
                  lens_params: torch.Tensor | None = None):
    """uv (N, 2) → (dir_cam (N, 3), origin_offset_cam (N, 3)), z-forward.

    resolution is (w, h); focal_length and principal_point are (2,)
    tensors or (N, 2). lens_params: (k1, k2, p1, p2) for OPENCV, (k1..k4)
    for OPENCV_FISHEYE, (r0..r4, w, h) for FTHETA. The origin offset is zero
    but for ORTHOGRAPHIC, where the pixel's displacement rides on the ray
    origin (reference uv_to_ray, common_device.cuh:448-455)."""
    w, h = resolution
    fx = focal_length[..., 0]
    fy = focal_length[..., 1]
    cx = principal_point[..., 0]
    cy = principal_point[..., 1]
    u = (uv[:, 0] - cx) * w / fx
    v = (uv[:, 1] - cy) * h / fy
    zeros3 = torch.zeros((uv.shape[0], 3), dtype=uv.dtype, device=uv.device)
    if lens_mode == LensMode.LATLONG:
        return latlong_to_dir(uv[:, 0], uv[:, 1]), zeros3
    if lens_mode == LensMode.EQUIRECTANGULAR:
        return equirectangular_to_dir(uv[:, 0], uv[:, 1]), zeros3
    if lens_mode == LensMode.FTHETA:
        if lens_params is None:
            raise ValueError("an F-theta lens needs its 7 intrinsic parameters")
        uv_c = torch.stack([uv[:, 0] - cx, uv[:, 1] - cy], -1)
        return f_theta_dir(uv_c, lens_params), zeros3
    if lens_mode == LensMode.OPENCV and lens_params is not None:
        k1, k2, p1, p2 = lens_params[0], lens_params[1], lens_params[2], lens_params[3]
        u, v = iterative_opencv_undistortion(u, v, k1, k2, p1, p2)
    elif lens_mode == LensMode.OPENCV_FISHEYE and lens_params is not None:
        u, v = fisheye_undistortion(u, v, lens_params[0], lens_params[1], lens_params[2],
                                    lens_params[3])
    elif lens_mode == LensMode.ORTHOGRAPHIC:
        dirs = torch.stack([torch.zeros_like(u), torch.zeros_like(u), torch.ones_like(u)], -1)
        return dirs, torch.stack([u, v, torch.zeros_like(u)], -1)
    return torch.stack([u, v, torch.ones_like(u)], -1), zeros3


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (…, 3) axis-angle → (…, 3, 3) rotation, R = I + a·K + b·K²
    with K = skew(w), a = sin θ / θ, b = (1 − cos θ) / θ², and Taylor forms
    below θ² = 1e-8."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    K = torch.stack([torch.stack([zero, -wz, wy], -1),
                     torch.stack([wz, zero, -wx], -1),
                     torch.stack([-wy, wx, zero], -1)], -2)
    theta2 = torch.sum(w * w, dim=-1)[..., None, None]
    small = theta2 < 1e-8
    theta2_safe = torch.where(small, 1.0, theta2)
    theta = torch.sqrt(theta2_safe)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2_safe)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a * K + b * (K @ K)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """The inverse of ``so3_exp``: (…, 3, 3) → (…, 3), with a Taylor form
    below θ = 1e-4 (not valid at θ = π)."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos)
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1)  # 2·sin θ·axis
    small = theta < 1e-4
    sin = torch.where(small, 1.0, torch.sin(theta))
    factor = torch.where(small, 0.5 + theta * theta / 12.0, theta / (2.0 * sin))
    return w * factor[..., None]


def camera_slerp(xform_start: torch.Tensor, xform_end: torch.Tensor, t) -> torch.Tensor:
    """Geodesic interpolation of (…, 3, 4) camera matrices: the rotation
    along the SO(3) geodesic, the translation lerped (reference
    camera_slerp, common_device.cuh:664-668). t broadcasts over the leading
    dimensions."""
    Rs, Re = xform_start[..., :3], xform_end[..., :3]
    ts_, te = xform_start[..., 3], xform_end[..., 3]
    w = so3_log(Re @ Rs.transpose(-1, -2))
    t = torch.as_tensor(t, dtype=xform_start.dtype, device=xform_start.device)[..., None]
    R = so3_exp(w * t) @ Rs
    trans = ts_ * (1.0 - t) + te * t
    return torch.cat([R, trans[..., None]], dim=-1)


def pinhole_rays(width: int, height: int, camera_matrix, fov: float,
                 device) -> tuple[torch.Tensor, torch.Tensor]:
    """Pinhole rays of pixel centres on ``device``, formed as the JAX
    package's SDF and volume renders form them in numpy: (origins (n, 3)
    f32, unit directions (n, 3) f64; the renders round them to f32).
    ``camera_matrix`` (3, 4): columns right, down, forward, origin; ``fov``
    the vertical field of view in degrees."""
    f64 = torch.float64
    cam = torch.as_tensor(np.asarray(camera_matrix, np.float32), device=device)
    fl = 0.5 * height / math.tan(0.5 * math.radians(fov))
    ys, xs = torch.meshgrid(torch.arange(height, dtype=f64, device=device),
                            torch.arange(width, dtype=f64, device=device), indexing="ij")
    u = ((xs + 0.5) / width - 0.5) * width / fl
    v = ((ys + 0.5) / height - 0.5) * height / fl
    rot = cam[:, :3].to(f64)
    d = u[..., None] * rot[:, 0] + v[..., None] * rot[:, 1] + rot[:, 2]
    d = (d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)).reshape(-1, 3)
    return cam[:, 3].expand(d.shape).contiguous(), d
