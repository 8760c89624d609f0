"""Camera models: uv → camera-space rays (port of the perspective and
OpenCV lenses of ``instant_ngp_tpu/render/camera.py``; reference
common_device.cuh), and the pinhole rays of the SDF and volume renders. The
other lens modes come with a later slice."""

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


def uv_to_ray_cam(uv: torch.Tensor, resolution, focal_length, principal_point,
                  lens_mode: LensMode = LensMode.PERSPECTIVE,
                  lens_params: torch.Tensor | None = None):
    """uv (N, 2) → (dir_cam (N, 3), origin_offset_cam (N, 3)), z-forward.

    resolution is (w, h); focal_length and principal_point are (2,)
    tensors or (N, 2). lens_params are (k1, k2, p1, p2) for OPENCV."""
    w, h = resolution
    fx = focal_length[..., 0]
    fy = focal_length[..., 1]
    cx = principal_point[..., 0]
    cy = principal_point[..., 1]
    u = (uv[:, 0] - cx) * w / fx
    v = (uv[:, 1] - cy) * h / fy
    zeros3 = torch.zeros((uv.shape[0], 3), dtype=uv.dtype, device=uv.device)
    if lens_mode == LensMode.OPENCV and lens_params is not None:
        k1, k2, p1, p2 = lens_params[0], lens_params[1], lens_params[2], lens_params[3]
        u, v = iterative_opencv_undistortion(u, v, k1, k2, p1, p2)
    elif lens_mode != LensMode.PERSPECTIVE and lens_mode != LensMode.OPENCV:
        raise NotImplementedError(f"lens mode {lens_mode.value} is not ported yet")
    return torch.stack([u, v, torch.ones_like(u)], -1), zeros3


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
