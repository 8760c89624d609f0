"""Wireframe debug overlays: the unit cube or render AABB and the training
cameras' frusta drawn over a rendered frame (port of
``instant_ngp_tpu/render/overlays.py``; the headless counterpart of the
reference's draw_visualizations, testbed.cu:2126-2254).

The projection runs on the host in numpy; ``draw_segment`` writes a
segment's pixels into the frame tensor in place, on whatever device the
frame lies.
"""

from __future__ import annotations

import numpy as np
import torch

# 12 edges of an axis-aligned box, as corner-index pairs into the
# (8, 3) corner order of BoundingBox.get_vertices
_BOX_EDGES = [
    (0, 1), (2, 3), (4, 5), (6, 7),  # x-aligned
    (0, 2), (1, 3), (4, 6), (5, 7),  # y-aligned
    (0, 4), (1, 5), (2, 6), (3, 7),  # z-aligned
]


def project_points(pts: np.ndarray, camera_matrix: np.ndarray,
                   width: int, height: int, focal_length,
                   principal_point=(0.5, 0.5)):
    """World points → (pixel xy, in-front mask) under the same pinhole
    convention as ray generation (camera matrix is [R|t] world-from-cam:
    d_world = R @ ((x-cx·W)/fx, (y-cy·H)/fy, 1))."""
    cam = np.asarray(camera_matrix, np.float32)
    R, t = cam[:, :3], cam[:, 3]
    p_c = (np.asarray(pts, np.float32) - t) @ R  # R^T (p - t), R orthonormal
    z = p_c[:, 2]
    in_front = z > 1e-6
    zs = np.where(in_front, z, 1.0)
    fx, fy = (focal_length if np.ndim(focal_length) else
              (focal_length, focal_length))
    cx, cy = principal_point
    x = p_c[:, 0] / zs * fx + cx * width
    y = p_c[:, 1] / zs * fy + cy * height
    return np.stack([x, y], -1), in_front


def draw_segment(frame: torch.Tensor, p0, p1, color, n_samples: int = 256) -> None:
    """Rasterize one line segment into frame (H, W, C) in place."""
    h, w = frame.shape[:2]
    ts = np.linspace(0.0, 1.0, n_samples)
    xs = np.round(p0[0] + (p1[0] - p0[0]) * ts).astype(int)
    ys = np.round(p0[1] + (p1[1] - p0[1]) * ts).astype(int)
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    rows = torch.from_numpy(ys[ok]).to(frame.device)
    cols = torch.from_numpy(xs[ok]).to(frame.device)
    frame[rows, cols, : len(color)] = torch.tensor(color, dtype=frame.dtype, device=frame.device)


def draw_wire_box(frame, box_min, box_max, camera_matrix, focal_length,
                  principal_point=(0.5, 0.5), color=(1.0, 1.0, 0.0)):
    """Draw an AABB wireframe (the reference's render-AABB/unit-cube
    gizmo) over `frame` in place."""
    lo = np.asarray(box_min, np.float32)
    hi = np.asarray(box_max, np.float32)
    corners = np.array([[lo[0], lo[1], lo[2]], [hi[0], lo[1], lo[2]],
                        [lo[0], hi[1], lo[2]], [hi[0], hi[1], lo[2]],
                        [lo[0], lo[1], hi[2]], [hi[0], lo[1], hi[2]],
                        [lo[0], hi[1], hi[2]], [hi[0], hi[1], hi[2]]],
                       np.float32)
    h, w = frame.shape[:2]
    px, front = project_points(corners, camera_matrix, w, h, focal_length,
                               principal_point)
    for a, b in _BOX_EDGES:
        if front[a] and front[b]:
            draw_segment(frame, px[a], px[b], color)


def camera_frustum_segments(xform: np.ndarray, aspect: float = 1.0,
                            scale: float = 0.05):
    """World-space line segments of a small view frustum pyramid at a
    camera pose (reference visualize_nerf_camera)."""
    cam = np.asarray(xform, np.float32)
    eye = cam[:, 3]
    # image-plane corners at unit depth, shrunk by `scale`
    corners_c = np.array([[-aspect, -1, 1], [aspect, -1, 1],
                          [aspect, 1, 1], [-aspect, 1, 1]],
                         np.float32) * scale
    corners_c[:, 2] = scale
    corners_w = corners_c @ cam[:, :3].T + eye
    segs = []
    for i in range(4):
        segs.append((eye, corners_w[i]))                 # apex → corner
        segs.append((corners_w[i], corners_w[(i + 1) % 4]))  # rim
    return segs


def draw_cameras(frame, xforms, camera_matrix, focal_length,
                 principal_point=(0.5, 0.5), color=(0.2, 1.0, 0.2),
                 aspect: float = 1.0):
    """Overlay every training camera as a frustum wireframe."""
    h, w = frame.shape[:2]
    for xf in xforms:
        for p0w, p1w in camera_frustum_segments(np.asarray(xf), aspect):
            px, front = project_points(
                np.stack([p0w, p1w]), camera_matrix, w, h, focal_length,
                principal_point)
            if front.all():
                draw_segment(frame, px[0], px[1], color, n_samples=64)
