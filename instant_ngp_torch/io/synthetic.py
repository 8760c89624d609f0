"""Procedural Blender-synthetic-style NeRF dataset generator (port of
``instant_ngp_tpu/io/synthetic.py``, in numpy as the original is).

An analytic scene (coloured boxes and a sphere with sharp edges, empty
space around them) is volume-integrated into ground-truth RGBA images with
the conventions of the Blender scenes: a transparent background in
straight-alpha PNGs, sRGB colour, and ``transforms.json`` /
``transforms_test.json`` in the nerf convention (``camera_angle_x`` +
``transform_matrix``). The same arguments give the same JSON files and the
same pixels as the JAX package's generator; the PNGs are written by the
package's own codec (``io/png.py``) instead of imageio.

The renderer integrates the analytic field at 512 steps a ray by default,
so the dataset's own error is negligible against a trained model's.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np

from .png import write_png


def _scene_fields():
    """Analytic density+color: a lego-ish arrangement of sharp colored
    boxes and a sphere inside the unit cube (nerf-convention world
    coords, scene centered at origin, radius ~1)."""
    boxes = [
        # (center, half-extent, rgb)
        ((0.00, -0.35, 0.00), (0.55, 0.08, 0.55), (0.65, 0.65, 0.62)),  # base
        ((0.00, -0.05, 0.00), (0.30, 0.22, 0.18), (0.85, 0.12, 0.10)),  # body
        ((-0.18, 0.25, 0.00), (0.10, 0.10, 0.10), (0.95, 0.80, 0.10)),  # stud
        ((0.18, 0.25, 0.00), (0.10, 0.10, 0.10), (0.10, 0.55, 0.90)),   # stud
        ((0.00, -0.05, 0.28), (0.08, 0.08, 0.06), (0.15, 0.75, 0.20)),  # nub
    ]
    spheres = [
        ((0.0, 0.52, 0.0), 0.14, (0.9, 0.35, 0.75)),
    ]

    bc = np.float32([b[0] for b in boxes])          # (NB, 3)
    bh = np.float32([b[1] for b in boxes])
    brgb = np.float32([b[2] for b in boxes])
    sc = np.float32([s[0] for s in spheres])        # (NS, 3)
    sr = np.float32([s[1] for s in spheres])
    srgb_c = np.float32([s[2] for s in spheres])

    def _inside(p):
        """(N,3) → (N, NB+NS) bool, one broadcast pass per shape class."""
        in_b = np.all(np.abs(p[:, None, :] - bc[None]) <= bh[None], -1)
        d2 = np.sum((p[:, None, :] - sc[None]) ** 2, -1)
        in_s = d2 <= (sr ** 2)[None]
        return np.concatenate([in_b, in_s], 1)

    all_rgb = np.concatenate([brgb, srgb_c], 0)

    def density(p):
        """(N,3) → (N,) density. Hard interiors (sigma=80), vacuum out."""
        return np.where(_inside(p).any(1), np.float32(80.0),
                        np.float32(0.0))

    def color(p):
        """(N,3) → (N,3) linear albedo (first shape in declaration
        order wins) with a simple height shade."""
        ins = _inside(p)
        first = np.argmax(ins, 1)  # 0 when none inside — masked below
        col = all_rgb[first] * ins.any(1)[:, None]
        shade = 0.65 + 0.35 * np.clip(p[:, 1] + 0.5, 0.0, 1.0)
        return (col * shade[:, None]).astype(np.float32)

    return density, color


def _look_at(eye, target=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0)):
    """nerf-convention camera-to-world (x right, y up, z BACK: camera
    looks along -z, like Blender/instant-ngp inputs)."""
    eye = np.float32(eye)
    f = eye - np.float32(target)  # +z points away from the scene
    f = f / np.linalg.norm(f)
    r = np.cross(np.float32(up), f)
    r = r / np.linalg.norm(r)
    u = np.cross(f, r)
    m = np.eye(4, dtype=np.float32)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = r, u, f, eye
    return m


def _render_gt(density, color, c2w, res: int, fov_x: float,
               n_steps: int = 512):
    """Brute-force volume integral → (res, res, 4) float straight-alpha
    linear RGBA over a transparent background."""
    fl = 0.5 * res / math.tan(0.5 * fov_x)
    ys, xs = np.meshgrid(np.arange(res), np.arange(res), indexing="ij")
    u = (xs + 0.5 - res / 2) / fl
    v = (ys + 0.5 - res / 2) / fl
    # camera looks along -z in nerf convention
    d_cam = np.stack([u, -v, -np.ones_like(u)], -1).reshape(-1, 3)
    d = d_cam @ c2w[:3, :3].T
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.broadcast_to(c2w[:3, 3], d.shape)

    # integrate over the scene bounding sphere (radius 1.2)
    t0, t1 = 0.5, 4.5
    ts = np.linspace(t0, t1, n_steps, dtype=np.float32)
    dt = float(ts[1] - ts[0])
    rgb = np.zeros((d.shape[0], 3), np.float32)
    T = np.ones(d.shape[0], np.float32)
    N = d.shape[0]
    # 64 steps of every ray at a time
    scene_lo = np.float32([-0.66, -0.46, -0.66])
    scene_hi = np.float32([0.66, 0.67, 0.66])
    for s0 in range(0, n_steps, 64):
        tc = ts[s0:s0 + 64]
        S = len(tc)
        p = (o[:, None, :] + tc[None, :, None] * d[:, None, :]).reshape(-1, 3)
        # the field is evaluated only at samples inside the scene's bounds
        near = np.all((p >= scene_lo) & (p <= scene_hi), -1)
        sel = np.nonzero(near)[0]
        sig = np.zeros(N * S, np.float32)
        if len(sel):
            sig[sel] = density(p[sel])
        sig = sig.reshape(N, S)
        if not sig.any():
            continue
        a = 1.0 - np.exp(-sig * dt)
        # transmittance before each in-chunk sample
        Tc = np.cumprod(1.0 - a, axis=1)
        T_before = np.concatenate([np.ones((N, 1), np.float32),
                                   Tc[:, :-1]], 1)
        w = T[:, None] * T_before * a
        col = np.zeros((N * S, 3), np.float32)
        if len(sel):
            col[sel] = color(p[sel])
        rgb += np.einsum("ns,nsc->nc", w, col.reshape(N, S, 3))
        T *= Tc[:, -1]
    alpha = 1.0 - T
    straight = rgb / np.maximum(alpha[:, None], 1e-6)
    out = np.concatenate([np.clip(straight, 0, 1), alpha[:, None]], -1)
    return out.reshape(res, res, 4)


def generate_synthetic_dataset(out_dir, n_train: int = 24, n_test: int = 4,
                               res: int = 256, fov_x_deg: float = 45.0,
                               n_steps: int = 512, seed: int = 7):
    """Write a Blender-synthetic-style dataset: train PNGs +
    transforms.json (+ transforms_test.json). Returns (dir, test json
    path). Idempotent: skips regeneration when the directory is
    complete."""
    out_dir = Path(out_dir)
    marker = out_dir / ".complete"
    if marker.exists():
        return out_dir, out_dir / "transforms_test.json"
    out_dir.mkdir(parents=True, exist_ok=True)
    density, color = _scene_fields()
    rng = np.random.default_rng(seed)
    fov_x = math.radians(fov_x_deg)

    def srgb(x):
        x = np.clip(x, 0.0, 1.0)
        return np.where(x <= 0.0031308, 12.92 * x,
                        1.055 * np.power(np.maximum(x, 1e-9), 1 / 2.4) - 0.055)

    def cameras(n, phase):
        cams = []
        for i in range(n):
            az = 2 * math.pi * (i + phase) / n
            el = math.radians(18 + 32 * float(rng.random()))
            r = 2.6
            eye = (r * math.cos(el) * math.sin(az),
                   r * math.sin(el),
                   r * math.cos(el) * math.cos(az))
            cams.append(_look_at(eye))
        return cams

    def write_split(cams, names, json_name):
        frames = []
        for c2w, name in zip(cams, names):
            rgba = _render_gt(density, color, c2w, res, fov_x,
                              n_steps=n_steps)
            img8 = np.concatenate(
                [srgb(rgba[..., :3]), rgba[..., 3:]], -1)
            img8 = (img8 * 255.0 + 0.5).astype(np.uint8)
            write_png(out_dir / f"{name}.png", img8)
            frames.append({"file_path": name,
                           "transform_matrix": c2w.tolist()})
        meta = {"camera_angle_x": fov_x, "aabb_scale": 1, "frames": frames}
        (out_dir / json_name).write_text(json.dumps(meta))

    write_split(cameras(n_train, 0.0),
                [f"train_{i:03d}" for i in range(n_train)],
                "transforms.json")
    write_split(cameras(n_test, 0.37),
                [f"test_{i:03d}" for i in range(n_test)],
                "transforms_test.json")
    marker.write_text("ok")
    return out_dir, out_dir / "transforms_test.json"
