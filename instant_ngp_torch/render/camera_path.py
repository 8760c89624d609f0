"""Camera paths: keyframed spline trajectories and offline video frames
(port of ``instant_ngp_tpu/render/camera_path.py``; reference
camera_path.{h,cu}).

Keyframes hold a rotation quaternion, a translation, the fov, the aperture,
the slice plane and a timestamp; playback interpolates with Catmull-Rom (or
linear) splines and normalizes the quaternion; a video frame sums its
samples along the shutter (prepare_next_camera_path_frame,
testbed.cu:3049-3170). The JSON is the reference's camera-path format, key
for key the JAX package's: a path saved by either package loads in the
other. The path itself is host state in numpy; ``render_video_frames``
sums a frame's samples on the task's device and hands each frame to the
host once.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Keyframe:
    R: np.ndarray  # quaternion (w, x, y, z)
    T: np.ndarray  # translation (3,)
    fov: float = 50.0
    aperture_size: float = 0.0
    slice_z: float = 0.0
    timestamp: float = 0.0
    scale: float = 1.0  # reference CameraKeyframe::scale

    @staticmethod
    def from_matrix(m: np.ndarray, **kw) -> "Keyframe":
        m = np.asarray(m)
        return Keyframe(R=rotmat_to_quat(m[:3, :3]), T=m[:3, 3].copy(), **kw)

    def to_matrix(self) -> np.ndarray:
        m = np.zeros((3, 4), np.float32)
        m[:3, :3] = quat_to_rotmat(self.R / np.linalg.norm(self.R))
        m[:3, 3] = self.T
        return m

    # pyngp CameraKeyframe aliases (python_api.cu:901-909)
    @property
    def slice(self):  # noqa: A003 — reference member name
        return self.slice_z

    @slice.setter
    def slice(self, v):  # noqa: A003
        self.slice_z = float(v)

    def m(self) -> np.ndarray:
        return self.to_matrix()

    def from_m(self, rv: np.ndarray) -> None:
        rv = np.asarray(rv, np.float32)
        self.R = rotmat_to_quat(rv[:3, :3])
        self.T = rv[:3, 3].copy()

    def same_pos_as(self, other: "Keyframe") -> bool:
        """pyngp CameraKeyframe.same_pos_as: pose equality within the
        reference's epsilon (camera_path.h SameAs semantics)."""
        return bool(
            np.allclose(self.T, other.T, atol=1e-4)
            and (np.allclose(self.R, other.R, atol=1e-4)
                 or np.allclose(self.R, -np.asarray(other.R), atol=1e-4))
        )


@dataclasses.dataclass
class CameraPathPos:
    """pyngp CameraPathPos (python_api.cu:927): a spline position as a
    keyframe index + in-segment fraction. Tuple-unpackable for the
    pre-existing (i, t) call sites."""

    kfidx: int = 0
    t: float = 0.0

    def __iter__(self):
        yield self.kfidx
        yield self.t

    def __getitem__(self, i):
        return (self.kfidx, self.t)[i]


def editing_kernel(x: float, kernel: str = "gaussian") -> float:
    """Keyframe-editing falloff kernels (camera_path.cu:191-201):
    gaussian | quartic | hat | box | none."""
    if kernel != "gaussian":
        x = float(np.clip(x, -1.0, 1.0))
    if kernel == "gaussian":
        return float(np.exp(-2.0 * x * x))
    if kernel == "quartic":
        return float((1.0 - x * x) ** 2)
    if kernel == "hat":
        return 1.0 - abs(x)
    if kernel == "box":
        return 1.0 if -1.0 < x < 1.0 else 0.0
    if kernel == "none":
        return 1.0 if abs(x) < 1e-4 else 0.0
    raise ValueError(f"unknown editing kernel {kernel!r}")


@dataclasses.dataclass
class RenderSettings:
    """pyngp CameraPathRenderSettings (python_api.cu:919-925)."""

    resolution: tuple = (1920, 1080)
    spp: int = 8
    fps: float = 60.0
    duration_seconds: float = 5.0
    shutter_fraction: float = 0.5
    quality: int = 10

    @property
    def n_frames(self) -> int:
        return int(round(self.duration_seconds * self.fps))

    def frame_milliseconds(self) -> float:
        return 1000.0 / max(self.fps, 1e-6)


def quat_to_rotmat(q):
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ],
        np.float32,
    )


def rotmat_to_quat(m):
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([0.25 * s, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s,
                         (m[1, 0] - m[0, 1]) / s], np.float32)
    i = int(np.argmax(np.diag(m)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(m[i, i] - m[j, j] - m[k, k] + 1.0, 1e-12)) * 2
    q = np.zeros(4, np.float32)
    q[0] = (m[k, j] - m[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (m[j, i] + m[i, j]) / s
    q[1 + k] = (m[k, i] + m[i, k]) / s
    return q


def _catmull_rom(p0, p1, p2, p3, t):
    t2, t3 = t * t, t * t * t
    return 0.5 * (
        2 * p1
        + (-p0 + p2) * t
        + (2 * p0 - 5 * p1 + 4 * p2 - p3) * t2
        + (-p0 + 3 * p1 - 3 * p2 + p3) * t3
    )


@dataclasses.dataclass
class CameraPath:
    keyframes: list = dataclasses.field(default_factory=list)
    loop: bool = False
    spline_order: int = 3  # 3 = Catmull-Rom, 1 = linear
    # pyngp playback state (python_api.cu CameraPath binding :929-945)
    play_time: float = 0.0
    auto_play_speed: float = 0.0
    update_cam_from_path: bool = False
    keyframe_subsampling: int = 1
    duration_seconds: float = 0.0
    rendering: bool = False
    render_frame_idx: int = 0
    render_start_time: float = 0.0
    render_frame_end_camera: Optional[np.ndarray] = None
    # keyframe-editing brush (camera_path.cu editing_kernel)
    editing_kernel_type: str = "none"
    editing_kernel_radius: float = 1.0
    # VR-latency camera prediction horizon fields (pyngp
    # CameraPath binding :937-938; consumed by predict_view_camera
    # callers choosing a delta_t)
    camera_prediction_duration_seconds: float = 0.0
    camera_prediction_dt: float = 0.0
    render_settings: "RenderSettings" = dataclasses.field(
        default_factory=lambda: RenderSettings())

    def add_camera(self, matrix: np.ndarray, fov: float = 50.0, **kw):
        self.keyframes.append(Keyframe.from_matrix(matrix, fov=fov, **kw))

    # --- pyngp playback API (semantics from camera_path.h:140-195,
    # camera_path.cu:203-258) ---------------------------------------
    def clear(self):
        self.keyframes.clear()
        self.play_time = 0.0
        self.duration_seconds = 0.0

    def empty(self) -> bool:
        return not self.keyframes

    def has_valid_timestamps(self) -> bool:
        prev = 0.0
        for k in self.keyframes:
            if not (k.timestamp > prev):
                return False
            prev = k.timestamp
        return True

    def make_keyframe_timestamps_equidistant(self):
        n = len(self.keyframes)
        for i, k in enumerate(self.keyframes):
            k.timestamp = (i + 1) / n
        self.duration_seconds = 1.0

    def sanitize_keyframes(self):
        if not self.has_valid_timestamps():
            self.make_keyframe_timestamps_equidistant()

    def get_keyframe(self, i: int) -> Keyframe:
        n = len(self.keyframes)
        if self.loop:
            return self.keyframes[(i + n) % n]
        return self.keyframes[int(np.clip(i, 0, n - 1))]

    def get_playtime(self, i: int) -> float:
        n = len(self.keyframes)
        if i <= 0 or n < 2:
            return 0.0
        kf = self.keyframes[int(np.clip(i - 1, 0, n - 1))]
        duration = (self.keyframes[-1].timestamp if self.loop
                    else self.keyframes[n - 2].timestamp)
        return kf.timestamp / duration

    def get_pos(self, playtime: float) -> "CameraPathPos":
        """(kfidx, t): segment index + fraction at `playtime` ∈ [0,1],
        respecting keyframe timestamps (camera_path.cu:233-258).
        Returns a CameraPathPos (tuple-unpackable)."""
        n = len(self.keyframes)
        if n == 0:
            return CameraPathPos(-1, 0.0)
        if n == 1:
            return CameraPathPos(0, playtime)
        duration = (self.keyframes[-1].timestamp if self.loop
                    else self.keyframes[n - 2].timestamp)
        pt = playtime * duration
        stamps = [k.timestamp for k in self.keyframes]
        i = int(np.searchsorted(stamps, pt, side="right"))
        i = int(np.clip(i, 0, n - (1 if self.loop else 2)))
        prev = 0.0 if i == 0 else stamps[i - 1]
        return CameraPathPos(i, (pt - prev) / max(stamps[i] - prev, 1e-12))

    def eval_camera_path(self, t: float) -> Keyframe:
        """Timestamp-aware spline evaluation (the pyngp method); falls
        back to uniform index spacing when timestamps are invalid."""
        if not self.has_valid_timestamps():
            return self.eval(t)
        i, f = self.get_pos(t)
        if i < 0:
            raise ValueError("empty camera path")
        return self._eval_segment(i, f)

    def eval(self, t: float) -> Keyframe:
        """t in [0,1] over the whole path (uniform keyframe spacing)."""
        n = len(self.keyframes)
        if n == 0:
            raise ValueError("empty camera path")
        if n == 1:
            return self.keyframes[0]
        x = t * (n - 1 if not self.loop else n)
        i = int(np.floor(x))
        f = x - i
        return self._eval_segment(i, f)

    def _eval_segment(self, i: int, f: float) -> Keyframe:
        n = len(self.keyframes)
        if n == 1:
            return self.keyframes[0]

        def kf(j):
            if self.loop:
                return self.keyframes[j % n]
            return self.keyframes[int(np.clip(j, 0, n - 1))]

        k0, k1, k2, k3 = kf(i - 1), kf(i), kf(i + 1), kf(i + 2)
        # keep quaternion hemisphere consistent
        qs = [k0.R, k1.R, k2.R, k3.R]
        for a in range(1, 4):
            if np.dot(qs[a - 1], qs[a]) < 0:
                qs[a] = -qs[a]
        if self.spline_order >= 3 and n >= 2:
            q = _catmull_rom(*qs, f)
            T = _catmull_rom(k0.T, k1.T, k2.T, k3.T, f)
            fov = _catmull_rom(k0.fov, k1.fov, k2.fov, k3.fov, f)
            ap = _catmull_rom(
                k0.aperture_size, k1.aperture_size, k2.aperture_size, k3.aperture_size, f
            )
        else:
            q = qs[1] * (1 - f) + qs[2] * f
            T = k1.T * (1 - f) + k2.T * f
            fov = k1.fov * (1 - f) + k2.fov * f
            ap = k1.aperture_size * (1 - f) + k2.aperture_size * f
        q = q / np.linalg.norm(q)
        return Keyframe(R=q, T=T, fov=float(fov), aperture_size=float(ap))

    # --- reference-compatible JSON (camera_path.cu save/load keys) ---
    def save(self, path):
        doc = {
            "loop": self.loop,
            "time": 1.0,
            "path": [
                {
                    "R": [float(v) for v in k.R],
                    "T": [float(v) for v in k.T],
                    "fov": k.fov,
                    "aperture_size": k.aperture_size,
                    "slice": k.slice_z,
                    "timestamp": k.timestamp,
                }
                for k in self.keyframes
            ],
        }
        Path(path).write_text(json.dumps(doc, indent=2))

    @staticmethod
    def load(path) -> "CameraPath":
        doc = json.loads(Path(path).read_text())
        cp = CameraPath(loop=bool(doc.get("loop", False)))
        for k in doc.get("path", []):
            cp.keyframes.append(
                Keyframe(
                    R=np.asarray(k["R"], np.float32),
                    T=np.asarray(k["T"], np.float32),
                    fov=float(k.get("fov", 50.0)),
                    aperture_size=float(k.get("aperture_size", 0.0)),
                    slice_z=float(k.get("slice", 0.0)),
                    timestamp=float(k.get("timestamp", 0.0)),
                )
            )
        return cp


def render_video_frames(task, path: CameraPath, n_frames: int, width: int, height: int,
                        spp: int = 1, shutter_fraction: float = 0.5) -> list[np.ndarray]:
    """Offline render of a camera path → a list of (H, W, 4) numpy frames
    (reference render loop, testbed.cu:3049-3170). Each frame's ``spp``
    samples move the camera along the shutter, from the frame's start to
    ``shutter_fraction`` of a frame later (motion blur); the task's renders
    are summed on its device in sample order, divided by ``spp`` and handed
    to the host once a frame."""
    frames = []
    for fi in range(n_frames):
        t0 = fi / max(n_frames, 1)
        t1 = (fi + shutter_fraction) / max(n_frames, 1)
        acc = None
        for s in range(spp):
            t = t0 + (t1 - t0) * (s / max(spp - 1, 1) if spp > 1 else 0.0)
            kf = path.eval(min(t, 1.0))
            frame = task.render(width, height, kf.to_matrix(), fov=kf.fov)
            acc = frame if acc is None else acc + frame
        frames.append((acc / spp).cpu().numpy())
    return frames
