"""Camera motion predictor for latency compensation (port of
``instant_ngp_tpu/render/camera_predictor.py``; reference
MatLogCameraPredictor, common_host.h:156-253, ECameraPredictionMode
common.h:168-175).

Predicts future camera poses by EMA-filtering the camera's velocity (and
acceleration) in matrix-log or SE(3)-log space, then integrating forward:
linear mode in closed form, quadratic mode by Euler integration over a
64-step sequence. Host-side control logic in numpy and scipy.
"""

from __future__ import annotations

import enum

import numpy as np


class CameraPredictionMode(enum.Enum):
    NONE = "none"
    MAT_LOG_LINEAR = "matlog_linear"
    MAT_LOG_QUADRATIC = "matlog_quadratic"
    SE3_LINEAR = "se3_linear"
    SE3_QUADRATIC = "se3_quadratic"


def _to4(m: np.ndarray) -> np.ndarray:
    out = np.eye(4)
    out[:3, :4] = np.asarray(m, np.float64)[:3, :4]
    return out


def mat_log(m: np.ndarray) -> np.ndarray:
    from scipy.linalg import logm

    return np.real(logm(_to4(m)))


def mat_exp(m: np.ndarray) -> np.ndarray:
    from scipy.linalg import expm

    return np.real(expm(np.asarray(m, np.float64)))


def se3_log(m: np.ndarray) -> np.ndarray:
    """Closed-form SE(3) log → 4×4 twist matrix [[ω]x, v; 0, 0]."""
    m = _to4(m)
    R = m[:3, :3]
    t = m[:3, 3]
    cos_theta = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    theta = np.arccos(cos_theta)
    if theta < 1e-8:
        w_hat = 0.5 * (R - R.T)
        V_inv = np.eye(3)
    else:
        w_hat = theta / (2.0 * np.sin(theta)) * (R - R.T)
        K = w_hat / theta
        # V^-1 = I − θ/2·K + (1 − θ/(2 tan(θ/2)))·K²
        V_inv = (
            np.eye(3) - 0.5 * theta * K
            + (1.0 - theta / (2.0 * np.tan(theta / 2.0))) * (K @ K)
        )
    out = np.zeros((4, 4))
    out[:3, :3] = w_hat
    out[:3, 3] = V_inv @ t
    return out


def se3_exp(xi: np.ndarray) -> np.ndarray:
    """Closed-form SE(3) exp of a 4×4 twist matrix."""
    xi = np.asarray(xi, np.float64)
    w_hat = xi[:3, :3]
    v = xi[:3, 3]
    w = np.array([w_hat[2, 1], w_hat[0, 2], w_hat[1, 0]])
    theta = np.linalg.norm(w)
    if theta < 1e-8:
        R = np.eye(3) + w_hat
        V = np.eye(3)
    else:
        K = w_hat / theta
        R = np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)
        V = (
            np.eye(3)
            + (1 - np.cos(theta)) / theta * K
            + (theta - np.sin(theta)) / theta * (K @ K)
        )
    out = np.eye(4)
    out[:3, :3] = R
    out[:3, 3] = V @ v
    return out


class _Ema:
    """Time- or step-based EMA of a matrix (reference Ema<mat4>,
    common_host.h:83-129)."""

    def __init__(self, half_life_ms: float):
        self.half_life_ms = half_life_ms  # 0 → step mode (half-life 1 step)
        self.val_ = None

    def update(self, v: np.ndarray, dt_ms: float = 1.0):
        if self.val_ is None:
            self.val_ = np.array(v, np.float64)
            return
        if self.half_life_ms <= 0:
            alpha = 0.5
        else:
            alpha = 0.5 ** (dt_ms / self.half_life_ms)
        self.val_ = alpha * self.val_ + (1.0 - alpha) * np.asarray(v, np.float64)

    def val(self) -> np.ndarray:
        return np.zeros((4, 4)) if self.val_ is None else self.val_


class MatLogCameraPredictor:
    """reference common_host.h:156-253."""

    def __init__(self, is_quadratic: bool = True, is_se3: bool = False,
                 half_life_s: float = 0.1):
        self.is_quadratic = is_quadratic
        self.is_se3 = is_se3
        self._ema_vel = _Ema(half_life_s * 1000.0)
        self._ema_acc = _Ema(half_life_s * 1000.0)
        self._prev_cam = np.eye(4)
        self._prev_log_vel = np.zeros((4, 4))
        self._n = 0

    def _log(self, m):
        return se3_log(m) if self.is_se3 else mat_log(m)

    def _exp(self, m):
        return se3_exp(m) if self.is_se3 else mat_exp(m)

    def sample_camera(self, cam: np.ndarray, delta_t: float):
        """Feed an observed camera pose (3×4 or 4×4) dt seconds after
        the previous one."""
        cam4 = _to4(cam)
        delta_t = max(delta_t, 1e-6)
        if self._n > 0:
            log_diff = self._log(cam4 @ np.linalg.inv(self._prev_cam))
            self._ema_vel.update(log_diff / delta_t, delta_t * 1000.0)
            self._ema_acc.update(
                (self._ema_vel.val() - self._prev_log_vel) / delta_t,
                delta_t * 1000.0,
            )
            self._prev_log_vel = self._ema_vel.val()
        self._prev_cam = cam4
        self._n += 1

    def predict_camera_sequence(self, time_s: float, sequence_size: int = 64):
        """Euler-integrated pose sequence out to time_s (reference
        predict_camera_sequence)."""
        out = [self._prev_cam[:3, :4]]
        vel = self._ema_vel.val()
        acc = self._ema_acc.val()
        dt = time_s / max(sequence_size - 1, 1)
        cur = self._prev_cam
        for i in range(1, sequence_size):
            if self.is_quadratic:
                mean_v = vel + (0.5 * dt) * acc
                cur = self._exp(mean_v * dt) @ cur
                vel = vel + acc * dt
            else:
                cur = self._exp(vel * (i * dt)) @ self._prev_cam
            out.append(cur[:3, :4])
        return out

    def predict_camera(self, delta_t: float) -> np.ndarray:
        """Predicted 3×4 pose delta_t seconds ahead."""
        if self._n == 0:
            return self._prev_cam[:3, :4]
        if self.is_quadratic:
            return self.predict_camera_sequence(delta_t, 64)[-1]
        return (self._exp(self._ema_vel.val() * delta_t) @ self._prev_cam)[:3, :4]


def make_predictor(mode: CameraPredictionMode | str,
                   half_life_s: float = 0.1):
    mode = CameraPredictionMode(mode) if isinstance(mode, str) else mode
    if mode == CameraPredictionMode.NONE:
        return None
    return MatLogCameraPredictor(
        is_quadratic="quadratic" in mode.value,
        is_se3="se3" in mode.value,
        half_life_s=half_life_s,
    )
