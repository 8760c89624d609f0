"""NeRF dataset record (port of the ``NerfDataset`` fields of
``instant_ngp_tpu/io/nerf_loader.py`` that a snapshot's dataset block
fills and the training step reads). Reading scenes from disk is not
ported yet: a training set is built in memory."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..common import NERF_SCALE


@dataclasses.dataclass
class NerfDataset:
    # images: (N, H, W, 4) uint8 (sRGB, straight alpha; float16 linear
    # when is_hdr); all zero when the dataset comes from a snapshot
    # (cameras only)
    images: np.ndarray
    is_hdr: bool
    # camera-to-world transforms in NGP coords, (N, 3, 4)
    xforms_start: np.ndarray
    xforms_end: np.ndarray
    focal_lengths: np.ndarray  # (N, 2)
    principal_points: np.ndarray  # (N, 2)
    rolling_shutter: np.ndarray  # (N, 4)
    resolution: tuple[int, int]  # (W, H)
    aabb_scale: int = 1
    scale: float = NERF_SCALE
    offset: np.ndarray = dataclasses.field(default_factory=lambda: np.array([0.5, 0.5, 0.5]))
    lens_params: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(4))  # k1,k2,p1,p2
    lens_mode: str = "perspective"
    n_extra_learnable_dims: int = 0
    depths: Optional[np.ndarray] = None  # (N, H, W) depth supervision: not ported
    rays: Optional[np.ndarray] = None  # (N, H, W, 6) supplied rays: not ported
    from_mitsuba: bool = False
    up: np.ndarray = dataclasses.field(default_factory=lambda: np.array([0.0, 0.0, 1.0]))
    render_aabb: Optional[np.ndarray] = None  # (2, 3) min/max in NGP space
    # rotation into the crop box's local frame; None = identity
    render_aabb_to_local: Optional[np.ndarray] = None  # (3, 3)
    paths: tuple = ()

    @property
    def n_images(self) -> int:
        return self.images.shape[0]
