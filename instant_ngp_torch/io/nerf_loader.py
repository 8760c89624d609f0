"""NeRF scenes from disk: ``transforms.json`` → ``NerfDataset`` (port of
``instant_ngp_tpu/io/nerf_loader.py``; reference nerf_loader.cu:175-560).

``load_nerf`` reads the key set of the reference loader: natural-sorted
frames, frames whose image is missing dropped, the image extension probed
when ``file_path`` has none, global and per-frame ``fl_*`` /
``camera_angle_*`` / ``cx`` / ``cy``, ``aabb_scale`` (at most 2^(cascades
− 1)), ``scale``, ``offset`` as a scalar or a list, ``white_transparent`` /
``black_transparent``, ``rolling_shutter``, ``transform_matrix_start`` /
``_end``, per-frame ``sharpness``, the lens keys (opencv k1…p2, fisheye,
ftheta, latlong, equirectangular, orthographic), ``up`` and
``render_aabb``, ``envmap`` (its path is kept; the environment map itself
is trained from zeros), per-frame ``depth_path`` (16-bit gray PNGs times
``integer_depth_scale`` and the scene scale) and ``rays_<stem>.dat`` files
of supplied rays beside the images. Images of differing sizes are padded
into the largest canvas, each with its own size in
``per_image_resolution``. Matrices and rays go from the nerf convention to
NGP's (nerf_loader.h:101-168).

LDR pixels stay sRGB uint8 with straight alpha, as the reference reads them
back (read_rgba, common_device.cuh:846-869); HDR pixels stay linear float16.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import json
import math
import re
import warnings
from pathlib import Path
from typing import Optional

import numpy as np

from ..common import NERF_CASCADES, NERF_SCALE
from .image import load_image
from .png import read_png

IMAGE_SUFFIXES = (".png", ".jpg", ".jpeg", ".exr")


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
    sharpness: Optional[np.ndarray] = None  # (N,) per-frame sharpness from transforms.json
    n_extra_learnable_dims: int = 0
    depths: Optional[np.ndarray] = None  # (N, H, W) f32 depth supervision, scene units
    # (N, H, W, 6) per-pixel supplied rays (o ⊕ d, NGP space) from rays_<stem>.dat
    # files (reference nerf_loader.cu:644-666)
    rays: Optional[np.ndarray] = None
    from_mitsuba: bool = False
    up: np.ndarray = dataclasses.field(default_factory=lambda: np.array([0.0, 0.0, 1.0]))
    render_aabb: Optional[np.ndarray] = None  # (2, 3) min/max in NGP space
    # rotation into the crop box's local frame; None = identity
    render_aabb_to_local: Optional[np.ndarray] = None  # (3, 3)
    envmap_path: Optional[str] = None
    paths: tuple = ()
    # (N, 2) per-image (w, h) of a scene with differing sizes, each image
    # padded into the largest canvas; None for a scene of one size
    per_image_resolution: Optional[np.ndarray] = None

    @property
    def n_images(self) -> int:
        return self.images.shape[0]

    def compute_sharpness_maps(self, resolution=(72, 128)) -> np.ndarray:
        """Per-image tiled sharpness, (N, SH, SW) f32: the variance of the
        luma Laplacian in each tile (reference compute_sharpness,
        nerf_loader.cu:111-151, at its 128×72 tiles), from integral images
        of the Laplacian and its square in f64, the tiles' bounds in the
        reference's integer arithmetic."""
        sh, sw = resolution
        w, h = self.resolution
        imgs = self.images
        rgb = (imgs[..., :3].astype(np.float32) / 255.0 if imgs.dtype == np.uint8
               else imgs[..., :3].astype(np.float32))
        luma = rgb @ np.array([0.2126, 0.7152, 0.0722], np.float32)  # (N, H, W)
        c = luma[:, 1:-1, 1:-1]
        # pixel (y, x) of the interior at lap[y - 1, x - 1]
        lap = (4.0 * c - luma[:, :-2, 1:-1] - luma[:, 2:, 1:-1] - luma[:, 1:-1, :-2]
               - luma[:, 1:-1, 2:])

        def integral(a):
            return np.pad(np.cumsum(np.cumsum(a, axis=1), axis=2), ((0, 0), (1, 0), (1, 0)))

        i1, i2 = integral(lap.astype(np.float64)), integral((lap ** 2).astype(np.float64))
        out = np.zeros((self.n_images, sh, sw), np.float32)
        xs = [(max((tx * w) // sw, 1), min(((tx + 1) * w) // sw, w - 2)) for tx in range(sw)]
        ys = [(max((ty * h) // sh, 1), min(((ty + 1) * h) // sh, h - 2)) for ty in range(sh)]
        for ty, (y1, y2) in enumerate(ys):
            for tx, (x1, x2) in enumerate(xs):
                cnt = max((x2 - x1) * (y2 - y1), 1)
                a1, a2, b1, b2 = y1 - 1, y2 - 1, x1 - 1, x2 - 1
                s1 = i1[:, a2, b2] - i1[:, a1, b2] - i1[:, a2, b1] + i1[:, a1, b1]
                s2 = i2[:, a2, b2] - i2[:, a1, b2] - i2[:, a2, b1] + i2[:, a1, b1]
                m1 = s1 / cnt
                out[:, ty, tx] = np.maximum(s2 / cnt - m1 * m1, 0.0)
        return out

    def nerf_matrix_to_ngp(self, m: np.ndarray) -> np.ndarray:
        """reference nerf_loader.h:101-120."""
        m = np.array(m, np.float32)[:3, :4].copy()
        m[:, 1] *= -1.0
        m[:, 2] *= -1.0
        m[:, 3] = m[:, 3] * self.scale + np.asarray(self.offset, np.float32)
        if self.from_mitsuba:
            m[:, 0] *= -1.0
            m[:, 2] *= -1.0
        else:
            m = m[[1, 2, 0], :]
        return m

    def ngp_matrix_to_nerf(self, m: np.ndarray) -> np.ndarray:
        """reference nerf_loader.h:122-140 (the inverse of the above)."""
        m = np.array(m, np.float32)[:3, :4].copy()
        if self.from_mitsuba:
            m[:, 0] *= -1.0
            m[:, 2] *= -1.0
        else:
            m = m[[2, 0, 1], :]
        m[:, 1] *= -1.0
        m[:, 2] *= -1.0
        m[:, 3] = (m[:, 3] - np.asarray(self.offset, np.float32)) / self.scale
        return m


def _natural_key(s: str):
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s)]


def _image_path(base_dir: Path, frame: dict) -> Optional[Path]:
    """The frame's image file, its extension probed when ``file_path`` has
    none; None when it is missing."""
    p = base_dir / frame["file_path"]
    if p.suffix:
        return p if p.exists() else None
    return next((p.with_suffix(e) for e in IMAGE_SUFFIXES if p.with_suffix(e).exists()), None)


def _focal(d: dict, axis: str, res: int, other=None):
    if f"fl_{axis}" in d:
        return float(d[f"fl_{axis}"])
    if f"camera_angle_{axis}" in d:
        return 0.5 * res / math.tan(0.5 * float(d[f"camera_angle_{axis}"]))
    return other


def load_nerf(path) -> NerfDataset:
    """Load a NeRF scene from a ``transforms.json`` or a directory holding
    one (the first ``*transforms*.json`` in name order)."""
    path = Path(path)
    if path.is_dir():
        json_paths = sorted(path.glob("*.json"))
        json_paths = [p for p in json_paths if "transforms" in p.name] or json_paths
        if not json_paths:
            raise FileNotFoundError(f"no transforms json in {path}")
        json_path = json_paths[0]
    else:
        json_path = path
    base_dir = json_path.parent
    with open(json_path) as f:
        meta = json.load(f)

    aabb_scale = int(meta.get("aabb_scale", 1))
    max_aabb = 1 << (NERF_CASCADES - 1)
    if aabb_scale > max_aabb:
        raise ValueError(f"aabb_scale must be <= {max_aabb}, got {aabb_scale}")
    scale = float(meta.get("scale", NERF_SCALE))
    offset = np.array(meta.get("offset", [0.5, 0.5, 0.5]), np.float32)
    if np.isscalar(meta.get("offset")):
        offset = np.full(3, float(meta["offset"]), np.float32)

    frames = sorted(meta["frames"], key=lambda fr: _natural_key(fr.get("file_path", "")))
    image_paths = [_image_path(base_dir, fr) for fr in frames]
    kept = [i for i, p in enumerate(image_paths) if p is not None]
    if len(kept) < len(frames):
        warnings.warn(f"skipped {len(frames) - len(kept)} frames with missing image files")
    frames = [frames[i] for i in kept]
    image_paths = [image_paths[i] for i in kept]

    with cf.ThreadPoolExecutor(max_workers=16) as pool:
        results = list(pool.map(load_image, image_paths))
    imgs = [r[0] for r in results]
    paths = tuple(str(p) for p in image_paths)
    is_hdr = results[0][1]
    sizes = np.asarray([[im.shape[1], im.shape[0]] for im in imgs])  # (N, 2) wh
    mixed = bool((sizes != sizes[0]).any())
    w, h = int(sizes[:, 0].max()), int(sizes[:, 1].max())
    if mixed:
        # each image padded into the largest canvas; uv maps stay per image
        # (reference TrainingImageMetadata.resolution)
        padded = []
        for im in imgs:
            canvas = np.zeros((h, w, im.shape[2]), im.dtype)
            canvas[:im.shape[0], :im.shape[1]] = im
            padded.append(canvas)
        imgs = padded
    if is_hdr:
        images = np.stack(imgs).astype(np.float16)
    else:
        images = (np.stack(imgs) * 255.0 + 0.5).astype(np.uint8)
    rays = _load_rays(paths, sizes, (w, h), scale, offset)

    if meta.get("white_transparent") or meta.get("black_transparent"):
        # alpha from luminance (reference nerf_loader.cu mask handling)
        lum = images[..., :3].astype(np.float32).mean(-1)
        if meta.get("white_transparent"):
            alpha = 255.0 - lum if not is_hdr else 1.0 - lum
        else:
            alpha = lum
        images[..., 3] = alpha.astype(images.dtype)

    n = len(frames)
    focal_lengths = np.zeros((n, 2), np.float32)
    principal = np.zeros((n, 2), np.float32)
    xf_start = np.zeros((n, 3, 4), np.float32)
    xf_end = np.zeros((n, 3, 4), np.float32)
    rolling = np.zeros((n, 4), np.float32)
    sharp = np.zeros((n,), np.float32)
    ds = NerfDataset(
        images=images, is_hdr=is_hdr, xforms_start=xf_start, xforms_end=xf_end,
        focal_lengths=focal_lengths, principal_points=principal, rolling_shutter=rolling,
        resolution=(w, h), aabb_scale=aabb_scale, scale=scale, offset=offset,
        from_mitsuba=bool(meta.get("from_mitsuba", False)),
        n_extra_learnable_dims=int(meta.get("n_extra_learnable_dims", 0)), paths=paths,
        per_image_resolution=sizes.astype(np.int32) if mixed else None, rays=rays)

    fx_g = _focal(meta, "x", w)
    fy_g = _focal(meta, "y", h, other=fx_g)
    if fx_g is None:
        fx_g = fy_g
    cx_g = float(meta.get("cx", 0.5 * w)) / w
    cy_g = float(meta.get("cy", 0.5 * h)) / h
    rs_g = np.array(meta.get("rolling_shutter", [0, 0, 0, 0]), np.float32)
    for i, fr in enumerate(frames):
        wi, hi = int(sizes[i, 0]), int(sizes[i, 1])
        # a global camera_angle falls back at the image's own resolution
        fx = _focal(fr, "x", wi, other=_focal(meta, "x", wi, other=fx_g))
        fy = _focal(fr, "y", hi, other=_focal(meta, "y", hi, other=fy_g)) or fx
        focal_lengths[i] = (fx, fy if fy else fx)
        principal[i] = (float(fr["cx"]) / wi if "cx" in fr else cx_g,
                        float(fr["cy"]) / hi if "cy" in fr else cy_g)
        rolling[i] = np.array(fr.get("rolling_shutter", rs_g), np.float32)
        m = fr.get("transform_matrix", fr.get("transform_matrix_start"))
        m_end = fr.get("transform_matrix_end", m)
        xf_start[i] = ds.nerf_matrix_to_ngp(np.array(m, np.float32))
        xf_end[i] = ds.nerf_matrix_to_ngp(np.array(m_end, np.float32))
        sharp[i] = float(fr.get("sharpness", 1.0))
    ds.sharpness = sharp

    ds.lens_params = np.array([float(meta.get(k, 0.0)) for k in ("k1", "k2", "p1", "p2")],
                              np.float32)
    ds.lens_mode = "opencv" if np.any(ds.lens_params != 0) else "perspective"
    if meta.get("fisheye") or meta.get("is_fisheye"):
        ds.lens_mode = "opencv_fisheye"
    if "ftheta_p0" in meta:
        # (p0..p4, w, h): the uv offset is rescaled to the intrinsics'
        # resolution (reference nerf_loader.cu:218-227)
        ds.lens_params = np.array([float(meta[f"ftheta_p{i}"]) for i in range(5)]
                                  + [float(meta["w"]), float(meta["h"])], np.float32)
        ds.lens_mode = "ftheta"
    if "latlong" in meta:
        ds.lens_mode = "latlong"
    elif "equirectangular" in meta:
        ds.lens_mode = "equirectangular"
    elif "orthographic" in meta:
        ds.lens_mode = "orthographic"
    if "up" in meta:
        ds.up = np.array(meta["up"], np.float32)
    if "render_aabb" in meta:
        ds.render_aabb = np.array(meta["render_aabb"], np.float32).reshape(2, 3)
    if "envmap" in meta:
        ds.envmap_path = str(base_dir / meta["envmap"])
    if any("depth_path" in fr for fr in frames):
        # 16-bit depth maps (reference nerf_loader.cu:392-404)
        depth_scale = float(meta.get("integer_depth_scale", 1.0 / 65535.0))
        ds.depths = np.zeros((n, h, w), np.float32)
        for i, fr in enumerate(frames):
            if "depth_path" in fr:
                dimg = read_png(base_dir / fr["depth_path"])[..., 0]
                ds.depths[i] = dimg.astype(np.float32) * depth_scale * scale
    return ds


def _load_rays(paths, sizes: np.ndarray, canvas, scale: float,
               offset: np.ndarray) -> Optional[np.ndarray]:
    """The supplied rays of a scene whose images have ``rays_<stem>.dat``
    files beside them (per pixel six f32, origin and direction, in the nerf
    convention; reference nerf_loader.cu:644-666), as (N, H, W, 6) in NGP
    space: the origin scaled and offset, both cycled xyz → yzx
    (nerf_ray_to_ngp, nerf_loader.h:153-168); zeros for an image without a
    file. None where no image has one."""
    ray_files = [Path(p).parent / f"rays_{Path(p).stem}.dat" for p in paths]
    if not any(rf.exists() for rf in ray_files):
        return None
    w, h = canvas
    rays = np.zeros((len(paths), h, w, 6), np.float32)
    for i, rf in enumerate(ray_files):
        wi, hi = int(sizes[i, 0]), int(sizes[i, 1])
        if not rf.exists():
            warnings.warn(f"missing rays file {rf}; frame {i} rays zeroed")
            continue
        raw = np.fromfile(rf, np.float32)
        if raw.size < wi * hi * 6:
            raise ValueError(f"rays file {rf} too small: {raw.size}")
        r = raw[:wi * hi * 6].reshape(hi, wi, 6)
        o = r[..., :3] * scale + offset[None, None, :]
        rays[i, :hi, :wi, :3] = o[..., [1, 2, 0]]
        rays[i, :hi, :wi, 3:] = r[..., 3:][..., [1, 2, 0]]
    return rays
