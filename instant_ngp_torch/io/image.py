"""Image IO (port of ``instant_ngp_tpu/io/image.py``): EXR (HDR), PNG
through the package's own codec (``io/png.py``), the other LDR formats
through PIL, and the raw ``.bin`` gigapixel format (reference
testbed_image.cu:393-457: an int32 pair header, then fp16 RGBA).

The ``.bin`` header is read and written as (h, w), as the JAX package
does (its docstring says "w,h"), so that files round-trip with it.

LDR images load as sRGB floats in [0, 1]; EXR and ``.bin`` images load as
linear values (is_hdr True). PIL is imported only for LDR formats other
than PNG.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from .exr import read_exr, write_exr
from .png import read_png, write_png


def load_image(path) -> tuple[np.ndarray, bool]:
    """Load an image → ((H, W, 4) float32, is_hdr)."""
    path = Path(path)
    suffix = path.suffix.lower()
    if suffix == ".exr":
        return _ensure_rgba(read_exr(path)), True
    if suffix == ".bin":
        with open(path, "rb") as f:
            h, w = struct.unpack("<ii", f.read(8))
            half = np.fromfile(f, np.float16, w * h * 4)
        if half.size != w * h * 4:
            raise ValueError(f"{path}: {half.size} values for a {w}x{h} RGBA image")
        return half.astype(np.float32).reshape(h, w, 4), True
    if suffix == ".png":
        return _bytes_to_rgba(read_png(path)).astype(np.float32) / 255.0, False
    from PIL import Image

    with Image.open(path) as im:
        img = np.asarray(im.convert("RGBA"), np.float32) / 255.0
    return img, False


def save_image(path, img: np.ndarray) -> None:
    """Save (H, W, C) float32. EXR and ``.bin`` stay linear; LDR formats
    expect sRGB-encoded values in [0, 1]."""
    path = Path(path)
    suffix = path.suffix.lower()
    if suffix == ".exr":
        write_exr(path, img)
        return
    if suffix == ".bin":
        h, w = img.shape[:2]
        with open(path, "wb") as f:
            f.write(struct.pack("<ii", h, w))
            f.write(_ensure_rgba(img).astype(np.float16).tobytes())
        return
    arr = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if arr.shape[-1] == 1:
        arr = arr[..., 0]
    if suffix == ".png":
        write_png(path, arr)
        return
    from PIL import Image

    Image.fromarray(arr).save(path)


def _bytes_to_rgba(px: np.ndarray) -> np.ndarray:
    """(H, W, C) uint8 → (H, W, 4), as PIL's ``convert("RGBA")``: gray
    is copied to R, G and B, and a missing alpha is 255."""
    c = px.shape[-1]
    gray = c <= 2
    rgb = np.repeat(px[..., :1], 3, axis=-1) if gray else px[..., :3]
    alpha = px[..., -1:] if c in (2, 4) else np.full(px.shape[:-1] + (1,), 255, np.uint8)
    return np.concatenate([rgb, alpha], axis=-1)


def _ensure_rgba(img: np.ndarray) -> np.ndarray:
    if img.ndim == 2:
        img = img[..., None]
    c = img.shape[-1]
    if c == 4:
        return img
    if c == 3:
        return np.concatenate([img, np.ones((*img.shape[:-1], 1), img.dtype)], axis=-1)
    if c == 1:
        return np.concatenate([img] * 3 + [np.ones_like(img)], axis=-1)
    raise ValueError(f"unsupported channel count {c}")
