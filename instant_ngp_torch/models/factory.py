"""Hash-grid autoconfiguration (port of ``instant_ngp_tpu/models/factory.py``).

When ``per_level_scale`` is absent it is derived so the finest level
reaches a desired resolution over the scene:

    b = exp(ln(desired_res · aabb_scale / base_res) / (n_levels − 1))

with desired_res = 2048 (NeRF/SDF), max(image res)/2 (image), or the
volume's world-to-index scale.
"""

from __future__ import annotations

import math


def autoconfig_grid_encoding(
    encoding_cfg: dict,
    mode: str,
    aabb_scale: int = 1,
    image_resolution: tuple[int, int] | None = None,
    volume_world2index_scale: float | None = None,
) -> dict:
    """Return encoding config with derived base_resolution/per_level_scale."""
    cfg = dict(encoding_cfg)
    otype = str(cfg.get("otype", "OneBlob")).lower()
    if "grid" not in otype and "permuto" not in otype:
        return cfg

    n_features_per_level = int(cfg.get("n_features_per_level", 2))
    if cfg.get("n_features", 0):
        n_levels = int(cfg["n_features"]) // n_features_per_level
    else:
        n_levels = int(cfg.get("n_levels", 16))
    log2_hashmap_size = int(cfg.get("log2_hashmap_size", 15))
    n_pos_dims = 2 if mode == "image" else 3

    base_resolution = int(cfg.get("base_resolution", 0))
    if not base_resolution:
        base_resolution = 1 << (log2_hashmap_size // n_pos_dims)
        cfg["base_resolution"] = base_resolution

    desired_resolution = 2048.0
    if mode == "image" and image_resolution is not None:
        desired_resolution = max(image_resolution) / 2.0
    elif mode == "volume" and volume_world2index_scale is not None:
        desired_resolution = volume_world2index_scale

    per_level_scale = float(cfg.get("per_level_scale", 0.0))
    if per_level_scale <= 0.0 and n_levels > 1:
        per_level_scale = math.exp(
            math.log(desired_resolution * aabb_scale / base_resolution) / (n_levels - 1)
        )
        cfg["per_level_scale"] = per_level_scale
    return cfg
