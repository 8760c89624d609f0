"""Snapshot loading (port of the load side of ``instant_ngp_tpu/snapshot.py``).

Layout: the full network config dict plus a ``"snapshot"`` subobject with
``params_binary`` (fp16 blob in tcnn packing order [density_net, rgb_net,
pos_enc per level, dir_enc]; MLP matrices stored (out, in) at widths padded
to 16) and ``density_grid_binary`` (fp16, Morton-ordered per cascade).
``.ingp`` files are zlib-compressed msgpack; ``.msgpack`` is raw. Decoding
uses the package's own msgpack reader, so loading needs no msgpack module.
"""

from __future__ import annotations

import zlib
from pathlib import Path

import numpy as np

from .io import msgpack_lite
from .io.nerf_loader import NerfDataset


def _pad16(v: int) -> int:
    return (v + 15) // 16 * 16


def _unpack_params(blob: np.ndarray, params_template: dict) -> dict:
    """Split the tcnn flat fp16 blob into the template's shapes (f32)."""
    out = {}
    pos = 0

    def take(shape):
        nonlocal pos
        n = int(np.prod(shape))
        arr = blob[pos : pos + n].astype(np.float32).reshape(shape)
        pos += n
        return arr

    for net_key in ("density_net", "rgb_net", "net"):
        if net_key in params_template:
            ws = []
            for w in params_template[net_key]:
                fan_in, fan_out = w.shape
                wt = take((_pad16(fan_out), _pad16(fan_in)))
                ws.append(wt[:fan_out, :fan_in].T)
            out[net_key] = ws
    for enc_key in ("pos_enc", "enc"):
        if enc_key in params_template:
            tmpl = params_template[enc_key]
            if isinstance(tmpl, (list, tuple)):  # per-level hash-grid leaves
                out[enc_key] = tuple(take(np.shape(t)) for t in tmpl)
            else:
                out[enc_key] = take(np.shape(tmpl))
    if "dir_enc" in params_template and params_template["dir_enc"] is not None:
        tmpl = params_template["dir_enc"]
        if isinstance(tmpl, (list, tuple)):
            out["dir_enc"] = [None if t is None else take(np.shape(t)) for t in tmpl]
        else:
            out["dir_enc"] = take(np.shape(tmpl))
    if pos != blob.size:
        # fail loudly on layout mismatch: a silent under-read would
        # misalign every tensor after the first wrong one
        raise ValueError(
            f"snapshot params_binary layout mismatch: consumed {pos} of "
            f"{blob.size} halfs — wrong network config or incompatible "
            f"packing"
        )
    return out


def lens_from_json(j: dict) -> tuple[str, np.ndarray]:
    """json → (mode, params) (reference json_binding.h:67-100)."""
    j = j or {}
    if "k1" in j:
        if j.get("is_fisheye", False):
            return "opencv_fisheye", np.asarray(
                [j["k1"], j["k2"], j.get("k3", 0.0), j.get("k4", 0.0)], np.float32)
        return "opencv", np.asarray(
            [j["k1"], j["k2"], j.get("p1", 0.0), j.get("p2", 0.0)], np.float32)
    if "ftheta_p0" in j:
        return "ftheta", np.asarray(
            [j[f"ftheta_p{i}"] for i in range(5)] + [j["w"], j["h"]], np.float32)
    if j.get("latlong"):
        return "latlong", np.zeros(4, np.float32)
    if j.get("equirectangular"):
        return "equirectangular", np.zeros(4, np.float32)
    if j.get("orthographic"):
        return "orthographic", np.zeros(4, np.float32)
    return "perspective", np.zeros(4, np.float32)


def _mat_from_json(v) -> np.ndarray:
    """Accept a mat4x3 as 4 columns of 3 (tcnn vec_json) or (3, 4)
    rows; return (3, 4) row-major."""
    a = np.asarray(v, np.float32)
    if a.shape == (4, 3):
        return a.T.copy()
    if a.shape == (3, 4):
        return a.copy()
    raise ValueError(f"unrecognized xform shape {a.shape}")


def dataset_from_json(block: dict) -> NerfDataset:
    """Reference snapshot dataset block → NerfDataset with zero images
    (json_binding.h:139-188). Handles both the per-image `metadata` array
    and the global-default fields."""
    n = int(block["n_images"])
    g_focal = block.get("focal_length")
    g_pp = block.get("principal_point", [0.5, 0.5])
    g_rs = block.get("rolling_shutter", [0, 0, 0, 0])
    g_res = block.get("image_resolution")
    g_lens = block.get("lens", block.get("camera_distortion"))

    focals = np.zeros((n, 2), np.float32)
    pps = np.zeros((n, 2), np.float32)
    rss = np.zeros((n, 4), np.float32)
    res = None
    lens_j = g_lens
    metadata = block.get("metadata")
    for i in range(n):
        mi = metadata[i] if metadata else {}
        focals[i] = np.asarray(mi.get("focal_length", g_focal or [0.0, 0.0]))[:2]
        pps[i] = np.asarray(mi.get("principal_point", g_pp))[:2]
        rss[i] = np.asarray(mi.get("rolling_shutter", g_rs))[:4]
        if res is None:
            res = mi.get("resolution", g_res)
        if lens_j is None:
            lens_j = mi.get("lens", mi.get("camera_distortion"))
    w, h = (int(res[0]), int(res[1])) if res is not None else (0, 0)

    xforms_start = np.zeros((n, 3, 4), np.float32)
    xforms_end = np.zeros((n, 3, 4), np.float32)
    for i, xf in enumerate(block["xforms"]):
        if isinstance(xf, dict):
            xforms_start[i] = _mat_from_json(xf["start"])
            xforms_end[i] = _mat_from_json(xf["end"])
        else:  # bare matrix
            xforms_start[i] = xforms_end[i] = _mat_from_json(xf)

    lens_mode, lens_params = lens_from_json(lens_j or {})
    ra = block.get("render_aabb")
    render_aabb = None
    if isinstance(ra, dict):
        render_aabb = np.asarray([ra["min"], ra["max"]], np.float32)
        if (render_aabb[1] < render_aabb[0]).any():
            # the reference's empty box means "no crop"
            render_aabb = None
    return NerfDataset(
        images=np.zeros((n, h, w, 4), np.uint8),
        is_hdr=bool(block.get("is_hdr", False)),
        xforms_start=xforms_start,
        xforms_end=xforms_end,
        focal_lengths=focals,
        principal_points=pps,
        rolling_shutter=rss,
        resolution=(w, h),
        aabb_scale=int(block.get("aabb_scale", 1)),
        scale=float(block.get("scale", 0.33)),
        offset=np.asarray(block.get("offset", [0.5, 0.5, 0.5]), np.float32),
        lens_params=lens_params,
        lens_mode=lens_mode,
        n_extra_learnable_dims=int(block.get("n_extra_learnable_dims", 0)),
        from_mitsuba=bool(block.get("from_mitsuba", False)),
        up=np.asarray(block.get("up", [0.0, 0.0, 1.0]), np.float32),
        render_aabb=render_aabb,
        paths=tuple(block.get("paths", ())),
    )


def load_snapshot_file(path) -> dict:
    path = Path(path)
    data = path.read_bytes()
    if path.suffix == ".ingp" or data[:1] == b"\x78":
        try:
            data = zlib.decompress(data)
        except zlib.error:
            pass  # a raw msgpack body whose first byte looks like zlib's
    return msgpack_lite.unpackb(data)


def restore_params(snapshot: dict, params_template: dict) -> dict:
    blob = np.frombuffer(snapshot["params_binary"], np.float16)
    return _unpack_params(blob, params_template)


def restore_density_grid(snapshot: dict, n_cascades: int) -> np.ndarray | None:
    from .ops.morton import morton_to_dense_perm

    if "density_grid_binary" not in snapshot:
        return None
    g = int(snapshot.get("density_grid_size", 128))
    raw = np.frombuffer(snapshot["density_grid_binary"], np.float16).astype(np.float32)
    n_casc = raw.size // (g**3)
    perm = morton_to_dense_perm(g)
    grids = raw.reshape(n_casc, -1)[:, perm].reshape(n_casc, g, g, g)
    if n_casc < n_cascades:
        grids = np.concatenate(
            [grids, np.zeros((n_cascades - n_casc, g, g, g), np.float32)]
        )
    return grids[:n_cascades]
