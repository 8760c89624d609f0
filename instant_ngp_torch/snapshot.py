"""Snapshot save and load (port of ``instant_ngp_tpu/snapshot.py``;
reference save_snapshot / load_snapshot, testbed.cu:5288-5491).

Layout: the full network config dict plus a ``"snapshot"`` subobject:
version, mode, training_step, loss, camera, ``params_type`` "__half" and
``params_binary`` (fp16 blob in tcnn packing order [density_net, rgb_net,
pos_enc per level, dir_enc]; MLP matrices stored (out, in) at widths padded
to 16), ``density_grid_size`` and ``density_grid_binary`` (fp16,
Morton-ordered per cascade), ``nerf`` {aabb_scale, rgb.rays_per_batch,
dataset}, and optionally ``optimizer_state`` and ``cam_offsets`` as
``pack_tree`` lists. ``.ingp`` files are zlib-compressed msgpack;
``.msgpack`` is raw. The package's own msgpack codec reads and writes them,
so snapshots need no msgpack module.

Trees (parameters, optimizer state, camera offsets) move in the JAX
package's layout as numpy arrays: ``tree_leaves`` gives their leaves in
``jax.tree.leaves`` order without importing JAX.
"""

from __future__ import annotations

import zlib
from pathlib import Path

import numpy as np

from .io import msgpack_lite
from .io.nerf_loader import NerfDataset

SNAPSHOT_FORMAT_VERSION = 1


def _pad16(v: int) -> int:
    return (v + 15) // 16 * 16


def _pack_params(params: dict) -> np.ndarray:
    """A JAX-layout parameter tree → the tcnn fp16 blob [density_net,
    rgb_net (or net), pos_enc (or enc) per level, dir_enc]: matrices
    transposed to (out, in) at widths padded to 16 with zeros, everything
    rounded to fp16 by numpy, as the JAX package rounds it."""
    blobs = []
    for net_key in ("density_net", "rgb_net", "net"):
        for w in params.get(net_key, ()):
            w = np.asarray(w, np.float32)
            fan_in, fan_out = w.shape
            pw = np.zeros((_pad16(fan_out), _pad16(fan_in)), np.float32)
            pw[:fan_out, :fan_in] = w.T
            blobs.append(pw.reshape(-1))
    for enc_key in ("pos_enc", "enc"):
        if enc_key in params:
            tbl = params[enc_key]
            leaves = tbl if isinstance(tbl, (list, tuple)) else (tbl,)
            blobs += [np.asarray(leaf, np.float32).reshape(-1) for leaf in leaves]
    dir_leaves = params.get("dir_enc")
    if dir_leaves is not None:
        if not isinstance(dir_leaves, (list, tuple)):
            dir_leaves = (dir_leaves,)
        blobs += [np.asarray(leaf, np.float32).reshape(-1) for leaf in dir_leaves
                  if leaf is not None]
    return np.concatenate(blobs).astype(np.float16) if blobs else np.zeros(0, np.float16)


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


def lens_to_json(mode: str, params) -> dict:
    """Lens → json (reference json_binding.h:37-65 to_json(Lens))."""
    p = np.asarray(params, np.float32).reshape(-1)
    p = np.concatenate([p, np.zeros(max(0, 7 - p.size), np.float32)])
    if mode == "opencv":
        return {"is_fisheye": False, "k1": float(p[0]), "k2": float(p[1]),
                "p1": float(p[2]), "p2": float(p[3])}
    if mode == "opencv_fisheye":
        return {"is_fisheye": True, "k1": float(p[0]), "k2": float(p[1]),
                "k3": float(p[2]), "k4": float(p[3])}
    if mode == "ftheta":
        return {f"ftheta_p{i}": float(p[i]) for i in range(5)} | {
            "w": float(p[5]), "h": float(p[6])}
    if mode in ("latlong", "equirectangular", "orthographic"):
        return {mode: True}
    return {}


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


def _mat_cols(m: np.ndarray) -> list:
    """(3, 4) row-major → 4 column vec3s (tcnn's mat4x3 json layout)."""
    return np.asarray(m, np.float32).T.tolist()


def _mat_from_json(v) -> np.ndarray:
    """Accept a mat4x3 as 4 columns of 3 (tcnn vec_json) or (3, 4)
    rows; return (3, 4) row-major."""
    a = np.asarray(v, np.float32)
    if a.shape == (4, 3):
        return a.T.copy()
    if a.shape == (3, 4):
        return a.copy()
    raise ValueError(f"unrecognized xform shape {a.shape}")


def dataset_to_json(ds: NerfDataset) -> dict:
    """NerfDataset → the reference snapshot schema (json_binding.h:112-137
    to_json(NerfDataset)). No crop box is written as the reference's empty
    box (min +inf, max −inf), which ``dataset_from_json`` reads back as no
    crop."""
    n = int(ds.n_images)
    w, h = int(ds.resolution[0]), int(ds.resolution[1])
    lens = lens_to_json(ds.lens_mode, ds.lens_params)
    metadata = [{
        "focal_length": np.asarray(ds.focal_lengths[i], np.float32).tolist(),
        "lens": lens,
        "principal_point": np.asarray(ds.principal_points[i], np.float32).tolist(),
        "rolling_shutter": np.asarray(ds.rolling_shutter[i], np.float32).tolist(),
        "resolution": [w, h],
    } for i in range(n)]
    xforms = [{"start": _mat_cols(ds.xforms_start[i]), "end": _mat_cols(ds.xforms_end[i])}
              for i in range(n)]
    if ds.render_aabb is not None:
        ra = {"min": np.asarray(ds.render_aabb[0], np.float32).tolist(),
              "max": np.asarray(ds.render_aabb[1], np.float32).tolist()}
    else:
        inf = float("inf")
        ra = {"min": [inf, inf, inf], "max": [-inf, -inf, -inf]}
    return {
        "n_images": n,
        "paths": [str(p) for p in ds.paths] or [""] * n,
        "metadata": metadata,
        "xforms": xforms,
        "render_aabb": ra,
        "render_aabb_to_local": np.eye(3, dtype=np.float32).tolist(),
        "up": np.asarray(ds.up, np.float32).tolist(),
        "offset": np.asarray(ds.offset, np.float32).tolist(),
        "envmap_resolution": [0, 0],
        "scale": float(ds.scale),
        "aabb_scale": int(ds.aabb_scale),
        "from_mitsuba": bool(ds.from_mitsuba),
        "is_hdr": bool(ds.is_hdr),
        "wants_importance_sampling": True,
        "n_extra_learnable_dims": int(ds.n_extra_learnable_dims),
    }


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


def tree_leaves(tree) -> list:
    """The leaves of a nested dict / list / tuple tree in ``jax.tree.leaves``
    order: dict entries by sorted key, lists and tuples in their order,
    None dropped (an empty subtree to JAX); anything else is a leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(template, leaves: list):
    """``template``'s structure with its leaves replaced, in
    ``tree_leaves`` order, by ``leaves``."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def pack_tree(tree) -> list:
    """A tree of arrays → [[dtype, shape, bytes], ...] in ``jax.tree.leaves``
    order (the JAX package's optimizer-state and camera-offset format)."""
    out = []
    for leaf in tree_leaves(tree):
        a = np.asarray(leaf)
        out.append([str(a.dtype), list(a.shape), a.tobytes()])
    return out


def unpack_tree(packed: list, template):
    """The inverse of ``pack_tree`` onto ``template``'s structure; each leaf
    takes the dtype and shape that the file states."""
    n_leaves = len(tree_leaves(template))
    if len(packed) != n_leaves:
        raise ValueError(f"optimizer-state leaf count mismatch: snapshot has {len(packed)}, "
                         f"template needs {n_leaves}")
    return tree_unflatten(template, [np.frombuffer(raw, dtype=np.dtype(dt)).reshape(shape)
                                     for dt, shape, raw in packed])


def unpack_cam_offsets(packed: list) -> dict:
    """A snapshot's ``cam_offsets`` (``pack_tree`` of the camera state, its
    keys sorted: [distortion], [envmap], exposure, [extra], focal, pos, rot)
    as a dict of numpy arrays. Which of the optional leaves it holds follows
    from the count and the leading leaves' shapes (the distortion map's is
    (h, w, 2), the environment map's (h, w, 4))."""
    leaves = [np.frombuffer(raw, dtype=np.dtype(dt)).reshape(shape) for dt, shape, raw in packed]
    keys = []
    for key, channels in (("distortion", 2), ("envmap", 4)):
        i = len(keys)
        if i < len(leaves) and leaves[i].ndim == 3 and leaves[i].shape[2] == channels:
            keys.append(key)
    keys += ["exposure", "focal", "pos", "rot"]
    if len(leaves) == len(keys) + 1:
        keys.insert(keys.index("focal"), "extra")
    if len(leaves) != len(keys):
        raise ValueError(f"camera offsets of {len(leaves)} leaves: not a camera state")
    return dict(zip(keys, leaves))


def save_snapshot(path, network_config: dict, params: dict, mode: str, training_step: int = 0,
                  loss: float = 0.0, density_grid: np.ndarray | None = None,
                  nerf_extra: dict | None = None, camera: dict | None = None,
                  optimizer_state=None, cam_offsets=None) -> None:
    """Write a snapshot document (the JAX package's ``save_snapshot``, key
    for key): trees are numpy trees in the JAX layout; the density grid
    (n_cascades, G, G, G) is stored fp16, Morton-ordered per cascade."""
    from .ops.morton import dense_to_morton_perm

    snapshot = {
        "version": SNAPSHOT_FORMAT_VERSION,
        "mode": mode,
        "training_step": int(training_step),
        "loss": float(loss),
        "params_type": "__half",
        "params_binary": _pack_params(params).tobytes(),
    }
    if camera:
        snapshot["camera"] = camera
    if density_grid is not None:
        g = int(density_grid.shape[-1])
        flat = np.asarray(density_grid, np.float32).reshape(density_grid.shape[0], -1)
        snapshot["density_grid_size"] = g
        snapshot["density_grid_binary"] = flat[:, dense_to_morton_perm(g)].astype(
            np.float16).tobytes()
    if nerf_extra:
        snapshot["nerf"] = nerf_extra
    if optimizer_state is not None:
        snapshot["optimizer_state"] = pack_tree(optimizer_state)
    if cam_offsets is not None:
        snapshot["cam_offsets"] = pack_tree(cam_offsets)
    doc = dict(network_config)
    doc["snapshot"] = snapshot
    data = msgpack_lite.packb(doc)
    path = Path(path)
    if path.suffix == ".ingp":
        data = zlib.compress(data)
    path.write_bytes(data)


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
