"""Scenes from disk in the PyTorch port, against the JAX package on the CPU:
the PNG codec against PIL (8- and 16-bit), the scene generator,
``load_nerf`` field by field (also on scenes with images of two sizes,
supplied rays, 16-bit depth maps, an envmap, start and end transforms and
rolling shutters), and one training step from a scene loaded from disk."""

import contextlib
import dataclasses
import io
import json
import struct
import zlib

import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import __graft_entry__ as graft
from instant_ngp_tpu.io.nerf_loader import load_nerf as jax_load_nerf
from instant_ngp_tpu.io.synthetic import generate_synthetic_dataset as jax_generate
from instant_ngp_tpu.nerf.sampler import march_rays as jax_march
from instant_ngp_tpu.nerf.task import NerfTask as JaxNerfTask
from instant_ngp_torch.io import png
from instant_ngp_torch.io.image import load_image
from instant_ngp_torch.io.nerf_loader import load_nerf
from instant_ngp_torch.io.synthetic import generate_synthetic_dataset
from instant_ngp_torch.models.nerf_network import train_state_from_jax, train_state_to_numpy
from instant_ngp_torch.nerf import train as port_train
from instant_ngp_torch.nerf.task import NerfTask
from test_torch_snapshot import _assert_datasets_equal
from test_torch_train_step import ITERS, K, R, TARGET, _grid, _jax_step_with_grads, _t

torch.set_num_threads(2)

MODES = (("L", 1), ("LA", 2), ("RGB", 3), ("RGBA", 4))
SCENE_ARGS = dict(res=32, n_train=4, n_test=2, n_steps=64)


def _all_filters_image(h, w, c, seed):
    """Content on which PIL's adaptive filtering picks every filter type:
    constant rows (None), smooth noisy rows (Sub, Up, Paeth) and rows that
    average their left neighbour and a random row above (Average)."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:h, 0:w]
    smooth = (np.sin(xs / 7.0) * 60 + np.cos(ys / 5.0) * 60 + 128)[..., None] + 20 * np.arange(c)
    v = np.clip(smooth + rng.integers(0, 40, (h, w, c)), 0, 255).astype(np.int64)
    v[4:8] = 0
    for y in range(9, 20, 2):
        v[y - 1] = rng.integers(0, 256, (w, c))
        left = np.zeros(c, np.int64)
        for x in range(w):
            v[y, x] = (left + v[y - 1, x]) >> 1
            left = v[y, x]
    return v.astype(np.uint8)


def _filters_used(data: bytes, h: int) -> set:
    idat = b"".join(body for kind, body in png._chunks(data) if kind == b"IDAT")
    return set(np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)[:, 0].tolist())


def _pil(data: bytes) -> np.ndarray:
    a = np.asarray(Image.open(io.BytesIO(data)))
    return a[..., None] if a.ndim == 2 else a


@pytest.mark.parametrize("writer", ["pil", "imageio"])
@pytest.mark.parametrize("mode,c", MODES)
def test_png_decodes_pil_and_imageio_files_bit_equal(mode, c, writer):
    """PIL with optimize=True uses all five filters on this content;
    imageio (through PIL's default heuristic) uses None, Sub, Up and Paeth."""
    img = _all_filters_image(64, 48, c, c)
    buf = io.BytesIO()
    arr = img[..., 0] if c == 1 else img
    if writer == "pil":
        Image.fromarray(arr, mode).save(buf, format="PNG", optimize=True)
    else:
        imageio.imwrite(buf, arr, format="png")
    data = buf.getvalue()
    assert _filters_used(data, 64) == ({0, 1, 2, 3, 4} if writer == "pil" else {0, 1, 2, 4})
    out = png.decode_png(data)
    assert out.dtype == np.uint8 and np.array_equal(out, _pil(data)) and np.array_equal(out, img)


@pytest.mark.parametrize("filter_type", range(5))
@pytest.mark.parametrize("mode,c", MODES)
def test_png_written_by_the_port_reads_back_in_pil(mode, c, filter_type):
    img = np.random.default_rng(c * 7 + filter_type).integers(0, 256, (23, 17, c), np.uint8)
    data = png.encode_png(img, filter_type)
    assert _filters_used(data, 23) == {filter_type}
    assert np.array_equal(_pil(data), img) and np.array_equal(png.decode_png(data), img)


def _with_ihdr(data: bytes, **fields) -> bytes:
    """The PNG with IHDR fields replaced (and its CRC made again)."""
    names = ("width", "height", "depth", "color_type", "compression", "filter", "interlace")
    vals = dict(zip(names, struct.unpack(">IIBBBBB", data[16:29])))
    vals.update(fields)
    body = struct.pack(">IIBBBBB", *(vals[n] for n in names))
    crc = struct.pack(">I", zlib.crc32(b"IHDR" + body))
    return data[:16] + body + crc + data[33:]


def test_png_rejects_interlaced_16_bit_and_palette_files():
    """Interlaced, sub-byte and palette files raise; a 16-bit gray file (a
    depth map) decodes to what PIL reads, and the codec's own 16-bit files
    with every filter read back in PIL."""
    base = png.encode_png(np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(ValueError, match="interlace"):
        png.decode_png(_with_ihdr(base, interlace=1))
    with pytest.raises(ValueError, match="bit depth 4"):
        png.decode_png(_with_ihdr(base, depth=4, color_type=0))
    buf = io.BytesIO()
    depth = (np.arange(16, dtype=np.uint16).reshape(4, 4) * 4000).astype(np.uint16)
    Image.fromarray(depth).save(buf, "PNG")
    got = png.decode_png(buf.getvalue())
    assert got.dtype == np.uint16 and np.array_equal(got[..., 0], np.asarray(
        Image.open(io.BytesIO(buf.getvalue())))) and np.array_equal(got[..., 0], depth)
    wide = np.random.default_rng(1).integers(0, 65536, (9, 7), dtype=np.uint16)
    for f in range(5):
        data = png.encode_png(wide, filter_type=f)
        assert np.array_equal(np.asarray(Image.open(io.BytesIO(data))), wide)
        assert np.array_equal(png.decode_png(data)[..., 0], wide)
    buf = io.BytesIO()
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).convert("P").save(buf, "PNG")
    with pytest.raises(ValueError, match="colour type 3"):
        png.decode_png(buf.getvalue())
    with pytest.raises(ValueError, match="bad CRC"):
        png.decode_png(base[:20] + bytes([base[20] ^ 1]) + base[21:])


@pytest.mark.parametrize("mode,c", MODES)
def test_load_image_of_png_equals_pil_route(tmp_path, mode, c):
    """``load_image`` of a PNG, through the port's codec, equals the JAX
    package's (PIL's ``convert("RGBA")``) bit for bit."""
    from instant_ngp_tpu.io.image import load_image as jax_load_image

    img = _all_filters_image(32, 24, c, c + 10)
    Image.fromarray(img[..., 0] if c == 1 else img, mode).save(tmp_path / "x.png", optimize=True)
    ours, hdr = load_image(tmp_path / "x.png")
    theirs, jax_hdr = jax_load_image(tmp_path / "x.png")
    assert ours.dtype == theirs.dtype == np.float32 and hdr == jax_hdr is False
    assert np.array_equal(ours, theirs)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("scenes")
    port_dir, _ = generate_synthetic_dataset(root / "port", **SCENE_ARGS)
    jax_dir, _ = jax_generate(root / "jax", **SCENE_ARGS)
    return port_dir, jax_dir


def test_generated_scene_equals_jax(scenes):
    port_dir, jax_dir = scenes
    for name in ("transforms.json", "transforms_test.json"):
        assert (port_dir / name).read_text() == (jax_dir / name).read_text()
    pngs = sorted(p.name for p in jax_dir.glob("*.png"))
    assert pngs == sorted(p.name for p in port_dir.glob("*.png")) and len(pngs) == 6
    for name in pngs:
        ours = png.read_png(port_dir / name)
        assert ours.shape == (32, 32, 4)
        assert np.array_equal(ours, np.asarray(Image.open(jax_dir / name)))


def test_load_nerf_equals_jax_on_a_generated_scene(scenes):
    port_dir, _ = scenes
    for target in (port_dir, port_dir / "transforms_test.json"):
        ours, theirs = load_nerf(target), jax_load_nerf(target)
        _assert_datasets_equal(ours, theirs)
    assert ours.n_images == 2 and ours.resolution == (32, 32) and ours.lens_mode == "perspective"


def _frame_matrix(i):
    a = 0.4 * i
    m = np.eye(4)
    m[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
    m[:3, 3] = [2 * np.sin(a), 0.3 * i, 2 * np.cos(a)]
    return m.tolist()


# hand-written scenes: keys at the top level, and frame entries by index
HAND_SCENES = {
    "per_frame_intrinsics": (
        {"aabb_scale": 4, "offset": 0.4, "scale": 0.5, "white_transparent": True,
         "k1": 0.01, "k2": -0.002, "p1": 0.0005, "p2": -0.0007, "up": [0.0, 1.0, 0.0],
         "render_aabb": [[0.1, 0.2, 0.3], [0.8, 0.9, 0.7]], "camera_angle_x": 0.9},
        {0: {"fl_x": 20.0, "fl_y": 21.5, "cx": 7.5, "cy": 9.0}, 2: {"fl_x": 18.0}}),
    "global_intrinsics_fisheye": (
        {"fl_x": 19.0, "fl_y": 17.0, "cx": 8.5, "cy": 7.0, "is_fisheye": True, "k1": 0.02,
         "k2": 0.001, "offset": [0.5, 0.4, 0.6], "black_transparent": True,
         "rolling_shutter": [0.0, 0.1, 0.0, 0.0]},
        {1: {"sharpness": 3.5, "rolling_shutter": [0.0, 0.0, 0.2, 0.0]}}),
    "ftheta_and_motion": (
        {"camera_angle_y": 0.8, "ftheta_p0": 0.0, "ftheta_p1": 0.5, "ftheta_p2": 0.0,
         "ftheta_p3": 0.0, "ftheta_p4": 0.0, "w": 16, "h": 12, "from_mitsuba": True},
        {0: {"transform_matrix_start": "m0", "transform_matrix_end": "m1"}}),
    "latlong_and_missing_frames": (
        {"camera_angle_x": 1.2, "latlong": True, "aabb_scale": 2},
        {3: {"missing": True}}),
}


def _write_scene(root, meta, per_frame, n=4, h=12, w=16):
    rng = np.random.default_rng(len(meta))
    frames = []
    # names out of natural order, the extension left off on odd frames
    for i in (2, 0, 10, 1)[:n]:
        idx = (2, 0, 10, 1).index(i)
        extra = dict(per_frame.get(idx, {}))
        name = f"img_{i}"
        if not extra.pop("missing", False):
            png.write_png(root / f"{name}.png", rng.integers(0, 256, (h, w, 4), np.uint8))
        fr = {"file_path": name if i % 2 else f"{name}.png"}
        if "transform_matrix_start" in extra:
            fr["transform_matrix_start"] = _frame_matrix(i)
            fr["transform_matrix_end"] = _frame_matrix(i + 1)
            extra = {}
        else:
            fr["transform_matrix"] = _frame_matrix(i)
        fr.update(extra)
        frames.append(fr)
    (root / "transforms.json").write_text(json.dumps(dict(meta, frames=frames)))


@pytest.mark.parametrize("name", sorted(HAND_SCENES))
def test_load_nerf_equals_jax_on_hand_written_scenes(tmp_path, name):
    meta, per_frame = HAND_SCENES[name]
    _write_scene(tmp_path, meta, per_frame)
    missing = name.endswith("missing_frames")

    def expect():
        return pytest.warns(UserWarning, match="missing") if missing else contextlib.nullcontext()

    with expect():
        ours = load_nerf(tmp_path)
    with expect():
        theirs = jax_load_nerf(tmp_path)
    _assert_datasets_equal(ours, theirs)
    # natural order, the extension probed, a missing image's frame dropped
    assert [p.rsplit("/", 1)[-1] for p in ours.paths] == (
        ["img_0.png", "img_2.png", "img_10.png"] if missing
        else ["img_0.png", "img_1.png", "img_2.png", "img_10.png"])


def _depth_png(path, h, w, seed):
    """A 16-bit depth PNG of seeded values, some of them 0 (no depth)."""
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 65536, (h, w), dtype=np.uint16)
    d[rng.random((h, w)) < 0.1] = 0
    png.write_png(path, d)
    return d


@pytest.mark.parametrize("case", ["mixed_sizes", "rays", "depth", "envmap"])
def test_load_nerf_equals_jax_on_capture_features(tmp_path, case):
    """Each feature the loader once refused, as the JAX loader loads it:
    an image of another size (padded into the canvas, with its own size
    and intrinsics), supplied rays beside one image (the others' warned and
    zeroed), a 16-bit depth map (bit for bit what PIL reads, times
    integer_depth_scale and the scene scale) and an envmap key."""
    meta, per_frame = {"camera_angle_x": 0.9, "scale": 0.5}, {}
    if case == "depth":
        meta["integer_depth_scale"] = 1.0 / 4000.0
        per_frame = {0: {"depth_path": "depth_0.png"}, 2: {"depth_path": "depth_2.png"}}
    if case == "envmap":
        meta = dict(meta, envmap="env.exr")
    _write_scene(tmp_path, meta, per_frame)
    if case == "mixed_sizes":
        png.write_png(tmp_path / "img_1.png", np.full((10, 14, 4), 200, np.uint8))
    if case == "rays":
        rng = np.random.default_rng(3)
        rng.normal(size=16 * 12 * 6).astype(np.float32).tofile(tmp_path / "rays_img_0.dat")
    if case == "depth":
        raw = {i: _depth_png(tmp_path / f"depth_{i}.png", 12, 16, i) for i in (0, 2)}
        for i, d in raw.items():
            assert np.array_equal(np.asarray(Image.open(tmp_path / f"depth_{i}.png")), d)
    warn = (pytest.warns(UserWarning, match="missing rays") if case == "rays"
            else contextlib.nullcontext())
    with warn:
        ours = load_nerf(tmp_path)
    with warn:
        theirs = jax_load_nerf(tmp_path)
    _assert_datasets_equal(ours, theirs)
    if case == "mixed_sizes":
        np.testing.assert_array_equal(ours.per_image_resolution, [[16, 12], [14, 10], [16, 12],
                                                                  [16, 12]])
    if case == "rays":
        assert ours.rays.shape == (4, 12, 16, 6) and np.any(ours.rays[0])
        assert not np.any(ours.rays[1:])
    if case == "depth":
        # frame entries 0 and 2 are img_2 and img_10, the 3rd and 4th in natural order
        assert ours.depths.shape == (4, 12, 16) and not np.any(ours.depths[:2])
        np.testing.assert_array_equal(
            ours.depths[3], raw[2].astype(np.float32) * np.float32(1.0 / 4000.0) * 0.5)
    if case == "envmap":
        assert ours.envmap_path == str(tmp_path / "env.exr")


def test_load_nerf_equals_jax_on_a_capture(tmp_path):
    """A scene with every feature of a capture at once: two image sizes,
    16-bit depth maps, rays for some views, an envmap, per-frame start and
    end transforms and rolling shutters; the datasets field for field equal,
    and the sharpness maps of ``compute_sharpness_maps``."""
    meta = {"camera_angle_x": 0.9, "envmap": "env.png", "rolling_shutter": [0.0, 0.0, 0.5, 0.0]}
    per_frame = {0: {"transform_matrix_start": "m0", "depth_path": "depth_0.png"},
                 1: {"depth_path": "depth_1.png", "rolling_shutter": [0.0, 0.0, 0.0, 1.0]}}
    _write_scene(tmp_path, meta, per_frame)
    png.write_png(tmp_path / "img_10.png", np.full((10, 14, 4), 90, np.uint8))
    for i in (0, 1):
        _depth_png(tmp_path / f"depth_{i}.png", 12, 16, 10 + i)
    np.arange(14 * 10 * 6, dtype=np.float32).tofile(tmp_path / "rays_img_10.dat")
    with pytest.warns(UserWarning, match="missing rays"):
        ours = load_nerf(tmp_path)
    with pytest.warns(UserWarning, match="missing rays"):
        theirs = jax_load_nerf(tmp_path)
    _assert_datasets_equal(ours, theirs)
    assert not np.array_equal(ours.xforms_start, ours.xforms_end)
    np.testing.assert_array_equal(ours.compute_sharpness_maps(), theirs.compute_sharpness_maps())


def _disk_tasks(scene):
    """The JAX and port tasks of the tiny config on the scene as each
    package loads it from disk, from one state (tests/test_torch_train_step.py's)."""
    cfg = graft._tiny_nerf_config()
    kw = dict(target_batch_size=TARGET, n_rays_per_batch=R, max_samples_per_ray=K,
              n_march_iters=ITERS)
    jt = JaxNerfTask(jax_load_nerf(scene), cfg, **kw)
    jt.state = dataclasses.replace(jt.state, grid=_grid(5))
    jt.model = dataclasses.replace(jt.model, pos_encoding=dataclasses.replace(
        jt.model.pos_encoding, hashed_grad_corners=8))
    pt = NerfTask(load_nerf(scene), cfg, "cpu", **kw)
    pt.model.pos_encoding.hashed_grad_corners = 8
    train_state_from_jax(pt.model, pt.state, jt.state)
    return jt, pt


def test_train_step_from_a_disk_scene_equals_jax(scenes):
    """One whole step from the same state and draws on the generated scene,
    as tests/test_torch_train_step.py holds it on an in-memory set, with
    that file's tolerances: gradients 1e-2 (MLPs, hashed levels) and 3e-2
    (dense levels) of the leaf's largest, loss and error map rtol 1e-5,
    parameters and Adam's m where |g| > 1e-3 of the leaf's largest."""
    jt, pt = _disk_tasks(scenes[0])
    data = dict(jt.data)
    key = jax.random.PRNGKey(11)
    k_pix, k_bg, k_jit, _ = jax.random.split(key, 4)
    img, uv, pdf = jt._sample_pixels(data, k_pix, R, False)
    draws = port_train.StepDraws(_t(img, torch.int64), _t(uv), _t(pdf),
                                 _t(jax.random.uniform(k_jit, (R,))),
                                 _t(jax.random.uniform(k_bg, (R, 3))))
    state0 = jt.state
    new_state, stats, grads = _jax_step_with_grads(jt, state0, data, key, False)
    o, d = jax.jit(lambda dd, i, u: jt._generate_rays(dd, i, u, None))(
        data, img, (jnp.floor(uv * jnp.array([32.0, 32.0])) + 0.5) / 32.0)
    ref_march = jax.jit(lambda o, d, s, j: jax_march(o, d, s, jnp.asarray(jt.aabb_min),
                                                     jnp.asarray(jt.aabb_max), j, jt.march_cfg))(
        o, d, state0.grid.skipmip, jax.random.uniform(k_jit, (R,)))
    p_grads, per_ray, batch = port_train.step_gradients(pt, draws)
    assert np.mean(batch.n_valid.numpy() == np.asarray(ref_march[4])) >= 0.99
    assert int(batch.n_valid.sum()) > 0
    for key_, ours in (("density_net", p_grads[:2]), ("rgb_net", p_grads[2:4])):
        for a, b in zip(ours, grads[key_]):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-2 * np.abs(b).max())
    table = p_grads[4].numpy()
    for lv, b in zip(pt.model.pos_encoding.levels, grads["pos_enc"]):
        b = np.asarray(b)
        tol = (1e-2 if lv.hashed else 3e-2) * np.abs(b).max()
        np.testing.assert_allclose(table[lv.offset:lv.offset + lv.size], b, rtol=0, atol=tol)
    assert float(per_ray.mean()) == pytest.approx(float(stats["loss"]), rel=1e-5)

    stats_p = port_train.train_step(pt, draws)
    assert float(stats_p["loss"]) == pytest.approx(float(stats["loss"]), rel=1e-5)
    assert int(stats_p["measured_samples"]) == int(stats["measured_samples"])
    got = train_state_to_numpy(pt.model, pt.state)
    emap = np.asarray(new_state.error_map)
    np.testing.assert_allclose(got["error_map"], emap, rtol=1e-5,
                               atol=1e-6 * float(np.abs(emap).max()))
    lr = float(jt.opt.learning_rate_at(0))
    for key_ in ("density_net", "rgb_net", "pos_enc"):
        for g_ref, p_ref, p_new, m_ref, m_new in zip(
                jax.tree.leaves(grads[key_]), jax.tree.leaves(new_state.params[key_]),
                got["params"][key_], jax.tree.leaves(new_state.opt_state["m"][key_]),
                got["opt_state"]["m"][key_]):
            g_ref = np.asarray(g_ref)
            big = np.abs(g_ref) > 1e-3 * np.abs(g_ref).max()
            np.testing.assert_allclose(np.asarray(p_new)[big], np.asarray(p_ref)[big], rtol=0,
                                       atol=1e-3 * lr)
            np.testing.assert_allclose(np.asarray(m_new)[big], np.asarray(m_ref)[big], rtol=0,
                                       atol=3e-3 * np.abs(np.asarray(m_ref)).max())
