"""Snapshot save in the PyTorch port, and snapshots in both directions
between the port and the JAX package, on the CPU: the msgpack encoder, the
binary blobs and the optimizer-state leaves byte for byte, JAX save → port
load and port save → JAX load for NeRF and image snapshots with and without
the optimizer state, loading onto a loaded scene, and the ``render_aabb``
reference defect matched on purpose."""

import math
import zlib
from pathlib import Path

import jax
import msgpack
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import __graft_entry__ as graft
from instant_ngp_tpu import snapshot as jax_snapshot
from instant_ngp_tpu.testbed import Testbed as JaxTestbed
from instant_ngp_torch import snapshot as port_snapshot
from instant_ngp_torch.io import msgpack_lite
from instant_ngp_torch.io.image import save_image
from instant_ngp_torch.io.synthetic import generate_synthetic_dataset
from instant_ngp_torch.testbed import Testbed as PortTestbed
from test_torch_image_task import _config as image_config
from test_torch_image_task import _image
from test_torch_render import MIN_PSNR_DB, _psnr

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = {"tiny": ROOT / "tests" / "fixtures" / "tiny_nerf.ingp",
            "fox": ROOT / "data" / "fox_1536.ingp"}
RES = 32  # render size of the NeRF comparisons


# --- msgpack -----------------------------------------------------------------

_LEAVES = (st.none() | st.booleans()
           | st.integers(min_value=-2**63, max_value=2**64 - 1)
           | st.sampled_from([0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, -32, -33,
                              -128, -129, -32768, -32769, -2**31, -2**31 - 1])
           | st.floats(allow_nan=False)
           | st.sampled_from([math.inf, -math.inf, 0.0, -0.0])
           | st.text(max_size=40)
           | st.binary(max_size=300)
           | st.sampled_from(["x" * 31, "x" * 32, "x" * 255, "x" * 256, b"\0" * 256,
                              b"\1" * 70000]))
_DOCS = st.recursive(_LEAVES, lambda children: st.lists(children, max_size=20)
                     | st.dictionaries(st.text(max_size=10), children, max_size=20),
                     max_leaves=40)


@settings(max_examples=300, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(_DOCS)
def test_packb_equals_msgpack(doc):
    assert msgpack_lite.packb(doc) == msgpack.packb(doc, use_bin_type=True)
    assert msgpack_lite.unpackb(msgpack_lite.packb(doc)) == doc


@pytest.mark.parametrize("name", ["tiny", "fox"])
def test_packb_writes_the_fixture_snapshots_byte_for_byte(name):
    raw = zlib.decompress(FIXTURES[name].read_bytes())
    doc = msgpack_lite.unpackb(raw)
    assert msgpack_lite.packb(doc) == msgpack.packb(doc, use_bin_type=True) == raw


def test_packb_refuses_what_msgpack_refuses():
    for bad in (np.float32(1.0), np.int64(3), {1.5}, object()):
        with pytest.raises(TypeError):
            msgpack_lite.packb(bad)
        with pytest.raises(TypeError):
            msgpack.packb(bad, use_bin_type=True)


# --- scenes, trained states and their snapshots --------------------------------

def _nerf_config():
    """The tiny config with configs/nerf/base.json's Ema → Adam chain and
    Composite direction encoding, so that snapshots carry an EMA and
    dir_enc's parameter-free leaves."""
    cfg = graft._tiny_nerf_config()
    cfg["optimizer"] = {"otype": "Ema", "decay": 0.95, "nested": cfg["optimizer"]}
    cfg["dir_encoding"] = {"otype": "Composite", "nested": [
        {"n_dims_to_encode": 3, "otype": "SphericalHarmonics", "degree": 4},
        {"otype": "Identity"}]}
    return cfg


def _testbed(package, mode, scene, config):
    if package == "jax":
        tb = JaxTestbed(mode)
    else:
        tb = PortTestbed(mode, device="cpu")
    tb.training_batch_size = 1 << 12 if mode == "nerf" else 1024
    tb.reload_network_from_json(config)
    if scene is not None:
        tb.load_training_data(str(scene))
    return tb


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A generated scene and an image, each trained 2 frames in each
    package and saved with and without the optimizer state."""
    root = tmp_path_factory.mktemp("snapshots")
    scene, _ = generate_synthetic_dataset(root / "scene", res=32, n_train=4, n_test=2,
                                          n_steps=64)
    image = root / "image.bin"
    save_image(image, _image())
    out = {"scene": scene, "image": image, "trained": {}, "files": {}}
    for mode, src, cfg in (("nerf", scene, _nerf_config()), ("image", image, image_config())):
        for package in ("jax", "port"):
            tb = _testbed(package, mode, src, cfg)
            for _ in range(2):
                tb.frame()
            out["trained"][package, mode] = tb
            for opt in (False, True):
                path = root / f"{package}_{mode}_{int(opt)}.ingp"
                tb.save_snapshot(str(path), include_optimizer_state=opt)
                out["files"][package, mode, opt] = path
    return out


def _state(package, tb):
    """(params tree, optimizer-state tree, density grid or None, training
    step) of a testbed, as numpy trees in the JAX layout."""
    from instant_ngp_torch.models import nerf_network, network

    task = tb.task
    nerf = hasattr(task, "dataset")
    if package == "jax":
        tree = jax.tree.map(np.asarray, task.state.params if nerf else task.params)
        opt = jax.tree.map(np.asarray, task.state.opt_state if nerf else task.opt_state)
        grid = np.asarray(task.state.grid.density) if nerf else None
        return tree, opt, grid, int(task.training_step)
    model_io = nerf_network if nerf else network
    grid = task.state.grid.density.numpy() if nerf else None
    return (model_io.params_to_numpy(task.model), task.opt_state_tree(), grid,
            int(task.training_step))


def _fp16(a):
    return np.asarray(a, np.float32).astype(np.float16).astype(np.float32)


def _assert_loaded(saved, loaded, with_opt: bool):
    """A loaded state against the saved one: parameters and grid rounded to
    fp16 as the file stores them; the optimizer state leaf by leaf in
    ``jax.tree.leaves`` order, exact (with it) or fresh from the loaded
    parameters (without: zero moments, step 0, EMA = the parameters)."""
    params_s, opt_s, grid_s, step_s = saved
    params_l, opt_l, grid_l, step_l = loaded
    pl, ps = jax.tree.leaves(params_l), jax.tree.leaves(params_s)
    assert len(pl) == len(ps)
    for a, b in zip(pl, ps):
        assert a.dtype == np.float32 and np.array_equal(a, _fp16(b))
    assert step_l == step_s
    expected = opt_s
    if not with_opt:
        fresh = {"step": np.int32(0), "m": jax.tree.map(np.zeros_like, params_s),
                 "v": jax.tree.map(np.zeros_like, params_s), "ema": jax.tree.map(_fp16, params_s)}
        expected = {k: fresh[k] for k in opt_l}
    ol, oe = jax.tree.leaves(opt_l), jax.tree.leaves(expected)
    assert len(ol) == len(oe)
    for a, b in zip(ol, oe):
        b = np.asarray(b)
        assert a.shape == b.shape and np.array_equal(a, b.astype(a.dtype))
    if grid_s is not None:
        assert np.array_equal(grid_l, _fp16(grid_s))


def _render_pair(port_tb, jax_tb):
    ds = port_tb.nerf_dataset
    xf = np.asarray(ds.xforms_start[0], np.float32)
    w, h = ds.resolution
    kw = dict(focal_length=(ds.focal_lengths[0, 0] * RES / w, ds.focal_lengths[0, 1] * RES / h),
              principal_point=tuple(ds.principal_points[0]), background=(0, 0, 0, 0))
    return (port_tb.task.render(RES, RES, xf, **kw).numpy(),
            np.asarray(jax_tb.task.render(RES, RES, xf, **kw)))


@pytest.mark.parametrize("with_opt", [False, True])
@pytest.mark.parametrize("mode", ["nerf", "image"])
@pytest.mark.parametrize("saver", ["jax", "port"])
def test_snapshot_round_trip_between_the_packages(data, saver, mode, with_opt):
    """One package saves, the other loads (NeRF without a scene: cameras
    from the dataset block; image onto the loaded image). The loaded state
    equals the saved one; a NeRF render from the file agrees between the
    packages at the render tolerance of tests/test_torch_render.py."""
    loader = "port" if saver == "jax" else "jax"
    path = data["files"][saver, mode, with_opt]
    src = None if mode == "nerf" else data["image"]
    cfg = _nerf_config() if mode == "nerf" else image_config()
    tb = _testbed(loader, mode, src, cfg)
    tb.load_snapshot(str(path))
    saved = _state(saver, data["trained"][saver, mode])
    _assert_loaded(saved, _state(loader, tb), with_opt)
    assert tb.training_step == saved[3] == 2
    if mode == "nerf":
        other = _testbed(saver, mode, None, cfg)
        other.load_snapshot(str(path))
        port_tb, jax_tb = (tb, other) if loader == "port" else (other, tb)
        frame, ref = _render_pair(port_tb, jax_tb)
        assert np.isfinite(frame).all() and frame.shape == ref.shape == (RES, RES, 4)
        assert _psnr(frame, ref) >= MIN_PSNR_DB


@pytest.mark.parametrize("mode", ["nerf", "image"])
def test_port_and_jax_save_the_same_document(data, tmp_path, mode):
    """A state loaded into both packages from one file is saved again by
    each: the documents are equal key for key and byte for byte, the loss
    too (neither package's meter takes the file's)."""
    src = data["scene"] if mode == "nerf" else data["image"]
    cfg = _nerf_config() if mode == "nerf" else image_config()
    path = data["files"]["jax", mode, True]
    docs = []
    for package in ("jax", "port"):
        tb = _testbed(package, mode, src, cfg)
        tb.load_snapshot(str(path))
        out = tmp_path / f"{package}.msgpack"
        tb.save_snapshot(str(out), include_optimizer_state=True)
        docs.append(msgpack.unpackb(out.read_bytes(), raw=False, strict_map_key=False))
    theirs, ours = docs
    assert list(ours) == list(theirs) and list(ours["snapshot"]) == list(theirs["snapshot"])
    assert ours == theirs


def test_save_snapshot_functions_write_the_same_bytes(data, tmp_path):
    """The port's ``save_snapshot`` and the JAX package's, given one NeRF
    state, write the same file: params blob, Morton fp16 grid blob,
    ``pack_tree`` of the optimizer state and of the camera offsets, and the
    msgpack and zlib framing."""
    tb = data["trained"]["port", "nerf"]
    task = tb.task
    params, opt, grid, step = _state("port", tb)
    kw = dict(training_step=step, loss=0.25, density_grid=grid,
              nerf_extra={"aabb_scale": 1, "rgb": {"rays_per_batch": 4096},
                          "dataset": port_snapshot.dataset_to_json(task.dataset)},
              camera={"matrix": np.eye(3, 4, dtype=np.float32).tolist(), "fov_axis": 1},
              optimizer_state=opt, cam_offsets=task.cam_offsets)
    assert (port_snapshot.dataset_to_json(task.dataset)
            == jax_snapshot.dataset_to_json(task.dataset))
    assert port_snapshot._pack_params(params).tobytes() == jax_snapshot._pack_params(
        params, None).tobytes()
    assert port_snapshot.pack_tree(opt) == jax_snapshot.pack_tree(opt)
    for suffix in (".msgpack", ".ingp"):
        ours, theirs = tmp_path / f"ours{suffix}", tmp_path / f"theirs{suffix}"
        port_snapshot.save_snapshot(ours, tb.network_config, params, "nerf", **kw)
        jax_snapshot.save_snapshot(theirs, tb.network_config, params, "nerf", **kw)
        assert ours.read_bytes() == theirs.read_bytes()


@pytest.mark.parametrize("mode", ["nerf", "image"])
def test_optimizer_state_leaves_in_jax_order(data, mode):
    """``tree_leaves`` of the port's optimizer-state tree is
    ``jax.tree.leaves`` of the JAX package's for the same model: each leaf's
    dtype and shape in order (ema, m, step, v; within each, the parameter
    tree's sorted keys)."""
    ours = port_snapshot.tree_leaves(data["trained"]["port", mode].task.opt_state_tree())
    theirs = jax.tree.leaves(_state("jax", data["trained"]["jax", mode])[1])
    assert [(a.dtype, a.shape) for a in ours] == [(np.asarray(b).dtype, np.shape(b))
                                                  for b in theirs]


def test_load_snapshot_onto_a_loaded_scene_keeps_its_images(data):
    """The repaired fault: loading a snapshot after ``load_training_data``
    loads onto that scene's task, as the JAX package does, so training
    continues on its images; without a scene the images are zero."""
    path = data["files"]["port", "nerf", True]
    images = {}
    for package in ("jax", "port"):
        tb = _testbed(package, "nerf", data["scene"], _nerf_config())
        task = tb.task
        tb.load_snapshot(str(path))
        assert tb.task is task and tb.training_step == 2
        images[package] = np.asarray(tb.task.dataset.images)
        bare = _testbed(package, "nerf", None, _nerf_config())
        bare.load_snapshot(str(path))
        assert not np.asarray(bare.task.dataset.images).any()
    assert images["port"].any() and np.array_equal(images["port"], images["jax"])
    tb.frame()  # the port's loaded task trains on
    assert tb.training_step == 3 and np.isfinite(tb.loss_graph[-1])


def test_render_aabb_reference_defect_is_matched(data, tmp_path):
    """Reference defect matched on purpose (the JAX package's
    testbed.py:2102): save_snapshot builds the live crop box but never
    writes it, so a changed crop is lost on a round trip. Neither package's
    file holds a top-level render_aabb, and a port load takes the dataset's
    (here none: the scene aabb)."""
    for package in ("jax", "port"):
        tb = data["trained"][package, "nerf"]
        tb.task.render_aabb_min = np.array([0.2, 0.2, 0.2], np.float32)
        path = tmp_path / f"{package}.ingp"
        tb.save_snapshot(str(path))
        tb.task.render_aabb_min = np.array(tb.task.aabb_min)
        snap = port_snapshot.load_snapshot_file(path)["snapshot"]
        assert "render_aabb" not in snap
        assert snap["nerf"]["dataset"]["render_aabb"]["min"] == [math.inf] * 3
        loaded = _testbed("port", "nerf", None, _nerf_config())
        loaded.load_snapshot(path)
        assert np.array_equal(loaded.task.render_aabb_min, loaded.task.aabb_min)
