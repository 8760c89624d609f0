"""Snapshot loading in the PyTorch port, against the JAX package.

The port reads ``.ingp`` files with its own msgpack decoder and must give
bit-equal parameters, density grids and datasets."""

import dataclasses
import os
import subprocess
import sys
import zlib
from pathlib import Path

import msgpack
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from instant_ngp_tpu import snapshot as jax_snapshot
from instant_ngp_tpu.testbed import Testbed as JaxTestbed
from instant_ngp_torch import snapshot as port_snapshot
from instant_ngp_torch.io import msgpack_lite
from instant_ngp_torch.models.nerf_network import NerfNetwork, params_from_jax, params_to_numpy
from instant_ngp_torch.testbed import _empty_nerf_dataset_from_snapshot

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = {
    "tiny": ROOT / "tests" / "fixtures" / "tiny_nerf.ingp",
    "fox": ROOT / "data" / "fox_1536.ingp",
}
_DOCS = {}


def _doc(name):
    if name not in _DOCS:
        raw = zlib.decompress(FIXTURES[name].read_bytes())
        _DOCS[name] = (raw, msgpack.unpackb(raw, raw=False, strict_map_key=False))
    return _DOCS[name]


@pytest.mark.parametrize("name", ["tiny", "fox"])
def test_msgpack_lite_decodes_fixture_like_msgpack(name):
    raw, expected = _doc(name)
    assert msgpack_lite.unpackb(raw) == expected


def test_msgpack_lite_covers_every_snapshot_type_code():
    obj = {
        "nil": None, "t": True, "f": False,
        "ints": [0, 127, -1, -32, 200, -100, 60000, -30000, 4_000_000_000, -2_000_000_000,
                 2**63 + 5, -(2**62)],
        "f64": 1.0 / 3.0,
        "str8": "x" * 40, "str16": "y" * 300, "str32": "z" * 70000,
        "bin8": b"\x01" * 10, "bin16": b"\x02" * 300, "bin32": b"\x03" * 70000,
        "arr16": list(range(20)), "arr32": [1] * 70000,
        "map16": {str(i): i for i in range(20)},
        "map32": {i: i for i in range(70000)},
    }
    for single in (False, True):  # float32 and float64 encodings
        raw = msgpack.packb(obj, use_bin_type=True, use_single_float=single)
        assert msgpack_lite.unpackb(raw) == msgpack.unpackb(raw, raw=False, strict_map_key=False)
    with pytest.raises(ValueError):
        msgpack_lite.unpackb(msgpack.packb(msgpack.ExtType(1, b"ab")))
    with pytest.raises(ValueError):
        msgpack_lite.unpackb(msgpack.packb([1, 2, 3])[:-1])  # truncated
    with pytest.raises(ValueError):
        msgpack_lite.unpackb(msgpack.packb(1) + b"\x00")  # trailing bytes


def _port_model(doc, aabb_scale):
    from instant_ngp_torch.models.factory import autoconfig_grid_encoding

    cfg = {k: v for k, v in doc.items() if k != "snapshot"}
    cfg["encoding"] = autoconfig_grid_encoding(cfg["encoding"], "nerf", aabb_scale=aabb_scale)
    return NerfNetwork.from_config(cfg)


@pytest.mark.parametrize("name", ["tiny", "fox"])
def test_restore_params_and_density_grid_bit_equal(name):
    doc = port_snapshot.load_snapshot_file(FIXTURES[name])
    snap = doc["snapshot"]
    aabb_scale = _empty_nerf_dataset_from_snapshot(snap).aabb_scale
    template = params_to_numpy(_port_model(doc, aabb_scale))
    ours = port_snapshot.restore_params(snap, template)
    theirs = jax_snapshot.restore_params(snap, template)
    assert ours.keys() == theirs.keys()
    for key in ours:
        for a, b in zip(ours[key], theirs[key]):
            if a is None:
                assert b is None
            else:
                assert a.dtype == b.dtype and np.array_equal(a, b)
    n_casc = {"tiny": 1, "fox": 3}[name]
    grid = port_snapshot.restore_density_grid(snap, n_casc)
    assert np.array_equal(grid, jax_snapshot.restore_density_grid(snap, n_casc))


def test_params_layout_mismatch_fails_loudly():
    doc = port_snapshot.load_snapshot_file(FIXTURES["tiny"])
    template = params_to_numpy(_port_model(doc, 1))
    template["pos_enc"] = template["pos_enc"][:-1]  # one level short
    with pytest.raises(ValueError, match="layout mismatch"):
        port_snapshot.restore_params(doc["snapshot"], template)


def _assert_datasets_equal(ours, theirs):
    for field in dataclasses.fields(ours):
        a, b = getattr(ours, field.name), getattr(theirs, field.name)
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            assert a is not None and b is not None, field.name
            assert np.asarray(a).shape == np.asarray(b).shape, field.name
            assert np.array_equal(np.asarray(a), np.asarray(b)), field.name
        else:
            assert a == b, field.name


def test_dataset_from_json_field_equal_on_fox():
    snap = _doc("fox")[1]["snapshot"]
    block = snap["nerf"]["dataset"]
    ours = port_snapshot.dataset_from_json(block)
    _assert_datasets_equal(ours, jax_snapshot.dataset_from_json(block))
    assert ours.lens_mode == "opencv"
    np.testing.assert_array_equal(ours.render_aabb, [[0, 0, 0], [1, 1, 1]])
    assert ours.aabb_scale == 4 and ours.n_images == 50


def test_legacy_dataset_block_field_equal_on_tiny():
    snap = _doc("tiny")[1]["snapshot"]
    ours = _empty_nerf_dataset_from_snapshot(snap)
    theirs = JaxTestbed("nerf")._empty_nerf_dataset_from_snapshot(snap)
    _assert_datasets_equal(ours, theirs)


def test_params_from_jax_round_trips():
    doc = port_snapshot.load_snapshot_file(FIXTURES["tiny"])
    model = _port_model(doc, 1)
    rng = np.random.default_rng(7)
    tree = {k: ([rng.standard_normal(np.shape(w)).astype(np.float32) for w in v]
                if k != "pos_enc" else
                tuple(rng.standard_normal(np.shape(t)).astype(np.float32) for t in v))
            for k, v in params_to_numpy(model).items()}
    params_from_jax(model, tree)
    back = params_to_numpy(model)
    assert back.keys() == tree.keys()
    for key in tree:
        for a, b in zip(back[key], tree[key]):
            assert np.array_equal(a, b)


def test_port_runtime_imports_neither_jax_nor_msgpack():
    """A snapshot render, and a scene generated, loaded from disk, saved
    with its optimizer state and loaded back, import no jax, msgpack,
    imageio, PIL (the scene is PNG) or JAX package module."""
    code = (
        "import sys, tempfile\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "import instant_ngp_torch.testbed as tb\n"
        "from instant_ngp_torch.io.synthetic import generate_synthetic_dataset\n"
        "t = tb.Testbed('nerf', device='cpu')\n"
        f"t.load_snapshot({str(FIXTURES['tiny'])!r})\n"
        "assert t.task.render(4, 4, t.nerf_dataset.xforms_start[0]).shape == (4, 4, 4)\n"
        "d = tempfile.mkdtemp()\n"
        "scene, _ = generate_synthetic_dataset(d + '/s', res=16, n_train=2, n_test=1, n_steps=8)\n"
        "s = tb.Testbed('nerf', device='cpu')\n"
        "s.training_batch_size = 1 << 11\n"
        f"s.reload_network_from_json({graft._tiny_nerf_config()!r})\n"
        "s.load_training_data(scene)\n"
        "s.save_snapshot(d + '/s.ingp', include_optimizer_state=True)\n"
        "u = tb.Testbed('nerf', device='cpu')\n"
        "u.load_snapshot(d + '/s.ingp')\n"
        "assert u.task.state.opt_state['step'] == 0 and u.nerf_dataset.n_images == 2\n"
        "bad = [m for m in ('jax', 'msgpack', 'imageio', 'PIL', 'instant_ngp_tpu') "
        "if m in sys.modules]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
