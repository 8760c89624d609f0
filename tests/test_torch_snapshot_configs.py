"""Snapshots of the wide and the octree configs between the port and the JAX
package, on the CPU: configs/nerf/big.json (128-wide MLPs),
configs/image/oneblob.json (256 → 128 × 8 → 3) and configs/sdf/takikawa.json
(the vertex table of the feature octree), each at its full MLP widths with its
grid or octree cut to ≤ 4 levels of ≤ 2^12 entries. Each package trains 2
frames and saves with the optimizer state; the other package loads the file
(parameters as fp16, the optimizer state exact); and both packages, loading
one file and saving it again, write the same ``params_binary`` and optimizer
state bytes."""

import copy

import msgpack
import numpy as np
import pytest
import torch

from instant_ngp_torch.config import load_network_config
from instant_ngp_torch.geometry.procedural import bumpy_torus, write_obj
from instant_ngp_torch.io.image import save_image
from instant_ngp_torch.io.synthetic import generate_synthetic_dataset
from test_torch_image_task import _image
from test_torch_snapshot_save import _assert_loaded, _state, _testbed

torch.set_num_threads(2)

CASES = [("nerf", "big.json"), ("image", "oneblob.json"), ("sdf", "takikawa.json")]


def _config(mode: str, name: str) -> dict:
    """The config with its grid or octree cut (levels ≤ 4, tables ≤ 2^12),
    its MLP widths untouched."""
    cfg = copy.deepcopy(load_network_config(name, mode=mode))
    enc = cfg["encoding"]
    enc["n_levels"] = min(int(enc.get("n_levels", 16)), 4)
    if "log2_hashmap_size" in enc:
        enc["log2_hashmap_size"] = min(int(enc["log2_hashmap_size"]), 12)
    return cfg


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("scenes")
    scene, _ = generate_synthetic_dataset(root / "scene", res=32, n_train=4, n_test=2,
                                          n_steps=64)
    image = root / "image.bin"
    save_image(image, _image())
    v, f = bumpy_torus(32, 16, seed=3)
    mesh = root / "torus.obj"
    write_obj(mesh, v, f)
    return {"nerf": scene, "image": image, "sdf": mesh}


def _close(tb):
    task = getattr(tb, "task", None)
    if task is not None and hasattr(task, "stop_producer"):
        task.stop_producer()


def _blobs(path) -> tuple:
    """(params_binary, the optimizer state packed again) of a .msgpack file."""
    doc = msgpack.unpackb(path.read_bytes(), raw=False, strict_map_key=False)["snapshot"]
    return doc["params_binary"], msgpack.packb(doc["optimizer_state"])


@pytest.mark.parametrize("mode,name", CASES, ids=[f"{m}/{n}" for m, n in CASES])
def test_snapshot_both_ways(scenes, tmp_path, mode, name):
    cfg = _config(mode, name)
    made = []
    try:
        files, trained = {}, {}
        for package in ("jax", "port"):
            tb = _testbed(package, mode, scenes[mode], cfg)
            made.append(tb)
            for _ in range(2):
                tb.frame()
            files[package] = tmp_path / f"{package}.msgpack"
            tb.save_snapshot(str(files[package]), include_optimizer_state=True)
            trained[package] = tb
        for saver, loader in (("jax", "port"), ("port", "jax")):
            tb = _testbed(loader, mode, None if mode == "nerf" else scenes[mode], cfg)
            made.append(tb)
            tb.load_snapshot(str(files[saver]))
            _assert_loaded(_state(saver, trained[saver]), _state(loader, tb), with_opt=True)
            assert tb.training_step == 2
            resaved = tmp_path / f"{saver}_{loader}.msgpack"
            tb.save_snapshot(str(resaved), include_optimizer_state=True)
            assert _blobs(resaved) == _blobs(files[saver])
    finally:
        for tb in made:
            _close(tb)
