"""The SDF primitive of the PyTorch port against the JAX package on the CPU:
the training batches, one step from the same state and batch, the IoU, the
Testbed surface, snapshots in both directions, and no JAX at run time. Every
task's batch producer is stopped at the end of its test."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instant_ngp_tpu.sdf.task import SdfTask as JaxSdfTask
from instant_ngp_tpu.testbed import Testbed as JaxTestbed
from instant_ngp_torch import common
from instant_ngp_torch import testbed as port_testbed
from instant_ngp_torch.geometry.procedural import bumpy_torus, write_obj
from instant_ngp_torch.models.network import (params_from_jax, train_state_from_jax,
                                              train_state_to_numpy)
from instant_ngp_torch.sdf.task import SdfTask

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
OPT = {"otype": "Adam", "learning_rate": 1e-2, "beta1": 0.9, "beta2": 0.99, "epsilon": 1e-15,
       "l2_reg": 1e-6}
# the step's gradients, read back from Adam's first moment, per leaf against
# its largest value: bf16 MLP on both sides (1e-2), dense levels 2e-2 (the
# JAX package splats them in bf16, the port in f32); as test_torch_image_task.py
TOL_GRAD, TOL_DENSE = 1e-2, 2e-2
TOL_LOSS = 1e-5  # relative
TOL_IOU = 0.005


def tiny_config(levels=4, log2=12, neurons=16, hidden=1):
    """tests/test_tasks.py's tiny config with the MAPE loss."""
    return {"loss": {"otype": "Mape"}, "optimizer": OPT,
            "encoding": {"otype": "HashGrid", "n_levels": levels, "n_features_per_level": 2,
                         "log2_hashmap_size": log2, "base_resolution": 4},
            "network": {"otype": "FullyFusedMLP", "activation": "ReLU",
                        "output_activation": "None", "n_neurons": neurons,
                        "n_hidden_layers": hidden}}


def torus(n_u=32, n_v=16, seed=3):
    v, f = bumpy_torus(n_u, n_v, seed=seed)
    return v[f]


@pytest.fixture
def tasks(request):
    """Builds (JAX task, port task) pairs with the JAX parameters carried
    across, and stops both producers afterwards."""
    made = []

    def make(config=None, tris=None, **kw):
        tris = torus() if tris is None else tris
        config = tiny_config() if config is None else config
        theirs = JaxSdfTask(tris, config, **kw)
        ours = SdfTask(tris, config, device="cpu", **kw)
        params_from_jax(ours.model, jax.tree.map(np.asarray, theirs.params))
        made.extend([theirs, ours])
        return theirs, ours

    yield make
    for task in made:
        task.stop_producer()


@pytest.mark.parametrize("sdf_mode,offset_scale", [("pseudonormal", 1.0), ("watertight", 1.0),
                                                   ("raystab", 2.5)])
def test_training_batches_equal_jax(tasks, sdf_mode, offset_scale):
    """Three successive batches bit for bit: the same numpy generator, the
    same triangle CDF and the same BVH distances."""
    theirs, ours = tasks(seed=5, batch_size=4096, sdf_mode=sdf_mode)
    np.testing.assert_array_equal(ours.tri_cdf, theirs.tri_cdf)
    np.testing.assert_array_equal(ours.triangles, theirs.triangles)
    theirs.surface_offset_scale = ours.surface_offset_scale = offset_scale
    for _ in range(3):
        (p_ref, d_ref), (p, d) = theirs.generate_training_batch(), ours.generate_training_batch()
        assert p.dtype == d.dtype == np.float32 and p.shape == (4096, 3)
        np.testing.assert_array_equal(p, p_ref)
        np.testing.assert_array_equal(d, d_ref)
    assert np.mean(d == 0) == 0.5 and np.mean(d < 0) > 0


@pytest.mark.parametrize("train_encoding,train_network", [(True, True), (False, True),
                                                          (True, False)])
def test_one_step_equals_jax(tasks, train_encoding, train_network):
    """One step from the same parameters on the same batch: the loss, Adam's
    first moment per leaf, and the frozen part unchanged."""
    theirs, ours = tasks(batch_size=4096)
    levels = ours.model.encoding.levels
    assert [lv.hashed for lv in levels] == [False, True, True, True]
    theirs.shall_train_encoding = ours.shall_train_encoding = train_encoding
    theirs.shall_train_network = ours.shall_train_network = train_network
    theirs.rebuild_jit_programs()
    pts, d = theirs.generate_training_batch()
    old = jax.tree.map(np.asarray, theirs.params)
    theirs.params, theirs.opt_state, loss_ref = theirs._jit_step(
        theirs.params, theirs.opt_state, jnp.asarray(pts), jnp.asarray(d))
    loss = float(ours.train_step(torch.from_numpy(pts), torch.from_numpy(d)))
    np.testing.assert_allclose(loss, float(loss_ref), rtol=TOL_LOSS)

    m_ref = jax.tree.map(np.asarray, theirs.opt_state["m"])
    state = train_state_to_numpy(ours.model, ours.opt_state)
    assert state["step"] == int(theirs.opt_state["step"]) == 1
    for out, ref in zip(state["m"]["net"], m_ref["net"]):
        np.testing.assert_allclose(out, ref, rtol=0, atol=TOL_GRAD * np.abs(ref).max())
    for lv, out, ref in zip(levels, state["m"]["enc"], m_ref["enc"]):
        tol = (TOL_GRAD if lv.hashed else TOL_DENSE) * np.abs(ref).max()
        np.testing.assert_allclose(out, ref, rtol=0, atol=tol)
    new = {"net": [w.detach().numpy() for w in ours.model.network.weights],
           "enc": ours.model.encoding.unpack_params(ours.model.encoding.table.detach().numpy())}
    new_ref = jax.tree.map(np.asarray, theirs.params)
    for key, trained in (("net", train_network), ("enc", train_encoding)):
        for out, ref, before, m in zip(new[key], new_ref[key], old[key], m_ref[key]):
            if not trained:
                np.testing.assert_array_equal(out, before)
                np.testing.assert_array_equal(ref, before)
                continue
            big = np.abs(m) > 1e-3 * np.abs(m).max()
            np.testing.assert_allclose(out[big], ref[big], rtol=0, atol=1e-3 * OPT["learning_rate"])


def _train_jax(task, steps):
    """JAX steps on fresh batches (no producer thread)."""
    for _ in range(steps):
        pts, d = task.generate_training_batch()
        task.params, task.opt_state, _ = task._jit_step(task.params, task.opt_state,
                                                        jnp.asarray(pts), jnp.asarray(d))


def test_calculate_iou_equals_jax(tasks):
    """On the JAX package's parameters after 30 steps (carried with the
    optimizer state), and before training."""
    theirs, ours = tasks(batch_size=4096)
    n = 1 << 16
    assert abs(ours.calculate_iou(n) - theirs.calculate_iou(n)) <= TOL_IOU
    _train_jax(theirs, 30)
    ours.opt_state = train_state_from_jax(ours.model, ours.opt,
                                          jax.tree.map(np.asarray, theirs.params),
                                          jax.tree.map(np.asarray, theirs.opt_state))
    iou, iou_ref = ours.calculate_iou(n), theirs.calculate_iou(n)
    assert iou_ref > 0.5 and abs(iou - iou_ref) <= TOL_IOU, (iou, iou_ref)
    pts = np.random.default_rng(1).random((1000, 3)).astype(np.float32)
    np.testing.assert_allclose(ours.sdf(pts).numpy(), theirs.sdf(pts), rtol=0, atol=1e-2)


def test_producer_feeds_steps_and_stops(tasks):
    """train() takes the producer's batches: each call waits for a fresh one
    for its first step (so every frame() trains on a fresh batch, as the
    JAX package's), and a later step of one call reuses the last when none
    is ready; stop_producer ends the thread."""
    _, ours = tasks(batch_size=2048)
    losses = [ours.train(1) for _ in range(12)]
    assert np.isfinite(losses).all() and ours.training_step == 12
    assert ours.fresh_batches == 12 and ours.reused_batches == 0
    assert np.isfinite(ours.train(8)) and ours.training_step == 20
    assert ours.fresh_batches + ours.reused_batches == 20 and ours.fresh_batches >= 13
    assert ours.batches_produced >= ours.fresh_batches and ours.producer_seconds > 0
    ours.stop_producer()
    assert not ours._thread.is_alive()
    ours.stop_producer()  # idempotent


@pytest.fixture
def mesh_file(tmp_path):
    v, f = bumpy_torus(32, 16, seed=3)
    v = v * np.float32(2.5) + np.float32(0.75)  # a raw frame other than the unit cube
    path = tmp_path / "torus.obj"
    write_obj(path, v, f)
    return path, v[f]


def test_testbed_sdf_surface(mesh_file):
    path, raw = mesh_file
    assert port_testbed.mode_from_scene(path) == common.TestbedMode.SDF
    tb = port_testbed.Testbed("sdf", device="cpu")
    try:
        tb.reload_network_from_json(tiny_config())
        tb.load_file(path)
        assert tb.mode == common.TestbedMode.SDF and isinstance(tb.task, SdfTask)
        assert tb.task.batch_size == 1 << 16  # the JAX package's Testbed passes none
        box = tb.raw_aabb
        lo, hi = box.min, box.max
        np.testing.assert_allclose(lo, raw.reshape(-1, 3).min(0), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(hi, raw.reshape(-1, 3).max(0), rtol=1e-5, atol=1e-5)
        iou0 = tb.calculate_iou(1 << 14)
        tb.calculate_iou_online = True
        for _ in range(16):
            tb.frame()
        assert tb.training_step == 16 and len(tb.loss_graph) == 16 and tb.loss > 0
        assert tb.sdf_iou is not None and tb.sdf_iou > iou0
        frame = tb.render(24, 16)
        assert isinstance(frame, np.ndarray) and frame.dtype == np.float32
        assert frame.shape == (16, 24, 4) and np.isfinite(frame).all()
        assert set(np.unique(frame[..., 3])) <= {0.0, 1.0}
        np.testing.assert_array_equal(tb.render_tensor(24, 16).numpy(), frame)
        srgb = tb.render(24, 16, linear=False)
        np.testing.assert_allclose(
            srgb[..., :3],
            port_testbed.linear_to_srgb(torch.from_numpy(frame[..., :3]).clamp(min=0)).numpy())
        tb.reload_network_from_json(tiny_config(levels=3))  # a new task, the old producer stopped
        old = tb.task
        assert tb.training_step == 0 and tb.task.model.encoding.n_levels == 3
        tb.frame()
        tb.reload_network_from_json(tiny_config())
        assert not old._thread.is_alive()
    finally:
        tb.task.stop_producer()


@pytest.mark.parametrize("with_opt", [True, False])
def test_snapshot_both_ways_between_the_packages(mesh_file, tmp_path, with_opt):
    """JAX save → port load and port save → JAX load onto a Testbed holding
    the mesh: parameters (fp16 in the file) and optimizer state equal to the
    saver's as the saver's own load reads them, and the step."""
    path, _ = mesh_file
    theirs, ours = JaxTestbed(), port_testbed.Testbed("sdf", device="cpu")
    readers = []
    try:
        for tb in (theirs, ours):
            tb.reload_network_from_json(tiny_config())
            tb.load_training_data(str(path))
            for _ in range(3):
                tb.frame()
        for saver, name in ((theirs, "jax"), (ours, "port")):
            snap = tmp_path / f"{name}.ingp"
            saver.save_snapshot(str(snap), include_optimizer_state=with_opt)
            jax_reader, port_reader = JaxTestbed(), port_testbed.Testbed("sdf", device="cpu")
            readers += [jax_reader, port_reader]
            jax_reader.load_training_data(str(path))  # configs/sdf/base.json: rebuilt on load
            port_reader.load_training_data(path)
            jax_reader.reload_network_from_json(tiny_config())
            jax_reader.load_snapshot(str(snap))
            port_reader.load_snapshot(snap)
            assert port_reader.training_step == jax_reader.training_step == 3
            assert port_reader.network_config == jax_reader.network_config
            got = {"params": {"net": [w.detach().numpy()
                                      for w in port_reader.task.model.network.weights],
                              "enc": port_reader.task.model.encoding.unpack_params(
                                  port_reader.task.model.encoding.table.detach().numpy())},
                   "opt": train_state_to_numpy(port_reader.task.model,
                                               port_reader.task.opt_state)}
            want = {"params": jax.tree.map(np.asarray, jax_reader.task.params),
                    "opt": jax.tree.map(np.asarray, jax_reader.task.opt_state)}
            for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            if not with_opt:
                assert got["opt"]["step"] == 0
    finally:
        for tb in (theirs, ours, *readers):
            if tb.task is not None:
                tb.task.stop_producer()


def test_load_snapshot_needs_the_mesh(mesh_file, tmp_path):
    path, _ = mesh_file
    tb = port_testbed.Testbed("sdf", device="cpu")
    tb.reload_network_from_json(tiny_config())
    tb.load_training_data(path)
    snap = tmp_path / "s.ingp"
    try:
        tb.save_snapshot(snap)
    finally:
        tb.task.stop_producer()
    with pytest.raises(RuntimeError, match="sdf"):
        port_testbed.Testbed("sdf", device="cpu").load_snapshot(snap)


def test_testbed_sdf_runs_on_the_card_by_default():
    assert port_testbed.Testbed("sdf").device.type == "cuda"


def test_sdf_path_loads_no_jax_and_not_the_jax_packages_library(mesh_file):
    """A CPU run of the SDF flow in a fresh interpreter: no JAX module, no
    module of the JAX package, and no library under instant_ngp_tpu/ mapped."""
    path, _ = mesh_file
    code = ("import sys\n"
            "from instant_ngp_torch.testbed import Testbed\n"
            "tb = Testbed('sdf', device='cpu')\n"
            f"tb.reload_network_from_json({tiny_config()!r})\n"
            f"tb.load_training_data({str(path)!r})\n"
            "tb.frame()\n"
            "tb.render(8, 8)\n"
            "tb.task.stop_producer()\n"
            "bad = [m for m in ('jax', 'msgpack', 'instant_ngp_tpu') if m in sys.modules]\n"
            "assert not bad, bad\n"
            "maps = open('/proc/self/maps').read()\n"
            "assert 'instant_ngp_tpu' not in maps and 'libngpbvh_' in maps\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
