"""The volume primitive's Testbed surface in the PyTorch port against the
JAX package on the CPU: ``Testbed("volume")`` on a ``.nvdb`` file written by
``tests/nvdb_fixture.py``, snapshots byte for byte the JAX package's and
loaded both ways, and no JAX at run time."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from instant_ngp_tpu.testbed import Testbed as JaxTestbed
from instant_ngp_torch import common
from instant_ngp_torch import testbed as port_testbed
from instant_ngp_torch.io.nanovdb import procedural_fog_volume
from instant_ngp_torch.models.network import train_state_from_jax, train_state_to_numpy
from instant_ngp_torch.volume.task import VolumeTask
from nvdb_fixture import write_nvdb
from torch_volume_common import tiny_config

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def nvdb_file(tmp_path):
    return write_nvdb(tmp_path / "fog.nvdb", procedural_fog_volume(16))


def test_testbed_volume_surface(nvdb_file):
    assert port_testbed.mode_from_scene(nvdb_file) == common.TestbedMode.VOLUME
    tb = port_testbed.Testbed("volume", device="cpu")
    tb.reload_network_from_json(tiny_config())
    tb.load_file(nvdb_file)
    assert tb.mode == common.TestbedMode.VOLUME and isinstance(tb.task, VolumeTask)
    assert tb.task.batch_size == 1 << 17  # the JAX package's Testbed passes none
    np.testing.assert_array_equal(tb.task.density_grid.numpy(), procedural_fog_volume(16))
    tb.task.batch_size = 2048
    mse0 = tb.task.compute_density_mse(1 << 12)
    for _ in range(12):
        tb.frame()
    assert tb.training_step == 12 and len(tb.loss_graph) == 12 and tb.loss > 0
    assert tb.task.compute_density_mse(1 << 12) < mse0
    frame = tb.render(16, 12)
    assert isinstance(frame, np.ndarray) and frame.dtype == np.float32
    assert frame.shape == (12, 16, 4) and np.isfinite(frame).all()
    gt = tb.render(16, 12, ground_truth=True)
    assert gt.shape == (12, 16, 4) and set(np.unique(gt[..., 3])) <= {0.0, 1.0}
    srgb = tb.render_tensor(16, 12, linear=False, ground_truth=True).numpy()
    assert srgb.shape == (12, 16, 4) and np.isfinite(srgb).all()
    tb.reload_network_from_json(tiny_config(levels=3))  # a new task on the same grid
    assert tb.training_step == 0 and tb.task.model.encoding.n_levels == 3


def _carry(theirs_tb, ours_tb):
    """The JAX Testbed's task state (parameters, Adam state, step, loss
    meter) into the port's."""
    jt, pt = theirs_tb.task, ours_tb.task
    pt.opt_state = train_state_from_jax(pt.model, pt.opt, jax.tree.map(np.asarray, jt.params),
                                        jax.tree.map(np.asarray, jt.opt_state))
    pt.training_step = ours_tb.training_step = jt.training_step
    ours_tb._loss_ema.value = theirs_tb.loss


@pytest.mark.parametrize("with_opt", [True, False])
def test_snapshots_both_ways_between_the_packages(nvdb_file, tmp_path, with_opt):
    """The port's file is the JAX package's byte for byte for the same state;
    each package loads the other's onto a Testbed holding the grid: the
    parameters (fp16 in the file) and optimizer state the saver's own load
    reads, and the step."""
    theirs, ours = JaxTestbed(), port_testbed.Testbed("volume", device="cpu")
    for tb in (theirs, ours):
        tb.reload_network_from_json(tiny_config())
        tb.load_training_data(str(nvdb_file))
    theirs.task.batch_size = 2048
    for _ in range(2):
        theirs.frame()
    _carry(theirs, ours)
    files = {}
    for saver, name in ((theirs, "jax"), (ours, "port")):
        files[name] = tmp_path / f"{name}.ingp"
        saver.save_snapshot(str(files[name]), include_optimizer_state=with_opt)
    assert files["port"].read_bytes() == files["jax"].read_bytes()
    for name in ("jax", "port"):
        jax_reader, port_reader = JaxTestbed(), port_testbed.Testbed("volume", device="cpu")
        jax_reader.reload_network_from_json(tiny_config())
        jax_reader.load_training_data(str(nvdb_file))
        port_reader.load_training_data(nvdb_file)  # configs/volume/base.json: rebuilt on load
        jax_reader.load_snapshot(str(files[name]))
        port_reader.load_snapshot(files[name])
        assert port_reader.training_step == jax_reader.training_step == 2
        assert port_reader.network_config == jax_reader.network_config == tiny_config()
        enc = port_reader.task.model.encoding
        got = {"params": {"net": [w.detach().numpy() for w in port_reader.task.model.network.weights],
                          "enc": enc.unpack_params(enc.table.detach().numpy())},
               "opt": train_state_to_numpy(port_reader.task.model, port_reader.task.opt_state)}
        want = {"params": jax.tree.map(np.asarray, jax_reader.task.params),
                "opt": jax.tree.map(np.asarray, jax_reader.task.opt_state)}
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        if not with_opt:
            assert got["opt"]["step"] == 0
        port_reader.task.batch_size = 2048
        port_reader.frame()  # the loaded task trains on
        assert port_reader.training_step == 3


def test_load_snapshot_needs_the_grid(nvdb_file, tmp_path):
    tb = port_testbed.Testbed("volume", device="cpu")
    tb.reload_network_from_json(tiny_config())
    tb.load_training_data(nvdb_file)
    snap = tmp_path / "v.ingp"
    tb.save_snapshot(snap)
    with pytest.raises(RuntimeError, match="volume"):
        port_testbed.Testbed("volume", device="cpu").load_snapshot(snap)


def test_testbed_volume_runs_on_the_card_by_default():
    assert port_testbed.Testbed("volume").device.type == "cuda"


def test_volume_path_loads_no_jax(nvdb_file):
    """A CPU run of the volume flow in a fresh interpreter: no JAX module
    and no module of the JAX package."""
    code = ("import sys\n"
            "from instant_ngp_torch.testbed import Testbed\n"
            "tb = Testbed('volume', device='cpu')\n"
            f"tb.reload_network_from_json({tiny_config()!r})\n"
            f"tb.load_training_data({str(nvdb_file)!r})\n"
            "tb.task.batch_size = 1024\n"
            "tb.frame()\n"
            "tb.render(8, 8)\n"
            "tb.render(8, 8, ground_truth=True)\n"
            "bad = [m for m in ('jax', 'msgpack', 'instant_ngp_tpu') if m in sys.modules]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
