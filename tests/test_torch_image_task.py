"""The image primitive of the PyTorch port against the JAX package on the
CPU: position sampling, one training step from the same state and
positions, render and compute_mse from the same parameters, a short fit,
and the Testbed image surface."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instant_ngp_tpu.image_fit.task import ImageTask as JaxImageTask
from instant_ngp_tpu.testbed import Testbed as JaxTestbed
from instant_ngp_torch import testbed as port_testbed
from instant_ngp_torch import common
from instant_ngp_torch.image_fit.task import ImageTask
from instant_ngp_torch.io.image import save_image
from instant_ngp_torch.models.network import (
    params_from_jax,
    train_state_from_jax,
    train_state_to_numpy,
)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
OPT = {"otype": "Adam", "learning_rate": 1e-2, "beta1": 0.9, "beta2": 0.99, "epsilon": 1e-15,
       "l2_reg": 1e-6}


def _config(log2_hashmap_size=12, levels=4, neurons=16, hidden=1):
    """tests/test_tasks.py's tiny image config."""
    return {"loss": {"otype": "L2"}, "optimizer": OPT,
            "encoding": {"otype": "HashGrid", "n_levels": levels, "n_features_per_level": 2,
                         "log2_hashmap_size": log2_hashmap_size, "base_resolution": 4},
            "network": {"otype": "FullyFusedMLP", "activation": "ReLU",
                        "output_activation": "None", "n_neurons": neurons,
                        "n_hidden_layers": hidden}}


def _image(h=32, w=32):
    """tests/test_tasks.py's tiny image (at any size)."""
    y, x = np.mgrid[0:h, 0:w] / float(max(h, w))
    return np.stack([np.sin(4 * x) * 0.5 + 0.5, y, x * y, np.ones_like(x)], -1).astype(np.float32)


def _tasks(img, config, is_hdr=True, **kw):
    theirs = JaxImageTask(img, is_hdr, config, **kw)
    ours = ImageTask(img, is_hdr, config, device="cpu", **kw)
    params_from_jax(ours.model, jax.tree.map(np.asarray, theirs.params))
    return theirs, ours


@pytest.mark.parametrize("batch", [4096, 2048])
@pytest.mark.parametrize("mode", [m.value for m in common.RandomMode if m.name.isupper()])
def test_sample_positions_equal_jax(mode, batch):
    """Every random mode at steps 0 and 5 with JAX's uniforms injected, as
    the jitted step samples them; 2048 is no square, so stratified is random."""
    theirs, ours = _tasks(_image(8, 8), _config(), batch_size=batch, random_mode=mode)
    sample = jax.jit(theirs._sample_positions)
    for step in (0, 5):
        key = jax.random.PRNGKey(step)
        u = torch.from_numpy(np.array(jax.random.uniform(key, (batch, 2))))
        ref = np.asarray(sample(key, jnp.uint32(step)))
        out = ours.sample_positions(u if ours.draw_uniforms() is not None else None, step)
        np.testing.assert_array_equal(out.numpy(), ref)


# The step's gradients, read back from Adam's first moment (m = (1 − β1)·g
# after one step from zero), per leaf against the leaf's largest value:
# the MLP and hashed tables at 1e-2 (bf16 compute on both sides: a hidden
# unit's bf16 rounding can flip when f32 sums differ in order), dense
# tables at 2e-2 (the JAX package splats them in bf16, the port in f32).
TOL_GRAD, TOL_DENSE = 1e-2, 2e-2


@pytest.mark.parametrize("linear_colors", [False, True])
def test_one_step_equals_jax(linear_colors):
    img = _image(64, 64)
    # levels at resolutions 4, 8, 16, 32 in a 2^7 table: two dense, two hashed
    theirs, ours = _tasks(img, _config(log2_hashmap_size=7), batch_size=4096,
                          linear_colors=linear_colors)
    levels = ours.model.encoding.levels
    assert [lv.hashed for lv in levels] == [False, False, True, True]
    uv = np.random.default_rng(1).random((4096, 2), dtype=np.float32)
    theirs._sample_positions = lambda key, step: jnp.asarray(uv)
    theirs.rebuild_jit_programs()
    loss_ref = theirs.train(1)
    loss = float(ours.train_step(torch.from_numpy(uv)))
    np.testing.assert_allclose(loss, loss_ref, rtol=1e-5)

    m_ref = jax.tree.map(np.asarray, theirs.opt_state["m"])
    state = train_state_to_numpy(ours.model, ours.opt_state)
    assert state["step"] == int(theirs.opt_state["step"]) == 1
    for out, ref in zip(state["m"]["net"], m_ref["net"]):
        np.testing.assert_allclose(out, ref, rtol=0, atol=TOL_GRAD * np.abs(ref).max())
    for lv, out, ref in zip(levels, state["m"]["enc"], m_ref["enc"]):
        tol = (TOL_GRAD if lv.hashed else TOL_DENSE) * np.abs(ref).max()
        np.testing.assert_allclose(out, ref, rtol=0, atol=tol)

    # new parameters where the gradient is not tiny: Adam moves them by ~lr
    new_ref = jax.tree.map(np.asarray, theirs.params)
    new = {"net": [w.detach().numpy() for w in ours.model.network.weights],
           "enc": ours.model.encoding.unpack_params(ours.model.encoding.table.detach().numpy())}
    for key in ("net", "enc"):
        for out, ref, m in zip(new[key], new_ref[key], m_ref[key]):
            big = np.abs(m) > 1e-3 * np.abs(m).max()
            np.testing.assert_allclose(out[big], ref[big], rtol=0, atol=1e-3 * OPT["learning_rate"])


def test_step_from_jax_train_state_equals_jax():
    """The JAX package's state after a step, loaded with train_state_from_jax,
    takes the next step as the JAX package does."""
    theirs, ours = _tasks(_image(32, 32), _config(), batch_size=4096)
    rng = np.random.default_rng(2)
    uvs = [rng.random((4096, 2), dtype=np.float32) for _ in range(2)]
    theirs._sample_positions = lambda key, step: jnp.where(step == 0, uvs[0], uvs[1])
    theirs.rebuild_jit_programs()
    theirs.train(1)
    ours.opt_state = train_state_from_jax(ours.model, ours.opt,
                                          jax.tree.map(np.asarray, theirs.params),
                                          jax.tree.map(np.asarray, theirs.opt_state))
    back = train_state_to_numpy(ours.model, ours.opt_state)
    for key in ("m", "v"):
        for a, b in zip(jax.tree.leaves(back[key]), jax.tree.leaves(theirs.opt_state[key])):
            np.testing.assert_array_equal(a, np.asarray(b))
    loss_ref = theirs.train(1)
    loss = float(ours.train_step(torch.from_numpy(uvs[1])))
    np.testing.assert_allclose(loss, loss_ref, rtol=1e-5)
    v_ref = jax.tree.map(np.asarray, theirs.opt_state["v"])
    v = train_state_to_numpy(ours.model, ours.opt_state)["v"]
    for out, ref in zip(jax.tree.leaves(v), jax.tree.leaves(v_ref)):
        np.testing.assert_allclose(out, ref, rtol=0, atol=TOL_DENSE * np.abs(ref).max())


def test_render_and_mse_equal_jax():
    theirs, ours = _tasks(_image(24, 40), _config(), batch_size=1024, is_hdr=False)
    params = jax.tree.map(lambda p: p + 0.05 * jnp.sign(p), theirs.params)  # a trained-looking model
    theirs.params = params
    params_from_jax(ours.model, jax.tree.map(np.asarray, params))
    for w, h in ((40, 24), (17, 9)):
        ref = np.asarray(theirs.render(w, h))
        out = ours.render(w, h).numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-2, atol=1e-3)
    ref = np.asarray(theirs.render(30, 20, gt_checkerboard=True, checker_px=4))
    out = ours.render(30, 20, gt_checkerboard=True, checker_px=4).numpy()
    tiles = ((np.arange(30)[None, :] // 4 + np.arange(20)[:, None] // 4) % 2) == 0
    np.testing.assert_allclose(out[~tiles], ref[~tiles], rtol=0, atol=1e-6)  # ground truth
    np.testing.assert_allclose(out[tiles], ref[tiles], rtol=1e-2, atol=1e-3)
    for quantize in (False, True):
        np.testing.assert_allclose(ours.compute_mse(quantize), theirs.compute_mse(quantize),
                                   rtol=1e-3)


def test_tiny_fit_reaches_tests_tasks_mse():
    """tests/test_tasks.py's fit: 60 steps of 4096 samples, MSE < 0.01 in
    both packages, and within 2x of each other."""
    theirs, ours = _tasks(_image(), _config(), batch_size=4096, linear_colors=True)
    theirs.train(60)
    ours.train(60)
    mse_ref, mse = theirs.compute_mse(), ours.compute_mse()
    assert mse < 0.01 and mse_ref < 0.01, (mse, mse_ref)
    assert 0.5 < mse / mse_ref < 2.0, (mse, mse_ref)


def test_testbed_image_surface(tmp_path):
    path = tmp_path / "img.bin"
    save_image(path, _image(20, 28))
    assert port_testbed.mode_from_scene(path) == common.TestbedMode.IMAGE
    tb = port_testbed.Testbed("image", device="cpu")
    tb.training_batch_size = 1024
    tb.reload_network_from_json(_config())
    tb.load_file(path)
    assert tb.mode == common.TestbedMode.IMAGE and tb.task.resolution == (28, 20)
    assert tb.image.random_mode == common.RandomMode.STRATIFIED
    assert not tb.image.training.linear_colors and not tb.image.training.snap_to_pixel_centers
    mse0 = tb.compute_image_mse()
    for _ in range(5):
        tb.frame()
    assert tb.training_step == 5 and len(tb.loss_graph) == 5 and tb.loss > 0
    assert tb.compute_image_mse() < mse0
    frame = tb.render(16, 8)  # pyngp render_to_cpu: a numpy frame on the host
    assert isinstance(frame, np.ndarray) and frame.dtype == np.float32
    assert frame.shape == (8, 16, 4) and np.isfinite(frame).all()
    np.testing.assert_array_equal(frame[..., 3], np.ones((8, 16), np.float32))
    np.testing.assert_array_equal(tb.render_tensor(16, 8).numpy(), frame)
    srgb = tb.render(16, 8, linear=False)  # .bin is HDR: the task's output is linear
    np.testing.assert_allclose(
        srgb[..., :3],
        port_testbed.linear_to_srgb(torch.from_numpy(frame[..., :3]).clamp(min=0)).numpy())
    tb.image.random_mode = "halton"
    tb.image.training.linear_colors = True
    tb.image.training.snap_to_pixel_centers = True
    assert tb.task.random_mode == "halton" and tb.task.linear_colors
    assert tb.image.training.snap_to_pixel_centers
    tb.frame()
    assert tb.training_step == 6
    tb.reload_network_from_file("base.json")  # configs/image/base.json: a new task
    assert tb.training_step == 0 and tb.task.model.encoding.log2_hashmap_size == 24


def test_testbed_render_equals_jax_testbed_render(tmp_path):
    """Image mode: the port's Testbed.render against the JAX Testbed.render
    on the same trained state (5 JAX frames, copied into the port), in both
    colour spaces: a numpy (H, W, 4) f32 frame each, alpha exactly 1, rgb
    within the MLP tolerance (bf16 compute on both sides; only the f32
    summation order differs)."""
    path = tmp_path / "img.bin"
    save_image(path, _image(20, 28))
    theirs = JaxTestbed()
    theirs.training_batch_size = 1024
    theirs.reload_network_from_json(_config())
    theirs.load_training_data(str(path))
    for _ in range(5):
        theirs.frame()
    ours = port_testbed.Testbed("image", device="cpu")
    ours.training_batch_size = 1024
    ours.reload_network_from_json(_config())
    ours.load_training_data(path)
    ours.task.opt_state = train_state_from_jax(ours.task.model, ours.task.opt,
                                               jax.tree.map(np.asarray, theirs.task.params),
                                               jax.tree.map(np.asarray, theirs.task.opt_state))
    for linear in (True, False):
        ref, out = theirs.render(16, 8, linear=linear), ours.render(16, 8, linear=linear)
        assert isinstance(ref, np.ndarray) and isinstance(out, np.ndarray)
        assert out.dtype == ref.dtype == np.float32 and out.shape == ref.shape == (8, 16, 4)
        np.testing.assert_array_equal(out[..., 3], ref[..., 3])
        np.testing.assert_allclose(out, ref, rtol=1e-2, atol=1e-3)


def test_testbed_runs_on_the_card_by_default():
    """Entry points run on the card unless the caller asks for the CPU
    (building a torch.device needs no card)."""
    assert port_testbed.Testbed("image").device.type == "cuda"
    assert port_testbed.Testbed().device.type == "cuda"


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_port_and_chip_smoke_import_neither_jax_nor_the_jax_package():
    files = [*sorted((ROOT / "instant_ngp_torch").rglob("*.py")), ROOT / "chip_smoke.py"]
    bad = {str(p.relative_to(ROOT)): _imports(p) & {"jax", "jaxlib", "instant_ngp_tpu"}
           for p in files}
    assert not any(bad.values()), bad
    # and at run time: the image path loads no JAX module
    code = ("import sys\n"
            "import numpy as np\n"
            "from instant_ngp_torch.image_fit.task import ImageTask\n"
            "t = ImageTask(np.ones((8, 8, 4), np.float32), True, {}, device='cpu', batch_size=64)\n"
            "t.train(1)\n"
            "bad = [m for m in ('jax', 'msgpack', 'instant_ngp_tpu') if m in sys.modules]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
