"""Every shipped image config in the port against the JAX package on the CPU,
shrunk by tests/test_configs_smoke.py's ``_shrink``: ``ImageTask`` builds it
on tests/test_configs_smoke.py's random 32² RGBA image, the model's forward
equals the JAX package's with the parameters carried across, and two
training steps leave a finite MSE. OneBlob also takes one step against the
JAX package's, at the same positions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instant_ngp_tpu.image_fit.task import ImageTask as JaxImageTask
from instant_ngp_torch.image_fit.task import ImageTask
from instant_ngp_torch.models.network import params_from_jax, params_to_numpy, train_state_to_numpy
from torch_configs_common import assert_step_matches, config_names, load_shrunk, numpy_tree

torch.set_num_threads(2)

CONFIGS = config_names("image")
# as tests/test_torch_configs_nerf.py
TOL_FORWARD = 2e-2


def _image():
    return np.random.default_rng(0).integers(0, 255, (32, 32, 4), np.uint8)


def _tasks(cfg, batch_size=256):
    """(JAX task, port task with the JAX parameters carried across; any
    table leaf drawn in ±1 first, so that the encoding matters)."""
    theirs = JaxImageTask(_image(), False, cfg, batch_size=batch_size)
    params = numpy_tree(theirs.params)
    rng = np.random.default_rng(1)
    if "enc" in params:
        params["enc"] = jax.tree.map(
            lambda t: rng.uniform(-1, 1, np.shape(t)).astype(np.float32), params["enc"])
        theirs.params = jax.tree.map(jnp.asarray, params)
    ours = ImageTask(_image(), False, cfg, device="cpu", batch_size=batch_size)
    params_from_jax(ours.model, params)
    return theirs, ours


@pytest.mark.parametrize("name", CONFIGS)
def test_config_builds_matches_jax_and_trains(name):
    theirs, ours = _tasks(load_shrunk("image", name))
    uv = np.random.default_rng(2).random((512, 2), dtype=np.float32)
    ref = np.asarray(jax.jit(lambda p, x: theirs.model(p, x).astype(jnp.float32))(theirs.params,
                                                                                   uv))
    with torch.no_grad():
        out = ours.model(torch.from_numpy(uv)).numpy()
    assert out.shape == ref.shape == (512, 3)
    np.testing.assert_allclose(out, ref, rtol=0, atol=TOL_FORWARD * np.abs(ref).max())
    assert np.isfinite(ours.train(2))
    assert ours.training_step == 2 and np.isfinite(ours.compute_mse())


def test_oneblob_step_equals_jax():
    """One step at injected positions: the loss, Adam's first moment and the
    new parameters."""
    cfg = load_shrunk("image", "oneblob.json")
    theirs, ours = _tasks(cfg, batch_size=4096)
    uv = np.random.default_rng(3).random((4096, 2), dtype=np.float32)
    theirs._sample_positions = lambda key, step: jnp.asarray(uv)
    theirs.rebuild_jit_programs()
    loss_ref = theirs.train(1)
    loss = float(ours.train_step(torch.from_numpy(uv)))
    np.testing.assert_allclose(loss, loss_ref, rtol=1e-5)
    m_out = train_state_to_numpy(ours.model, ours.opt_state)["m"]
    assert_step_matches(m_out, numpy_tree(theirs.opt_state["m"]), params_to_numpy(ours.model),
                        numpy_tree(theirs.params), ("enc",), ours.opt.spec.learning_rate)
