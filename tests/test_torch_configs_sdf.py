"""Every shipped SDF config in the port against the JAX package on the CPU,
shrunk by tests/test_configs_smoke.py's ``_shrink``, on its tetrahedron
soup: ``SdfTask`` builds it (Takikawa's octree included), the model's
forward equals the JAX package's with the parameters carried across, and two
training steps on the producer's batches stay finite. Takikawa also takes
one step against the JAX package's on the same batch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instant_ngp_tpu.sdf.task import SdfTask as JaxSdfTask
from instant_ngp_torch.models.network import params_from_jax, params_to_numpy, train_state_to_numpy
from instant_ngp_torch.sdf.task import SdfTask
from torch_configs_common import assert_step_matches, config_names, load_shrunk, numpy_tree

torch.set_num_threads(2)

CONFIGS = config_names("sdf")
# as tests/test_torch_configs_nerf.py
TOL_FORWARD = 2e-2
# tests/test_configs_smoke.py's unit tetrahedron soup
TRIS = np.array([
    [[0.2, 0.2, 0.2], [0.8, 0.2, 0.2], [0.2, 0.8, 0.2]],
    [[0.2, 0.2, 0.2], [0.2, 0.8, 0.2], [0.2, 0.2, 0.8]],
    [[0.2, 0.2, 0.2], [0.2, 0.2, 0.8], [0.8, 0.2, 0.2]],
    [[0.8, 0.2, 0.2], [0.2, 0.2, 0.8], [0.2, 0.8, 0.2]],
], np.float32)


@pytest.fixture
def tasks():
    """Builds (JAX task, port task) pairs with the JAX parameters carried
    across (any table leaf drawn in ±1 first), and stops both producers."""
    made = []

    def make(cfg, batch_size=256):
        theirs = JaxSdfTask(TRIS, cfg, batch_size=batch_size)
        ours = SdfTask(TRIS, cfg, device="cpu", batch_size=batch_size)
        made.extend([theirs, ours])
        params = numpy_tree(theirs.params)
        rng = np.random.default_rng(1)
        if "enc" in params:
            params["enc"] = jax.tree.map(
                lambda t: rng.uniform(-1, 1, np.shape(t)).astype(np.float32), params["enc"])
            theirs.params = jax.tree.map(jnp.asarray, params)
        params_from_jax(ours.model, params)
        return theirs, ours

    yield make
    for task in made:
        task.stop_producer()


@pytest.mark.parametrize("name", CONFIGS)
def test_config_builds_matches_jax_and_trains(tasks, name):
    theirs, ours = tasks(load_shrunk("sdf", name))
    if name == "takikawa.json":
        for a, b in zip(theirs.octree.levels, ours.octree.levels):
            np.testing.assert_array_equal(a, b)
    pts = np.random.default_rng(2).random((512, 3), dtype=np.float32)
    ref = np.asarray(jax.jit(lambda p, x: theirs.model(p, x).astype(jnp.float32))(theirs.params,
                                                                                   pts))
    with torch.no_grad():
        out = ours.model(torch.from_numpy(pts)).numpy()
    assert out.shape == ref.shape == (512, 1)
    np.testing.assert_allclose(out, ref, rtol=0, atol=TOL_FORWARD * np.abs(ref).max())
    ours.train(2)
    assert ours.training_step == 2
    assert all(bool(torch.isfinite(p).all()) for p in ours.model.param_list())


def test_takikawa_step_equals_jax(tasks):
    """One step on the same batch: the loss, Adam's first moment and the new
    parameters, the vertex table's gradient through the octree's gathers."""
    theirs, ours = tasks(load_shrunk("sdf", "takikawa.json"), batch_size=4096)
    pts, d = theirs.generate_training_batch()
    theirs.params, theirs.opt_state, loss_ref = theirs._jit_step(
        theirs.params, theirs.opt_state, jnp.asarray(pts), jnp.asarray(d))
    loss = float(ours.train_step(torch.from_numpy(pts), torch.from_numpy(d)))
    np.testing.assert_allclose(loss, float(loss_ref), rtol=1e-5)
    m_out = train_state_to_numpy(ours.model, ours.opt_state)["m"]
    assert_step_matches(m_out, numpy_tree(theirs.opt_state["m"]), params_to_numpy(ours.model),
                        numpy_tree(theirs.params), ("enc",), ours.opt.spec.learning_rate)
