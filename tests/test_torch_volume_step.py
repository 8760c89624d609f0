"""One training step of the volume primitive in the PyTorch port against the
JAX package's ``VolumeTask._step`` on the CPU: from the JAX package's
parameters and Adam state, on the batch its own step traces from the same
key, the loss, Adam's moments and the new parameters, with and without the
freeze toggles, and the ExponentialDecay schedule of configs/volume/base.json.

Tolerances: the loss relative ``TOL_LOSS`` (1e-5: the bf16 MLP's rows are the
same, the sums run in another order). Adam's first moment is the step's
gradient (times 1 − β1): per leaf within ``TOL_GRAD`` (1e-2) of its largest
value for the MLP (bf16 on both sides), ``TOL_DENSE`` (2e-2) for the dense
grid levels (the JAX package splats them in bf16, the port in f32), as the
image and SDF step tests hold them. The new parameters, where the moment is
not tiny: after a first step within 1e-3 of the learning rate (Adam's first
update is ±lr whatever the gradient's size); after a trained state within
``TOL_GRAD`` of it (the update lr·m̂/√v̂ then moves with the gradient, which
agrees to ``TOL_GRAD``)."""

import jax
import numpy as np
import pytest
import torch

from instant_ngp_torch.config import default_config
from instant_ngp_torch.io.nanovdb import procedural_fog_volume
from instant_ngp_torch.models.network import train_state_from_jax, train_state_to_numpy
from torch_volume_common import OPT, task_pair, tiny_config

torch.set_num_threads(2)

TOL_LOSS = 1e-5
TOL_GRAD, TOL_DENSE = 1e-2, 2e-2


def _jax_batch(task, key):
    return [torch.from_numpy(np.array(a))
            for a in jax.jit(task._generate_batch)(key, task.density_grid)]


def _new_params(task):
    enc = task.model.encoding
    return {"net": [w.detach().numpy() for w in task.model.network.weights],
            "enc": enc.unpack_params(enc.table.detach().numpy())}


def _check_step(theirs, ours, key, train_encoding=True, train_network=True, lr=None,
                param_tol=1e-3):
    """One step in both packages on the JAX batch of ``key``; the port holds
    the JAX package's state before it."""
    ours.opt_state = train_state_from_jax(ours.model, ours.opt,
                                          jax.tree.map(np.asarray, theirs.params),
                                          jax.tree.map(np.asarray, theirs.opt_state))
    theirs.shall_train_encoding = ours.shall_train_encoding = train_encoding
    theirs.shall_train_network = ours.shall_train_network = train_network
    if not (train_encoding and train_network):
        theirs.rebuild_jit_programs()  # the toggles are read when the step is traced
    pts, tgt, valid = _jax_batch(theirs, key)
    assert 0 < float(valid.float().mean()) < 1
    old = jax.tree.map(np.asarray, theirs.params)
    theirs.params, theirs.opt_state, loss_ref = theirs._jit_step(
        theirs.params, theirs.opt_state, theirs.density_grid, key)
    loss = float(ours.train_step(pts, tgt, valid))
    np.testing.assert_allclose(loss, float(loss_ref), rtol=TOL_LOSS)

    m_ref = jax.tree.map(np.asarray, theirs.opt_state["m"])
    state = train_state_to_numpy(ours.model, ours.opt_state)
    assert state["step"] == int(theirs.opt_state["step"])
    for out, ref in zip(state["m"]["net"], m_ref["net"]):
        np.testing.assert_allclose(out, ref, rtol=0, atol=TOL_GRAD * np.abs(ref).max())
    for lv, out, ref in zip(ours.model.encoding.levels, state["m"]["enc"], m_ref["enc"]):
        tol = (TOL_GRAD if lv.hashed else TOL_DENSE) * np.abs(ref).max()
        np.testing.assert_allclose(out, ref, rtol=0, atol=tol)
    new, new_ref = _new_params(ours), jax.tree.map(np.asarray, theirs.params)
    lr = OPT["learning_rate"] if lr is None else lr
    for part, trained in (("net", train_network), ("enc", train_encoding)):
        for out, ref, before, m in zip(new[part], new_ref[part], old[part], m_ref[part]):
            if not trained:
                np.testing.assert_array_equal(out, before)
                np.testing.assert_array_equal(ref, before)
                continue
            big = np.abs(m) > 1e-3 * np.abs(m).max()
            np.testing.assert_allclose(out[big], ref[big], rtol=0, atol=param_tol * lr)
    return loss


@pytest.mark.parametrize("train_encoding,train_network", [(True, True), (False, True),
                                                          (True, False)])
def test_first_step_equals_jax(train_encoding, train_network):
    theirs, ours = task_pair(procedural_fog_volume(32), batch_size=4096)
    assert [lv.hashed for lv in ours.model.encoding.levels] == [False, False, False, True]
    _check_step(theirs, ours, jax.random.PRNGKey(11), train_encoding, train_network)


def test_step_from_a_trained_state_equals_jax():
    """Three JAX steps first (its own batches), then the state carried
    across and one more step in both packages, on a config with hashed
    levels."""
    theirs, ours = task_pair(procedural_fog_volume(32), tiny_config(levels=6, log2=10),
                             batch_size=4096)
    assert any(lv.hashed for lv in ours.model.encoding.levels)
    theirs.train(3)
    assert int(theirs.opt_state["step"]) == 3
    _check_step(theirs, ours, jax.random.PRNGKey(12), param_tol=TOL_GRAD)


def test_volume_config_step_equals_jax():
    """configs/volume/base.json at full width (16 levels, 2^19 entries,
    64 neurons, ExponentialDecay → Adam with l2_reg) on a small batch: its
    schedule's learning rate is 1e-2 at step 1."""
    theirs, ours = task_pair(procedural_fog_volume(32), default_config("volume"),
                             batch_size=2048)
    _check_step(theirs, ours, jax.random.PRNGKey(13), lr=1e-2)


def test_train_runs_the_generator_and_counts_steps():
    """``train`` on the port's own draws: the step count, a finite loss, and
    the same losses from the same seed."""
    runs = []
    for _ in range(2):
        _, ours = task_pair(procedural_fog_volume(16), batch_size=2048)
        runs.append([ours.train(1) for _ in range(3)])
        assert ours.training_step == 3 and ours.opt_state["step"] == 3
    assert np.isfinite(runs[0]).all() and runs[0] == runs[1]
