"""Every shipped NeRF config in the port against the JAX package on the CPU,
at the model level as tests/test_configs_smoke.py drives them, shrunk by
its ``_shrink``: ``NerfNetwork.from_config`` builds it, its forward equals
the JAX package's with the parameters carried across, and two steps of the
config's loss and optimizer stay finite. The new position encodings
(Frequency, Identity, a Composite of HashGrids over overlapping slices)
also take one step against the JAX package's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instant_ngp_tpu.models.nerf_network import NerfNetwork as JaxNerfNetwork
from instant_ngp_tpu.ops.losses import loss_fn as jax_loss_fn
from instant_ngp_tpu.ops.losses import loss_type_from_string as jax_loss_type
from instant_ngp_tpu.ops.optimizers import optimizer_from_config
from instant_ngp_torch.models.nerf_network import (NerfNetwork, params_from_jax,
                                                   params_to_numpy, tree_from_flat)
from instant_ngp_torch.ops.losses import loss_fn, loss_type_from_string
from instant_ngp_torch.ops.optimizers import Optimizer, OptimizerSpec, state_to_tree
from torch_configs_common import assert_step_matches, config_names, load_shrunk, numpy_tree

torch.set_num_threads(2)

CONFIGS = config_names("nerf")
N = 256
# The forward, per output, against the largest |output| of the JAX package's:
# bf16 inputs, weights and hidden activations on both sides, f32 sums in
# another order (a hidden unit's bf16 rounding can flip), and the encodings'
# ulp-level differences (sin/cos, XLA's FMAs in the grid's interpolation).
TOL_FORWARD = 2e-2


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((N, 3), dtype=np.float32), rng.random((N, 3), dtype=np.float32),
            rng.random((N, 4), dtype=np.float32))


def _models(cfg):
    """(JAX model, its parameters with every table leaf drawn in ±1 so that
    the encodings matter, the port's model with them carried across)."""
    theirs = JaxNerfNetwork.from_config(cfg)
    params = numpy_tree(theirs.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    if "pos_enc" in params:
        params["pos_enc"] = jax.tree.map(
            lambda t: rng.uniform(-1, 1, np.shape(t)).astype(np.float32), params["pos_enc"])
    ours = NerfNetwork.from_config(cfg, device="cpu")
    params_from_jax(ours, params)
    return theirs, params, ours


@pytest.mark.parametrize("name", CONFIGS)
def test_config_builds_matches_jax_and_trains(name):
    cfg = load_shrunk("nerf", name)
    theirs, params, ours = _models(cfg)
    assert all(a.shape == b.shape for a, b in
               zip(jax.tree.leaves(params), jax.tree.leaves(params_to_numpy(ours))))
    pos, dirs, target = _inputs()
    ref = np.asarray(jax.jit(lambda p, a, b: theirs(p, a, b).astype(jnp.float32))(params, pos,
                                                                                    dirs))
    with torch.no_grad():
        out = ours(torch.from_numpy(pos), torch.from_numpy(dirs)).numpy()
    assert out.shape == ref.shape == (N, 4)
    np.testing.assert_allclose(out, ref, rtol=0, atol=TOL_FORWARD * np.abs(ref).max())

    lfn = loss_fn(loss_type_from_string(cfg.get("loss", {}).get("otype", "L2")))
    opt = Optimizer(OptimizerSpec.from_config(cfg.get("optimizer", {})), ours.matrix_mask())
    plist = ours.param_list()
    state = opt.init(plist)
    x, d, t = map(torch.from_numpy, (pos, dirs, target))
    for _ in range(2):
        loss = torch.mean(lfn(t, ours(x, d)))
        grads = torch.autograd.grad(loss, plist)
        with torch.no_grad():
            opt.update(list(grads), state, plist)
        assert np.isfinite(float(loss.detach()))
    assert all(bool(torch.isfinite(p).all()) for p in plist)


@pytest.mark.parametrize("name", ["frequency.json", "none.json", "tensor.json"])
def test_one_step_equals_jax(name):
    """One step of the config's loss and optimizer from the same parameters
    on the same inputs: the loss, Adam's first moment and the new
    parameters."""
    cfg = load_shrunk("nerf", name)
    theirs, params, ours = _models(cfg)
    pos, dirs, target = _inputs(2)
    lname = cfg.get("loss", {}).get("otype", "L2")
    jopt = optimizer_from_config(cfg.get("optimizer", {}), matrix_mask=theirs.matrix_mask(params))
    jlfn = jax_loss_fn(jax_loss_type(lname))

    @jax.jit
    def step(p, s):
        val, g = jax.value_and_grad(
            lambda q: jnp.mean(jlfn(target, theirs(q, pos, dirs).astype(jnp.float32))))(p)
        p, s = jopt.update(g, s, p)
        return p, s, val

    new_ref, jstate, loss_ref = step(jax.tree.map(jnp.asarray, params), jopt.init(params))
    lfn = loss_fn(loss_type_from_string(lname))
    opt = Optimizer(OptimizerSpec.from_config(cfg.get("optimizer", {})), ours.matrix_mask())
    plist = ours.param_list()
    state = opt.init(plist)
    loss = torch.mean(lfn(torch.from_numpy(target), ours(torch.from_numpy(pos),
                                                          torch.from_numpy(dirs))))
    grads = torch.autograd.grad(loss, plist)
    with torch.no_grad():
        opt.update(list(grads), state, plist)
    np.testing.assert_allclose(float(loss.detach()), float(loss_ref), rtol=1e-5)
    m_out = state_to_tree(state, lambda flat: tree_from_flat(ours, flat))["m"]
    assert_step_matches(m_out, numpy_tree(jstate["m"]), params_to_numpy(ours),
                        numpy_tree(new_ref), ("pos_enc",), opt.spec.learning_rate)
