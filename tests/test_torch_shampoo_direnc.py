"""Shampoo and parametric direction encodings on the port against the JAX
package, on the CPU: the Shampoo update and its state (m, v, the L/R
statistics, the preconditioned momentum) over several steps of a NeRF
model's parameters; an Adam config carrying Shampoo's keys staying Adam;
the state's trees to and from the JAX layout; a NeRF model whose direction
encoding is a hash grid (its tables through A and E at D = 3): the
forward output, ``params_from_jax``, tcnn's packing order; and one whole
training step with both against the JAX step's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from instant_ngp_tpu import snapshot as jax_snapshot
from instant_ngp_tpu.models.nerf_network import NerfNetwork as JaxNerfNetwork
from instant_ngp_tpu.nerf.task import NerfTask as JaxNerfTask
from instant_ngp_tpu.ops.optimizers import optimizer_from_config
from instant_ngp_torch import snapshot as port_snapshot
from instant_ngp_torch.models.nerf_network import (NerfNetwork, flat_from_tree, params_from_jax,
                                                   train_state_from_jax, train_state_to_numpy,
                                                   tree_from_flat)
from instant_ngp_torch.nerf import train as port_train
from instant_ngp_torch.nerf.task import NerfTask
from instant_ngp_torch.ops.optimizers import (Optimizer, OptimizerSpec, state_from_tree,
                                              state_to_tree)

from test_torch_camopt import _grid
from test_torch_train_features import _draws, _jax_step

torch.set_num_threads(2)

SHAMPOO = {"otype": "Ema", "decay": 0.95, "nested": {
    "otype": "ExponentialDecay", "decay_start": 2, "decay_interval": 2, "decay_base": 0.33,
    "nested": {"otype": "Shampoo", "learning_rate": 1e-2, "beta1": 0.9, "beta2": 0.99,
               "epsilon": 1e-15, "l2_reg": 1e-6, "beta3": 0.8, "identity": 1e-4}}}
DIR_GRID = {"otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2,
            "log2_hashmap_size": 10, "base_resolution": 2, "per_level_scale": 2.0}


def _config(shampoo=True, dir_grid=True):
    cfg = graft._tiny_nerf_config()
    if shampoo:
        cfg["optimizer"] = SHAMPOO
    if dir_grid:
        cfg["dir_encoding"] = DIR_GRID
    return cfg


def _leaves_close(ours, theirs, what, tol=1e-5):
    for i, (a, b) in enumerate(zip(jax.tree.leaves(ours), jax.tree.leaves(theirs))):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, (what, i)
        np.testing.assert_allclose(a, b, rtol=0, atol=tol * max(np.abs(b).max(), 1e-30),
                                   err_msg=f"{what} leaf {i}")


def test_shampoo_steps_equal_jax():
    """Six steps of the NeRF model's optimizer (Ema → ExponentialDecay →
    Shampoo: the MLP matrices preconditioned, the hash tables on Adam)
    against the JAX Optimizer.update from the same parameters and gradients:
    the parameters, the EMA, m, v, pm and the L/R statistics each within
    1e-5 of the leaf's largest |ref| (both take eigh of the statistics in
    f32; the preconditioner's f32 rounding, ~3e-6, is the largest term);
    the state's tree keeps the JAX layout, (1, 1) placeholders for the
    tables' statistics (a snapshot packs the JAX package's leaves), and comes
    back from it unchanged."""
    cfg = _config(dir_grid=True)
    jmodel = JaxNerfNetwork.from_config(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    jopt = optimizer_from_config(cfg["optimizer"], matrix_mask=jmodel.matrix_mask(jparams))
    jstate = jopt.init(jparams)
    model = NerfNetwork.from_config(cfg, device="cpu")
    params_from_jax(model, jax.tree.map(np.asarray, jparams))
    opt = Optimizer(OptimizerSpec.from_config(cfg["optimizer"]), model.matrix_mask())
    assert opt.spec.is_shampoo and opt.spec.beta3 == 0.8
    params = model.param_list()
    state = opt.init(params)
    rng = np.random.default_rng(2)
    update = jax.jit(jopt.update)
    for _ in range(6):
        grads = jax.tree.map(lambda p: rng.normal(size=p.shape).astype(np.float32), jparams)
        jparams, jstate = update(jax.tree.map(jnp.asarray, grads), jstate, jparams)
        with torch.no_grad():
            opt.update([torch.from_numpy(g) for g in flat_from_tree(model, grads)], state, params)
    _leaves_close(tree_from_flat(model, params), jparams, "params")
    tree = state_to_tree(state, lambda flat: tree_from_flat(model, flat))
    assert sorted(tree) == sorted(jstate) == ["L", "R", "ema", "m", "pm", "step", "v"]
    assert int(tree["step"]) == int(jstate["step"]) == 6
    for key in ("ema", "m", "v", "pm", "L", "R"):
        _leaves_close(tree[key], jstate[key], key)
    assert [np.shape(a) for a in jax.tree.leaves(tree["L"]["pos_enc"])] == [(1, 1)] * 4
    # a snapshot's packed optimizer state: the JAX package's leaves, dtypes and shapes
    assert [(dt, tuple(shape)) for dt, shape, _ in port_snapshot.pack_tree(tree)] == [
        (dt, tuple(shape)) for dt, shape, _ in jax_snapshot.pack_tree(jstate)]
    back = state_from_tree(tree, lambda t: flat_from_tree(model, t), "cpu")
    for key in ("m", "v", "ema", "pm", "L", "R"):
        assert all(torch.equal(a, b) for a, b in zip(back[key], state[key])), key


def test_adam_config_with_shampoo_keys_stays_adam():
    """An Adam leaf that carries Shampoo's knobs (as the reference's envmap
    block does) trains with Adam, as in the JAX package: no L/R state."""
    cfg = {"otype": "Adam", "learning_rate": 1e-3, "beta3": 0.5, "beta_shampoo": 0.0,
           "identity": 1e-3, "cg_on_momentum": True, "frobenius_normalization": False}
    spec = OptimizerSpec.from_config(cfg)
    from instant_ngp_tpu.ops.optimizers import OptimizerSpec as JaxSpec

    jspec = JaxSpec.from_config(cfg)
    assert spec.otype == jspec.otype == "Adam" and not spec.is_shampoo
    assert (spec.beta3, spec.identity, spec.cg_on_momentum) == (jspec.beta3, jspec.identity,
                                                                jspec.cg_on_momentum)
    state = Optimizer(spec, [True]).init([torch.zeros(4, 4)])
    assert sorted(state) == ["m", "step", "v"]


def test_direction_grid_model_equals_jax():
    """A NeRF model whose direction encoding is a hash grid: the JAX
    parameters carried across (``params_from_jax``; the tree back equal),
    the forward output within 1e-2 of its largest |ref| (bf16 MLPs, as
    test_torch_configs_nerf.py holds), the direction tables last in
    ``param_list`` and in tcnn's blob [density_net, rgb_net, pos_enc,
    dir_enc], byte for byte the JAX package's."""
    cfg = _config(shampoo=False)
    jmodel = JaxNerfNetwork.from_config(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(3))
    jparams = dict(jparams, dir_enc=tuple(
        jax.random.uniform(jax.random.PRNGKey(4 + i), t.shape, minval=-1.0, maxval=1.0)
        for i, t in enumerate(jparams["dir_enc"])))
    model = NerfNetwork.from_config(cfg, device="cpu")
    params_from_jax(model, jax.tree.map(np.asarray, jparams))
    tables = model.param_list()[-1:]
    assert tables[0] is model.dir_encoding.table and model.matrix_mask()[-1] is False
    back = tree_from_flat(model, model.param_list())
    _leaves_close(back, jparams, "params", tol=0.0)
    rng = np.random.default_rng(5)
    pos = rng.random((512, 3), dtype=np.float32)
    dirs = rng.random((512, 3), dtype=np.float32)
    ref = np.asarray(jmodel(jparams, jnp.asarray(pos), jnp.asarray(dirs)), np.float32)
    with torch.no_grad():
        out = model(torch.from_numpy(pos), torch.from_numpy(dirs)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-2 * np.abs(ref).max())
    blob = port_snapshot._pack_params(back)
    assert np.array_equal(blob, jax_snapshot._pack_params(jax.tree.map(np.asarray, jparams),
                                                          jmodel))
    again = port_snapshot._unpack_params(blob, back)
    assert np.array_equal(np.concatenate([np.ravel(t) for t in again["dir_enc"]]),
                          np.concatenate([np.ravel(t) for t in back["dir_enc"]]).astype(
                              np.float16).astype(np.float32))


def test_shampoo_direction_grid_step_equals_jax():
    """One whole training step with Shampoo and a direction grid from the
    same state, the JAX step's draws injected: every parameter's gradient
    (the direction tables' among them) within 2e-2 of its largest |ref| (as
    test_torch_camopt.py holds the MLPs'), the loss within 1e-5, and the
    new MLP matrices where their gradient is not tiny within 1e-3 of the
    rate (Shampoo's first step is grafted to Adam's norm)."""
    cfg = _config()
    kw = dict(target_batch_size=1 << 11, n_rays_per_batch=128, max_samples_per_ray=16,
              n_march_iters=48)
    ds = graft._synthetic_dataset(3, 16, 16)
    jt = JaxNerfTask(ds, cfg, **kw)
    jt.state = dataclasses.replace(jt.state, grid=_grid(8))
    jt.model = dataclasses.replace(jt.model, pos_encoding=dataclasses.replace(
        jt.model.pos_encoding, hashed_grad_corners=8))
    from instant_ngp_torch.io.nerf_loader import NerfDataset

    pds = NerfDataset(**{f.name: getattr(ds, f.name) for f in dataclasses.fields(NerfDataset)})
    pt = NerfTask(pds, cfg, "cpu", **kw)
    pt.model.pos_encoding.hashed_grad_corners = 8
    train_state_from_jax(pt.model, pt.state, jt.state)
    assert "L" in pt.state.opt_state
    key = jax.random.PRNGKey(41)
    draws = _draws(jt, key)
    new_state, stats, grads, _ = _jax_step(jt, jt.state, key)
    p_grads, per_ray, _ = port_train.step_gradients(pt, draws)
    ref = [*grads["density_net"], *grads["rgb_net"],
           np.concatenate([np.asarray(t) for t in grads["pos_enc"]]),
           np.concatenate([np.asarray(t) for t in grads["dir_enc"]])]
    assert len(p_grads) == len(ref)
    for a, b in zip(p_grads, ref):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=2e-2 * np.abs(b).max())
    assert np.abs(ref[-1]).max() > 0  # the direction tables learn
    assert float(per_ray.mean()) == pytest.approx(float(stats["loss"]), rel=1e-5)
    port_train.train_step(pt, draws)
    got = train_state_to_numpy(pt.model, pt.state)
    lr = float(jt.opt.learning_rate_at(0))
    for key_ in ("density_net", "rgb_net"):
        for g_ref, p_ref, p_new in zip(grads[key_], new_state.params[key_],
                                       got["params"][key_]):
            big = np.abs(np.asarray(g_ref)) > 1e-3 * np.abs(np.asarray(g_ref)).max()
            np.testing.assert_allclose(p_new[big], np.asarray(p_ref)[big], rtol=0,
                                       atol=1e-3 * lr)
