"""The training step's plain-torch parts against the JAX package on the
CPU: losses, the optimizer on identical gradients, sample compaction, the
occupancy-grid update with the JAX package's draws injected, visibility
culling, and the training-state round trip."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from instant_ngp_tpu.common import NerfActivation as JaxActivation
from instant_ngp_tpu.models.nerf_network import NerfNetwork as JaxNerfNetwork
from instant_ngp_tpu.nerf import occupancy as jax_occ
from instant_ngp_tpu.ops import compaction as jax_cmp
from instant_ngp_tpu.ops import losses as jax_losses
from instant_ngp_tpu.ops import optimizers as jax_opt
from instant_ngp_torch.common import NerfActivation
from instant_ngp_torch.models.nerf_network import (
    NerfNetwork,
    flat_from_tree,
    params_from_jax,
    params_to_numpy,
    train_state_from_jax,
    train_state_to_numpy,
)
from instant_ngp_torch.nerf import occupancy as port_occ
from instant_ngp_torch.ops import compaction as port_cmp
from instant_ngp_torch.ops import losses as port_losses
from instant_ngp_torch.ops.optimizers import Optimizer, OptimizerSpec

torch.set_num_threads(2)


@pytest.mark.parametrize("name", ["Huber", "L2"])
def test_losses_equal_jax(name):
    rng = np.random.default_rng(0)
    t = rng.random((500, 3), dtype=np.float32)
    p = (t + rng.standard_normal((500, 3)) * 0.2).astype(np.float32)
    lt = port_losses.loss_type_from_string(name)
    assert lt.value == jax_losses.loss_type_from_string(name).value
    ref = np.asarray(jax_losses.loss_fn(jax_losses.loss_type_from_string(name))(t, p))
    out = port_losses.loss_fn(lt)(torch.from_numpy(t), torch.from_numpy(p)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=0)  # same f32 formula


def _optimizer_config():
    return {"otype": "Ema", "decay": 0.95, "nested": {
        "otype": "ExponentialDecay", "decay_start": 2, "decay_interval": 2, "decay_base": 0.33,
        "nested": {"otype": "Adam", "learning_rate": 1e-2, "beta1": 0.9, "beta2": 0.99,
                   "epsilon": 1e-15, "l2_reg": 1e-6}}}


def test_optimizer_steps_equal_jax_on_identical_gradients():
    """Six Adam steps through the decay schedule with l2_reg on the matrices
    and the parameter EMA. The same f32 operations in the same order; XLA's
    pow for the bias corrections and its sqrt may differ by an ulp, which
    moves an element by about 1e-7 of its leaf's scale: tolerance 1e-6 of
    the largest element of each leaf."""
    cfg = graft._tiny_nerf_config()
    jmodel = JaxNerfNetwork.from_config(cfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    jopt = jax_opt.Optimizer(jax_opt.OptimizerSpec.from_config(_optimizer_config()),
                             matrix_mask=jmodel.matrix_mask(params))
    jstate = jopt.init(params)
    model = NerfNetwork.from_config(cfg)
    params_from_jax(model, jax.tree.map(np.asarray, params))
    opt = Optimizer(OptimizerSpec.from_config(_optimizer_config()), model.matrix_mask())
    state = opt.init(model.param_list())
    rng = np.random.default_rng(1)
    for step in range(6):
        assert opt.learning_rate_at(step) == pytest.approx(float(jopt.learning_rate_at(step)),
                                                           rel=1e-7)
        grads = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32)
                             * 10.0 ** rng.integers(-6, 0), params)
        params, jstate = jopt.update(jax.tree.map(jnp.asarray, grads), jstate, params)
        opt.update([torch.from_numpy(g) for g in flat_from_tree(model, grads)], state,
                   model.param_list())
        for key, ref_tree in (("params", params), ("m", jstate["m"]), ("v", jstate["v"]),
                              ("ema", jstate["ema"])):
            ours = model.param_list() if key == "params" else state[key]
            for a, b in zip(ours, flat_from_tree(model, jax.tree.map(np.asarray, ref_tree))):
                np.testing.assert_allclose(a.detach().numpy(), b, rtol=0,
                                           atol=1e-6 * float(np.abs(b).max()))
    assert state["step"] == int(jstate["step"]) == 6


@pytest.mark.parametrize("capacity", [64, 250, 10_000])
def test_compaction_maps_and_gathers_equal_jax(capacity):
    """Maps exact, including the overflow drop; gathers and their gradients
    exact (pure data movement)."""
    rng = np.random.default_rng(2)
    R, K = 40, 12
    n_valid = rng.integers(0, K + 1, R).astype(np.int32)
    ref = jax_cmp.prefix_compaction_maps(jnp.asarray(n_valid), K, capacity)
    maps = port_cmp.prefix_compaction_maps(torch.from_numpy(n_valid), K, capacity)
    for a, b in zip(maps, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    x = rng.standard_normal((R * K, 3)).astype(np.float32)
    gy = rng.standard_normal((capacity, 3)).astype(np.float32)
    y_ref, vjp = jax.vjp(lambda v: jax_cmp.compact_gather(v, *ref[:3]), jnp.asarray(x))
    live = np.arange(capacity) < int(ref.n_valid)
    # the slots past n_valid take no cotangent on the training path (the
    # expand gather's adjoint gives them 0); JAX's adjoint ignores them
    gy = np.where(live[:, None], gy, 0.0).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = port_cmp.compact_gather(xt, maps)
    y.backward(torch.from_numpy(gy))
    np.testing.assert_array_equal(y.detach().numpy()[live], np.asarray(y_ref)[live])
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(vjp(jnp.asarray(gy))[0]))
    yv = rng.standard_normal((capacity, 4)).astype(np.float32)
    g_out = rng.standard_normal((R * K, 4)).astype(np.float32)
    e_ref, e_vjp = jax.vjp(lambda v: jax_cmp.expand_gather(v, *ref), jnp.asarray(yv))
    yt = torch.from_numpy(yv).requires_grad_(True)
    e = port_cmp.expand_gather(yt, maps)
    e.backward(torch.from_numpy(g_out))
    np.testing.assert_array_equal(e.detach().numpy(), np.asarray(e_ref))
    np.testing.assert_array_equal(yt.grad.numpy(), np.asarray(e_vjp(jnp.asarray(g_out))[0]))


def _jax_grid_draws(key, n_casc, full):
    """The random draws of the JAX package's update_grid for this key
    (occupancy.py:202-263), as the port's GridDraws."""
    G, chunk = jax_occ.G, 1 << 18
    n_cells = G**3
    k1, k2, k3 = jax.random.split(key, 3)
    out = {}
    if full:
        n = n_casc * n_cells
    else:
        n_uniform = n_cells // 8 * n_casc
        k1a, k1b = jax.random.split(k1)
        k2a, k2b = jax.random.split(k2)
        out = dict(u_idx=jax.random.randint(k1a, (n_uniform,), 0, n_cells, jnp.int32),
                   u_mip=jax.random.randint(k1b, (n_uniform,), 0, n_casc, jnp.int32),
                   o_mip=jax.random.randint(k2a, (n_uniform,), 0, n_casc, jnp.int32),
                   cand=jax.random.randint(k2b, (n_uniform, 4), 0, n_cells, jnp.int32))
        n = 2 * n_uniform
    n_pad = (n + chunk - 1) // chunk * chunk
    keys = jax.random.split(k3, n_pad // chunk)
    jitter = np.concatenate([np.asarray(jax.random.uniform(k, (3, chunk))) for k in keys], 1)
    out = {k: torch.from_numpy(np.asarray(v).astype(np.int64)) for k, v in out.items()}
    return port_occ.GridDraws(jitter=torch.from_numpy(jitter[:, :n]), **out)


@pytest.mark.parametrize("full", [True, False])
def test_update_grid_equals_jax_with_injected_draws(full):
    """Same cells, jitter and density field (max/sub/mul only, so both sides
    compute it exactly); the exp of the density activation may differ by an
    ulp: density rtol 1e-6, skip chain exact. The mean is an f32 sum of 2M
    cells taken in another order: rtol 1e-4."""
    n_casc = 2
    rng = np.random.default_rng(3)
    prev = rng.random((n_casc, 128, 128, 128), dtype=np.float32) * 0.02
    prev[:, :10] = -1.0  # culled cells stay culled
    state = dataclasses.replace(jax_occ.init_grid(n_casc), density=jnp.asarray(prev))
    key = jax.random.PRNGKey(7)

    def field(p, maximum):
        return (maximum(maximum(p[:, 0], p[:, 1]), p[:, 2]) - 0.6) * 30.0

    ref = jax_occ.update_grid(state, lambda p: field(p, jnp.maximum), key, 0, decay=0.95,
                              density_activation=JaxActivation.EXPONENTIAL, full=full)
    grid = port_occ.OccupancyGrid(n_casc, "cpu")
    grid.set_density(torch.from_numpy(prev), 0.0, 0)
    port_occ.update_grid(grid, lambda p: field(p, torch.maximum), _jax_grid_draws(key, n_casc, full),
                         0.95, NerfActivation.EXPONENTIAL, full)
    np.testing.assert_allclose(grid.density.numpy(), np.asarray(ref.density), rtol=1e-6, atol=0)
    assert float(grid.mean_density) == pytest.approx(float(ref.mean_density), rel=1e-4)
    np.testing.assert_array_equal(grid.skipmip.numpy(), np.asarray(ref.skipmip))
    assert grid.ema_step == int(ref.ema_step) == 1


def test_mark_untrained_cells_equals_jax():
    rng = np.random.default_rng(4)
    n = 3
    xforms = np.zeros((n, 3, 4), np.float32)
    for i in range(n):
        q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
        xforms[i, :, :3] = q
        xforms[i, :, 3] = 0.5 - 1.2 * q[:, 2]  # looking at the center
    focals = rng.uniform(20, 40, (n, 2)).astype(np.float32)
    pps = rng.uniform(0.4, 0.6, (n, 2)).astype(np.float32)
    ref = np.asarray(jax_occ.mark_untrained_cells(1, (32, 24), focals, xforms, pps))
    out = port_occ.mark_untrained_cells(1, (32, 24), focals, xforms, pps, "cpu").numpy()
    assert 0.05 < np.mean(ref == 0.0) < 0.99
    np.testing.assert_array_equal(out, ref)


def test_train_state_round_trip():
    """A JAX training state through train_state_from_jax and back is the
    same numbers; parameters keep their packing order."""
    from instant_ngp_torch.nerf.task import NerfTask

    cfg = graft._tiny_nerf_config()
    cfg["optimizer"] = _optimizer_config()
    ds = graft._synthetic_dataset()
    task = NerfTask(_port_dataset(ds), cfg, "cpu", n_rays_per_batch=64)
    assert task.state.opt_state is None  # made at the first step
    task.optimizer_state()
    rng = np.random.default_rng(5)
    ref = train_state_to_numpy(task.model, task.state)
    ref = jax.tree.map(lambda a: (rng.random(np.shape(a)) * 4 - 2).astype(np.float32)
                       if np.ndim(a) else a, ref)
    ref["grid"]["mean_density"] = np.float32(0.004)
    ref["opt_state"]["step"] = np.int32(17)
    train_state_from_jax(task.model, task.state, ref)
    back = train_state_to_numpy(task.model, task.state)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert [k for k in params_to_numpy(task.model)] == ["density_net", "rgb_net", "pos_enc"]
    # rendering and grid updates read the EMA
    ema = task.state.opt_state["ema"]
    inference = task.inference_params()
    assert list(inference) == [name for name, _ in task.model.named_parameters()
                               if name != "pos_encoding.table"] + ["pos_encoding.table"]
    assert all(a is b for a, b in zip(inference.values(), ema))


@torch.no_grad()
def test_render_and_grid_updates_read_the_ema():
    """With an EMA apart from the live parameters, the render window and the
    grid update's density are the model's on the EMA: equal to a twin
    model that holds the EMA as its parameters."""
    from instant_ngp_torch.nerf.task import NerfTask

    cfg = graft._tiny_nerf_config()
    cfg["optimizer"] = _optimizer_config()
    pds = _port_dataset(graft._synthetic_dataset())
    task = NerfTask(pds, cfg, "cpu", n_rays_per_batch=64)
    twin = NerfTask(pds, cfg, "cpu", n_rays_per_batch=64)
    gen = torch.Generator().manual_seed(3)
    for e, p in zip(task.optimizer_state()["ema"], twin.model.param_list()):
        e.add_(torch.randn(e.shape, generator=gen) * 0.1 * (e.abs().max() + 1e-3))
        p.copy_(e)
    pos = torch.rand((500, 3), generator=gen)
    assert torch.equal(task.inference_density(pos), twin.model.density(pos))
    assert not torch.equal(task.inference_density(pos), task.model.density(pos))
    o = torch.rand((50, 3), generator=gen)
    d = torch.nn.functional.normalize(torch.randn((50, 3), generator=gen), dim=-1)
    ts = torch.rand((50, 8), generator=gen)
    valid = torch.rand((50, 8), generator=gen) < 0.7
    assert torch.equal(task._eval_window(o, d, ts, valid), twin._eval_window(o, d, ts, valid))


def _port_dataset(ds):
    from instant_ngp_torch.io.nerf_loader import NerfDataset

    return NerfDataset(images=ds.images, is_hdr=ds.is_hdr, xforms_start=ds.xforms_start,
                       xforms_end=ds.xforms_end, focal_lengths=ds.focal_lengths,
                       principal_points=ds.principal_points, rolling_shutter=ds.rolling_shutter,
                       resolution=ds.resolution, aabb_scale=ds.aabb_scale)
