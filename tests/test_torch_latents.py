"""Per-image latents ("extra dims") on the port against the JAX package, on
the CPU: the NeRF model with E = 4 latent inputs to its rgb MLP (outputs
and the gradients to the latents, positions and directions), a 16² render
conditioned on a training view's latents and on an explicit vector, and a
snapshot holding latents and a distortion map saved by each package, loaded
by the other and trained a step from."""

import dataclasses
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from instant_ngp_tpu import testbed as jax_testbed
from instant_ngp_tpu.models.nerf_network import NerfNetwork as JaxNerfNetwork
from instant_ngp_tpu.nerf import occupancy as jax_occ
from instant_ngp_tpu.nerf.task import NerfTask as JaxNerfTask
from instant_ngp_torch import testbed as port_testbed
from instant_ngp_torch.io.nerf_loader import NerfDataset
from instant_ngp_torch.io.synthetic import generate_synthetic_dataset
from instant_ngp_torch.models.nerf_network import (NerfNetwork, params_from_jax,
                                                   train_state_from_jax)
from instant_ngp_torch.nerf.task import NerfTask

torch.set_num_threads(2)

E = 4


def _t(a):
    return torch.from_numpy(np.array(a))


def test_model_with_latents_equals_jax():
    """Outputs (rtol 1e-5 of the largest) and the gradients of a random
    cotangent to the latents, positions and directions (2e-2 of each
    leaf's largest: bf16 cotangents, sums in another order), the rgb MLP
    taking 16 + 16 + E inputs; no latents given means zeros, as in JAX."""
    cfg = graft._tiny_nerf_config()
    jm = JaxNerfNetwork.from_config(cfg, n_extra_dims=E)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(3)))
    pm = NerfNetwork.from_config(cfg, n_extra_dims=E, device="cpu")
    params_from_jax(pm, params)
    assert pm.rgb_network.weights[0].shape[0] == 32 + E
    rng = np.random.default_rng(0)
    n = 300
    pos = rng.random((n, 3), dtype=np.float32)
    dirs = rng.random((n, 3), dtype=np.float32)
    extra = rng.normal(size=(n, E)).astype(np.float32)
    g = rng.normal(size=(n, 4)).astype(np.float32)

    def f(p, d, e):
        return jm(params, p, d, extra=e)

    ref, vjp = jax.vjp(f, jnp.asarray(pos), jnp.asarray(dirs), jnp.asarray(extra))
    refs = vjp(jnp.asarray(g))
    p_t, d_t, e_t = (_t(a).requires_grad_(True) for a in (pos, dirs, extra))
    out = pm(p_t, d_t, extra=e_t)
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    grads = torch.autograd.grad(out, (p_t, d_t, e_t), _t(g))
    for got, want in zip(grads, refs):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-2 * np.abs(want).max())
    zero = np.asarray(jm(params, jnp.asarray(pos), jnp.asarray(dirs)))
    np.testing.assert_allclose(pm(_t(pos), _t(dirs)).detach().numpy(), zero, rtol=0,
                               atol=1e-5 * np.abs(zero).max())


def _render_tasks():
    """The JAX task and the port's on a 2-view synthetic scene with E = 4
    latents, random parameters and a grid of dense cells, one state."""
    ds = graft._synthetic_dataset()
    ds.n_extra_learnable_dims = E
    cfg = graft._tiny_nerf_config()
    jt = JaxNerfTask(ds, cfg, target_batch_size=1 << 12, n_rays_per_batch=256)
    rng = np.random.default_rng(1)
    dens = jnp.asarray(np.where(rng.random((1, 128, 128, 128)) < 0.3, 5.0, 0.0)
                       .astype(np.float32))
    mean = jnp.mean(dens[0])
    bits = jax_occ._bitfield_from_density(dens, mean)
    grid = jax_occ.OccupancyGridState(density=dens, bitfield=bits,
                                      skipmip=jax_occ._skip_chain(bits), mean_density=mean,
                                      ema_step=jnp.int32(1))
    params = jax.tree.map(lambda a: a * 40.0 if a.ndim == 2 and a.shape[0] > 64 else a,
                          jt.state.params)  # tables large enough to matter
    jt.state = dataclasses.replace(jt.state, grid=grid, params=params)
    pds = NerfDataset(images=ds.images, is_hdr=False, xforms_start=ds.xforms_start,
                      xforms_end=ds.xforms_end, focal_lengths=ds.focal_lengths,
                      principal_points=ds.principal_points, rolling_shutter=ds.rolling_shutter,
                      resolution=ds.resolution, aabb_scale=ds.aabb_scale,
                      n_extra_learnable_dims=E)
    pt = NerfTask(pds, cfg, "cpu", target_batch_size=1 << 12, n_rays_per_batch=256)
    train_state_from_jax(pt.model, pt.state, jt.state)
    return jt, pt


def test_render_conditioned_on_latents_equals_jax():
    """16² renders from view 0's camera, conditioned on training view 1's
    latents and on an explicit vector: each within 2e-3 of the JAX render
    (≥ 45 dB), and the latents change the frame."""
    jt, pt = _render_tasks()
    xf = np.asarray(jt.dataset.xforms_start[0])
    frames = {}
    for how in ("view1", "vector"):
        if how == "view1":
            jt.rendering_extra_dims_from_training_view = 1
            pt.rendering_extra_dims_from_training_view = 1
        else:
            vec = np.random.default_rng(4).normal(size=E).astype(np.float32) * 3.0
            jt.set_rendering_extra_dims(vec)
            pt.set_rendering_extra_dims(vec)
        ref = np.asarray(jt.render(16, 16, xf))
        ours = pt.render(16, 16, xf).numpy()
        np.testing.assert_allclose(ours, ref, rtol=0, atol=2e-3)
        mse = float(np.mean((ours[..., :3] - ref[..., :3]) ** 2))
        assert mse < 10 ** -4.5
        frames[how] = ours
    assert np.abs(frames["view1"] - frames["vector"]).max() > 1e-2


@pytest.fixture(scope="module")
def latent_scene(tmp_path_factory):
    scene, _ = generate_synthetic_dataset(tmp_path_factory.mktemp("scene") / "s", res=16,
                                          n_train=2, n_test=1, n_steps=32)
    out = tmp_path_factory.mktemp("latent") / "s"
    shutil.copytree(scene, out)
    meta = json.loads((out / "transforms.json").read_text())
    meta["n_extra_learnable_dims"] = E
    (out / "transforms.json").write_text(json.dumps(meta))
    return out


def _testbed(package, scene):
    tb = jax_testbed.Testbed() if package == "jax" else port_testbed.Testbed(device="cpu")
    tb.training_batch_size = 1 << 12
    tb.reload_network_from_json(graft._tiny_nerf_config())
    tb.nerf.training.optimize_distortion = True
    tb.nerf.training.optimize_extrinsics = True
    tb.load_training_data(str(scene))
    return tb


def _cam(tb) -> dict:
    task = tb.task
    if hasattr(task.state, "params"):
        return {k: np.asarray(v) for k, v in task.state.cam.items()}
    return task.cam_offsets_numpy()


def test_snapshot_with_latents_and_distortion_crosses_both_ways(latent_scene, tmp_path):
    """JAX trains a step with a distortion map and latents and saves; the
    port loads it onto the scene (every camera leaf bit for bit), trains a
    step (the map and the latents move) and saves; the JAX Testbed loads
    that (bit for bit) and trains a step."""
    theirs = _testbed("jax", latent_scene)
    theirs.frame()
    theirs.save_snapshot(str(tmp_path / "jax.ingp"))
    cam0 = _cam(theirs)
    assert set(cam0) == {"rot", "pos", "exposure", "focal", "extra", "distortion"}
    assert np.any(cam0["distortion"])  # trained by the step

    ours = _testbed("port", latent_scene)
    ours.load_snapshot(tmp_path / "jax.ingp")
    got = _cam(ours)
    assert sorted(got) == sorted(cam0)
    for k in cam0:
        np.testing.assert_array_equal(got[k], cam0[k], err_msg=k)
    ours.frame()
    assert np.isfinite(ours.loss)
    moved = _cam(ours)
    assert not np.array_equal(moved["distortion"], cam0["distortion"])
    assert not np.array_equal(moved["extra"], cam0["extra"])
    ours.save_snapshot(tmp_path / "port.ingp")

    again = _testbed("jax", latent_scene)
    again.load_snapshot(str(tmp_path / "port.ingp"))
    back = _cam(again)
    for k in moved:
        np.testing.assert_array_equal(back[k], moved[k], err_msg=k)
    again.frame()
    assert np.isfinite(again.loss)
