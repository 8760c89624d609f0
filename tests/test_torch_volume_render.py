"""The volume primitive's renders and metric in the PyTorch port against the
JAX package on the CPU: the pinhole rays, the learned render and the
ground-truth render on the JAX package's own draws, and
``compute_density_mse`` on its positions (``test_torch_volume_testbed.py``
holds the Testbed surface and the snapshots).

Renders are held as shares of rays, since a ray, like a training path, is
chaotic (``test_torch_volume_batch.py``): an ulp in a free flight can move
an event across a bitgrid cell. The learned render's rgb also carries the
bf16 MLP's last bits (the port's plain MLP against XLA's): a ray agrees
within ``TOL_RGB`` (1e-2), and ``MIN_AGREE`` of the rays must. The ground
truth depends on no model: a ray agrees where its alpha is the same and its
rgb within 1e-5 relative."""

import jax
import numpy as np
import pytest
import torch

from instant_ngp_torch.io.nanovdb import procedural_fog_volume
from instant_ngp_torch.models.network import train_state_from_jax
from instant_ngp_torch.render.camera import pinhole_rays
from torch_volume_common import jax_gt_draws, jax_render_uniforms, task_pair

torch.set_num_threads(2)

TOL_RGB = 1e-2
MIN_AGREE = 0.98
CAM = np.array([[1, 0, 0, 0.5], [0, 1, 0, 0.5], [0, 0, 1, -1.2]], np.float32)


def jax_rays(width, height, cam, fov):
    """The rays of the JAX package's ``VolumeTask.render`` (task.py:417-425),
    rounded to f32 as it hands them to its jitted render."""
    fl = 0.5 * height / np.tan(0.5 * np.radians(fov))
    ys, xs = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    u = (xs + 0.5) / width - 0.5
    v = (ys + 0.5) / height - 0.5
    dirs = np.stack([u * width / fl, v * height / fl, np.ones_like(u)], -1)
    d = dirs @ cam[:, :3].T
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.broadcast_to(cam[:, 3], d.shape)
    return o.reshape(-1, 3).astype(np.float32), d.reshape(-1, 3).astype(np.float32)


@pytest.fixture(scope="module")
def trained():
    """A JAX task on procedural_fog_volume(64) after 40 steps, and the port
    holding its state."""
    theirs, ours = task_pair(procedural_fog_volume(64), batch_size=4096)
    theirs.train(40)
    ours.opt_state = train_state_from_jax(ours.model, ours.opt,
                                          jax.tree.map(np.asarray, theirs.params),
                                          jax.tree.map(np.asarray, theirs.opt_state))
    return theirs, ours


def test_pinhole_rays_are_the_jax_renders():
    for w, h, fov in ((16, 12, 50.0), (9, 16, 50.625)):
        o_ref, d_ref = jax_rays(w, h, CAM, fov)
        o, d = pinhole_rays(w, h, CAM, fov, "cpu")
        np.testing.assert_array_equal(o.numpy(), o_ref)
        np.testing.assert_array_equal(d.to(torch.float32).numpy(), d_ref)


@pytest.mark.parametrize("wh,seed", [((16, 16), 21), ((12, 8), 22)])
def test_learned_render_equals_jax_on_its_draws(trained, wh, seed):
    theirs, ours = trained
    o, d = jax_rays(*wh, CAM, 50.0)
    key = jax.random.PRNGKey(seed)
    rgb_ref, a_ref = (np.asarray(x) for x in jax.jit(theirs._render_rays)(
        theirs.inference_params, o, d, key))
    rgb, a = ours.render_rays(ours.inference_params(), torch.from_numpy(o), torch.from_numpy(d),
                              uniforms=jax_render_uniforms(key, o.shape[0]))
    rgb, a = rgb.numpy(), a.numpy()
    assert 0.02 < float(a_ref.mean()) < 0.98, float(a_ref.mean())
    agree = (np.abs(rgb - rgb_ref).max(-1) <= TOL_RGB) & (np.abs(a - a_ref) <= TOL_RGB)
    assert agree.mean() >= MIN_AGREE, agree.mean()
    mse = float(np.mean((np.clip(rgb, 0, 1) - np.clip(rgb_ref, 0, 1)) ** 2))
    assert -10 * np.log10(max(mse, 1e-12)) >= 40.0, mse


@pytest.mark.parametrize("wh,seed", [((16, 16), 31), ((8, 8), 32)])
def test_ground_truth_render_equals_jax_on_its_draws(trained, wh, seed):
    theirs, ours = trained
    o, d = jax_rays(*wh, CAM, 50.0)
    key = jax.random.PRNGKey(seed)
    rgb_ref, a_ref = (np.asarray(x) for x in jax.jit(theirs._render_rays_gt)(
        o, d, theirs.density_grid, key))
    draws = jax_gt_draws(key, o.shape[0])
    assert tuple(draws.shape) == (256, 5, o.shape[0])
    rgb, a = (x.numpy() for x in ours.render_rays_gt(torch.from_numpy(o), torch.from_numpy(d),
                                                     draws))
    assert set(np.unique(a)) <= {0.0, 1.0} and 0 < a_ref.mean() < 1
    agree = (a == a_ref) & np.isclose(rgb, rgb_ref, rtol=1e-5, atol=1e-6).all(-1)
    assert agree.mean() >= MIN_AGREE, agree.mean()


def test_compute_density_mse_equals_jax_on_its_positions(trained):
    theirs, ours = trained
    n = 1 << 14
    pos = (jax.random.uniform(jax.random.PRNGKey(99), (n, 3))
           * jax.numpy.asarray(theirs.aabb_max - theirs.aabb_min)
           + jax.numpy.asarray(theirs.aabb_min))
    ref = theirs.compute_density_mse(n)
    got = ours.compute_density_mse(positions=np.array(pos))
    assert ref > 0
    np.testing.assert_allclose(got, ref, rtol=1e-3)
    own = ours.compute_density_mse(n)  # the port's own positions (seed 99)
    np.testing.assert_allclose(own, ref, rtol=0.1)
