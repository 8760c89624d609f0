"""The training schedule across ``Testbed.frame()`` calls on the CPU.

A frame is one ``train(1)``. The JAX package keeps the last step's stats
only within one ``train()`` call, so under its frames the ray count never
adapts and the zero-sample abort never fires. The port keeps them on the
task: frames adapt and abort as one ``train(n)`` call does."""

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from instant_ngp_tpu.nerf.task import NerfTask as JaxNerfTask
from instant_ngp_torch import testbed as port_testbed
from instant_ngp_torch.io.nerf_loader import NerfDataset
from instant_ngp_torch.nerf.task import NerfTask

torch.set_num_threads(2)

# every ray marches all K samples of the constant-colour scene, so the
# grid update at step 16 raises the ray count to the 2^11 floor
KW = dict(n_rays_per_batch=256, max_samples_per_ray=16, n_march_iters=48,
          target_batch_size=1 << 12)
STEPS = 17  # through the grid update at step 16


def _dataset():
    ds = graft._synthetic_dataset()
    ds.images[...] = np.array([200, 80, 40, 255], np.uint8)
    return ds, NerfDataset(
        images=ds.images, is_hdr=False, xforms_start=ds.xforms_start, xforms_end=ds.xforms_end,
        focal_lengths=ds.focal_lengths, principal_points=ds.principal_points,
        rolling_shutter=ds.rolling_shutter, resolution=ds.resolution, aabb_scale=ds.aabb_scale)


def _testbed(pds, cfg):
    tb = port_testbed.Testbed("nerf", device="cpu")
    tb.network_config, tb.nerf_dataset = cfg, pds
    tb.task = NerfTask(pds, cfg, "cpu", **KW)
    return tb


def test_frames_adapt_the_ray_count_as_one_train_call():
    ds, pds = _dataset()
    cfg = graft._tiny_nerf_config()
    jt = JaxNerfTask(ds, cfg, **KW)
    for _ in range(STEPS):
        jt.train(1)
    assert jt._n_rays_current == KW["n_rays_per_batch"]  # the JAX package's frames never adapt

    tb = _testbed(pds, cfg)
    for _ in range(STEPS):
        tb.frame()
    one_call = NerfTask(pds, cfg, "cpu", **KW)
    loss = one_call.train(STEPS)
    assert tb.task.n_rays_current == one_call.n_rays_current == 1 << 11
    assert tb.loss_graph[-1] == pytest.approx(loss, rel=1e-6)


def test_frames_stop_training_when_no_sample_is_marched():
    _, pds = _dataset()
    tb = _testbed(pds, graft._tiny_nerf_config())
    task = tb.task
    # every cell culled: the march finds nothing, and updates keep it so
    task.set_density_grid(torch.full_like(task.state.grid.density, -1.0))
    with pytest.warns(UserWarning, match="generated 0 samples"):
        for _ in range(STEPS):
            tb.frame()
    assert task.training_aborted and not tb.shall_train
    assert task.training_step == 16 and len(tb.loss_graph) == STEPS
    tb.frame()
    assert task.training_step == 16 and len(tb.loss_graph) == STEPS
