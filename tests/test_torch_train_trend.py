"""Training trend on the CPU: the port and the JAX package each train the
tiny NeRF on a constant-colour scene for 40 steps from their own seeds
(their random streams differ), through a full grid update at steps 0, 16
and 32. Both losses fall and end within a stated factor of each other."""

import numpy as np
import torch

import __graft_entry__ as graft
from instant_ngp_tpu.nerf.task import NerfTask as JaxNerfTask
from instant_ngp_torch.io.nerf_loader import NerfDataset
from instant_ngp_torch import testbed as port_testbed
from instant_ngp_torch.nerf.task import NerfTask

torch.set_num_threads(2)

STEPS = 40
# every ray marches all 16 samples here, so the adaptive ray count is the
# 2^11 floor from the start: the JAX package, which adapts only within one
# train() call, and the port, which adapts across calls, run one schedule
KW = dict(n_rays_per_batch=1 << 11, max_samples_per_ray=16, n_march_iters=48,
          target_batch_size=1 << 16)
# measured (CPU): the mean loss of the last 8 steps is 0.30 (JAX) and 0.39
# (port) of the first 8's, and the port ends 1.29x the JAX package's
MAX_FALL_RATIO = 0.85
MAX_FINAL_FACTOR = 1.5


def test_port_and_jax_losses_fall_together():
    ds = graft._synthetic_dataset()
    ds.images[...] = np.array([200, 80, 40, 255], np.uint8)
    cfg = graft._tiny_nerf_config()
    jt = JaxNerfTask(ds, cfg, **KW)
    jax_losses = np.array([jt.train(1) for _ in range(STEPS)])

    tb = port_testbed.Testbed("nerf", device="cpu")
    tb.network_config = cfg
    tb.nerf_dataset = NerfDataset(
        images=ds.images, is_hdr=False, xforms_start=ds.xforms_start, xforms_end=ds.xforms_end,
        focal_lengths=ds.focal_lengths, principal_points=ds.principal_points,
        rolling_shutter=ds.rolling_shutter, resolution=ds.resolution, aabb_scale=ds.aabb_scale)
    tb.task = NerfTask(tb.nerf_dataset, cfg, "cpu", **KW)
    for _ in range(STEPS):
        tb.frame()
    port_losses = np.array(tb.loss_graph)
    assert tb.training_step == STEPS and np.isfinite(port_losses).all()
    assert tb.task.n_rays_current == jt._n_rays_current == KW["n_rays_per_batch"]
    print(f"last 8 / first 8: JAX {jax_losses[-8:].mean() / jax_losses[:8].mean():.3f}, port "
          f"{port_losses[-8:].mean() / port_losses[:8].mean():.3f}; port / JAX "
          f"{port_losses[-8:].mean() / jax_losses[-8:].mean():.3f}")
    assert 0.0 < tb.loss < port_losses[0]

    for losses in (jax_losses, port_losses):
        assert losses[-8:].mean() <= MAX_FALL_RATIO * losses[:8].mean()
    ratio = port_losses[-8:].mean() / jax_losses[-8:].mean()
    assert 1.0 / MAX_FINAL_FACTOR <= ratio <= MAX_FINAL_FACTOR
