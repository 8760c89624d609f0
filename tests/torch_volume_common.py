"""What the volume tests of the PyTorch port share: a tiny config, task pairs
with the JAX parameters carried across, and the JAX package's own draws,
rebuilt from its key schedules (the JAX functions draw inside themselves).

  * ``_generate_batch``: ``k_spawn0, k_scan = split(key)``; a spawn splits
    its key in two (a normal, then a uniform); ``split(k_scan, 192)``, and
    each iteration ``ka, kb, kc, kd, kj = split(kk, 5)``: zeta1 from ka, the
    jitter from kj, zeta2 from kb, the scatter normal from kc, a spawn from kd
  * ``_render_rays``: ``krng, k1 = split(krng)`` an iteration, a uniform in
    [1e-7, 1) from k1
  * ``_render_rays_gt``: ``krng, k1, k2, k3 = split(krng, 4)`` an iteration:
    u in [1e-7, 1), zeta2, a normal (R, 3)
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from instant_ngp_tpu.volume.task import VolumeTask as JaxVolumeTask
from instant_ngp_torch.models.network import params_from_jax
from instant_ngp_torch.volume.task import VolumeTask
from instant_ngp_torch.volume.tracking import BatchDraws

OPT = {"otype": "Adam", "learning_rate": 1e-2, "beta1": 0.9, "beta2": 0.99, "epsilon": 1e-15,
       "l2_reg": 1e-6}


def tiny_config(levels=4, log2=12, neurons=16, hidden=1):
    """tests/test_tasks.py's tiny config (L2 loss)."""
    return {"loss": {"otype": "L2"}, "optimizer": OPT,
            "encoding": {"otype": "HashGrid", "n_levels": levels, "n_features_per_level": 2,
                         "log2_hashmap_size": log2, "base_resolution": 4},
            "network": {"otype": "FullyFusedMLP", "activation": "ReLU",
                        "output_activation": "None", "n_neurons": neurons,
                        "n_hidden_layers": hidden}}


def task_pair(grid, config=None, **kw):
    """(JAX task, port task on the CPU) on one grid, the port holding the
    JAX package's initial parameters."""
    config = tiny_config() if config is None else config
    theirs = JaxVolumeTask(grid, config, **kw)
    ours = VolumeTask(grid, config, device="cpu", **kw)
    params_from_jax(ours.model, jax.tree.map(np.asarray, theirs.params))
    return theirs, ours


def _spawn_draws(k, n):
    k1, k2 = jax.random.split(k)
    return jax.random.normal(k1, (n, 3)), jax.random.uniform(k2, (n, 3))


def jax_batch_draws(key, n_paths: int, n_iters: int = 192) -> BatchDraws:
    """The draws ``_generate_batch(key)`` makes, as the port's BatchDraws."""
    def per_iter(kk):
        ka, kb, kc, kd, kj = jax.random.split(kk, 5)
        zeta1 = jax.random.uniform(ka, (n_paths,))
        jitter = jax.random.uniform(kj, (n_paths, 3))
        zeta2 = jax.random.uniform(kb, (n_paths,))
        scatter = jax.random.normal(kc, (n_paths, 3))
        normal, uniform = _spawn_draws(kd, n_paths)
        return jnp.concatenate([zeta1[None], jitter.T, zeta2[None], scatter.T, normal.T,
                                uniform.T])

    @jax.jit
    def draws(key):
        k_spawn0, k_scan = jax.random.split(key)
        normal, uniform = _spawn_draws(k_spawn0, n_paths)
        return (jnp.concatenate([normal.T, uniform.T]),
                jax.vmap(per_iter)(jax.random.split(k_scan, n_iters)))

    first, it = draws(key)
    return BatchDraws(torch.from_numpy(np.array(first)), torch.from_numpy(np.array(it)))


def jax_render_uniforms(key, n_rays: int, n_iters: int = 192) -> torch.Tensor:
    """The uniforms ``_render_rays(…, key)`` draws: (n_iters, R)."""
    def body(krng, _):
        krng, k1 = jax.random.split(krng)
        return krng, jax.random.uniform(k1, (n_rays,), minval=1e-7, maxval=1.0)

    _, u = jax.jit(lambda k: jax.lax.scan(body, k, None, length=n_iters))(key)
    return torch.from_numpy(np.array(u))


def jax_gt_draws(key, n_rays: int, n_iters: int = 256) -> torch.Tensor:
    """The draws ``_render_rays_gt(…, key)`` makes: (n_iters, 5, R) as the
    port's ``trace_gt`` takes them."""
    def body(krng, _):
        krng, k1, k2, k3 = jax.random.split(krng, 4)
        u = jax.random.uniform(k1, (n_rays,), minval=1e-7, maxval=1.0)
        z2 = jax.random.uniform(k2, (n_rays,))
        rnd = jax.random.normal(k3, (n_rays, 3))
        return krng, jnp.concatenate([u[None], z2[None], rnd.T])

    _, draws = jax.jit(lambda k: jax.lax.scan(body, k, None, length=n_iters))(key)
    return torch.from_numpy(np.array(draws))


def path_agreement(out, ref, rtol: float, atol: float) -> np.ndarray:
    """(n_paths,) bool: paths whose 4 vertices have the same valid flags
    and, where valid, positions and targets within rtol/atol of the
    reference's. out, ref: (pts, tgt, valid) numpy arrays."""
    pts, tgt, valid = (np.asarray(a) for a in out)
    pts_r, tgt_r, valid_r = (np.asarray(a) for a in ref)
    n = valid.shape[0] // 4
    close = (np.isclose(pts, pts_r, rtol=rtol, atol=atol).all(-1)
             & np.isclose(tgt, tgt_r, rtol=rtol, atol=atol).all(-1))
    return ((valid == valid_r) & (close | ~valid)).reshape(n, 4).all(-1)
