"""Ray-march math, occupancy read side and ``march_rays`` (plain version of
kernel C) of the PyTorch port against the JAX package, on the CPU."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instant_ngp_tpu.nerf import occupancy as jax_occ
from instant_ngp_tpu.nerf import sampler as jax_sampler
from instant_ngp_tpu.ops import raymarch as jax_rm
from instant_ngp_torch import snapshot as port_snapshot
from instant_ngp_torch.nerf import occupancy as port_occ
from instant_ngp_torch.nerf import sampler as port_sampler
from instant_ngp_torch.ops import raymarch as port_rm
from instant_ngp_torch import testbed as port_testbed

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = {"tiny": ROOT / "tests" / "fixtures" / "tiny_nerf.ingp",
            "fox": ROOT / "data" / "fox_1536.ingp"}
N = 10_000


def _rays(rng, n=N):
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d[: n // 20, rng.integers(0, 3)] = 0.0  # axis-parallel components
    d /= np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-12)
    return d.astype(np.float32)


@pytest.mark.parametrize("cone_angle", [0.0, 1.0 / 256.0])
def test_raymarch_helpers_equal_jax(cone_angle):
    """Against the jitted JAX helpers, i.e. the arithmetic the reference's
    render path runs (fused multiply-adds, reciprocal multiplies)."""
    rng = np.random.default_rng(21)
    t = rng.uniform(0.1, 60.0, N).astype(np.float32)  # scene distances
    n = (np.asarray(jax.jit(lambda v: jax_rm.to_stepping_space(v, cone_angle))(
        rng.uniform(0.1, 60.0, N).astype(np.float32)))
        + rng.uniform(-0.5, 0.5, N)).astype(np.float32)
    pos = rng.uniform(-2.0, 3.0, (N, 3)).astype(np.float32)
    d = _rays(rng)
    idir = (1.0 / np.where(np.abs(d) < 1e-12, np.where(d >= 0, 1e-12, -1e-12), d)).astype(np.float32)
    mip = rng.integers(0, 8, N).astype(np.int32)
    res = (128.0 * np.exp2(-mip.astype(np.float32))).astype(np.float32)
    lo, hi = np.full(3, -1.5, np.float32), np.full(3, 2.5, np.float32)
    ca = cone_angle
    # name: (JAX helper, port helper, array arguments); the arrays go in as
    # jit arguments, so XLA compiles the arithmetic instead of folding it
    cases = {
        "to_stepping_space": (lambda v: jax_rm.to_stepping_space(v, ca),
                              lambda v: port_rm.to_stepping_space(v, ca), (t,)),
        "from_stepping_space": (lambda v: jax_rm.from_stepping_space(v, ca),
                                lambda v: port_rm.from_stepping_space(v, ca), (n,)),
        "advance_n_steps": (lambda v: jax_rm.advance_n_steps(v, ca, 0.5),
                            lambda v: port_rm.advance_n_steps(v, ca, 0.5), (t,)),
        "distance_to_next_voxel": (jax_rm.distance_to_next_voxel, port_rm.distance_to_next_voxel,
                                   (pos, d, idir, res)),
        "advance_to_next_voxel": (lambda *a: jax_rm.advance_to_next_voxel(a[0], ca, *a[1:]),
                                  lambda *a: port_rm.advance_to_next_voxel(a[0], ca, *a[1:]),
                                  (t, pos, d, idir, mip)),
        "mip_from_pos": (lambda p: jax_rm.mip_from_pos(p, 7), lambda p: port_rm.mip_from_pos(p, 7),
                         (pos,)),
        "mip_from_dt": (lambda v, p: jax_rm.mip_from_dt(jax_rm.calc_dt(v, ca) * 40.0, p, 7),
                        lambda v, p: port_rm.mip_from_dt(port_rm.calc_dt(v, ca) * 40.0, p, 7),
                        (t, pos)),
        "ray_intersect_aabb": (lambda p, v: jax_rm.ray_intersect_aabb(p, v, lo, hi),
                               lambda p, v: port_rm.ray_intersect_aabb(p, v, torch.from_numpy(lo),
                                                                       torch.from_numpy(hi)),
                               (pos, d)),
    }
    for name, (theirs, ours, args) in cases.items():
        refs = jax.jit(theirs)(*args)
        outs = ours(*(torch.from_numpy(a) for a in args))
        if name != "ray_intersect_aabb":
            refs, outs = (refs,), (outs,)
        for ref, out in zip(refs, outs):
            np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=0, err_msg=name)
    # dt is a difference of two nearly equal distances: hold it to 1e-6 of t
    ref = np.asarray(jax.jit(lambda v: jax_rm.calc_dt(v, ca))(t))
    err = np.abs(port_rm.calc_dt(torch.from_numpy(t), ca).numpy() - ref)
    assert (err <= 1e-6 * t).all(), err.max()


def _density(name):
    snap = port_snapshot.load_snapshot_file(FIXTURES[name])["snapshot"]
    return port_snapshot.restore_density_grid(snap, {"tiny": 1, "fox": 3}[name])


def test_bitfield_and_skip_chain_equal_jax_on_tiny_grid():
    density = _density("tiny")
    mean = np.float32(np.mean(np.maximum(density[0], 0.0)))
    bits = np.asarray(jax_occ._bitfield_from_density(jnp.asarray(density), mean))
    ours = port_occ._bitfield_from_density(torch.from_numpy(density), torch.tensor(mean))
    np.testing.assert_array_equal(ours.numpy(), bits)
    np.testing.assert_array_equal(port_occ._skip_chain(ours).numpy(),
                                  np.asarray(jax_occ._skip_chain(jnp.asarray(bits))))
    # pooling and chains are exercised: some cells are occupied, some skip far
    assert bits[0].any() and bits[1].any() and np.asarray(jax_occ._skip_chain(bits)).max() >= 2


def test_bitfield_and_skip_chain_equal_jax_on_multi_cascade_grid():
    rng = np.random.default_rng(4)
    density = (rng.random((3, 128, 128, 128), dtype=np.float32) ** 8).astype(np.float32)
    bits = np.asarray(jax_occ._bitfield_from_density(jnp.asarray(density), np.float32(0.2)))
    ours = port_occ._bitfield_from_density(torch.from_numpy(density), torch.tensor(0.2))
    np.testing.assert_array_equal(ours.numpy(), bits)
    np.testing.assert_array_equal(port_occ._skip_chain(ours).numpy(),
                                  np.asarray(jax_occ._skip_chain(jnp.asarray(bits))))


_TESTBEDS = {}


def _testbed(name):
    if name not in _TESTBEDS:
        tb = port_testbed.Testbed("nerf", device="cpu")
        tb.load_snapshot(FIXTURES[name])
        _TESTBEDS[name] = tb
    return _TESTBEDS[name]


@pytest.mark.parametrize("start", ["jitter", "t_init"])
@pytest.mark.parametrize("name", ["tiny", "fox"])  # cone 0 and cone 1/256
def test_march_rays_equals_jax(name, start):
    """The render window (K = 8, 64 iterations) against the jitted JAX
    march_rays."""
    tb = _testbed(name)
    task = tb.task
    ds = tb.nerf_dataset
    res = 16  # 256 rays of view 0
    w, h = ds.resolution
    ys, xs = np.meshgrid(np.arange(res), np.arange(res), indexing="ij")
    uv = np.stack([(xs.reshape(-1) + 0.5) / res, (ys.reshape(-1) + 0.5) / res], -1).astype(np.float32)
    fl = task._t([ds.focal_lengths[0, 0] * res / w, ds.focal_lengths[0, 1] * res / h])
    o, d, tmin, _ = task._prep_rays(torch.from_numpy(uv), task._t([res, res]), fl,
                                    task._t(ds.principal_points[0]), task._t(ds.xforms_start[0]))
    K, iters = task.render_samples_per_window, task.render_march_iters
    kw = dict(n_march_iters=iters, max_samples_per_ray=K, cone_angle=task.cone_angle,
              max_mip=task.max_cascade)
    jitter = np.random.default_rng(8).random(o.shape[0], dtype=np.float32)
    t_init = tmin.numpy() if start == "t_init" else None
    skip = task.skipmip.numpy()
    ref = jax.jit(lambda o_, d_, s_, j_, t_: jax_sampler.march_rays(
        o_, d_, s_, jnp.asarray(task.aabb_min), jnp.asarray(task.aabb_max), j_,
        jax_sampler.MarchConfig(**kw), t_init=t_))(o.numpy(), d.numpy(), skip, jitter, t_init)
    ours = port_sampler.march_rays(o, d, task.skipmip, *task._aabb_t, torch.from_numpy(jitter),
                                   port_sampler.MarchConfig(**kw),
                                   t_init=None if t_init is None else torch.from_numpy(t_init))
    ts, dts, valid, t_exit, n_valid = (np.asarray(a) for a in ref)
    p_ts, p_dts, p_valid, p_t_exit, p_n_valid = (a.numpy() for a in ours)
    same = n_valid == p_n_valid
    assert same.mean() >= 0.99
    assert n_valid.sum() > 0
    np.testing.assert_allclose(p_ts[same], ts[same], rtol=1e-5)
    # dt is a difference of two nearly equal distances: hold it to 1e-5 of t
    assert (np.abs(p_dts[same] - dts[same]) <= 1e-5 * ts[same]).all()
    np.testing.assert_allclose(p_t_exit[same], t_exit[same], rtol=1e-5)
    np.testing.assert_array_equal(p_valid[same], valid[same])
