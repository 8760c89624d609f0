"""Kernels C (ray march) and H (row scatter-add) as the training path runs
them, on the CPU: the plain march at the training march's configuration
against the jitted JAX ``march_rays`` on the fox snapshot's grid with its
iteration statistics, the accumulating scatter
``scatter_add_rows_`` against JAX's ``.at[idx].add`` and the error-map
deposit through it, and the bit identities kernel C's arithmetic rests on.
Neither wrapper falls back to its plain version off the CPU."""

import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instant_ngp_tpu.nerf import sampler as jax_sampler
from instant_ngp_torch import testbed as port_testbed
from instant_ngp_torch.nerf import sampler as port_sampler
from instant_ngp_torch.nerf import train as port_train
from instant_ngp_torch.ops.scatter import scatter_add_rows, scatter_add_rows_

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
FOX = ROOT / "data" / "fox_1536.ingp"
# chip_smoke.py's training march: K 32, 192 iterations, random jitter
N_RAYS, TRAIN_K, TRAIN_ITERS = 1024, 32, 192


@pytest.fixture(scope="module")
def fox():
    tb = port_testbed.Testbed("nerf", device="cpu")
    tb.load_snapshot(FOX)
    return tb.task


def test_training_march_equals_jax_on_the_snapshot_grid(fox):
    """Rays of random pixels of fox's views from the jittered aabb entry,
    through the trained grid, against the jitted JAX march_rays. XLA's own
    log/exp may differ by an ulp and move a ray by a step: n_valid agrees on
    >= 0.99 of the rays, and ts there to rtol 1e-5."""
    rng = np.random.default_rng(11)
    task = fox
    img = torch.from_numpy(rng.integers(0, task.dataset.n_images, N_RAYS))
    uv = torch.from_numpy(rng.random((N_RAYS, 2), dtype=np.float32))
    o, d = port_train.generate_rays(task, img, uv)
    jitter = rng.random(N_RAYS, dtype=np.float32)
    kw = dict(n_march_iters=TRAIN_ITERS, max_samples_per_ray=TRAIN_K, cone_angle=task.cone_angle,
              max_mip=task.max_cascade)
    ref = jax.jit(lambda o_, d_, s_, j_: jax_sampler.march_rays(
        o_, d_, s_, jnp.asarray(task.aabb_min), jnp.asarray(task.aabb_max), j_,
        jax_sampler.MarchConfig(**kw)))(o.numpy(), d.numpy(), task.skipmip.numpy(), jitter)
    stats = {}
    ours = port_sampler.march_rays_plain(o, d, task.skipmip, *task._aabb_t,
                                         torch.from_numpy(jitter), port_sampler.MarchConfig(**kw),
                                         stats=stats)
    ts, dts, valid, t_exit, n_valid = (np.asarray(a) for a in ref)
    p_ts, p_dts, p_valid, p_t_exit, p_n_valid = (a.numpy() for a in ours)
    same = n_valid == p_n_valid
    assert same.mean() >= 0.99
    assert n_valid.mean() > TRAIN_K / 2  # the rays reach the scene and sample it
    np.testing.assert_allclose(p_ts[same], ts[same], rtol=1e-5)
    assert (np.abs(p_dts[same] - dts[same]) <= 1e-5 * ts[same]).all()
    np.testing.assert_array_equal(p_valid[same], valid[same])
    # the statistics count every iteration a ray ran: one emit per sample
    # plus the skips, and every read chain value
    iters = stats["iters"].numpy()
    assert (iters >= p_n_valid).all() and iters.max() <= TRAIN_ITERS
    assert int(stats["chain_counts"].sum()) == int(iters.sum())
    assert int(stats["chain_counts"][0]) == int(p_n_valid.sum())


@pytest.mark.parametrize("n_features", [1, 2, 4])
@pytest.mark.parametrize("index", ["int32", "int64"])
def test_accumulating_scatter_equals_jax_at_add(index, n_features):
    """scatter_add_rows_ adds into a non-zero map in place, as JAX's
    map.at[idx].add(vals, mode="drop") (rows past the end dropped); f32
    sums in another order: rtol 1e-6. The allocating form is the same into
    zeros. JAX wraps a negative index; the port drops it as out of range."""
    rng = np.random.default_rng(7)
    size, m = 1 << 10, 1 << 13
    idx = rng.integers(0, size + 3, m).astype(index)
    vals = rng.standard_normal((m, n_features)).astype(np.float32)
    base = rng.standard_normal((size, n_features)).astype(np.float32)
    ref = np.asarray(jnp.asarray(base).at[jnp.asarray(idx)].add(jnp.asarray(vals), mode="drop"))
    out = torch.from_numpy(base.copy())
    got = scatter_add_rows_(out, torch.from_numpy(idx), torch.from_numpy(vals))
    assert got is out
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-5)
    fresh = scatter_add_rows(torch.from_numpy(idx), torch.from_numpy(vals), size).numpy()
    np.testing.assert_allclose(fresh, ref - base, rtol=1e-6, atol=1e-5)
    neg = scatter_add_rows(torch.from_numpy(-1 - idx), torch.from_numpy(vals), size)
    assert not bool(neg.any())


def test_deposit_adds_straight_into_the_error_map():
    """deposit_error adds the step's bilinear deposit into the map's own
    storage, as the JAX step's error_map.reshape(-1).at[corners].add."""
    rng = np.random.default_rng(9)
    n_img, eh, ew, R = 3, 11, 13, 256
    emap = torch.from_numpy(rng.random((n_img, eh, ew), dtype=np.float32))
    task = types.SimpleNamespace(error_map_res=(eh, ew),
                                 error_map_wh=torch.tensor([ew, eh]).float(),
                                 state=types.SimpleNamespace(error_map=emap), use_kernels=True)
    img = torch.from_numpy(rng.integers(0, n_img, R))
    uv = torch.from_numpy(rng.random((R, 2), dtype=np.float32))
    per_ray = torch.from_numpy(rng.random(R, dtype=np.float32))
    pdf = torch.from_numpy(rng.random(R, dtype=np.float32) + 0.5)
    corners, vals = port_train.error_deposit(task, img, uv, per_ray, pdf)
    ref = np.asarray(jnp.asarray(emap.numpy()).reshape(-1).at[jnp.asarray(corners.numpy())].add(
        jnp.asarray(vals.numpy()[:, 0])))
    ptr = emap.data_ptr()
    port_train.deposit_error(task, img, uv, per_ray, pdf)
    assert task.state.error_map is emap and emap.data_ptr() == ptr
    np.testing.assert_allclose(emap.numpy().reshape(-1), ref, rtol=1e-6)


def test_kernel_c_bit_identities():
    """What kernel C computes from bits equals what the plain version
    computes with exp2, frexp and division: 2^-mip and 128·2^-mip from
    exponent bits, frexp's exponent of positive normal floats from their
    bits, and a division by the power-of-two resolution as a multiply by
    its inverse."""
    rng = np.random.default_rng(3)
    mips = np.arange(8)
    pow2 = lambda e: ((e + 127).astype(np.int32) << 23).view(np.float32)  # noqa: E731
    np.testing.assert_array_equal(pow2(-mips), np.exp2(-mips.astype(np.float32)))
    res = np.float32(128.0) * np.exp2(-mips.astype(np.float32))
    np.testing.assert_array_equal(pow2(7 - mips), res)
    x = np.concatenate([np.float32(1e-30) * rng.random(1000, dtype=np.float32) + np.float32(1e-30),
                        (10.0 ** rng.uniform(-30, 30, 10000)).astype(np.float32),
                        np.float32([1e-30, 0.5, 1.0, 2.0, 255.99998, 256.0])])
    np.testing.assert_array_equal((x.view(np.int32) >> 23) - 126, np.frexp(x)[1])
    t = np.concatenate([(rng.standard_normal(10000) * 10.0 ** rng.uniform(-20, 3, 10000)),
                        [np.inf, -np.inf, 0.0]]).astype(np.float32)
    for m in mips:
        r = np.float32(res[m])
        np.testing.assert_array_equal(t / r, t * pow2(np.array(m - 7)))


@pytest.mark.parametrize("which", ["C", "H", "H_in_place"])
def test_wrappers_do_not_fall_back_off_the_cpu(which):
    """A tensor that is neither on the CPU nor on the card raises: the
    wrappers run their plain versions for CPU tensors only."""
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="CUDA"):
        if which == "C":
            z3 = torch.zeros((8, 3), device=meta)
            port_sampler.march_rays(z3, z3, torch.zeros((8, 128, 128, 128), device=meta),
                                    torch.zeros(3, device=meta), torch.ones(3, device=meta),
                                    torch.zeros(8, device=meta), port_sampler.MarchConfig())
        elif which == "H":
            scatter_add_rows(torch.zeros(8, dtype=torch.int64, device=meta),
                             torch.zeros((8, 2), device=meta), 16)
        else:
            scatter_add_rows_(torch.zeros((16, 1), device=meta),
                              torch.zeros(8, dtype=torch.int32, device=meta),
                              torch.zeros((8, 1), device=meta))
