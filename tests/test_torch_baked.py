"""The baked render (``instant_ngp_torch/nerf/baked.py`` and its NerfTask
paths) against the JAX package on the CPU, on the tiny snapshot at 16²:
kernel N's plain version on a cache carried across from a JAX bake (within
1e-6), the bake's host plan (index, offsets, resolutions and row count bit
for bit, for the snapshot's grid, a dense grid whose resolutions degrade and
the row-cap backstop), the bake's table (within one bf16 step of the MLP's
outputs), the baked render and ``render_batch`` (exact and baked), the bake
cache's keys, and the activated composite's plain version (the baked
round's last step) against JAX's ``_composite_window(activated=True)``.
The bakes are at 32³: the snapshot's untrained grid is dense, and the JAX
package bakes through its whole model."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instant_ngp_tpu.nerf import baked as jax_baked
from instant_ngp_tpu.testbed import Testbed as JaxTestbed
from instant_ngp_torch import testbed as port_testbed
from instant_ngp_torch.common import EPS_T, NerfActivation
from instant_ngp_torch.nerf import baked as port_baked
from instant_ngp_torch.nerf import task as port_task

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
TINY = ROOT / "tests" / "fixtures" / "tiny_nerf.ingp"
RES = 16
BAKE_RES = 32
MIN_PSNR_DB = 45.0  # 100.2 dB measured for the frame and the batch
# the table's records: the density MLP's bf16 output through the same
# activations; the two packages round it at other places (one bf16 step of
# the largest value measured)
TABLE_TOL = 2.0 ** -7


@pytest.fixture(scope="module")
def testbeds():
    ours = port_testbed.Testbed("nerf", device="cpu")
    ours.load_snapshot(TINY)
    theirs = JaxTestbed("nerf")
    theirs.load_snapshot(str(TINY))
    for tb in (ours, theirs):
        tb.task.baked_res0 = BAKE_RES
    return ours, theirs


@pytest.fixture(scope="module")
def jax_cache(testbeds):
    return testbeds[1].task.bake(res0=BAKE_RES)


def _camera(tb, i=0):
    return np.asarray(tb.nerf_dataset.xforms_start[i], np.float32)


def _psnr(a, b):
    mse = float(np.mean((np.clip(a[..., :3], 0, 1) - np.clip(b[..., :3], 0, 1)) ** 2))
    return -10.0 * np.log10(max(mse, 1e-12))


def _carried(cache):
    return port_baked.cache_from_numpy(np.asarray(cache.index), np.asarray(cache.table),
                                       np.asarray(cache.offsets), np.asarray(cache.res),
                                       cache.n_cascades, cache.n_rows, "cpu")


def test_query_on_a_carried_cache_matches_jax(jax_cache):
    """Kernel N's plain version on the JAX bake, at positions in and around
    the cascade (cell corners, centres, outside the box): within 1e-6 (the
    corner sum's order: 1.2e-7 measured), zero where JAX gives zero."""
    cache = _carried(jax_cache)
    rng = np.random.default_rng(0)
    n = BAKE_RES
    corners = rng.integers(0, n, (512, 3)).astype(np.float32) / n
    centres = (rng.integers(0, n, (512, 3)).astype(np.float32) + 0.5) / n
    pos = np.concatenate([rng.uniform(-0.2, 1.2, (4096, 3)).astype(np.float32), corners,
                          centres])
    ref = np.asarray(jax_baked.query(jax_cache, jnp.asarray(pos)))
    got = port_baked.query_plain(cache, torch.from_numpy(pos)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got == 0, ref == 0)
    assert (ref[:, 3] > 0).sum() > 1000 and (ref[:, 3] == 0).sum() > 100
    assert torch.equal(port_baked.query(cache, torch.from_numpy(pos)),
                       port_baked.query_plain(cache, torch.from_numpy(pos)))


def _blob_bitfield(n_cascades, radius):
    g = (np.arange(128) + 0.5) / 128
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    ball = (X - 0.5) ** 2 + (Y - 0.45) ** 2 + (Z - 0.55) ** 2 < radius ** 2
    return np.stack([ball] * n_cascades)


@pytest.mark.parametrize("case", ["snapshot", "dense_degrades", "backstop", "three_cascades"])
def test_bake_plan_matches_jax(testbeds, case):
    """The bake's host plan bit for bit: JAX's ``bake`` with a stub corner
    evaluator against ``plan_bake``/``bake`` — the snapshot's grid at 32³;
    a full grid whose resolutions degrade under a cap of 2^17 rows; a cap
    of 2^14 rows that even 32³ misses (the row backstop); three sparse
    cascades at 256³ and 128³."""
    ours, theirs = testbeds
    jax_bits = np.asarray(theirs.task.state.grid.bitfield)
    res0, max_rows_log2, n_c = BAKE_RES, 21, 1
    bits = jax_bits
    if case == "dense_degrades":
        bits, res0, max_rows_log2 = np.ones_like(jax_bits), 256, 17
    elif case == "backstop":
        bits, max_rows_log2 = np.ones_like(jax_bits), 14
    elif case == "three_cascades":
        bits, res0, max_rows_log2, n_c = _blob_bitfield(3, 0.12), 256, 22, 3

    def stub(params, bricks, cells, *rest):
        return jnp.zeros((cells.shape[0], 8, 4), jnp.float32)

    ref = jax_baked.bake(None, None, bits, n_c, theirs.task.aabb_min, theirs.task.aabb_max,
                         None, None, res0=res0, max_rows_log2=max_rows_log2, eval_fn=stub)
    res, cells, mips, index, offsets = port_baked.plan_bake(bits, n_c, res0, max_rows_log2)
    np.testing.assert_array_equal(index, np.asarray(ref.index))
    np.testing.assert_array_equal(offsets, np.asarray(ref.offsets))
    np.testing.assert_array_equal(res, np.asarray(ref.res))
    assert len(cells) == ref.n_rows
    if case == "dense_degrades":
        assert res[0] < 256
    if case == "backstop":
        assert ref.n_rows == 1 << 14 and res == [32]


def test_bake_equals_jax(testbeds, jax_cache):
    """``NerfTask.bake`` on the same parameters and grid: the index bit for
    bit, the table within one bf16 step of the MLP's output (the JAX
    package reads its brick cache, the port the hash tables)."""
    ours, _ = testbeds
    cache = ours.task.bake(res0=BAKE_RES)
    assert cache.n_rows == jax_cache.n_rows > 0
    np.testing.assert_array_equal(cache.index.numpy(), np.asarray(jax_cache.index))
    assert cache.res_host == tuple(np.asarray(jax_cache.res).tolist())
    ref = np.asarray(jax_cache.table).astype(np.float32)
    np.testing.assert_allclose(cache.table.float().numpy(), ref, rtol=TABLE_TOL, atol=TABLE_TOL)
    assert cache.table.dtype == torch.bfloat16 and cache.table.shape == (32768, 32)


def test_baked_render_matches_jax(testbeds):
    """The baked frame at 16² ≥ 45 dB of JAX's, alpha within 1e-4, and not
    the exact frame; through the Testbed too."""
    ours, theirs = testbeds
    xf = _camera(ours)
    frame = ours.task.render(RES, RES, xf, render_quality="baked").numpy()
    ref = np.asarray(theirs.task.render(RES, RES, xf, render_quality="baked"))
    assert frame.shape == ref.shape == (RES, RES, 4)
    assert _psnr(frame, ref) >= MIN_PSNR_DB
    np.testing.assert_allclose(frame[..., 3], ref[..., 3], rtol=0, atol=1e-4)
    exact = ours.task.render(RES, RES, xf).numpy()
    assert not np.array_equal(frame, exact)
    ours.render_quality = theirs.render_quality = "baked"
    try:
        for tb in (ours, theirs):
            tb.set_camera_to_training_view(0)
        assert _psnr(ours.render(RES, RES), np.asarray(theirs.render(RES, RES))) >= MIN_PSNR_DB
    finally:
        ours.render_quality = theirs.render_quality = "exact"


def test_bake_cache_keys(testbeds):
    """A bake is reused for the same step, resolution, origin (to 1e-4) and
    route, and made anew when one of them changes (test_baked.py:87)."""
    task = testbeds[0].task
    task._baked_cache = None
    c1 = task._get_baked(origin=np.zeros(3))
    assert task._get_baked(origin=np.full(3, 1e-5)) is c1
    c2 = task._get_baked(origin=np.ones(3))
    assert c2 is not c1
    task.training_step += 1
    try:
        assert task._get_baked(origin=np.ones(3)) is not c2
    finally:
        task.training_step -= 1
    c3 = task._get_baked(origin=np.ones(3))
    task.set_use_kernels(False)
    try:
        assert task._get_baked(origin=np.ones(3)) is not c3
    finally:
        task.set_use_kernels(True)


@pytest.mark.parametrize("quality", ["exact", "baked"])
def test_render_batch_matches_jax(testbeds, quality):
    """Three views through one pool, on a grey background: each ≥ 45 dB of
    JAX's ``render_batch`` and the batch's first view equal to the task's own
    render of it (exact: bit for bit)."""
    ours, theirs = testbeds
    cams = [_camera(ours, i % 2) for i in range(3)]
    bg = (0.5, 0.5, 0.5, 1.0)
    frames = ours.task.render_batch(RES, RES, cams, background=bg, render_quality=quality)
    ref = np.asarray(theirs.task.render_batch(RES, RES, cams, background=bg,
                                              render_quality=quality))
    assert tuple(frames.shape) == ref.shape == (3, RES, RES, 4)
    for v in range(3):
        assert _psnr(frames[v].numpy(), ref[v]) >= MIN_PSNR_DB
    if quality == "exact":
        fl = 0.5 * RES / np.tan(0.5 * np.radians(50.0))
        one = ours.task.render(RES, RES, cams[0], focal_length=(fl, fl), background=bg)
        assert torch.equal(frames[0], one)


def test_get_camera_extrinsics_equals_jax(testbeds):
    ours, theirs = testbeds
    for i in (0, 1, 99):
        np.testing.assert_array_equal(ours.task.get_camera_extrinsics(i),
                                      np.asarray(theirs.task.get_camera_extrinsics(i)))


def test_composite_activated_matches_jax(testbeds):
    """The activated composite's plain version (the baked round's last
    step) against JAX's ``_composite_window(activated=True)`` on random (R,
    16) windows of activated samples: within 1e-5 of each output's scale (XLA's cumsum and
    exp against the running sum in f32), the alive flags equal."""
    theirs = testbeds[1].task
    rng = np.random.default_rng(5)
    R, K = 512, 16
    f32 = np.float32
    out = np.concatenate([rng.random((R, K, 3)), rng.random((R, K, 1)) * 50], -1).astype(f32)
    t = rng.random(R).astype(f32)
    ts = (t[:, None] + np.cumsum(rng.random((R, K)) * 2e-3, 1)).astype(f32)
    args = [out, ts, (rng.random((R, K)) * 2e-3 + 1e-4).astype(f32), rng.random((R, K)) < 0.9,
            t, (t + 0.05).astype(f32), rng.random(R).astype(f32), rng.random((R, 3)).astype(f32),
            rng.random(R).astype(f32), np.ones(R, bool), np.full(R, 5.0, f32),
            np.zeros(R, f32)]
    ref = theirs._composite_window(*[jnp.asarray(a) for a in args], eps_t=EPS_T, activated=True)
    got = port_task.composite_window_plain(*[torch.from_numpy(np.asarray(a)) for a in args],
                                           EPS_T, NerfActivation.LOGISTIC,
                                           NerfActivation.EXPONENTIAL, activated=True)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        if r.dtype == bool:
            np.testing.assert_array_equal(g.numpy(), r)
        else:
            np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-5 * max(1.0, np.abs(r).max()))
    assert not np.allclose(got[2].numpy(), port_task.composite_window_plain(
        *[torch.from_numpy(np.asarray(a)) for a in args], EPS_T, NerfActivation.LOGISTIC,
        NerfActivation.EXPONENTIAL)[2].numpy())


@pytest.mark.parametrize("which", ["N", "D_activated", "round"])
def test_wrappers_do_not_fall_back_off_the_cpu(which):
    """A tensor that is neither on the CPU nor on the card raises; the
    activated composite has no kernel of its own off the CPU (the baked
    round does it)."""
    meta = torch.device("meta")
    cache = port_baked.BakedCache(
        torch.zeros(8, dtype=torch.int32, device=meta),
        torch.zeros((4, 32), dtype=torch.bfloat16, device=meta),
        torch.zeros(1, dtype=torch.int32, device=meta),
        torch.zeros(1, dtype=torch.int32, device=meta), 1, 4, (2,))
    with pytest.raises(ValueError, match="CUDA"):
        if which == "N":
            port_baked.query(cache, torch.zeros((8, 3), device=meta))
        elif which == "round":
            z = torch.zeros((4, 16), device=meta)
            r = torch.zeros(4, device=meta)
            r3 = torch.zeros((4, 3), device=meta)
            b = torch.zeros(4, dtype=torch.bool, device=meta)
            port_baked.render_round(cache, r3, r3, z, z, torch.zeros((4, 16), dtype=torch.bool,
                                                                     device=meta),
                                    r, r, r, r3, r, b, r, r, EPS_T)
        else:
            z = torch.zeros((4, 8), device=meta)
            r = torch.zeros(4, device=meta)
            port_task.composite_window(
                torch.zeros((4, 8, 4), device=meta), z, z,
                torch.zeros((4, 8), dtype=torch.bool, device=meta), r, r, r,
                torch.zeros((4, 3), device=meta), r, torch.zeros(4, dtype=torch.bool, device=meta),
                r, r, EPS_T, NerfActivation.LOGISTIC, NerfActivation.EXPONENTIAL, activated=True)
