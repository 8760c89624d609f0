"""The baked round (``nerf.baked.render_round``: a baked render's positions,
lookups and activated composite after its march, one kernel on the card)
on the CPU, on the tiny snapshot's 32³ bake: its plain version against the
JAX package's ``_render_round_baked`` given the same march window; a numpy
model of the kernel's order (a lane a ray, passes of kPass samples staged in
shared memory, an invalid sample's row zero) and of the half-warp design
``bench/round_variants.py`` measures beside it (a lane a sample, each lane's
running sum of τ formed in order from the half-warp's values) bit for bit a
ray's sequential loop; and the baked render through the round bit for bit the
composition it replaced (march, positions, ``query_plain``,
``composite_window_plain(activated=True)``)."""

import re
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import TOL_COMPOSITE
from instant_ngp_tpu.testbed import Testbed as JaxTestbed
from instant_ngp_torch import testbed as port_testbed
from instant_ngp_torch.common import EPS_T, MIN_CONE_STEPSIZE, NerfActivation, fma
from instant_ngp_torch.nerf import baked as port_baked
from instant_ngp_torch.nerf.task import composite_window_plain, running_sum

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
TINY = ROOT / "tests" / "fixtures" / "tiny_nerf.ingp"
RES = 16  # the baked frame
RAYS = 32  # the round's window: RAYS² rays of view 0
BAKE_RES = 32
# samples a ray a pass: the kernel's own constant
PASS = int(re.search(r"constexpr int kPass = (\d+);",
                     (ROOT / "instant_ngp_torch" / "csrc" / "baked_round.cu").read_text()).group(1))
LANES = 16  # a half-warp a ray (bench/round_variants.py's half_warp design)


@pytest.fixture(scope="module")
def testbeds():
    ours = port_testbed.Testbed("nerf", device="cpu")
    ours.load_snapshot(TINY)
    theirs = JaxTestbed("nerf")
    theirs.load_snapshot(str(TINY))
    for tb in (ours, theirs):
        tb.task.baked_res0 = BAKE_RES
    return ours, theirs


def _window(task, cache, seed: int):
    """The baked render's march window for RAYS² rays of view 0 and a
    seeded ray state: (o, d, ts, dts, valid, t, t_exit, T, rgb, depth,
    alive, tmax, cost)."""
    xf = np.asarray(task.dataset.xforms_start[0], np.float32)
    ys, xs = np.meshgrid(np.arange(RAYS), np.arange(RAYS), indexing="ij")
    uv = torch.from_numpy(np.stack([(xs.reshape(-1) + 0.5) / RAYS, (ys.reshape(-1) + 0.5) / RAYS],
                                   -1).astype(np.float32))
    fl = 0.5 * RAYS / np.tan(0.5 * np.radians(50.0))
    o, d, tmin, tmax = task._prep_rays(uv, task._t([RAYS, RAYS]), task._t([fl, fl]),
                                       task._t([0.5, 0.5]), task._t(xf))
    alive = tmax > tmin
    dt = max(1.0, (1.0 / float(cache.res_host[0])) / MIN_CONE_STEPSIZE)
    ts, dts, valid, t_exit, _ = task._march_window(o, d, tmin, alive, tmax,
                                                   window=task.baked_samples_per_window,
                                                   dt_scale=dt)
    rng = np.random.default_rng(seed)
    R = o.shape[0]
    T = torch.from_numpy(rng.uniform(0.2, 1.0, R).astype(np.float32))
    rgb = torch.from_numpy(rng.random((R, 3)).astype(np.float32))
    depth = torch.from_numpy(rng.random(R).astype(np.float32))
    cost = torch.from_numpy(rng.integers(0, 40, R).astype(np.float32))
    return o, d, ts, dts, valid, tmin, t_exit, T, rgb, depth, alive, tmax, cost


def test_round_plain_matches_jax_render_round_baked(testbeds):
    """``render_round_plain`` against the jitted JAX ``_render_round_baked``
    on its own bake, its march replaced by the port's window: T, rgb, depth
    and cost within TOL_COMPOSITE, t and the alive flags equal."""
    ours, theirs = testbeds
    jcache = theirs.task.bake(res0=BAKE_RES)
    cache = port_baked.cache_from_numpy(
        np.asarray(jcache.index), np.asarray(jcache.table), np.asarray(jcache.offsets),
        np.asarray(jcache.res), jcache.n_cascades, jcache.n_rows, "cpu")
    o, d, ts, dts, valid, t, t_exit, T, rgb, depth, alive, tmax, cost = _window(
        ours.task, cache, 0)
    assert int(valid.sum()) > 1000
    got = port_baked.render_round_plain(cache, o, d, ts, dts, valid, t, t_exit, T, rgb, depth,
                                        alive, tmax, cost, EPS_T)
    jtask = theirs.task

    def round_given_window(ts, dts, valid, t_exit, o, d, t, T, rgb, depth, alive, tmax, cost):
        jtask._march_window = lambda *a, **k: (ts, dts, valid, t_exit, None)
        try:
            return jtask._render_round_baked(jcache, None, o, d, t, T, rgb, depth, alive, tmax,
                                             cost, EPS_T)
        finally:
            del jtask._march_window

    ref = jax.jit(round_given_window)(*[jnp.asarray(a.numpy()) for a in (
        ts, dts, valid, t_exit, o, d, t, T, rgb, depth, alive, tmax, cost)])
    for name, g, r in zip(("t", "T", "rgb", "depth", "alive", "cost"), got, ref):
        r = np.asarray(r)
        if name in ("t", "alive"):
            np.testing.assert_array_equal(g.numpy(), r, err_msg=name)
        else:
            np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=TOL_COMPOSITE, err_msg=name)
    assert not torch.equal(got[2], rgb) and 0 < int(got[4].sum()) < int(alive.sum())


def _sequential(tau, rgbd, T):
    """A ray's loop in numpy f32 (kernel D's old loop, one thread a ray):
    the running sum and the weighted [r, g, b, t] sums, sample after
    sample."""
    f32 = np.float32
    R, K = tau.shape
    cs, acc, css = np.zeros(R, f32), np.zeros((R, 4), f32), np.empty((R, K), f32)
    for k in range(K):
        cs = (cs + tau[:, k]).astype(f32)
        css[:, k] = cs
        weight = ((f32(1) - np.exp(-tau[:, k])) * (T * np.exp(-cs + tau[:, k]))).astype(f32)
        acc = (acc + (weight[:, None] * rgbd[:, k]).astype(f32)).astype(f32)
    return css, acc


def _ray_lane(tau, rgbd, T, valid):
    """csrc/baked_round.cu's order in numpy f32: a lane a ray, passes of
    PASS samples staged in shared memory, an invalid sample's row zero (it
    makes no lookup; the plain version multiplies its zero weight by the
    row N gives), the running sum and the four sums in registers from pass
    to pass."""
    f32 = np.float32
    R, K = tau.shape
    cs, acc, css = np.zeros(R, f32), np.zeros((R, 4), f32), np.empty((R, K), f32)
    for c0 in range(0, K, PASS):
        staged = np.where(valid[:, c0:c0 + PASS, None], rgbd[:, c0:c0 + PASS], f32(0))
        staged[..., 3] = rgbd[:, c0:c0 + PASS, 3]  # every sample's t is staged
        for j in range(staged.shape[1]):
            tk = tau[:, c0 + j]
            cs = (cs + tk).astype(f32)
            css[:, c0 + j] = cs
            weight = ((f32(1) - np.exp(-tk)) * (T * np.exp(-cs + tk))).astype(f32)
            acc = (acc + (weight[:, None] * staged[:, j]).astype(f32)).astype(f32)
    return css, acc


def _half_warp(tau, rgbd, T, valid):
    """The half_warp design's order (``bench/round_variants.py``) in numpy
    f32: chunks of LANES samples; lane k adds the chunk's shared values τ_0
    … τ_k one by one onto the carry; each lane's weighted [r, g, b, t] goes
    to shared memory, and lane c < 4 sums channel c over the chunk in
    sample order; the carry is the chunk's last lane's sum."""
    f32 = np.float32
    R, K = tau.shape
    carry, acc, css = np.zeros(R, f32), np.zeros((R, 4), f32), np.empty((R, K), f32)
    for c0 in range(0, K, LANES):
        n = min(LANES, K - c0)
        shared = tau[:, c0:c0 + n]
        prods = np.empty((R, n, 4), f32)
        for lane in range(LANES):
            cs = carry.copy()
            for j in range(LANES):  # every lane reads all 16 values
                if j <= min(lane, n - 1):
                    cs = (cs + shared[:, j]).astype(f32)
            if lane < n:
                tk = tau[:, c0 + lane]
                weight = ((f32(1) - np.exp(-tk)) * (T * np.exp(-cs + tk))).astype(f32)
                prods[:, lane] = weight[:, None] * rgbd[:, c0 + lane]
                css[:, c0 + lane] = cs
            if lane == n - 1:
                last = cs
        for c in range(4):  # lane c
            for j in range(n):
                acc[:, c] = (acc[:, c] + prods[:, j, c]).astype(f32)
        carry = last
    return css, acc


@pytest.mark.parametrize("design", ["ray_lane", "half_warp"])
@pytest.mark.parametrize("K", [16, 40])
def test_round_order_is_the_sequential_loop(design, K):
    """The designs' premise on seeded windows with dense samples (τ up to
    ~1e3) and invalid ones (τ 0, a finite row): the running sums are
    ``running_sum`` and the loop's bit for bit, and so are the weighted
    sums; at K 40 (passes and chunks with a ragged last one, the carry
    between them) too. ``ray_lane`` is the kernel's; ``half_warp`` the
    alternative ``bench/round_variants.py`` measures."""
    rng = np.random.default_rng(K)
    R = 2048
    valid = rng.random((R, K)) < 0.8
    tau = (rng.uniform(0.0, 3.0, (R, K)) * valid).astype(np.float32)
    dense = valid & (rng.random((R, K)) < 0.1)
    tau[dense] = rng.uniform(500.0, 1500.0, int(dense.sum())).astype(np.float32)
    rgbd = np.concatenate([rng.random((R, K, 3)), rng.uniform(0.5, 4.0, (R, K, 1))],
                          -1).astype(np.float32)
    T = rng.uniform(0.01, 1.0, R).astype(np.float32)
    css, acc = (_ray_lane if design == "ray_lane" else _half_warp)(tau, rgbd, T, valid)
    seq_cs, seq_acc = _sequential(tau, rgbd, T)
    np.testing.assert_array_equal(css, running_sum(torch.from_numpy(tau)).numpy())
    np.testing.assert_array_equal(css, seq_cs)
    np.testing.assert_array_equal(acc, seq_acc)
    assert np.abs(acc).max() > 0


def _parent_render_rays(task, o, d, tminmax=None, max_rounds: int = 64, fast: bool = False,
                        baked_cache=None):
    """The baked branch of ``NerfTask._render_rays`` as it was before the
    round: march, positions by ``common.fma``, ``query_plain``, then
    ``composite_window_plain(activated=True)``."""
    tmin, tmax = tminmax
    R = o.shape[0]
    t, T = tmin.clone(), torch.ones((R,))
    rgb, depth, cost = torch.zeros((R, 3)), torch.zeros((R,)), torch.zeros((R,))
    alive = tmax > tmin
    baked_dt = max(1.0, (1.0 / float(baked_cache.res_host[0])) / MIN_CONE_STEPSIZE)
    for _ in range(2 * max_rounds):
        idx = torch.nonzero(alive).squeeze(1)
        if idx.numel() == 0:
            break
        o_c, d_c, t_c, tmax_c = o[idx].contiguous(), d[idx].contiguous(), t[idx], tmax[idx]
        alive_c = torch.ones_like(idx, dtype=torch.bool)
        ts, dts, valid, t_exit, _ = task._march_window(
            o_c, d_c, t_c, alive_c, tmax_c, window=task.baked_samples_per_window,
            dt_scale=baked_dt)
        Rc, K = ts.shape
        pos = fma(ts[..., None], d_c[:, None, :], o_c[:, None, :])
        out = port_baked.query_plain(baked_cache, pos.reshape(Rc * K, 3)).reshape(Rc, K, 4)
        t_n, T_n, rgb_n, depth_n, alive_n, cost_n = composite_window_plain(
            out, ts, dts, valid, t_c, t_exit, T[idx], rgb[idx], depth[idx], alive_c, tmax_c,
            cost[idx], task.min_transmittance, task.rgb_activation, task.density_activation,
            activated=True)
        t[idx], T[idx], rgb[idx], depth[idx] = t_n, T_n, rgb_n, depth_n
        alive[idx], cost[idx] = alive_n, cost_n
    return rgb, 1.0 - T, depth, cost


def test_baked_render_equals_the_parent_composition(testbeds, monkeypatch):
    """A baked 16² frame (and its depth) through the round equals, bit for
    bit, the frame of the composition the round replaced."""
    task = testbeds[0].task
    xf = np.asarray(task.dataset.xforms_start[0], np.float32)
    frame, depth = task.render(RES, RES, xf, render_quality="baked", return_depth=True)
    monkeypatch.setattr(task, "_render_rays", types.MethodType(_parent_render_rays, task))
    ref, ref_depth = task.render(RES, RES, xf, render_quality="baked", return_depth=True)
    assert torch.equal(frame, ref) and torch.equal(depth, ref_depth)
    assert float(frame[..., 3].max()) > 0.1
