"""Kernel D's plain version (``nerf.task.composite_window_plain``) against
the JAX package's ``_composite_window`` and against a numpy model of
``csrc/composite.cu``'s loop, on windows with dense samples, on the CPU.

The weight's exponent −cumsum(τ)_k + τ_k keeps only the last bits of a
sum that a dense sample (τ ~ 1e3) has made large, so the order in which
the running sum is taken shows in the output far above f32 rounding."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import TOL_COMPOSITE
from instant_ngp_tpu.common import NerfActivation as JaxActivation
from instant_ngp_tpu.nerf.task import NerfTask as JaxNerfTask
from instant_ngp_torch.common import NerfActivation
from instant_ngp_torch.nerf.task import composite_window_plain, running_sum

torch.set_num_threads(2)

R, K = 4096, 8
EPS_T = 1e-4


def _window(seed: int) -> dict:
    """A render window of activated outputs (rgb in [0, 1], σ up to e^15):
    most samples light, one in eight dense, some invalid."""
    rng = np.random.default_rng(seed)
    sigma = np.exp(rng.uniform(-15.0, 6.0, (R, K)))
    dense = rng.random((R, K)) < 0.125
    sigma[dense] = np.exp(rng.uniform(12.0, 15.0, int(dense.sum())))
    out = np.concatenate([rng.random((R, K, 3)), sigma[..., None]], axis=-1).astype(np.float32)
    t = rng.uniform(0.0, 1.0, R).astype(np.float32)
    return {
        "out": out,
        "ts": (t[:, None] + np.cumsum(rng.uniform(1e-4, 2e-3, (R, K)), axis=1)).astype(np.float32),
        "dts": rng.uniform(1e-4, 2e-3, (R, K)).astype(np.float32),
        "valid": rng.random((R, K)) < 0.9,
        "t": t,
        "t_exit": (t + rng.uniform(-0.01, 0.1, R)).astype(np.float32),
        "T": rng.random(R).astype(np.float32),
        "rgb": rng.random((R, 3)).astype(np.float32),
        "depth": rng.random(R).astype(np.float32),
        "alive": rng.random(R) < 0.95,
        "tmax": np.full(R, 1.05, np.float32),
        "cost": np.zeros(R, np.float32),
    }


def _port(w: dict, running=running_sum):
    """The plain version on w, its running sum replaced by ``running``."""
    import instant_ngp_torch.nerf.task as port_task

    args = [torch.from_numpy(v) for v in w.values()]
    saved, port_task.running_sum = port_task.running_sum, running
    try:
        res = composite_window_plain(*args, EPS_T, NerfActivation.NONE, NerfActivation.NONE)
    finally:
        port_task.running_sum = saved
    return [r.numpy() for r in res]


def _jax(w: dict):
    """The JAX package's ``_composite_window``, jitted with the arrays as
    arguments."""
    fake = types.SimpleNamespace(rgb_activation=JaxActivation.NONE,
                                 density_activation=JaxActivation.NONE)
    fn = jax.jit(lambda *a: JaxNerfTask._composite_window(fake, *a, eps_t=EPS_T))
    return [np.asarray(r) for r in fn(*w.values())]


def _max_err(a, b) -> float:
    return max(float(np.abs(x.astype(np.float64) - y.astype(np.float64)).max())
               for x, y in zip(a[1:4], b[1:4]))


def _kernel_d_model(w: dict):
    """csrc/composite.cu's loop in numpy f32: one ray's samples in order,
    the running sum of τ in one register."""
    f32 = np.float32
    out, ts, dts, valid = w["out"], w["ts"], w["dts"], w["valid"]
    cs = np.zeros(R, f32)
    acc = np.zeros((R, 4), f32)
    for k in range(K):
        tau = (np.where(valid[:, k], out[:, k, 3], f32(0)) * dts[:, k]).astype(f32)
        cs = (cs + tau).astype(f32)
        weight = ((f32(1) - np.exp(-tau)) * (w["T"] * np.exp(-cs + tau))).astype(f32)
        rgbd = np.concatenate([out[:, k, :3], ts[:, k, None]], axis=1)
        acc = (acc + weight[:, None] * rgbd).astype(f32)
    T_new = (w["T"] * np.exp(-cs)).astype(f32)
    return [w["t_exit"], T_new, w["rgb"] + acc[:, :3], w["depth"] + acc[:, 3]]


def test_running_sum_is_xla_cumsum_bit_for_bit():
    """``running_sum`` is sequential f32 addition: XLA's cumsum, a
    reduce-window, on the same τ, and a numpy loop."""
    rng = np.random.default_rng(3)
    tau = (np.exp(rng.uniform(-15.0, 15.0, (R, K))) * rng.uniform(1e-4, 2e-3, (R, K)))
    tau = tau.astype(np.float32)
    seq, acc = np.empty_like(tau), np.zeros(R, np.float32)
    for k in range(K):
        acc = (acc + tau[:, k]).astype(np.float32)
        seq[:, k] = acc
    ours = running_sum(torch.from_numpy(tau)).numpy()
    np.testing.assert_array_equal(ours, seq)
    np.testing.assert_array_equal(ours, np.asarray(jax.jit(lambda x: jnp.cumsum(x, axis=-1))(tau)))


@pytest.mark.parametrize("seed", [0, 1])
def test_composite_window_plain_matches_jax_on_dense_windows(seed):
    """Same τ, same running sums: the outputs agree within a few f32
    roundings of the exps and the K-term sums (4 · 2^-22 of values ≤ 2),
    the alive flags and costs exactly."""
    w = _window(seed)
    ours, theirs = _port(w), _jax(w)
    assert _max_err(ours, theirs) <= 1e-6
    np.testing.assert_array_equal(ours[4], theirs[4])
    np.testing.assert_array_equal(ours[5], theirs[5])


@pytest.mark.parametrize("seed", [0, 1])
def test_composite_window_plain_matches_kernel_d_loop(seed):
    """The plain version against kernel D's order of operations, modelled
    in numpy f32, within the same few roundings."""
    w = _window(seed)
    assert _max_err(_port(w), _kernel_d_model(w)) <= 1e-6


def test_another_summation_order_breaks_the_kernel_tolerance():
    """The premise: taking the running sum by a parallel scan (pairs, then
    fours; the GPU's torch.cumsum order) instead of in sequence moves the
    outputs by more than chip_smoke.TOL_COMPOSITE on these windows."""

    def scan(x):
        y, s = x.clone(), 1
        while s < x.shape[-1]:
            z = y.clone()
            z[..., s:] = y[..., s:] + y[..., :-s]
            y, s = z, 2 * s
        return y

    w = _window(0)
    assert _max_err(_port(w, scan), _port(w)) > TOL_COMPOSITE
