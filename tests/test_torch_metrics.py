"""The port's quality metrics (``instant_ngp_torch/metrics.py``) against the
JAX package's (``instant_ngp_tpu/metrics.py``) on seeded image pairs, LDR
and HDR. Both are numpy, so they agree to 1e-6 relative."""

import numpy as np
import pytest

from instant_ngp_tpu import metrics as jax_metrics
from instant_ngp_torch import metrics as port_metrics

RTOL = 1e-6


def _pair(seed: int, hdr: bool):
    """A reference image and a noisy render of it, (24, 20, 3) f32; HDR
    values reach ~4."""
    rng = np.random.default_rng(seed)
    ref = rng.random((24, 20, 3)).astype(np.float32)
    test = np.clip(ref + rng.normal(0.0, 0.05, ref.shape), 0.0, None).astype(np.float32)
    return (ref * 4.0, test * 4.0) if hdr else (ref, test)


@pytest.mark.parametrize("hdr", [False, True], ids=["ldr", "hdr"])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", ["mse", "psnr", "l1", "mape", "smape", "ssim", "flip"])
def test_metric_equals_jax(name, seed, hdr):
    ref, test = _pair(seed, hdr)
    ours = getattr(port_metrics, name)(ref, test)
    theirs = getattr(jax_metrics, name)(ref, test)
    assert isinstance(ours, float) == isinstance(theirs, float)
    np.testing.assert_allclose(ours, theirs, rtol=RTOL)


@pytest.mark.parametrize("hdr", [False, True], ids=["ldr", "hdr"])
@pytest.mark.parametrize("seed", [0, 1])
def test_flip_map_equals_jax(seed, hdr):
    ref, test = _pair(seed, hdr)
    ours = port_metrics.flip_map(ref, test)
    theirs = jax_metrics.flip_map(ref, test)
    assert ours.shape == theirs.shape == ref.shape[:2]
    np.testing.assert_allclose(ours, theirs, rtol=RTOL)


@pytest.mark.parametrize("x", [1e-2, 3.7e-4, 0.0, 1.0])
def test_mse_to_psnr_equals_jax(x):
    np.testing.assert_allclose(port_metrics.mse_to_psnr(x), jax_metrics.mse_to_psnr(x), rtol=RTOL)


def test_ssim_of_a_grayscale_pair_equals_jax():
    ref, test = _pair(5, False)
    np.testing.assert_allclose(port_metrics.ssim(ref[..., 0], test[..., 0]),
                               jax_metrics.ssim(ref[..., 0], test[..., 0]), rtol=RTOL)
