"""One whole NeRF training step on the port against the JAX package's, on
the CPU, with the JAX step's draws injected, for the capture features of
the scene itself: images of differing sizes (padded into one canvas, each
read and each ray made at its own size), supplied rays (``rays_*.dat``,
read by row through kernel I's plain version) and a moving camera (start
and end transforms slerped at each pixel's rolling-shutter and motion-blur
time). ``test_torch_train_features.check_feature_step`` holds the step."""

import pytest

from test_torch_train_features import check_feature_step


@pytest.mark.parametrize("feature", ["mixed_sizes", "rays", "motion"])
def test_capture_step_equals_jax(feature):
    check_feature_step(feature)


def test_camera_state_with_an_envmap_crosses_snapshots():
    """A camera state with a distortion map, an environment map and latents,
    packed as the JAX package packs a snapshot's ``cam_offsets``, unpacks in
    the port leaf for leaf, and so without either map or the latents."""
    import numpy as np

    from instant_ngp_tpu import snapshot as jax_snapshot
    from instant_ngp_torch import snapshot as port_snapshot

    rng = np.random.default_rng(0)
    full = {"rot": (3, 3), "pos": (3, 3), "exposure": (3, 3), "focal": (2,), "extra": (3, 4),
            "distortion": (32, 32, 2), "envmap": (128, 256, 4)}
    for drop in ((), ("distortion",), ("envmap", "extra"), ("distortion", "envmap", "extra")):
        cam = {k: rng.normal(size=s).astype(np.float32) for k, s in full.items() if k not in drop}
        got = port_snapshot.unpack_cam_offsets(jax_snapshot.pack_tree(cam))
        assert sorted(got) == sorted(cam)
        for k, v in cam.items():
            np.testing.assert_array_equal(got[k], v)
