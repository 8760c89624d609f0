"""The SDF render of the PyTorch port against the JAX package's on the CPU: a
tiny SDF trained by the JAX package, carried across, rendered at 32² by both
(sphere trace, analytic or finite-difference normals, soft shadows, the
floor) and the mesh's ground truth in both modes.

The trace's hit tests (|dist| < 5e-4, |final| < 2e-3) and the shadow
trace's dist < 1e-4 are discrete decisions that flip on the last bit of the
network's output, whose bf16 hidden layers round after f32 sums taken in
another order in the two packages. So parity is stated as the share of
pixels whose hit masks differ (≤ 1 %) and the PSNR of the frames over the
pixels where they agree (≥ 40 dB). ``distance_scale`` below 1 is left out of
the comparison: at 24 steps it leaves grazing rays unconverged near the hit
threshold, where those last bits decide whether a ray hits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instant_ngp_tpu.sdf.task import SdfTask as JaxSdfTask
from instant_ngp_torch.geometry.procedural import bumpy_torus
from instant_ngp_torch.models.network import params_from_jax
from instant_ngp_torch.sdf.task import SdfTask

torch.set_num_threads(2)

RES = 32
N_TRACE_STEPS = 24  # tests/test_tasks.py's: JAX on the CPU compiles each render setting anew
MIN_PSNR_DB = 40.0
MAX_MASK_DIFF = 0.01
TRAIN_STEPS = 60
CONFIG = {"loss": {"otype": "Mape"},
          "optimizer": {"otype": "Adam", "learning_rate": 1e-2, "beta1": 0.9, "beta2": 0.99,
                        "epsilon": 1e-15, "l2_reg": 1e-6},
          "encoding": {"otype": "HashGrid", "n_levels": 6, "n_features_per_level": 2,
                       "log2_hashmap_size": 14, "base_resolution": 8},
          "network": {"otype": "FullyFusedMLP", "activation": "ReLU",
                      "output_activation": "None", "n_neurons": 32, "n_hidden_layers": 2}}


def look_at(eye, target=(0.5, 0.5, 0.5)) -> np.ndarray:
    """A (3, 4) camera at eye looking at target: columns right, down, forward,
    origin (the render's d = u·c0 + v·c1 + c2)."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, [0.0, 1.0, 0.0])
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    return np.stack([right, down, fwd, eye], 1).astype(np.float32)


CAMERA = look_at((0.5, 1.25, -0.25))


@pytest.fixture(scope="module")
def trained():
    """(JAX task, port task): the JAX package trains 60 steps on fresh
    batches of its own; the port task gets its parameters."""
    v, f = bumpy_torus(48, 24, seed=3)
    theirs = JaxSdfTask(v[f], CONFIG, batch_size=4096)
    ours = SdfTask(v[f], CONFIG, device="cpu", batch_size=4096)
    for _ in range(TRAIN_STEPS):
        pts, d = theirs.generate_training_batch()
        theirs.params, theirs.opt_state, _ = theirs._jit_step(theirs.params, theirs.opt_state,
                                                              jnp.asarray(pts), jnp.asarray(d))
    params_from_jax(ours.model, jax.tree.map(np.asarray, theirs.params))
    yield theirs, ours
    theirs.stop_producer()
    ours.stop_producer()


def _compare(out: np.ndarray, ref: np.ndarray, min_hit: float = 0.2) -> tuple[float, float]:
    """(share of pixels whose hit masks differ, PSNR over the rest), after
    checking shape, finiteness and that the view hits the surface."""
    assert out.shape == ref.shape == (RES, RES, 4) and np.isfinite(out).all()
    hit, hit_ref = out[..., 3] > 0.5, ref[..., 3] > 0.5
    assert hit_ref.mean() > min_hit, hit_ref.mean()
    differ = float(np.mean(hit != hit_ref))
    same = hit == hit_ref
    mse = float(np.mean((np.clip(out[same][:, :3], 0, 1) - np.clip(ref[same][:, :3], 0, 1)) ** 2))
    return differ, -10.0 * np.log10(max(mse, 1e-12))


DEFAULTS = {"analytic_normals": True, "floor_enable": False, "floor_y": 0.0,
            "render_shadows": True, "zero_offset": 0.0}
KNOBS = {
    "analytic_shadows": {},
    "finite_differences_floor": {"analytic_normals": False, "floor_enable": True,
                                 "floor_y": 0.4},
    "no_shadows_zero_offset": {"render_shadows": False, "zero_offset": 0.01},
}


@pytest.mark.parametrize("knobs", KNOBS)
def test_render_equals_jax(trained, knobs):
    theirs, ours = trained
    for task in (theirs, ours):
        for k, v in KNOBS[knobs].items():
            setattr(task, k, v)
    try:
        ref = np.asarray(theirs.render(RES, RES, CAMERA, n_trace_steps=N_TRACE_STEPS))
        out = ours.render(RES, RES, CAMERA, n_trace_steps=N_TRACE_STEPS).numpy()
    finally:
        for task in (theirs, ours):
            for k in KNOBS[knobs]:
                setattr(task, k, DEFAULTS[k])
    differ, db = _compare(out, ref)
    assert differ <= MAX_MASK_DIFF and db >= MIN_PSNR_DB, (differ, db)
    if knobs == "analytic_shadows":
        # shadows darken some lit pixels: the frame differs from one without them
        ours.render_shadows = False
        plain = ours.render(RES, RES, CAMERA, n_trace_steps=N_TRACE_STEPS).numpy()
        ours.render_shadows = True
        assert np.any(plain[..., :3] > out[..., :3] + 1e-3)


@pytest.mark.parametrize("mode", ["raytracedmesh", "spheretracedmesh"])
def test_ground_truth_equals_jax(trained, mode):
    """The mesh's own frame: BVH ray casts with flat normals, or a sphere
    trace of its SDF with 6-tap normals; host work in both packages."""
    theirs, ours = trained
    theirs.groundtruth_mode = ours.groundtruth_mode = mode
    ref = np.asarray(theirs.render(RES, RES, CAMERA, n_trace_steps=N_TRACE_STEPS,
                                   ground_truth=True))
    out = ours.render(RES, RES, CAMERA, n_trace_steps=N_TRACE_STEPS, ground_truth=True).numpy()
    differ, db = _compare(out, ref)
    assert differ <= MAX_MASK_DIFF and db >= MIN_PSNR_DB, (differ, db)


def test_hit_positions_are_the_render_hits(trained):
    """``hit_positions`` gives the surface positions of ``render``'s frame:
    one for each hit pixel, on the surface and inside the unit cube."""
    _, ours = trained
    hits = ours.hit_positions(RES, RES, CAMERA, n_trace_steps=N_TRACE_STEPS)
    frame = ours.render(RES, RES, CAMERA, n_trace_steps=N_TRACE_STEPS)
    assert hits.shape == (int((frame[..., 3] > 0.5).sum()), 3) and hits.shape[0] > 0
    assert bool((ours.sdf(hits).abs() < 2e-3).all())
    assert bool(((hits >= 0) & (hits <= 1)).all())
