"""What a trained NeRF renders besides its colour, against the JAX package on
the CPU, on the tiny snapshot at 16²: every render mode, the slice render
(``NerfTask.render_slice`` and the Testbed's RenderMode.SLICE), depth of
field, a rotated crop box, the ``fast`` render and its stochastic-corner
encode (kernel A's stochastic mode's plain version), ``level_stats`` and
``density_slice``. The views are rendered at the default field of view: the
JAX render then compiles its ray generation once for the file."""

import dataclasses
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instant_ngp_tpu.common import RenderMode as JaxRenderMode
from instant_ngp_tpu.nerf import task as jax_task
from instant_ngp_tpu.testbed import Testbed as JaxTestbed
from instant_ngp_torch import testbed as port_testbed
from instant_ngp_torch.common import RenderMode
from instant_ngp_torch.nerf import task as port_task
from instant_ngp_torch.ops import hashgrid as port_hg
from test_torch_hashgrid import _encodings, _positions

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
TINY = ROOT / "tests" / "fixtures" / "tiny_nerf.ingp"
RES = 16
MIN_PSNR_DB = 45.0
# normals are −∇σ through the bf16 density network: the backward's f32 sums
# and bf16 roundings fall in another order than XLA's (46.6 dB measured)
MIN_NORMALS_PSNR_DB = 40.0
MODES = ("shade", "depth", "positions", "normals", "ao", "cost", "encodingvis", "distortion",
         "slice")


@pytest.fixture(scope="module")
def testbeds():
    ours = port_testbed.Testbed("nerf", device="cpu")
    ours.load_snapshot(TINY)
    theirs = JaxTestbed("nerf")
    theirs.load_snapshot(str(TINY))
    return ours, theirs


def _camera(tb):
    return np.asarray(tb.nerf_dataset.xforms_start[0], np.float32)


def _psnr(a, b):
    mse = float(np.mean((np.clip(a[..., :3], 0, 1) - np.clip(b[..., :3], 0, 1)) ** 2))
    return -10.0 * np.log10(max(mse, 1e-12))


def _both(testbeds, **kw):
    ours, theirs = testbeds
    xf = _camera(ours)
    return (ours.task.render(RES, RES, xf, **kw).numpy(),
            np.asarray(theirs.task.render(RES, RES, xf, **kw)))


@pytest.mark.parametrize("mode", MODES)
def test_render_mode_matches_jax(testbeds, mode):
    """Each mode's frame ≥ 45 dB of JAX's (normals 40 dB), its alpha within
    1e-4; cost (samples a ray) equal on ≥ 99 % of pixels (the 41-in-4,096
    march differences of Queue 3 can move a ray by a step)."""
    frame, ref = _both(testbeds, render_mode=mode)
    assert frame.shape == ref.shape == (RES, RES, 4)
    assert _psnr(frame, ref) >= (MIN_NORMALS_PSNR_DB if mode == "normals" else MIN_PSNR_DB)
    np.testing.assert_allclose(frame[..., 3], ref[..., 3], rtol=0, atol=1e-4)
    if mode == "cost":
        assert np.mean(np.all(frame[..., :3] == ref[..., :3], -1)) >= 0.99
        assert frame[..., 0].max() > 0  # samples were counted
    if mode not in ("shade", "distortion"):
        shade, _ = _both(testbeds)
        assert not np.array_equal(frame[..., :3], shade[..., :3])


def test_distortion_mode_reads_a_distortion_map(testbeds):
    """A (h, w, 2) map held as a snapshot would hold it: the port's
    ``cam_offsets["distortion"]``, JAX's ``state.cam["distortion"]``. The
    JAX render reads the map op by op; the port's read contracts the jitted
    read's three FMAs: offsets an ulp apart, scaled by 50 and 100 in the
    colour, within 3e-5."""
    ours, theirs = testbeds
    dist = np.random.default_rng(2).normal(scale=0.01, size=(8, 12, 2)).astype(np.float32)
    state = theirs.task.state
    ours.task.cam_offsets["distortion"] = dist
    theirs.task.state = dataclasses.replace(state, cam={**state.cam,
                                                        "distortion": jnp.asarray(dist)})
    try:
        frame, ref = _both(testbeds, render_mode="distortion")
    finally:
        del ours.task.cam_offsets["distortion"]
        theirs.task.state = state
    np.testing.assert_allclose(frame, ref, rtol=0, atol=3e-5)
    assert np.ptp(frame[..., 0]) > 0.1


def test_render_slice_and_the_testbed_slice_mode_match_jax(testbeds):
    """``render_slice`` on the plane 0.8 over a grey background, and the
    Testbed's RenderMode.SLICE (plane slice_plane_z + scale, sRGB out): the
    whole model off the unit cube too, ≥ 45 dB."""
    ours, theirs = testbeds
    xf = _camera(ours)
    kw = dict(plane_dist=0.8, background=(0.3, 0.3, 0.3, 0.5))
    frame = ours.task.render_slice(RES, RES, xf, **kw).numpy()
    ref = np.asarray(theirs.task.render_slice(RES, RES, xf, **kw))
    assert _psnr(frame, ref) >= MIN_PSNR_DB and frame[..., 3].max() > 0.5
    for tb, mode in ((ours, RenderMode.SLICE), (theirs, JaxRenderMode.SLICE)):
        tb.render_mode, tb.slice_plane_z = mode, -0.7
    try:
        frame = ours.render(RES, RES, camera_matrix=xf, linear=False)
        ref = theirs.render(RES, RES, camera_matrix=xf, linear=False)
    finally:
        ours.render_mode, theirs.render_mode = RenderMode.SHADE, JaxRenderMode.SHADE
    assert _psnr(frame, ref) >= MIN_PSNR_DB


def test_depth_of_field_at_spp_2_matches_jax(testbeds):
    """A thin lens of aperture 0.03 focused at 0.9: sample s on the disk at
    Halton(s + 1; 5, 7), the rays clipped by the render loop; ≥ 45 dB, and
    not the pinhole frame."""
    ours, theirs = testbeds
    pinhole, _ = _both(testbeds, spp=2)
    for t in (ours.task, theirs.task):
        t.aperture_size, t.focus_z = 0.03, 0.9
    try:
        frame, ref = _both(testbeds, spp=2)
    finally:
        for t in (ours.task, theirs.task):
            t.aperture_size, t.focus_z = 0.0, 1.0
    assert _psnr(frame, ref) >= MIN_PSNR_DB
    assert _psnr(frame, pinhole) < 60.0


def test_rotated_crop_box_matches_jax(testbeds):
    """A crop box [0.25, 0.75]³ turned 0.4 rad about z: the ray interval is
    the scene box's ∩ the rotated box's; ≥ 45 dB, and another frame than
    the same box unrotated."""
    ours, theirs = testbeds
    c, s = math.cos(0.4), math.sin(0.4)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    saved = [(t.render_aabb_min, t.render_aabb_max) for t in (ours.task, theirs.task)]
    for t in (ours.task, theirs.task):
        t.render_aabb_min = np.full(3, 0.25, np.float32)
        t.render_aabb_max = np.full(3, 0.75, np.float32)
    try:
        straight, _ = _both(testbeds)
        ours.render_aabb_to_local = rot
        theirs.render_aabb_to_local = rot
        assert np.array_equal(ours.render_aabb_to_local, rot)
        frame, ref = _both(testbeds)
    finally:
        ours.render_aabb_to_local = theirs.render_aabb_to_local = np.eye(3, dtype=np.float32)
        for t, (lo, hi) in zip((ours.task, theirs.task), saved):
            t.render_aabb_min, t.render_aabb_max = lo, hi
    assert _psnr(frame, ref) >= MIN_PSNR_DB
    assert not np.array_equal(frame, straight)


@pytest.mark.parametrize("name", ["fox", "small_f2", "small_f4"])
@pytest.mark.parametrize("interpolation", ["Simplex", "Linear", "Smoothstep"])
def test_stochastic_encode_equals_jax_encode_infer(name, interpolation):
    """The fast render's encode against ``encode_infer(stochastic_corner=
    True)`` on random points, cell boundaries and simplex ties: on hashed
    levels the chosen corner agrees on ≥ 99.9 % of samples and its row is
    bit for bit JAX's where it does; dense levels are bit for bit at F 4
    (XLA's einsum is an FMA chain from corner 0 there) and within 2 f32
    ulps of their size at F 2 (another order)."""
    je, pe = _encodings(name, interpolation)
    rng = np.random.default_rng(7)
    x = _positions(rng, pe, 4000)
    F = pe.n_features_per_level
    table = rng.uniform(-1, 1, (pe.n_entries, F)).astype(np.float32)
    tables = tuple(jnp.asarray(table[lv.offset:lv.offset + lv.size]) for lv in pe.levels)
    ref = np.asarray(jax.jit(lambda p, x: je.encode_infer(
        p, x, stochastic_corner=True, compute_dtype=jnp.float32))(tables, jnp.asarray(x)))
    got = port_hg.hashgrid_encode_stochastic_plain(pe.levels, pe.interpolation,
                                                   torch.from_numpy(table),
                                                   torch.from_numpy(x)).numpy()
    exact = port_hg.hashgrid_encode_plain(pe.levels, pe.interpolation, torch.from_numpy(table),
                                          torch.from_numpy(x)).numpy()
    n_hashed = 0
    for lv_i, lv in enumerate(pe.levels):
        a, b = got[:, lv_i * F:(lv_i + 1) * F], ref[:, lv_i * F:(lv_i + 1) * F]
        if lv.hashed:
            n_hashed += 1
            same = np.all(a == b, -1)
            assert same.mean() >= 0.999
            rows = table[lv.offset:lv.offset + lv.size]
            assert np.all(np.any(np.all(a[:64, None, :] == rows[None], -1), -1))  # one row each
            assert not np.array_equal(a, exact[:, lv_i * F:(lv_i + 1) * F])
        elif F == 4:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=2 * np.finfo(np.float32).eps)
    assert n_hashed > 0


def test_fast_render_matches_jax(testbeds):
    """``render_quality="fast"`` in both packages: ≥ 45 dB (95.0 measured),
    and not the exact frame; through the Testbed too. The baked quality no
    longer waits for Queue 1 item 3: it renders, and is neither frame
    (tests/test_torch_baked.py holds it against JAX)."""
    ours, theirs = testbeds
    exact, _ = _both(testbeds)
    frame, ref = _both(testbeds, render_quality="fast")
    assert _psnr(frame, ref) >= MIN_PSNR_DB
    assert not np.array_equal(frame, exact)
    ours.render_quality = "fast"
    try:
        tb_frame = ours.render(RES, RES, camera_matrix=_camera(ours))
    finally:
        ours.render_quality = "exact"
    assert tb_frame.shape == (RES, RES, 4)
    saved, ours.task.baked_res0 = ours.task.baked_res0, 32
    try:
        baked = ours.task.render(RES, RES, _camera(ours), render_quality="baked").numpy()
    finally:
        ours.task.baked_res0 = saved
    assert np.isfinite(baked).all()
    assert not np.array_equal(baked, exact) and not np.array_equal(baked, frame)


def test_level_stats_and_density_slice_equal_jax(testbeds):
    """The per-level table statistics exactly (numpy on the same tables);
    the density slice within bf16 tolerance (the density MLP in bf16)."""
    ours, theirs = testbeds
    ref = jax_task.level_stats(theirs.task)
    got = port_task.level_stats(ours.task)
    assert [(g["resolution"], g["hashed"], g["n_entries"]) for g in got] == \
        [(r["resolution"], r["hashed"], r["n_entries"]) for r in ref]
    for g, r in zip(got, ref):
        for k in ("mean", "std", "min", "max", "frac_nonzero"):
            assert g[k] == pytest.approx(r[k], rel=1e-5, abs=1e-9)
    got = port_task.density_slice(ours.task, z=0.45, res=24)
    ref = jax_task.density_slice(theirs.task, z=0.45, res=24)
    assert got.shape == (24, 24)
    np.testing.assert_allclose(got, ref, rtol=3e-2, atol=1e-3)
    assert got.max() > 1.0


def test_a_snapshots_distortion_map_loads_and_renders(testbeds, tmp_path):
    """A JAX snapshot saved with a distortion map in its camera offsets (the
    map ``optimize_distortion`` trains) loads into the port's Testbed, the
    distortion mode reads it (the JAX render, within 3e-5, as above), and a
    step trains from it."""
    ours, theirs = testbeds
    dist = np.random.default_rng(6).normal(scale=0.01, size=(32, 32, 2)).astype(np.float32)
    state = theirs.task.state
    theirs.task.state = dataclasses.replace(state, cam={**state.cam,
                                                        "distortion": jnp.asarray(dist)})
    try:
        theirs.save_snapshot(str(tmp_path / "d.ingp"))
        ref = np.asarray(theirs.task.render(RES, RES, _camera(ours), render_mode="distortion"))
    finally:
        theirs.task.state = state
    loaded = port_testbed.Testbed(device="cpu")
    loaded.load_snapshot(tmp_path / "d.ingp")
    np.testing.assert_array_equal(loaded.task.cam_offsets["distortion"], dist)
    frame = loaded.task.render(RES, RES, _camera(ours), render_mode="distortion").numpy()
    np.testing.assert_allclose(frame[..., :3], ref[..., :3], rtol=0, atol=3e-5)
    # training from it runs; with neither the extrinsics nor the focal length
    # optimized the map takes no gradient (the JAX step's), so Adam leaves it
    assert np.isfinite(loaded.task.train(1))
    np.testing.assert_array_equal(loaded.task.cam_offsets["distortion"].numpy(), dist)
