"""The slab renderer (``instant_ngp_torch/nerf/slab.py`` and its NerfTask
path) against the JAX package on the CPU, through the plain versions of
kernels P and O: the host planning bit for bit (``clipmap_boxes``,
``_plan_octaves``, ``static_ladder``, ``_host_k0``, ``plan_groups_host``),
the resampling pieces on seeded inputs, the sweep, the merged sweep and
whole frames (both ``merge_layers`` paths) on DenseVolumes carried across
from numpy, the port's frames against a fine brute-force march over the same
voxel field (test_slab.py's cases), ``bake_dense`` against JAX's, the
Testbed's slab frame against the JAX Testbed's (perspective and OpenCV
lenses), and a strict test of the deferred view dependence."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instant_ngp_tpu.nerf import slab as S
from instant_ngp_tpu.testbed import Testbed as JaxTestbed
from instant_ngp_torch import testbed as port_testbed
from instant_ngp_torch.common import Lens
from instant_ngp_torch.nerf import slab as P
from test_slab import _brute_force, _camera_dirs, _smooth_blob

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
TINY = ROOT / "tests" / "fixtures" / "tiny_nerf.ingp"
AABB = (np.float32([-1.5] * 3), np.float32([2.5] * 3))
# layers and frames against JAX: the first product's bf16 rounding can fall
# one bf16 step apart where the two f32 sums differ in their last bit
TOL = 2e-3
MIN_PSNR_DB = 45.0  # the Testbed's slab frame: 80.5-80.9 dB measured


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _psnr(a, b):
    mse = float(np.mean((np.clip(a[..., :3], 0, 1) - np.clip(b[..., :3], 0, 1)) ** 2))
    return -10.0 * np.log10(max(mse, 1e-12))


# --- host planning, bit for bit ---

@pytest.mark.parametrize("fn", ["clipmap_boxes", "plan_octaves", "static_ladder", "host_k0",
                                "plan_groups_host"])
def test_host_planning_equals_jax(fn):
    rng = np.random.default_rng(11)
    if fn == "clipmap_boxes":
        for _ in range(20):
            eye = rng.uniform(-2.0, 3.0, 3).astype(np.float32)
            for ext in (0.25, 0.3, 1.0):
                np.testing.assert_array_equal(P.clipmap_boxes(eye, *AABB, ext),
                                              S.clipmap_boxes(eye, *AABB, ext))
    elif fn == "plan_octaves":
        for _ in range(40):
            n = int(rng.choice([32, 48, 192, 256]))
            lo = float(rng.uniform(-2, 0))
            hi = lo + float(rng.uniform(0.25, 4))
            e0 = float(rng.uniform(lo - 1, hi + 1))
            for sign in (1.0, -1.0):
                assert P._plan_octaves(e0, n, lo, hi, sign) == S._plan_octaves(e0, n, lo, hi, sign)
    elif fn == "static_ladder":
        for n in range(1, 600, 7):
            assert P.static_ladder(n) == S.static_ladder(n)
    elif fn == "host_k0":
        for _ in range(100):
            lo = float(rng.uniform(-2, 0))
            hi = lo + float(rng.uniform(0.25, 4))
            e0 = float(rng.uniform(lo - 1, hi + 1))
            n = int(rng.choice([16, 192, 256]))
            for sign in (1.0, -1.0):
                assert P._host_k0(e0, n, lo, hi, sign) == S._host_k0(e0, n, lo, hi, sign)
    else:
        W, H = 96, 64
        for trial in range(12):
            q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
            xform = np.concatenate([q, rng.normal(size=(3, 1))], 1).astype(np.float32)
            fl = (W / (1.2 + trial * 0.3), H / (1.0 + trial * 0.2))
            pp = (0.5 + 0.1 * rng.normal(), 0.5 + 0.1 * rng.normal())
            g1, lo1, hi1 = P.plan_groups_host(xform, (W, H), fl, pp)
            g2, lo2, hi2 = S.plan_groups_host(xform, (W, H), fl, pp)
            assert g1 == g2
            np.testing.assert_array_equal(lo1, lo2)
            np.testing.assert_array_equal(hi1, hi2)


def test_group_stats_equals_jax_and_contains_in_the_host_plan():
    """The device-reduced plan against JAX's ``_group_stats`` (counts equal,
    extremes within an f32 ulp of the quotient) on random unit rays, and the
    host plan's windows containing it (test_slab.py:253-291)."""
    rng = np.random.default_rng(7)
    d = rng.normal(size=(4096, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    counts, lo, hi = P.group_stats(_t(d))
    rc, rlo, rhi = (np.asarray(x) for x in S._group_stats(jnp.asarray(d)))
    np.testing.assert_array_equal(counts, rc)
    np.testing.assert_allclose(lo, rlo, rtol=1e-6)
    np.testing.assert_allclose(hi, rhi, rtol=1e-6)
    W, H = 96, 64
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    uv = np.stack([(xs.reshape(-1) + 0.5) / W, (ys.reshape(-1) + 0.5) / H], -1)
    for trial in range(4):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        xform = np.concatenate([q, rng.normal(size=(3, 1))], 1).astype(np.float32)
        fl = (W / (1.2 + trial * 0.4), H / (1.0 + trial * 0.3))
        pp = (0.5, 0.5)
        u = (uv[:, 0] - pp[0]) * W / fl[0]
        v = (uv[:, 1] - pp[1]) * H / fl[1]
        dirs = np.stack([u, v, np.ones_like(u)], -1) @ q.T
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        counts, lo_d, hi_d = P.group_stats(_t(dirs))
        groups, lo_h, hi_h = P.plan_groups_host(xform, (W, H), fl, pp)
        for g in np.nonzero(counts)[0]:
            assert g in groups
            assert np.all(lo_h[g] <= lo_d[g] + 1e-4) and np.all(hi_h[g] >= hi_d[g] - 1e-4)


# --- resampling pieces on seeded inputs ---

def test_interp_matrix_and_ray_box_entry_match_jax():
    idx = np.linspace(-2.0, 10.0, 97, dtype=np.float32)
    np.testing.assert_array_equal(P.interp_matrix(_t(idx), 8).numpy(),
                                  np.asarray(S._interp_matrix(jnp.asarray(idx), 8)))
    rng = np.random.default_rng(1)
    d = rng.normal(size=(256, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.float32([0.1, -0.4, 0.3])
    for lo, hi in ((np.float32([0.2] * 3), np.float32([0.9] * 3)),
                   (np.full(3, np.inf, np.float32),) * 2):
        got = P.ray_box_entry(o, _t(d), lo, hi).numpy()
        ref = np.asarray(S._ray_box_entry(jnp.asarray(o), jnp.asarray(d), jnp.asarray(lo),
                                          jnp.asarray(hi)))
        np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_quad_pack_and_sample_match_jax():
    rng = np.random.default_rng(0)
    B = 16
    layers = rng.random((3, B, B, 8), np.float32)
    pk = P.quad_pack(_t(layers))
    ref_pk = np.asarray(S.quad_pack(jnp.asarray(layers))).astype(np.float32)
    np.testing.assert_array_equal(pk.float().numpy(), ref_pk)
    ui = rng.uniform(-1.0, B, 200).astype(np.float32)
    vi = rng.uniform(-1.0, B, 200).astype(np.float32)
    got = P.sample_packed(pk[:B * B], B, _t(ui), _t(vi)).numpy()
    ref = np.asarray(S.sample_packed(jnp.asarray(ref_pk[:B * B]).astype(jnp.bfloat16), B,
                                     jnp.asarray(ui), jnp.asarray(vi)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_resample_and_composite_layers_match_jax():
    rng = np.random.default_rng(2)
    B, C = 24, 8
    lay = rng.random((B, B, C), np.float32)
    e_p = np.float32([-2.0, 0.4, 0.6])
    args = (e_p, np.float32(0.1), np.float32([0.0, 0.1]), np.float32([1.1, 0.9]),
            np.float32(0.7), np.float32([-0.2, 0.0]), np.float32([1.0, 1.3]))
    got = P.resample_layer(_t(lay), *args, B_out=32).numpy()
    ref = np.asarray(S.resample_layer(jnp.asarray(lay), *[jnp.asarray(a) for a in args],
                                      B_out=32))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    a, b = rng.random((2, B, B, C), np.float32)
    np.testing.assert_allclose(P.composite_layers(_t(a), _t(b)).numpy(),
                               np.asarray(S.composite_layers(jnp.asarray(a), jnp.asarray(b))),
                               rtol=0, atol=1e-7)


# --- the sweep and whole frames on carried volumes ---

def _clipmap_volumes(n=16, n_feat=3, seed=3):
    """Three eye-centred levels of smooth blobs (σ-premultiplied colour and
    features), the inner levels' regions zeroed, as bf16-valued numpy."""
    eye = np.float32([-0.9, 0.6, 0.4])
    boxes = S.clipmap_boxes(eye, *AABB, finest_extent=1.0)
    rng = np.random.default_rng(seed)
    vols = []
    for m in range(3):
        lo, hi = boxes[m]
        v = _smooth_blob(n, (0.5, 0.5, 0.5), 0.3, 20.0 / 2.0 ** m,
                         (0.8 / (m + 1), 0.3 * (m + 1) / 3, 0.5))
        if n_feat:
            feats = rng.normal(size=(n, n, n, n_feat)).astype(np.float32) * v[..., 3:4]
            v = np.concatenate([v, feats], -1)
        if m > 0:
            ilo, ihi = boxes[m - 1]
            c = [lo[a] + (np.arange(n) + 0.5) / n * (hi[a] - lo[a]) for a in range(3)]
            Pm = np.stack(np.meshgrid(*c, indexing="ij"), -1)
            v[((Pm > ilo) & (Pm < ihi)).all(-1)] = 0.0
        vols.append(np.asarray(jnp.asarray(v, jnp.bfloat16)).astype(np.float32))
    return eye, boxes, vols


def _both_volumes(vols, boxes):
    jd = S.DenseVolumes(volumes=[jnp.asarray(v, jnp.bfloat16) for v in vols],
                        res=[v.shape[0] for v in vols], n_cascades=len(vols), boxes=boxes)
    pd = P.volumes_from_numpy(vols, [v.shape[0] for v in vols], len(vols), "cpu", boxes=boxes)
    return jd, pd


def test_sweep_octave_matches_jax():
    """Every octave of the finest level and of the next (its front and back
    split at the finest level's box) swept along y at B 24: front and back
    layers within TOL."""
    eye, boxes, vols = _clipmap_volumes()
    perm = [1, 2, 0]  # the y axis first
    e_p = eye[perm]
    n = 16
    inf3 = np.full(3, np.inf, np.float32)
    least_T = 1.0
    for m in (0, 1):
        vol_t = np.transpose(vols[m], perm + [3])
        lo_p, hi_p = boxes[m, 0][perm], boxes[m, 1][perm]
        ilo, ihi = (inf3, inf3) if m == 0 else (boxes[0, 0][perm], boxes[0, 1][perm])
        for k_first, L, z_b in S._plan_octaves(float(e_p[0]), n, float(lo_p[0]),
                                               float(hi_p[0]), 1.0):
            wlo, whi = np.float32([-1.5, -1.2]), np.float32([1.8, 2.1])
            ref = S.sweep_octave(jnp.asarray(vol_t, jnp.bfloat16), jnp.asarray(e_p),
                                 jnp.float32(1.0), jnp.asarray(lo_p), jnp.asarray(hi_p),
                                 jnp.int32(k_first), jnp.float32(z_b), jnp.asarray(wlo),
                                 jnp.asarray(whi), jnp.asarray(ilo), jnp.asarray(ihi), n=n, B=24,
                                 L=L)
            got = P.sweep_octave(_t(vol_t).to(torch.bfloat16), e_p, 1.0, lo_p, hi_p, k_first,
                                 z_b, wlo, whi, ilo, ihi, n=n, B=24, L=L)
            for g, r in zip(got, ref):
                np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=TOL)
            least_T = min(least_T, float(got[0][..., 3].min()))
    assert least_T < 0.5  # the octaves composited content


@pytest.mark.parametrize("merge_layers", [True, False])
def test_render_frame_matches_jax(merge_layers):
    """Whole frames of the three-level clipmap with 3 feature channels
    (C 8), rays spanning several groups: each output channel within TOL of
    JAX's render_frame; merged also ``sweep_group_merged`` of one group."""
    eye, boxes, vols = _clipmap_volumes()
    jd, pd = _both_volumes(vols, boxes)
    dirs = _camera_dirs(eye, [0.2, 0.4, 0.5], n=9, fov_deg=100)
    bg = (0.1, 0.2, 0.3, 0.4)
    ref = np.asarray(S.render_frame(jd, eye, dirs, background=bg, B0=24, Bo=16,
                                    merge_layers=merge_layers))
    got = P.render_frame(pd, eye, _t(dirs), background=bg, B0=24, Bo=16,
                         merge_layers=merge_layers).numpy()
    assert got.shape == ref.shape == (81, 9)
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL * max(1.0, np.abs(ref).max()))
    counts, _, _ = P.group_stats(_t(dirs))
    assert (counts > 0).sum() >= 2
    assert float(ref[:, 3].max()) > 0.3


def test_sweep_group_merged_matches_jax():
    eye, boxes, vols = _clipmap_volumes(n_feat=0)
    jd, pd = _both_volumes(vols, boxes)
    perm = [0, 1, 2]
    e_p = eye[perm]
    boxes_p = boxes[:, :, perm]
    k0s = np.int32([S._host_k0(float(e_p[0]), 16, float(boxes_p[m, 0, 0]),
                               float(boxes_p[m, 1, 0]), 1.0) for m in range(3)])
    specs = tuple((16, S.static_ladder(16)) for _ in range(3))
    dlo, dhi = np.float32([-0.6, -0.5]), np.float32([0.7, 0.4])
    ref = S.sweep_group_merged(tuple(jnp.asarray(v, jnp.bfloat16) for v in vols),
                               jnp.asarray(e_p), jnp.float32(1.0), jnp.asarray(boxes_p),
                               jnp.asarray(k0s), jnp.asarray(dlo), jnp.asarray(dhi),
                               specs=specs, B0=24, Bo=16)
    got = P.sweep_group_merged([v.to(torch.bfloat16) for v in map(_t, vols)], e_p, 1.0, boxes_p,
                               k0s, dlo, dhi, specs=specs, B0=24, Bo=16)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=0, atol=TOL)
    np.testing.assert_allclose(np.float32(got[1]), np.asarray(ref[1]), rtol=1e-6)
    np.testing.assert_allclose(got[2], np.asarray(ref[2]), rtol=1e-6)
    np.testing.assert_allclose(got[3], np.asarray(ref[3]), rtol=1e-6)


# --- the port against a fine brute-force march (test_slab.py:162-254, 386) ---

def _nested(eye_inside: bool):
    n0, n1 = 32, 32
    vol0 = _smooth_blob(n0, (0.5, 0.5, 0.5), 0.25 if eye_inside else 0.3, 30.0, (0.9, 0.3, 0.1))
    vol1 = (_smooth_blob(n1, (0.85, 0.5, 0.5), 0.12, 25.0, (0.1, 0.4, 0.8)) if eye_inside else
            _smooth_blob(n1, (0.15, 0.5, 0.5), 0.2, 20.0, (0.1, 0.4, 0.8)))
    c = (np.arange(n1) + 0.5) / n1
    inner = (c > 0.25) & (c < 0.75)
    vol1[inner[:, None, None] & inner[None, :, None] & inner[None, None, :]] = 0.0
    return [vol0, vol1]


BRUTE_CASES = {
    # name: (volumes, boxes, eye, target, fov, B0, Bo, tolerance)
    "single": (lambda: [_smooth_blob(32, (0.5, 0.5, 0.5), 0.3, 40.0, (0.8, 0.4, 0.2))], None,
               [0.5, 0.5, -1.5], [0.5, 0.5, 0.5], 25, 64, 32, 0.06),
    "oblique": (lambda: [_smooth_blob(32, (0.55, 0.45, 0.5), 0.25, 30.0, (0.2, 0.7, 0.9))], None,
                [-0.9, -0.8, -0.7], [0.5, 0.5, 0.5], 40, 64, 32, 0.08),
    "nested": (lambda: _nested(False), None, [0.5, 0.5, -1.2], [0.4, 0.5, 0.5], 45, 64, 64, 0.09),
    "eye_inside_outer": (lambda: _nested(True), None, [0.5, 0.45, -0.35], [0.6, 0.5, 0.6], 50,
                         96, 96, 0.08),
    "eye_centred_boxes": (lambda: [v[..., :4] for v in _clipmap_volumes(32, 0)[2]],
                          lambda: _clipmap_volumes(32, 0)[1], [-0.9, 0.6, 0.4], [0.2, 0.4, 0.5],
                          55, 96, 96, 0.08),
}


@pytest.mark.parametrize("case", sorted(BRUTE_CASES))
def test_frames_match_a_brute_force_march(case):
    make, make_boxes, eye, target, fov, B0, Bo, tol = BRUTE_CASES[case]
    vols = make()
    boxes = make_boxes() if make_boxes else None
    jd, pd = _both_volumes(vols, boxes)
    eye = np.float32(eye)
    dirs = _camera_dirs(eye, target, n=5, fov_deg=fov)
    got = P.render_frame(pd, eye, _t(dirs), B0=B0, Bo=Bo).numpy()
    ref = _brute_force(jd, eye, dirs, n_steps=1500)
    assert np.abs(got[:, :3] - ref[:, :3]).max() < tol
    assert np.abs(got[:, 3] - (1 - ref[:, 3])).max() < tol


def test_masked_neighbours_do_not_darken():
    """An opaque white wall between empty voxels renders white (the
    σ-premultiplied colour: empty voxels weigh nothing), as the brute force
    (test_slab.py:294-319)."""
    n = 32
    vol = np.zeros((n, n, n, 4), np.float32)
    vol[:, :, 15:17, :] = 200.0
    jd, pd = _both_volumes([vol], None)
    eye = np.float32([0.5, 0.5, -1.0])
    dirs = _camera_dirs(eye, [0.5, 0.5, 0.5], n=5, fov_deg=20)
    got = P.render_frame(pd, eye, _t(dirs), B0=64, Bo=32).numpy()
    assert got[:, 3].min() > 0.95
    assert (got[:, :3] / np.maximum(got[:, 3:4], 1e-6)).min() > 0.9
    assert np.abs(got[:, :3] - _brute_force(jd, eye, dirs, n_steps=1500)[:, :3]).max() < 0.08


# --- the bake and the task ---

@pytest.fixture(scope="module")
def testbeds():
    ours = port_testbed.Testbed("nerf", device="cpu")
    ours.load_snapshot(TINY)
    theirs = JaxTestbed("nerf")
    theirs.load_snapshot(str(TINY))
    for tb in (ours, theirs):
        tb.task.slab_res0 = 32
    return ours, theirs


def test_bake_dense_matches_jax(testbeds):
    """``bake_dense`` on the snapshot's model and grid, over three clipmap
    levels (24³ and 16³; the inner levels' regions zeroed), with JAX's
    feature basis: the occupied voxels equal, every channel within two bf16
    steps of its level's largest value."""
    ours, theirs = testbeds
    eye = np.float32([0.2, 0.3, -0.4])
    boxes = S.clipmap_boxes(eye, *AABB, finest_extent=1.0)
    jt = theirs.task
    params = jt.opt.inference_params(jt.state.opt_state, jt.state.params)
    fp = jt._get_slab_feat_proj(params)
    ref = S.bake_dense(jt.model, params, np.asarray(jt.state.grid.bitfield), 1, jt.aabb_min,
                       jt.aabb_max, jt.rgb_activation, jt.density_activation, res0=24,
                       res_outer=16, boxes=boxes, feat_proj=fp)
    task = ours.task
    _, density, rgb = task._model_fns()
    got = P.bake_dense(density, rgb, task._bitfield(), 1, task.aabb_min, task.aabb_max,
                       task.rgb_activation, task.density_activation, res0=24, res_outer=16,
                       boxes=boxes, feat_proj=fp)
    assert got.res == ref.res == [24, 16, 16] and got.n_feat == 3
    for m in range(3):
        r = np.asarray(ref.volumes[m]).astype(np.float32)
        g = got.volumes[m].float().numpy()
        np.testing.assert_array_equal(g[..., 3] != 0, r[..., 3] != 0)
        scale = np.abs(r).max(axis=(0, 1, 2))
        assert np.all(np.abs(g - r).max(axis=(0, 1, 2)) <= 2 * 2.0 ** -8 * np.maximum(scale, 1))
    assert (np.asarray(ref.volumes[0])[..., 3] != 0).sum() > 100


@pytest.mark.parametrize("lens", ["perspective", "opencv"])
def test_testbed_slab_frame_matches_jax(testbeds, lens):
    """The Testbed's slab frame (shade, deferred features) at 16² ≥ 45 dB
    of the JAX Testbed's and its alpha within 1e-4, through the host plan
    (perspective) and the device-reduced plan (OpenCV)."""
    ours, theirs = testbeds
    saved = (ours.nerf_dataset.lens_mode, np.array(ours.nerf_dataset.lens_params))
    try:
        if lens == "opencv":
            params = np.float32([0.05, -0.01, 0.002, -0.001])
            ours.render_lens = Lens("opencv", params)
            theirs.nerf_dataset.lens_mode = ours.nerf_dataset.lens_mode
            theirs.nerf_dataset.lens_params = params
        frames = []
        for tb in (ours, theirs):
            tb.task._slab_cache = None
            tb.render_quality = "slab"
            tb.set_camera_to_training_view(0)
            frames.append(np.asarray(tb.render(16, 16)))
        assert _psnr(*frames) >= MIN_PSNR_DB
        np.testing.assert_allclose(frames[0][..., 3], frames[1][..., 3], rtol=0, atol=1e-4)
        assert ours.task._slab_cache[1].n_feat == 3
    finally:
        for tb in (ours, theirs):
            tb.render_quality = "exact"
        ours.render_lens = Lens(*saved)
        theirs.nerf_dataset.lens_mode, theirs.nerf_dataset.lens_params = saved


@pytest.fixture(scope="module")
def view_dependent():
    """The tiny snapshot with its rgb MLP's first layer redrawn (seeded,
    ±1.5), the feature and the direction inputs: colour that depends
    strongly on the view and on the features together."""
    tb = port_testbed.Testbed("nerf", device="cpu")
    tb.load_snapshot(TINY)
    w = tb.task.model.rgb_network.weights[0]
    rng = np.random.default_rng(4)
    with torch.no_grad():
        w.copy_(torch.from_numpy(rng.uniform(-1.5, 1.5, tuple(w.shape)).astype(np.float32)))
    tb.task.slab_res0 = 48
    return tb


def test_deferred_view_dependence_is_live(view_dependent):
    """Stricter than test_slab.py:377-383, whose bound holds even when the
    feature path does nothing: on a model with view-dependent colour the
    deferred frame's MSE against the exact frame is below 0.9 times the
    diffuse bake's, and zeroing the feature channels changes the frame."""
    task = view_dependent.task
    xf = np.asarray(task.dataset.xforms_start[0], np.float32)
    exact = task.render(24, 24, xf).numpy()[..., :3]
    task.slab_deferred_vd, task._slab_cache = True, None
    deferred = task.render(24, 24, xf, render_quality="slab").numpy()[..., :3]
    dvols = task._slab_cache[1]
    assert dvols.n_feat == 3
    Pm = dvols.feat_proj[2]
    np.testing.assert_allclose(Pm.T @ Pm, np.eye(3), atol=1e-4)
    saved = [v.clone() for v in dvols.volumes]
    for v in dvols.volumes:
        v[..., 4:] = 0
    dvols.vt_cache = None  # the sweep reads the transposed copies
    zeroed = task.render(24, 24, xf, render_quality="slab").numpy()[..., :3]
    dvols.volumes[:] = saved
    task.slab_deferred_vd, task._slab_cache = False, None
    diffuse = task.render(24, 24, xf, render_quality="slab").numpy()[..., :3]
    task.slab_deferred_vd, task._slab_cache = True, None
    mse_def = float(np.mean((deferred - exact) ** 2))
    mse_diff = float(np.mean((diffuse - exact) ** 2))
    assert mse_def < 0.9 * mse_diff, (mse_def, mse_diff)
    assert float(np.abs(zeroed - deferred).max()) > 1e-2, float(np.abs(zeroed - deferred).max())


def test_slab_ignores_spp_and_the_modes_take_the_exact_path(testbeds):
    """As in the JAX package: the slab frame is the same at spp 1 and 4; a
    G-buffer mode with quality "slab" or "baked" is the exact frame; a mesh
    on the task without an initialised process group raises (no unsharded
    frame under a mesh; the sharded warp is test_torch_sharding.py's)."""
    task = testbeds[0].task
    xf = np.asarray(task.dataset.xforms_start[0], np.float32)
    a = task.render(8, 8, xf, render_quality="slab")
    assert torch.equal(a, task.render(8, 8, xf, render_quality="slab", spp=4))
    depth = task.render(8, 8, xf, render_mode="depth")
    for q in ("slab", "baked"):
        assert torch.equal(task.render(8, 8, xf, render_mode="depth", render_quality=q), depth)
    task.mesh = object()
    try:
        with pytest.raises(RuntimeError, match="process group"):
            task.render(8, 8, xf, render_quality="slab")
    finally:
        task.mesh = None


@pytest.mark.parametrize("which", ["O", "P"])
def test_wrappers_do_not_fall_back_off_the_cpu(which):
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="CUDA"):
        if which == "O":
            z = torch.zeros((6, 1), device=meta)
            w = torch.zeros((6, 1, 2), device=meta)
            P.warp_composite(torch.zeros((8, 3), device=meta), np.zeros(3, np.float32),
                             torch.zeros((1, 20), dtype=torch.bfloat16, device=meta),
                             torch.zeros((6 * 16, 20), dtype=torch.bfloat16, device=meta), z, w, w,
                             torch.zeros(4, device=meta), B0=4, Bo=2, nc=1)
        else:
            lay = torch.zeros((4, 4, 8), device=meta)
            P.slab_step(torch.zeros((2, 4, 7, 4), device=meta), torch.zeros(2, device=meta), 0.1,
                        torch.zeros((4, 4), device=meta), torch.zeros((4, 4), device=meta), lay,
                        lay.clone())
