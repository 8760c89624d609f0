"""``NerfTask.render`` at spp > 1 (sample 0 at the pixel centre, sample s ≥ 1
offset by (halton(s, 2), halton(s, 3)); rgb and alpha summed in sample
order, scaled by 1/spp, then the background blended), with a ``uv_warp_fn``
and with backgrounds, against the JAX package's ``task.render`` on the tiny
fixture, on the CPU. Tolerance: tests/test_torch_render.py's 45 dB."""

from pathlib import Path

import numpy as np
import pytest
import torch

from instant_ngp_tpu.render.foveation import Foveation as JaxFoveation
from instant_ngp_tpu.testbed import Testbed as JaxTestbed
from instant_ngp_torch.nerf.task import halton
from instant_ngp_torch import testbed as port_testbed
from instant_ngp_torch.render.foveation import Foveation

torch.set_num_threads(2)

TINY = Path(__file__).resolve().parent / "fixtures" / "tiny_nerf.ingp"
MIN_PSNR_DB = 45.0  # tests/test_torch_render.py's render tolerance
W, H = 24, 16


def _psnr(a, b):
    mse = float(np.mean((np.clip(a, 0, 1) - np.clip(b, 0, 1)) ** 2))
    return -10.0 * np.log10(max(mse, 1e-12))


@pytest.fixture(scope="module")
def pair():
    ours = port_testbed.Testbed(device="cpu")
    ours.load_snapshot(TINY)
    theirs = JaxTestbed()
    theirs.load_snapshot(str(TINY))
    ds = ours.nerf_dataset
    # a fov, not the view's focal lengths: the JAX render compiles its ray
    # generation anew for each call given np.float32 intrinsics (~5 s)
    kw = dict(fov=40.0, principal_point=(0.45, 0.55))
    return ours.task, theirs.task, np.asarray(ds.xforms_start[0], np.float32), kw


CASES = {
    "spp1": dict(spp=1),
    "spp2_background": dict(spp=2, background=(0.2, 0.4, 0.6, 1.0)),
    "spp8": dict(spp=8),
    "spp4_half_alpha_background_srgb": dict(spp=4, background=(1.0, 1.0, 1.0, 0.5), to_srgb=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_render_at_spp_equals_jax(pair, case):
    ours, theirs, xf, kw = pair
    args = {**kw, **CASES[case]}
    frame = ours.render(W, H, xf, **args).numpy()
    ref = np.asarray(theirs.render(W, H, xf, **args))
    assert frame.shape == ref.shape == (H, W, 4) and frame.dtype == np.float32
    assert _psnr(frame, ref) >= MIN_PSNR_DB
    assert np.abs(frame[..., 3] - ref[..., 3]).max() <= 1e-3


@pytest.mark.parametrize("spp", [1, 2])
def test_render_with_a_uv_warp_equals_jax(pair, spp):
    """The foveation warp maps each sample's uv before ray generation."""
    ours, theirs, xf, kw = pair
    warp = Foveation.make(steepness=(2.0, 3.0), focus=(0.4, 0.6), radius=(0.2, 0.25)).warp
    jax_warp = JaxFoveation.make(steepness=(2.0, 3.0), focus=(0.4, 0.6), radius=(0.2, 0.25)).warp
    frame = ours.render(W, H, xf, spp=spp, uv_warp_fn=warp, **kw).numpy()
    ref = np.asarray(theirs.render(W, H, xf, spp=spp, uv_warp_fn=jax_warp, **kw))
    plain = ours.render(W, H, xf, spp=spp, **kw).numpy()
    assert _psnr(frame, ref) >= MIN_PSNR_DB
    assert np.abs(frame - plain).max() > 1e-3  # the warp moved the rays


def test_render_depth_at_spp_equals_jax(pair):
    ours, theirs, xf, kw = pair
    frame, depth = ours.render(W, H, xf, spp=2, return_depth=True, **kw)
    ref, ref_depth = theirs.render(W, H, xf, spp=2, return_depth=True, **kw)
    assert depth.shape == (H, W)
    assert _psnr(frame.numpy(), np.asarray(ref)) >= MIN_PSNR_DB
    np.testing.assert_allclose(depth.numpy(), np.asarray(ref_depth), atol=1e-3)


def test_samples_sum_in_order_then_the_background():
    """spp 2 on a background equals (sample 0 + sample 1) / 2 on transparent
    black, then the blend, to the bit; the samples are the Halton offsets."""
    tb = port_testbed.Testbed(device="cpu")
    tb.load_snapshot(TINY)
    task, ds = tb.task, tb.nerf_dataset
    xf, bg = ds.xforms_start[0], (0.25, 0.5, 0.75, 1.0)
    kw = dict(focal_length=tuple(ds.focal_lengths[0]), principal_point=(0.5, 0.5))
    offsets = iter([(0.5, 0.5), (halton(1, 2), halton(1, 3))])
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    xs, ys = xs.reshape(-1).astype(np.float32), ys.reshape(-1).astype(np.float32)

    def shift(uv):  # one sample's uv at the next offset, as render forms it
        off = next(offsets)
        return np.stack([(xs + off[0]) / W, (ys + off[1]) / H], -1).astype(np.float32)

    frames = [task.render(W, H, xf, uv_warp_fn=shift, **kw) for _ in range(2)]
    rgb = (frames[0][..., :3] + frames[1][..., :3]) * 0.5
    alpha = (frames[0][..., 3] + frames[1][..., 3]) * 0.5
    expect = rgb + (1.0 - alpha)[..., None] * torch.tensor(bg[:3]) * bg[3]
    out = task.render(W, H, xf, spp=2, background=bg, **kw)
    assert halton(1, 2) == 0.5 and halton(1, 3) == 1 / 3 and halton(2, 2) == 0.25
    assert torch.equal(out[..., 3], alpha) and torch.equal(out[..., :3], expect)


def test_other_render_modes_wait_for_queue_1_item_2(pair):
    """The render modes besides shade no longer wait for Queue 1 item 2:
    the depth mode at spp 2 (each sample's depth in rgb, averaged, no
    background) against JAX's (tests/test_torch_render_modes.py holds every
    mode); nor does the slab quality wait for item 3: as in the JAX package
    it ignores spp (tests/test_torch_slab.py holds it against JAX)."""
    ours, theirs, xf, kw = pair
    frame = ours.render(W, H, xf, spp=2, render_mode="depth", background=(1, 1, 1, 1),
                        **kw).numpy()
    ref = np.asarray(theirs.render(W, H, xf, spp=2, render_mode="depth",
                                   background=(1, 1, 1, 1), **kw))
    assert _psnr(frame, ref) >= MIN_PSNR_DB
    _, depth = ours.render(W, H, xf, spp=2, return_depth=True, **kw)
    np.testing.assert_array_equal(frame[..., 0], depth.numpy())
    saved, ours.slab_res0 = ours.slab_res0, 32
    try:
        slab = ours.render(W, H, xf, render_quality="slab", **kw)
        assert torch.equal(slab, ours.render(W, H, xf, render_quality="slab", spp=2, **kw))
    finally:
        ours.slab_res0 = saved
    assert bool(torch.isfinite(slab).all()) and slab.shape == (H, W, 4)
