"""The PyTorch port's NeRF model and whole snapshot render against the JAX
package, on the CPU (plain versions of all four kernels)."""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from instant_ngp_tpu.models.nerf_network import NerfNetwork as JaxNerfNetwork
from instant_ngp_tpu.testbed import Testbed as JaxTestbed
from instant_ngp_torch.models.nerf_network import NerfNetwork, params_from_jax, params_to_numpy
from instant_ngp_torch import testbed as port_testbed
from instant_ngp_torch.common import fma

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = {"tiny": ROOT / "tests" / "fixtures" / "tiny_nerf.ingp",
            "fox": ROOT / "data" / "fox_1536.ingp"}
# PSNR of the port's 32x32 frame against the JAX package's, measured on
# this test's inputs: tiny 112.4 dB, fox 84.8 dB (the JAX renderer reads
# bf16 "bricks" for dense levels, the port the f32 tables).
MIN_PSNR_DB = 45.0
# rays of the 32x32 frame that start outside the aabb, measured on the CPU
LOST_RAYS = {"tiny": 552, "fox": 0}


def _psnr(a, b):
    mse = float(np.mean((np.clip(a[..., :3], 0, 1) - np.clip(b[..., :3], 0, 1)) ** 2))
    return -10.0 * np.log10(max(mse, 1e-12))


@pytest.mark.parametrize("name", ["tiny", "fox"])
def test_nerf_network_equals_jax(name):
    doc = port_testbed.Testbed("nerf", device="cpu")
    doc.load_snapshot(FIXTURES[name])  # for the config and its autoconfigured encoding
    config = doc.task.config
    ours = NerfNetwork.from_config(config)
    theirs = JaxNerfNetwork.from_config(config)
    rng = np.random.default_rng(31)
    tree = params_to_numpy(ours)
    tree["density_net"] = [(rng.standard_normal(w.shape) * np.sqrt(2 / w.shape[0])).astype(np.float32)
                           for w in tree["density_net"]]
    tree["rgb_net"] = [(rng.standard_normal(w.shape) * np.sqrt(2 / w.shape[0])).astype(np.float32)
                       for w in tree["rgb_net"]]
    tree["pos_enc"] = tuple(rng.uniform(-1, 1, t.shape).astype(np.float32) for t in tree["pos_enc"])
    params_from_jax(ours, tree)
    pos = rng.random((2048, 3), dtype=np.float32)
    dirs = rng.random((2048, 3), dtype=np.float32)
    ref = np.asarray(jax.jit(lambda p, x, d: theirs(p, x, d))(tree, pos, dirs), np.float32)
    out = ours(torch.from_numpy(pos), torch.from_numpy(dirs)).detach().numpy()
    assert out.shape == (2048, 4)
    # bf16 compute on both sides; only f32 summation order differs
    np.testing.assert_allclose(out, ref, rtol=1e-2, atol=1e-3)


def _view0_frames(name, res=32):
    """The snapshot's view 0 at res^2 with bench.py bench_render_fox's
    arguments, rendered by both packages: (port task, camera, render
    arguments, port frame, JAX frame)."""
    ours = port_testbed.Testbed("nerf", device="cpu")
    ours.load_snapshot(FIXTURES[name])
    theirs = JaxTestbed("nerf")
    theirs.load_snapshot(str(FIXTURES[name]))
    ds = ours.nerf_dataset
    w, h = ds.resolution
    xf = np.asarray(ds.xforms_start[0], np.float32)
    kw = dict(focal_length=(ds.focal_lengths[0, 0] * res / w, ds.focal_lengths[0, 1] * res / h),
              principal_point=tuple(ds.principal_points[0]), background=(0, 0, 0, 0))
    frame = ours.task.render(res, res, xf, **kw).numpy()
    ref = np.asarray(theirs.task.render(res, res, xf, **kw))
    return ours.task, xf, kw, frame, ref


@pytest.mark.parametrize("name", ["tiny", "fox"])
def test_snapshot_render_matches_jax(name):
    res = 32
    _, _, _, frame, ref = _view0_frames(name, res)
    assert frame.shape == ref.shape == (res, res, 4)
    assert np.isfinite(frame).all()
    assert frame[..., 3].mean() > 0.05
    assert _psnr(frame, ref) >= MIN_PSNR_DB


@pytest.mark.parametrize("name", ["tiny", "fox"])
def test_render_rays_start_on_the_crop_box_face_as_in_jax(name):
    """Known reference defect, matched on purpose (ROADMAP.md Queue 3): a
    render ray starts exactly at its crop-box entry; where its first
    position o + t·d rounds to just outside the aabb the march stops and the
    pixel renders transparent. Both packages lose those rays. The tiny
    fixture's camera lies outside its aabb, fox's inside (none lost)."""
    res = 32
    task, xf, kw, frame, ref = _view0_frames(name, res)
    ys, xs = torch.meshgrid(torch.arange(res), torch.arange(res), indexing="ij")
    uv = torch.stack([(xs.reshape(-1) + 0.5) / res, (ys.reshape(-1) + 0.5) / res], -1).float()
    o, d, tmin, tmax = task._prep_rays(uv, task._t([res, res]), task._t(kw["focal_length"]),
                                       task._t(kw["principal_point"]), task._t(xf))
    amin, amax = task._aabb_t
    start = fma(tmin[:, None], d, o)
    outside = ~torch.all((start >= amin) & (start <= amax), dim=-1)
    lost = ((tmax > tmin) & outside).numpy().reshape(res, res)
    assert int(lost.sum()) == LOST_RAYS[name]
    assert (frame[..., 3][lost] == 0).all() and (ref[..., 3][lost] == 0).all()
