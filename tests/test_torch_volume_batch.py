"""The volume primitive's training batch in the PyTorch port against the JAX
package on the CPU: ``tracking.generate_batch`` (kernel L's plain version on
CPU tensors) against ``VolumeTask._generate_batch`` on the JAX package's own
draws, and what kernel L's wrapper hands the card.

A path is chaotic: one ulp in a free flight's ``log(1 − ζ)``, a norm or a
slab test moves its position, and where that moves it across a bitgrid cell
or a voxel, or past a collision threshold, the rest of the path parts from
JAX's. XLA's CPU ``log`` differs from PyTorch's by an ulp on ~15 % of inputs,
and XLA fuses ``a·b + c`` into FMAs, which the port (like kernel L) does
not. So the comparison is a share of paths: a path agrees where its 4
vertices have the JAX path's valid flags and, where valid, positions and
targets within ``TOL_PATH`` (relative, 1e-5: about 100 f32 ulps, the
distance a few ulp-sized differences in ~200 free flights build up) and
``TOL_PATH`` / 10 absolute. At least ``MIN_AGREE`` of all paths, and of the
paths that recorded a vertex, must agree."""

import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from instant_ngp_torch import cuda_lib
from instant_ngp_torch.io.nanovdb import procedural_fog_volume
from instant_ngp_torch.volume import tracking
from instant_ngp_torch.volume.task import VolumeTask
from torch_volume_common import jax_batch_draws, path_agreement, task_pair, tiny_config

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
TOL_PATH = 1e-5
MIN_AGREE = 0.99


@pytest.mark.parametrize("res,batch,seed", [(16, 4096, 3), (32, 1024, 5), (32, 4096, 7)])
def test_batch_matches_jax_on_its_draws(res, batch, seed):
    """The port's batch on the JAX draws of ``_generate_batch(PRNGKey(seed))``
    against that batch: the share of agreeing paths, the valid flags and
    the vertex counts of the agreeing paths."""
    grid = procedural_fog_volume(res)
    theirs, ours = task_pair(grid, batch_size=batch)
    key = jax.random.PRNGKey(seed)
    ref = [np.asarray(a) for a in jax.jit(theirs._generate_batch)(key, theirs.density_grid)]
    draws = jax_batch_draws(key, batch // 4)
    assert tuple(draws.first.shape) == (6, batch // 4)
    assert tuple(draws.per_iter.shape) == (192, 14, batch // 4)
    out = [a.numpy() for a in ours.generate_batch(draws)]
    assert [a.shape for a in out] == [a.shape for a in ref] == [(batch, 3), (batch, 4), (batch,)]
    agree = path_agreement(out, ref, TOL_PATH, TOL_PATH / 10)
    recorded = ref[2].reshape(-1, 4).any(-1)
    assert recorded.sum() >= 10
    assert agree.mean() >= MIN_AGREE and agree[recorded].mean() >= MIN_AGREE, (
        agree.mean(), agree[recorded].mean())
    counts = out[2].reshape(-1, 4).sum(-1)
    np.testing.assert_array_equal(counts[agree], ref[2].reshape(-1, 4).sum(-1)[agree])
    # the agreeing paths at the bit: most of them (an ulp shows up late, if at all)
    exact = path_agreement(out, ref, 0.0, 0.0)
    assert exact.mean() >= 0.8, exact.mean()


def test_batch_invariants_on_the_ports_draws():
    """On the port's own draws (a seeded generator): valid slots are a
    prefix of each path's 4; empty slots are zero; a vertex lies inside the
    box, in an occupied bitgrid cell, with a density the grid holds and a
    non-negative rgb target; a seed gives the same batch twice."""
    grid = procedural_fog_volume(32)
    task = VolumeTask(grid, tiny_config(), device="cpu", batch_size=8192)
    gen = torch.Generator().manual_seed(4)
    draws = tracking.draw_batch(gen, 2048)
    assert draws.first.dtype == draws.per_iter.dtype == torch.float32
    u = draws.per_iter[:, [0, 1, 2, 3, 4, 11, 12, 13]]
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    n = draws.per_iter[:, 5:11]
    assert abs(float(n.mean())) < 0.01 and abs(float(n.std()) - 1.0) < 0.01
    pts, tgt, valid = task.generate_batch(draws)
    again = tracking.generate_batch_plain(task, tracking.draw_batch(
        torch.Generator().manual_seed(4), 2048))
    for a, b in zip((pts, tgt, valid), again):
        assert torch.equal(a, b)
    v = valid.reshape(-1, 4)
    assert bool((v[:, 1:] <= v[:, :-1]).all())  # a prefix
    assert 0.05 < float(valid.float().mean()) < 1.0
    assert bool((pts[~valid] == 0).all() and (tgt[~valid] == 0).all())
    p = pts[valid]
    assert bool(((p >= task.aabb_min_t) & (p <= task.aabb_max_t)).all())
    assert bool(task._bitgrid_at(p).all())
    assert bool(torch.isin(tgt[valid, 3], task.density_grid.reshape(-1)).all())
    assert bool((tgt[valid, :3] >= 0).all()) and bool((tgt[valid, :3] > 0).any())


def test_wrappers_do_not_fall_back_off_the_cpu():
    """Tensors that are neither on the CPU nor on the card raise: the
    wrappers run their plain versions for CPU tensors only."""
    task = VolumeTask(procedural_fog_volume(16), tiny_config(), device="cpu")
    meta = torch.device("meta")
    draws = tracking.BatchDraws(torch.zeros((6, 8), device=meta),
                                torch.zeros((192, 14, 8), device=meta))
    with pytest.raises(ValueError, match="CUDA"):
        tracking.generate_batch(task, draws)
    with pytest.raises(ValueError, match="CUDA"):
        tracking.trace_gt(task, torch.zeros((8, 3), device=meta), torch.zeros((8, 3), device=meta),
                          torch.zeros((256, 5, 8), device=meta))


def test_card_tensors_reach_kernels_l_and_m(monkeypatch):
    """With card tensors (meta stands for them) each wrapper launches its
    kernel once, with the path and iteration counts, and runs no plain
    version."""
    calls = []
    monkeypatch.setattr(cuda_lib, "check_cuda", lambda *t, dtype=None: None)
    monkeypatch.setattr(cuda_lib, "launch", lambda name, *args: calls.append((name, args)))
    monkeypatch.setattr(tracking, "generate_batch_plain", None)
    monkeypatch.setattr(tracking, "trace_gt_plain", None)
    task = VolumeTask(procedural_fog_volume(16), tiny_config(), device="cpu")
    meta = torch.device("meta")
    draws = tracking.BatchDraws(torch.zeros((6, 300), device=meta),
                                torch.zeros((192, 14, 300), device=meta))
    pts, tgt, valid = tracking.generate_batch(task, draws)
    assert (tuple(pts.shape), tuple(tgt.shape), tuple(valid.shape)) == ((1200, 3), (1200, 4),
                                                                        (1200,))
    assert valid.dtype == torch.bool
    rgb, alpha = tracking.trace_gt(task, torch.zeros((77, 3), device=meta),
                                   torch.zeros((77, 3), device=meta),
                                   torch.zeros((256, 5, 77), device=meta))
    assert tuple(rgb.shape) == (77, 3) and tuple(alpha.shape) == (77,)
    assert [name for name, _ in calls] == ["volume_generate_batch", "volume_trace_gt"]
    assert calls[0][1][6:8] == (300, 192) and calls[1][1][7:9] == (77, 256)
    with pytest.raises(ValueError, match="draws"):
        tracking.trace_gt(task, torch.zeros((77, 3), device=meta),
                          torch.zeros((77, 3), device=meta), torch.zeros((256, 5, 76), device=meta))


def test_kernel_constants_layout_matches_the_source():
    """``_params_c``'s float[25] holds each constant where ``csrc/volume.cu``'s
    ``make_params`` reads it."""
    src = (ROOT / "instant_ngp_torch" / "csrc" / "volume.cu").read_text()
    body = src[src.index("Params make_params"):src.index('extern "C"')]
    vecs = {name: int(i or 0)
            for name, i in re.findall(r"p\.(\w+)\[k\] = f\[(?:(\d+) \+ )?k\]", body)}
    scalars = dict(re.findall(r"p\.(\w+) = f\[(\d+)\]", body))
    task = VolumeTask(np.random.default_rng(2).random((8, 16, 24)).astype(np.float32) * 3,
                      tiny_config(), device="cpu")
    values, res = tracking._params_c(task)
    f = np.array(values[:], np.float32)
    want = {"amin": task.aabb_min, "amax": task.aabb_max, "inv_extent": task.inv_extent,
            "up": task.up_dir, "sun": task.sun_dir, "sky": task.sky_col,
            "suncol": tracking.SUN_COLOR}
    assert sorted(vecs) == sorted(want) and len(f) == 25
    for name, v in want.items():
        i = int(vecs[name])
        np.testing.assert_array_equal(f[i:i + 3], np.asarray(v, np.float32), err_msg=name)
    want = {"scale": task.scale, "inv_majorant": task.inv_majorant, "albedo": task.albedo,
            "scattering": task.scattering}
    assert sorted(scalars) == sorted(want)
    for name, v in want.items():
        assert f[int(scalars[name])] == np.float32(v), name
    assert list(res) == [8, 16, 24]
    assert task.inv_majorant == float(np.float32(1) / np.float32(task.global_majorant))


def _poison_unread(census: tracking.ReadCensus, name: str, t: torch.Tensor, value) -> torch.Tensor:
    """A copy of t with every element outside the sectors the census marked
    under ``name`` set to value."""
    per = census.SECTOR_BYTES // t.element_size()
    kept = census.touched[name].repeat_interleave(per)[:t.numel()].reshape(t.shape)
    return torch.where(kept, t, torch.as_tensor(value, dtype=t.dtype))


@pytest.mark.parametrize("kernel", ["L", "M"])
def test_census_covers_every_read(kernel):
    """``tracking.ReadCensus``, which ``chip_smoke.py``'s bounds of kernels L
    and M count from, marks every draw, grid value and bitgrid cell the
    function's result depends on: with all the draws and grid values outside
    the marked sectors NaN and all those bitgrid cells flipped, the plain
    version gives the same result bit for bit. And it leaves most of the
    draws unread, so the check has something to poison."""
    grid = procedural_fog_volume(32)
    task = VolumeTask(grid, tiny_config(), device="cpu", batch_size=4096)
    gen = torch.Generator().manual_seed(11)
    census = tracking.ReadCensus()
    if kernel == "L":
        draws = tracking.draw_batch(gen, 1024)
        ref = tracking.generate_batch_plain(task, draws, census)
        per_iter = _poison_unread(census, "draws", draws.per_iter, float("nan"))
        all_draws = draws.per_iter
        poisoned = tracking.BatchDraws(draws.first, per_iter)
        run = lambda t: tracking.generate_batch_plain(t, poisoned)  # noqa: E731
    else:
        side = 32
        cam = np.array([[1, 0, 0, 0.5], [0, 1, 0, 0.5], [0, 0, 1, -1.2]], np.float32)
        from instant_ngp_torch.render.camera import pinhole_rays

        o, d = pinhole_rays(side, side, cam, 50.0, "cpu")
        all_draws = tracking.draw_gt(gen, side * side)
        ref = tracking.trace_gt_plain(task, o, d, all_draws, census)
        poisoned = _poison_unread(census, "draws", all_draws, float("nan"))
        run = lambda t: tracking.trace_gt_plain(t, o, d, poisoned)  # noqa: E731
    counts = census.counts
    assert counts["event"] > 0 and counts["scatter"] > 0, counts
    read = census.bytes_read()
    assert read["draws"] < 0.5 * all_draws.numel() * 4, read
    task.density_grid = _poison_unread(census, "grid", task.density_grid, float("nan"))
    task.bitgrid = task.bitgrid ^ _poison_unread(census, "bitgrid",
                                                 torch.zeros_like(task.bitgrid), 1)
    out = run(task)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
