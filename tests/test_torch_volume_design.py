"""The premises of kernels L and M's design (``csrc/volume.cu``), on the CPU.

The kernels walk each path (ray) a window of ``kWindow`` iterations at a
time, inside ring stages of ``kStage`` iterations: they compute the window's
positions along the current direction at once, read the bitgrid and grid at
all of them, and walk them in order up to the first iteration that turns the
path or ends its attempt; the next window starts after it. The mirrors below
do the same with the plain versions' tensor ops, all paths at once (each at
its own iteration), and must give the plain versions' results bit for bit
on the JAX package's own draws: the windows' positions are the sequential
ones, and a cut restarts where the plain loop goes on. The draws the kernels
stage (the first rows of every iteration of the stages a thread fills) and
those they read at their use must cover every draw the plain version reads
(``tracking.ReadCensus``)."""

import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from instant_ngp_torch import cuda_lib
from instant_ngp_torch.bench.volume_kernels import kernel_constants, staged_iterations
from instant_ngp_torch.io.nanovdb import procedural_fog_volume
from instant_ngp_torch.ops.raymarch import ray_intersect_aabb
from instant_ngp_torch.render.camera import pinhole_rays
from instant_ngp_torch.volume import tracking
from instant_ngp_torch.volume.task import VolumeTask
from instant_ngp_torch.volume.tracking import (JITTER, RESPAWN_NORMAL, RESPAWN_UNIFORM, SCATTER,
                                               ZETA1, ZETA2)
from torch_volume_common import jax_batch_draws, jax_gt_draws, tiny_config

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
K = kernel_constants(ROOT)
W, S = K["kWindow"], K["kStage"]
CAMERA = np.array([[1, 0, 0, 0.5], [0, 1, 0, 0.5], [0, 0, 1, -1.2]], np.float32)


def new_stats() -> dict:
    return {k: 0 for k in ("passes", "bitgrid", "grid", "bitgrid_used", "grid_used", "scatter",
                           "escape", "absorb", "respawn")}


def staged_mask(live, shape, rows: int, stage: int, depth: int) -> torch.Tensor:
    """A bool tensor of draws' ``shape`` (n_iters, rows an iteration, n):
    the elements the kernel stages, rows below ``rows`` of the iterations
    each path's thread fills (``staged_iterations``)."""
    n_iters = shape[0]
    upto = staged_iterations(live, n_iters, stage, depth)
    mask = torch.zeros(shape, dtype=torch.bool)
    mask[:, :rows] = (torch.arange(n_iters)[:, None] < upto[None, :])[:, None, :]
    return mask


def mark_rows(reads, draws: torch.Tensor, iters: torch.Tensor, rows, mask: torch.Tensor) -> None:
    """Marks rows of draws (n_iters, n_rows, n) at each masked path's own
    iteration iters (n,)."""
    if reads is None or not bool(mask.any()):
        return
    p = torch.nonzero(mask)[:, 0]
    r = torch.as_tensor(list(rows))
    flat = (iters[p][None, :] * draws.shape[1] + r[:, None]) * draws.shape[2] + p[None, :]
    reads.read("draws", draws, flat.reshape(-1))


def window_slots(start: torch.Tensor, m: int, act: torch.Tensor, j: int):
    """(each path's slot start + j clamped into the stage, whether it is walked
    this pass: a live path's slot before m)."""
    return torch.clamp(start + j, max=m - 1), act & (start + j < m)


def walk_batch(task, draws, reads=None, stats=None):
    """Kernel L's walk in tensor ops → (pts, tgt, valid, each path's live
    iterations). ``reads`` marks what the walk reads beside the staged rows
    (the rows read at their use, every lookup it issues), ``stats`` counts
    passes, lookups and cuts."""
    stats = new_stats() if stats is None else stats
    V = tracking.MAX_TRAIN_VERTICES
    first, it = draws.first, draws.per_iter
    n, n_iters = draws.n_paths, it.shape[0]
    ar = torch.arange(n)
    pos, dirs = tracking._spawn(task, first[:3].T, first[3:].T)
    done = torch.zeros(n, dtype=torch.bool)
    n_rec = torch.zeros(n, dtype=torch.int32)
    pend_from = torch.zeros(n, dtype=torch.int32)
    rec_pos = torch.zeros((n, V, 3))
    rec_den = torch.zeros((n, V))
    rec_rgb = torch.zeros((n, V, 3))
    iota_v = torch.arange(V, dtype=torch.int32)[None, :]
    live = torch.zeros(n, dtype=torch.int32)

    def finalize(rec_rgb, dirs, throughput):
        radiance = (tracking.proc_envmap(dirs, task.up_dir, task.sun_dir, task.sky_col)
                    * throughput[:, None])
        pend = (iota_v >= pend_from[:, None]) & (iota_v < n_rec[:, None])
        return torch.where(pend[..., None], radiance[:, None, :], rec_rgb)

    for s in range(-(-n_iters // S)):
        it0 = s * S
        d = it[it0:it0 + S]
        m = d.shape[0]
        # each iteration's free flight, as the plain version computes its row
        dt = torch.stack([-torch.log(1.0 - d[j, ZETA1]) * task.scale for j in range(m)])
        start = torch.zeros(n, dtype=torch.int64)
        while True:
            act = ~done & (start < m)
            if not bool(act.any()):
                break
            stats["passes"] += int(act.sum())
            c, w, inn, occ, den, zeta2, slots = pos, [], [], [], [], [], []
            for j in range(W):  # the window along the current direction
                slot, on = window_slots(start, m, act, j)
                c = torch.where(on[:, None], c + dirs * dt[slot, ar][:, None], c)
                w.append(c)
                inn.append(on & tracking._inside(task, c))
                occ.append(inn[j] & task._bitgrid_at(c))
                vox = task._jittered_index(c, d[slot, :, ar][:, JITTER:ZETA2])
                flat, inb = task._voxel(vox)
                den.append(torch.where(occ[j], task._take(vox), 0.0))
                zeta2.append(d[slot, ZETA2, ar])
                slots.append(slot)
                stats["bitgrid"] += int(inn[j].sum())
                stats["grid"] += int((occ[j] & inb).sum())
                if reads is not None:
                    reads.read("bitgrid", task.bitgrid, task._bitgrid_cell(c[inn[j]]))
                    reads.read("grid", task.density_grid, flat[occ[j] & inb])
            nxt = torch.clamp(m - start, max=W)
            for j in range(W):  # the walk, up to the first cut
                walk = act & (start + j < m) & (j < nxt)
                live += walk.to(torch.int32)
                stats["bitgrid_used"] += int((walk & inn[j]).sum())
                stats["grid_used"] += int((walk & occ[j]).sum())
                pos = torch.where(walk[:, None], w[j], pos)
                ev = walk & occ[j]
                record = ev & (n_rec < V)
                at = record[:, None] & (iota_v == torch.clamp(n_rec, 0, V - 1)[:, None])
                rec_pos = torch.where(at[..., None], pos[:, None, :], rec_pos)
                rec_den = torch.where(at, den[j][:, None], rec_den)
                n_rec = n_rec + record.to(torch.int32)
                extinction = torch.where(ev, den[j] * task.inv_majorant, 0.0)
                scatter_prob = extinction * task.albedo
                real = ev & (zeta2[j] < extinction)
                scatter = real & (zeta2[j] < scatter_prob)
                absorb = real & ~scatter
                row = d[slots[j], :, ar]
                nd = row[:, SCATTER:RESPAWN_NORMAL]
                new_dir = dirs * task.scattering + nd / tracking.norm3(nd)[:, None]
                new_dir = new_dir / tracking.norm3(new_dir)[:, None]
                dirs = torch.where(scatter[:, None], new_dir, dirs)
                died = walk & (~inn[j] | absorb)
                thr = torch.where(absorb, 0.0, 1.0)
                rec_rgb = torch.where(died[:, None, None], finalize(rec_rgb, dirs, thr), rec_rgb)
                pend_from = torch.where(died, n_rec, pend_from)
                done = done | (died & (n_rec >= V))
                respawn = died & ~done
                s_pos, s_dirs = tracking._spawn(task, row[:, RESPAWN_NORMAL:RESPAWN_UNIFORM],
                                                row[:, RESPAWN_UNIFORM:])
                pos = torch.where(respawn[:, None], s_pos, pos)
                dirs = torch.where(respawn[:, None], s_dirs, dirs)
                nxt = torch.where(scatter | died, j + 1, nxt)
                for key, mask in (("scatter", scatter), ("escape", walk & ~inn[j]),
                                  ("absorb", absorb), ("respawn", respawn)):
                    stats[key] += int(mask.sum())
                mark_rows(reads, it, it0 + slots[j], range(SCATTER, RESPAWN_NORMAL), scatter)
                mark_rows(reads, it, it0 + slots[j], range(RESPAWN_NORMAL, RESPAWN_UNIFORM + 3),
                          respawn)
            start = torch.where(act, start + nxt, start)
    rec_rgb = finalize(rec_rgb, dirs, torch.ones(n))
    B = n * V
    tgt = torch.cat([rec_rgb.reshape(B, 3), rec_den.reshape(B, 1)], -1)
    return rec_pos.reshape(B, 3), tgt, (iota_v < n_rec[:, None]).reshape(B), live


def walk_gt(task, o, d, draws, reads=None, stats=None):
    """Kernel M's walk in tensor ops → (rgb, alpha, each ray's live
    iterations); ``reads`` and ``stats`` as ``walk_batch``'s."""
    stats = new_stats() if stats is None else stats
    R, n_iters = o.shape[0], draws.shape[0]
    ar = torch.arange(R)
    tmin, tmax = ray_intersect_aabb(o, d, task.aabb_min_t, task.aabb_max_t)
    alive = tmax > tmin
    pos = o + tmin[:, None] * d
    dirs = d
    absorbed = torch.zeros(R, dtype=torch.bool)
    scattered = torch.zeros_like(absorbed)
    live = torch.zeros(R, dtype=torch.int32)
    for s in range(-(-n_iters // S)):
        it0 = s * S
        dr = draws[it0:it0 + S]
        m = dr.shape[0]
        dt = torch.stack([-torch.log(dr[j, 0]) * task.scale for j in range(m)])
        start = torch.zeros(R, dtype=torch.int64)
        while True:
            act = alive & (start < m)
            if not bool(act.any()):
                break
            stats["passes"] += int(act.sum())
            c, w, inn, occ, ext, z2, slots = pos, [], [], [], [], [], []
            for j in range(W):
                slot, on = window_slots(start, m, act, j)
                c = torch.where(on[:, None], c + dt[slot, ar][:, None] * dirs, c)
                w.append(c)
                inn.append(on & tracking._inside(task, c))
                occ.append(inn[j] & task._bitgrid_at(c))
                vox = task._nearest_index(c)
                flat, inb = task._voxel(vox)
                ext.append(task._take(vox) * task.inv_majorant)
                z2.append(dr[slot, 1, ar])
                slots.append(slot)
                stats["bitgrid"] += int(inn[j].sum())
                stats["grid"] += int((inn[j] & inb).sum())
                if reads is not None:
                    reads.read("bitgrid", task.bitgrid, task._bitgrid_cell(c[inn[j]]))
                    reads.read("grid", task.density_grid, flat[inn[j] & inb])
            nxt = torch.clamp(m - start, max=W)
            for j in range(W):
                walk = act & (start + j < m) & (j < nxt)
                live += walk.to(torch.int32)
                stats["bitgrid_used"] += int((walk & inn[j]).sum())
                stats["grid_used"] += int((walk & occ[j]).sum())
                pos = torch.where(walk[:, None], w[j], pos)
                ev = walk & occ[j]
                do_scatter = ev & (z2[j] < ext[j] * task.albedo)
                do_absorb = ev & ~do_scatter & (z2[j] < ext[j])
                new_d = dirs * task.scattering + dr[slots[j], 2:, ar]
                new_d = new_d / torch.clamp(tracking.norm3(new_d), min=1e-9)[:, None]
                dirs = torch.where(do_scatter[:, None], new_d, dirs)
                scattered = scattered | do_scatter
                absorbed = absorbed | do_absorb
                alive = torch.where(walk, inn[j] & ~absorbed, alive)
                nxt = torch.where(do_scatter | (walk & ~alive), j + 1, nxt)
                for key, mask in (("scatter", do_scatter), ("escape", walk & ~inn[j]),
                                  ("absorb", do_absorb)):
                    stats[key] += int(mask.sum())
                mark_rows(reads, draws, it0 + slots[j], range(2, tracking.GT_DRAWS_PER_ITER),
                          do_scatter)
            start = torch.where(act, start + nxt, start)
    env = tracking.proc_envmap(dirs, task.up_dir, task.sun_dir, task.sky_col)
    rgb = torch.where(absorbed[:, None], 0.0, env)
    return rgb, (absorbed | scattered).to(torch.float32), live


def batch_case(res: int, n_paths: int, seed: int):
    task = VolumeTask(procedural_fog_volume(res), tiny_config(), device="cpu",
                      batch_size=4 * n_paths)
    return task, jax_batch_draws(jax.random.PRNGKey(seed), n_paths)


def gt_case(res: int, side: int, seed: int):
    task = VolumeTask(procedural_fog_volume(res), tiny_config(), device="cpu")
    o, d = pinhole_rays(side, side, CAMERA, 50.0, "cpu")
    return task, o, d.to(torch.float32), jax_gt_draws(jax.random.PRNGKey(seed), side * side)


@pytest.mark.parametrize("res,n_paths,seed", [(16, 256, 3), (32, 256, 5)])
def test_window_walk_equals_plain_batch(res, n_paths, seed):
    """L's window walk on the JAX package's draws of ``_generate_batch``:
    every path bit for bit the plain version's, and as many live iterations;
    the draws cut windows at scatters, escapes and respawns, so passes
    restart mid-stage."""
    task, draws = batch_case(res, n_paths, seed)
    census = tracking.ReadCensus()
    ref = tracking.generate_batch_plain(task, draws, census)
    stats = new_stats()
    *out, live = walk_batch(task, draws, stats=stats)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert torch.equal(live, census.per_path("live"))
    assert stats["scatter"] > 0 and stats["escape"] > 0 and stats["respawn"] > 0, stats
    windows = int((-(-live // W)).sum())  # windows, had no path been cut
    assert stats["passes"] > windows, (stats, windows)
    assert stats["bitgrid_used"] < stats["bitgrid"], stats
    assert census.counts["scatter"] == stats["scatter"], (census.counts, stats)


def test_window_walk_equals_plain_trace():
    """M's window walk on the JAX package's draws of ``_render_rays_gt`` for
    64^2 rays: every ray bit for bit the plain version's, with scatters,
    escapes and absorptions cutting windows."""
    task, o, d, draws = gt_case(32, 64, 9)
    census = tracking.ReadCensus()
    ref = tracking.trace_gt_plain(task, o, d, draws, census)
    stats = new_stats()
    *out, live = walk_gt(task, o, d, draws, stats=stats)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert torch.equal(live, census.per_path("live"))
    assert stats["scatter"] > 0 and stats["escape"] > 0 and stats["absorb"] > 0, stats
    assert stats["passes"] > int((-(-live // W)).sum()), stats
    assert census.counts["scatter"] == stats["scatter"], (census.counts, stats)


@pytest.mark.parametrize("kernel", ["L", "M"])
def test_staged_and_at_use_rows_cover_the_census(kernel):
    """Every 32-byte sector of the draws, grid and bitgrid the plain
    version's census marks is one the kernel's design reads: the staged rows
    (``kBatchStaged`` / ``kGtStaged`` of them, every iteration of the stages
    each thread fills, from the census's live iterations), the rows the walk
    reads at their use (the scatter normal, the respawn's six), and the
    lookups the windows issue. The staged rows are the rows a live
    iteration reads: zeta1, the jitter and zeta2 (L); u and z2 (M)."""
    design = tracking.ReadCensus()
    census = tracking.ReadCensus()
    if kernel == "L":
        task, draws = batch_case(32, 512, 7)
        tracking.generate_batch_plain(task, draws, census)
        walk_batch(task, draws, reads=design)
        all_draws, rows, depth = draws.per_iter, K["kBatchStaged"], K["kBatchDepth"]
        assert rows == ZETA2 + 1
    else:
        task, o, d, draws = gt_case(32, 64, 4)
        tracking.trace_gt_plain(task, o, d, draws, census)
        walk_gt(task, o, d, draws, reads=design)
        all_draws, rows, depth = draws, K["kGtStaged"], K["kGtDepth"]
        assert rows == 2
    staged = staged_mask(census.per_path("live"), tuple(all_draws.shape), rows, S, depth)
    design.read("draws", all_draws, staged.reshape(-1).nonzero()[:, 0])
    for name in ("draws", "grid", "bitgrid"):
        missed = census.touched[name] & ~design.touched[name]
        assert not bool(missed.any()), (name, int(missed.sum()))
    # a path that stays live to the end stages every iteration; the design
    # reads more draws than the census, and less than all of them (L: rows
    # 0-4 of 14; M: 0-1 of 5, and rays stop)
    upto = staged_iterations(census.per_path("live"), all_draws.shape[0], S, depth)
    assert int(upto.max()) == all_draws.shape[0]
    n_design, n_census = int(design.touched["draws"].sum()), int(census.touched["draws"].sum())
    assert n_census <= n_design < design.touched["draws"].numel(), (n_census, n_design)


def test_staged_iterations_follow_the_thread_loop():
    """The stages a thread fills: [0, last + kDepth) of the stages, where
    ``last`` is the last stage it walks, and none where its path is never
    live (M's rays that miss the box start no ring)."""
    live = torch.tensor([0, 5, 16, 17, 40, 192, 190], dtype=torch.int32)
    got = staged_iterations(live, 192, 16, 2).tolist()
    assert got == [0, 32, 32, 48, 64, 192, 192]
    assert staged_iterations(live, 20, 16, 3).tolist() == [0] + [20] * 6


def test_rings_fit_four_blocks_an_sm():
    """Each block's rings fit the 48 KB of dynamic shared memory a launch
    gets without an opt-in (the launchers set none), so 4 blocks fit an SM's
    228 KB: L's 2^15 paths are ~4 blocks an SM, M's 65,536-ray chunks
    likewise; a stage holds whole windows and a fill runs ahead of its use."""
    for rows, threads, depth in ((K["kBatchStaged"], K["kBatchThreads"], K["kBatchDepth"]),
                                 (K["kGtStaged"], K["kGtThreads"], K["kGtDepth"])):
        ring = depth * rows * S * threads * 4
        assert ring <= 48 * 1024 and 4 * (ring + 1024) <= 233472, (rows, threads, depth, ring)
        assert depth >= 2
    assert S % W == 0


def test_launcher_signatures_match_the_sources():
    """Kernels L and M's launchers (``cuda_lib``) have as many argument types
    as their C functions have parameters, the stream included."""
    src = (ROOT / "instant_ngp_torch" / "csrc" / "volume.cu").read_text()
    for name in ("volume_generate_batch", "volume_trace_gt"):
        m = re.search(r'extern "C" [\w ]+ ngp_' + name + r"\(([^)]*)\)", src)
        assert m is not None, name
        assert len([a for a in m.group(1).split(",") if a.strip()]) == len(
            cuda_lib.SIGNATURES[name]), name
