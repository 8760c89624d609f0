"""The volume primitive's two path tracers through the ground-truth grid:
the delta-tracked training batch (kernel L) and the ground-truth render's
Woodcock trace (kernel M), each with its plain PyTorch version.

Plain versions follow ``instant_ngp_tpu/volume/task.py``'s
``_generate_batch`` (:160-277) and ``_render_rays_gt`` (:365-413) line by
line: all paths in lockstep, one iteration of elementwise ops at a time.
The kernels (``csrc/volume.cu``) run one thread a path with the same
arithmetic in the same order, and stop a path once nothing of it can change
any more, so each path's result is the same. They compute a window of an
iteration's successors along the current direction ahead of walking it;
``tests/test_torch_volume_design.py`` mirrors that walk.

The random numbers are arguments (``BatchDraws``, and the (n_iters, 5, R)
draws of ``trace_gt``), so that a test can hand in the JAX package's own.
``draw_batch`` and ``draw_gt`` make them from a ``torch.Generator``. They are
stored iteration-major and path-minor, so a kernel's reads of one iteration
coalesce.

The wrappers run the plain version for CPU tensors and launch the kernel
for CUDA tensors; the ``task`` they take is a ``VolumeTask`` (its grid, bitgrid,
box and constants).
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from .. import cuda_lib
from ..ops.raymarch import ray_intersect_aabb

MAX_TRAIN_VERTICES = 4
BATCH_ITERS = 192  # the lockstep iterations of a training batch
GT_ITERS = 256  # the ground-truth render's
# rows of BatchDraws.per_iter, in the JAX function's use order
ZETA1, JITTER, ZETA2, SCATTER, RESPAWN_NORMAL, RESPAWN_UNIFORM = 0, 1, 4, 5, 8, 11
BATCH_DRAWS_PER_ITER = 14
GT_DRAWS_PER_ITER = 5  # u in [1e-7, 1), zeta2, a normal (3)
GT_U_MIN = 1e-7


@dataclasses.dataclass
class BatchDraws:
    """The random numbers of one training batch of n paths, f32.

    ``first`` (6, n): the first spawn's normal (rows 0-2) and uniform (3-5).
    ``per_iter`` (n_iters, 14, n): each iteration's, in the order the JAX
    function uses them: zeta1 (row 0), the density read's jitter (1-3),
    zeta2 (4), the scatter direction's normal (5-7), and the respawn's normal
    (8-10) and uniform (11-13), drawn for every path at every iteration."""

    first: torch.Tensor
    per_iter: torch.Tensor

    @property
    def n_paths(self) -> int:
        return self.first.shape[1]


def draw_batch(generator: torch.Generator, n_paths: int) -> BatchDraws:
    """A batch's draws on the generator's device: normals N(0, 1), uniforms
    in [0, 1)."""
    dev = generator.device
    first = torch.empty((6, n_paths), device=dev)
    first[:3].normal_(generator=generator)
    first[3:].uniform_(generator=generator)
    it = torch.empty((BATCH_ITERS, BATCH_DRAWS_PER_ITER, n_paths), device=dev)
    it[:, ZETA1:SCATTER].uniform_(generator=generator)
    it[:, SCATTER:RESPAWN_UNIFORM].normal_(generator=generator)
    it[:, RESPAWN_UNIFORM:].uniform_(generator=generator)
    return BatchDraws(first, it)


def draw_gt(generator: torch.Generator, n_rays: int, n_iters: int = GT_ITERS) -> torch.Tensor:
    """The ground-truth trace's draws (n_iters, 5, R) on the generator's
    device: u in [1e-7, 1) (row 0), zeta2 in [0, 1) (1), a normal (2-4)."""
    draws = torch.empty((n_iters, GT_DRAWS_PER_ITER, n_rays), device=generator.device)
    draws[:, :2].uniform_(generator=generator)
    draws[:, 0].mul_(1.0 - GT_U_MIN).add_(GT_U_MIN).clamp_(min=GT_U_MIN)
    draws[:, 2:].normal_(generator=generator)
    return draws


class ReadCensus:
    """What a kernel that reads only what the plain version uses must read,
    counted on a plain version's masks as it runs: the 32-byte sectors of
    each input it touches (``touched``, by name: the draws, the grid, the
    bitgrid), and the path-iterations of each kind (``counts``: ``live``,
    ``event``, ``scatter``, ``died``, ``respawn``). A plain version given
    one marks, at each iteration, the draws each path's thread reads (zeta1
    while the path is live, the rest only where their branch runs) and the
    grid and bitgrid elements it reads."""

    SECTOR_BYTES = 32

    def __init__(self):
        self.touched: dict[str, torch.Tensor] = {}
        self._per_path: dict[str, torch.Tensor] = {}

    def read(self, name: str, t: torch.Tensor, flat: torch.Tensor) -> None:
        """Marks the elements of t at the flat indices as read."""
        per = self.SECTOR_BYTES // t.element_size()
        if name not in self.touched:
            self.touched[name] = torch.zeros(-(-t.numel() // per), dtype=torch.bool,
                                             device=t.device)
        self.touched[name][flat // per] = True

    def rows(self, draws: torch.Tensor, i: int, rows, mask: torch.Tensor) -> None:
        """Marks the rows of iteration i of draws (n_iters, n_rows, n) that
        the paths in mask (n,) read."""
        p = torch.nonzero(mask)[:, 0]
        r = torch.as_tensor(list(rows), device=p.device) + i * draws.shape[1]
        self.read("draws", draws, (r[:, None] * draws.shape[2] + p[None, :]).reshape(-1))

    def count(self, name: str, mask: torch.Tensor) -> None:
        m = mask.to(torch.int32)
        self._per_path[name] = self._per_path[name] + m if name in self._per_path else m

    @property
    def counts(self) -> dict[str, int]:
        return {k: int(v.sum()) for k, v in self._per_path.items()}

    def per_path(self, name: str) -> torch.Tensor:
        """(n,) int32: each path's path-iterations of this kind; ``live``
        is a prefix of the loop, so it is the iterations a path is live."""
        return self._per_path[name]

    def bytes_read(self) -> dict[str, int]:
        """The bytes of the touched sectors of each input."""
        return {k: int(v.sum()) * self.SECTOR_BYTES for k, v in self.touched.items()}


# --- shared pieces of the plain versions ---
def norm3(v: torch.Tensor) -> torch.Tensor:
    """|v| of (n, 3) rows as sqrt((x·x + y·y) + z·z), the kernels' order."""
    return torch.sqrt(v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1] + v[:, 2] * v[:, 2])


def dot3(v: torch.Tensor, w) -> torch.Tensor:
    """v · w of (n, 3) rows and a host 3-vector, summed left to right."""
    return v[:, 0] * float(w[0]) + v[:, 1] * float(w[1]) + v[:, 2] * float(w[2])


SUN_COLOR = np.array([255.0, 215.0, 195.0], np.float32) / np.float32(255.0)


def proc_envmap(dirs: torch.Tensor, up_dir, sun_dir, sky_col) -> torch.Tensor:
    """The procedural sun and sky (reference testbed_volume.cu:44-58) of unit
    directions (n, 3) → (n, 3): sky · (up·d / 2 + 1/2) + sun colour · 20 ·
    max(0, sun·d)^64 (six squarings, as JAX's integer power)."""
    skyam = dot3(dirs, up_dir) * 0.5 + 0.5
    sunam = torch.clamp(dot3(dirs, sun_dir), min=0.0)
    for _ in range(6):
        sunam = sunam * sunam
    sky = torch.as_tensor(np.asarray(sky_col, np.float32), device=dirs.device)
    sun = torch.as_tensor(SUN_COLOR, device=dirs.device)
    return sky * skyam[:, None] + sun * (20.0 * sunam)[:, None]


def _inside(task, pos: torch.Tensor) -> torch.Tensor:
    return torch.all((pos >= task.aabb_min_t) & (pos <= task.aabb_max_t), dim=-1)


def _spawn(task, normal: torch.Tensor, uniform: torch.Tensor):
    """A fresh path (``_generate_batch.spawn``): a point on the sphere of
    radius 2 about the box's centre, aimed at a uniform point of the box,
    moved onto the box (1e-6 past its entry). normal, uniform: (n, 3)."""
    d0 = normal / norm3(normal)[:, None]
    pos = d0 * 2.0 + 0.5
    target = uniform * (task.aabb_max_t - task.aabb_min_t) + task.aabb_min_t
    dirs = target - pos
    dirs = dirs / norm3(dirs)[:, None]
    tmin, _ = ray_intersect_aabb(pos, dirs, task.aabb_min_t, task.aabb_max_t)
    pos = pos + (torch.clamp(tmin, min=0.0) + 1e-6)[:, None] * dirs
    return pos, dirs


def generate_batch_plain(task, draws: BatchDraws, census: ReadCensus | None = None):
    """The delta-tracking path tracer → (pts (B, 3), tgt (B, 4), valid (B,)),
    B = 4 · n_paths, rows path-major: each path records up to 4 vertices
    (position, jittered density) at events in occupied bitgrid cells; each
    vertex's rgb target is the terminal radiance of its attempt (the
    envmap on escape, 0 on absorption); a path respawns until its 4 slots
    are full, and an attempt still in flight after the last iteration ends
    with throughput 1. As the JAX function, ``throughput`` is never updated
    (every attempt ends with 1 or 0), the respawn draws are made for every
    path at every iteration, and the pending range and ``done`` change only
    when an attempt ends. A ``census`` counts what kernel L reads."""
    V = MAX_TRAIN_VERTICES
    first, it = draws.first, draws.per_iter
    n = draws.n_paths
    dev = first.device
    pos, dirs = _spawn(task, first[:3].T, first[3:].T)
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    n_rec = torch.zeros(n, dtype=torch.int32, device=dev)
    pend_from = torch.zeros(n, dtype=torch.int32, device=dev)
    rec_pos = torch.zeros((n, V, 3), device=dev)
    rec_den = torch.zeros((n, V), device=dev)
    rec_rgb = torch.zeros((n, V, 3), device=dev)
    iota_v = torch.arange(V, dtype=torch.int32, device=dev)[None, :]

    def finalize(rec_rgb, dirs, throughput):
        radiance = proc_envmap(dirs, task.up_dir, task.sun_dir, task.sky_col) * throughput[:, None]
        pend = (iota_v >= pend_from[:, None]) & (iota_v < n_rec[:, None])
        return torch.where(pend[..., None], radiance[:, None, :], rec_rgb)

    for i in range(it.shape[0]):
        d = it[i]
        live = ~done
        dt = -torch.log(1.0 - d[ZETA1]) * task.scale
        pos = pos + dirs * dt[:, None]
        inside = _inside(task, pos)
        escaped = ~done & ~inside
        event = ~done & inside & task._bitgrid_at(pos)
        density = task._grid_density_at_jittered(pos, d[JITTER:ZETA2].T)
        record = event & (n_rec < V)
        onehot = iota_v == torch.clamp(n_rec, 0, V - 1)[:, None]
        at = record[:, None] & onehot
        rec_pos = torch.where(at[..., None], pos[:, None, :], rec_pos)
        rec_den = torch.where(at, density[:, None], rec_den)
        n_rec = n_rec + record.to(torch.int32)

        extinction = torch.where(event, density * task.inv_majorant, 0.0)
        scatter_prob = extinction * task.albedo
        zeta2 = d[ZETA2]
        real = event & (zeta2 < extinction)
        scatter = real & (zeta2 < scatter_prob)
        absorb = real & ~scatter
        nd = d[SCATTER:RESPAWN_NORMAL].T
        new_dir = dirs * task.scattering + nd / norm3(nd)[:, None]
        new_dir = new_dir / norm3(new_dir)[:, None]
        dirs = torch.where(scatter[:, None], new_dir, dirs)

        died = escaped | absorb
        thr = torch.where(absorb, 0.0, 1.0)
        rec_rgb = torch.where(died[:, None, None], finalize(rec_rgb, dirs, thr), rec_rgb)
        pend_from = torch.where(died, n_rec, pend_from)
        done = done | (died & (n_rec >= V))

        respawn = died & ~done
        if census is not None:
            census.count("live", live)
            census.rows(it, i, [ZETA1], live)
            census.read("bitgrid", task.bitgrid, task._bitgrid_cell(pos[live & inside]))
            census.count("event", event)
            census.rows(it, i, range(JITTER, SCATTER), event)
            flat, inb = task._voxel(task._jittered_index(pos[event], d[JITTER:ZETA2].T[event]))
            census.read("grid", task.density_grid, flat[inb])
            census.count("scatter", scatter)
            census.rows(it, i, range(SCATTER, RESPAWN_NORMAL), scatter)
            census.count("died", died)
            census.count("respawn", respawn)
            census.rows(it, i, range(RESPAWN_NORMAL, BATCH_DRAWS_PER_ITER), respawn)
        s_pos, s_dirs = _spawn(task, d[RESPAWN_NORMAL:RESPAWN_UNIFORM].T, d[RESPAWN_UNIFORM:].T)
        pos = torch.where(respawn[:, None], s_pos, pos)
        dirs = torch.where(respawn[:, None], s_dirs, dirs)

    rec_rgb = finalize(rec_rgb, dirs, torch.ones(n, device=dev))
    B = n * V
    tgt = torch.cat([rec_rgb.reshape(B, 3), rec_den.reshape(B, 1)], -1)
    return rec_pos.reshape(B, 3), tgt, (iota_v < n_rec[:, None]).reshape(B)


def _params_c(task):
    """The constants kernels L and M take, as host arrays: float[25] (the
    box's min, max and 1 / extent, scale, 1 / majorant, albedo, scattering,
    the envmap's up, sun, sky and sun colour) and int[3] (the grid's
    resolution)."""
    f32 = np.float32
    vals = [*task.aabb_min, *task.aabb_max, *task.inv_extent, f32(task.scale),
            f32(task.inv_majorant),
            f32(task.albedo), f32(task.scattering), *np.asarray(task.up_dir, f32),
            *np.asarray(task.sun_dir, f32), *np.asarray(task.sky_col, f32), *SUN_COLOR]
    return ((ctypes.c_float * len(vals))(*[float(v) for v in vals]),
            (ctypes.c_int * 3)(*[int(r) for r in task.grid_res]))


def generate_batch(task, draws: BatchDraws):
    """A training batch (see ``generate_batch_plain``): the plain version for
    CPU tensors, kernel L for CUDA tensors (one launch: a thread a path,
    the draws each iteration reads staged ahead, a look-ahead window)."""
    if draws.first.device.type == "cpu":
        return generate_batch_plain(task, draws)
    first, it = draws.first.contiguous(), draws.per_iter.contiguous()
    cuda_lib.check_cuda(first, it, task.density_grid, dtype=torch.float32)
    cuda_lib.check_cuda(task.bitgrid, dtype=torch.uint8)
    if it.shape[1] != BATCH_DRAWS_PER_ITER or it.shape[2] != first.shape[1]:
        raise ValueError(f"draws of shapes {tuple(first.shape)} and {tuple(it.shape)}")
    n, n_iters = first.shape[1], it.shape[0]
    B = n * MAX_TRAIN_VERTICES
    pts = torch.empty((B, 3), device=first.device)
    tgt = torch.empty((B, 4), device=first.device)
    valid = torch.empty((B,), dtype=torch.bool, device=first.device)
    params, res = _params_c(task)
    if n > 0:
        cuda_lib.launch("volume_generate_batch", first.data_ptr(), it.data_ptr(),
                        task.density_grid.data_ptr(), task.bitgrid.data_ptr(),
                        ctypes.addressof(params), ctypes.addressof(res), n, n_iters,
                        pts.data_ptr(), tgt.data_ptr(), valid.data_ptr())
    return pts, tgt, valid


def trace_gt_plain(task, o: torch.Tensor, d: torch.Tensor, draws: torch.Tensor,
                   census: ReadCensus | None = None):
    """The ground-truth render: Woodcock tracking of rays o, d (R, 3) through
    the grid (nearest-voxel reads) with scattering and absorption events,
    draws (n_iters, 5, R) → (rgb (R, 3), alpha (R,)): black where absorbed,
    else the envmap in the last direction; alpha 1 where absorbed or
    scattered. A ``census`` counts what kernel M reads."""
    R = o.shape[0]
    tmin, tmax = ray_intersect_aabb(o, d, task.aabb_min_t, task.aabb_max_t)
    alive = tmax > tmin
    pos = o + tmin[:, None] * d
    dirs = d
    absorbed = torch.zeros(R, dtype=torch.bool, device=o.device)
    scattered = torch.zeros_like(absorbed)
    for i in range(draws.shape[0]):
        u, z2, rnd = draws[i, 0], draws[i, 1], draws[i, 2:].T
        dt = -torch.log(u) * task.scale
        pos = torch.where(alive[:, None], pos + dt[:, None] * dirs, pos)
        inside = _inside(task, pos)
        event = alive & inside & task._bitgrid_at(pos)
        extinction = task._grid_density_at(pos) * task.inv_majorant
        do_scatter = event & (z2 < extinction * task.albedo)
        do_absorb = event & ~do_scatter & (z2 < extinction)
        new_d = dirs * task.scattering + rnd
        new_d = new_d / torch.clamp(norm3(new_d), min=1e-9)[:, None]
        dirs = torch.where(do_scatter[:, None], new_d, dirs)
        if census is not None:
            census.count("live", alive)
            census.rows(draws, i, [0], alive)
            census.read("bitgrid", task.bitgrid, task._bitgrid_cell(pos[alive & inside]))
            census.count("event", event)
            census.rows(draws, i, [1], event)
            flat, inb = task._voxel(task._nearest_index(pos[event]))
            census.read("grid", task.density_grid, flat[inb])
            census.count("scatter", do_scatter)
            census.rows(draws, i, range(2, GT_DRAWS_PER_ITER), do_scatter)
        scattered = scattered | do_scatter
        absorbed = absorbed | do_absorb
        alive = alive & inside & ~absorbed
    env = proc_envmap(dirs, task.up_dir, task.sun_dir, task.sky_col)
    rgb = torch.where(absorbed[:, None], 0.0, env)
    return rgb, (absorbed | scattered).to(torch.float32)


def trace_gt(task, o: torch.Tensor, d: torch.Tensor, draws: torch.Tensor):
    """The ground-truth trace (see ``trace_gt_plain``): the plain version for
    CPU tensors, kernel M for CUDA tensors (one launch: a thread a ray, as
    kernel L)."""
    if o.device.type == "cpu":
        return trace_gt_plain(task, o, d, draws)
    o, d, draws = o.contiguous(), d.contiguous(), draws.contiguous()
    cuda_lib.check_cuda(o, d, draws, task.density_grid, dtype=torch.float32)
    cuda_lib.check_cuda(task.bitgrid, dtype=torch.uint8)
    R = o.shape[0]
    if draws.shape[1:] != (GT_DRAWS_PER_ITER, R) or d.shape != o.shape:
        raise ValueError(f"rays {tuple(o.shape)} and draws {tuple(draws.shape)}")
    rgb = torch.empty((R, 3), device=o.device)
    alpha = torch.empty((R,), device=o.device)
    params, res = _params_c(task)
    if R > 0:
        cuda_lib.launch("volume_trace_gt", o.data_ptr(), d.data_ptr(), draws.data_ptr(),
                        task.density_grid.data_ptr(), task.bitgrid.data_ptr(),
                        ctypes.addressof(params), ctypes.addressof(res), R, draws.shape[0],
                        rgb.data_ptr(), alpha.data_ptr())
    return rgb, alpha
