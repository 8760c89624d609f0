"""The volume primitive's reader and set-up in the PyTorch port against the
JAX package on the CPU: ``read_nvdb_dense`` on files written by
``tests/nvdb_fixture.py`` (plain, gzip-wrapped, a bare grid; a cube, a
non-cube grid with leaves that straddle its index box, one across two upper
nodes), ``procedural_fog_volume``, ``VolumeTask``'s box, majorant, bitgrid
and autoconfigured encoding, its ground-truth reads, and the parameter and
optimizer-state trees of the volume config in the JAX package's order.

That the readers agree with files NanoVDB itself writes cannot be shown
here: the repository holds no such file. Both readers and the writer follow
one reading of the v32.3 layout."""

import jax
import numpy as np
import pytest
import torch

from instant_ngp_tpu.io import nanovdb as jax_nanovdb
from instant_ngp_torch import snapshot as port_snapshot
from instant_ngp_torch.config import default_config
from instant_ngp_torch.io import nanovdb
from instant_ngp_torch.models.network import params_to_numpy
from nvdb_fixture import nvdb_bytes, write_nvdb
from torch_volume_common import task_pair, tiny_config

torch.set_num_threads(2)

RNG_GRID = np.random.default_rng(11).random((24, 16, 40)).astype(np.float32)
# (grid, index_min, whether every leaf lies inside the index box)
GRIDS = {"fog16": (nanovdb.procedural_fog_volume(16), (0, 0, 0), True),
         "noncube": (RNG_GRID, (8, -16, 24), True),
         "straddling": (RNG_GRID, (-8, 3, 16), False),
         "two_uppers": (RNG_GRID, (4032, 0, -4104), True)}


@pytest.mark.parametrize("form", [{}, {"gzip_wrap": True}, {"file_header": False}],
                         ids=["plain", "gzip", "bare_grid"])
@pytest.mark.parametrize("name", sorted(GRIDS))
def test_reader_equals_jax_on_written_files(tmp_path, name, form):
    """Both readers give the same array and index origin; where every leaf
    lies inside the index box, that is the written grid; a straddling leaf
    is dropped by both (the background, 0, stays there)."""
    grid, imin, whole = GRIDS[name]
    path = write_nvdb(tmp_path / "g.nvdb", grid, index_min=imin, **form)
    dense, origin = nanovdb.read_nvdb_dense(path)
    dense_ref, origin_ref = jax_nanovdb.read_nvdb_dense(path)
    assert dense.dtype == np.float32 and dense.shape == grid.shape
    np.testing.assert_array_equal(dense, dense_ref)
    np.testing.assert_array_equal(origin, origin_ref)
    np.testing.assert_array_equal(origin, imin)
    if whole:
        np.testing.assert_array_equal(dense, grid)
    else:
        assert (dense == 0).any() and (dense == grid).any()


def test_reader_refuses_what_the_jax_reader_refuses(tmp_path):
    bad = tmp_path / "bad.nvdb"
    bad.write_bytes(b"\0" * 64)
    for read in (nanovdb.read_nvdb_dense, jax_nanovdb.read_nvdb_dense):
        with pytest.raises(ValueError, match="not a NanoVDB file"):
            read(bad)
    raw = bytearray(nvdb_bytes(nanovdb.procedural_fog_volume(8)))
    raw[14] = 1  # the header's codec: compressed
    bad.write_bytes(bytes(raw))
    for read in (nanovdb.read_nvdb_dense, jax_nanovdb.read_nvdb_dense):
        with pytest.raises(NotImplementedError, match="codec 1"):
            read(bad)


def test_key_to_coord_equals_jax():
    keys = np.random.default_rng(3).integers(0, 1 << 63, 64, dtype=np.int64)
    for key in map(int, keys):
        assert nanovdb._key_to_coord(key) == jax_nanovdb._key_to_coord(key)


@pytest.mark.parametrize("res", [16, 32])
def test_procedural_fog_equals_jax(res):
    fog = nanovdb.procedural_fog_volume(res)
    assert fog.dtype == np.float32 and fog.shape == (res,) * 3
    np.testing.assert_array_equal(fog, jax_nanovdb.procedural_fog_volume(res))


SETUP_GRIDS = {"fog16": nanovdb.procedural_fog_volume(16),
               "noncube": np.random.default_rng(5).random((8, 16, 24)).astype(np.float32)
               * np.float32(3.0)}


@pytest.mark.parametrize("name", sorted(SETUP_GRIDS))
def test_task_setup_equals_jax(name):
    """The box fitted into [0, 1]³, world2index_scale, the majorant, the
    128³ bitgrid, the constants and the autoconfigured encoding."""
    theirs, ours = task_pair(SETUP_GRIDS[name])
    for key in ("aabb_min", "aabb_max", "grid_res"):
        np.testing.assert_array_equal(getattr(ours, key), getattr(theirs, key))
    assert ours.aabb_min.dtype == np.float32
    assert ours.world2index_scale == theirs.world2index_scale
    assert ours.global_majorant == theirs.global_majorant
    np.testing.assert_array_equal(ours.bitgrid.numpy().astype(bool), np.asarray(theirs.bitgrid))
    assert ours.bitgrid.dtype == torch.uint8 and ours.bitgrid.shape == (128, 128, 128)
    np.testing.assert_array_equal(ours.density_grid.numpy(), np.asarray(theirs.density_grid))
    for key in ("albedo", "scattering", "distance_scale", "batch_size"):
        assert getattr(ours, key) == getattr(theirs, key), key
    assert ours.batch_size == 1 << 17  # the JAX Testbed passes none
    for key in ("up_dir", "sun_dir", "sky_col"):
        np.testing.assert_array_equal(getattr(ours, key), getattr(theirs, key))
    assert ours.config["encoding"] == theirs.config["encoding"]
    assert ours.network_config == tiny_config()
    assert ours.scale == float(np.float32(theirs.distance_scale / theirs.global_majorant))


def test_grid_reads_equal_jax():
    """The nearest read, the jittered read and the bitgrid read at positions
    inside, on the faces of and outside a non-cube box, against the jitted
    JAX reads with the arrays passed as arguments: the same voxel and cell
    at every position save those within an f32 rounding of a voxel face
    (XLA fuses ``rel * res - 0.5`` into one FMA; the port rounds twice)."""
    theirs, ours = task_pair(SETUP_GRIDS["noncube"])
    rng = np.random.default_rng(9)
    ext = theirs.aabb_max - theirs.aabb_min
    pos = rng.uniform(theirs.aabb_min - 0.1 * ext, theirs.aabb_max + 0.1 * ext,
                      (1 << 14, 3)).astype(np.float32)
    pos[:64] = np.concatenate([theirs.aabb_min, theirs.aabb_max])[rng.integers(0, 6, (64, 3))]
    # a quarter near the occupied cells' centres (the bitgrid marks one cell a voxel)
    cells = np.argwhere(np.asarray(theirs.bitgrid))
    cells = cells[rng.integers(0, len(cells), 1 << 12)]
    pos[-(1 << 12):] = ((cells + rng.uniform(-0.45, 0.45, cells.shape)) / 128.0).astype(np.float32)
    jitter = rng.random(pos.shape).astype(np.float32)
    grid = theirs.density_grid
    near = jax.jit(lambda p, g: theirs._grid_density_at(p, g))(pos, grid)
    jit_ = jax.jit(lambda p, j, g: theirs._grid_density_at_jittered(p, j, g))(pos, jitter, grid)
    bits = jax.jit(theirs._bitgrid_at)(pos)
    p, j = torch.from_numpy(pos), torch.from_numpy(jitter)
    np.testing.assert_array_equal(ours._grid_density_at(p).numpy(), np.asarray(near))
    np.testing.assert_array_equal(ours._bitgrid_at(p).numpy(), np.asarray(bits))
    same = ours._grid_density_at_jittered(p, j).numpy() == np.asarray(jit_)
    assert same.mean() >= 0.999, same.mean()
    assert (np.asarray(near) > 0).mean() > 0.3 and np.asarray(bits).mean() > 0.05


def test_volume_config_trees_in_jax_order():
    """configs/volume/base.json at full width: the port's parameter and
    optimizer-state trees, flattened as snapshots flatten them, are the
    JAX package's leaf for leaf (dtype and shape), so the files match."""
    grid = nanovdb.procedural_fog_volume(16)
    theirs, ours = task_pair(grid, default_config("volume"))
    assert [tuple(w.shape) for w in ours.model.network.weights] == [(32, 64), (64, 64), (64, 4)]
    for got, want in ((params_to_numpy(ours.model), theirs.params),
                      (ours.opt_state_tree(), theirs.opt_state)):
        assert [(a.dtype, a.shape) for a in port_snapshot.tree_leaves(got)] == [
            (np.asarray(b).dtype, np.shape(b)) for b in jax.tree.leaves(want)]
    for a, b in zip(port_snapshot.tree_leaves(params_to_numpy(ours.model)),
                    jax.tree.leaves(theirs.params)):
        np.testing.assert_array_equal(a, np.asarray(b))
