"""A minimal NanoVDB (.nvdb) reader for float grids (port of
``instant_ngp_tpu/io/nanovdb.py``; the reference's load_volume,
testbed_volume.cu:609-701).

The volume primitive needs only the dense density values and the index
bounding box, so the tree is decoded on the host into a dense numpy grid
(the reference likewise walks the leaf nodes into its own bitgrid).

The layout read is NanoVDB 32.3's, as the wdas_cloud sample files hold it:
a float grid, no compression (a gzip-wrapped file is unwrapped first).

  * FileHeader: magic 0x304244566f6e614e ("NanoVDB0"), version, grid count,
    codec; then per grid its FileMetaData (176 bytes) and name. A bare
    GridData blob (magic "NanoVDB1") is read too
  * GridData (672 bytes), TreeData, the root's tiles, upper (32^3) and lower
    (16^3) internal nodes, leaves of 8^3 values

A leaf that does not lie wholly inside the root's index box is dropped, as
the JAX package's reader drops it. Numpy only; ``procedural_fog_volume``
is the cloud the tests and ``chip_smoke.py`` use, since the repository
holds no ``.nvdb`` file.
"""

from __future__ import annotations

import gzip
import struct
from pathlib import Path

import numpy as np

MAGIC = 0x304244566F6E614E  # "NanoVDB0"
MAGIC_GRID = 0x314244566F6E614E
GRID_DATA_SIZE = 672
FILE_META_SIZE = 176
ROOT_DATA_SIZE = 64
TILE_SIZE = 32  # Tile<float>: key (u64), child (i64), state (u32), value (f32), padding


def read_nvdb_dense(path) -> tuple[np.ndarray, np.ndarray]:
    """A .nvdb float grid → (dense (X, Y, Z) f32, index_min (3,))."""
    raw = Path(path).read_bytes()
    if raw[:2] == b"\x1f\x8b":
        raw = gzip.decompress(raw)
    (magic,) = struct.unpack_from("<Q", raw, 0)
    if magic not in (MAGIC, MAGIC_GRID):
        raise ValueError(f"not a NanoVDB file (magic {magic:#x})")
    if magic == MAGIC:
        # FileHeader: magic (8) version (4) gridCount (2) codec (2)
        _version, _grid_count, codec = struct.unpack_from("<IHH", raw, 8)
        if codec != 0:
            raise NotImplementedError(f"nvdb codec {codec} (compressed) unsupported")
        meta_off = 16
        # FileMetaData: gridSize, fileSize, nameKey, voxelCount, gridType,
        # gridClass, bounding boxes, voxel size, ...; the name's length at +168
        (name_len,) = struct.unpack_from("<I", raw, meta_off + 168)
        grid_off = meta_off + FILE_META_SIZE + name_len
    else:
        grid_off = 0
    return _parse_grid_data(raw, grid_off)


def _align32(x: int) -> int:
    return (x + 31) & ~31


def _mask_bits(words: np.ndarray, n: int) -> np.ndarray:
    return np.unpackbits(words.view(np.uint8), bitorder="little")[:n].astype(bool)


def _parse_grid_data(raw: bytes, off: int) -> tuple[np.ndarray, np.ndarray]:
    """The dense grid of the GridData blob at ``off``: TreeData follows the
    672-byte GridData; its fourth node offset is the root's."""
    tree_off = off + GRID_DATA_SIZE
    # TreeData: nodeOffset[4] (u64), nodeCount[3] (u32), tileCount[3] (u32), voxelCount (u64)
    node_off = struct.unpack_from("<4Q", raw, tree_off)
    root_off = tree_off + node_off[3]

    # RootData<float>: bbox (2 x int32 x 3), tableSize (u32), background (f32),
    # min, max, avg, stddev (f32 each), padded to 64 bytes
    bbox = struct.unpack_from("<6i", raw, root_off)
    (table_size,) = struct.unpack_from("<I", raw, root_off + 24)
    (background,) = struct.unpack_from("<f", raw, root_off + 28)
    imin = np.array(bbox[:3])
    shape = np.array(bbox[3:]) + 1 - imin
    dense = np.full(shape, background, np.float32)

    def read_internal(ioff: int, log2dim: int):
        """(child mask, child offset table) of an internal node: bbox (24),
        flags (8), value mask, child mask, min/max/avg/std (16), then the
        table, 32-byte aligned."""
        n = 1 << (3 * log2dim)
        words = n // 64
        cmask_off = ioff + 24 + 8 + words * 8
        table_off = ioff + _align32(cmask_off + words * 8 + 16 - ioff)
        cmask = np.frombuffer(raw, np.uint64, words, cmask_off)
        return _mask_bits(cmask, n), np.frombuffer(raw, np.int64, n, table_off)

    for t in range(table_size):
        toff = root_off + ROOT_DATA_SIZE + t * TILE_SIZE
        _key, child = struct.unpack_from("<Qq", raw, toff)
        if child <= 0:
            continue
        upper_off = root_off + child
        ubits, utable = read_internal(upper_off, 5)
        for iu in np.nonzero(ubits)[0]:
            lower_off = upper_off + int(utable[iu])
            lbits, ltable = read_internal(lower_off, 4)
            for il in np.nonzero(lbits)[0]:
                # LeafData<float>: bbox min (3 x i32), bbox dif (3 x u8), flags
                # (u8), value mask (64), min/max/avg/std (16), values[512]
                leaf_off = lower_off + int(ltable[il])
                origin = struct.unpack_from("<3i", raw, leaf_off)
                vals = np.frombuffer(raw, np.float32, 512, leaf_off + 16 + 64 + 16)
                x0, y0, z0 = np.array(origin) - imin
                if (0 <= x0 <= shape[0] - 8 and 0 <= y0 <= shape[1] - 8
                        and 0 <= z0 <= shape[2] - 8):
                    dense[x0:x0 + 8, y0:y0 + 8, z0:z0 + 8] = vals.reshape(8, 8, 8)
    return dense, imin


def _key_to_coord(key: int) -> tuple[int, int, int]:
    """A root tile's key → its origin (21 bits an axis, x highest)."""
    kz = key & ((1 << 21) - 1)
    ky = (key >> 21) & ((1 << 21) - 1)
    kx = (key >> 42) & ((1 << 21) - 1)
    return kx, ky, kz


def procedural_fog_volume(res: int = 128) -> np.ndarray:
    """A procedural cloud-like density (res^3 f32) from a fixed seed: an
    ellipsoidal falloff modulated by three octaves of block noise."""
    rng = np.random.default_rng(7)
    coords = np.linspace(-1, 1, res)
    x, y, z = np.meshgrid(coords, coords, coords, indexing="ij")
    r = np.sqrt(x**2 + 1.5 * y**2 + z**2)
    base = np.clip(0.7 - r, 0, None)
    noise = np.zeros((res, res, res), np.float32)
    for octave in range(1, 4):
        n = min(2**octave * 4, res)
        small = rng.random((n, n, n)).astype(np.float32)
        reps = res // n
        up = np.kron(small, np.ones((reps, reps, reps), np.float32))
        noise += up / 2**octave
    dens = np.clip(base * (0.5 + noise), 0, None) * 4.0
    return dens.astype(np.float32)
